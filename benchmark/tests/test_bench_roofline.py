"""The floor arithmetic of the kernels' roofline."""

import pytest

from benchmark import roofline

ESS = {"draw": 148.0, "factors": 9.0, "accumulation": 56.0, "retirement": 110.0,
       "tracked_accumulation": 56.0, "tracked_retirement": 121.0}


def test_peaks_are_the_cards():
    assert roofline.OPS_PER_S == pytest.approx(132 * 1.98e9 * 128)
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def test_rows_work_by_hand():
    # Two rows at W = 10 and 12, R = 1, 100 paths; 90 and 100 survive.
    w = roofline.rows_work(ESS, [10, 12], [90, 100], 100, 1)
    ret = [90 * 12 + 10, 100 * 12]
    draws = max(100 * 10 + ret[0], 100 * 12 + ret[1])
    ops = draws * 157.0 + 100 * 10 * 56 + ret[0] * 110 + 100 * 12 * 56 + ret[1] * 110
    assert w["ops"] == pytest.approx(ops)
    assert w["bytes"] == 2 * (2 * 100 * 4 + 8)


def test_full_work_by_hand():
    w = roofline.full_work(ESS, 24, 95, 100, 2, 5)
    ret = 95 * 24 + 5
    assert w["ops"] == pytest.approx((100 * 24 + ret) * 157 + 100 * 24 * 56 + ret * 121)
    assert w["bytes"] == 100 * 4 * (7 + 2 * 5 + 2)


def test_floor_is_the_larger_bound():
    assert roofline.floor_s(roofline.OPS_PER_S, 0) == pytest.approx(1.0)
    assert roofline.floor_s(0, roofline.HBM_BYTES_PER_S * 2) == pytest.approx(2.0)
    assert roofline.floor_s(roofline.OPS_PER_S, roofline.HBM_BYTES_PER_S * 3) == pytest.approx(3.0)


def test_ruined_paths_count_one_retirement_month():
    alive = roofline.rows_work(ESS, [0], [100], 100, 1)["ops"]
    ruined = roofline.rows_work(ESS, [0], [0], 100, 1)["ops"]
    assert ruined == pytest.approx(100 * 157 + 100 * 110)
    assert alive == pytest.approx(12 * ruined)
