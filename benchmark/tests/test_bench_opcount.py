"""The frozen essential-operation counts recomputed from the reference."""

import pytest

from benchmark import opcount, spec
from benchmark.reference import philox


@pytest.mark.parametrize("config", [c["name"] for c in spec.benchmark()["configs"]])
def test_frozen_counts_match_the_reference(config):
    cell = next(w["name"] for w in spec.benchmark()["workloads"] if w["config"] == config)
    c = spec.Cell(cell)
    assert opcount.count(c.config) == c.config_file["essential_ops"]


def test_draw_count_is_philox_rounds_and_three_normals():
    assert opcount.draw_ops() == 10 * 10 + 3 * 16
    # The float part of a normal, counted on the reference itself: the
    # shift, conversion, multiply-add, x * x, log1p, sqrt, 9 multiply-adds
    # and the product.
    import torch

    bits = torch.randint(0, 2**32 - 1, (64,), dtype=torch.int64)
    assert opcount._per_path(lambda: philox.to_normal(bits), 64) == philox.OPS_PER_NORMAL


def test_a_multiply_feeding_one_add_counts_once():
    import torch

    a, b, c = (torch.ones(8) for _ in range(3))
    assert opcount._per_path(lambda: a * b + c, 8) == 1
    assert opcount._per_path(lambda: (a * b + c, a * b), 8) == 2  # fused pair + a mul
    assert opcount._per_path(lambda: torch.where(a > b, a, c), 8) == 2
