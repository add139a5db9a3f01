"""A whole run of each cell without the card's check, at a size a test can
hold on the CPU (the server's plain versions in float64, the reference in
float64): sound, it reads correct; with the timed path broken underneath,
correct comes out false. The faults a cell of this system can have: half
of the paths left out with every statistic taken over the rest, and an
answer altered where it is produced (the kernels' outputs by 0.1%). One
chip, so no exchange between chips; no training step."""

import pytest

from benchmark import run

SMALL = {"search_paths": 1024, "final_paths": 1024, "paths": 1024, "clients": 1,
         "check_requests": 1, "check_rows": 4}
GRID = {"variants": {"monthly_expenses": {"from": 4000, "to": 14000, "count": 4},
                     "inv1_returns_mean": {"from": 0.06, "to": 0.14, "count": 2}}}
CELLS = {"macunaima.plan": 40, "jorge.plan": 30, "macunaima.grid": 25}


@pytest.fixture(autouse=True)
def capped(monkeypatch):
    # The served path's binned payload, as at the cells' own 1M paths.
    monkeypatch.setenv("MCRT_MAX_RAW_PATHS", "256")


def one(cell, fault=None, trace=False):
    sizes = dict(SMALL, **(GRID if "grid" in cell else {}))
    return run.run_cell(cell, 2**31 + 11, CELLS[cell], trace, device="cpu",
                        fault=fault, sizes=sizes)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    res = one(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = one(cell, fault)
    assert res["correct"] is False, res["checks"]


def test_a_traced_run_reads_the_spans():
    res = one("jorge.plan", trace=True)
    assert res["correct"] is True
    for name in ("server.self_ms.plan", "search.ms", "final.ms"):
        assert res["metrics"][name]["value"] > 0
    # The CPU's plain versions bump no kernel launch counter.
    assert res["metrics"]["search.probes"]["value"] == 0
    assert "breakdown" in res and res["device"]["window_s"] > 0
