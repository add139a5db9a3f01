"""The frozen reference against the port's plain version on the CPU, in
float64 at a small size: draws, probe and grid rows, the tracked run and
the served statistics."""

import json

import numpy as np
import pytest
import torch

from benchmark import spec, traffic
from benchmark.reference import check, loop, philox, stats
from monte_carlo_retirement_tpu_torch.config import Config
from monte_carlo_retirement_tpu_torch.engine import kernel
from monte_carlo_retirement_tpu_torch.engine.cuda_kernel import pack_grid
from monte_carlo_retirement_tpu_torch.engine.runner import Engine
from monte_carlo_retirement_tpu_torch.engine.simulator import RetirementMonteCarloSimulator
from monte_carlo_retirement_tpu_torch.hosts.payload import build_result
from monte_carlo_retirement_tpu_torch.models.retirement import stack_params
from monte_carlo_retirement_tpu_torch.ops import shocks

N = 3000


def household(cell, seed=12345):
    c = spec.Cell(cell)
    body = next(traffic.requests(c.config, c.mix, 0))
    return dict(body["config"], seed=seed, num_simulations_main=N, num_simulations_search=N)


def test_philox_words_and_normals_are_the_programs():
    block, lane = philox.path_index(9000, "cpu")
    for month in (1, 600, 2**31 + 5):
        ours = philox.words(987654321, block, month, lane)
        theirs = shocks.month_words(987654321, block, month, lane)
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b)
        assert torch.equal(philox.month_normals(987654321, block, lane, month),
                           shocks.month_normals(987654321, block, month, lane))
    assert philox.stream_seed(77, 1) == Engine(
        Config(**household("macunaima.plan")), main_seed_override=77,
        device="cpu")._stream_seed("final")


@pytest.mark.parametrize("cell", ["macunaima.plan", "jorge.plan"])
def test_probe_rows_equal_the_plain_version(cell):
    cfg = household(cell, 3003)
    eng = Engine(Config(**cfg), device="cpu")
    months = [0, 57, 231, 300]
    out = kernel.simulate(eng._pack(months, "search"), eng.statics, eng.retirement_years, N)
    ref = loop.Loop([cfg], months, philox.stream_seed(cfg["seed"], 0), N,
                    torch.float64).rows()
    assert torch.equal(out["success"], ref["success"])
    assert torch.equal(out["final_balance"], ref["final_balance"])
    assert np.array_equal(loop.success_pct([cfg], months, philox.stream_seed(cfg["seed"], 0),
                                           N, torch.float64, block_paths=4096),
                          np.array(eng.probe(months, N)))


def test_grid_rows_with_their_own_parameters_equal_the_plain_version():
    c = spec.Cell("macunaima.grid")
    variants = traffic.grid_variants(c.mix)[::37]
    base = dict(c.config, seed=4242)
    cfgs = [{**base, **v["overrides"]} for v in variants]
    months = [231] * len(cfgs)
    packed = pack_grid(stack_params([Config(**x) for x in cfgs]),
                       philox.stream_seed(4242, 1), months, 50, dtype=torch.float64)
    eng = Engine(Config(**cfgs[0]), device="cpu")
    out = kernel.simulate(packed, eng.statics, 50, N)
    ref = loop.Loop(cfgs, months, philox.stream_seed(4242, 1), N, torch.float64).rows()
    assert torch.equal(out["success"], ref["success"])
    assert torch.equal(out["final_balance"], ref["final_balance"])


@pytest.mark.parametrize("cell,months", [("macunaima.plan", 231), ("jorge.plan", 100),
                                         ("jorge.plan", 0)])
def test_tracked_run_and_served_statistics_equal_the_programs(cell, months):
    cfg = household(cell, 5005)
    eng = Engine(Config(**cfg), device="cpu")
    out = kernel.simulate(eng._pack(months, "final"), eng.statics, eng.retirement_years, N,
                          traj_len=1 + eng._t_scan(months) // 12)
    ref = loop.Loop([cfg], [months], philox.stream_seed(cfg["seed"], 1), N,
                    torch.float64).tracked()
    for key, value in ref.items():
        theirs = out[key]
        if key in ("trajectory", "price_levels", "withdrawal_rates"):
            theirs = theirs.t()[: value.shape[0]]
        assert torch.equal(torch.nan_to_num(theirs, 7.0), torch.nan_to_num(value, 7.0)), key
    sim = RetirementMonteCarloSimulator(Config(**cfg), device="cpu")
    sim.use_final_seeds()
    body = json.loads(json.dumps(build_result(Config(**cfg), sim, months, include_raw=False)))
    served = stats.served(ref, cfg["retirement_years"])
    numbers = check.compare_served(check.served_from_payload(body), served, N)
    assert numbers == {"final_success_pts": 0.0, "stats_rank": 0.0, "bins_moved": 0.0}


def test_percentiles_are_numpys_and_sit_at_their_rank():
    x = torch.randn(3, 1001, dtype=torch.float64)
    valid = x > -1.0
    cols = stats.Columns(x, valid)
    qs = (0.05, 0.5, 0.99)
    ours = cols.values(qs)
    for r in range(3):
        want = np.percentile(x[r][valid[r]].numpy(), [5, 50, 99])
        assert np.allclose(ours[r], want, rtol=0, atol=1e-12)
    assert cols.rank_gap(ours, qs) == 0.0
    srt = np.sort(x[0][valid[0]].numpy())
    moved = ours.copy()
    moved[0, 1] = srt[len(srt) // 2 + 10]  # ten paths above the median
    assert cols.rank_gap(moved, qs) == pytest.approx(10 / len(srt), abs=1.5 / len(srt))


def test_a_changed_answer_moves_the_numbers():
    cfg = household("jorge.plan", 1001)
    ref = loop.Loop([cfg], [60], philox.stream_seed(cfg["seed"], 1), N, torch.float64).tracked()
    served = stats.served(ref, cfg["retirement_years"])
    bent = dict(served, success_probability=served["success_probability"] + 0.5,
                trajectory=served["trajectory"] * 1.01)
    numbers = check.compare_served(bent, served, N)
    assert numbers["final_success_pts"] == pytest.approx(0.495)
    assert numbers["stats_rank"] > 1e-3
    assert check.compare_served(served, served, N)["stats_rank"] == 0.0
