"""The reference's six extensions: against the port's plain version on
the CPU, in float64 at a small size (probe rows, grid rows with their own
parameters, the tracked run and its served statistics, for each extension
alone on macunaima's household and for all six together); against each
rule's stated semantics, apart from the port's order of operations; and a
configuration with every extension on (written here; no entry in
BENCHMARK.json) checked, controlled and counted through the harness."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, opcount, spec, traffic
from benchmark.reference import check, loop, philox, stats
from monte_carlo_retirement_tpu_torch.config import Config
from monte_carlo_retirement_tpu_torch.engine import kernel
from monte_carlo_retirement_tpu_torch.engine.cuda_kernel import pack_grid
from monte_carlo_retirement_tpu_torch.engine.runner import Engine
from monte_carlo_retirement_tpu_torch.engine.simulator import RetirementMonteCarloSimulator
from monte_carlo_retirement_tpu_torch.hosts.grid import (GridRequest, prepare_grid,
                                                         run_prepared_grid)
from monte_carlo_retirement_tpu_torch.hosts.payload import build_result
from monte_carlo_retirement_tpu_torch.models.retirement import stack_params

# One 4096-path block and part of the next: under antithetic sampling the
# second block's paths mirror the first's.
N = 4096 + 1000
# chip_smoke.py's settings of each extension (its EXTENSIONS), and all six
# together on a rent that is fixed-nominal and capped (its ALL_ON).
CRASHES = {"frequency_per_year": 0.2, "mean_drop_pct": 25.0, "size_volatility": 0.1,
           "inv2_beta": 0.3}
LONGEVITY = {"mode_age": 88.0, "dispersion_years": 10.0, "max_age": 110.0}
GUARDRAILS = {"upper_wr_pct": 6.0, "lower_wr_pct": 3.0}
EXTENSIONS = {
    "bills": dict(inv1_use_realized_gains_tax_system=False,
                  inv1_annual_tax_on_gains_rate=0.15),
    "glide": dict(allocation_inv1_final_pct=0.4),
    "guardrails": dict(spending_guardrails=GUARDRAILS),
    "jumps": dict(market_crashes=CRASHES),
    "mortality": dict(longevity=LONGEVITY),
    "antithetic": dict(antithetic=True),
}
ALL_ON = {k: v for ext in EXTENSIONS.values() for k, v in ext.items()}
RENT = dict(monthly_amount_today=1500.0, inflation_indexed=False, duration_years=35)


def household(ext, seed=12345, n=N):
    """macunaima's household with ``ext`` on ("all": every extension)."""
    c = spec.Cell("macunaima.plan")
    cfg = dict(next(traffic.requests(c.config, c.mix, 0))["config"], seed=seed,
               num_simulations_main=n, num_simulations_search=n)
    if ext == "all":
        streams = cfg["other_income_streams"]
        cfg.update(ALL_ON, other_income_streams=[streams[0], dict(streams[1], **RENT)])
    else:
        cfg.update(EXTENSIONS[ext])
    return cfg


CASES = sorted(EXTENSIONS) + ["all"]


@pytest.mark.parametrize("ext", CASES)
def test_probe_rows_equal_the_plain_version(ext):
    cfg = household(ext, 3003)
    eng = Engine(Config(**cfg), device="cpu")
    months = [0, 57, 231, 300]
    out = kernel.simulate(eng._pack(months, "search"), eng.statics, eng.retirement_years, N)
    ref = loop.Loop([cfg], months, philox.stream_seed(cfg["seed"], 0), N,
                          torch.float64).rows()
    assert torch.equal(out["success"], ref["success"])
    assert torch.equal(out["final_balance"], ref["final_balance"])


def test_blocks_of_paths_with_their_offsets_equal_the_probe():
    # 4096-path blocks: the second starts at an odd key block, the mirror
    # of the first under antithetic sampling.
    cfg = household("all", 3003)
    months = [57, 231]
    eng = Engine(Config(**cfg), device="cpu")
    assert np.array_equal(
        loop.success_pct([cfg], months, philox.stream_seed(cfg["seed"], 0), N,
                         torch.float64, block_paths=4096),
        np.array(eng.probe(months, N)))


@pytest.mark.parametrize("ext", CASES)
def test_grid_rows_with_their_own_parameters_equal_the_plain_version(ext):
    c = spec.Cell("macunaima.grid")
    variants = traffic.grid_variants(c.mix)[::51]
    base = household(ext, 4242)
    cfgs = [{**base, **v["overrides"]} for v in variants]
    months = [231] * len(cfgs)
    packed = pack_grid(stack_params([Config(**x) for x in cfgs]),
                       philox.stream_seed(4242, 1), months, 50, dtype=torch.float64)
    eng = Engine(Config(**cfgs[0]), device="cpu")
    out = kernel.simulate(packed, eng.statics, 50, N)
    ref = loop.Loop(cfgs, months, philox.stream_seed(4242, 1), N, torch.float64).rows()
    assert torch.equal(out["success"], ref["success"])
    assert torch.equal(out["final_balance"], ref["final_balance"])


# W = 100 ends retirement inside a year: the gain bills' last settle.
@pytest.mark.parametrize("ext,months", [(e, 231) for e in CASES]
                         + [("bills", 100), ("all", 100), ("all", 0)])
def test_tracked_run_and_served_statistics_equal_the_programs(ext, months):
    cfg = household(ext, 5005)
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


# --- each rule's stated semantics, apart from the port's order of operations --
UNTAXED = dict(inv1_use_realized_gains_tax_system=False, inv1_annual_tax_on_gains_rate=0.0,
               inv2_use_realized_gains_tax_system=False, inv2_annual_tax_on_gains_rate=0.0)


def test_crashes_keep_the_mean_gross_return_and_leave_inflation_alone():
    crashes = dict(CRASHES, frequency_per_year=2.0)
    cfg = household("jumps")
    cfg["market_crashes"] = crashes
    plain = dict(cfg, market_crashes=None)
    n, months = 4 * 4096, range(1, 33)
    run = loop.Loop([cfg], [0], 777, n, torch.float64)
    base = loop.Loop([plain], [0], 777, n, torch.float64)
    draws = [run.draw(m) for m in months]
    plain_draws = [base.draw(m) for m in months]
    g1 = torch.cat([d[0][0] for d in draws])
    gi = torch.cat([d[1][0] for d in draws])
    gp = torch.cat([(d[2] / d[1])[0] for d in draws])
    assert torch.equal(gi, torch.cat([d[1][0] for d in plain_draws]))
    # The yearly gross return net of the fund's cost is 1 + mean (asset 2:
    # on top of inflation), a month's its twelfth root.
    want1 = ((1 + cfg["inv1_returns_mean"]) * (1 - cfg.get("inv1_expense_ratio_annual", 0.0))
             ) ** (1 / 12)
    want2 = ((1 + cfg["inv2_premium_over_inflation_mean"])
             * (1 - cfg.get("inv2_expense_ratio_annual", 0.0))) ** (1 / 12)
    # The compensator of each asset, from the stated formula.
    freq = crashes["frequency_per_year"] / 12
    mu, sig = np.log(1 - crashes["mean_drop_pct"] / 100), crashes["size_volatility"]
    comp = lambda a: np.log(1 - freq + freq * np.exp(a * mu + (a * sig) ** 2 / 2))
    c1 = comp(1.0)
    for g, want in ((g1, want1), (gp, want2)):
        se = float(g.std()) / len(g) ** 0.5
        assert abs(float(g.mean()) - want) < 5 * se, (float(g.mean()), want, se)
    # Without it, the mean would fall by some p * drop a month.
    se = float(g1.std()) / len(g1) ** 0.5
    assert float(g1.mean()) * np.exp(c1) < want1 - 20 * se
    # A month without a crash moves asset 1 by the compensator alone; the
    # others come at the stated frequency.
    g1_plain = torch.cat([d[0][0] for d in plain_draws])
    crashed = float(((g1 / g1_plain - np.exp(-c1)).abs() > 1e-9).double().mean())
    assert abs(crashed - freq) < 5 * (freq * (1 - freq) / len(g1)) ** 0.5, crashed


def test_guardrails_step_at_year_starts_between_the_rails_and_clamp():
    cfg = household("guardrails")
    up, lo = GUARDRAILS["upper_wr_pct"] / 100, GUARDRAILS["lower_wr_pct"] / 100
    rates = torch.tensor([0.08, 0.045, 0.02], dtype=torch.float64)
    mults = torch.tensor([1.0, 0.52, 1.95], dtype=torch.float64)
    rate, smult = rates.repeat_interleave(3), mults.repeat(3)
    run = loop.Loop([cfg], [0], 11, 9, torch.float64)
    st = run.initial(1)
    total = 12 * cfg["monthly_expenses"] * smult / rate  # price level 1
    st.update(b1=(total * 0.6)[None], c1=(total * 0.6)[None], b2=(total * 0.4)[None],
              c2=(total * 0.4)[None], smult=smult[None].clone())
    want = torch.where(rate > up, smult * 0.9, torch.where(rate < lo, smult * 1.1, smult))
    want = want.clamp(0.5, 2.0)
    for m, stepped in ((13, True), (18, False), (25, True)):
        got = run.retire(m, st, run.draw(m))["smult"][0]
        assert torch.allclose(got, want if stepped else smult, rtol=1e-12, atol=0), m
    # The first retirement month is no year start.
    assert torch.equal(run.retire(1, st, run.draw(1))["smult"][0], smult)


def test_antithetic_pairs_negate_the_normals_and_reflect_the_uniforms():
    cfg = household("all", 8008)
    n = 4 * 4096
    run = loop.Loop([cfg], [100], 8008, n, torch.float64)
    even, odd = slice(0, 4096), slice(4096, 8192)
    for m in (1, 17, 300):
        z = run.planes(m)
        for plane in (0, 1, 2, 4):
            assert torch.equal(z[plane, odd], -z[plane, even])
        assert torch.equal(z[3, odd], 1.0 - z[3, even])
        assert not torch.equal(z[0, 2 * 4096:3 * 4096], z[0, even])
    # The lifetime uniform of the pair's first path, from its own key block.
    block, lane = philox.path_index(4096, "cpu")
    w = philox.words(8008 ^ loop.LIFETIME_SALT, block, 0, lane, counter=2)[0]
    u = loop.uniform(w).double()
    life = lambda x: loop.remaining_months(x, run.p["mort_g0"], run.p["mort_b12"],
                                           run.p["mort_cap"], run.w_f)[0]
    assert torch.equal(run.lifetime[0, even], life(u))
    assert torch.equal(run.lifetime[0, odd], life(1.0 - u))


def test_gain_bills_settle_at_absolute_year_ends():
    billed = {**household("bills", 9009), **UNTAXED, "inv1_annual_tax_on_gains_rate": 0.15}
    plain = dict(billed, inv1_annual_tax_on_gains_rate=0.0)
    n, w = 4096, 30
    run = loop.Loop([billed], [w], 9009, n, torch.float64)
    ref = loop.Loop([plain], [w], 9009, n, torch.float64)
    st, st0, gain = run.initial(1), ref.initial(1), torch.zeros((1, n), dtype=torch.float64)
    for m in range(1, 13):
        g = run.draw(m)
        gain = gain + st0["b1"] * (g[0] - 1.0)
        st, st0 = run.accumulate(m, st, g), ref.accumulate(m, st0, g)
        before, after = st0["b1"] + st0["b2"], st["b1"] + st["b2"]
        if m < 12:
            # Nothing is paid inside the year: the bill only accrues.
            assert torch.equal(after, before), m
    # Month 12 pays 15% of the year's positive gains on asset 1.
    assert torch.allclose(before - after, 0.15 * gain.clamp(min=0.0), rtol=1e-9, atol=1e-6)
    # In retirement (W = 30) the bill still settles at month 36, not at
    # the retirement year's end.
    for m in range(13, w + 1):
        st = run.accumulate(m, st, run.draw(m))
    for m in range(w + 1, 49):
        st = run.retire(m, st, run.draw(m))
        assert bool((st["g1a"] == 0).all()) == (m in (36, 48)), m


def test_the_glide_path_moves_the_target_linearly_then_holds():
    final = EXTENSIONS["glide"]["allocation_inv1_final_pct"]
    cfg = {**household("glide", 1010), **UNTAXED}
    start, w = cfg["allocation_inv1_pct"], 60
    run = loop.Loop([cfg], [w], 1010, 4096, torch.float64)
    st = run.initial(1)
    assert torch.allclose(st["b1"] / (st["b1"] + st["b2"]),
                          torch.tensor(start, dtype=torch.float64))
    for m in range(1, w + 1):
        st = run.accumulate(m, st, run.draw(m))
        want = start + (final - start) * m / w
        assert torch.allclose(st["b1"] / (st["b1"] + st["b2"]),
                              torch.tensor(want, dtype=torch.float64), rtol=1e-12), m
    for m in range(w + 1, w + 25):
        st = run.retire(m, st, run.draw(m))
        live = (st["alive"] > 0.5) & (st["b1"] + st["b2"] > 1.0)
        ratio = (st["b1"] / (st["b1"] + st["b2"]))[live]
        assert torch.allclose(ratio, torch.full_like(ratio, final), rtol=1e-12), m


def test_longevity_ends_spending_and_leaves_the_estate_invested():
    cfg = household("mortality", 6006)
    run = loop.Loop([cfg], [231], philox.stream_seed(6006, 1), N, torch.float64)
    out = run.tracked()
    died = run.lifetime[0] < 12 * 20  # owners who die within 20 years of retiring
    assert bool(died.any())
    # No year after death records a withdrawal rate; the estate still grows.
    year = 21
    assert bool(torch.isnan(out["withdrawal_rates"][year - 1][died]).all())
    assert bool((out["final_balance"][died] > 0).all())
    assert bool((out["success"][died] > 0.5).all())


# --- the harness -------------------------------------------------------------
SMALL = {"search_paths": 2048, "final_paths": 2048, "paths": 2048}
GRID = {"variants": {"monthly_expenses": {"from": 4000, "to": 14000, "count": 4},
                     "inv1_returns_mean": {"from": 0.06, "to": 0.14, "count": 2}}}


def extension_cell(tmp_path, name):
    """The workload ``name`` of BENCHMARK.json on a configuration written
    here: macunaima with every extension on."""
    path = tmp_path / "all_on.json"
    path.write_text(json.dumps({"name": "all_on", "config": dict(household("all"), seed=None)}))
    bench = spec.benchmark()
    bench["configs"] = [{"name": "all_on", "file": str(path)}]
    bench["workloads"] = [dict(w, config="all_on") for w in bench["workloads"]
                          if w["name"] == name]
    cell = spec.Cell(name, bench)
    cell.mix = dict(cell.mix, **SMALL, **(GRID if "grid" in name else {}))
    return cell


def test_the_count_of_an_extension_configuration_has_every_key(tmp_path):
    cell = extension_cell(tmp_path, "jorge.plan")
    ess = opcount.count(cell.config)
    assert set(ess) == {"draw", "factors", "accumulation", "retirement",
                        "tracked_accumulation", "tracked_retirement"}
    # An antithetic pair shares its draws, crashes included.
    assert ess["draw"] == opcount.draw_ops(cell.config) == (148 + 3 + 100 + 16) / 2 + 0.5
    base = spec.Cell("macunaima.plan").config_file["essential_ops"]
    assert all(ess[k] > base[k] for k in ("factors", "accumulation", "retirement"))


def test_the_programs_plan_answer_reads_within_the_limits(tmp_path):
    cell = extension_cell(tmp_path, "jorge.plan")
    body = next(traffic.requests(cell.config, cell.mix, 2**31 + 17))
    config = Config(**body["config"])
    sim = RetirementMonteCarloSimulator(config, device="cpu")
    months, _, curve = sim.find_minimum_working_months(verbose=False)
    sim.use_final_seeds()
    served = json.loads(json.dumps(build_result(config, sim, months, search_curve=curve,
                                                include_raw=False)))
    answer = check.answer_from_payload(200, served)
    numbers = check.plan_numbers(body, answer, torch.float64, "cpu")
    assert set(numbers) == set(cell.limits)
    assert all(numbers[k] <= lim for k, lim in cell.limits.items()), numbers


def test_the_programs_grid_answer_reads_within_the_limits(tmp_path):
    cell = extension_cell(tmp_path, "macunaima.grid")
    body = next(traffic.requests(cell.config, cell.mix, 2**31 + 19))
    served = json.loads(json.dumps(run_prepared_grid(prepare_grid(GridRequest(**body)),
                                                     device="cpu")))
    rows = [0, 3, 5, 6]
    numbers = check.grid_numbers(body, check.grid_answer(served, rows), rows,
                                 torch.float64, "cpu")
    assert set(numbers) == set(cell.limits)
    assert all(numbers[k] <= lim for k, lim in cell.limits.items()), numbers


def test_the_control_is_not_correct_on_the_extension_paths(tmp_path):
    cell = extension_cell(tmp_path, "jorge.plan")
    numbers = control.readings(cell, 2**31 + 23, 1, "cpu")
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers
