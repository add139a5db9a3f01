"""The dynamic household (``configs/macunaima_dynamic.json``, cell
``macunaima_dynamic.plan``): upstream's household plus the six extensions
at the values and sources its file states, the port's plan answer for it
within the cell's limits on the CPU in float64 at a small size, and the
bfloat16 control above at least one of them."""

import json

import torch

import chip_smoke
from benchmark import control, spec, traffic
from benchmark.reference import check
from monte_carlo_retirement_tpu_torch.config import Config
from monte_carlo_retirement_tpu_torch.engine.cuda_kernel import statics_from_config
from monte_carlo_retirement_tpu_torch.engine.simulator import RetirementMonteCarloSimulator
from monte_carlo_retirement_tpu_torch.hosts.payload import build_result

BENCH = spec.benchmark()
CELL = "macunaima_dynamic.plan"
ADDED = {"spending_guardrails", "longevity", "market_crashes", "allocation_inv1_final_pct",
         "inv1_use_realized_gains_tax_system", "inv1_annual_tax_on_gains_rate", "antithetic"}
PLAN_METRICS = ("plans_per_s", "server.self_ms.plan", "search.ms", "search.probes",
                "payload.self_ms", "final.ms", "reductions.card_ms", "probe_kernel.roofline_pct",
                "full_kernel.roofline_pct", "device.idle_pct.plan")
SMALL = {"search_paths": 2048, "final_paths": 2048}


def small_cell():
    cell = spec.Cell(CELL)
    cell.mix = dict(cell.mix, **SMALL)
    return cell


def test_the_configuration_is_upstream_plus_the_extensions_at_their_sources():
    with open(spec.ROOT / "config.json") as fh:
        upstream = json.load(fh)
    cell = spec.Cell(CELL)
    cfg, entry = cell.config, cell.config_entry
    changed = {k for k in upstream if upstream[k] != cfg[k]} | (set(cfg) - set(upstream))
    assert changed == set(entry["reduced"]) | ADDED
    assert changed <= set(cell.config_file["assumed"])
    wr0 = cell.config_file["wr0_pct"]
    assert str(round(wr0, 4)) in cell.config_file["assumed"]["wr0"]
    assert cfg["spending_guardrails"] == {
        "upper_wr_pct": round(1.2 * wr0, 1), "lower_wr_pct": round(0.8 * wr0, 1),
        "adjustment_pct": 10.0, "floor_pct": 50.0, "cap_pct": 200.0}
    assert cfg["longevity"] == chip_smoke.LONGEVITY
    assert cfg["market_crashes"] == chip_smoke.CRASHES
    assert cfg["allocation_inv1_final_pct"] == 0.4 and cfg["antithetic"] is True
    assert not cfg["inv1_use_realized_gains_tax_system"]
    assert cfg["inv1_annual_tax_on_gains_rate"] == 0.15
    # Every extension of the port's Statics is on; macunaima's has none.
    st = statics_from_config(Config(**cfg))
    assert (st.bill1, st.glide, st.guardrails, st.jumps, st.mortality, st.antithetic) == (True,) * 6
    assert not (st.bill2 or st.use_real1) and st.use_real2
    base = statics_from_config(Config(**spec.Cell("macunaima.plan").config))
    assert st._replace(use_real1=True, bill1=False, glide=False, guardrails=False, jumps=False,
                       mortality=False, antithetic=False) == base


def test_the_cell_runs_the_plan_mix_on_one_chip_and_joins_the_plan_metrics():
    entry = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "macunaima_dynamic", "plan.c4", 1)
    config = next(c for c in BENCH["configs"] if c["name"] == "macunaima_dynamic")
    assert config["reduced"] == ["num_simulations_main", "num_simulations_search"]
    assert len(config["source"]) <= 200
    metrics = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name in PLAN_METRICS:
        assert metrics[name]["workloads"][-1] == CELL, name
    reported = {m["name"] for m in spec.Cell(CELL).per_layer + spec.Cell(CELL).end_to_end}
    assert reported == set(PLAN_METRICS) | {"setup_s"}


def test_the_programs_plan_answer_reads_within_the_limits():
    cell = small_cell()
    body = next(traffic.requests(cell.config, cell.mix, 2**31 + 29))
    config = Config(**body["config"])
    sim = RetirementMonteCarloSimulator(config, device="cpu")
    months, _, curve = sim.find_minimum_working_months(verbose=False)
    assert months > 0
    sim.use_final_seeds()
    served = json.loads(json.dumps(build_result(config, sim, months, search_curve=curve,
                                                include_raw=False)))
    numbers = check.plan_numbers(body, check.answer_from_payload(200, served),
                                 torch.float64, "cpu")
    assert set(numbers) == set(cell.limits)
    assert all(numbers[k] <= lim for k, lim in cell.limits.items()), numbers


def test_the_control_reads_above_a_limit():
    cell = small_cell()
    numbers = control.readings(cell, 2**31 + 31, 1, "cpu")
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers
