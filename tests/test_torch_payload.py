"""The port's serving payload against the JAX package's and against itself.

The same per-path arrays, made with numpy from a seed, go through JAX
``ops/stats.serving_bins`` and the port's (every field equal), and through
the payload's numpy binning; the same fake-simulator 7-tuple goes through
both packages' ``build_result`` (equal dicts). On the CPU in float64 the
port's device-reduced payload equals its pandas payload byte for byte, as
``tests/test_reduced_payload.py`` holds the JAX package's. The dashboard's
``views.js`` renders the port's payloads under ``tools/jsmini``.
"""

import json
import math

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.engine.kernel import PathOutputs  # noqa: E402
from monte_carlo_retirement_tpu.engine.simulator import (  # noqa: E402
    RetirementMonteCarloSimulator as JaxSimulator,
)
from monte_carlo_retirement_tpu.hosts import payload as jax_payload  # noqa: E402
from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.ops.stats import (  # noqa: E402
    serving_bins as jax_serving_bins,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import (  # noqa: E402
    Engine,
    HostBins,
)
from monte_carlo_retirement_tpu_torch.engine.simulator import (  # noqa: E402
    RetirementMonteCarloSimulator,
)
from monte_carlo_retirement_tpu_torch.hosts import cli  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import payload  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts.schemas import (  # noqa: E402
    SimulationResponse,
)
from monte_carlo_retirement_tpu_torch.ops.stats import serving_bins  # noqa: E402
from monte_carlo_retirement_tpu_torch.timing import (  # noqa: E402
    expected_trajectory_length,
)
from tests.conftest import base_config_dict  # noqa: E402
from tools.jsmini import load_frontend  # noqa: E402

torch.set_num_threads(2)
R_YEARS = 6

BIN_CASES = ["random", "all_succeed", "none_succeed", "one_success",
             "constant", "bin_edges", "ruin_at_R", "integer_ruin_max", "two_paths"]


def _arrays(case):
    """(finals, success, years_to_ruin) of one adversarial case."""
    rng = np.random.default_rng(BIN_CASES.index(case))
    n = 2 if case == "two_paths" else 64
    success = rng.random(n) < 0.7
    if case == "all_succeed":
        success[:] = True
    elif case == "none_succeed":
        success[:] = False
    elif case == "one_success":
        success[:] = False
        success[17] = True
    elif case == "two_paths":
        success[:] = [True, False]
    finals = np.where(success, rng.uniform(0.0, 5e6, n), 0.0)
    if case == "constant":
        finals[success] = 12345.6789
    elif case == "bin_edges":
        # Every success on an edge lo + k * width (k = 0..60), in float64.
        lo, width = 1000.0, 1234.5678
        k = rng.integers(0, 61, n)
        k[:2] = (0, 60)
        success[:2] = True
        finals = np.where(success, lo + k * width, 0.0)
    ytr = np.where(success, np.nan, rng.uniform(0.0, R_YEARS, n))
    if case == "ruin_at_R":
        ytr[~success] = np.where(rng.random((~success).sum()) < 0.5,
                                 float(R_YEARS), np.floor(ytr[~success]))
    elif case == "integer_ruin_max":
        fail = np.flatnonzero(~success)
        ytr[fail] = np.minimum(ytr[fail], 3.9)
        ytr[fail[0]] = 4.0  # an exact-integer maximum exercises the clamp
    return finals, success, ytr


def _outs(finals, success, ytr, dtype):
    n = len(finals)
    return {
        "success": torch.from_numpy(success.astype(np.float64)).to(dtype),
        "final_balance": torch.from_numpy(finals).to(dtype),
        "years_to_ruin": torch.from_numpy(ytr).to(dtype),
        "withdrawal_rates": torch.ones((n, R_YEARS), dtype=dtype),
    }


@pytest.mark.parametrize("case", BIN_CASES)
def test_serving_bins_equal_jax(case):
    finals, success, ytr = _arrays(case)
    n = len(finals)
    got = serving_bins(_outs(finals, success, ytr, torch.float64))
    want = jax_serving_bins(PathOutputs(
        success=jnp.asarray(success), final_balance=jnp.asarray(finals),
        start_balance=jnp.ones(n), years_to_ruin=jnp.asarray(ytr),
        first_year_gross=jnp.ones(n), first_year_real_gross=jnp.ones(n),
        inflation_at_retirement=jnp.ones(n), trajectory=jnp.ones((n, 3)),
        price_levels=jnp.ones((n, 3)), withdrawal_rates=jnp.ones((n, R_YEARS)),
    ))
    assert got._fields == want._fields
    for name in got._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", BIN_CASES)
def test_serving_bins_equal_numpy_binning(case, dtype):
    """The device counts equal the payload's numpy binning of the same
    values; in float32 too, the card's dtype, with float32 edge values."""
    finals, success, ytr = _arrays(case)
    if dtype == torch.float32:
        finals, ytr = finals.astype(np.float32), ytr.astype(np.float32)
    bins = serving_bins(_outs(finals, success, ytr, dtype))
    host = {name: v.numpy() for name, v in zip(bins._fields, bins)}
    hb = HostBins(**{k: (v if v.ndim else v.item()) for k, v in host.items()})
    assert payload._binned_finals_from_device(hb, len(finals)) == \
        payload.bin_successful_finals(finals, success)
    failed = ytr[~success & ~np.isnan(ytr)]
    assert payload._ruin_counts_from_device(hb) == \
        payload.bin_years_to_ruin(failed)


def _fake_tuple(seed, months, with_success=True, tables=True):
    rng = np.random.default_rng(seed)
    n, R = 40, 3
    L = expected_trajectory_length(months, R)
    success = rng.random(n) < 0.75
    summary = {
        "Start Balance": rng.uniform(5e4, 2e5, n),
        "Final Balance": np.where(success, rng.uniform(0, 3e5, n), 0.0),
        "Success": success,
        "YearsToRuin": np.where(success, np.nan, rng.uniform(0, R, n)),
        "First Year Gross Withdrawal": rng.uniform(1e3, 9e3, n),
        "First Year Real Gross Withdrawal": rng.uniform(1e3, 9e3, n),
        "Inflation At Retirement": rng.uniform(1.0, 1.5, n),
    }
    if not with_success:
        del summary["Success"]
    df = pd.DataFrame(summary)
    if not tables:
        return df, None, None, None, None, None, None
    pcts = [0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95]
    traj = pd.DataFrame(np.sort(rng.uniform(0, 1e6, (L, 7)), axis=1), columns=pcts)
    real = pd.DataFrame(np.sort(rng.uniform(0, 1e6, (L, 7)), axis=1), columns=pcts)
    wr = rng.uniform(2, 8, (R, 5))
    wr[-1, :] = np.nan
    wr_df = pd.DataFrame(wr, columns=[0.1, 0.25, 0.5, 0.75, 0.9])
    samples = rng.uniform(0, 1e6, (5, L)).tolist()
    samples_real = rng.uniform(0, 1e6, (5, L)).tolist()
    return df, traj, samples, wr_df, real, samples_real, [n, n - 3, 0]


@pytest.mark.parametrize("kind", ["raw", "capped", "no_success_column",
                                  "no_tables", "search_curve"])
def test_build_result_equals_jax_on_fake_simulator(kind, monkeypatch):
    monkeypatch.setenv("MCRT_MAX_RAW_PATHS", "10" if kind == "capped" else "20000")
    months = 26 if kind == "no_tables" else 24
    result = _fake_tuple(3, months, with_success=kind != "no_success_column",
                         tables=kind != "no_tables")

    class Fake:
        def run_monte_carlo_simulations(self, **_kwargs):
            return result

    raw = base_config_dict(num_simulations_main=40, retirement_years=3,
                           current_age=44.3, other_income_streams=[
                               {"name": "pension", "monthly_amount_today": 900.0,
                                "start_at_age": 50, "inflation_indexed": True,
                                "tax_rate": 0.1}])
    curve = ([{"working_months": 24, "working_years": 2.0, "probability": 70.0},
              {"working_months": 12, "working_years": 1.0, "probability": 50.0},
              {"working_months": 24, "working_years": 2.0, "probability": 72.0}]
             if kind == "search_curve" else None)
    got = payload.build_result(Config(**raw), Fake(), months, search_curve=curve)
    want = jax_payload.build_result(JaxConfig(**raw), Fake(), months,
                                    search_curve=curve)
    assert got == want
    SimulationResponse.model_validate(got)


SCENARIOS = {
    "plain": dict(num_simulations_main=64, retirement_years=5, seed=77,
                  monthly_expenses=2_600.0),
    "streams_partial_year": dict(
        num_simulations_main=48, retirement_years=6, seed=13,
        monthly_expenses=3_100.0, current_age=44.3,
        other_income_streams=[
            {"name": "pension", "monthly_amount_today": 900.0,
             "start_at_age": 50, "inflation_indexed": True, "tax_rate": 0.1},
            {"name": "rent", "monthly_amount_today": 400.0, "start_at_age": 47,
             "duration_years": 4, "inflation_indexed": False, "tax_rate": 0.0},
        ]),
    "annual_tax_heavy_failures": dict(
        num_simulations_main=64, retirement_years=4, seed=31,
        initial_balance=160_000.0, monthly_expenses=3_400.0,
        inv1_annual_tax_on_gains_rate=0.25, inv2_annual_tax_on_gains_rate=0.15,
        equity_inflation_correlation=-0.4),
    "no_success": dict(num_simulations_main=32, retirement_years=2, seed=9,
                       initial_balance=1_000.0, monthly_expenses=50_000.0),
}


@pytest.mark.parametrize("months", [0, 31])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reduced_payload_equals_pandas_payload(monkeypatch, name, months):
    """On the CPU in float64 the reduced assembly and the pandas assembly
    of the same capped run give the same bytes."""
    monkeypatch.setenv("MCRT_MAX_RAW_PATHS", "10")
    config = Config(**base_config_dict(**SCENARIOS[name]))
    sim = RetirementMonteCarloSimulator(config, device="cpu")
    sim.use_final_seeds()
    ck.reset_counts()
    reduced = payload.build_result(config, sim, months)
    assert ck.PLAIN_CALLS["full"] == 1
    sim2 = RetirementMonteCarloSimulator(config, device="cpu")
    sim2.use_final_seeds()
    pandas_capped = payload._build_result_pandas(config, sim2, months, None,
                                                 capped=True)
    assert json.dumps(reduced) == json.dumps(pandas_capped)
    SimulationResponse.model_validate(reduced)
    if name == "no_success":
        assert reduced["histogram"]["binned"] is None
        assert reduced["summary"]["median_final_balance_successful"] == 0.0
        assert reduced["ruin_histogram"]["failure_count"] == 32


def test_reduced_run_keeps_vectors_on_the_device():
    """``run(reduced=True)``: the same tables as the full run, no per-path
    array, the bins in host types."""
    eng = Engine(Config(**base_config_dict(**SCENARIOS["plain"])), device="cpu")
    full = eng.run(18, 64)
    red = eng.run(18, 64, reduced=True)
    assert full.bins is None and red.success is None and red.final_balance is None
    for name in ("trajectory_percentiles", "real_trajectory_percentiles",
                 "sample_trajectories", "wr_percentiles", "wr_observation_counts",
                 "final_balance_percentiles"):
        a, b = getattr(full, name), getattr(red, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("success_probability", "median_start_balance", "swr",
                 "median_final_successful"):
        assert getattr(full, name) == getattr(red, name), name
    bins = red.bins
    assert isinstance(bins.success_count, int) and isinstance(bins.ruin_max, float)
    assert bins.success_count == int(full.success.sum())
    assert bins.finals_hist_counts.dtype == np.int64
    assert bins.ruin_counts.shape == (eng.retirement_years + 1,)


def test_run_path_has_the_jax_keys():
    raw = base_config_dict(retirement_years=3, seed=5, monthly_expenses=1_500.0)
    sim = RetirementMonteCarloSimulator(Config(**raw), device="cpu")
    got = sim._run_single_simulation_path(13)
    want = JaxSimulator(JaxConfig(**raw))._run_single_simulation_path(13)
    assert list(got) == list(want)
    assert len(got["Trajectory"]) == len(want["Trajectory"])
    assert len(got["WithdrawalRateTrajectory"]) == 3
    assert got["Start Balance"] > 0 and math.isfinite(got["Final Balance"])


def test_cli_json_out_on_the_main_run(tmp_path, monkeypatch):
    """--json-out on the main run writes the /api/simulate payload of the
    final batch it already ran (no second run)."""
    cfg_path = tmp_path / "scenario.json"
    cfg_path.write_text(json.dumps(base_config_dict(
        scenario="json out", retirement_years=3, num_simulations_main=16,
        monthly_expenses=500.0, seed=6)))
    out = tmp_path / "result.json"
    monkeypatch.chdir(tmp_path)
    calls = []
    original = RetirementMonteCarloSimulator.run_monte_carlo_simulations

    def counted(self, *a, **k):
        calls.append(a)
        return original(self, *a, **k)

    monkeypatch.setattr(RetirementMonteCarloSimulator,
                        "run_monte_carlo_simulations", counted)
    cli.main([str(cfg_path), "--device", "cpu", "--override", "13",
              "--json-out", str(out)])
    parsed = SimulationResponse.model_validate(json.loads(out.read_text()))
    assert parsed.summary.required_working_months == 13
    assert len(parsed.histogram.final_balances) == 16
    assert len(calls) == 1


def _floatify(value):
    """JSON numbers are doubles in JS."""
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return float(value)
    if isinstance(value, list):
        return [_floatify(v) for v in value]
    if isinstance(value, dict):
        return {k: _floatify(v) for k, v in value.items()}
    return value


@pytest.fixture(scope="module")
def port_payloads():
    config = Config(**base_config_dict(num_simulations_main=64, retirement_years=6,
                                       seed=21, monthly_expenses=2_800.0))
    curve = [{"working_months": 0, "working_years": 0.0, "probability": 40.0},
             {"working_months": 18, "working_years": 1.5, "probability": 85.0}]
    out = {}
    for include_raw in (True, False):
        sim = RetirementMonteCarloSimulator(config, device="cpu")
        sim.use_final_seeds()
        out[include_raw] = _floatify(payload.build_result(
            config, sim, 18, search_curve=curve, include_raw=include_raw))
    return out


def _bars(card):
    svg = card.querySelector("svg")
    return [(float(r.getAttribute("x")), float(r.getAttribute("height")))
            for r in svg.getElementsByTagName("rect")
            if r.getAttribute("opacity") == "0.8"]


@pytest.mark.parametrize("include_raw", [True, False])
def test_dashboard_renders_port_payload(port_payloads, include_raw):
    fe = load_frontend(["charts.js", "views.js", "api.js"])
    data = port_payloads[include_raw]
    card = fe.call("views.js", "summaryCard", data)
    s = data["summary"]
    assert f"{s['success_probability']:.2f}%" in card.textContent
    assert "Estimated working period" in card.textContent
    header = card.querySelector("table.pct-table").getElementsByTagName("th")
    assert [h.textContent for h in header][:2] == ["P1", "P5"]
    traj = fe.call("views.js", "trajectoryCard", data)
    assert len(traj.querySelector("svg").getElementsByTagName("path")) >= 8
    assert "Retirement Starts" in traj.textContent
    hist = fe.call("views.js", "histogramCard", data["histogram"])
    assert _bars(hist)


def test_dashboard_bins_of_both_forms_draw_the_same_bars(port_payloads):
    fe = load_frontend(["charts.js", "views.js", "api.js"])
    raw = _bars(fe.call("views.js", "histogramCard", port_payloads[True]["histogram"]))
    binned = _bars(fe.call("views.js", "histogramCard",
                           port_payloads[False]["histogram"]))
    assert len(raw) == len(binned)
    for (rx, rh), (bx, bh) in zip(raw, binned):
        assert rh == bh and abs(rx - bx) < 0.01
