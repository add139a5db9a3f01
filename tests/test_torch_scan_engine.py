"""The scan backend of the port's entries against the JAX package's, on
the CPU.

``Engine(backend="scan")`` draws the JAX engine's threefry streams
(``search_key``/``final_key``) and runs the plain loop's month body, so on
the same main seed it must count the same survivors as the JAX engine (CPU,
float64; JAX averages them in float32, so percentages within 1e-4
points), find the same working month and give the same run tables to
1e-9. ``run_scenario_grid`` and ``sensitivity_fd`` take ``backend`` as JAX
does (the scan branch in float32 in both packages); the optimizers pass
it on. Unknown backends raise JAX's errors, the three ``MCRT_*_BACKEND``
knobs select them, and a scan over a mesh of CPU shards equals the
mesh-less scan.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import scenario_batch as jsb  # noqa: E402
from monte_carlo_retirement_tpu.engine import sensitivity as jsens  # noqa: E402
from monte_carlo_retirement_tpu.engine.runner import Engine as JaxEngine  # noqa: E402
from monte_carlo_retirement_tpu.engine.simulator import (  # noqa: E402
    RetirementMonteCarloSimulator as JaxSimulator,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import optimize as opt  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import scenario_batch as sb  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import sensitivity as sens  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.simulator import (  # noqa: E402
    RetirementMonteCarloSimulator,
)
from monte_carlo_retirement_tpu_torch.ops.shocks import stream_keys  # noqa: E402
from monte_carlo_retirement_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024 + 17
MONTHS = [40, 44, 48, 52, 56, 60]
W = 52  # a month where ruin and success both happen
KNOBS = ("MCRT_PROBE_BACKEND", "MCRT_RUN_BACKEND", "MCRT_GRID_BACKEND")
RUN_FIELDS = ("success_probability", "median_start_balance",
              "median_final_successful", "swr", "final_balance_percentiles",
              "trajectory_percentiles", "real_trajectory_percentiles",
              "sample_trajectories", "sample_real_trajectories",
              "wr_percentiles", "wr_observation_counts", "success",
              "final_balance", "start_balance", "years_to_ruin",
              "first_year_gross", "first_year_real_gross",
              "inflation_at_retirement")


def _raw(**over):
    with open(os.path.join(REPO, "config.json"), encoding="utf-8") as fh:
        raw = json.load(fh)
    raw.update(seed=2026, retirement_years=5, num_simulations_search=N,
               num_simulations_main=N)
    raw.update(over)
    return raw


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX engine's probe, search and run on the CPU in float64 (its
    auto backend there is the scan)."""
    raw = _raw()
    eng = JaxEngine(JaxConfig(**raw))
    probe = eng.probe(MONTHS, N)
    month, prob, curve = JaxSimulator(JaxConfig(**raw)).find_minimum_working_months(
        verbose=False)
    return dict(engine=eng, probe=probe, month=month, prob=prob, curve=curve,
                run=eng.run(month, N))


def test_engine_keys_are_jax_stream_keys(jax_side):
    eng = Engine(Config(**_raw()), device="cpu")
    want = jax_side["engine"]
    assert eng.search_key == tuple(int(v) for v in np.asarray(want.search_key))
    assert eng.final_key == tuple(int(v) for v in np.asarray(want.final_key))
    assert (eng.search_key, eng.final_key) == stream_keys(2026)


def test_scan_probe_counts_equal_jax(jax_side):
    got = Engine(Config(**_raw()), device="cpu").probe(MONTHS, N, backend="scan")
    want = jax_side["probe"]
    counts = [round(p * N / 100.0) for p in got]
    assert counts == [round(p * N / 100.0) for p in want]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert 0.0 < min(got) < 100.0


def test_scan_search_finds_jax_month(jax_side, monkeypatch):
    monkeypatch.setenv("MCRT_PROBE_BACKEND", "scan")
    month, prob, curve = RetirementMonteCarloSimulator(
        Config(**_raw()), device="cpu").find_minimum_working_months(verbose=False)
    assert month == jax_side["month"] > 0
    assert abs(prob - jax_side["prob"]) <= 1e-4
    assert [pt["working_months"] for pt in curve] == [
        pt["working_months"] for pt in jax_side["curve"]]


@pytest.mark.parametrize("reduced", (False, True), ids=("raw", "reduced"))
def test_scan_run_equals_jax(jax_side, reduced):
    month = jax_side["month"]
    got = Engine(Config(**_raw()), device="cpu").run(month, N, backend="scan",
                                                     reduced=reduced)
    want = jax_side["run"]
    for name in RUN_FIELDS:
        g = getattr(got, name)
        if reduced and isinstance(g, type(None)):
            continue
        w = np.asarray(getattr(want, name), dtype=float)
        g = np.asarray(g, dtype=float)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        ok = ~np.isnan(w)
        # JAX's success probability is a float32 mean.
        rtol = 1e-6 if name == "success_probability" else 1e-9
        np.testing.assert_allclose(g[ok], w[ok], rtol=rtol, err_msg=name)
    if reduced:
        assert got.bins is not None and got.success is None


@pytest.mark.parametrize("shards", (2, 4))
def test_scan_over_a_mesh_equals_meshless(shards):
    cfg = Config(**_raw())
    plain = Engine(cfg, device="cpu")
    meshed = Engine(cfg, device="cpu", mesh=make_mesh(["cpu"] * shards))
    n = 4096 + 33
    assert meshed.probe(MONTHS[:2], n, backend="scan") == plain.probe(
        MONTHS[:2], n, backend="scan")
    a, b = meshed.run(W, n, backend="scan"), plain.run(W, n, backend="scan")
    for name in RUN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), err_msg=name)


def _variants():
    return [_raw(monthly_expenses=e) for e in (9_000.0, 10_000.0, 11_000.0)]


def test_scan_grid_rows_equal_jax():
    raws = _variants()
    want = jsb.run_scenario_grid([JaxConfig(**r) for r in raws], [W] * 3, N,
                                 seed=5, backend="scan")
    got = sb.run_scenario_grid([Config(**r) for r in raws], [W] * 3, N,
                               seed=5, device="cpu", backend="scan")
    np.testing.assert_allclose(got.success_probability,
                               np.asarray(want.success_probability), atol=1e-4)
    assert 0.0 < got.success_probability.min() < got.success_probability.max() < 100.0
    assert (np.diff(got.success_probability) <= 0).all()
    for name in ("median_final_balance", "mean_final_balance",
                 "final_balance_percentiles"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name), dtype=float),
                                   rtol=2e-5, atol=1.0, err_msg=name)
    np.testing.assert_allclose(got.success_sigma, np.asarray(want.success_sigma),
                               atol=1e-4)


def test_scan_sensitivity_equals_jax():
    names = ["monthly_expenses", "initial_balance"]
    want = jsens.sensitivity_fd(JaxConfig(**_raw()), W, num_paths=N, seed=3,
                                params=names, backend="scan")
    got = sens.sensitivity_fd(Config(**_raw()), W, num_paths=N, seed=3,
                              params=names, device="cpu", backend="scan")
    assert [r.param for r in got] == names
    for g, w in zip(got, want):
        for field in ("base_value", "step_plus", "step_minus"):
            assert getattr(g, field) == getattr(w, field)
        for field in ("success_base", "success_plus", "success_minus"):
            assert abs(getattr(g, field) - getattr(w, field)) <= 1e-4, field
        scale = abs(w.d_success) + 1e-12
        assert abs(g.d_success - w.d_success) <= 1e-4 * scale + 1e-4 / (
            g.step_plus + g.step_minus), (g, w)
    assert got[0].d_success < 0.0 < got[1].d_success


def test_optimizer_passes_the_backend_on(monkeypatch):
    seen = []
    real = sb.run_scenario_grid

    def spy(*args, **kw):
        seen.append(kw.get("backend"))
        return real(*args, **kw)

    monkeypatch.setattr(opt, "run_scenario_grid", spy)
    res = opt.optimize_param(Config(**_raw()), W, "allocation_inv1_pct",
                             num_paths=256, points=3, rounds=1, device="cpu",
                             backend="scan")
    assert seen == ["scan"] and res.evaluations == 3
    joint = opt.optimize_params(Config(**_raw()), W, ["allocation_inv1_pct"],
                                num_paths=256, points=3, rounds=1, device="cpu",
                                backend="scan")
    assert seen == ["scan", "scan"]
    assert joint.best.values[0] == res.best.value


@pytest.mark.parametrize("entry", ("probe", "run"))
def test_unknown_backends_raise_jax_errors(jax_side, entry):
    eng = Engine(Config(**_raw()), device="cpu")
    jeng = jax_side["engine"]
    call = (lambda e, b: e.probe([10], 64, backend=b)) if entry == "probe" else (
        lambda e, b: e.run(10, 64, backend=b))
    for bad in ("bogus", "pallas_sharded"):
        with pytest.raises(ValueError) as want:
            call(jeng, bad)
        with pytest.raises(ValueError) as got:
            call(eng, bad)
        assert str(got.value) == str(want.value)


def test_unknown_grid_backend_raises_jax_error():
    raws = _variants()[:1]
    with pytest.raises(ValueError) as want:
        jsb.run_scenario_grid([JaxConfig(**r) for r in raws], [10], 64,
                              backend="bogus")
    with pytest.raises(ValueError) as got:
        sb.run_scenario_grid([Config(**r) for r in raws], [10], 64,
                             device="cpu", backend="bogus")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs a mesh"):
        sb.run_scenario_grid([Config(**r) for r in raws], [10], 64,
                             device="cpu", backend="pallas_sharded")


def test_knobs_select_the_backends(monkeypatch):
    cfg = Config(**_raw())
    eng = Engine(cfg, device="cpu")
    ck.reset_counts()
    auto = eng.probe([W], N)
    assert ck.PLAIN_CALLS["probe"] == 1  # CPU auto: the kernel's plain version
    scan = eng.probe([W], N, backend="scan")
    assert ck.PLAIN_CALLS["probe"] == 1 and auto != scan
    monkeypatch.setenv("MCRT_PROBE_BACKEND", "scan")
    assert eng.probe([W], N) == scan
    monkeypatch.setenv("MCRT_PROBE_BACKEND", "nope")
    with pytest.raises(ValueError, match="Unknown probe backend 'nope'"):
        eng.probe([W], N)
    monkeypatch.setenv("MCRT_RUN_BACKEND", "scan")
    a, b = eng.run(W, 300), eng.run(W, 300, backend="scan")
    np.testing.assert_array_equal(a.final_balance, b.final_balance)
    assert ck.PLAIN_CALLS["full"] == 0
    monkeypatch.setenv("MCRT_GRID_BACKEND", "scan")
    cfgs = [Config(**r) for r in _variants()[:2]]
    g = sb.run_scenario_grid(cfgs, [W] * 2, 300, device="cpu")
    h = sb.run_scenario_grid(cfgs, [W] * 2, 300, device="cpu", backend="scan")
    np.testing.assert_array_equal(g.success_probability, h.success_probability)
    assert ck.PLAIN_CALLS["grid"] == 0


def test_float64_engine_on_the_card():
    if torch.cuda.is_available():
        eng = Engine(Config(**_raw()), dtype=torch.float64, device="cuda")
        assert eng._resolve_backend(None, "probe") == "scan"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Engine(Config(**_raw()), dtype=torch.float64, device="cuda")


def test_scan_probe_percent_is_an_exact_count():
    eng = Engine(Config(**_raw()), device="cpu")
    (p,) = eng.probe([W], 777, backend="scan")
    assert math.isclose(p * 777 / 100.0, round(p * 777 / 100.0), abs_tol=1e-9)


def test_pallas_backend_of_a_meshed_engine_runs_one_device():
    """``backend="pallas"`` on an engine with a mesh is the kernels on its
    device alone (JAX's rule), equal to the mesh-less engine's."""
    cfg = Config(**_raw())
    plain = Engine(cfg, device="cpu")
    meshed = Engine(cfg, device="cpu", mesh=make_mesh(["cpu"] * 2))
    assert meshed.probe(MONTHS[:2], 600, backend="pallas") == plain.probe(
        MONTHS[:2], 600)
    a, b = meshed.run(W, 600, backend="pallas"), plain.run(W, 600)
    np.testing.assert_array_equal(a.final_balance, b.final_balance)
    assert meshed.mesh is not None
