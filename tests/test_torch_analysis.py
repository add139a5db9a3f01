"""The port's analysis modes (sensitivity, optimizer, CLI) vs the JAX package.

The arithmetic around the grid is held to the JAX package free of random
numbers: both packages' ``run_scenario_grid`` are replaced by one
deterministic function of the configs, so the finite-difference rows and
the optimizer's refinement must come out equal, value for value, and must
have asked for the same variants. The CLI's three modes run end to end on
the CPU at tiny sizes, and their ``--json-out`` payloads validate against
the JAX package's response models.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import optimize as jax_opt  # noqa: E402
from monte_carlo_retirement_tpu.engine import scenario_batch as jax_sb  # noqa: E402
from monte_carlo_retirement_tpu.engine import sensitivity as jax_sens  # noqa: E402
from monte_carlo_retirement_tpu.hosts.grid import GridResponse  # noqa: E402
from monte_carlo_retirement_tpu.hosts.optimize import (  # noqa: E402
    OptimizeJointResponse,
    OptimizeResponse,
)
from monte_carlo_retirement_tpu.hosts import sensitivity as jax_host_sens  # noqa: E402
from monte_carlo_retirement_tpu.hosts.sensitivity import (  # noqa: E402
    SensitivityResponse,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import optimize as opt  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import scenario_batch as sb  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import sensitivity as sens  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import cli  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import sensitivity as host_sens  # noqa: E402
from tests.conftest import base_config_dict  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")

BASE = base_config_dict(
    retirement_years=3, monthly_contribution=800.0, monthly_expenses=2_400.0,
    inv1_use_realized_gains_tax_system=True, inv1_realized_gains_tax_rate=0.15,
    num_simulations_main=256, num_simulations_search=128,
    target_probability=75.0,
)


def _fake_grid(result_cls, calls):
    """A deterministic stand-in for run_scenario_grid: every statistic is a
    smooth function of the config fields the analyses perturb, with an
    interior optimum in allocation and correlation."""

    def run(configs, working_months, num_simulations, seed=0, chunk_size=None,
            progress_callback=None, **_where):
        calls.append(([c.model_dump() for c in configs], list(working_months),
                      num_simulations, seed, chunk_size))
        f = lambda name: np.array([float(getattr(c, name)) for c in configs])
        score = (
            70.0 + 2e-5 * f("initial_balance") - 0.004 * f("monthly_expenses")
            + 0.003 * f("monthly_contribution") - 80.0 * (f("allocation_inv1_pct") - 0.53) ** 2
            + 90.0 * f("inv1_returns_mean") - 40.0 * f("inv1_returns_volatility")
            - 120.0 * f("inflation_rate_mean")
            - 9.0 * (f("equity_inflation_correlation") + 0.1) ** 2
            + 0.01 * np.asarray(working_months, dtype=float)
        )
        p = np.clip(score, 0.0, 100.0)
        median = 1e4 * score + 0.37 * f("initial_balance")
        mean = median * 1.1 + 17.0
        bands = np.stack([median * q for q in (0.2, 0.6, 1.0, 1.5, 2.5)], axis=1)
        sigma = np.sqrt(p / 100.0 * (1.0 - p / 100.0) / num_simulations) * 100.0
        if progress_callback is not None:
            progress_callback({"type": "grid_chunk", "done": len(configs),
                               "total": len(configs), "elapsed_s": 0.0})
        return result_cls(p, median, mean, sigma, bands)

    return run


@pytest.fixture
def fake_grids(monkeypatch):
    calls = {"port": [], "jax": []}
    port = _fake_grid(sb.ScenarioBatchResult, calls["port"])
    ref = _fake_grid(jax_sb.ScenarioBatchResult, calls["jax"])
    for module in (sens, opt):
        monkeypatch.setattr(module, "run_scenario_grid", port)
    for module in (jax_sens, jax_opt):
        monkeypatch.setattr(module, "run_scenario_grid", ref)
    return calls


@pytest.mark.parametrize(
    "params,rel_step,abs_step",
    [
        (None, 0.02, 0.005),
        (["allocation_inv1_pct", "equity_inflation_correlation",
          "inv1_realized_gains_tax_rate", "contribution_growth_rate_annual"],
         0.05, 0.01),
    ],
)
def test_sensitivity_fd_arithmetic_equals_jax(fake_grids, params, rel_step,
                                               abs_step):
    # Allocation at 1.0 pins the plus side: a one-sided probe.
    raw = dict(BASE, allocation_inv1_pct=1.0 if params else 0.6)
    got = sens.sensitivity_fd(Config(**raw), 30, num_paths=999, seed=4,
                              params=params, rel_step=rel_step,
                              abs_step=abs_step, device="cpu")
    want = jax_sens.sensitivity_fd(JaxConfig(**raw), 30, num_paths=999, seed=4,
                                   params=params, rel_step=rel_step,
                                   abs_step=abs_step)
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert fake_grids["port"] == fake_grids["jax"]
    assert sens.DEFAULT_PARAMS == jax_sens.DEFAULT_PARAMS
    assert sens.SENSITIVITY_PARAMS == jax_sens.SENSITIVITY_PARAMS
    if params:
        assert got[0].step_plus == 0.0 and got[0].step_minus > 0.0


@pytest.mark.parametrize("objective", ["success_probability", "p5_final_balance"])
def test_optimize_param_arithmetic_equals_jax(fake_grids, objective):
    kw = dict(num_paths=512, seed=3, objective=objective, lo=0.3, hi=0.9,
              points=9, rounds=3)
    got = opt.optimize_param(Config(**BASE), 24, "allocation_inv1_pct",
                             device="cpu", **kw)
    want = jax_opt.optimize_param(JaxConfig(**BASE), 24, "allocation_inv1_pct",
                                  **kw)
    assert got == want
    assert got.evaluations == 27 and got.interval[0] <= got.best.value <= got.interval[1]
    assert fake_grids["port"] == fake_grids["jax"]


def test_optimize_params_joint_arithmetic_equals_jax(fake_grids):
    kw = dict(num_paths=512, seed=1, bounds=[(0.2, 0.9), (-0.6, 0.6)],
              points=5, rounds=2)
    names = ["allocation_inv1_pct", "equity_inflation_correlation"]
    got = opt.optimize_params(Config(**BASE), 12, names, device="cpu", **kw)
    want = jax_opt.optimize_params(JaxConfig(**BASE), 12, names, **kw)
    assert got == want
    assert got.evaluations == 50 and len(got.surface) == 25
    assert fake_grids["port"] == fake_grids["jax"]
    assert opt.OBJECTIVES.keys() == jax_opt.OBJECTIVES.keys()
    assert opt.MAX_JOINT_ROWS == jax_opt.MAX_JOINT_ROWS
    for n_params in (1, 2):
        assert opt.default_points(n_params) == jax_opt.default_points(n_params)


def test_sensitivity_request_with_ad_raises():
    """``include_ad`` answers with the AD column (JAX's keys), and raises
    only where JAX does: for the FD-only dotted parameters."""
    kw = dict(config=BASE, working_months=6, num_paths=128, include_ad=True,
              ad_num_paths=128, params=["monthly_expenses", "initial_balance"])
    got = host_sens.run_sensitivity_request(
        host_sens.SensitivityRequest(**kw), device="cpu")
    want = jax_host_sens.run_sensitivity_request(
        jax_host_sens.SensitivityRequest(**kw))
    SensitivityResponse.model_validate(got)
    assert got.keys() == want.keys()
    assert [r.keys() for r in got["rows"]] == [r.keys() for r in want["rows"]]
    rows = {r["param"]: r for r in got["rows"]}
    assert rows["monthly_expenses"]["ad_d_mean_final"] < 0
    assert rows["initial_balance"]["ad_d_mean_final"] > 0
    dotted = dict(kw, config=dict(BASE, longevity={
        "mode_age": 80.0, "dispersion_years": 8.0, "max_age": 105.0}),
        params=["longevity.mode_age"])
    with pytest.raises(ValueError, match="FD-only"):
        host_sens.run_sensitivity_request(
            host_sens.SensitivityRequest(**dotted), device="cpu")


@pytest.mark.parametrize(
    "argv,message",
    [
        (["--grid", "g.json", "--sensitivity"], "mutually exclusive"),
        (["--opt-points", "5"], "requires --optimize"),
        (["--sensitivity", "--optimize", "allocation_inv1_pct"],
         "mutually exclusive"),
        (["--override", "-1"], "nonnegative"),
    ],
)
def test_cli_rejects_bad_mode_combinations(argv, message, capsys):
    with pytest.raises(SystemExit):
        cli._parse_args(["config.json"] + argv)
    assert message in capsys.readouterr().err


GRID_REQUEST = {
    "variants": [
        {"name": "lean", "overrides": {"monthly_expenses": 1_800.0}},
        {"overrides": {"monthly_expenses": 2_400.0}},
        {"overrides": {"monthly_expenses": 3_200.0, "inv1_returns_mean": 0.05}},
    ],
    "working_months": [12, 12, 18],
    "num_paths": 300,
    "chunk_size": 2,
}


@pytest.mark.parametrize(
    "mode",
    ["grid", "sensitivity", "optimize", "optimize_joint"],
)
def test_cli_analysis_modes_on_cpu(tmp_path, mode):
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(BASE))
    out = tmp_path / "out.json"
    args = {
        "grid": ["--grid", str(tmp_path / "grid.json")],
        # No --override: the searched month on the port's simulator.
        "sensitivity": ["--sensitivity", "monthly_expenses,initial_balance"],
        "optimize": ["--override", "12", "--optimize",
                     "allocation_inv1_pct:0.3:0.9", "--opt-points", "5",
                     "--opt-rounds", "2"],
        "optimize_joint": ["--override", "12", "--optimize",
                           "allocation_inv1_pct:0.3:0.9,"
                           "equity_inflation_correlation:-0.5:0.5",
                           "--opt-points", "3", "--opt-rounds", "1",
                           "--opt-objective", "p5_final_balance"],
    }[mode]
    (tmp_path / "grid.json").write_text(json.dumps(GRID_REQUEST))
    cmd = [sys.executable, "-m", "monte_carlo_retirement_tpu_torch.hosts.cli",
           str(cfg_path), "--device", "cpu", "--json-out", str(out)] + args
    proc = subprocess.run(cmd, cwd=tmp_path, env=PORT_ENV, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert out.exists(), proc.stderr[-3000:]
    payload = json.loads(out.read_text())
    if mode == "grid":
        res = GridResponse.model_validate(payload)
        assert [r.name for r in res.rows][0] == "lean"
        assert res.total_scenarios == 3 and res.num_paths == 300
        p = [r.success_probability for r in res.rows]
        assert p[0] >= p[1]  # shared shocks: more expenses never help
        assert "Scenario grid: 3 variants" in proc.stderr
    elif mode == "sensitivity":
        res = SensitivityResponse.model_validate(payload)
        assert {r.param for r in res.rows} == {"monthly_expenses",
                                               "initial_balance"}
        assert "Search complete" in proc.stderr
        rows = {r.param: r for r in res.rows}
        assert rows["monthly_expenses"].d_success <= 0.0
        assert rows["initial_balance"].d_success >= 0.0
    elif mode == "optimize":
        res = OptimizeResponse.model_validate(payload)
        assert res.evaluations == 10 and len(res.curve) == 5
        assert res.interval[0] <= res.best.value <= res.interval[1]
    else:
        res = OptimizeJointResponse.model_validate(payload)
        assert res.evaluations == 9 and len(res.surface) == 9
        assert res.objective == "p5_final_balance"
