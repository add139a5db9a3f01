"""The port's slice end to end on the CPU, against the JAX engine.

The port runs its plain versions in float64 with its own Philox stream;
the JAX engine runs its scan backend in float64 with threefry. The streams
differ, so the comparisons are statistical (Monte Carlo error), with the
bounds of tests/test_f32_tolerance.py and of the search driver's margin.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine.runner import Engine as JaxEngine  # noqa: E402
from monte_carlo_retirement_tpu.engine.simulator import (  # noqa: E402
    RetirementMonteCarloSimulator as JaxSimulator,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.simulator import (  # noqa: E402
    RetirementMonteCarloSimulator,
)
from tests.conftest import base_config_dict, binomial_sigma_pct  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _raw(name="config.json", **overrides):
    with open(os.path.join(REPO, name), encoding="utf-8") as fh:
        raw = json.load(fh)
    raw.update(seed=2026, retirement_years=10, **overrides)
    return raw


def test_chunked_probe_equals_single_dispatch(monkeypatch):
    eng = Engine(Config(**_raw()), device="cpu")
    months = [110, 118, 124]
    n = 4096 + 904
    single = eng.probe(months, n)
    monkeypatch.setenv("MCRT_MAX_PROBE_PATHS", "4096")
    ck.reset_counts()
    chunked = eng.probe(months, n)
    assert ck.PLAIN_CALLS["probe"] == 2  # 4096 + 904 paths
    assert chunked == single
    assert 0.0 < min(single) and max(single) < 100.0


def test_slice_matches_jax_engine_within_monte_carlo_error():
    n, months = 8192, 120
    port = Engine(Config(**_raw()), device="cpu").run(months, n)
    ref = JaxEngine(JaxConfig(**_raw())).run(months, n, stream="final")
    assert port.success.dtype == np.bool_ and port.success.shape == (n,)
    sigma = math.hypot(binomial_sigma_pct(port.success_probability, n),
                       binomial_sigma_pct(ref.success_probability, n))
    assert 50.0 < ref.success_probability < 99.0  # a month that discriminates
    assert abs(port.success_probability - ref.success_probability) <= max(
        4.0 * sigma, 0.30
    )
    for name in ("median_start_balance", "median_final_successful"):
        a, b = getattr(port, name), getattr(ref, name)
        assert abs(a - b) <= 0.03 * abs(b), (name, a, b)
    # Same table shapes and the same sample rows as the JAX engine.
    for name in ("final_balance_percentiles", "trajectory_percentiles",
                 "real_trajectory_percentiles", "sample_trajectories",
                 "wr_percentiles", "wr_observation_counts"):
        assert getattr(port, name).shape == np.asarray(getattr(ref, name)).shape
    np.testing.assert_allclose(port.sample_trajectories[:, 0],
                               np.asarray(ref.sample_trajectories)[:, 0])
    assert np.isfinite(port.trajectory_percentiles).all()


@pytest.mark.parametrize("scenario", ["config.json", "jorge.json"])
def test_searched_months_cross_check(scenario):
    raw = _raw(scenario, num_simulations_search=2048)
    port = RetirementMonteCarloSimulator(Config(**raw), device="cpu")
    jax_sim = JaxSimulator(JaxConfig(**raw))
    m_port, p_port, _ = port.find_minimum_working_months(verbose=False)
    m_jax, p_jax, _ = jax_sim.find_minimum_working_months(verbose=False)
    assert m_port > 0 and m_jax > 0
    target = raw["target_probability"]
    margin = 150.0 / math.sqrt(raw["num_simulations_search"])
    assert p_port >= target and p_jax >= target
    # Each engine probes the other's month on its own search stream.
    (p_port_at_jax,) = port.engine.probe([m_jax], 2048, stream="search")
    (p_jax_at_port,) = jax_sim.engine.probe([m_port], 2048, stream="search")
    assert abs(p_port_at_jax - target) <= margin, (m_jax, p_port_at_jax)
    assert abs(p_jax_at_port - target) <= margin, (m_port, p_jax_at_port)


def test_cli_on_cpu_writes_both_plots(tmp_path):
    cfg = base_config_dict(
        retirement_years=3, num_simulations_search=256, num_simulations_main=512,
        monthly_expenses=2_500.0, monthly_contribution=1_000.0,
    )
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    cmd = [sys.executable, "-m", "monte_carlo_retirement_tpu_torch.hosts.cli",
           str(path)]
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=tmp_path, env=PORT_ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    pngs = sorted(p.name for p in tmp_path.glob("ret_proj_*.png"))
    assert len(pngs) == 2 and pngs[0].endswith("_HIST.png"), pngs
    assert pngs[1].endswith("_TRAJ.png")
    assert "Search Complete" in proc.stderr
    if not torch.cuda.is_available():
        # The default device is the card; without one the CLI must fail,
        # never carry on silently on the CPU.
        proc = subprocess.run(cmd, cwd=tmp_path, env=PORT_ENV,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert "no CUDA card" in proc.stderr


TINY = base_config_dict(retirement_years=2, num_simulations_search=128)


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        "from monte_carlo_retirement_tpu_torch.config import Config\n"
        "from monte_carlo_retirement_tpu_torch.engine.simulator import "
        "RetirementMonteCarloSimulator\n"
        "from monte_carlo_retirement_tpu_torch.hosts import (\n"
        "    bench, cli, correlation_sweep, cross_backend_check, edge_sweep,\n"
        "    fuzz, grid, openapi, optimize, payload, plotting, scaling_demo,\n"
        "    scenario_grid_demo, schemas, sensitivity, server)\n"
        "from monte_carlo_retirement_tpu_torch.ops import threefry\n"
        "from monte_carlo_retirement_tpu_torch.engine import (\n"
        "    optimize as opt, scenario_batch, sensitivity as sens)\n"
        f"cfg = Config(**{TINY!r})\n"
        "sim = RetirementMonteCarloSimulator(cfg, device='cpu')\n"
        "m, p, _ = sim.find_minimum_working_months(verbose=False)\n"
        "sim.use_final_seeds()\n"
        "sim.run_monte_carlo_simulations(max(m, 0), 256)\n"
        "payload.build_result(cfg, sim, max(m, 0), include_raw=False)\n"
        "openapi.build_spec()\n"
        "server.create_app(device='cpu')\n"
        "scenario_batch.run_scenario_grid([cfg, cfg], [0, 6], 128, device='cpu')\n"
        "sens.sensitivity_fd(cfg, 6, num_paths=64, params=['monthly_expenses'],"
        " device='cpu')\n"
        "opt.optimize_param(cfg, 6, 'allocation_inv1_pct', num_paths=64,"
        " points=3, rounds=1, device='cpu')\n"
        "sim.engine.probe([0, 6], 64, backend='scan')\n"
        "sim.engine.run(6, 64, backend='scan')\n"
        "scenario_batch.run_scenario_grid([cfg], [6], 64, device='cpu',"
        " backend='scan')\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
        "or k == 'monte_carlo_retirement_tpu' "
        "or k.startswith('monte_carlo_retirement_tpu.')]\n"
        "print('IMPORTED', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=PORT_ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTED []" in proc.stdout, proc.stdout
