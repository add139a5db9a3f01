"""The port's bench line, its two sweep scripts and its public surface.

``hosts/bench.py`` at ``--device cpu`` and a few thousand paths prints one
JSON line with exactly bench.py's keys less its TPU targets, plus the
device's name and power limit. ``hosts/scenario_grid_demo.py`` and
``hosts/correlation_sweep.py`` print their scripts' tables; the sweep's
rows each equal that row run alone. Every name of the JAX package's public
surface resolves on the port to the port's own object.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import monte_carlo_retirement_tpu as jax_pkg  # noqa: E402
import monte_carlo_retirement_tpu_torch as port  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (  # noqa: E402
    run_scenario_grid,
)
from monte_carlo_retirement_tpu_torch.hosts import (  # noqa: E402
    bench,
    correlation_sweep,
    scenario_grid_demo,
)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX package's lazy names (monte_carlo_retirement_tpu/__init__.py:51-70).
JAX_LAZY = ("Engine", "RetirementMonteCarloSimulator",
            "median_first_year_withdrawal_rate", "find_minimum_working_months")
KEYS = {"metric", "value", "unit", "success_rate_pct", "full_stats_ms",
        "card_name", "power_limit"}


def test_bench_line_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(bench, "REPEATS", 1)
    monkeypatch.setattr(bench, "CHAIN", 1)
    assert bench.main(["--device", "cpu", "--paths", "2048"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == KEYS
    assert not {"vs_baseline", "full_stats_target_ms", "full_stats_vs_target"} & set(line)
    assert line["unit"] == "ms" and line["value"] > 0 and line["full_stats_ms"] > 0
    assert 0.0 <= line["success_rate_pct"] <= 100.0
    assert line["metric"].startswith("2,048 paths x 600-month") and line["power_limit"] is None


def test_bench_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run on it")
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--paths", "4096"])


@pytest.mark.parametrize("name", list(jax_pkg.__all__) + list(JAX_LAZY))
def test_public_surface_is_the_ports_own(name):
    mine, theirs = getattr(port, name), getattr(jax_pkg, name)
    if isinstance(theirs, (int, float)):
        assert mine == theirs
        assert name in vars(port.constants)
    else:
        assert mine.__module__.startswith("monte_carlo_retirement_tpu_torch.")
        assert mine.__name__ == theirs.__name__
    assert port.__all__ == jax_pkg.__all__


def test_scenario_grid_demo_prints_the_scripts_table(capsys):
    assert scenario_grid_demo.main(["32", "256", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "256 scenarios x 32 paths x 831 months, chunks of 256"
    assert out[2].startswith("success% grid (rows: expenses 4k->14k")
    rows = [[float(v) for v in line.split(":")[1].split()] for line in out[3:]]
    assert len(rows) == 16 and all(len(r) == 16 for r in rows)
    assert out[3].startswith("    4,000:") and out[-1].startswith("   14,000:")
    # Shared shocks: success never rises with expenses in any column.
    assert (np.diff(np.array(rows), axis=0) <= 0).all()


def test_correlation_sweep_rows_equal_each_row_alone():
    res = correlation_sweep.run_sweep(n_paths=128, device="cpu")
    configs = correlation_sweep.sweep_configs()
    assert len(configs) == 9 and res.success_probability.shape == (9,)
    for i in (0, 8):  # rho = -1, +1
        alone = run_scenario_grid([configs[i]], [correlation_sweep.W], 128,
                                  seed=correlation_sweep.SEED, device="cpu")
        for a, b in zip(res, alone):
            np.testing.assert_array_equal(a[i], b[0])


def test_correlation_sweep_prints_the_scripts_table(capsys, monkeypatch):
    monkeypatch.setattr(correlation_sweep, "N_PATHS", 64)
    assert correlation_sweep.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"{'rho':>6} {'success %':>10} {'median final':>16}"
    assert [line.split()[0] for line in out[1:]] == [
        f"{r:.2f}" for r in correlation_sweep.RHOS]


def test_pyproject_names_the_ports_entry_points():
    with open(os.path.join(REPO, "pyproject.toml"), encoding="utf-8") as fh:
        text = fh.read()
    assert 'mcrt-torch = "monte_carlo_retirement_tpu_torch.hosts.cli:main"' in text
    assert ('mcrt-torch-server = "monte_carlo_retirement_tpu_torch.hosts.server:main"'
            in text)
