"""``hosts/cross_backend_check.py`` and ``hosts/scaling_demo.py`` at a tiny
size on the CPU: their lines, their rules, and their scan legs against the
JAX scripts' scan (``scripts/cross_backend_check.py``,
``scripts/scaling_demo.py``) on the same keys."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.config import (  # noqa: E402
    load_config_from_json as jax_load,
)
from monte_carlo_retirement_tpu.engine.kernel import (  # noqa: E402
    simulate_paths as jax_simulate_paths,
)
from monte_carlo_retirement_tpu.models.retirement import (  # noqa: E402
    SimParams as JaxParams,
)
from monte_carlo_retirement_tpu.ops.shocks import (  # noqa: E402
    stream_keys as jax_stream_keys,
)
from monte_carlo_retirement_tpu_torch.hosts import cross_backend_check as cbc  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import scaling_demo as sd  # noqa: E402

torch.set_num_threads(2)
N = 512 + 7


def _jax_scan_pct(fname, W, R, seed, t_scan, n):
    raw = jax_load(f"{cbc.REPO}/{fname}")
    raw["retirement_years"] = R
    params = JaxParams.from_config(JaxConfig(**raw), dtype=jnp.float32)
    outs = jax_simulate_paths(params, jnp.int32(W), jax_stream_keys(seed)[1],
                              n_paths=n, t_scan=t_scan, retirement_years=R,
                              traj_len=0, dtype=jnp.float32)
    return float(np.asarray(outs.success).mean()) * 100.0


@pytest.fixture(scope="module")
def cross():
    return cbc.check(N, "cpu")


def test_cross_backend_check_cases_within_the_rule(cross):
    assert [r.name for r in cross] == [c[0] for c in cbc.CASES]
    for r in cross:
        assert 0.0 < r.scan_pct <= 100.0 and 0.0 < r.kernel_pct <= 100.0
        assert math.isclose(r.diff, r.scan_pct - r.kernel_pct)
        p = (r.scan_pct + r.kernel_pct) / 200.0
        assert math.isclose(r.three_sigma, 3 * math.sqrt(2 * p * (1 - p) / N) * 100)
        assert r.ok, r


@pytest.mark.parametrize("case", range(len(cbc.CASES)))
def test_cross_backend_scan_leg_equals_jax_scan(cross, case):
    """The scan leg is the JAX script's scan leg: float32 threefry on the
    final key of stream_keys(2026), at most a path apart (float32
    round-off at a ruin threshold)."""
    _, fname, W, R = cbc.CASES[case]
    want = _jax_scan_pct(fname, W, R, cbc.SEED, ((W + 12 * R + 59) // 60) * 60, N)
    assert abs(cross[case].scan_pct - want) <= 100.0 / N + 1e-9


def test_cross_backend_main_exit_codes(capsys, monkeypatch, cross):
    monkeypatch.setattr(cbc, "check", lambda n, device: cross)
    assert cbc.main(["--device", "cpu", "--paths", str(N)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and "MISMATCH" not in "".join(out)
    bad = cross[0]._replace(diff=5.0, three_sigma=1.0)
    monkeypatch.setattr(cbc, "check", lambda n, device: [bad] + cross[1:])
    assert cbc.main(["--device", "cpu"]) == 1
    assert "MISMATCH" in capsys.readouterr().out


def test_scaling_demo_lines_and_success(capsys, monkeypatch):
    monkeypatch.setattr(sd, "SHARDS", (1, 2, 4))  # 8 shards: the card's run
    seen = []
    real = sd.demo
    monkeypatch.setattr(sd, "demo", lambda *a: seen.extend(real(*a)) or seen)
    assert sd.main(["--device", "cpu", "--paths", str(N), "--repeats", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 * len(sd.SHARDS)
    assert all("shard(s)" in ln and "speedup" in ln for ln in out)
    assert [(ln.engine, ln.shards) for ln in seen] == [
        (e, k) for e in ("scan", "kernel") for k in sd.SHARDS]
    for engine in ("scan", "kernel"):
        rates = {ln.success_pct for ln in seen if ln.engine == engine}
        assert len(rates) == 1  # the same batch at every shard count
    assert all(ln.best_ms > 0 and ln.speedup > 0 for ln in seen)
    want = _jax_scan_pct("config.json", 0, sd.RETIREMENT_YEARS, 7, sd.T_SCAN, N)
    assert seen[0].success_pct == pytest.approx(want, abs=100.0 / N)


def test_scan_rows_split_over_shards_equal_one_scan():
    """The scan's rows split over 1, 3 and 8 shards count the same
    survivors, at expenses where some paths survive."""
    from monte_carlo_retirement_tpu_torch.config import Config
    from monte_carlo_retirement_tpu_torch.models.retirement import SimParams

    raw = jax_load(f"{sd.REPO}/config.json")
    raw.update(retirement_years=sd.RETIREMENT_YEARS, monthly_expenses=2_500.0)
    params = SimParams.from_config(Config(**raw))
    key = sd.stream_keys(7)[1]
    rates = {sd.scan_success(params, key, N, k, "cpu") for k in (1, 3, 8)}
    assert len(rates) == 1 and 0.0 < rates.pop() < 100.0
