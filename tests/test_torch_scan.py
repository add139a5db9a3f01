"""The port's scan engine path by path against the JAX package's.

``engine/kernel.simulate_paths`` draws the JAX scan's threefry stream
(``ops/threefry.py``, ``ops/shocks.py``) and runs the plain loop's month
body, so on the same key it must give JAX's ``simulate_paths`` answers to
round-off in float64: the same success flag on every path, and final
balances and every tracked field within relative 1e-9 / absolute 1e-6
(paths beyond $1e9 skipped, as in ROADMAP C), under config.json, each
extension alone and all of them on, in probe mode here and in tracked
mode in ``test_torch_scan_tracked.py`` (two files, so that each stays
short on one test worker).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine.kernel import (  # noqa: E402
    simulate_paths as jax_simulate_paths,
)
from monte_carlo_retirement_tpu.models.retirement import (  # noqa: E402
    SimParams as JaxParams,
)
from monte_carlo_retirement_tpu.ops.shocks import (  # noqa: E402
    stream_keys as jax_stream_keys,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.kernel import (  # noqa: E402
    PathOutputs,
    scan_statics,
    simulate_paths,
)
from monte_carlo_retirement_tpu_torch.models.retirement import (  # noqa: E402
    SimParams,
)
from monte_carlo_retirement_tpu_torch.ops.shocks import stream_keys  # noqa: E402

torch.set_num_threads(2)

N = 1024 + 17  # an odd count: the last antithetic path is unpaired
R = 5
W = 150  # a partial working year: the terminal settle runs
BIG = 1e9  # the conditioning bound of ROADMAP C
CASES = {"config.json": {}, **chip_smoke.EXTENSIONS, "all_on": chip_smoke.ALL_ON}
TRACKED = ("start_balance", "years_to_ruin", "first_year_gross",
           "first_year_real_gross", "inflation_at_retirement", "trajectory",
           "price_levels", "withdrawal_rates")


def _both(overrides, **more):
    raw = chip_smoke._raw_config(**dict(overrides))
    raw.update(retirement_years=R, monthly_expenses=20_000.0)
    raw.update(more)
    raw = json.loads(json.dumps(raw))
    return JaxConfig(**raw), Config(**raw)


def _flags(raw_cfg):
    return dict(antithetic=bool(raw_cfg.antithetic),
                jumps=raw_cfg.market_crashes is not None,
                mortality=raw_cfg.longevity is not None)


def _run_both(overrides, w, t_scan, traj_len, seed=2026, **more):
    jcfg, cfg = _both(overrides, **more)
    flags = _flags(cfg)
    want = jax_simulate_paths(
        JaxParams.from_config(jcfg, dtype=jnp.float64), jnp.int32(w),
        jax_stream_keys(seed)[1], n_paths=N, t_scan=t_scan,
        retirement_years=R, traj_len=traj_len, dtype=jnp.float64, **flags)
    got = simulate_paths(SimParams.from_config(cfg), w, stream_keys(seed)[1],
                         n_paths=N, t_scan=t_scan, retirement_years=R,
                         traj_len=traj_len, dtype=torch.float64, **flags)
    return got, want


def _assert_round_off(got: PathOutputs, want, tracked: bool):
    ws = np.asarray(want.success)
    assert got.success.dtype == torch.bool
    np.testing.assert_array_equal(got.success.numpy(), ws)
    wf = np.asarray(want.final_balance)
    ok = wf < BIG
    assert ok.mean() > 0.9
    np.testing.assert_allclose(got.final_balance.numpy()[ok], wf[ok],
                               rtol=1e-9, atol=1e-6)
    for name in TRACKED:
        g, w = getattr(got, name), getattr(want, name)
        if not tracked:
            assert g is None and w is None
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        rows = ok.reshape((-1,) + (1,) * (w.ndim - 1))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        sel = np.broadcast_to(rows, w.shape) & ~np.isnan(w)
        np.testing.assert_allclose(g[sel], w[sel], rtol=1e-9, atol=1e-6,
                                   err_msg=name)


def check_case(case: str, tracked: bool):
    """One case of ``CASES`` at W in probe or tracked mode."""
    t_scan = ((W + 12 * R + 59) // 60) * 60
    got, want = _run_both(CASES[case], W, t_scan,
                          1 + t_scan // 12 if tracked else 0)
    _assert_round_off(got, want, tracked)
    ws = np.asarray(want.success)
    assert ws.any()
    if case in ("config.json", "bills", "jumps", "all_on"):
        assert not ws.all()  # ruin happens: the flags are tested


@pytest.mark.parametrize("case", list(CASES))
def test_simulate_paths_equals_jax_path_by_path(case):
    """Probe mode (the tracked mode: ``test_torch_scan_tracked.py``)."""
    check_case(case, tracked=False)


@pytest.mark.parametrize("w", (0, 24, 2))
def test_simulate_paths_at_whole_years_and_a_short_scan(w):
    """W = 0 and W on a year boundary (no settle); W = 2 under a scan of
    only 12 R months (``scripts/scaling_demo.py``'s T): the accumulation
    phase stops at t_scan - 12 R while retirement still starts after W."""
    t_scan = 12 * R if w == 2 else ((w + 12 * R + 59) // 60) * 60
    got, want = _run_both({}, w, t_scan, 1 + t_scan // 12, seed=7,
                          monthly_expenses=2_500.0)
    _assert_round_off(got, want, tracked=True)


def test_scan_statics_follow_the_parameters():
    _, cfg = _both(chip_smoke.ALL_ON)
    st = scan_statics(SimParams.from_config(cfg), antithetic=True, jumps=True,
                      mortality=True)
    assert (st.bill1, st.glide, st.guardrails, st.jumps, st.mortality) == (
        True, True, True, True, True)
    assert st.stream_indexed == (True, False) and st.stream_capped == (False, True)
    _, base = _both({})
    st = scan_statics(SimParams.from_config(base))
    assert not (st.bill1 or st.bill2 or st.glide or st.guardrails
                or st.antithetic or st.jumps or st.mortality)
