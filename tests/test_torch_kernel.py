"""The port's plain month loop vs the JAX Pallas kernels on injected shocks.

The same numpy normals go into JAX ``pallas_simulate`` / ``pallas_simulate_full``
(``with_shocks=True, interpret=True``, as ``tests/test_pallas_parity.py``
runs them) and, reshaped to (T, 3, 4096), into the port's ``probe_plain`` /
``simulate_full_plain`` — in float32 (the kernels' working type) and in
float64 (the CPU engine's). The bounds are the JAX suite's own for Pallas
against the scan kernel: success-flag mismatch < 3e-3, final-balance
relative error < 5e-3, and the full-mode field bounds of
``test_pallas_parity.py:196-227``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.engine.pallas_kernel import (  # noqa: E402
    BLOCK_ROWS,
    pallas_simulate,
    pallas_simulate_full,
    statics_from_config as jax_statics,
)
from monte_carlo_retirement_tpu.models.retirement import (  # noqa: E402
    SimParams as JaxParams,
)
from monte_carlo_retirement_tpu.timing import expected_trajectory_length  # noqa: E402
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.models.retirement import SimParams  # noqa: E402
from tests.conftest import base_config_dict, make_config  # noqa: E402

torch.set_num_threads(2)
N = BLOCK_ROWS * 128

# (W, R, use_real1, use_real2, indexed streams): a pairwise covering of
# W in {0, 13, 24}, R in {4, 5}, both tax-system flags and 0/1/2 streams —
# every pair of levels of any two factors appears in some case.
CASES = [
    (0, 5, False, True, 0),
    (0, 4, False, False, 1),
    (0, 4, True, True, 2),
    (13, 4, True, True, 0),
    (13, 5, True, True, 1),
    (13, 5, False, False, 2),
    (24, 4, True, False, 0),
    (24, 5, True, True, 1),
    (24, 4, False, True, 2),
]


def _config(W, R, use1, use2, ns, seed, **extra):
    streams = [
        {"name": "Pension", "monthly_amount_today": 900.0,
         "start_at_age": 41.0, "duration_years": None,
         "inflation_indexed": True, "tax_rate": 0.2},
        {"name": "Annuity", "monthly_amount_today": 400.0,
         "start_at_age": 40.5, "duration_years": None,
         "inflation_indexed": True, "tax_rate": 0.1},
    ][:ns]
    kw = dict(
        retirement_years=R,
        seed=seed,
        initial_balance=120_000.0,
        monthly_contribution=1_500.0,
        contribution_growth_rate_annual=0.03,
        monthly_expenses=2_200.0,
        inv1_returns_volatility=0.17,
        inv1_use_realized_gains_tax_system=use1,
        inv1_realized_gains_tax_rate=0.15,
        inv2_use_realized_gains_tax_system=use2,
        inv2_realized_gains_tax_rate=0.1,
        equity_inflation_correlation=0.2,
        other_income_streams=streams,
    )
    kw.update(extra)
    return make_config(**kw)


def _shocks(T, seed, planes=3):
    """Injected draws in the Pallas plane layout: 3 normals; with 6
    planes also the crash uniform and normal (3, 4) and the longevity
    uniform (5, read in month 0 only)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((T, planes, N)).astype(np.float32)
    if planes > 3:
        z[:, 3] = rng.uniform(size=(T, N)).astype(np.float32)
        z[:, 5] = rng.uniform(size=(T, N)).astype(np.float32)
    return z


def assert_probe_close(succ_p, final_p, succ_j, final_j, what):
    """The JAX suite's bounds for Pallas against the scan kernel: success
    flags mismatching < 3e-3; final balances dust-aware
    (test_pallas_parity.py:311-323): near-depleted paths end with a few
    dollars where Pallas' approximate reciprocal reads as percents, so a
    path diverges only when off both relatively and by more than $5."""
    mismatch = float((succ_p != succ_j).mean())
    assert mismatch < 3e-3, f"{what}: success mismatch {mismatch:.4f}"
    diff = np.abs(final_p - final_j)
    rel = diff / np.maximum(np.abs(final_j), 1.0)
    bad = (rel > 5e-3) & (diff > 5.0)
    assert float(bad.mean()) <= 1e-3, f"{what}: {bad.sum()} paths diverge"


def assert_full_close(got, ref, R, L, what):
    """The full-mode field bounds of test_pallas_parity.py:196-227, with the
    dust-aware final balances and at most a one-month move of a ruin month
    on the share of paths a flipped flag may have."""
    assert ((got["success"] > 0.5) == (ref["success"] > 0.5)).mean() > 0.999, what
    for name in ("start_balance", "first_year_gross",
                 "first_year_real_gross", "inflation_at_retirement"):
        rel = np.abs(got[name] - ref[name]) / np.maximum(np.abs(ref[name]), 1.0)
        assert float(np.quantile(rel, 0.999)) < 5e-3, f"{what} {name}"
    diff = np.abs(got["final_balance"] - ref["final_balance"])
    rel = diff / np.maximum(np.abs(ref["final_balance"]), 1.0)
    assert float(((rel > 5e-3) & (diff > 5.0)).mean()) <= 1e-3, what
    ytr_p, ytr_j = got["years_to_ruin"], ref["years_to_ruin"]
    same_nan = np.isnan(ytr_p) == np.isnan(ytr_j)
    assert same_nan.mean() > 0.999, what
    both = same_nan & ~np.isnan(ytr_j)
    # A ruin month may move by one at the funding-failure boundary, where
    # Pallas' approximate reciprocal and IEEE division part ways: allow
    # it on the same share of paths as a flipped success flag, and by
    # no more than that one month.
    ytr_diff = np.abs(ytr_p[both] - ytr_j[both])
    moved = ytr_diff > 1e-5
    assert moved.sum() / N < 1e-3, f"{what}: {moved.sum()} ruin months moved"
    assert float(ytr_diff.max(initial=0.0)) <= 1.0 / 12.0 + 1e-5, (
        f"{what}: a ruin month moved by {ytr_diff.max():.4f} years")
    for name in ("trajectory", "price_levels"):
        assert got[name].shape == (N, L)
        rel = np.abs(got[name] - ref[name]) / np.maximum(np.abs(ref[name]), 1.0)
        assert float(np.quantile(rel, 0.999)) < 5e-3, f"{what} {name}"
    wr_p, wr_j = got["withdrawal_rates"], ref["withdrawal_rates"]
    assert wr_p.shape == (N, R)
    assert (np.isnan(wr_p) == np.isnan(wr_j)).mean() > 0.999, what
    ok = ~np.isnan(wr_p) & ~np.isnan(wr_j)
    np.testing.assert_allclose(wr_p[ok], wr_j[ok], rtol=5e-3, atol=1e-4)


def _port(cfg, W, R, dtype):
    params = SimParams.from_config(Config(**cfg.model_dump(by_alias=True)))
    packed = ck.pack_params(params, 0, [W], R, dtype=dtype)
    return packed, ck.statics_from_config(cfg)


@pytest.mark.parametrize("W,R,use1,use2,ns", CASES)
def test_probe_plain_matches_pallas_on_injected_shocks(W, R, use1, use2, ns):
    cfg = _config(W, R, use1, use2, ns, seed=100 + W + R)
    T = W + 12 * R
    z = _shocks(T, seed=W * 10 + R)
    jparams = JaxParams.from_config(cfg, dtype=jnp.float32)
    succ_j, final_j = pallas_simulate(
        jparams, W, 0, n_paths=N, retirement_years=R,
        n_streams=jparams.n_streams, statics=jax_statics(cfg),
        shocks=jnp.asarray(z.reshape(T, 3, BLOCK_ROWS, 128)),
        with_shocks=True, interpret=True,
    )
    succ_j = np.asarray(succ_j) > 0.5
    final_j = np.asarray(final_j)
    for dtype in (torch.float32, torch.float64):
        packed, statics = _port(cfg, W, R, dtype)
        out = ck.probe_plain(packed, statics, R, N, shocks=torch.from_numpy(z))
        succ_p = out.success[0].numpy() > 0.5
        assert int(out.counts[0]) == int(succ_p.sum())
        assert_probe_close(succ_p, out.final_balance[0].numpy(), succ_j, final_j,
                           str(dtype))


@pytest.mark.parametrize("W,R,use1,use2,ns", CASES)
def test_full_plain_matches_pallas_on_injected_shocks(W, R, use1, use2, ns):
    cfg = _config(W, R, use1, use2, ns, seed=200 + W + R)
    T = W + 12 * R
    L = expected_trajectory_length(W, R)
    z = _shocks(T, seed=W * 10 + R + 1)
    jparams = JaxParams.from_config(cfg, dtype=jnp.float32)
    full = pallas_simulate_full(
        jparams, W, 0, n_paths=N, retirement_years=R,
        n_streams=jparams.n_streams, statics=jax_statics(cfg), traj_len=L,
        shocks=jnp.asarray(z.reshape(T, 3, BLOCK_ROWS, 128)),
        with_shocks=True, interpret=True,
    )
    ref = {k: np.asarray(v) for k, v in full.items()}
    for dtype in (torch.float32, torch.float64):
        packed, statics = _port(cfg, W, R, dtype)
        out = ck.simulate_full_plain(
            packed, statics, R, N, L, shocks=torch.from_numpy(z)
        )
        got = {k: v.numpy() for k, v in out.items()}
        assert_full_close(got, ref, R, L, str(dtype))


def test_probe_candidates_share_shocks_and_match_single_runs():
    """A multi-candidate probe (working months differ per row, shocks
    shared) equals one probe per candidate, path for path."""
    cfg = _config(0, 4, True, True, 1, seed=5)
    params = SimParams.from_config(cfg)
    statics = ck.statics_from_config(cfg)
    months = [0, 5, 17, 30]
    batch = ck.probe_plain(ck.pack_params(params, 77, months, 4, dtype=torch.float64),
                           statics, 4, 1000)
    for i, m in enumerate(months):
        one = ck.probe_plain(ck.pack_params(params, 77, [m], 4, dtype=torch.float64),
                             statics, 4, 1000)
        torch.testing.assert_close(batch.success[i], one.success[0], rtol=0, atol=0)
        torch.testing.assert_close(batch.final_balance[i], one.final_balance[0],
                                   rtol=0, atol=0)
        assert int(batch.counts[i]) == int(one.counts[0])


# Each extension of the month loop alone, on the injected-shocks scenario of
# CASES with higher expenses (W = 13, so a partial working year and the
# bills' terminal settle; R = 5): between 40% and 98% of paths succeed,
# and each rule binds inside the 5 years.
CRASHES = {"frequency_per_year": 1.0, "mean_drop_pct": 25.0,
           "size_volatility": 0.3, "inv2_beta": 0.5}
EXTENSIONS = {
    "bills": dict(inv1_use_realized_gains_tax_system=False,
                  inv1_annual_tax_on_gains_rate=0.2,
                  inv2_use_realized_gains_tax_system=False,
                  inv2_annual_tax_on_gains_rate=0.1),
    "fixed": dict(other_income_streams=[
        {"name": "Pension", "monthly_amount_today": 900.0, "start_at_age": 41.0,
         "duration_years": None, "inflation_indexed": True, "tax_rate": 0.2},
        {"name": "Fixed", "monthly_amount_today": 700.0, "start_at_age": 42.0,
         "duration_years": None, "inflation_indexed": False, "tax_rate": 0.1}]),
    "capped": dict(other_income_streams=[
        {"name": "Capped", "monthly_amount_today": 900.0, "start_at_age": 41.0,
         "duration_years": 2, "inflation_indexed": True, "tax_rate": 0.2},
        {"name": "Annuity", "monthly_amount_today": 600.0, "start_at_age": 41.5,
         "duration_years": 3, "inflation_indexed": False, "tax_rate": 0.1}]),
    "antithetic": dict(antithetic=True),
    "glide": dict(allocation_inv1_final_pct=0.25),
    "guardrails": dict(spending_guardrails={"upper_wr_pct": 6.0,
                                            "lower_wr_pct": 3.0}),
    "jumps": dict(market_crashes=dict(CRASHES)),
    "mortality": dict(longevity={"mode_age": 44.0, "dispersion_years": 4.0,
                                 "max_age": 90.0}),
}
EXT_W, EXT_R = 13, 5


def ext_config(name, W=EXT_W, R=EXT_R, seed=300, **extra):
    extra = {"monthly_expenses": 3_200.0, **EXTENSIONS[name], **extra}
    return _config(W, R, True, True, 1, seed=seed, **extra)


@pytest.mark.parametrize("name", list(EXTENSIONS))
def test_extension_plain_matches_pallas_on_injected_shocks(name):
    """The plain loop under each extension's Statics vs JAX pallas_simulate
    and pallas_simulate_full on the same six planes of numpy draws (the
    Pallas layout: crashes read planes 3-4, longevity plane 5 of month 0;
    injected runs ignore antithetic pairing in both packages)."""
    cfg = ext_config(name)
    W, R = EXT_W, EXT_R
    T = W + 12 * R
    L = expected_trajectory_length(W, R)
    z = _shocks(T, seed=len(name), planes=6)
    z_jax = jnp.asarray(z.reshape(T, 6, BLOCK_ROWS, 128))
    jparams = JaxParams.from_config(cfg, dtype=jnp.float32)
    kw = dict(n_paths=N, retirement_years=R, n_streams=jparams.n_streams,
              statics=jax_statics(cfg), shocks=z_jax, with_shocks=True,
              interpret=True)
    succ_j, final_j = pallas_simulate(jparams, W, 0, **kw)
    succ_j = np.asarray(succ_j) > 0.5
    ref = {k: np.asarray(v)
           for k, v in pallas_simulate_full(jparams, W, 0, traj_len=L, **kw).items()}
    # The rule must bind for the comparison to mean anything.
    assert 0.02 < succ_j.mean() < 0.999, succ_j.mean()
    for dtype in (torch.float32, torch.float64):
        packed, statics = _port(cfg, W, R, dtype)
        assert tuple(statics) == tuple(jax_statics(cfg))
        out = ck.probe_plain(packed, statics, R, N, shocks=torch.from_numpy(z))
        succ_p = out.success[0].numpy() > 0.5
        assert int(out.counts[0]) == int(succ_p.sum())
        assert_probe_close(succ_p, out.final_balance[0].numpy(), succ_j,
                           np.asarray(final_j), f"{name} {dtype}")
        full = ck.simulate_full_plain(packed, statics, R, N, L,
                                      shocks=torch.from_numpy(z))
        assert_full_close({k: v.numpy() for k, v in full.items()}, ref, R, L,
                          f"{name} {dtype}")


def test_kernel_wrappers_on_a_cuda_tensor_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the wrapper would launch")
    cfg = _config(0, 4, True, True, 1, seed=3)
    params = SimParams.from_config(cfg)
    statics = ck.statics_from_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ck.pack_params(params, 1, [0], 4, device="cuda")
    cpu = ck.pack_params(params, 1, [0], 4)
    # A packed block whose tensors claim the card: the wrappers must raise,
    # never fall back to their plain versions.
    on_card = types.SimpleNamespace(
        fp=cpu.fp, ip=cpu.ip, n_streams=cpu.n_streams,
        device=torch.device("cuda"),
    )
    before = dict(ck.PLAIN_CALLS)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ck.probe(on_card, statics, 4, 64)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ck.simulate_full(on_card, statics, 4, 64, 6)
    assert ck.PLAIN_CALLS == before
