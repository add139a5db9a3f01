"""The port's copies of the JAX package's public ``ops`` names against
JAX's, on the same numpy inputs in float64 on the CPU.

``ops/__init__.py`` exports JAX's six names. The tax closed forms
(``sale_tax_profile``, ``withdraw_net_target``, ``net_liquidation_value``,
``rebalance``, ``apply_annual_gain_taxes``) take balances, bases and rates
drawn from a seed, with zero, dust and loss bases, empty and dust
balances, and the rate-1 zero-basis sale where the kernel body's algebra
and the closed form part ways. ``order_statistics``,
``exact_quantiles_parts`` and ``masked_median`` take masked columns with
ranks at and beyond the valid count, and subnormals and -0.0 that JAX's
zero-band snap turns into +0.0; ``snap_zero_band`` is the chunked
module's numpy snap. Every output agrees within 1e-12 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import monte_carlo_retirement_tpu.ops as jax_ops  # noqa: E402
import monte_carlo_retirement_tpu_torch.ops as ops  # noqa: E402
from monte_carlo_retirement_tpu.ops import chunked_quantiles as jax_cq  # noqa: E402
from monte_carlo_retirement_tpu.ops import quantiles as jax_q  # noqa: E402
from monte_carlo_retirement_tpu.ops import tax as jax_tax  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import chunked_quantiles as cq  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import quantiles as q  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import tax  # noqa: E402

RTOL = 1e-12
N = 4096


def _close(got, want, what):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        if a.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}[{i}]")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0.0,
                                       err_msg=f"{what}[{i}]")


def _assets(rng):
    """Balances and bases with every edge the closed forms branch on."""
    bal = rng.lognormal(11.0, 1.5, N)
    bal[:64] = 0.0
    bal[64:128] = rng.uniform(0.0, 2e-6, 64)  # at and below EPS
    frac = rng.choice([0.0, 0.3, 0.9, 1.0, 1.7], N)  # gains, par and losses
    basis = bal * frac * rng.uniform(0.8, 1.2, N)
    basis[rng.random(N) < 0.05] = 0.0
    return bal, basis


def _rates(rng):
    r = rng.uniform(0.0, 0.6, N)
    r[rng.random(N) < 0.05] = 0.0
    r[rng.random(N) < 0.05] = 1.0  # a full-rate sale of a zero basis
    return r


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    b1, c1 = _assets(rng)
    b2, c2 = _assets(rng)
    target = rng.lognormal(9.0, 2.0, N)
    target[rng.random(N) < 0.05] = 0.0
    target[rng.random(N) < 0.05] = 1e12  # beyond any capacity
    gains = rng.normal(0.0, 2e4, (2, N))
    gains[:, :32] = 0.0
    return dict(
        b1=b1, c1=c1, b2=b2, c2=c2, target=target, g1=gains[0], g2=gains[1],
        u1=rng.random(N) < 0.5, u2=rng.random(N) < 0.5,
        r1=_rates(rng), r2=_rates(rng), a1=_rates(rng), a2=_rates(rng),
        alloc=np.concatenate([rng.uniform(0.0, 1.0, N - 2), [0.0, 1.0]]),
    )


def _both(data, names):
    t = [torch.from_numpy(data[k]) if isinstance(data[k], np.ndarray)
         else data[k] for k in names]
    j = [jnp.asarray(data[k]) for k in names]
    return t, j


def test_ops_exports_jax_names():
    assert ops.__all__ == jax_ops.__all__
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name
    assert ops.rebalance is tax.rebalance


@pytest.mark.parametrize("use", ["per_path", True, False])
def test_sale_tax_profile_and_net_liquidation_value(data, use):
    flags = data["u1"] if use == "per_path" else use
    b, c, r = (torch.from_numpy(data[k]) for k in ("b1", "c1", "r1"))
    jb, jc, jr = (jnp.asarray(data[k]) for k in ("b1", "c1", "r1"))
    tflag = torch.from_numpy(flags) if use == "per_path" else flags
    jflag = jnp.asarray(flags)
    _close(tax.sale_tax_profile(b, c, tflag, r),
           jax_tax.sale_tax_profile(jb, jc, jflag, jr), "sale_tax_profile")
    _close(tax.net_liquidation_value(b, c, tflag, r),
           jax_tax.net_liquidation_value(jb, jc, jflag, jr),
           "net_liquidation_value")


@pytest.mark.parametrize("with_eff", [False, True])
def test_withdraw_net_target(data, with_eff):
    t, j = _both(data, ("b1", "c1", "target", "u1", "r1"))
    kw_t = kw_j = {}
    if with_eff:
        kw_t = {"eff_tax": tax.sale_tax_profile(t[0], t[1], t[3], t[4])[0]}
        kw_j = {"eff_tax": jax_tax.sale_tax_profile(j[0], j[1], j[3], j[4])[0]}
    got = tax.withdraw_net_target(*t, **kw_t)
    _close(got, jax_tax.withdraw_net_target(*j, **kw_j), "withdraw_net_target")
    # The edge the kernel body treats otherwise: a rate of 1 on a zero
    # basis sells the whole live balance for no cash.
    edge = (data["u1"] & (data["r1"] == 1.0) & (data["c1"] == 0.0)
            & (data["b1"] > 1e-6) & (data["target"] > 0.0))
    assert edge.any()
    assert (got[0].numpy()[edge] == 0.0).all() and (got[3].numpy()[edge] == 0.0).all()


def test_rebalance(data):
    t, j = _both(data, ("b1", "c1", "b2", "c2", "alloc", "u1", "r1", "u2", "r2"))
    _close(tax.rebalance(*t), jax_tax.rebalance(*j), "rebalance")


def test_apply_annual_gain_taxes(data):
    names = ("b1", "c1", "b2", "c2", "g1", "g2", "alloc", "u1", "r1", "a1",
             "u2", "r2", "a2")
    t, j = _both(data, names)
    got = tax.apply_annual_gain_taxes(*t)
    _close(got, jax_tax.apply_annual_gain_taxes(*j), "apply_annual_gain_taxes")
    assert got[4].any() and not got[4].all()  # some bills fail, most pay


@pytest.fixture(scope="module")
def table():
    """(n, C) values with exact zeros, -0.0 and subnormals, and masks
    that leave one column empty and one with a single valid entry."""
    rng = np.random.default_rng(5)
    n, cols = 1001, 6
    x = rng.normal(0.0, 1e5, (n, cols))
    x[:40, 1] = 0.0
    x[40:80, 1] = -0.0
    x[80:120, 1] = 1e-310  # subnormal
    x[:, 2] = np.where(rng.random(n) < 0.5, -5e-320, 3e-320)
    valid = rng.random((n, cols)) < 0.7
    valid[:, 3] = False
    valid[:, 4] = False
    valid[7, 4] = True
    return x, valid


@pytest.mark.parametrize("masked", [False, True])
def test_order_statistics(table, masked):
    x, valid = table
    v = valid if masked else None
    counts = (valid.sum(axis=0) if masked else np.full(x.shape[1], x.shape[0]))
    rng = np.random.default_rng(2)
    ranks = np.stack([
        np.concatenate([[0, max(c - 1, 0), c, c + 5],
                        rng.integers(0, max(c, 1), 4)]) for c in counts
    ]).astype(np.int32)
    got = q.order_statistics(torch.from_numpy(x), torch.from_numpy(ranks),
                             None if v is None else torch.from_numpy(v))
    want = jax_q.order_statistics(jnp.asarray(x), jnp.asarray(ranks),
                                  None if v is None else jnp.asarray(v))
    _close(got, want, "order_statistics")
    w = np.asarray(want)
    assert np.isnan(w[:, 2:4]).all()  # at and beyond the valid count
    np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(w))


def test_exact_quantiles_parts(table):
    x, valid = table
    qs = [0.0, 0.05, 0.25, 0.5, 0.95, 1.0]
    parts = [x[:, :3], x[:, 3:]]
    valids = [None, valid[:, 3:]]
    got = q.exact_quantiles_parts([torch.from_numpy(p) for p in parts], qs,
                                  [None, torch.from_numpy(valids[1])])
    want = jax_q.exact_quantiles_parts([jnp.asarray(p) for p in parts], qs,
                                       [None, jnp.asarray(valids[1])])
    assert [tuple(g.shape) for g in got] == [(6, 3), (6, 3)]
    _close(got, want, "exact_quantiles_parts")
    assert np.isnan(np.asarray(want[1])[:, 0]).all()  # the empty column
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.signbit(g.numpy()),
                                      np.signbit(np.asarray(w)))


@pytest.mark.parametrize("col", [0, 1, 2, 3, 4])
def test_masked_median(table, col):
    x, valid = table
    xc, vc = x[:, col], valid[:, col]
    _close(q.masked_median(torch.from_numpy(xc)),
           jax_q.masked_median(jnp.asarray(xc)), "masked_median")
    _close(q.masked_median(torch.from_numpy(xc), torch.from_numpy(vc)),
           jax_q.masked_median(jnp.asarray(xc), jnp.asarray(vc)),
           "masked_median (masked)")


def test_snap_zero_band():
    tiny = np.finfo(np.float32).tiny
    x = np.array([0.0, -0.0, tiny / 4, -tiny / 2, tiny, -tiny, 1.5, -2.5,
                  np.inf, np.nan], dtype=np.float32)
    got, want = cq.snap_zero_band(x), jax_cq.snap_zero_band(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    assert not np.signbit(got[:4]).any() and (got[:4] == 0.0).all()
