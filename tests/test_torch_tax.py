"""The port's tax algebra vs the JAX package's closed forms (ops/tax.py), f64.

The port's ``profile`` / ``rebalance_lite`` use the Pallas body's reduced
algebra (one gain fraction per asset; realized tax = gross * eff); the JAX
``sale_tax_profile`` / ``rebalance`` compute the same quantities the long
way (taxable gain, basis removed, max() chains). In float64 they agree to
round-off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.ops import tax as jax_tax  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import tax  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-12


def _close(got, want, scale):
    """Relative 1e-12 of the quantity's natural scale (the balances it was
    computed from), so exact zeros and tiny residuals compare fairly."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert (np.abs(got - want) <= RTOL * np.maximum(np.abs(want), scale)).all(), (
        np.max(np.abs(got - want) / np.maximum(np.abs(want), scale))
    )


def _balances(rng, n):
    b = rng.uniform(0.0, 2e6, n)
    c = b * rng.uniform(0.2, 1.6, n)  # gains and losses
    b[:8] = [0.0, 1e-7, 5e-7, 2e-6, 1.0, 10.0, 3e5, 3e5]
    c[:8] = [0.0, 0.0, 1e-7, 5e-6, 2.0, 0.0, 3e5, 0.0]
    return b, c


@pytest.mark.parametrize("use", [True, False])
def test_profile_matches_sale_tax_profile(use):
    rng = np.random.default_rng(1 + use)
    b, c = _balances(rng, 4096)
    rate = 0.23
    eff_j, cap_j = jax_tax.sale_tax_profile(
        jnp.asarray(b), jnp.asarray(c), jnp.asarray(use), jnp.asarray(rate)
    )
    eff, nf, nc = tax.profile(torch.from_numpy(b), torch.from_numpy(c), use, rate)
    _close(eff.numpy(), np.asarray(eff_j), 1.0)
    _close(nf.numpy(), 1.0 - np.asarray(eff_j), 1.0)
    _close(nc.numpy(), np.asarray(cap_j), b)


@pytest.mark.parametrize("use1,use2", [(True, True), (True, False),
                                       (False, True), (False, False)])
def test_rebalance_lite_matches_rebalance(use1, use2):
    rng = np.random.default_rng(10 + 2 * use1 + use2)
    n = 4096
    b1, c1 = _balances(rng, n)
    b2, c2 = _balances(rng, n)
    b2[:8] = b2[:8][::-1]
    r1, r2 = 0.15, 0.3
    for a1 in (0.0, 0.35, 0.6, 1.0):
        want = jax_tax.rebalance(
            *(jnp.asarray(v) for v in (b1, c1, b2, c2)), jnp.asarray(a1),
            jnp.asarray(use1), jnp.asarray(r1), jnp.asarray(use2), jnp.asarray(r2),
        )
        t = [torch.from_numpy(v) for v in (b1, c1, b2, c2)]
        got = tax.monthly_rebalance(*t, a1, use1, r1, use2, r2)
        scale = b1 + b2
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w), scale)
        # Post-tax weights are exact where a rebalance happened.
        total = (got[0] + got[2]).numpy()
        live = total > 1.0
        np.testing.assert_allclose(got[0].numpy()[live],
                                   a1 * total[live], rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("use1,use2", [(False, False), (True, False),
                                       (False, True)])
def test_annual_tax_matches_apply_annual_gain_taxes(use1, use2):
    rng = np.random.default_rng(20 + 2 * use1 + use2)
    n = 4096
    b1, c1 = _balances(rng, n)
    b2, c2 = _balances(rng, n)
    g1 = rng.uniform(-2e5, 4e5, n)  # period market gains, losses included
    g2 = rng.uniform(-2e5, 4e5, n)
    g1[:4] = [3e6, 0.0, -1.0, 5e5]  # bills beyond the capacity fail
    r1, r2, ann1, ann2 = 0.15, 0.3, 0.25, 0.2
    bill1, bill2 = not use1, not use2
    for a1 in (0.0, 0.35, 1.0):
        want = jax_tax.apply_annual_gain_taxes(
            *(jnp.asarray(v) for v in (b1, c1, b2, c2, g1, g2)), jnp.asarray(a1),
            jnp.asarray(use1), jnp.asarray(r1), jnp.asarray(ann1),
            jnp.asarray(use2), jnp.asarray(r2), jnp.asarray(ann2),
        )
        t = [torch.from_numpy(v) for v in (b1, c1, b2, c2, g1, g2)]
        got = tax.annual_tax(*t, a1, use1, r1, bill1, ann1, use2, r2, bill2,
                             ann2, tax.fail_rtol(torch.float64))
        # The Pallas body zeroes a balance at or below EPS (1e-6) after the
        # bill's sale on every path, the closed form only on paths that
        # pay: the two differ by that dust and by round-off.
        scale = b1 + b2
        for g, w in zip(got[:4], want[:4]):
            diff = np.abs(g.numpy() - np.asarray(w))
            assert (diff <= RTOL * np.maximum(np.abs(w), scale) + 2e-6).all()
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        assert bool(got[4][0]) and 0 < int(got[4].sum()) < n  # g1[0]: 3e6
        assert (got[0] >= 0).all() and (got[2] >= 0).all()


def test_withdraw_pro_rata_delivers_the_need_or_everything():
    rng = np.random.default_rng(5)
    n = 4096
    b1, c1 = _balances(rng, n)
    b2, c2 = _balances(rng, n)
    t = [torch.from_numpy(v) for v in (b1, c1, b2, c2)]
    need = torch.from_numpy(rng.uniform(0.0, 3e6, n))
    p1 = tax.profile(t[0], t[1], True, 0.2)
    p2 = tax.profile(t[2], t[3], False, 0.0)
    wmask = torch.ones(n, dtype=torch.bool)
    wmask[:16] = False
    nb1, nc1, nb2, nc2, gross, net = tax.withdraw_pro_rata(*t, need, p1, p2, wmask)
    cap = (p1[2] + p2[2]).numpy()
    want = np.where(need.numpy() >= cap, cap, need.numpy())
    want[:16] = 0.0
    np.testing.assert_allclose(net.numpy(), want, rtol=1e-12, atol=1e-6)
    # Gross sold is what left the balances; nothing is created.
    np.testing.assert_allclose((t[0] - nb1 + t[2] - nb2).numpy(), gross.numpy(),
                               rtol=1e-12, atol=2e-6)
    assert (nb1 >= 0).all() and (nb2 >= 0).all() and (nc1 >= 0).all()
    assert tax.fail_rtol(torch.float32) == 2e-5 and tax.fail_rtol(torch.float64) == 0.0
