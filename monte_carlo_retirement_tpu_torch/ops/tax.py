"""The month loop's tax algebra in torch (plain versions of the kernel body).

Operation for operation the JAX Pallas body's helpers — ``profile``
(``pallas_kernel.py:587-598``), ``rebalance_lite`` (``:600-638``), the
capacity-limited withdrawal split pro-rata by net capacity (``:975-1000``)
and the annual mark-to-market settlement ``annual_tax`` (``:645-690``) —
with IEEE division where Pallas used its approximate reciprocal. The
average-cost-basis invariant makes one per-asset sale profile serve the
capacity check, the withdrawal and the rebalance: realized tax is exactly
``gross * eff``. Tested against the JAX package's ``ops/tax.py`` closed forms,
which follow at the end of this module under their JAX names
(``sale_tax_profile``, ``withdraw_net_target``, ``net_liquidation_value``,
``rebalance``, ``apply_annual_gain_taxes``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..constants import SMALL_EPSILON

EPS = SMALL_EPSILON

Tensor = torch.Tensor


def fail_rtol(dtype) -> float:
    """Relative slack for funding-failure comparisons: 2e-5 in float32 (the
    f32 chain carries hundreds of balance ulps of rounding), 0 in float64
    (bit-comparable to the reference's absolute 1e-6)."""
    return 2e-5 if dtype == torch.float32 else 0.0


def profile(b: Tensor, c: Tensor, use: bool, rate):
    """Sale profile of one asset: (eff, nf, nc) = tax per gross dollar, net
    per gross dollar and full-liquidation net capacity. ``rate`` is a float
    or a tensor that broadcasts against ``b`` (one rate per scenario row)."""
    live = b > EPS
    if not use:
        return (
            torch.zeros_like(b),
            torch.ones_like(b),
            torch.where(live, b, 0.0),
        )
    safe = torch.where(live, b, 1.0)
    gf = torch.clamp(b - c, min=0.0) / safe
    eff = gf * rate
    nf = 1.0 - eff
    nc = torch.where(live, b * nf, 0.0)
    return eff, nf, nc


def rebalance_lite(b1, c1, b2, c2, eff1, eff2, a1, extra_noop=None):
    """Tax-aware rebalance toward target ``a1`` (a float, or a tensor that
    broadcasts against the balances: one target per scenario row) whose
    post-tax weights are exact: the over-weight side sells gross x with
    x = |drift| / (1 - alloc_s * eff_s); the buyer's basis grows by the net
    purchase only."""
    total = b1 + b2
    a1 = torch.as_tensor(a1, dtype=total.dtype, device=total.device)
    drift1 = b1 - total * a1
    adrift = drift1.abs()
    sell1 = drift1 > 0
    noop = (total <= EPS) | (adrift <= EPS)
    if extra_noop is not None:
        noop = noop | extra_noop
    bal_s = torch.where(sell1, b1, b2)
    basis_s = torch.where(sell1, c1, c2)
    eff_s = torch.where(sell1, eff1, eff2)
    alloc_s = torch.where(sell1, a1, 1.0 - a1)
    denom = torch.clamp(1.0 - alloc_s * eff_s, min=EPS)
    gross_s = torch.minimum(bal_s, adrift / denom)
    frac_s = gross_s / torch.where(bal_s > EPS, bal_s, 1.0)
    net_p = gross_s * (1.0 - eff_s)
    new_sb = bal_s - gross_s
    new_sc = basis_s - basis_s * frac_s
    bal_b = torch.where(sell1, b2, b1) + net_p
    basis_b = torch.where(sell1, c2, c1) + net_p
    ob1 = torch.where(sell1, new_sb, bal_b)
    oc1 = torch.where(sell1, new_sc, basis_b)
    ob2 = torch.where(sell1, bal_b, new_sb)
    oc2 = torch.where(sell1, basis_b, new_sc)
    z1 = ob1 <= EPS
    z2 = ob2 <= EPS
    ob1 = torch.where(z1, 0.0, ob1)
    oc1 = torch.where(z1, 0.0, oc1)
    ob2 = torch.where(z2, 0.0, ob2)
    oc2 = torch.where(z2, 0.0, oc2)
    return (
        torch.where(noop, b1, ob1),
        torch.where(noop, c1, oc1),
        torch.where(noop, b2, ob2),
        torch.where(noop, c2, oc2),
    )


def monthly_rebalance(b1, c1, b2, c2, a1, use1, r1, use2, r2):
    eff1, _, _ = profile(b1, c1, use1, r1)
    eff2, _, _ = profile(b2, c2, use2, r2)
    return rebalance_lite(b1, c1, b2, c2, eff1, eff2, a1)


def withdraw_pro_rata(
    b1, c1, b2, c2, need, prof1, prof2, wmask
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Capacity-limited withdrawal of net ``need`` split pro-rata by net
    capacity: ONE sale fraction (need / total capacity, snapped to exactly
    1 when the need exceeds it) applies to both balances and bases.
    Returns (b1, c1, b2, c2, gross, net) where gross/net are the gross sold
    and the net cash delivered (zero where ``wmask`` is off)."""
    _eff1, nf1, nc1 = prof1
    _eff2, nf2, nc2 = prof2
    tnc = nc1 + nc2
    wmask_f = torch.where(wmask, 1.0, 0.0).to(b1.dtype)
    # The minimum keeps 0 <= frac <= 1 by construction.
    frac_w = torch.clamp(
        torch.where(need >= tnc, 1.0, need / torch.clamp(tnc, min=EPS)),
        max=1.0,
    ) * wmask_f
    keep_w = 1.0 - frac_w
    ok1 = nc1 > 0
    ok2 = nc2 > 0
    gross1 = torch.where(ok1, b1 * frac_w, 0.0)
    gross2 = torch.where(ok2, b2 * frac_w, 0.0)
    net = gross1 * nf1 + gross2 * nf2
    c1 = torch.where(ok1, c1 * keep_w, c1)
    c2 = torch.where(ok2, c2 * keep_w, c2)
    b1 = b1 - gross1
    b2 = b2 - gross2
    e1 = b1 <= EPS
    e2 = b2 <= EPS
    b1 = torch.where(e1, 0.0, b1)
    c1 = torch.where(e1, 0.0, c1)
    b2 = torch.where(e2, 0.0, b2)
    c2 = torch.where(e2, 0.0, c2)
    return b1, c1, b2, c2, gross1 + gross2, net


def annual_tax(b1, c1, b2, c2, g1a, g2a, a1, use1, r1, bill1, ann1, use2, r2,
               bill2, ann2, rtol):
    """Settle one completed mark-to-market tax period: the bill on each
    billed asset's positive period gains ``g*a`` (market P&L only) at its
    annual rate, paid from both assets pro-rata by net capacity — the
    withdrawal's one sale fraction — then an exact-post-tax rebalance
    toward ``a1``. ``bill1``/``bill2`` are the Statics flags, ``rtol`` the
    dtype's :func:`fail_rtol`. Returns (b1, c1, b2, c2, tax_failed)."""
    due1 = torch.clamp(g1a, min=0.0) * ann1 if bill1 else torch.zeros_like(b1)
    due2 = torch.clamp(g2a, min=0.0) * ann2 if bill2 else torch.zeros_like(b2)
    total_due = due1 + due2
    prof1 = profile(b1, c1, use1, r1)
    prof2 = profile(b2, c2, use2, r2)
    tnc = prof1[2] + prof2[2]
    payment = torch.minimum(total_due, tnc)
    tol = EPS + rtol * (total_due + tnc)
    do_pay = (tnc > EPS) & (payment > 0)
    b1, c1, b2, c2, _gross, _net = withdraw_pro_rata(
        b1, c1, b2, c2, total_due, prof1, prof2, do_pay
    )
    failed = payment < total_due - tol
    b1, c1, b2, c2 = monthly_rebalance(b1, c1, b2, c2, a1, use1, r1, use2, r2)
    return b1, c1, b2, c2, failed


# ---------------------------------------------------------------------------
# The JAX package's public closed forms (``ops/tax.py:45-253``), same
# signatures and return tuples. The month loop above runs the kernel body's
# algebra; these are the scan's per-asset forms, kept operation for
# operation: they differ from the body's where a rate of 1 meets a zero
# basis (the closed form sells the asset for no cash, the body sells
# nothing) and by rounding where a sale nearly empties an asset. The
# realized-tax flags may be booleans or bool tensors that broadcast.
# ---------------------------------------------------------------------------
def _safe(x: Tensor) -> Tensor:
    """A strictly positive denominator stand-in for balances near zero."""
    return torch.where(x > EPS, x, torch.ones_like(x))


def _flag(use, like: Tensor) -> Tensor:
    return torch.as_tensor(use, dtype=torch.bool, device=like.device)


def sale_tax_profile(bal: Tensor, basis: Tensor, use_realized_tax,
                     tax_rate) -> Tuple[Tensor, Tensor]:
    """Per-asset (tax per gross dollar sold, full-liquidation net
    capacity): the capacity is :func:`net_liquidation_value`."""
    use = _flag(use_realized_tax, bal)
    gain = torch.clamp(bal - basis, min=0.0)
    eff_tax = torch.where(use, (gain / _safe(bal)) * tax_rate, 0.0)
    tax = torch.where(use, gain * tax_rate, 0.0)
    capacity = torch.where(bal <= EPS, 0.0, torch.clamp(bal - tax, min=0.0))
    return eff_tax, capacity


def withdraw_net_target(bal: Tensor, basis: Tensor, net_target: Tensor,
                        use_realized_tax, tax_rate, eff_tax=None
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Sell just enough of one asset to deliver ``net_target`` cash after
    realized-gains tax, under average-cost basis (the basis removed is the
    sold fraction of the basis; the sale is capped at the balance, so the
    cash may fall short). ``eff_tax`` from :func:`sale_tax_profile` may be
    passed. Returns (new_balance, new_basis, gross_withdrawal,
    net_cash_delivered)."""
    use = _flag(use_realized_tax, bal)
    active = (bal > EPS) & (net_target > 0)
    if eff_tax is None:
        gain_frac = torch.clamp(bal - basis, min=0.0) / _safe(bal)
        eff_tax = torch.where(use, gain_frac * tax_rate, 0.0)
    net_frac = torch.clamp(1.0 - eff_tax, min=EPS)
    gross = torch.minimum(net_target / net_frac, bal)
    frac_sold = gross / _safe(bal)
    basis_removed = basis * frac_sold
    taxable_gain = torch.clamp(gross - basis_removed, min=0.0)
    tax_paid = torch.where(use, taxable_gain * tax_rate, 0.0)
    net_cash = torch.clamp(gross - tax_paid, min=0.0)
    new_bal = torch.clamp(bal - gross, min=0.0)
    new_basis = torch.clamp(basis - basis_removed, min=0.0)
    emptied = new_bal <= EPS
    new_bal = torch.where(emptied, 0.0, new_bal)
    new_basis = torch.where(emptied, 0.0, new_basis)
    return (
        torch.where(active, new_bal, torch.clamp(bal, min=0.0)),
        torch.where(active, new_basis, torch.clamp(basis, min=0.0)),
        torch.where(active, gross, 0.0),
        torch.where(active, net_cash, 0.0),
    )


def net_liquidation_value(bal: Tensor, basis: Tensor, use_realized_tax,
                          tax_rate) -> Tensor:
    """Cash obtained by liquidating an asset and paying its gains tax: the
    withdrawal capacity and the ruin test."""
    return sale_tax_profile(bal, basis, use_realized_tax, tax_rate)[1]


def rebalance(bal1: Tensor, basis1: Tensor, bal2: Tensor, basis2: Tensor,
              alloc1, use_real1, rate1, use_real2, rate2
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Tax-aware restore of the target allocation: the over-weight side
    sells gross x solving ``bal_s - x = alloc_s * (total - tax_per_$ * x)``,
    so the post-tax weights are exact; the buyer's basis grows by the net
    purchase only."""
    total = bal1 + bal2
    drift1 = bal1 - total * alloc1
    noop = (total <= EPS) | (drift1.abs() <= EPS)
    sell1 = drift1 > 0
    alloc2 = 1.0 - alloc1
    bal_s = torch.where(sell1, bal1, bal2)
    basis_s = torch.where(sell1, basis1, basis2)
    flag1 = _flag(use_real1, bal1).to(bal1.dtype)
    flag2 = _flag(use_real2, bal1).to(bal1.dtype)
    taxed_rate_s = torch.where(sell1, rate1 * flag1, rate2 * flag2)
    alloc_s = torch.where(sell1, alloc1, alloc2)
    drift_s = torch.where(sell1, drift1, bal2 - total * alloc2)
    gain_frac = torch.clamp(bal_s - basis_s, min=0.0) / _safe(bal_s)
    tax_per_dollar = gain_frac * taxed_rate_s
    denom = torch.clamp(1.0 - alloc_s * tax_per_dollar, min=EPS)
    gross_sale = torch.minimum(bal_s, drift_s / denom)
    frac_sold = gross_sale / _safe(bal_s)
    basis_removed = torch.minimum(basis_s, basis_s * frac_sold)
    taxable_gain = torch.clamp(gross_sale - basis_removed, min=0.0)
    net_purchase = gross_sale - taxable_gain * taxed_rate_s
    new_s_bal = torch.clamp(bal_s - gross_sale, min=0.0)
    new_s_basis = torch.clamp(basis_s - basis_removed, min=0.0)
    bal_b = torch.where(sell1, bal2, bal1) + net_purchase
    basis_b = torch.where(sell1, basis2, basis1) + net_purchase
    out_b1 = torch.where(sell1, new_s_bal, bal_b)
    out_c1 = torch.where(sell1, new_s_basis, basis_b)
    out_b2 = torch.where(sell1, bal_b, new_s_bal)
    out_c2 = torch.where(sell1, basis_b, new_s_basis)
    z1, z2 = out_b1 <= EPS, out_b2 <= EPS
    out_b1 = torch.where(z1, 0.0, out_b1)
    out_c1 = torch.where(z1, 0.0, out_c1)
    out_b2 = torch.where(z2, 0.0, out_b2)
    out_c2 = torch.where(z2, 0.0, out_c2)
    return (
        torch.where(noop, bal1, out_b1),
        torch.where(noop, basis1, out_c1),
        torch.where(noop, bal2, out_b2),
        torch.where(noop, basis2, out_c2),
    )


def apply_annual_gain_taxes(bal1: Tensor, basis1: Tensor, bal2: Tensor,
                            basis2: Tensor, gain1: Tensor, gain2: Tensor,
                            alloc1, use_real1, rate_real1, rate_ann1,
                            use_real2, rate_real2, rate_ann2
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Settle one completed mark-to-market tax period: the bill on each
    annual-system asset's positive market P&L ``gain*``, drawn from both
    assets pro-rata by net capacity (a realized-tax asset may sell extra to
    pay its share), then an unconditional :func:`rebalance`. Returns
    (b1, c1, b2, c2, tax_failed)."""
    u1, u2 = _flag(use_real1, bal1), _flag(use_real2, bal1)
    due1 = torch.where(u1, 0.0, torch.clamp(gain1, min=0.0) * rate_ann1)
    due2 = torch.where(u2, 0.0, torch.clamp(gain2, min=0.0) * rate_ann2)
    total_due = due1 + due2
    eff1, cap1 = sale_tax_profile(bal1, basis1, u1, rate_real1)
    eff2, cap2 = sale_tax_profile(bal2, basis2, u2, rate_real2)
    total_cap = cap1 + cap2
    payment = torch.minimum(total_due, total_cap)
    tol = EPS + fail_rtol(bal1.dtype) * (total_due + total_cap)
    tax_failed = payment < total_due - tol
    do_pay = (total_cap > EPS) & (payment > 0)
    share1 = cap1 / _safe(total_cap)
    share2 = 1.0 - share1
    nb1, nc1, _, net1 = withdraw_net_target(bal1, basis1, payment * share1,
                                            u1, rate_real1, eff_tax=eff1)
    nb2, nc2, _, net2 = withdraw_net_target(bal2, basis2, payment * share2,
                                            u2, rate_real2, eff_tax=eff2)
    bal1 = torch.where(do_pay, nb1, bal1)
    basis1 = torch.where(do_pay, nc1, basis1)
    bal2 = torch.where(do_pay, nb2, bal2)
    basis2 = torch.where(do_pay, nc2, basis2)
    tax_failed = tax_failed | (do_pay & (net1 + net2 < total_due - tol))
    bal1, basis1, bal2, basis2 = rebalance(bal1, basis1, bal2, basis2, alloc1,
                                           u1, rate_real1, u2, rate_real2)
    return bal1, basis1, bal2, basis2, tax_failed
