"""The retirement-planning model's scenario parameters, as torch tensors.

Same model and the same numbers as the JAX package's
``models/retirement.py``: annual arithmetic mean/vol pairs become lognormal
(mu, sigma); asset 2 grows with inflation times a premium; income streams
are pruned by one shared predicate so the kernel's stream table and its
compile-time flags line up. ``SimParams`` is a dataclass of 0-d / (S,)
tensors in the JAX ``SimParams`` field order, so either package's
parameters convert into the other's leaf by leaf (``from_jax``). A scenario
batch (``stack_params``) is the same dataclass with a leading scenario axis
on every leaf: (K,) scalars and (K, S) stream tables.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..constants import MONTHS_PER_YEAR


def arithmetic_to_log_params(mean: float, vol: float) -> Tuple[float, float]:
    """Lognormal (mu, sigma) such that E[exp(mu + sigma Z)] = 1 + mean.

    vol == 0 degenerates to the deterministic drift log(1 + mean).
    """
    if mean <= -1.0:
        raise ValueError("Arithmetic mean must be greater than -100%.")
    if vol < 0:
        raise ValueError("Volatility cannot be negative.")
    if vol == 0:
        return math.log(1.0 + mean), 0.0
    gross = 1.0 + mean
    sigma = math.sqrt(math.log(1.0 + (vol * vol) / (gross * gross)))
    mu = math.log(gross) - 0.5 * sigma * sigma
    return mu, sigma


def prune_streams(config: Config) -> list:
    """Income streams that can actually pay (nonzero amount and duration).
    The same pruned list orders the SimParams stream tensors and the
    kernel ``Statics`` per-stream flags."""
    return [
        s
        for s in config.other_income_streams
        if s.monthly_amount_today > 1e-6 and s.duration_years != 0
    ]


@dataclasses.dataclass
class SimParams:
    """Scenario parameters: 0-d tensors, stream tables of shape (S,)."""

    initial_balance: torch.Tensor
    monthly_contribution: torch.Tensor
    contribution_growth: torch.Tensor
    monthly_expenses: torch.Tensor
    alloc1: torch.Tensor
    alloc1_final: torch.Tensor

    mu1: torch.Tensor
    sigma1: torch.Tensor
    mu_inf: torch.Tensor
    sigma_inf: torch.Tensor
    mu_prem: torch.Tensor
    sigma_prem: torch.Tensor
    rho: torch.Tensor

    ann_tax1: torch.Tensor
    ann_tax2: torch.Tensor
    real_tax1: torch.Tensor
    real_tax2: torch.Tensor
    use_real1: torch.Tensor  # bool
    use_real2: torch.Tensor  # bool

    gr_upper: torch.Tensor
    gr_lower: torch.Tensor
    gr_adjust: torch.Tensor
    gr_floor: torch.Tensor
    gr_cap: torch.Tensor

    jump_p: torch.Tensor
    jump_mu: torch.Tensor
    jump_sigma: torch.Tensor
    jump_beta: torch.Tensor
    jump_comp1: torch.Tensor
    jump_comp2: torch.Tensor

    mort_g0: torch.Tensor
    mort_b12: torch.Tensor
    mort_cap: torch.Tensor

    stream_amount: torch.Tensor
    stream_months_from_t0: torch.Tensor
    stream_duration_months: torch.Tensor  # +inf when indefinite
    stream_indexed: torch.Tensor  # bool
    stream_tax: torch.Tensor

    @property
    def n_streams(self) -> int:
        return int(self.stream_amount.shape[-1])

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))

    @classmethod
    def from_config(
        cls, config: Config, dtype=torch.float64, device="cpu"
    ) -> "SimParams":
        """Build the parameters from a validated Config (host math in f64,
        identical to the JAX package's ``SimParams.host_leaves``)."""
        return cls._from_arrays(_host_leaves(config), dtype, device)

    @classmethod
    def from_jax(cls, leaves, dtype=torch.float64, device="cpu") -> "SimParams":
        """The JAX package's parameters -> the port's.

        ``leaves`` is a JAX ``SimParams`` (or its ``host_leaves``) whose
        leaves convert with ``np.asarray``, or any sequence of arrays in the
        same field order. A stacked batch (the JAX ``stack_params``: numpy
        leaves with a leading scenario axis) converts the same way into the
        port's stacked form, leaf shapes kept."""
        names = cls.field_names()
        if hasattr(leaves, "_fields"):
            arrays = {n: np.asarray(getattr(leaves, n)) for n in names}
        else:
            leaves = list(leaves)
            if len(leaves) != len(names):
                raise ValueError(
                    f"expected {len(names)} leaves, got {len(leaves)}"
                )
            arrays = {n: np.asarray(v) for n, v in zip(names, leaves)}
        return cls._from_arrays(arrays, dtype, device)

    @classmethod
    def _from_arrays(cls, arrays: dict, dtype, device) -> "SimParams":
        out = {}
        for name in cls.field_names():
            a = np.asarray(arrays[name])
            if a.dtype == np.bool_:
                out[name] = torch.as_tensor(a, dtype=torch.bool, device=device)
            else:
                out[name] = torch.as_tensor(
                    a.astype(np.float64), dtype=dtype, device=device
                )
        return cls(**out)


def stack_params(configs: Sequence[Config], dtype=torch.float64,
                 device="cpu") -> SimParams:
    """Stack per-config parameters into one batch with a leading scenario
    axis (the JAX ``engine/scenario_batch.py::stack_params``, same checks
    and messages). The host math runs in float64 numpy, so stacking K
    configs costs one tensor per leaf, not K."""
    if not configs:
        raise ValueError("scenario batch needs at least one config")
    r_years = {c.retirement_years for c in configs}
    if len(r_years) != 1:
        raise ValueError(
            f"all configs must share retirement_years, got {sorted(r_years)}"
        )
    per_config = [_host_leaves(c) for c in configs]
    # Validate on the PRUNED stream count: the raw config counts can match
    # while the stacked table shapes do not.
    n_streams = {len(p["stream_amount"]) for p in per_config}
    if len(n_streams) != 1:
        raise ValueError(
            "all configs must have the same number of effective income "
            "streams after pruning zero-amount/zero-duration ones, got "
            f"counts {sorted(n_streams)}"
        )
    stacked = {
        name: np.stack([p[name] for p in per_config])
        for name in SimParams.field_names()
    }
    return SimParams._from_arrays(stacked, dtype, device)


def _host_leaves(config: Config) -> dict:
    """Every parameter as a float64/bool numpy array, keyed by field name."""
    mu1, s1 = arithmetic_to_log_params(
        config.inv1_returns_mean, config.inv1_returns_volatility
    )
    mui, si = arithmetic_to_log_params(
        config.inflation_rate_mean, config.inflation_rate_volatility
    )
    mup, sp = arithmetic_to_log_params(
        config.inv2_premium_over_inflation_mean,
        config.inv2_premium_over_inflation_volatility,
    )
    # Expense ratios fold into the drifts (log1p(-0.0) == 0.0 keeps the
    # fee-free default bit-identical).
    mu1 += math.log1p(-getattr(config, "inv1_expense_ratio_annual", 0.0))
    mup += math.log1p(-getattr(config, "inv2_expense_ratio_annual", 0.0))
    streams = prune_streams(config)
    n = len(streams)
    amounts = np.array([s.monthly_amount_today for s in streams], np.float64)
    from_t0 = np.array(
        [
            (float(s.start_at_age) - float(config.current_age)) * MONTHS_PER_YEAR
            for s in streams
        ],
        dtype=np.float64,
    )
    durations = np.array(
        [
            np.inf if s.duration_years is None
            else float(s.duration_years) * MONTHS_PER_YEAR
            for s in streams
        ],
        dtype=np.float64,
    )
    indexed = np.array([s.inflation_indexed for s in streams], dtype=bool)
    taxes = np.array([s.tax_rate for s in streams], dtype=np.float64)
    gr = getattr(config, "spending_guardrails", None)
    mc = getattr(config, "market_crashes", None)
    lg = getattr(config, "longevity", None)
    if lg is None:
        mg0, mb12, mcap = 0.0, 0.0, 3.0e7
    else:
        mg0 = (lg.mode_age - config.current_age) / lg.dispersion_years
        mb12 = MONTHS_PER_YEAR * lg.dispersion_years
        mcap = max(0.0, (lg.max_age - config.current_age) * MONTHS_PER_YEAR)
    if mc is None:
        jp = jmu = jsig = jbeta = jc1 = jc2 = 0.0
    else:
        jp = mc.frequency_per_year / MONTHS_PER_YEAR
        jmu = math.log(1.0 - mc.mean_drop_pct / 100.0)
        jsig = mc.size_volatility
        jbeta = mc.inv2_beta
        jc1 = math.log((1.0 - jp) + jp * math.exp(jmu + 0.5 * jsig * jsig))
        jc2 = math.log(
            (1.0 - jp) + jp * math.exp(jbeta * jmu + 0.5 * (jbeta * jsig) ** 2)
        )

    f = lambda x: np.asarray(x, dtype=np.float64)
    final_alloc = getattr(config, "allocation_inv1_final_pct", None)
    return dict(
        initial_balance=f(config.initial_balance),
        monthly_contribution=f(config.monthly_contribution),
        contribution_growth=f(config.contribution_growth_rate_annual),
        monthly_expenses=f(config.monthly_expenses),
        alloc1=f(config.allocation_inv1_pct),
        alloc1_final=f(
            config.allocation_inv1_pct if final_alloc is None else final_alloc
        ),
        mu1=f(mu1),
        sigma1=f(s1),
        mu_inf=f(mui),
        sigma_inf=f(si),
        mu_prem=f(mup),
        sigma_prem=f(sp),
        rho=f(config.equity_inflation_correlation),
        ann_tax1=f(config.inv1_annual_tax_on_gains_rate),
        ann_tax2=f(config.inv2_annual_tax_on_gains_rate),
        real_tax1=f(config.inv1_realized_gains_tax_rate),
        real_tax2=f(config.inv2_realized_gains_tax_rate),
        use_real1=np.asarray(bool(config.inv1_use_realized_gains_tax_system)),
        use_real2=np.asarray(bool(config.inv2_use_realized_gains_tax_system)),
        gr_upper=f(np.inf if gr is None else gr.upper_wr_pct / 100.0),
        gr_lower=f(0.0 if gr is None else gr.lower_wr_pct / 100.0),
        gr_adjust=f(0.0 if gr is None else gr.adjustment_pct / 100.0),
        gr_floor=f(1.0 if gr is None else gr.floor_pct / 100.0),
        gr_cap=f(1.0 if gr is None else gr.cap_pct / 100.0),
        jump_p=f(jp),
        jump_mu=f(jmu),
        jump_sigma=f(jsig),
        jump_beta=f(jbeta),
        jump_comp1=f(jc1),
        jump_comp2=f(jc2),
        mort_g0=f(mg0),
        mort_b12=f(mb12),
        mort_cap=f(mcap),
        stream_amount=f(amounts.reshape(n)),
        stream_months_from_t0=f(from_t0.reshape(n)),
        stream_duration_months=f(durations.reshape(n)),
        stream_indexed=indexed.reshape(n),
        stream_tax=f(taxes.reshape(n)),
    )
