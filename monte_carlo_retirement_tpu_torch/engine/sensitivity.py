"""Parameter sensitivity analysis on the port, two ways (the JAX
package's ``engine/sensitivity.py``, with the port's imports):

* **Finite differences with common random numbers** (``sensitivity_fd``,
  JAX lines 49-347). Every perturbed scenario (theta +/- h for each
  parameter) is one row of a scenario grid (``engine/scenario_batch.py``),
  so all probes share their shocks: the +/- difference cancels the Monte
  Carlo noise common to both rows, and only paths whose outcome actually
  flips contribute. Cost: 2K+1 grid rows on the grid kernel.

* **Forward-mode AD** (``sensitivity_ad``, JAX lines 354-551): d mean final
  balance / d theta, every parameter's tangent in one pass. The tangents of
  the parameter block come from ``torch.func.jacfwd`` of theta -> block
  (scalars only); the month loop's JVP along them is the JVP kernel on the
  card (``cuda_kernel.simulate_jvp``, the compiled form of JAX's
  ``jit(jacfwd)`` through its scan) and its plain version,
  ``torch.func.jvp`` of the plain loop, on the CPU. By default the paths
  are the grid kernel's (the same Philox stream seed); with
  ``backend="scan"`` they are JAX's own (``simulate_paths``' draws on
  ``stream_keys(seed)[1]``). Both functions read ``MCRT_GRID_BACKEND``, so
  AD and the CRN finite difference always see the same shocks. Success is
  a step function (AD sees derivative 0), so AD covers the smooth
  mean-final-balance metric as an independent cross-check of the FD
  slopes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..constants import MONTHS_PER_YEAR
from ..models.retirement import SimParams
from ..ops.shocks import stream_keys
from . import kernel
from .cuda_kernel import (
    pack_params,
    require_device,
    simulate_jvp,
    statics_from_config,
)
from .scenario_batch import (
    ScenarioBatchResult,
    _grid_stream_seed,
    run_scenario_grid,
)

__all__ = [
    "SENSITIVITY_PARAMS",
    "DEFAULT_PARAMS",
    "SensitivityRow",
    "sensitivity_fd",
    "sensitivity_ad",
]


class ParamSpec(NamedTuple):
    lo: float  # hard lower bound of the Config field
    hi: float  # hard upper bound (inf = open)
    kind: str  # "dollar": relative step; "rate": absolute step
    scale: float  # step fallback scale for a zero-valued dollar param


_INF = float("inf")

# Every numeric scalar Config field whose perturbation keeps the compiled
# structure fixed (same Statics, same stream shape) is eligible. Bounds
# mirror config.py's pydantic constraints so perturbed configs re-validate.
SENSITIVITY_PARAMS: Dict[str, ParamSpec] = {
    "initial_balance": ParamSpec(0.0, _INF, "dollar", 10_000.0),
    "monthly_contribution": ParamSpec(0.0, _INF, "dollar", 100.0),
    "contribution_growth_rate_annual": ParamSpec(0.0, _INF, "rate", 0.0),
    "monthly_expenses": ParamSpec(0.0, _INF, "dollar", 100.0),
    "allocation_inv1_pct": ParamSpec(0.0, 1.0, "rate", 0.0),
    # Glide endpoint: eligible only when the base config sets it (a None
    # base cannot be perturbed — and flipping glide on/off is a Statics
    # change); _resolve_spec enforces that.
    "allocation_inv1_final_pct": ParamSpec(0.0, 1.0, "rate", 0.0),
    "inv1_returns_mean": ParamSpec(-0.999, _INF, "rate", 0.0),
    "inv1_returns_volatility": ParamSpec(0.0, _INF, "rate", 0.0),
    "inv1_expense_ratio_annual": ParamSpec(0.0, 0.999, "rate", 0.0),
    "inv2_expense_ratio_annual": ParamSpec(0.0, 0.999, "rate", 0.0),
    "inv1_annual_tax_on_gains_rate": ParamSpec(0.0, 1.0, "rate", 0.0),
    "inv1_realized_gains_tax_rate": ParamSpec(0.0, 1.0, "rate", 0.0),
    "inv2_premium_over_inflation_mean": ParamSpec(-0.999, _INF, "rate", 0.0),
    "inv2_premium_over_inflation_volatility": ParamSpec(0.0, _INF, "rate", 0.0),
    "inv2_annual_tax_on_gains_rate": ParamSpec(0.0, 1.0, "rate", 0.0),
    "inv2_realized_gains_tax_rate": ParamSpec(0.0, 1.0, "rate", 0.0),
    "inflation_rate_mean": ParamSpec(-0.999, _INF, "rate", 0.0),
    "inflation_rate_volatility": ParamSpec(0.0, _INF, "rate", 0.0),
    "equity_inflation_correlation": ParamSpec(-1.0, 1.0, "rate", 0.0),
    # Nested guardrail bands (dotted paths; percent UNITS, so they use the
    # relative "dollar" step rule with scale 1). Probing requires the rule
    # to be set on the base config (a None parent is rejected like any
    # unset optional field); FD-only — the bands enter the kernel through
    # comparisons/clamps, so forward-mode AD is not offered for them.
    "spending_guardrails.upper_wr_pct": ParamSpec(1e-6, 100.0, "dollar", 1.0),
    "spending_guardrails.lower_wr_pct": ParamSpec(0.0, 100.0, "dollar", 1.0),
    "spending_guardrails.adjustment_pct": ParamSpec(1e-6, 50.0, "dollar", 1.0),
    "spending_guardrails.floor_pct": ParamSpec(0.0, 100.0, "dollar", 1.0),
    "spending_guardrails.cap_pct": ParamSpec(100.0, _INF, "dollar", 1.0),
    # Market-crash parameters (dotted paths; FD-only like every dotted
    # name — the crash indicator u < p is a step function, so forward-mode
    # AD would see derivative 0 in the frequency anyway). Probing requires
    # market_crashes set on the base config (flipping it on/off is a
    # Statics / draw-structure change).
    "market_crashes.frequency_per_year": ParamSpec(0.0, 12.0, "dollar", 0.1),
    "market_crashes.mean_drop_pct": ParamSpec(1e-6, 99.99, "dollar", 1.0),
    "market_crashes.size_volatility": ParamSpec(0.0, 2.0, "rate", 0.0),
    "market_crashes.inv2_beta": ParamSpec(0.0, 1.0, "rate", 0.0),
    # Longevity parameters (dotted paths; FD-only like every dotted name —
    # the lifespan enters the kernel through month comparisons). Probing
    # requires longevity set on the base config (flipping it on/off is a
    # Statics / draw-structure change). Ages are years, so the relative
    # "dollar" step rule with scale 1 applies.
    "longevity.mode_age": ParamSpec(1e-6, 120.0, "dollar", 1.0),
    "longevity.dispersion_years": ParamSpec(1.0, 30.0, "dollar", 1.0),
    "longevity.max_age": ParamSpec(1e-6, 130.0, "dollar", 1.0),
}


def get_field(dump: dict, name: str):
    """Read a (possibly dotted) config field from a model_dump dict; None
    when the field or any parent is unset."""
    obj = dump
    for part in name.split("."):
        if not isinstance(obj, dict) or part not in obj:
            return None
        obj = obj[part]
    return obj


def with_field(dump: dict, name: str, value) -> dict:
    """A copy of ``dump`` with a (possibly dotted) field replaced."""
    head, _, rest = name.partition(".")
    if not rest:
        return {**dump, head: value}
    sub = dump.get(head)
    if not isinstance(sub, dict):
        raise ValueError(
            f"Cannot set '{name}': parent '{head}' is unset on the base "
            "config."
        )
    return {**dump, head: with_field(sub, rest, value)}

# The decision-relevant default set (the dashboard's tornado view).
DEFAULT_PARAMS: List[str] = [
    "monthly_expenses",
    "monthly_contribution",
    "initial_balance",
    "allocation_inv1_pct",
    "inv1_returns_mean",
    "inv1_returns_volatility",
    "inflation_rate_mean",
    "equity_inflation_correlation",
]


class SensitivityRow(NamedTuple):
    """One parameter's finite-difference sensitivities."""

    param: str
    base_value: float
    step_plus: float  # 0.0 when the upper bound pinned a one-sided probe
    step_minus: float
    success_base: float  # percent
    success_plus: float
    success_minus: float
    d_success: float  # d success% / d param (per unit)
    d_median_final: float
    d_mean_final: float
    d_p5_final: float  # downside: d (5th-pct final balance) / d param
    success_per_step: float  # success% change over one practical step
    practical_step: float  # 1% of value (dollar) / the abs step (rate)
    success_sigma: float  # per-row binomial MC sigma (CRN bound is tighter)


def _steps(value: float, spec: ParamSpec, rel_step: float, abs_step: float):
    """(h_plus, h_minus) clamped into the field's bounds; either may be 0
    (one-sided probe at a boundary)."""
    if spec.kind == "dollar":
        h = rel_step * max(abs(value), spec.scale)
    else:
        h = abs_step
    h_plus = min(h, spec.hi - value)
    h_minus = min(h, value - spec.lo)
    return max(h_plus, 0.0), max(h_minus, 0.0)


def _practical_step(value: float, spec: ParamSpec, abs_step: float) -> float:
    if spec.kind == "dollar":
        return 0.01 * max(abs(value), spec.scale)
    return abs_step


_quiet_lock = threading.Lock()
_quiet_depth = 0
_quiet_prev = logging.NOTSET


@contextmanager
def _quiet_config_warnings():
    """Suppress the config soft-warning validators while building probe
    variants: the BASE config already surfaced them once; repeating them for
    every theta +/- h copy is pure noise. Reference-counted under a lock so
    overlapping server requests restore the original level exactly once
    (naive save/restore could pin the logger at ERROR forever)."""
    global _quiet_depth, _quiet_prev
    cfg_log = logging.getLogger("mcrt.config")
    with _quiet_lock:
        if _quiet_depth == 0:
            _quiet_prev = cfg_log.level
            cfg_log.setLevel(logging.ERROR)
        _quiet_depth += 1
    try:
        yield
    finally:
        with _quiet_lock:
            _quiet_depth -= 1
            if _quiet_depth == 0:
                cfg_log.setLevel(_quiet_prev)


def validate_params(params: Optional[Sequence[str]]) -> List[str]:
    names = list(params) if params else list(DEFAULT_PARAMS)
    unknown = [p for p in names if p not in SENSITIVITY_PARAMS]
    if unknown:
        raise ValueError(
            f"Unknown sensitivity parameters {unknown}; supported: "
            f"{sorted(SENSITIVITY_PARAMS)}"
        )
    if len(set(names)) != len(names):
        raise ValueError("Duplicate sensitivity parameters in request.")
    return names


def sensitivity_fd(
    config: Config,
    working_months: int,
    num_paths: Optional[int] = None,
    seed: int = 0,
    params: Optional[Sequence[str]] = None,
    rel_step: float = 0.02,
    abs_step: float = 0.005,
    device="cuda",
    mesh=None,
    progress_callback=None,
    backend: Optional[str] = None,
) -> List[SensitivityRow]:
    """Central finite differences over a CRN scenario grid on ``device``
    (over ``mesh``'s shards when given, on ``backend``, as
    ``run_scenario_grid`` takes them).

    One grid request of ``1 + 2K`` rows (base + theta +/- h per parameter;
    boundary-pinned parameters probe one-sided). Derivatives use the actual
    realized steps: ``(f(v + h+) - f(v - h-)) / (h+ + h-)``.
    """
    names = validate_params(params)
    base_dump = config.model_dump()
    base_dump.pop("allocation_inv2_pct", None)  # derived property
    n = int(num_paths or config.num_simulations_main)

    variants: List[Config] = [config]
    slots: List[tuple] = []  # (name, plus_idx|-1, minus_idx|-1, h+, h-)
    with _quiet_config_warnings():
        for name in names:
            spec = SENSITIVITY_PARAMS[name]
            raw = get_field(base_dump, name)
            if raw is None:
                raise ValueError(
                    f"Parameter '{name}' is unset (null) in the base config; "
                    "set a base value to probe it (turning an optional "
                    "feature on changes the compiled structure)."
                )
            v = float(raw)
            h_plus, h_minus = _steps(v, spec, rel_step, abs_step)

            def _variant(val):
                # Cross-field constraints (e.g. guardrail lower < upper) can
                # reject a probe the per-field bounds allow; degrade that
                # side to a one-sided probe instead of failing the request.
                # Only validation failures degrade — anything else (a
                # renamed field, a type bug) must surface, not silently
                # halve the derivative's accuracy.
                from pydantic import ValidationError

                try:
                    return Config(**with_field(base_dump, name, val))
                except ValidationError:
                    return None

            plus_cfg = _variant(v + h_plus) if h_plus > 0.0 else None
            minus_cfg = _variant(v - h_minus) if h_minus > 0.0 else None
            if plus_cfg is None:
                h_plus = 0.0
            if minus_cfg is None:
                h_minus = 0.0
            if h_plus + h_minus <= 0.0:
                raise ValueError(
                    f"Parameter '{name}' has a degenerate bound interval; "
                    "cannot probe it."
                )
            plus_idx = minus_idx = -1
            if plus_cfg is not None:
                plus_idx = len(variants)
                variants.append(plus_cfg)
            if minus_cfg is not None:
                minus_idx = len(variants)
                variants.append(minus_cfg)
            slots.append((name, plus_idx, minus_idx, h_plus, h_minus))

    res: ScenarioBatchResult = run_scenario_grid(
        variants,
        [int(working_months)] * len(variants),
        n,
        seed=seed,
        device=device,
        mesh=mesh,
        progress_callback=progress_callback,
        backend=backend,
    )

    p = np.asarray(res.success_probability, dtype=float)
    med = np.asarray(res.median_final_balance, dtype=float)
    mean = np.asarray(res.mean_final_balance, dtype=float)
    p5 = np.asarray(res.final_balance_percentiles[:, 0], dtype=float)
    sig = np.asarray(res.success_sigma, dtype=float)

    rows: List[SensitivityRow] = []
    for name, plus_idx, minus_idx, h_plus, h_minus in slots:
        spec = SENSITIVITY_PARAMS[name]
        v = float(get_field(base_dump, name))
        ip = plus_idx if plus_idx >= 0 else 0  # boundary: base IS the probe
        im = minus_idx if minus_idx >= 0 else 0
        h = h_plus + h_minus
        d_succ = (p[ip] - p[im]) / h
        d_med = (med[ip] - med[im]) / h
        d_mean = (mean[ip] - mean[im]) / h
        d_p5 = (p5[ip] - p5[im]) / h
        step = _practical_step(v, spec, abs_step)
        rows.append(
            SensitivityRow(
                param=name,
                base_value=v,
                step_plus=h_plus,
                step_minus=h_minus,
                success_base=float(p[0]),
                success_plus=float(p[ip]),
                success_minus=float(p[im]),
                d_success=float(d_succ),
                d_median_final=float(d_med),
                d_mean_final=float(d_mean),
                d_p5_final=float(d_p5),
                success_per_step=float(d_succ * step),
                practical_step=float(step),
                success_sigma=float(sig[0]),
            )
        )
    return rows


# ----------------------------------------------------------------------
# Forward-mode AD through the month loop
# ----------------------------------------------------------------------

def _log_params_ad(mean, vol):
    """Differentiable arithmetic->lognormal conversion (models/retirement.py
    arithmetic_to_log_params in torch, with a gradient-stable sqrt at vol=0:
    sigma = (vol/gross) * sqrt(log1p(r)/r), and log1p(r)/r -> 1 as r -> 0)."""
    gross = 1.0 + mean
    r = (vol / gross) ** 2
    ratio = torch.where(r < 1e-12, 1.0 - 0.5 * r,
                        torch.log1p(r) / torch.clamp(r, min=1e-30))
    sigma = (vol / gross) * torch.sqrt(ratio)
    mu = torch.log(gross) - 0.5 * sigma * sigma
    return mu, sigma


# theta entries that flow through the lognormal conversion, as
# (mean_name, vol_name) -> (mu_leaf, sigma_leaf)
_AD_LOGNORMAL = {
    ("inv1_returns_mean", "inv1_returns_volatility"): ("mu1", "sigma1"),
    ("inflation_rate_mean", "inflation_rate_volatility"): ("mu_inf", "sigma_inf"),
    (
        "inv2_premium_over_inflation_mean",
        "inv2_premium_over_inflation_volatility",
    ): ("mu_prem", "sigma_prem"),
}

# Expense-ratio fields fold into the drift of their lognormal group
# (SimParams.from_config: mu += log1p(-ratio)); the inflation group has none.
_AD_FEES = {
    ("inv1_returns_mean", "inv1_returns_volatility"):
        "inv1_expense_ratio_annual",
    (
        "inv2_premium_over_inflation_mean",
        "inv2_premium_over_inflation_volatility",
    ): "inv2_expense_ratio_annual",
}

# Direct scalar mappings config-field -> SimParams leaf.
_AD_DIRECT = {
    "initial_balance": "initial_balance",
    "monthly_contribution": "monthly_contribution",
    "contribution_growth_rate_annual": "contribution_growth",
    "monthly_expenses": "monthly_expenses",
    "allocation_inv1_pct": "alloc1",
    "allocation_inv1_final_pct": "alloc1_final",
    "equity_inflation_correlation": "rho",
    "inv1_annual_tax_on_gains_rate": "ann_tax1",
    "inv2_annual_tax_on_gains_rate": "ann_tax2",
    "inv1_realized_gains_tax_rate": "real_tax1",
    "inv2_realized_gains_tax_rate": "real_tax2",
}


def _params_from_theta(config: Config, names: Sequence[str], theta,
                       device="cpu"):
    """Differentiable SimParams (float64 leaves on ``device``) as a function
    of the theta vector (float64, one entry per name)."""
    base = SimParams.from_config(config, dtype=torch.float64, device=device)
    dump = config.model_dump()
    # Optional fields (e.g. the glide endpoint) may be None on the base,
    # and dotted paths are FD-only (refused by sensitivity_ad); the
    # lognormal recombination below never reads either, so both are simply
    # omitted here.
    values = {
        n: float(get_field(dump, n))
        for n in SENSITIVITY_PARAMS
        if "." not in n and get_field(dump, n) is not None
    }
    for i, n in enumerate(names):
        values[n] = theta[i]

    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.tensor(v, dtype=torch.float64, device=device)

    updates = {}
    for n in names:
        if n in _AD_DIRECT:
            updates[_AD_DIRECT[n]] = leaf(values[n])
    # Without a configured glide, alloc1_final mirrors alloc1 and the
    # RETIREMENT phase reads alloc1_final — so the theta perturbation must
    # move BOTH leaves or the decumulation phase is insensitive to the
    # allocation. With a glide set, alloc1_final is its own parameter and
    # stays at its configured value.
    if (
        "allocation_inv1_pct" in names
        and getattr(config, "allocation_inv1_final_pct", None) is None
    ):
        updates["alloc1_final"] = updates["alloc1"]
    for (mean_n, vol_n), (mu_leaf, sigma_leaf) in _AD_LOGNORMAL.items():
        fee_n = _AD_FEES.get((mean_n, vol_n))
        if (
            mean_n in names or vol_n in names
            or (fee_n is not None and fee_n in names)
        ):
            mu, sigma = _log_params_ad(leaf(values[mean_n]), leaf(values[vol_n]))
            if fee_n is not None:
                # Fold the expense-ratio drag as from_config does, at the
                # theta value (differentiable when the fee IS theta).
                mu = mu + torch.log1p(-leaf(values.get(fee_n, 0.0)))
            updates[mu_leaf] = mu
            updates[sigma_leaf] = sigma
    return dataclasses.replace(base, **updates)


def _scan_statics_ad(config: Config, names: Sequence[str], device):
    """The scan's loop structure for AD, fixed outside the transform from
    the base parameters: the leaves theta moves carry tangents there and
    cannot be read as flags. JAX's scan takes the annual bill and the
    glide as data, so they stay on wherever theta can move them: a
    differentiated annual rate on a mark-to-market asset bills at a zero
    base rate too, and the glide target moves with the allocation (with
    ``alloc1_final`` mirroring ``alloc1`` it is an exact no-op)."""
    base = SimParams.from_config(config, device=device)
    st = kernel.scan_statics(
        base, antithetic=bool(config.antithetic),
        jumps=config.market_crashes is not None,
        mortality=config.longevity is not None)
    return st._replace(
        bill1=st.bill1 or (not st.use_real1
                           and "inv1_annual_tax_on_gains_rate" in names),
        bill2=st.bill2 or (not st.use_real2
                           and "inv2_annual_tax_on_gains_rate" in names),
        glide=st.glide or "allocation_inv1_pct" in names,
    )


def ad_inputs(config: Config, working_months: int, names: Sequence[str],
              seed: int, device, backend: str, dtype):
    """What ``sensitivity_ad`` hands the JVP: the row's parameter block
    (``Packed``), the block's tangents along each theta entry (K, F.NUM +
    5*S, in the block's dtype) from ``torch.func.jacfwd`` of theta -> block
    on ``device``, the
    loop's ``Statics`` and the draws (``stream_key``/``t_scan`` on the
    scan, none on the grid kernel's Philox stream)."""
    w = int(working_months)
    R = int(config.retirement_years)
    if backend == "scan":
        statics = _scan_statics_ad(config, names, device)
        draws = dict(stream_key=stream_keys(seed)[1],
                     t_scan=w + MONTHS_PER_YEAR * R)

        def pack(p):
            return kernel.scan_block(p, [w], R, dtype, device=device,
                                     statics=statics)[0]
    else:
        statics = statics_from_config(config)
        draws = {}
        stream_seed = _grid_stream_seed(seed)

        def pack(p):
            return pack_params(p, stream_seed, [w], R, dtype=dtype,
                               device=device)

    dump = config.model_dump()
    theta0 = torch.tensor([float(dump[n]) for n in names],
                          dtype=torch.float64, device=device)

    def block(theta):
        return pack(_params_from_theta(config, names, theta, device=device)).fp

    fp_dot = torch.func.jacfwd(block)(theta0).reshape(-1, len(names))
    packed = pack(_params_from_theta(config, names, theta0, device=device))
    return packed, fp_dot.t().to(packed.fp.dtype).contiguous(), statics, draws


def sensitivity_ad(
    config: Config,
    working_months: int,
    num_paths: int = 32_768,
    seed: int = 0,
    params: Optional[Sequence[str]] = None,
    device="cuda",
    backend: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, float]:
    """d mean-final-balance / d theta by forward-mode AD through the month
    loop on ``device``, every parameter in one pass, in ``dtype`` (default
    float32 on the card, float64 on the CPU): the JVP kernel on the card
    (``cuda_kernel.simulate_jvp``; it raises rather than run anything
    else), its plain version (``torch.func.jvp`` of the plain loop) on the
    CPU, along the parameter block's tangents (:func:`ad_inputs`). Equal to
    ``torch.func.jacfwd`` of the mean through the plain loop. Returns
    ``{"mean_final_balance": value, "d_mean_final": {name: grad}}``.

    ``backend`` (default ``MCRT_GRID_BACKEND``, else "auto", as
    :func:`sensitivity_fd` reads it, so the two share their draws):
    "auto", "pallas" and "pallas_sharded" differentiate the month loop on
    the grid kernel's Philox stream; "scan" is JAX's ``sensitivity_ad``:
    ``simulate_paths`` on ``stream_keys(seed)[1]`` over ``W + 12 R``
    months, equal to JAX's on the same seed to round-off.

    Forward mode: one tangent per parameter, no reverse-pass residuals
    through the month loop. Ruin clamps and capacity switches make the
    metric piecewise smooth; AD returns the a.e. derivative (equal to the
    CRN finite difference up to the O(h) mass of switching paths).
    """
    names = validate_params(params)
    dotted = [n for n in names if "." in n]
    if dotted:
        raise ValueError(
            f"Parameters {dotted} are FD-only (they enter the kernel "
            "through comparisons/clamps); drop include_ad or the dotted "
            "parameters."
        )
    dump = config.model_dump()
    unset = [n for n in names if dump[n] is None]
    if unset:
        raise ValueError(
            f"Parameters {unset} are unset (null) in the base config; set "
            "base values to differentiate through them."
        )
    if backend is None:
        backend = os.environ.get("MCRT_GRID_BACKEND", "auto")
    if backend not in ("auto", "scan", "pallas", "pallas_sharded"):
        raise ValueError(f"unknown grid backend {backend!r}")
    require_device(device)
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    packed, fp_dot, statics, draws = ad_inputs(config, working_months, names,
                                               seed, device, backend, dtype)
    out = simulate_jvp(packed, fp_dot, statics, int(config.retirement_years),
                       int(num_paths), **draws)
    value = out.final_balance.to(torch.float64).mean()
    grads = out.tangents.to(torch.float64).mean(dim=1).cpu().numpy()
    return {
        "mean_final_balance": float(value),
        "d_mean_final": {name: float(g) for name, g in zip(names, grads)},
    }
