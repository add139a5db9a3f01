"""Sensitivity-analysis serving on the port: request models, validation,
assembly.

A copy of the JAX package's ``hosts/sensitivity.py`` with the port's
imports and a ``device`` argument. The request schema and the response are
the same; ``include_ad=True`` adds the AD cross-check
(``engine/sensitivity.sensitivity_ad``: ``torch.func.jacfwd`` through the
plain month loop on the same device).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field

from ..config import Config
from ..engine.sensitivity import (
    DEFAULT_PARAMS,
    sensitivity_ad,
    sensitivity_fd,
    validate_params,
)


class SensitivityRequest(BaseModel):
    config: Dict[str, Any] = Field(
        ..., description="Base scenario as a JSON object (the on-disk scenario-file shape; see docs/CONFIG.md)."
    )
    working_months: int = Field(..., ge=0)
    params: Optional[List[str]] = Field(
        None,
        description=(
            "Config fields to probe (default: the decision-relevant set "
            f"{DEFAULT_PARAMS})."
        ),
    )
    num_paths: Optional[int] = Field(
        None, ge=1,
        description="Paths per probe (default: config.num_simulations_main).",
    )
    rel_step: float = Field(
        0.02, gt=0.0, le=0.5,
        description="Relative step for dollar-scale parameters.",
    )
    abs_step: float = Field(
        0.005, gt=0.0, le=0.5,
        description="Absolute step for rate-scale parameters.",
    )
    include_ad: bool = Field(
        False,
        description=(
            "Also differentiate mean final balance through the month loop "
            "(torch.func.jacfwd) as an independent cross-check of the FD "
            "slopes."
        ),
    )
    ad_num_paths: int = Field(32_768, ge=1, le=1_048_576)


class SensitivityRowModel(BaseModel):
    param: str
    base_value: float
    step_plus: float
    step_minus: float
    success_base: float
    success_plus: float
    success_minus: float
    d_success: float  # d success% per unit of the parameter
    d_median_final: float
    d_mean_final: float
    d_p5_final: float  # downside: d (5th-pct final balance) per unit
    success_per_step: float  # success% change over one practical step
    practical_step: float
    success_sigma: float
    ad_d_mean_final: Optional[float] = None


class SensitivityResponse(BaseModel):
    scenario: str
    working_months: int
    num_paths: int
    rows: List[SensitivityRowModel]  # tornado order: |success_per_step| desc
    mean_final_balance_ad: Optional[float] = None


def prepare_sensitivity(request: SensitivityRequest):
    """Materialize (config, params, num_paths); raises ValueError -> 422."""
    try:
        config = Config(**request.config)
    except Exception as exc:
        raise ValueError(f"base config is invalid: {exc}") from exc
    names = validate_params(request.params)
    num_paths = int(request.num_paths or config.num_simulations_main)
    return config, names, num_paths


def _sig(x: float, digits: int = 6) -> float:
    """Round to significant digits; keeps tiny derivatives readable without
    flattening them to 0.0 (fixed-decimal rounding would)."""
    if x == 0.0 or not math.isfinite(x):
        return x
    scale = digits - 1 - math.floor(math.log10(abs(x)))
    return round(x, scale)


def run_sensitivity_request(
    request: SensitivityRequest, prepared=None, progress_callback=None,
    device="cuda",
) -> dict:
    """Dispatch the CRN grid (and optionally the AD pass) on ``device`` and
    assemble the response dict (worker-thread safe). ``progress_callback``
    receives the grid's per-launch ``grid_chunk`` events (the 1+2K probe
    rows run as chunked launches) and a ``phase`` event before the AD
    pass."""
    config, names, num_paths = prepared or prepare_sensitivity(request)
    seed = int(config.seed) if config.seed is not None else 0
    rows = sensitivity_fd(
        config,
        request.working_months,
        num_paths=num_paths,
        seed=seed,
        params=names,
        rel_step=request.rel_step,
        abs_step=request.abs_step,
        device=device,
        progress_callback=progress_callback,
    )
    ad = None
    if request.include_ad:
        if progress_callback is not None:
            progress_callback({
                "type": "phase",
                "phase": "sensitivity_ad",
                "message": "Differentiating mean final balance through the "
                "month loop (torch.func.jacfwd cross-check)…",
            })
        ad = sensitivity_ad(
            config,
            request.working_months,
            num_paths=request.ad_num_paths,
            seed=seed,
            params=names,
            device=device,
        )
    out_rows = []
    for r in rows:
        row = {
            "param": r.param,
            "base_value": _sig(r.base_value, 9),
            "step_plus": _sig(r.step_plus),
            "step_minus": _sig(r.step_minus),
            "success_base": round(r.success_base, 3),
            "success_plus": round(r.success_plus, 3),
            "success_minus": round(r.success_minus, 3),
            "d_success": _sig(r.d_success),
            "d_median_final": _sig(r.d_median_final),
            "d_mean_final": _sig(r.d_mean_final),
            "d_p5_final": _sig(r.d_p5_final),
            "success_per_step": _sig(r.success_per_step),
            "practical_step": _sig(r.practical_step),
            "success_sigma": _sig(r.success_sigma, 3),
        }
        if ad is not None:
            row["ad_d_mean_final"] = _sig(ad["d_mean_final"][r.param])
        out_rows.append(row)
    out_rows.sort(key=lambda r: -abs(r["success_per_step"]))
    result = {
        "scenario": config.Nickname,
        "working_months": int(request.working_months),
        "num_paths": num_paths,
        "rows": out_rows,
    }
    if ad is not None:
        result["mean_final_balance_ad"] = round(ad["mean_final_balance"], 2)
    return result
