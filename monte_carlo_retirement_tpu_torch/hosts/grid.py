"""Scenario-grid serving on the port: request models, validation, assembly.

A copy of the JAX package's ``hosts/grid.py`` with the port's imports (any
import from the JAX package imports jax) and a ``device`` argument on the
dispatching functions. BASELINE stretch config 5 is its full width: 256
config variants x 1M paths on one card, in chunks with ``grid_chunk``
progress events.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from pydantic import BaseModel, Field

from ..config import Config
from ..engine.scenario_batch import (
    GRID_FINAL_PERCENTILES,
    ScenarioBatchResult,
    run_scenario_grid,
)

# Hard cap on variants per request: bounds request memory and keeps a typo
# from dispatching an hour of device work. 4096 = 16x the stretch target.
MAX_GRID_VARIANTS = 4096


class GridVariant(BaseModel):
    """One grid cell: the base config with ``overrides`` applied on top."""

    name: Optional[str] = None
    overrides: Dict[str, Any] = Field(default_factory=dict)


class GridRequest(BaseModel):
    config: Dict[str, Any] = Field(
        ..., description="Base scenario as a JSON object (the on-disk scenario-file shape; see docs/CONFIG.md)."
    )
    variants: List[GridVariant] = Field(..., min_length=1)
    working_months: Union[int, List[int]] = Field(
        ...,
        description=(
            "Working months for every variant, or one value per variant."
        ),
    )
    num_paths: Optional[int] = Field(
        None, ge=1,
        description="Paths per variant (default: config.num_simulations_main).",
    )
    chunk_size: Optional[int] = Field(
        None, ge=1, le=256,
        description="Variants per device dispatch (default MCRT_GRID_CHUNK).",
    )


class GridScenarioRow(BaseModel):
    name: str
    working_months: int
    success_probability: float
    success_sigma: float
    median_final_balance: float
    mean_final_balance: float
    final_balance_percentiles: Dict[str, float]


class GridResponse(BaseModel):
    scenario: str
    num_paths: int
    total_scenarios: int
    rows: List[GridScenarioRow]


def variant_name(variant: GridVariant, index: int) -> str:
    if variant.name:
        return str(variant.name)
    if variant.overrides:
        parts = [f"{k}={v}" for k, v in list(variant.overrides.items())[:3]]
        return ", ".join(parts)
    return f"variant {index}"


def prepare_grid(request: GridRequest):
    """Materialize (configs, months, names, num_paths) from a grid request.

    Raises ValueError (422 at the endpoint) on malformed variants; the
    structural-statics check happens inside run_scenario_grid via
    grid_statics and surfaces as a 400 (a valid request this engine cannot
    batch together)."""
    if len(request.variants) > MAX_GRID_VARIANTS:
        raise ValueError(
            f"grid request carries {len(request.variants)} variants; the "
            f"cap is {MAX_GRID_VARIANTS}"
        )
    base = dict(request.config)
    configs: List[Config] = []
    names: List[str] = []
    for i, variant in enumerate(request.variants):
        merged = {**base, **variant.overrides}
        try:
            configs.append(Config(**merged))
        except Exception as exc:
            raise ValueError(
                f"variant {i} ({variant_name(variant, i)!r}) is invalid: {exc}"
            ) from exc
        names.append(variant_name(variant, i))

    if isinstance(request.working_months, int):
        months = [request.working_months] * len(configs)
    else:
        months = [int(m) for m in request.working_months]
        if len(months) != len(configs):
            raise ValueError(
                f"working_months supplies {len(months)} values for "
                f"{len(configs)} variants"
            )
    if any(m < 0 for m in months):
        raise ValueError("working_months must be >= 0")

    num_paths = request.num_paths or configs[0].num_simulations_main
    return configs, months, names, int(num_paths)


def build_grid_result(
    base_config: Config,
    names: List[str],
    months: List[int],
    num_paths: int,
    res: ScenarioBatchResult,
) -> dict:
    rows = []
    for i, name in enumerate(names):
        rows.append(
            {
                "name": name,
                "working_months": months[i],
                "success_probability": round(
                    float(res.success_probability[i]), 2
                ),
                "success_sigma": round(float(res.success_sigma[i]), 3),
                "median_final_balance": round(
                    float(res.median_final_balance[i]), 2
                ),
                "mean_final_balance": round(
                    float(res.mean_final_balance[i]), 2
                ),
                "final_balance_percentiles": {
                    f"p{int(q * 100)}": round(
                        max(0.0, float(res.final_balance_percentiles[i, j])),
                        2,
                    )
                    for j, q in enumerate(GRID_FINAL_PERCENTILES)
                },
            }
        )
    return {
        "scenario": base_config.Nickname,
        "num_paths": num_paths,
        "total_scenarios": len(names),
        "rows": rows,
    }


def run_prepared_grid(
    prepared, chunk_size=None, progress_callback=None, device="cuda"
) -> dict:
    """Dispatch and assemble an already-validated grid (worker-thread safe)
    on ``device`` ("cuda": the grid kernel; "cpu": its plain version).

    ``prepared`` is the (configs, months, names, num_paths) tuple from
    :func:`prepare_grid` — the endpoint runs that during request parsing so
    malformed variants answer 422, while errors raised here (mixed statics
    the engine cannot batch) surface as 400.
    """
    configs, months, names, num_paths = prepared
    seed = configs[0].seed if configs[0].seed is not None else 0
    res = run_scenario_grid(
        configs,
        months,
        num_paths,
        seed=int(seed),
        chunk_size=chunk_size,
        device=device,
        progress_callback=progress_callback,
    )
    return build_grid_result(configs[0], names, months, num_paths, res)


def run_grid_request(request: GridRequest, progress_callback=None,
                     device="cuda") -> dict:
    """Validate, dispatch and assemble a grid request in one call (library
    convenience; the endpoints split prepare/dispatch for error taxonomy)."""
    return run_prepared_grid(
        prepare_grid(request),
        chunk_size=request.chunk_size,
        progress_callback=progress_callback,
        device=device,
    )
