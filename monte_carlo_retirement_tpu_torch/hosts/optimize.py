"""Optimizer serving on the port: request models, validation, assembly.

A copy of the JAX package's ``hosts/optimize.py`` with the port's imports
and a ``device`` argument on the functions that run the refinement.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from pydantic import BaseModel, Field

from ..config import Config
from ..engine.optimize import (
    MAX_JOINT_ROWS,
    OBJECTIVES,
    default_points,
    optimize_param,
    optimize_params,
)
from ..engine.sensitivity import SENSITIVITY_PARAMS, get_field


class OptimizeParamSpec(BaseModel):
    """One axis of a joint optimization: a config field plus an optional
    search interval (either side defaults to the field's hard bound)."""

    name: str = Field(
        ..., description="Config field to optimize over "
        f"(supported: {sorted(SENSITIVITY_PARAMS)}).",
    )
    lo: Optional[float] = None
    hi: Optional[float] = None


class OptimizeRequest(BaseModel):
    config: Dict[str, Any] = Field(
        ..., description="Base scenario as a JSON object (the on-disk scenario-file shape; see docs/CONFIG.md)."
    )
    working_months: int = Field(..., ge=0)
    param: Optional[str] = Field(
        None, description="Config field to optimize over "
        f"(supported: {sorted(SENSITIVITY_PARAMS)}). The single-field "
        "form; mutually exclusive with `params`.",
    )
    params: Optional[List[OptimizeParamSpec]] = Field(
        None, min_length=1, max_length=2,
        description="Joint form: one or two fields optimized together "
        "over a product grid (one CRN dispatch per round). Responses use "
        "the joint shape (`params`/`best.values`/`surface`).",
    )
    objective: str = Field(
        "success_probability",
        description=f"Metric to maximize (supported: {sorted(OBJECTIVES)}).",
    )
    lo: Optional[float] = Field(
        None, description="Search interval lower bound, single-field form "
        "(default: the field's hard bound).",
    )
    hi: Optional[float] = Field(
        None, description="Search interval upper bound, single-field form "
        "(required when the field has no hard upper bound).",
    )
    num_paths: Optional[int] = Field(
        None, ge=1,
        description="Paths per point (default: config.num_simulations_main).",
    )
    points: Optional[int] = Field(
        None, ge=3, le=257,
        description="Grid points per axis per refinement round (default "
        "17 single-field, 13 per axis jointly; joint grids are capped at "
        f"{MAX_JOINT_ROWS} rows per round).")
    rounds: int = Field(3, ge=1, le=8,
                        description="Refinement rounds (each one dispatch).")


class OptimizePointModel(BaseModel):
    value: float
    success_probability: float
    median_final_balance: float
    mean_final_balance: float
    objective_value: float  # the requested objective at this point


class OptimizeResponse(BaseModel):
    scenario: str
    working_months: int
    num_paths: int
    param: str
    objective: str
    base_value: float
    best: OptimizePointModel
    interval: List[float]  # final refined bracket [lo, hi] around best
    curve: List[OptimizePointModel]  # round-1 coarse sweep
    rounds: int
    evaluations: int
    success_sigma: float


class JointPointModel(BaseModel):
    values: List[float]  # aligned with `params`
    success_probability: float
    median_final_balance: float
    mean_final_balance: float
    objective_value: float  # the requested objective at this point


class OptimizeJointResponse(BaseModel):
    scenario: str
    working_months: int
    num_paths: int
    params: List[str]
    objective: str
    base_values: List[float]  # the base config's values, aligned w/ params
    best: JointPointModel
    intervals: List[List[float]]  # refined bracket per param
    surface: List[JointPointModel]  # round-1 product grid, C-order
    points_per_axis: int
    rounds: int
    evaluations: int
    success_sigma: float


def response_model(request: OptimizeRequest):
    """The response schema this request's result validates against."""
    return OptimizeJointResponse if request.params is not None \
        else OptimizeResponse


def request_target(request: OptimizeRequest) -> str:
    """Human-readable optimization target for log lines."""
    if request.params is not None:
        return " x ".join(p.name for p in request.params)
    return str(request.param)


def prepare_optimize(request: OptimizeRequest):
    """Materialize (config, num_paths); raises ValueError -> 422.

    Interval/param/objective validation happens in the engine — those
    errors are also request errors, so the runner re-raises them for the
    handler's 422 path via prepare-time probing of the static arguments.
    """
    try:
        config = Config(**request.config)
    except Exception as exc:
        raise ValueError(f"base config is invalid: {exc}") from exc
    if (request.param is None) == (request.params is None):
        raise ValueError(
            "exactly one of `param` (single field) or `params` (joint "
            "list) must be provided"
        )
    names = ([p.name for p in request.params]
             if request.params is not None else [request.param])
    if len(set(names)) != len(names):
        raise ValueError(f"Duplicate parameters in {names}")
    for name in names:
        if name not in SENSITIVITY_PARAMS:
            raise ValueError(
                f"Unknown parameter '{name}'; supported: "
                f"{sorted(SENSITIVITY_PARAMS)}"
            )
    if request.objective not in OBJECTIVES:
        raise ValueError(
            f"Unknown objective '{request.objective}'; supported: "
            f"{sorted(OBJECTIVES)}"
        )
    from ..engine.optimize import _bounds_for

    if request.params is not None:
        if request.lo is not None or request.hi is not None:
            raise ValueError(
                "`lo`/`hi` belong to the single-field form; put bounds on "
                "the `params` entries instead"
            )
        for p in request.params:
            _bounds_for(p.name, p.lo, p.hi)  # raises ValueError
        points = (request.points if request.points is not None
                  else default_points(len(names)))
        if len(names) > 1 and points ** len(names) > MAX_JOINT_ROWS:
            raise ValueError(
                f"points={points} over {len(names)} parameters is "
                f"{points ** len(names)} rows per round; at most "
                f"{MAX_JOINT_ROWS} fit one dispatch (points <= "
                f"{int(MAX_JOINT_ROWS ** (1 / len(names)))})"
            )
    else:
        _bounds_for(request.param, request.lo, request.hi)
    num_paths = int(request.num_paths or config.num_simulations_main)
    return config, num_paths


def run_optimize_request(
    request: OptimizeRequest,
    prepared=None,
    progress_callback: Optional[Callable[[dict], None]] = None,
    device="cuda",
) -> dict:
    """Run the refinement on ``device`` and assemble the response dict
    (worker-thread safe)."""
    config, num_paths = prepared or prepare_optimize(request)
    seed = int(config.seed) if config.seed is not None else 0
    if request.params is not None:
        return _run_joint(request, config, num_paths, seed,
                          progress_callback, device)
    result = optimize_param(
        config,
        request.working_months,
        request.param,
        num_paths=num_paths,
        seed=seed,
        objective=request.objective,
        lo=request.lo,
        hi=request.hi,
        points=(request.points if request.points is not None
                else default_points(1)),
        rounds=request.rounds,
        device=device,
        progress_callback=progress_callback,
    )

    def point(p) -> dict:
        return {
            "value": round(p.value, 10),
            "success_probability": round(p.success_probability, 3),
            "median_final_balance": round(p.median_final_balance, 2),
            "mean_final_balance": round(p.mean_final_balance, 2),
            "objective_value": round(p.objective_value, 4),
        }

    return {
        "scenario": config.Nickname,
        "working_months": int(request.working_months),
        "num_paths": num_paths,
        "param": result.param,
        "objective": result.objective,
        # get_field: dotted guardrail paths read through the nested object.
        "base_value": float(get_field(config.model_dump(), result.param)),
        "best": point(result.best),
        "interval": [round(result.interval[0], 10),
                     round(result.interval[1], 10)],
        "curve": [point(p) for p in result.curve],
        "rounds": result.rounds,
        "evaluations": result.evaluations,
        "success_sigma": round(result.success_sigma, 3),
    }


def _run_joint(
    request: OptimizeRequest,
    config: Config,
    num_paths: int,
    seed: int,
    progress_callback: Optional[Callable[[dict], None]],
    device,
) -> dict:
    result = optimize_params(
        config,
        request.working_months,
        [p.name for p in request.params],
        num_paths=num_paths,
        seed=seed,
        objective=request.objective,
        bounds=[(p.lo, p.hi) for p in request.params],
        points=request.points,
        rounds=request.rounds,
        device=device,
        progress_callback=progress_callback,
    )

    def point(p) -> dict:
        return {
            "values": [round(v, 10) for v in p.values],
            "success_probability": round(p.success_probability, 3),
            "median_final_balance": round(p.median_final_balance, 2),
            "mean_final_balance": round(p.mean_final_balance, 2),
            "objective_value": round(p.objective_value, 4),
        }

    base_dump = config.model_dump()
    return {
        "scenario": config.Nickname,
        "working_months": int(request.working_months),
        "num_paths": num_paths,
        "params": list(result.params),
        "objective": result.objective,
        "base_values": [
            float(get_field(base_dump, p)) for p in result.params
        ],
        "best": point(result.best),
        "intervals": [[round(lo, 10), round(hi, 10)]
                      for lo, hi in result.intervals],
        "surface": [point(p) for p in result.surface],
        "points_per_axis": result.points_per_axis,
        "rounds": result.rounds,
        "evaluations": result.evaluations,
        "success_sigma": round(result.success_sigma, 3),
    }
