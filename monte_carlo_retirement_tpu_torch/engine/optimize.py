"""Plan optimization over one or two config fields by batched grid refinement.

A copy of the JAX package's ``engine/optimize.py`` with the port's imports
(numpy only), and ``device``, ``mesh`` and ``backend`` passed on to
``run_scenario_grid``. The
algorithm is NOT a serial line search: each refinement round evaluates the
full product grid over the current interval(s) in ONE scenario-grid
dispatch (engine/scenario_batch.py), takes the argmax cell, and zooms each
axis into the two cells around it. With common random numbers the
objective is a deterministic function of the parameters (draws depend only
on (stream, month, path)), so rounds are exactly comparable, ties break
deterministically, and the refinement cannot chase sampling noise.

Interval shrink per round = 2/(K-1) per axis; K=17 points for 3 rounds
narrows a 1-D search interval by ~512x for 51 scenario rows total — about
three device dispatches, versus ~9 sequential dispatches for
golden-section reaching only ~70x on a latency-bound serial path. The
joint 2-D form (``optimize_params``) runs a K x K grid per round (default
13 x 13 = 169 rows, still one dispatch) and shrinks BOTH axes ~6x per
round — a coordinate-descent loop of 1-D searches would pay a dispatch
per axis per sweep and can stall on diagonal ridges the product grid sees
directly.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from .scenario_batch import ScenarioBatchResult, run_scenario_grid
from .sensitivity import SENSITIVITY_PARAMS, _quiet_config_warnings

__all__ = [
    "OBJECTIVES",
    "OptimizeResult",
    "OptimizePoint",
    "JointOptimizePoint",
    "JointOptimizeResult",
    "optimize_param",
    "optimize_params",
]

# objective name -> extractor over a ScenarioBatchResult. All are
# maximized; decision-grade metrics only (success% ties are broken by
# median final). The percentile objectives optimize the DOWNSIDE of the
# final-balance distribution (p5/p25 over all paths, ruined paths at 0) —
# the risk-averse counterparts to the median/mean.
OBJECTIVES = {
    "success_probability": lambda r: r.success_probability,
    "median_final_balance": lambda r: r.median_final_balance,
    "mean_final_balance": lambda r: r.mean_final_balance,
    "p5_final_balance": lambda r: r.final_balance_percentiles[:, 0],
    "p25_final_balance": lambda r: r.final_balance_percentiles[:, 1],
}


class OptimizePoint(NamedTuple):
    value: float
    success_probability: float
    median_final_balance: float
    mean_final_balance: float
    # The REQUESTED objective's value at this point — equal to one of the
    # fields above for the classic objectives, the percentile readout for
    # the risk-averse ones (which the points don't otherwise carry).
    objective_value: float = float("nan")


class OptimizeResult(NamedTuple):
    param: str
    objective: str
    best: OptimizePoint
    interval: tuple  # final refined (lo, hi) bracket around the best point
    curve: List[OptimizePoint]  # round-1 coarse sweep over [lo, hi]
    rounds: int
    evaluations: int  # total scenario rows dispatched
    success_sigma: float  # per-point binomial MC sigma at the best point


class JointOptimizePoint(NamedTuple):
    values: Tuple[float, ...]  # one per optimized parameter
    success_probability: float
    median_final_balance: float
    mean_final_balance: float
    objective_value: float = float("nan")  # the requested objective here


class JointOptimizeResult(NamedTuple):
    params: Tuple[str, ...]
    objective: str
    best: JointOptimizePoint
    intervals: Tuple[Tuple[float, float], ...]  # refined bracket per param
    surface: List[JointOptimizePoint]  # round-1 product grid, C-order
    points_per_axis: int
    rounds: int
    evaluations: int  # total scenario rows dispatched
    success_sigma: float  # per-point binomial MC sigma at the best point


# Rows per refinement round when optimizing jointly; each round is one
# scenario-grid dispatch whose (k, n)-shaped intermediates must stay inside
# HBM at the 1M-path serving scale (same budget as the serving model's
# 257-point bound on the 1-D form).
MAX_JOINT_ROWS = 257


def default_points(n_params: int) -> int:
    """Default grid points per axis — the ONE place the rule lives (the
    hosts echo it in messages and cap checks)."""
    return 17 if n_params == 1 else 13


def _bounds_for(param: str, lo: Optional[float], hi: Optional[float]):
    spec = SENSITIVITY_PARAMS[param]
    lo = spec.lo if lo is None else float(lo)
    hi = spec.hi if hi is None else float(hi)
    if math.isinf(hi):
        raise ValueError(
            f"Parameter '{param}' has no upper bound; pass an explicit "
            "hi for the search interval."
        )
    if not (spec.lo <= lo < hi <= spec.hi):
        raise ValueError(
            f"Search interval [{lo}, {hi}] must be increasing and inside "
            f"the config bounds [{spec.lo}, {spec.hi}] of '{param}'."
        )
    return lo, hi


def optimize_params(
    config: Config,
    working_months: int,
    params: Sequence[str],
    num_paths: Optional[int] = None,
    seed: int = 0,
    objective: str = "success_probability",
    bounds: Optional[Sequence[Optional[Tuple[Optional[float],
                                             Optional[float]]]]] = None,
    points: Optional[int] = None,
    rounds: int = 3,
    device="cuda",
    mesh=None,
    progress_callback: Optional[Callable[[dict], None]] = None,
    backend: Optional[str] = None,
) -> JointOptimizeResult:
    """Maximize ``objective`` over one or two config fields at fixed months.

    Each round dispatches the ``points``-per-axis product grid over the
    current interval(s) as one CRN scenario grid, then zooms every axis
    into the two grid cells around the argmax. ``bounds`` aligns with
    ``params``: each entry is ``(lo, hi)`` (either side ``None`` for the
    field's hard bound) or ``None`` for both defaults.
    ``progress_callback`` receives the underlying ``grid_chunk`` events
    plus an ``optimize_round`` event per round (with legacy
    ``best_value``/``interval`` keys when one parameter is optimized).
    """
    params = [str(p) for p in params]
    if not 1 <= len(params) <= 2:
        raise ValueError(
            f"optimize_params supports 1 or 2 parameters, got {len(params)}"
        )
    if len(set(params)) != len(params):
        raise ValueError(f"Duplicate parameters in {params}")
    for p in params:
        if p not in SENSITIVITY_PARAMS:
            raise ValueError(
                f"Unknown parameter '{p}'; supported: "
                f"{sorted(SENSITIVITY_PARAMS)}"
            )
    if objective not in OBJECTIVES:
        raise ValueError(
            f"Unknown objective '{objective}'; supported: "
            f"{sorted(OBJECTIVES)}"
        )
    ndim = len(params)
    points = int(points) if points is not None else default_points(ndim)
    rounds = int(rounds)
    if points < 3:
        raise ValueError("points must be >= 3")
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    if ndim > 1 and points ** ndim > MAX_JOINT_ROWS:
        raise ValueError(
            f"points={points} over {ndim} parameters is {points ** ndim} "
            f"rows per round; the one-dispatch HBM budget allows at most "
            f"{MAX_JOINT_ROWS} (points <= "
            f"{int(MAX_JOINT_ROWS ** (1 / ndim))})"
        )
    if bounds is None:
        bounds = [None] * ndim
    bounds = list(bounds)
    if len(bounds) != ndim:
        raise ValueError("bounds must align with params")
    base_dump = config.model_dump()
    base_dump.pop("allocation_inv2_pct", None)  # derived property
    axes: List[np.ndarray] = []
    for p, b in zip(params, bounds):
        lo, hi = (None, None) if b is None else b
        lo, hi = _bounds_for(p, lo, hi)
        # Guardrail bands carry a cross-field constraint (lower < upper):
        # intersect the sweep interval with the sibling band so a default
        # sweep never generates configs pydantic rejects mid-round.
        sib = None
        if p == "spending_guardrails.lower_wr_pct":
            from .sensitivity import get_field

            sib = get_field(base_dump, "spending_guardrails.upper_wr_pct")
            if sib is not None:
                hi = min(hi, float(sib) - 1e-6)
        elif p == "spending_guardrails.upper_wr_pct":
            from .sensitivity import get_field

            sib = get_field(base_dump, "spending_guardrails.lower_wr_pct")
            if sib is not None:
                lo = max(lo, float(sib) + 1e-6)
        # Longevity carries mode_age < max_age the same way.
        elif p == "longevity.mode_age":
            from .sensitivity import get_field

            sib = get_field(base_dump, "longevity.max_age")
            if sib is not None:
                hi = min(hi, float(sib) - 1e-6)
        elif p == "longevity.max_age":
            from .sensitivity import get_field

            sib = get_field(base_dump, "longevity.mode_age")
            if sib is not None:
                lo = max(lo, float(sib) + 1e-6)
        if sib is not None and not lo < hi:
            raise ValueError(
                f"Search interval for '{p}' collapses against the sibling "
                f"band ({sib}); pass explicit bounds on the other side of it."
            )
        axes.append(np.linspace(lo, hi, points))
    n = int(num_paths or config.num_simulations_main)
    extract = OBJECTIVES[objective]

    def evaluate(rows: np.ndarray) -> ScenarioBatchResult:
        from .sensitivity import with_field

        def build(row):
            dump = base_dump
            for d in range(ndim):
                dump = with_field(dump, params[d], float(row[d]))
            return Config(**dump)

        with _quiet_config_warnings():
            variants = [build(row) for row in rows]
        return run_scenario_grid(
            variants,
            [int(working_months)] * len(variants),
            n,
            seed=seed,
            # One dispatch per round (the module's design claim) — the row
            # count is host-bounded (257 in 1-D serving, MAX_JOINT_ROWS
            # jointly), whose (k, n) grid intermediates stay comfortably
            # inside HBM even at 1M paths. Above that path scale the
            # grid's MCRT_GRID_CELL_BUDGET guard splits the round into
            # exact CRN-preserving chunks.
            chunk_size=len(rows),
            device=device,
            mesh=mesh,
            progress_callback=progress_callback,
            backend=backend,
        )

    def point(rows, res, med, obj, i) -> JointOptimizePoint:
        return JointOptimizePoint(
            values=tuple(float(v) for v in rows[i]),
            success_probability=float(res.success_probability[i]),
            median_final_balance=float(med[i]),
            mean_final_balance=float(res.mean_final_balance[i]),
            objective_value=float(obj[i]),
        )

    surface: List[JointOptimizePoint] = []
    evaluations = 0
    # The GLOBAL best across rounds. Zooming re-grids around each round's
    # argmax, and with an even point count the new grid need not re-sample
    # it — so the returned optimum must be tracked across rounds, never
    # read off the final grid alone.
    best_key = None
    best: Optional[JointOptimizePoint] = None
    best_brackets = [
        (float(ax[0]), float(ax[-1])) for ax in axes
    ]
    best_sigma = 0.0
    for r in range(rounds):
        mesh_axes = np.meshgrid(*axes, indexing="ij")
        rows = np.stack([m.ravel() for m in mesh_axes], axis=1)
        res = evaluate(rows)
        evaluations += len(rows)
        obj = np.asarray(extract(res), dtype=float)
        med = np.asarray(res.median_final_balance, dtype=float)
        # Deterministic argmax with a median-final tie-break (success
        # saturates at 100% over whole plateaus; CRN makes ties exact).
        best_idx = int(
            max(range(len(rows)), key=lambda i: (obj[i], med[i]))
        )
        cell = np.unravel_index(best_idx, (points,) * ndim)
        key = (float(obj[best_idx]), float(med[best_idx]))
        if best_key is None or key > best_key:
            best_key = key
            best = point(rows, res, med, obj, best_idx)
            best_brackets = [
                (
                    float(axes[d][max(0, cell[d] - 1)]),
                    float(axes[d][min(points - 1, cell[d] + 1)]),
                )
                for d in range(ndim)
            ]
            best_sigma = float(res.success_sigma[best_idx])
        if r == 0:
            surface = [point(rows, res, med, obj, i)
                       for i in range(len(rows))]
        if progress_callback is not None:
            event = {
                "type": "optimize_round",
                "round": r + 1,
                "rounds": rounds,
                "best_values": list(best.values),
                "best_objective": best_key[0],
                "intervals": [
                    [float(ax[0]), float(ax[-1])] for ax in axes
                ],
            }
            if ndim == 1:  # legacy single-parameter event keys
                event["best_value"] = best.values[0]
                event["interval"] = event["intervals"][0]
            progress_callback(event)
        if r + 1 < rounds:
            axes = [
                np.linspace(
                    float(axes[d][max(0, cell[d] - 1)]),
                    float(axes[d][min(points - 1, cell[d] + 1)]),
                    points,
                )
                for d in range(ndim)
            ]

    assert best is not None
    return JointOptimizeResult(
        params=tuple(params),
        objective=objective,
        best=best,
        intervals=tuple(best_brackets),
        surface=surface,
        points_per_axis=points,
        rounds=rounds,
        evaluations=evaluations,
        success_sigma=best_sigma,
    )


def optimize_param(
    config: Config,
    working_months: int,
    param: str,
    num_paths: Optional[int] = None,
    seed: int = 0,
    objective: str = "success_probability",
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    points: int = 17,
    rounds: int = 3,
    device="cuda",
    mesh=None,
    progress_callback: Optional[Callable[[dict], None]] = None,
    backend: Optional[str] = None,
) -> OptimizeResult:
    """Maximize ``objective`` over one scalar config field at fixed months.

    The single-parameter form of :func:`optimize_params` — identical
    numerics (same grids, same dispatches, same tie-breaks), with the
    original scalar-shaped result.
    """
    joint = optimize_params(
        config,
        working_months,
        [param],
        num_paths=num_paths,
        seed=seed,
        objective=objective,
        bounds=[(lo, hi)],
        points=points,
        rounds=rounds,
        device=device,
        mesh=mesh,
        progress_callback=progress_callback,
        backend=backend,
    )

    def scalar(p: JointOptimizePoint) -> OptimizePoint:
        return OptimizePoint(
            value=p.values[0],
            success_probability=p.success_probability,
            median_final_balance=p.median_final_balance,
            mean_final_balance=p.mean_final_balance,
            objective_value=p.objective_value,
        )

    return OptimizeResult(
        param=param,
        objective=joint.objective,
        best=scalar(joint.best),
        interval=joint.intervals[0],
        curve=[scalar(p) for p in joint.surface],
        rounds=joint.rounds,
        evaluations=joint.evaluations,
        success_sigma=joint.success_sigma,
    )
