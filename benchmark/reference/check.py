"""The numbers that decide ``correct``: served answers against the reference.

Each number is the worst over the answers checked in a run:

- ``search_edge_pts``: how far the reference, on the search stream at the
  search's paths, puts the answer W on the wrong side of the target:
  max(0, target - p(W), p(W - 1) - target) in percentage points (W - 1
  only above the search's start). For a household answered "target not
  met" (400), max(0, p(start + 840) - target).
- ``search_prob_pts``: |the probability the search curve gives at W - the
  reference's p(W)|, beyond the curve's rounding to 0.01.
- ``final_success_pts``: |served success probability - the reference's|,
  beyond the payload's rounding to 0.01.
- ``stats_rank``: the largest share of paths by which a served percentile
  misses its rank in the reference's sorted paths (``stats.Columns``),
  over the three medians, the nine final-balance percentiles, the nominal
  and real trajectory percentiles and the withdrawal-rate percentiles.
- ``bins_moved``: the largest share of paths that changed bin, over the
  successful-final histogram, the ruin-year histogram and the yearly
  withdrawal-rate observation counts (sum of |count gaps| / paths).
- ``grid_success_pts`` and ``grid_stats_rank``: the same for sampled rows
  of a scenario grid (success; median and five percentiles), and
  ``grid_mean_rel``: the mean final balance's relative gap beyond its
  rounding (over at least a dollar).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from . import loop, philox, stats

SEARCH_YEARS = 70


def _arr(values) -> np.ndarray:
    return np.array([np.nan if v is None else float(v) for v in values], dtype=np.float64)


def served_from_payload(body: dict) -> dict:
    """A served /api/simulate payload in the form of ``stats.served``."""
    s = body["summary"]
    pct = lambda block, names: np.stack([_arr(block["percentiles"][k]) for k in names])
    tr = ["p5", "p10", "p25", "p50", "p75", "p90", "p95"]
    wq = ["p5", "p25", "p50", "p75", "p95"]
    fq = ["p1", "p5", "p10", "p25", "p50", "p75", "p90", "p95", "p99"]
    binned = (body.get("histogram") or {}).get("binned")
    return {
        "success_probability": s["success_probability"],
        "median_start_balance": s["median_start_balance"],
        "median_final_balance_successful": s["median_final_balance_successful"],
        "swr": np.nan if s["swr"] is None else s["swr"],
        "final_balance_percentiles": _arr(s["final_balance_percentiles"][k] for k in fq),
        "trajectory": pct(body["trajectory"], tr),
        "trajectory_real": pct(body["trajectory_real"], tr),
        "withdrawal_rate": pct(body["withdrawal_rate"], wq),
        "observation_counts": np.array(body["withdrawal_rate"]["observation_counts"]),
        "hist_counts": np.array(binned["counts"] if binned else [], dtype=np.int64),
        "year_counts": list(body["ruin_histogram"]["year_counts"] or []),
    }


# Each served percentile table, its fractions and the payload's rounding.
RANKED = (
    ("median_start_balance", (0.5,), 0.005),
    ("median_final_balance_successful", (0.5,), 0.005),
    ("swr", (0.5,), 0.005),
    ("final_balance_percentiles", stats.FINAL, 0.005),
    ("trajectory", stats.TRAJECTORY, 0.005),
    ("trajectory_real", stats.TRAJECTORY, 0.005),
    ("withdrawal_rate", stats.WITHDRAWAL, 0.0005),
)


def counts_moved(prog, ref, n: int) -> float:
    a, b = list(prog), list(ref)
    size = max(len(a), len(b))
    a, b = np.pad(a, (0, size - len(a))), np.pad(b, (0, size - len(b)))
    return float(np.abs(a - b).sum() / n)


def compare_served(prog: dict, ref: dict, n: int) -> Dict[str, float]:
    """The final run's numbers of one answer: ``prog`` the served values,
    ``ref`` the reference's ``stats.served``."""
    rank = 0.0
    for key, qs, rounding in RANKED:
        cols = ref["columns"][key]
        value = np.asarray(prog[key], dtype=np.float64)
        if key == "median_final_balance_successful" and cols.count[0] == 0:
            # The payload serves 0.0 where no path succeeded.
            rank = max(rank, 0.0 if value == 0.0 else math.inf)
            continue
        rank = max(rank, cols.rank_gap(value.T if value.ndim == 2 else value, qs, rounding))
    return {
        "final_success_pts": max(abs(prog["success_probability"]
                                     - ref["success_probability"]) - 0.005, 0.0),
        "stats_rank": rank,
        "bins_moved": max(counts_moved(prog["hist_counts"], ref["hist_counts"], n),
                          counts_moved(prog["year_counts"], ref["year_counts"], n),
                          counts_moved(prog["observation_counts"],
                                       ref["observation_counts"], n)),
    }


def final_reference(cfg: dict, months: int, dtype, device) -> dict:
    """The reference's statistics of the final run of ``cfg`` at ``months``."""
    run = loop.Loop([cfg], [months], philox.stream_seed(cfg["seed"], 1),
                    cfg["num_simulations_main"], dtype, device)
    out = run.tracked()
    res = stats.served(out, int(cfg["retirement_years"]))
    del out, run
    return res


def answer_from_payload(status: int, body) -> dict:
    """A served /api/simulate answer in the form the comparison reads:
    ``status``, and for a 200 the months found, the search curve's
    probability there and the final run's statistics."""
    if status != 200:
        return {"status": status}
    months = int(body["summary"]["required_working_months"])
    curve = body.get("search_curve") or {"points": []}
    probs = {int(q["working_months"]): q["probability"] for q in curve["points"]}
    return {"status": 200, "months": months, "search_prob": probs.get(months),
            "served": served_from_payload(body)}


def search_numbers(cfg: dict, answer: dict, dtype, device) -> Dict[str, float]:
    """``search_edge_pts`` and ``search_prob_pts`` of one answered search."""
    seed = philox.stream_seed(cfg["seed"], 0)
    n = int(cfg["num_simulations_search"])
    target = float(cfg["target_probability"])
    start = int(cfg["starting_working_months_search"])
    if answer["status"] != 200:
        last = start + SEARCH_YEARS * 12
        p = loop.success_pct([cfg], [last], seed, n, dtype, device)[0]
        return {"search_edge_pts": max(0.0, p - target), "search_prob_pts": 0.0}
    w = answer["months"]
    months = [w - 1, w] if w > start else [w]
    p = loop.success_pct([cfg], months, seed, n, dtype, device)
    edge = max(0.0, target - p[-1])
    if w > start:
        edge = max(edge, p[0] - target)
    prob = answer["search_prob"]
    gap = float("inf") if prob is None else max(abs(prob - p[-1]) - 0.005, 0.0)
    return {"search_edge_pts": edge, "search_prob_pts": gap}


def plan_numbers(request: dict, answer: dict, dtype, device) -> Dict[str, float]:
    """Every number of one /api/simulate answer (``answer_from_payload``)."""
    cfg = request["config"]
    out = search_numbers(cfg, answer, dtype, device)
    if answer["status"] == 200:
        ref = final_reference(cfg, answer["months"], dtype, device)
        out.update(compare_served(answer["served"], ref,
                                  int(cfg["num_simulations_main"])))
    return out


def grid_reference(request: dict, rows: Sequence[int], dtype, device) -> dict:
    """``stats.grid_rows`` of the ``rows`` of a grid request."""
    base = request["config"]
    cfgs = [{**base, **request["variants"][i]["overrides"]} for i in rows]
    months = request["working_months"]
    months = [months] * len(rows) if isinstance(months, int) else [months[i] for i in rows]
    n = int(request.get("num_paths") or base["num_simulations_main"])
    run = loop.Loop(cfgs, months, philox.stream_seed(base["seed"], 1), n, dtype, device)
    res = run.rows()
    return stats.grid_rows(res["success"], res["final_balance"])


def grid_answer(body: dict, rows: Sequence[int]) -> dict:
    """The served rows of a /api/grid answer in ``stats.grid_rows``' form."""
    picked = [body["rows"][i] for i in rows]
    return {
        "success_probability": np.array([r["success_probability"] for r in picked]),
        "median_final_balance": np.array([r["median_final_balance"] for r in picked]),
        "mean_final_balance": np.array([r["mean_final_balance"] for r in picked]),
        "final_balance_percentiles": np.array(
            [[r["final_balance_percentiles"][k] for k in ("p5", "p25", "p50", "p75", "p95")]
             for r in picked]),
    }


def grid_numbers(request: dict, answer: dict, rows: Sequence[int], dtype, device
                 ) -> Dict[str, float]:
    """``grid_success_pts``, ``grid_stats_rank`` and ``grid_mean_rel`` of
    the sampled ``rows`` (``answer`` as ``grid_answer`` gives them)."""
    ref = grid_reference(request, rows, dtype, device)
    succ = np.abs(np.asarray(answer["success_probability"])
                  - ref["success_probability"]).max() - 0.005
    served = np.concatenate([np.asarray(answer["final_balance_percentiles"], np.float64),
                             np.asarray(answer["median_final_balance"], np.float64)[:, None]],
                            axis=1)
    rank = ref["columns"].rank_gap(served, stats.GRID + (0.5,), 0.005)
    mean = np.asarray(answer["mean_final_balance"], np.float64)
    # A row whose every path is ruined has a mean of 0: a dollar is its scale.
    rel = np.maximum(np.abs(mean - ref["mean_final_balance"]) - 0.005, 0.0) / np.maximum(
        np.abs(ref["mean_final_balance"]), 1.0)
    return {"grid_success_pts": max(float(succ), 0.0), "grid_stats_rank": rank,
            "grid_mean_rel": float(rel.max())}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the answers checked."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
