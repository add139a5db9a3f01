"""Minimum-working-months search: batched bracket -> verify.

The reference searched serially — bracket with adaptive steps, bisect, then
verify every month in the statistically plausible transition region
(backend/simulation.py:1138-1343). On TPU, probing one candidate costs the
same as probing a batch (candidates are a vmap axis with shared shocks), so
the search collapses to a few batched device calls:

  Phase 1  evaluate a 12-month ladder from the starting point in chunks,
           stopping at the first chunk containing a target hit;
  Phase 2  verify *every* month from one tested point before the first
           near-target ladder point (a conservative 3-sigma binomial margin,
           identical to the reference's) up to the first ladder hit, all in
           batched calls;
  Answer   the smallest tested month meeting the target — same selection
           rule as the reference, so locally non-monotone Monte Carlo
           estimates are handled identically.

Common random numbers across candidates hold by construction (shocks are a
pure function of (stream, month, path)), so the success curve is coherent.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..constants import MAX_SEARCH_YEARS, MONTHS_PER_YEAR

log = logging.getLogger("mcrt.search")

ProbeBatch = Callable[[Sequence[int]], Sequence[float]]

# Candidates evaluated per device call during the ladder phase. Matches the
# engine's PROBE_WIDTH so the whole search reuses one compiled executable.
LADDER_CHUNK = 16
# Batch size for the verification sweep.
VERIFY_CHUNK = 64


def find_minimum_working_months(
    probe_batch: ProbeBatch,
    *,
    starting_working_months: int,
    target_probability_pct: float,
    sim_count: int,
    scenario_name: str = "",
    verbose: bool = True,
    progress_callback: Optional[Callable[[dict], None]] = None,
) -> Tuple[int, float, List[Dict[str, float]]]:
    """Estimate the minimum working months achieving the target probability.

    ``probe_batch(months)`` returns the success probability (percent) for each
    candidate month count, evaluated with common random numbers. Returns
    (months, probability, search_curve); months == -1 when the target cannot
    be met within ``starting + 70 years`` (the curve then carries the best
    probability found).
    """
    start = int(starting_working_months)
    target = float(target_probability_pct)
    max_months = start + MAX_SEARCH_YEARS * MONTHS_PER_YEAR

    cache: Dict[int, float] = {}
    curve: List[Dict[str, float]] = []
    state = {"iteration": 0, "lo": start, "hi": None}

    if verbose:
        log.info(
            "Estimating working months to achieve %.2f%% success for '%s'.",
            target,
            scenario_name,
        )
        log.info(
            "Starting search from %d months. Simulations per test: %d.",
            start,
            sim_count,
        )

    def _evaluate(months: Sequence[int]) -> None:
        """Probe a batch of new candidates and record them in probe order."""
        fresh = [m for m in months if m not in cache]
        if not fresh:
            return
        probs = probe_batch(fresh)
        for m, prob in zip(fresh, probs):
            prob = float(prob)
            cache[m] = prob
            state["iteration"] += 1
            if verbose:
                log.info(
                    "Search iter %d: %d m (%.1f yrs) -> %.2f%% (target %.2f%%)",
                    state["iteration"],
                    m,
                    m / MONTHS_PER_YEAR,
                    prob,
                    target,
                )
            curve.append(
                {
                    "working_months": m,
                    "working_years": round(m / MONTHS_PER_YEAR, 1),
                    "probability": round(prob, 2),
                }
            )
            if progress_callback:
                progress_callback(
                    {
                        "type": "search_iter",
                        "iteration": state["iteration"],
                        "working_months": m,
                        "working_years": round(m / MONTHS_PER_YEAR, 1),
                        "probability": round(prob, 2),
                        "target": target,
                        "sim_count": sim_count,
                        "lo": state["lo"],
                        "hi": state["hi"],
                    }
                )

    # --- Phase 1: 12-month ladder, chunked, stop at the first hit -----------
    ladder = list(range(start, max_months + 1, MONTHS_PER_YEAR))
    if ladder[-1] != max_months:
        ladder.append(max_months)

    first_hit: Optional[int] = None
    # Probe the starting point alone first (cheap early exit), then chunks.
    chunk_bounds = [(0, 1)] + [
        (i, i + LADDER_CHUNK) for i in range(1, len(ladder), LADDER_CHUNK)
    ]
    for lo_i, hi_i in chunk_bounds:
        chunk = ladder[lo_i:hi_i]
        _evaluate(chunk)
        hits = [m for m in chunk if cache[m] >= target]
        if hits:
            first_hit = min(hits)
            state["hi"] = first_hit
        # Only misses strictly below the first hit may raise lo — a noisy
        # miss above it would otherwise report lo > hi in progress events.
        misses = [
            m
            for m in chunk
            if cache[m] < target and (first_hit is None or m < first_hit)
        ]
        if misses:
            state["lo"] = max(state["lo"], max(misses))
        if hits:
            break

    if cache.get(start, -1.0) >= target:
        if verbose:
            log.info("  Target met at starting point %d months.", start)
        return start, cache[start], curve

    if first_hit is None:
        best_prob = max(cache.values()) if cache else -1.0
        if verbose:
            log.warning(
                "Search for '%s' reached max limit (%.1f yrs). Target NOT met. "
                "Highest probability achieved: %.2f%%.",
                scenario_name,
                max_months / MONTHS_PER_YEAR,
                best_prob,
            )
        return -1, best_prob, curve

    if progress_callback:
        progress_callback(
            {
                "type": "search_refining",
                "working_months": first_hit,
                "lo": state["lo"],
                "hi": first_hit,
            }
        )

    # --- Phase 2: verify every month in the plausible transition region -----
    # Conservative three-sigma worst-case binomial margin (same as reference).
    margin = min(100.0, 150.0 / math.sqrt(sim_count))
    tested = sorted(m for m in cache if m <= first_hit)
    near_idx = next(
        (i for i, m in enumerate(tested) if cache[m] >= target - margin),
        len(tested) - 1,
    )
    verification_start = max(start, tested[max(0, near_idx - 1)])
    if verbose:
        log.info(
            "  Verifying each month from %d to %d to handle locally "
            "non-monotone Monte Carlo estimates.",
            verification_start,
            first_hit,
        )
    to_verify = [
        m for m in range(verification_start, first_hit + 1) if m not in cache
    ]
    for i in range(0, len(to_verify), VERIFY_CHUNK):
        _evaluate(to_verify[i : i + VERIFY_CHUNK])

    qualifying = [
        m for m, prob in cache.items() if start <= m <= first_hit and prob >= target
    ]
    best = min(qualifying) if qualifying else first_hit
    best_prob = cache[best]
    if verbose:
        log.info(
            "  Search complete: estimated minimum %d months (%.1f yrs) "
            "with prob %.2f%%.",
            best,
            best / MONTHS_PER_YEAR,
            best_prob,
        )
    return best, best_prob, curve
