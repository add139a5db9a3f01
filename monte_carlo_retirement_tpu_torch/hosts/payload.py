"""Assembly of the plot-ready simulation response payload.

A copy of the JAX package's ``hosts/payload.py`` with the port's imports
(importing that module would import jax): the same keys, rounding, NaN
handling, reference-line and cohort rules, so the port's server answers in
the JAX server's wire format.

Two assembly paths produce identical wire output:

* **Pandas path** — runs ``run_monte_carlo_simulations`` (the reference
  7-tuple) and reduces per-path arrays on the host. Used below the raw-path
  cap (the response embeds the arrays anyway), when the caller forces raw
  arrays (``include_raw=True``), and for simulators without the reduced
  seam (the fake-simulator test pattern).
* **Reduced path** — ``run_result_reduced``: every percentile and histogram
  is reduced on the device (``ops/stats.py``); the host only applies the
  data-dependent trims of the wire format. At 1M paths this fetches
  kilobytes instead of ~28 MB of per-path arrays.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..constants import (
    MONTHS_PER_YEAR,
    SMALL_EPSILON,
    TRAJECTORY_PERCENTILES,
    WITHDRAWAL_RATE_PERCENTILES,
)
from ..engine.simulator import median_first_year_withdrawal_rate, success_mask
from ..timing import (
    expected_trajectory_length,
    retirement_age,
    stream_payment_start_month_index,
    trajectory_time_points,
)
from ..utils import profiling


def max_raw_paths() -> int:
    """Per-path arrays (histogram inputs, ruin list) are serialized raw up to
    this many paths; beyond it the response carries pre-binned aggregates so
    a 1M-path run serves a bounded payload (north-star scale)."""
    return int(os.environ.get("MCRT_MAX_RAW_PATHS", "20000"))


def bin_successful_finals(finals: np.ndarray, flags: np.ndarray) -> Optional[dict]:
    """60-bin histogram over successful final balances — identical semantics
    to the dashboard's client-side binning (equal-width from min to max,
    degenerate width 1, last bin clamped, median = sorted[floor(n/2)])."""
    wins = np.asarray(finals, dtype=float)[np.asarray(flags, dtype=bool)]
    if wins.size == 0:
        return None
    lo, hi = float(wins.min()), float(wins.max())
    nbins = 60
    width = (hi - lo) / nbins or 1.0
    idx = np.minimum(nbins - 1, ((wins - lo) / width).astype(int))
    counts = np.bincount(idx, minlength=nbins)
    median = float(np.sort(wins)[wins.size // 2])
    return {
        "bin_edges": [round(lo + i * width, 2) for i in range(nbins + 1)],
        "counts": [int(c) for c in counts],
        "median": round(median, 2),
        "success_count": int(wins.size),
        "total_paths": int(len(flags)),
    }


def bin_years_to_ruin(years: np.ndarray) -> List[int]:
    """Integer-year bins with the dashboard's client-side rules: bins span
    [0, ceil(max(years, 1))), last bin clamps, trailing zeros trimmed."""
    vals = np.asarray(years, dtype=float)
    if vals.size == 0:
        return []
    max_year = int(math.ceil(max(float(vals.max()), 1.0)))
    idx = np.minimum(max_year - 1, vals.astype(int))
    counts = [int(c) for c in np.bincount(idx, minlength=max_year)]
    while counts and counts[-1] == 0:
        counts.pop()
    return counts


def safe_float(value: float) -> Optional[float]:
    """NaN/Inf -> None so strict JSON serialisation never fails."""
    if value is None or math.isnan(value) or math.isinf(value):
        return None
    return round(value, 2)


def dedupe_search_curve(points: List[dict]) -> List[dict]:
    """Keep the latest probability per working_months, sorted ascending."""
    latest: Dict[int, dict] = {}
    for point in points:
        latest[int(point["working_months"])] = point
    return [latest[m] for m in sorted(latest)]


def _trajectory_payload(pct_df, sample_paths, years: List[float]) -> Optional[dict]:
    if pct_df is None or pct_df.empty:
        return None
    if len(years) != len(pct_df):
        raise ValueError(
            "Trajectory time-point count does not match trajectory data "
            f"({len(years)} != {len(pct_df)})."
        )
    percentiles = {
        f"p{int(col * 100)}": [round(float(v), 2) for v in pct_df[col]]
        for col in pct_df.columns
    }
    samples = (
        [[round(float(v), 2) for v in path] for path in sample_paths]
        if sample_paths
        else []
    )
    return {"years": years, "percentiles": percentiles, "sample_paths": samples}


def _trajectory_payload_arrays(
    pct_table: np.ndarray, sample_paths: np.ndarray, years: List[float]
) -> Optional[dict]:
    """The reduced-path twin of ``_trajectory_payload``: a (7, L) percentile
    table + (k, L) samples instead of pandas frames."""
    if pct_table is None or pct_table.size == 0:
        return None
    if len(years) != pct_table.shape[1]:
        raise ValueError(
            "Trajectory time-point count does not match trajectory data "
            f"({len(years)} != {pct_table.shape[1]})."
        )
    percentiles = {
        f"p{int(frac * 100)}": [round(float(v), 2) for v in row]
        for frac, row in zip(TRAJECTORY_PERCENTILES, pct_table)
    }
    samples = [[round(float(v), 2) for v in path] for path in sample_paths]
    return {"years": years, "percentiles": percentiles, "sample_paths": samples}


def _summary_block(
    config: Config,
    required_w_months: int,
    success_prob: float,
    median_start: float,
    median_final: float,
    swr: float,
    balance_percentiles: Dict[str, float],
    search_curve: Optional[List[dict]],
    num_simulations: Optional[int] = None,
) -> dict:
    sigma = None
    if num_simulations:
        p = min(max(success_prob / 100.0, 0.0), 1.0)
        sigma = round(math.sqrt(p * (1.0 - p) / num_simulations) * 100.0, 3)
    return {
        "required_working_months": required_w_months,
        "required_working_years": round(required_w_months / MONTHS_PER_YEAR, 1),
        "working_period_is_estimate": bool(search_curve),
        "retirement_age": round(
            retirement_age(config.current_age, required_w_months), 1
        ),
        "success_probability": round(success_prob, 2),
        # Additive field (absent from the reference wire format): the
        # estimate's own one-sigma Monte Carlo error — decision-grade context
        # for "96.8% vs target 97%". Binomial, so an upper bound under
        # antithetic sampling.
        "success_probability_sigma": sigma,
        "target_probability": config.target_probability,
        "median_start_balance": round(median_start, 2),
        "median_final_balance_successful": round(median_final, 2),
        "swr": safe_float(swr),
        "final_balance_percentiles": balance_percentiles,
    }


def _reference_lines(config: Config, required_w_months: int) -> List[dict]:
    """Retirement start + every materially nonzero income stream."""
    retirement_year = required_w_months / MONTHS_PER_YEAR
    lines = [{"name": "Retirement Starts", "year": retirement_year}]
    for stream in config.other_income_streams or []:
        if stream.monthly_amount_today <= SMALL_EPSILON or stream.duration_years == 0:
            continue
        pay_start = stream_payment_start_month_index(
            config.current_age, required_w_months, stream.start_at_age
        )
        lines.append(
            {
                "name": stream.name,
                "year": round(retirement_year + pay_start / MONTHS_PER_YEAR, 3),
            }
        )
    return lines


def _search_curve_block(
    config: Config, required_w_months: int, search_curve: Optional[List[dict]]
) -> Optional[dict]:
    if not search_curve:
        return None
    return {
        "points": dedupe_search_curve(search_curve),
        "target_probability": config.target_probability,
        "selected_working_months": required_w_months,
    }


@profiling.traced("plan.payload")
def build_result(
    config: Config,
    simulator,
    required_w_months: int,
    search_curve: Optional[List[dict]] = None,
    include_raw: Optional[bool] = None,
) -> dict:
    """Run the final simulation batch and assemble the full response dict.

    ``simulator`` needs only ``run_monte_carlo_simulations`` (the facade's
    pandas 7-tuple), preserving the reference's fake-simulator test seam;
    when it also provides ``run_result_reduced`` and the response would be
    capped anyway, the device-reduced path serves it without fetching
    per-path arrays.

    ``include_raw``: ``True`` forces raw per-path arrays (reference wire
    format) regardless of the cap, ``False`` forces the binned form,
    ``None`` lets ``MCRT_MAX_RAW_PATHS`` decide.
    """
    if include_raw is None:
        capped = config.num_simulations_main > max_raw_paths()
    else:
        capped = not include_raw
    if capped and hasattr(simulator, "run_result_reduced"):
        return _build_result_reduced(
            config, simulator, required_w_months, search_curve
        )
    return _build_result_pandas(
        config, simulator, required_w_months, search_curve, capped
    )


def _build_result_pandas(
    config: Config,
    simulator,
    required_w_months: int,
    search_curve: Optional[List[dict]],
    capped: bool,
) -> dict:
    (
        summary_df,
        traj_pct_df,
        sample_paths,
        wr_pct_df,
        real_pct_df,
        real_sample_paths,
        wr_counts,
    ) = simulator.run_monte_carlo_simulations(
        working_months=required_w_months,
        num_simulations=config.num_simulations_main,
    )
    if summary_df.empty:
        raise ValueError(f"Simulation for '{config.Nickname}' yielded no results.")

    successes = success_mask(summary_df)
    success_prob = float(successes.mean() * 100.0)

    successful_finals = summary_df.loc[successes, "Final Balance"]
    median_final = float(successful_finals.median()) if not successful_finals.empty else 0.0
    median_start = float(summary_df["Start Balance"].median())
    swr = median_first_year_withdrawal_rate(summary_df)

    quantiles = summary_df["Final Balance"].quantile(
        [0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99]
    )
    balance_percentiles = {
        f"p{int(q * 100)}": round(max(0.0, float(v)), 2)
        for q, v in quantiles.items()
    }

    years = trajectory_time_points(required_w_months, config.retirement_years)
    retirement_year = required_w_months / MONTHS_PER_YEAR

    withdrawal_rate = None
    if wr_pct_df is not None and not wr_pct_df.empty:
        wr_percentiles: Dict[str, List[Optional[float]]] = {}
        for col in wr_pct_df.columns:
            series = [
                None
                if v is None or (isinstance(v, float) and math.isnan(v))
                else round(float(v), 3)
                for v in wr_pct_df[col]
            ]
            wr_percentiles[f"p{int(col * 100)}"] = series
        withdrawal_rate = {
            "years": [retirement_year + i for i in range(len(wr_pct_df))],
            "percentiles": wr_percentiles,
            "observation_counts": wr_counts or [],
            "total_paths": int(len(summary_df)),
        }

    ruin_histogram = None
    if "YearsToRuin" in summary_df.columns:
        failed = summary_df.loc[~successes, "YearsToRuin"].dropna()
        ruin_histogram = {
            "years_to_ruin": (
                [] if capped else [round(float(v), 1) for v in failed]
            ),
            "failure_count": int(len(failed)),
            "total_paths": int(len(summary_df)),
            "year_counts": (
                bin_years_to_ruin(failed.to_numpy()) if capped else None
            ),
        }

    return {
        "scenario": config.Nickname,
        "summary": _summary_block(
            config, required_w_months, success_prob, median_start,
            median_final, swr, balance_percentiles, search_curve,
            num_simulations=int(len(summary_df)),
        ),
        "trajectory": _trajectory_payload(traj_pct_df, sample_paths, years),
        "trajectory_real": _trajectory_payload(real_pct_df, real_sample_paths, years),
        "withdrawal_rate": withdrawal_rate,
        "search_curve": _search_curve_block(
            config, required_w_months, search_curve
        ),
        "ruin_histogram": ruin_histogram,
        "histogram": (
            {
                "final_balances": [],
                "start_balances": [],
                "success_flags": [],
                "binned": bin_successful_finals(
                    summary_df["Final Balance"].to_numpy(),
                    successes.to_numpy(),
                ),
            }
            if capped
            else {
                "final_balances": [
                    round(float(v), 2) for v in summary_df["Final Balance"]
                ],
                "start_balances": [
                    round(float(v), 2) for v in summary_df["Start Balance"]
                ],
                "success_flags": [bool(v) for v in successes],
            }
        ),
        "reference_lines": _reference_lines(config, required_w_months),
    }


def _binned_finals_from_device(bins, total_paths: int) -> Optional[dict]:
    """Assemble the ``HistogramBins`` dict from device-reduced aggregates —
    same wire values as ``bin_successful_finals`` on the raw arrays."""
    if bins.success_count == 0:
        return None
    lo, hi = bins.finals_min_successful, bins.finals_max_successful
    nbins = len(bins.finals_hist_counts)
    width = (hi - lo) / nbins or 1.0
    return {
        "bin_edges": [round(lo + i * width, 2) for i in range(nbins + 1)],
        "counts": [int(c) for c in bins.finals_hist_counts],
        "median": round(float(bins.finals_median_successful), 2),
        "success_count": int(bins.success_count),
        "total_paths": int(total_paths),
    }


def _ruin_counts_from_device(bins) -> List[int]:
    """``bin_years_to_ruin`` from device integer-year counts: collapse the
    bins at/above ceil(max) into the last kept bin, trim trailing zeros."""
    if bins.failure_count == 0:
        return []
    max_year = int(math.ceil(max(float(bins.ruin_max), 1.0)))
    device = [int(c) for c in bins.ruin_counts]
    counts = device[:max_year]
    counts[max_year - 1] += sum(device[max_year:])
    while counts and counts[-1] == 0:
        counts.pop()
    return counts


def _build_result_reduced(
    config: Config,
    simulator,
    required_w_months: int,
    search_curve: Optional[List[dict]],
) -> dict:
    res = simulator.run_result_reduced(
        required_w_months, config.num_simulations_main
    )
    n = int(res.num_simulations)
    if n == 0:
        raise ValueError(f"Simulation for '{config.Nickname}' yielded no results.")
    bins = res.bins

    median_final = res.median_final_successful
    if math.isnan(median_final):  # no successful paths
        median_final = 0.0

    balance_percentiles = {
        f"p{int(q * 100)}": round(max(0.0, float(v)), 2)
        for q, v in zip(
            (0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99),
            res.final_balance_percentiles,
        )
    }

    years = trajectory_time_points(required_w_months, config.retirement_years)
    retirement_year = required_w_months / MONTHS_PER_YEAR
    L = expected_trajectory_length(required_w_months, config.retirement_years)
    assert res.trajectory_percentiles.shape[1] == L

    wr_table = res.wr_percentiles
    withdrawal_rate = None
    if wr_table is not None and wr_table.size:
        wr_percentiles = {
            f"p{int(frac * 100)}": [
                None if math.isnan(float(v)) else round(float(v), 3)
                for v in row
            ]
            for frac, row in zip(WITHDRAWAL_RATE_PERCENTILES, wr_table)
        }
        withdrawal_rate = {
            "years": [retirement_year + i for i in range(wr_table.shape[1])],
            "percentiles": wr_percentiles,
            "observation_counts": [int(v) for v in res.wr_observation_counts],
            "total_paths": n,
        }

    ruin_histogram = {
        "years_to_ruin": [],
        "failure_count": int(bins.failure_count),
        "total_paths": n,
        "year_counts": _ruin_counts_from_device(bins),
    }

    return {
        "scenario": config.Nickname,
        "summary": _summary_block(
            config, required_w_months, res.success_probability,
            res.median_start_balance, median_final, res.swr,
            balance_percentiles, search_curve,
            num_simulations=res.num_simulations,
        ),
        "trajectory": _trajectory_payload_arrays(
            res.trajectory_percentiles, res.sample_trajectories, years
        ),
        "trajectory_real": _trajectory_payload_arrays(
            res.real_trajectory_percentiles, res.sample_real_trajectories, years
        ),
        "withdrawal_rate": withdrawal_rate,
        "search_curve": _search_curve_block(
            config, required_w_months, search_curve
        ),
        "ruin_histogram": ruin_histogram,
        "histogram": {
            "final_balances": [],
            "start_balances": [],
            "success_flags": [],
            "binned": _binned_finals_from_device(bins, n),
        },
        "reference_lines": _reference_lines(config, required_w_months),
    }
