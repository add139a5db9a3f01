"""Summary reductions over the path axis (the JAX ``ops/stats.py``).

Run on the device that holds the per-path tensors; only the small tables
are brought to the host. Every percentile has exact np.percentile /
np.nanpercentile semantics (``ops/quantiles.py``). ``serving_bins`` also
reduces the dashboard's histogram payloads there, so a capped serving
response needs no per-path array on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import (
    FINAL_BALANCE_PERCENTILES,
    SMALL_EPSILON,
    TRAJECTORY_PERCENTILES,
    WITHDRAWAL_RATE_PERCENTILES,
)
from .quantiles import exact_quantiles, quantiles_percol, upper_median

EPS = SMALL_EPSILON

# Bin count of the dashboard's successful-final-balance histogram.
FINAL_HIST_BINS = 60


class RunSummary(NamedTuple):
    """Reduced statistics for one full simulation batch (tensors)."""

    success_probability: torch.Tensor  # scalar, percent
    median_start_balance: torch.Tensor  # scalar
    median_final_successful: torch.Tensor  # scalar (NaN if no successes)
    swr: torch.Tensor  # scalar, percent (NaN if no valid start balances)
    final_balance_percentiles: torch.Tensor  # (9,)
    trajectory_percentiles: torch.Tensor  # (7, L)
    real_trajectory_percentiles: torch.Tensor  # (7, L)
    sample_trajectories: torch.Tensor  # (num_samples, L)
    sample_real_trajectories: torch.Tensor  # (num_samples, L)
    wr_percentiles: torch.Tensor  # (5, R)
    wr_observation_counts: torch.Tensor  # (R,)


class ServingBins(NamedTuple):
    """Pre-binned dashboard aggregates, reduced on the device (the JAX
    ``ServingBins``); the counts equal ``hosts/payload.py``'s numpy binning
    of the same per-path values."""

    success_count: torch.Tensor  # scalar int
    finals_min_successful: torch.Tensor  # scalar (+inf if no successes)
    finals_max_successful: torch.Tensor  # scalar (-inf if no successes)
    finals_hist_counts: torch.Tensor  # (FINAL_HIST_BINS,) int
    finals_median_successful: torch.Tensor  # scalar, sorted[n//2] (NaN if none)
    ruin_counts: torch.Tensor  # (R+1,) int — integer-year bins incl. == R
    ruin_max: torch.Tensor  # scalar (-inf if no failures)
    failure_count: torch.Tensor  # scalar int — failed paths with finite ruin


def vector_summary(success, final, start, first_year_real_gross):
    """Headline scalars + final-balance percentiles from per-path vectors.
    Returns (success_prob, median_start, median_final_successful, swr,
    final_pcts)."""
    success = success > 0.5 if success.dtype != torch.bool else success
    success_prob = success.to(final.dtype).mean() * 100.0
    start_ok = start > EPS
    rates = first_year_real_gross / torch.clamp(start, min=EPS) * 100.0
    cols = torch.stack([start, final, rates, final], dim=1)
    all_ok = torch.ones_like(start_ok)
    valid = torch.stack([all_ok, success, start_ok, all_ok], dim=1)
    fq = torch.tensor(FINAL_BALANCE_PERCENTILES, dtype=final.dtype,
                      device=final.device)
    half = torch.full_like(fq, 0.5)
    qmat = torch.stack([half, half, half, fq])
    tbl = quantiles_percol(cols, qmat, valid=valid)
    return success_prob, tbl[0, 0], tbl[1, 0], tbl[2, 0], tbl[3, :]


def real_series(traj, price):
    """The inflation-adjusted trajectory: one expression for the whole run
    and for each chunk of a chunked run (``engine/runner.py``), so both
    derive bit-equal values."""
    return torch.where(price > EPS, traj / torch.clamp(price, min=EPS), 0.0)


def series_summary(traj, price, wr, sample_idx):
    """Per-year percentile tables + sample paths from the (n, L)/(n, R)
    series. Returns (traj_pcts, real_pcts, samples, samples_real, wr_pcts,
    wr_counts)."""
    real = real_series(traj, price)
    traj_pcts = exact_quantiles(traj, TRAJECTORY_PERCENTILES)
    real_pcts = exact_quantiles(real, TRAJECTORY_PERCENTILES)
    samples = traj[sample_idx]
    samples_real = real[sample_idx]
    wr_valid = ~torch.isnan(wr)
    wr_pcts = exact_quantiles(wr, WITHDRAWAL_RATE_PERCENTILES, valid=wr_valid)
    wr_counts = wr_valid.sum(dim=0)
    return traj_pcts, real_pcts, samples, samples_real, wr_pcts, wr_counts


def summarize(outs, sample_idx: torch.Tensor) -> RunSummary:
    """Reduce per-path outputs (a mapping with the ``simulate_full`` keys)
    to percentile tables and headline scalars."""
    (success_prob, median_start, median_final_successful, swr,
     final_pcts) = vector_summary(
        outs["success"], outs["final_balance"], outs["start_balance"],
        outs["first_year_real_gross"],
    )
    (traj_pcts, real_pcts, samples, samples_real, wr_pcts,
     wr_counts) = series_summary(
        outs["trajectory"], outs["price_levels"], outs["withdrawal_rates"],
        sample_idx,
    )
    return RunSummary(
        success_probability=success_prob,
        median_start_balance=median_start,
        median_final_successful=median_final_successful,
        swr=swr,
        final_balance_percentiles=final_pcts,
        trajectory_percentiles=traj_pcts,
        real_trajectory_percentiles=real_pcts,
        sample_trajectories=samples,
        sample_real_trajectories=samples_real,
        wr_percentiles=wr_pcts,
        wr_observation_counts=wr_counts,
    )


def _masked_bincount(idx: torch.Tensor, keep: torch.Tensor,
                     nbins: int) -> torch.Tensor:
    """Counts of ``idx`` (integral floats in [0, nbins)) where ``keep``;
    the rest go to a spare last bin that is dropped."""
    spare = torch.where(keep, idx, float(nbins)).to(torch.int64)
    return torch.bincount(spare, minlength=nbins + 1)[:nbins]


def serving_bins(outs, r_years: int | None = None) -> ServingBins:
    """The dashboard's histogram payloads, reduced on the device that holds
    ``outs`` (a mapping with the ``simulate_full`` keys).

    Equal to ``hosts/payload.bin_successful_finals`` and
    ``bin_years_to_ruin`` on the same values: the bin index is computed in
    float64 as numpy computes it from the (float32) finals, with the same
    width rule ((hi - lo) / 60, or 1.0 when that is 0), truncation and
    last-bin clamp, so a value on a bin edge lands where numpy puts it.
    The host only trims the ruin bins (trailing zeros, ceil(max) length).
    """
    success = outs["success"]
    success = success > 0.5 if success.dtype != torch.bool else success
    final = outs["final_balance"]

    lo = torch.where(success, final, torch.inf).min()
    hi = torch.where(success, final, -torch.inf).max()
    lo64, hi64 = lo.double(), hi.double()
    width0 = (hi64 - lo64) / FINAL_HIST_BINS
    width = torch.where(width0 == 0.0, 1.0, width0)
    idx = torch.clamp(torch.floor((final.double() - lo64) / width),
                      max=FINAL_HIST_BINS - 1)
    hist = _masked_bincount(idx, success, FINAL_HIST_BINS)

    # R from the withdrawal-rate table width unless given; ruin years lie
    # in [0, R], so R+1 integer bins cover every value incl. an exact == R.
    if r_years is None:
        r_years = outs["withdrawal_rates"].shape[1]
    ytr = outs["years_to_ruin"]
    failed = ~success & ~torch.isnan(ytr)
    ridx = torch.clamp(torch.floor(ytr.double()), max=r_years)
    return ServingBins(
        success_count=success.sum(),
        finals_min_successful=lo,
        finals_max_successful=hi,
        finals_hist_counts=hist,
        finals_median_successful=upper_median(final, success),
        ruin_counts=_masked_bincount(ridx, failed, r_years + 1),
        ruin_max=torch.where(failed, ytr, -torch.inf).max(),
        failure_count=failed.sum(),
    )
