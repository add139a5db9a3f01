"""Summary reductions over the path axis (the JAX ``ops/stats.py:43-142``).

Run on the device that holds the per-path tensors; only the small tables
are brought to the host. Every percentile has exact np.percentile /
np.nanpercentile semantics (``ops/quantiles.py``).
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
from .quantiles import exact_quantiles, quantiles_percol

EPS = SMALL_EPSILON


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


def series_summary(traj, price, wr, sample_idx):
    """Per-year percentile tables + sample paths from the (n, L)/(n, R)
    series. Returns (traj_pcts, real_pcts, samples, samples_real, wr_pcts,
    wr_counts)."""
    real = torch.where(price > EPS, traj / torch.clamp(price, min=EPS), 0.0)
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
