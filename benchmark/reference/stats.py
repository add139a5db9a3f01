"""The served statistics, worked out again from per-path outputs.

Percentiles are numpy's default (linear between the two neighbouring order
statistics), taken over the paths in float64 from sorted values. A served
percentile is judged by rank: how many of the reference's paths lie
between it and the order statistics it should fall between, as a share of
the column's paths. A value is exact to the reference only where the paths
agree bit for bit; float32 arithmetic in another order moves a few paths
across a ruin or a bin edge, which moves a percentile near an atom (the
ruined paths' zeros) or in a sparse tail by much more than its rounding,
but moves its rank by those few paths only. The histogram and ruin-year
bins follow the dashboard's rules: 60 equal bins from the smallest to the
largest successful final balance (width 1 when they agree, the last bin
clamped), and whole-year bins of the years to ruin up to ceil(max),
trailing zeros trimmed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

EPS = 1e-6
TRAJECTORY = (0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95)
WITHDRAWAL = (0.05, 0.25, 0.50, 0.75, 0.95)
FINAL = (0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99)
GRID = (0.05, 0.25, 0.50, 0.75, 0.95)
HIST_BINS = 60


class Columns:
    """The rows of a (C, n) table sorted over their valid entries (the
    rest sort last as +inf), with each row's valid count."""

    def __init__(self, rows: torch.Tensor, valid: Optional[torch.Tensor] = None):
        if valid is None:
            valid = torch.ones_like(rows, dtype=torch.bool)
        self.sorted = torch.sort(torch.where(valid, rows, torch.inf), dim=1).values
        self.count = valid.sum(dim=1).cpu().numpy()

    def values(self, qs) -> np.ndarray:
        """(C, Q) percentiles, NaN where a row has no valid entry."""
        out = np.full((self.sorted.shape[0], len(qs)), np.nan)
        last = np.maximum(self.count - 1, 0)
        for j, q in enumerate(qs):
            h = q * last
            lo = np.floor(h).astype(np.int64)
            hi = np.minimum(lo + 1, last)
            idx = torch.as_tensor(np.stack([lo, hi], axis=1), device=self.sorted.device)
            ab = torch.gather(self.sorted, 1, idx).double().cpu().numpy()
            with np.errstate(invalid="ignore"):
                val = ab[:, 0] + (ab[:, 1] - ab[:, 0]) * (h - lo)
            out[:, j] = np.where(self.count > 0, val, np.nan)
        return out

    def rank_gap(self, served: np.ndarray, qs, rounding: float = 0.0) -> float:
        """The largest share of a row's paths between a served (C, Q)
        percentile, give or take its ``rounding``, and the two order
        statistics it should lie between; inf where one side has a value
        and the other has none."""
        served = np.asarray(served, dtype=np.float64).reshape(len(self.count), len(qs))
        n = self.count[:, None].astype(np.float64)
        missing = np.isnan(served)
        if ((n == 0) != missing).any():
            return math.inf
        if missing.all():
            return 0.0
        vals = torch.as_tensor(np.where(missing, 0.0, served), device=self.sorted.device)
        col = self.sorted.double().contiguous()
        left = torch.searchsorted(col, (vals - rounding).contiguous()).cpu().numpy()
        right = torch.searchsorted(col, (vals + rounding).contiguous(), right=True).cpu().numpy()
        h = np.asarray(qs)[None, :] * np.maximum(n - 1, 0)
        lo = np.floor(h)
        hi = np.minimum(lo + 1, np.maximum(n - 1, 0))
        gap = np.maximum(0, np.maximum(left - hi, lo + 1 - right)) / np.maximum(n, 1)
        return float(np.where(missing, 0.0, gap).max())


def served(out: Dict[str, torch.Tensor], R: int) -> dict:
    """The tracked run's statistics as the served payload carries them,
    with the sorted columns behind each percentile (``columns``)."""
    success = out["success"] > 0.5
    n = success.numel()
    final, start = out["final_balance"], out["start_balance"]
    rates = out["first_year_real_gross"] / torch.clamp(start, min=EPS) * 100.0
    traj, price, wr = out["trajectory"], out["price_levels"], out["withdrawal_rates"]
    real = torch.where(price > EPS, traj / torch.clamp(price, min=EPS), 0.0)
    wr_valid = ~torch.isnan(wr)
    cols = {
        "median_start_balance": Columns(start[None]),
        "median_final_balance_successful": Columns(final[None], success[None]),
        "swr": Columns(rates[None], (start > EPS)[None]),
        "final_balance_percentiles": Columns(final[None]),
        "trajectory": Columns(traj),
        "trajectory_real": Columns(real),
        "withdrawal_rate": Columns(wr, wr_valid),
    }
    median_final = cols["median_final_balance_successful"].values((0.5,))[0, 0]
    return {
        "success_probability": float(success.sum().item()) / n * 100.0,
        "median_start_balance": cols["median_start_balance"].values((0.5,))[0, 0],
        "median_final_balance_successful": 0.0 if math.isnan(median_final) else median_final,
        "swr": cols["swr"].values((0.5,))[0, 0],
        "final_balance_percentiles": np.maximum(
            cols["final_balance_percentiles"].values(FINAL)[0], 0.0),
        "trajectory": cols["trajectory"].values(TRAJECTORY).T,
        "trajectory_real": cols["trajectory_real"].values(TRAJECTORY).T,
        "withdrawal_rate": cols["withdrawal_rate"].values(WITHDRAWAL).T,
        "observation_counts": wr_valid.sum(dim=1).cpu().numpy(),
        "hist_counts": _finals_hist(final, success),
        "year_counts": _ruin_counts(out["years_to_ruin"], success, R),
        "columns": cols,
    }


def _finals_hist(final: torch.Tensor, success: torch.Tensor) -> np.ndarray:
    if not bool(success.any()):
        return np.zeros(0, dtype=np.int64)
    wins = final[success].double()
    lo, hi = wins.min(), wins.max()
    width = (hi - lo) / HIST_BINS
    width = torch.where(width == 0.0, torch.ones_like(width), width)
    idx = torch.clamp(torch.floor((wins - lo) / width), max=HIST_BINS - 1).long()
    return torch.bincount(idx, minlength=HIST_BINS).cpu().numpy()


def _ruin_counts(ytr: torch.Tensor, success: torch.Tensor, R: int) -> List[int]:
    failed = ~success & ~torch.isnan(ytr)
    if not bool(failed.any()):
        return []
    years = ytr[failed].double()
    max_year = int(math.ceil(max(float(years.max()), 1.0)))
    idx = torch.clamp(torch.floor(years), max=max_year - 1).long()
    counts = torch.bincount(idx, minlength=max_year).cpu().tolist()
    while counts and counts[-1] == 0:
        counts.pop()
    return counts


def grid_rows(success: torch.Tensor, final: torch.Tensor) -> dict:
    """Per-row statistics of a scenario grid: success %, median and mean
    final balance, the five final-balance percentiles, and the sorted
    finals behind them (``columns``)."""
    n = success.shape[1]
    cols = Columns(final)
    pcts = cols.values(GRID)
    return {
        "success_probability": (success > 0.5).sum(dim=1).double().cpu().numpy() / n * 100.0,
        "median_final_balance": pcts[:, 2],
        "mean_final_balance": final.double().mean(dim=1).cpu().numpy(),
        "final_balance_percentiles": np.maximum(pcts, 0.0),
        "columns": cols,
    }
