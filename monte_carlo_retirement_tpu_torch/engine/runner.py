"""Engine: seeds, candidate batching, device placement and result assembly.

Counterpart of the JAX package's ``engine/runner.py`` for one torch device.
``probe`` pads every candidate batch to ``PROBE_WIDTH`` and runs the probe
kernel (the plain version on the CPU); above ``max_probe_paths()`` it
splits the paths into chunks of whole 4096-path blocks by global block
offset, which draws exactly the shocks of one dispatch, and merges the
survivor counts. ``run`` is the full-statistics run: the full kernel, then
the summary reductions on the same device, then the tables and per-path
vectors to the host; with ``reduced=True`` (the serving path) the per-path
vectors stay on the device, the dashboard's histograms are reduced there
too (``ops/stats.serving_bins``), and the tables and bins cross to the host
in one copy.

Stream seeds and sample rows follow the JAX engine's rules
(``runner.py:463-470, 654-658``), so both packages pick the same seeds and
sample paths for a given main seed. There is no scan backend, no compile
cache and no trajectory-width cap here: the width is ``1 + t_scan // 12``.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..constants import MONTHS_PER_YEAR, NUM_SAMPLE_PATHS
from ..logging_utils import generate_seed_from_timestamp
from ..models.retirement import SimParams
from ..ops.shocks import BLOCK_PATHS
from ..ops.stats import serving_bins, summarize
from ..timing import expected_trajectory_length
from .cuda_kernel import (
    VECTOR_FIELDS,
    pack_params,
    probe as probe_kernel,
    require_device,
    simulate_full,
    statics_from_config,
)

log = logging.getLogger("mcrt.engine")

# Scan lengths round up to this many months (the JAX engine's bucket); here
# it only sizes the trajectory buffer.
SCAN_BUCKET_MONTHS = 60

# Candidate batches are padded to this width (one launch shape per search).
PROBE_WIDTH = 16


def max_probe_paths() -> int:
    """Probe paths per launch; chunked by global block offset above it."""
    return int(os.environ.get("MCRT_MAX_PROBE_PATHS", str(16 * 2**20)))


def _round_up(value: int, multiple: int) -> int:
    return max(multiple, ((value + multiple - 1) // multiple) * multiple)


@dataclass
class HostBins:
    """Device-reduced dashboard aggregates on the host (``ops/stats.
    ServingBins``): the payload's capped path needs nothing else."""

    success_count: int
    finals_min_successful: float
    finals_max_successful: float
    finals_hist_counts: np.ndarray  # (60,)
    finals_median_successful: float
    ruin_counts: np.ndarray  # (R+1,)
    ruin_max: float
    failure_count: int


@dataclass
class RunResult:
    """Host-side (numpy) results of one full simulation batch.

    In reduced mode (``Engine.run(reduced=True)``) the per-path arrays are
    None and ``bins`` holds the dashboard's aggregates: only the tables and
    the bins cross to the host.
    """

    working_months: int
    num_simulations: int
    # Per-path arrays (None in reduced mode)
    success: Optional[np.ndarray]
    final_balance: Optional[np.ndarray]
    start_balance: Optional[np.ndarray]
    years_to_ruin: Optional[np.ndarray]
    first_year_gross: Optional[np.ndarray]
    first_year_real_gross: Optional[np.ndarray]
    inflation_at_retirement: Optional[np.ndarray]
    success_probability: float
    median_start_balance: float
    median_final_successful: float
    swr: float
    final_balance_percentiles: np.ndarray  # (9,)
    trajectory_percentiles: np.ndarray  # (7, L)
    real_trajectory_percentiles: np.ndarray  # (7, L)
    sample_trajectories: np.ndarray  # (k, L)
    sample_real_trajectories: np.ndarray  # (k, L)
    wr_percentiles: np.ndarray  # (5, R)
    wr_observation_counts: np.ndarray  # (R,)
    # Device-binned dashboard aggregates (reduced mode only)
    bins: Optional[HostBins] = None


def _fetch(groups):
    """Every tensor of ``groups`` (NamedTuples of tensors) on the host in
    one device-to-host copy: flattened into one float64 vector (float32
    values and counts below 2**53 convert exactly), then split and cast
    back to each tensor's dtype. Returns one dict per group."""
    leaves = [t for g in groups for t in g]
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for group in groups:
        fields = {}
        for name, t in zip(group._fields, group):
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            fields[name] = flat[at:at + t.numel()].reshape(t.shape).astype(dtype)
            at += t.numel()
        out.append(fields)
    return out


class Engine:
    """Monte Carlo engine for one scenario on one torch device.

    ``device="cuda"`` runs the CUDA kernels in float32 and raises when no
    card is present; ``device="cpu"`` runs the plain versions (float64 by
    default).
    """

    def __init__(
        self,
        config: Config,
        main_seed_override: Optional[int] = None,
        dtype=None,
        device="cuda",
    ):
        self.config = config.model_copy(deep=True)
        if main_seed_override is not None:
            if main_seed_override < 0:
                raise ValueError("main_seed_override must be nonnegative.")
            self.main_seed = int(main_seed_override)
        elif self.config.seed is not None:
            self.main_seed = int(self.config.seed)
        else:
            self.main_seed = generate_seed_from_timestamp()
        require_device(device)
        self.device = torch.device(device)
        if dtype is None:
            dtype = torch.float32 if self.device.type == "cuda" else torch.float64
        if self.device.type == "cuda" and dtype != torch.float32:
            raise TypeError("the CUDA kernels run float32")
        self.dtype = dtype
        self.retirement_years = int(self.config.retirement_years)
        self.statics = statics_from_config(self.config)
        self.params = SimParams.from_config(
            self.config, dtype=torch.float64, device=self.device
        )
        log.info(
            "Engine initialized for scenario '%s' on %s with main seed: %d",
            self.config.Nickname, self.device, self.main_seed,
        )

    def _t_scan(self, max_working_months: int) -> int:
        horizon = max_working_months + self.retirement_years * MONTHS_PER_YEAR
        return _round_up(horizon, SCAN_BUCKET_MONTHS)

    def _stream_seed(self, stream: str) -> int:
        """A stable 31-bit seed per (main_seed, stream) for the Philox key."""
        try:
            idx = {"search": 0, "final": 1}[stream]
        except KeyError:
            raise ValueError(f"Unknown seed stream '{stream}'") from None
        state = np.random.SeedSequence([self.main_seed, idx]).generate_state(1)
        return int(state[0] % (2**31))

    def _pack(self, months, stream: str, block_offset: int = 0):
        return pack_params(
            self.params, self._stream_seed(stream), months,
            self.retirement_years, block_offset=block_offset,
            dtype=self.dtype, device=self.device,
        )

    # ------------------------------------------------------------------
    # probe: batched success probabilities for the search
    # ------------------------------------------------------------------
    def probe(
        self,
        months: Sequence[int],
        num_simulations: int,
        stream: str = "search",
        horizon_months: Optional[int] = None,
    ) -> List[float]:
        """Success probability (percent) for each working-month candidate;
        candidates share their shocks (common random numbers)."""
        months = [int(m) for m in months]
        if not months:
            return []
        if any(m < 0 for m in months):
            raise ValueError(f"working-month candidates must be >= 0: {months}")
        if horizon_months is not None and horizon_months < max(months):
            raise ValueError(
                f"horizon_months={horizon_months} is below the largest "
                f"candidate ({max(months)})"
            )
        n_total = int(num_simulations)
        if n_total < 1:
            raise ValueError(f"num_simulations must be >= 1, got {n_total}")
        budget = max(BLOCK_PATHS, (max_probe_paths() // BLOCK_PATHS) * BLOCK_PATHS)
        t_start = time.perf_counter()
        out: List[float] = []
        for i in range(0, len(months), PROBE_WIDTH):
            chunk = months[i : i + PROBE_WIDTH]
            padded = chunk + [chunk[-1]] * (PROBE_WIDTH - len(chunk))
            counts = None
            offset = 0
            for start in range(0, n_total, budget):
                cn = min(budget, n_total - start)
                part = probe_kernel(
                    self._pack(padded, stream, block_offset=offset),
                    self.statics, self.retirement_years, cn,
                ).counts
                counts = part if counts is None else counts + part
                offset += -(-cn // BLOCK_PATHS)
            # Merge over chunks as exact counts: the path-weighted mean.
            pct = counts.cpu().numpy().astype(np.float64) / n_total * 100.0
            out.extend(float(v) for v in pct[: len(chunk)])
        log.debug(
            "phase=probe device=%s candidates=%d paths=%d: %.3f s",
            self.device, len(months), n_total, time.perf_counter() - t_start,
        )
        return out

    # ------------------------------------------------------------------
    # full run with all statistics
    # ------------------------------------------------------------------
    def run(
        self, working_months: int, num_simulations: int, stream: str = "final",
        reduced: bool = False,
    ) -> RunResult:
        """One full-statistics batch. ``reduced=True`` keeps the per-path
        vectors on the device and reduces the dashboard's histograms there
        too; the host gets the tables and bins only."""
        working_months = int(working_months)
        if working_months < 0:
            raise ValueError(f"working_months must be >= 0, got {working_months}")
        n = int(num_simulations)
        traj_len = 1 + self._t_scan(working_months) // MONTHS_PER_YEAR
        k = min(NUM_SAMPLE_PATHS, n)
        sample_idx = torch.as_tensor(
            np.random.default_rng(self.main_seed).choice(n, size=k, replace=False),
            dtype=torch.int64, device=self.device,
        )
        t_start = time.perf_counter()
        full = simulate_full(
            self._pack(working_months, stream), self.statics,
            self.retirement_years, n, traj_len,
        )
        summary = summarize(full, sample_idx)
        bins = None
        if reduced:
            s, b = _fetch([summary, serving_bins(full, self.retirement_years)])
            bins = HostBins(**{
                name: v if v.ndim else v.item() for name, v in b.items()
            })
            host = dict.fromkeys(VECTOR_FIELDS)
        else:
            host = {name: full[name].cpu().numpy() for name in VECTOR_FIELDS}
            host["success"] = host["success"] > 0.5
            s = {name: v.cpu().numpy() for name, v in summary._asdict().items()}
        log.info(
            "phase=final_run device=%s paths=%d months=%d reduced=%s: %.3f s",
            self.device, n, working_months, reduced,
            time.perf_counter() - t_start,
        )
        L = expected_trajectory_length(working_months, self.retirement_years)
        return RunResult(
            working_months=working_months,
            num_simulations=n,
            **host,
            bins=bins,
            success_probability=float(s["success_probability"]),
            median_start_balance=float(s["median_start_balance"]),
            median_final_successful=float(s["median_final_successful"]),
            swr=float(s["swr"]),
            final_balance_percentiles=s["final_balance_percentiles"],
            trajectory_percentiles=s["trajectory_percentiles"][:, :L],
            real_trajectory_percentiles=s["real_trajectory_percentiles"][:, :L],
            sample_trajectories=s["sample_trajectories"][:, :L],
            sample_real_trajectories=s["sample_real_trajectories"][:, :L],
            wr_percentiles=s["wr_percentiles"],
            wr_observation_counts=s["wr_observation_counts"],
        )

    # ------------------------------------------------------------------
    # single-path inspection (tests / debugging)
    # ------------------------------------------------------------------
    def run_path(self, working_months: int, stream: str = "final") -> dict:
        """Simulate one path and return a reference-style result dict (the
        JAX ``Engine.run_path``)."""
        res = self.run(working_months, 1, stream=stream)
        return {
            "Start Balance": float(res.start_balance[0]),
            "Final Balance": float(max(0.0, res.final_balance[0])),
            "Success": bool(res.success[0]),
            "YearsToRuin": float(res.years_to_ruin[0]),
            "First Year Gross Withdrawal": float(res.first_year_gross[0]),
            "First Year Real Gross Withdrawal": float(res.first_year_real_gross[0]),
            "Trajectory": [float(v) for v in res.sample_trajectories[0]],
            "RealTrajectory": [float(v) for v in res.sample_real_trajectories[0]],
            "WithdrawalRateTrajectory": [
                float(v) for v in res.wr_percentiles[2]  # median == the path
            ],
            "Inflation At Retirement": float(res.inflation_at_retirement[0]),
        }
