"""Engine: seeds, candidate batching, device placement and result assembly.

Counterpart of the JAX package's ``engine/runner.py`` for one torch device.
``probe`` pads every candidate batch to ``PROBE_WIDTH`` and runs the probe
kernel (the plain version on the CPU); above ``max_probe_paths()`` it
splits the paths into chunks of whole 4096-path blocks by global block
offset, which draws exactly the shocks of one dispatch, and merges the
survivor counts. ``run`` is the non-reduced full-statistics run: the full
kernel, then the summary reductions on the same device, then one copy of
the tables and per-path vectors to the host.

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
from ..ops.stats import summarize
from ..timing import expected_trajectory_length
from .cuda_kernel import (
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
class RunResult:
    """Host-side (numpy) results of one full simulation batch."""

    working_months: int
    num_simulations: int
    success: np.ndarray
    final_balance: np.ndarray
    start_balance: np.ndarray
    years_to_ruin: np.ndarray
    first_year_gross: np.ndarray
    first_year_real_gross: np.ndarray
    inflation_at_retirement: np.ndarray
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
        self, working_months: int, num_simulations: int, stream: str = "final"
    ) -> RunResult:
        """One full-statistics batch."""
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
        host = {
            name: full[name].cpu().numpy()
            for name in (
                "success", "final_balance", "start_balance", "years_to_ruin",
                "first_year_gross", "first_year_real_gross",
                "inflation_at_retirement",
            )
        }
        s = {name: v.cpu().numpy() for name, v in summary._asdict().items()}
        log.info(
            "phase=final_run device=%s paths=%d months=%d: %.3f s",
            self.device, n, working_months, time.perf_counter() - t_start,
        )
        L = expected_trajectory_length(working_months, self.retirement_years)
        return RunResult(
            working_months=working_months,
            num_simulations=n,
            success=host["success"] > 0.5,
            final_balance=host["final_balance"],
            start_balance=host["start_balance"],
            years_to_ruin=host["years_to_ruin"],
            first_year_gross=host["first_year_gross"],
            first_year_real_gross=host["first_year_real_gross"],
            inflation_at_retirement=host["inflation_at_retirement"],
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
