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
in one copy. A float32 run above ``max_device_paths()`` is split into
chunks of whole blocks (``_run_chunked``): the union of the chunks is the
unchunked run path for path, and every statistic equals the unchunked
run's (the per-year tables through ``ops/chunked_quantiles.py``).

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
from ..constants import (
    MONTHS_PER_YEAR,
    NUM_SAMPLE_PATHS,
    TRAJECTORY_PERCENTILES,
    WITHDRAWAL_RATE_PERCENTILES,
)
from ..logging_utils import generate_seed_from_timestamp
from ..models.retirement import SimParams
from ..ops.chunked_quantiles import BandSearch, bracket_ranks
from ..ops.quantiles import ceil_stats, count_le, floor_values
from ..ops.shocks import BLOCK_PATHS
from ..ops.stats import real_series, serving_bins, summarize, vector_summary
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


# Full-statistics paths per launch unless MCRT_MAX_DEVICE_PATHS says
# otherwise. An unchunked run peaks at ~1.95 KB of card memory per path at
# config.json's month (L = 71) and ~3.15 KB at the longest horizon (L =
# 121): the series plus the sort of summarize (chip_smoke.py phase 11,
# PERF.md). At 5 x 2**20 paths, the server's four concurrent runs
# (MCRT_MAX_CONCURRENT_RUNS) at the longest horizon hold ~66 GB of an 80 GB
# H100, and the 1M-path main path stays unchunked.
DEFAULT_MAX_DEVICE_PATHS = 5 * 2**20

# Probe edges per target rank in a round of the chunked run's band search:
# a round costs one re-simulation and one sort of every chunk whatever the
# edge count (the counts are binary searches in the sorted chunk), so wide
# rounds are nearly free and cut rounds.
BAND_EDGES = 1024


def max_probe_paths() -> int:
    """Probe paths per launch; chunked by global block offset above it."""
    return int(os.environ.get("MCRT_MAX_PROBE_PATHS", str(16 * 2**20)))


def max_device_paths() -> int:
    """Full-statistics paths per launch, in whole 4096-path blocks; a
    float32 run above it is split into chunks (``Engine._run_chunked``)."""
    budget = int(os.environ.get("MCRT_MAX_DEVICE_PATHS",
                                str(DEFAULT_MAX_DEVICE_PATHS)))
    return max(BLOCK_PATHS, budget // BLOCK_PATHS * BLOCK_PATHS)


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
    """Every tensor of ``groups`` (dicts of tensors) on the host in one
    device-to-host copy: flattened into one float64 vector (float32 values
    and counts below 2**53 convert exactly), then split and cast back to
    each tensor's dtype. Returns one dict per group."""
    leaves = [t for g in groups for t in g.values()]
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for group in groups:
        fields = {}
        for name, t in group.items():
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            fields[name] = flat[at:at + t.numel()].reshape(t.shape).astype(dtype)
            at += t.numel()
        out.append(fields)
    return out


def _host_bins(b: dict) -> HostBins:
    return HostBins(**{name: v if v.ndim else v.item() for name, v in b.items()})


def _host_vectors(vecs) -> dict:
    """The RunResult's per-path fields: ``vecs``' seven vectors on the
    host (success as bool), or all None (reduced mode) for ``vecs=None``."""
    if vecs is None:
        return dict.fromkeys(VECTOR_FIELDS)
    host = {name: vecs[name].cpu().numpy() for name in VECTOR_FIELDS}
    host["success"] = host["success"] > 0.5
    return host


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
        if self.dtype == torch.float32 and n > max_device_paths():
            return self._run_chunked(working_months, n, stream, reduced,
                                     traj_len, sample_idx)
        t_start = time.perf_counter()
        full = simulate_full(
            self._pack(working_months, stream), self.statics,
            self.retirement_years, n, traj_len,
        )
        summary = summarize(full, sample_idx)
        bins = None
        if reduced:
            s, b = _fetch([summary._asdict(),
                           serving_bins(full, self.retirement_years)._asdict()])
            bins = _host_bins(b)
        else:
            s = {name: v.cpu().numpy() for name, v in summary._asdict().items()}
        host = _host_vectors(None if reduced else full)
        log.info(
            "phase=final_run device=%s paths=%d months=%d reduced=%s: %.3f s",
            self.device, n, working_months, reduced,
            time.perf_counter() - t_start,
        )
        return self._result(working_months, n, host, s, bins)

    def _result(self, working_months: int, n: int, host: dict, s: dict,
                bins: Optional[HostBins]) -> RunResult:
        """The RunResult of host vectors, summary tables and bins."""
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
    # chunked full run (beyond the device's path budget)
    # ------------------------------------------------------------------
    def _run_chunked(self, working_months: int, n: int, stream: str,
                     reduced: bool, traj_len: int,
                     sample_idx: torch.Tensor) -> RunResult:
        """A full-statistics run in chunks of ``max_device_paths()`` paths
        (the JAX ``Engine._run_chunked``, ``runner.py:820-1074``).

        Chunk c simulates global path blocks [off_c, off_c + ceil(cn/4096))
        through the full kernel's block offset, so the union of the chunks
        is the unchunked run path for path, and every statistic equals the
        unchunked run's: the headline scalars, final-balance percentiles and
        serving bins from the concatenated per-path vectors; the samples
        gathered from the chunk that holds each; the per-year tables by the
        band search of ``ops/chunked_quantiles.py``. The first pass reduces
        each chunk and brackets every target order statistic (margin
        ``chunks + 8``); each band round and the ceil pass re-simulate every
        chunk and count on the device. Each chunk's counts are copied to
        the host before the next chunk launches, so at most one chunk's
        series are live at a time.
        """
        t_start = time.perf_counter()
        R = self.retirement_years
        budget = max_device_paths()
        # (first path, paths, global block offset) of each chunk
        chunks = [(start, min(budget, n - start), start // BLOCK_PATHS)
                  for start in range(0, n, budget)]
        qs = [np.asarray(TRAJECTORY_PERCENTILES, np.float32)] * 2 + [
            np.asarray(WITHDRAWAL_RATE_PERCENTILES, np.float32)]
        t_sim = 0.0
        launches = 0

        def simulate(c):
            """Chunk c's full outputs and its three (n, C) tables with
            their masks: trajectory, real trajectory, withdrawal rate."""
            nonlocal t_sim, launches
            t0 = time.perf_counter()
            _, cn, off = chunks[c]
            full = simulate_full(
                self._pack(working_months, stream, block_offset=off),
                self.statics, R, cn, traj_len,
            )
            wr = full["withdrawal_rates"]
            tables = [(full["trajectory"], None),
                      (real_series(full["trajectory"], full["price_levels"]),
                       None),
                      (wr, ~torch.isnan(wr))]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_sim += time.perf_counter() - t0
            launches += 1
            return full, tables

        k = sample_idx.shape[0]
        samples = [torch.zeros((k, traj_len), dtype=self.dtype,
                               device=self.device) for _ in range(2)]
        margin = len(chunks) + 8
        vec_parts, wr_counts, brk_lo, brk_hi = [], 0, None, None
        for c, (start, cn, _) in enumerate(chunks):
            full, tables = simulate(c)
            vec_parts.append({name: full[name] for name in VECTOR_FIELDS})
            local = sample_idx - start
            rows = torch.clamp(local, 0, cn - 1)
            inside = ((local >= 0) & (local < cn))[:, None]
            for i in range(2):
                samples[i] = torch.where(inside, tables[i][0][rows], samples[i])
            cnt_c = tables[2][1].sum(dim=0).cpu().numpy()
            wr_counts = wr_counts + cnt_c
            lo_vals, hi_vals = [], []
            for (x, valid), q, nv in zip(
                    tables, qs, [np.full(traj_len, cn)] * 2 + [cnt_c]):
                lo_r, hi_r = bracket_ranks(q, nv, margin)
                both = floor_values(
                    x, np.concatenate([lo_r, hi_r], axis=1), valid
                ).cpu().numpy()
                # An empty column counts nothing: its statistics stay out.
                empty = (nv == 0)[:, None]
                lo_vals.append(np.where(empty, np.inf, both[:, :len(q)]))
                hi_vals.append(np.where(empty, -np.inf, both[:, len(q):]))
            if brk_lo is None:
                brk_lo, brk_hi = lo_vals, hi_vals
            else:
                brk_lo = [np.minimum(a, b) for a, b in zip(brk_lo, lo_vals)]
                brk_hi = [np.maximum(a, b) for a, b in zip(brk_hi, hi_vals)]
            del full, tables

        all_paths = np.full(traj_len, n, dtype=np.int64)
        search = BandSearch(qs, [all_paths, all_paths, wr_counts],
                            edges_per_rank=BAND_EDGES)
        search.seed_intervals(brk_lo, brk_hi)

        def accumulate(count, merge):
            """One pass over the chunks: ``count(x, valid, i)`` per table
            on the device, merged on the host by ``merge(acc, part)``."""
            acc = None
            for c in range(len(chunks)):
                _, tables = simulate(c)
                part = [count(x, valid, i)
                        for i, (x, valid) in enumerate(tables)]
                acc = part if acc is None else [merge(a, p)
                                                for a, p in zip(acc, part)]
                del tables
            return acc

        while not search.resolved:
            edges = [torch.as_tensor(e, device=self.device)
                     for e in search.edges()]
            search.update(accumulate(
                lambda x, valid, i: count_le(x, edges[i], valid).cpu().numpy(),
                np.add))
        v_lo = [torch.as_tensor(v, device=self.device)
                for v in search.floor_values()]
        ceil = accumulate(
            lambda x, valid, i: [t.cpu().numpy()
                                 for t in ceil_stats(x, v_lo[i], valid)],
            lambda a, p: [a[0] + p[0], np.minimum(a[1], p[1])])
        traj_pcts, real_pcts, wr_pcts = search.interpolate(
            [c[0] for c in ceil], [c[1] for c in ceil])

        vecs = {name: torch.cat([p[name] for p in vec_parts])
                for name in VECTOR_FIELDS}
        del vec_parts
        (success_prob, median_start, median_final, swr,
         final_pcts) = vector_summary(
            vecs["success"], vecs["final_balance"], vecs["start_balance"],
            vecs["first_year_real_gross"])
        summary = dict(
            success_probability=success_prob,
            median_start_balance=median_start,
            median_final_successful=median_final, swr=swr,
            final_balance_percentiles=final_pcts,
            sample_trajectories=samples[0], sample_real_trajectories=samples[1],
        )
        bins = None
        if reduced:
            s, b = _fetch([summary, serving_bins(vecs, r_years=R)._asdict()])
            bins = _host_bins(b)
        else:
            (s,) = _fetch([summary])
        host = _host_vectors(None if reduced else vecs)
        s.update(trajectory_percentiles=traj_pcts,
                 real_trajectory_percentiles=real_pcts,
                 wr_percentiles=wr_pcts, wr_observation_counts=wr_counts)
        wall = time.perf_counter() - t_start
        stats = {"chunks": len(chunks), "band_passes": search.rounds + 1,
                 "full_launches": launches, "wall_s": wall,
                 "simulation_s": t_sim, "count_s": wall - t_sim}
        log.info(
            "phase=final_run device=%s paths=%d months=%d reduced=%s "
            "chunks=%d band_passes=%d full_launches=%d: %.3f s "
            "(simulation %.3f s)",
            self.device, n, working_months, reduced, len(chunks),
            stats["band_passes"], launches, wall, t_sim,
            extra={"chunked": stats},
        )
        return self._result(working_months, n, host, s, bins)

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
