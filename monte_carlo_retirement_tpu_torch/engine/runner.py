"""Engine: seeds, candidate batching, device placement and result assembly.

Counterpart of the JAX package's ``engine/runner.py`` for one torch device
or a paths mesh of several (``parallel/mesh.py``). ``probe`` pads every
candidate batch to ``PROBE_WIDTH`` and runs the probe kernel (the plain
version on the CPU); above ``max_probe_paths()`` (per shard) it splits the
paths into chunks of whole 4096-path blocks by global block offset, which
draws exactly the shocks of one dispatch, and merges the survivor counts.
``run`` is the full-statistics run: the full kernel, then the summary
reductions on the same device, then the tables and per-path vectors to the
host; with ``reduced=True`` (the serving path) the per-path vectors stay on
the device, the dashboard's histograms are reduced there too
(``ops/stats.serving_bins``), and the tables and bins cross to the host in
one copy. A float32 run above ``max_device_paths()`` is split into chunks
of whole blocks: the union of the chunks is the unchunked run path for
path, and every statistic equals the unchunked run's (the per-year tables
through ``ops/chunked_quantiles.py``, ``_run_banded``).

Over a mesh (``Engine(mesh=...)`` or ``MCRT_MESH=auto``) every launch is
the sharded one (``engine/sharded.py``). A float32 run treats each shard as
one resident chunk of the band search: its series stay on its device, the
counts are summed over shards and processes, and only the seven per-path
vectors are gathered. A float64 run (the CPU's plain versions, whose
shards share the host's memory) gathers the shards' outputs and reduces
them as one run. Either way every field equals the mesh-less run's, and
every process of a group returns the same result.

Backends (the JAX ``_BACKENDS``, argument ``backend=`` or the
``MCRT_PROBE_BACKEND`` / ``MCRT_RUN_BACKEND`` knobs): "pallas" is the
kernels on one device (their plain versions on the CPU), "pallas_sharded"
the sharded launches over the mesh, "scan" the JAX scan engine
(``engine/kernel.simulate_paths``: the threefry keys ``search_key`` and
``final_key`` of ``stream_keys(main_seed)``, JAX's ``_probe_impl`` and
``_run_impl``; never chunked; over a mesh each shard draws its own global
rows and the shards' outputs are gathered, so every field equals the
mesh-less scan's). "auto" takes the scan for a float64 engine on the card,
as JAX does, and the (sharded) kernels otherwise, on the CPU too, where
JAX's auto is the scan.

Stream seeds and sample rows follow the JAX engine's rules
(``runner.py:463-470, 654-658``), so both packages pick the same seeds and
sample paths for a given main seed. There is no compile cache and no
trajectory-width cap here: the width is ``1 + t_scan // 12``.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
from ..ops.shocks import BLOCK_PATHS, stream_keys
from ..ops.stats import real_series, serving_bins, summarize, vector_summary
from ..parallel import distributed
from ..parallel.mesh import (
    PathMesh,
    Shard,
    local_device_count,
    make_mesh,
    mesh_device,
)
from ..timing import expected_trajectory_length
from ..utils import profiling
from .cuda_kernel import (
    VECTOR_FIELDS,
    body_steps_all,
    pack_params,
    probe as probe_kernel,
    record_steps,
    require_device,
    simulate_full,
    statics_from_config,
)
from .kernel import scan_rows
from .sharded import gather_paths, probe_sharded, simulate_full_sharded

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
    float32 run above it is split into chunks (``Engine._run_banded``)."""
    budget = int(os.environ.get("MCRT_MAX_DEVICE_PATHS",
                                str(DEFAULT_MAX_DEVICE_PATHS)))
    return max(BLOCK_PATHS, budget // BLOCK_PATHS * BLOCK_PATHS)


def _round_up(value: int, multiple: int) -> int:
    return max(multiple, ((value + multiple - 1) // multiple) * multiple)


class _Chunk(NamedTuple):
    """One pass unit of ``Engine._run_banded``: ``paths`` real paths over
    every process, launched as ``launch`` paths on each local shard."""

    paths: int
    launch: int
    shards: Tuple[Shard, ...]


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
    with profiling.span("card.sync", what="final"):
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


def _to_host(value):
    """A tensor, or a tuple of tensors, as numpy."""
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return [v.cpu().numpy() for v in value]


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
    """Monte Carlo engine for one scenario on one torch device or a mesh.

    ``device="cuda"`` runs the CUDA kernels in float32 (a float64 engine
    there runs the scan) and raises when no card is present;
    ``device="cpu"`` runs the plain versions (float64 by default).
    ``mesh`` (a ``parallel.mesh.PathMesh`` of the same kind of
    device) shards every launch's paths over its devices; with
    ``MCRT_MESH`` set to ``auto``, ``local`` or ``1`` and no mesh passed,
    the engine takes a mesh over every local device of its kind (the
    cards, or ``MCRT_LOCAL_DEVICE_COUNT`` CPU shards) when there is more
    than one — how hosts that build mesh-less engines scale out.
    """

    def __init__(
        self,
        config: Config,
        main_seed_override: Optional[int] = None,
        dtype=None,
        device="cuda",
        mesh: Optional[PathMesh] = None,
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
        if mesh is None and os.environ.get("MCRT_MESH", "").lower() in (
                "auto", "local", "1"):
            auto = make_mesh(None if torch.device(device).type == "cuda"
                             else ["cpu"] * local_device_count())
            mesh = auto if auto.size > 1 else None
        self.device = mesh_device(mesh, device)
        self.mesh = mesh
        if dtype is None:
            dtype = torch.float32 if self.device.type == "cuda" else torch.float64
        self.dtype = dtype
        # The scan engine's threefry roots (the JAX Engine's keys).
        self.search_key, self.final_key = stream_keys(self.main_seed)
        self.retirement_years = int(self.config.retirement_years)
        self.statics = statics_from_config(self.config)
        self.params = SimParams.from_config(
            self.config, dtype=torch.float64, device=self.device
        )
        log.info(
            "Engine initialized for scenario '%s' on %s%s with main seed: %d",
            self.config.Nickname, self.device,
            f" (mesh of {mesh.size} shards)" if mesh else "", self.main_seed,
        )

    def _key(self, stream: str):
        if stream == "search":
            return self.search_key
        if stream == "final":
            return self.final_key
        raise ValueError(f"Unknown seed stream '{stream}'")

    _BACKENDS = ("auto", "scan", "pallas", "pallas_sharded")

    def _validate_backend(self, backend: str, kind: str) -> str:
        if backend not in self._BACKENDS:
            raise ValueError(
                f"Unknown {kind} backend {backend!r}; expected one of "
                f"{self._BACKENDS}"
            )
        if backend == "pallas_sharded" and self.mesh is None:
            raise ValueError(
                "backend 'pallas_sharded' needs an Engine mesh "
                "(Engine(..., mesh=make_mesh()))"
            )
        return backend

    def _resolve_backend(self, backend: Optional[str], kind: str) -> str:
        """``backend``, else ``MCRT_PROBE_BACKEND`` / ``MCRT_RUN_BACKEND``,
        else auto: the scan for a float64 engine on the card (the kernels
        run float32), otherwise the kernels (their plain versions on the
        CPU), sharded over the Engine's mesh when it has one."""
        backend = self._validate_backend(
            backend or os.environ.get(f"MCRT_{kind.upper()}_BACKEND", "auto"),
            kind)
        if backend != "auto":
            return backend
        if self.device.type == "cuda" and self.dtype != torch.float32:
            return "scan"
        return "pallas" if self.mesh is None else "pallas_sharded"

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

    def _pack(self, months, stream: str, block_offset: int = 0, device=None):
        return pack_params(
            self.params, self._stream_seed(stream), months,
            self.retirement_years, block_offset=block_offset,
            dtype=self.dtype, device=self.device if device is None else device,
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
        backend: Optional[str] = None,
    ) -> List[float]:
        """Success probability (percent) for each working-month candidate;
        candidates share their shocks (common random numbers). ``backend``
        (``_BACKENDS``, default ``MCRT_PROBE_BACKEND`` or auto): "pallas"
        the probe kernel on one device, "pallas_sharded" over the mesh,
        "scan" the threefry scan of ``_probe_scan``."""
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
        t_scan = self._t_scan(int(horizon_months or max(months)))
        probe_backend = self._resolve_backend(backend, "probe")
        out: List[float] = []
        for i in range(0, len(months), PROBE_WIDTH):
            chunk = months[i : i + PROBE_WIDTH]
            padded = chunk + [chunk[-1]] * (PROBE_WIDTH - len(chunk))
            if probe_backend == "scan":
                counts, simulated = self._probe_scan(padded, stream, n_total,
                                                     t_scan)
            elif probe_backend == "pallas":
                counts, simulated = self._probe_counts(padded, stream, n_total)
            else:
                counts, simulated = self._probe_counts_mesh(padded, stream,
                                                            n_total)
            # Merge over chunks as exact counts: the path-weighted mean.
            pct = counts.astype(np.float64) / simulated * 100.0
            out.extend(float(v) for v in pct[: len(chunk)])
        return out

    # ------------------------------------------------------------------
    # the scan backend (threefry keys, the plain loop's month body)
    # ------------------------------------------------------------------
    def _scan_shards(self, n: int) -> Tuple[int, Tuple[Shard, ...]]:
        """Rows per shard and this process's shards of an n-path scan: one
        shard of n rows without a mesh; over a mesh its plan's shards
        (``PathMesh.plan``: whole 4096-path blocks of consecutive global
        paths, ``paths`` of them real)."""
        if self.mesh is None:
            return n, (Shard(self.device, 0, n, 0),)
        plan = self.mesh.plan(n)
        return plan.local_pad, plan.shards

    def _scan_kwargs(self, n: int, shard: Shard) -> dict:
        return dict(n_paths=n, retirement_years=self.retirement_years,
                    dtype=self.dtype, antithetic=self.statics.antithetic,
                    jumps=self.statics.jumps, mortality=self.statics.mortality,
                    row_offset=shard.start, device=shard.device)

    def _probe_scan(self, padded: List[int], stream: str, n_total: int,
                    t_scan: int):
        """Survivors per candidate over exactly ``n_total`` paths of the
        threefry scan (the JAX ``_probe_impl``: every candidate on the
        stream's same keys), counted exactly; over a mesh each shard draws
        its own global rows and the counts are summed."""
        per, shards = self._scan_shards(n_total)
        parts = []
        for s in shards:
            rows = scan_rows(self.params, padded, self._key(stream),
                             t_scan=t_scan, **self._scan_kwargs(per, s))
            survivors = (rows["success"][:, :s.paths] > 0.5).sum(dim=1)
            parts.append(torch.stack((survivors, rows["steps"])))
        tally = sum(p.cpu() for p in parts)
        record_steps("scan", tally[1].sum(), len(shards) * body_steps_all(
            len(padded), per, self.retirement_years))
        counts = tally[0]
        if self.mesh is not None and self.mesh.grouped:
            counts = distributed.all_reduce(counts, "sum")
        return counts.numpy(), n_total

    def _full_scan(self, working_months: int, n: int, stream: str,
                   traj_len: int) -> dict:
        """The tracked threefry scan (the JAX ``_run_impl``'s
        ``simulate_paths``) as the full kernel's dict on this engine's
        device; over a mesh each shard draws its own global rows and the
        shards' outputs are gathered in global order, so every field
        equals the mesh-less scan's."""
        per, shards = self._scan_shards(n)
        t_scan = self._t_scan(working_months)
        outs = [scan_rows(self.params, [working_months], self._key(stream),
                          t_scan=t_scan, traj_len=traj_len,
                          **self._scan_kwargs(per, s)) for s in shards]
        if self.mesh is None:
            return outs[0]
        return {name: gather_paths([o[name] for o in outs], self.mesh)[:n]
                for name in outs[0]}

    def _probe_counts(self, padded: List[int], stream: str, n_total: int):
        """Survivors per candidate over exactly ``n_total`` paths, in
        launches of at most ``max_probe_paths()``; the launches' body steps,
        and under longevity their decided steps, come back in the same copy
        (``cuda_kernel.BODY_STEPS``)."""
        budget = max(BLOCK_PATHS, (max_probe_paths() // BLOCK_PATHS) * BLOCK_PATHS)
        tally, offset, steps_all = None, 0, 0
        for start in range(0, n_total, budget):
            cn = min(budget, n_total - start)
            out = probe_kernel(
                self._pack(padded, stream, block_offset=offset),
                self.statics, self.retirement_years, cn,
            )
            # A wrapper of the kernel may hand back its counts alone.
            rows = [out.counts]
            if out.steps is not None:
                rows += [out.steps] + ([] if out.decided is None else [out.decided])
            part = torch.stack(rows)
            tally = part if tally is None else tally + part
            steps_all += body_steps_all(len(padded), cn, self.retirement_years)
            offset += -(-cn // BLOCK_PATHS)
        with profiling.span("card.sync", what="probe") as sync:
            tally = tally.cpu().numpy()
            if len(tally) > 1:
                decided = tally[2].sum() if len(tally) > 2 else None
                sync.set(**record_steps("probe", tally[1].sum(), steps_all, decided))
        return tally[0], n_total

    def _probe_counts_mesh(self, padded: List[int], stream: str, n_total: int):
        """Survivors per candidate over every path the mesh simulates (the
        sharded probe's padded count), in mesh-sized launches of at most
        ``n_dev * max_probe_paths()`` over contiguous global blocks
        (``runner.py:549-603``); the merge weighs each launch by its
        simulated count, which exact counts do by themselves."""
        n_dev = self.mesh.size
        unit = n_dev * BLOCK_PATHS
        budget = max(unit, (n_dev * max_probe_paths() // unit) * unit)
        counts, simulated = 0, 0
        for start in range(0, n_total, budget):
            part = probe_sharded(
                self.params, self._stream_seed(stream), padded,
                self.retirement_years, min(budget, n_total - start),
                self.statics, mesh=self.mesh,
                block_offset=simulated // BLOCK_PATHS, dtype=self.dtype,
            )
            counts = counts + part.counts
            simulated += part.simulated
        return counts, simulated

    # ------------------------------------------------------------------
    # full run with all statistics
    # ------------------------------------------------------------------
    @profiling.traced("plan.final")
    def run(
        self, working_months: int, num_simulations: int, stream: str = "final",
        backend: Optional[str] = None, reduced: bool = False,
    ) -> RunResult:
        """One full-statistics batch. ``reduced=True`` keeps the per-path
        vectors on the device and reduces the dashboard's histograms there
        too; the host gets the tables and bins only. ``backend`` as in
        :meth:`probe` (default ``MCRT_RUN_BACKEND`` or auto); the scan
        never chunks."""
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
        run_backend = self._resolve_backend(backend, "run")
        if run_backend == "pallas" and self.mesh is not None:
            # The kernels on this engine's device alone.
            single = copy.copy(self)
            single.mesh = None
            return single.run(working_months, n, stream, "pallas", reduced)
        if run_backend != "scan" and self.dtype == torch.float32 and (
                self.mesh is not None or n > max_device_paths()):
            return self._run_banded(working_months, n, stream, reduced,
                                    traj_len, sample_idx)
        t_start = time.perf_counter()
        if run_backend == "scan":
            full = self._full_scan(working_months, n, stream, traj_len)
        elif self.mesh is None:
            full = simulate_full(
                self._pack(working_months, stream), self.statics,
                self.retirement_years, n, traj_len,
            )
        else:
            full = simulate_full_sharded(
                self.params, self._stream_seed(stream), working_months,
                self.retirement_years, n, traj_len, self.statics,
                mesh=self.mesh, dtype=self.dtype,
            )
            full = {name: v[:n] for name, v in full.items()}
        summary = summarize(full, sample_idx)
        bins = None
        if reduced:
            s, b = _fetch([summary._asdict(),
                           serving_bins(full, self.retirement_years)._asdict()])
            bins = _host_bins(b)
        else:
            with profiling.span("card.sync", what="final"):
                s = {name: v.cpu().numpy()
                     for name, v in summary._asdict().items()}
        host = _host_vectors(None if reduced else full)
        log.info(
            "phase=final_run backend=%s device=%s paths=%d months=%d "
            "reduced=%s: %.3f s", run_backend, self.device, n, working_months,
            reduced, time.perf_counter() - t_start,
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
    # banded full run: chunks beyond the device's path budget, mesh shards
    # ------------------------------------------------------------------
    def _chunks(self, n: int) -> Tuple[List[_Chunk], bool]:
        """The pass units of a banded run and whether they stay resident.

        Mesh-less: chunks of ``max_device_paths()`` paths, chunk c on the
        global blocks from ``start // 4096`` (the JAX ``_run_chunked``,
        ``runner.py:820-889``), re-simulated on every pass. Over a mesh:
        one launch of every shard, resident, up to ``n_dev *
        max_device_paths()`` paths; beyond that mesh-sized chunks whose
        sizes are multiples of ``n_dev * 4096``, so the global block
        numbering stays contiguous (``runner.py:853-868``)."""
        budget = max_device_paths()
        if self.mesh is None:
            return [_Chunk(min(budget, n - start), min(budget, n - start),
                           (Shard(self.device, start, min(budget, n - start),
                                  start // BLOCK_PATHS),))
                    for start in range(0, n, budget)], False
        n_dev = self.mesh.size
        unit = n_dev * BLOCK_PATHS
        resident = n <= n_dev * budget
        step = n if resident else max(unit, (n_dev * budget // unit) * unit)
        chunks, offset = [], 0
        for start in range(0, n, step):
            cn = min(step, n - start)
            plan = self.mesh.plan(cn, block_offset=offset, start=start)
            chunks.append(_Chunk(cn, plan.local_pad, plan.shards))
            offset += plan.simulated // BLOCK_PATHS
        return chunks, resident

    def _run_banded(self, working_months: int, n: int, stream: str,
                    reduced: bool, traj_len: int,
                    sample_idx: torch.Tensor) -> RunResult:
        """A float32 full-statistics run whose per-year tables come from the
        band search of ``ops/chunked_quantiles.py`` over pass units
        (``_chunks``): the chunks of a run beyond the device's path budget
        (the JAX ``Engine._run_chunked``, ``runner.py:820-1074``) and the
        shards of a mesh.

        Every unit simulates its global path blocks through the full
        kernel's block offset, so their union is the unchunked single-device
        run path for path, and every statistic equals that run's: the
        headline scalars, final-balance percentiles and serving bins from
        the per-path vectors, gathered in global order; the samples from the
        shard that holds each; the per-year tables by the band search. The
        first pass reduces each shard and brackets every target order
        statistic (margin: shards + 8); each band round and the ceil pass
        count on the device where the shard's series lie, then sum over the
        shards and the processes. A resident unit (a mesh run within
        ``n_dev * max_device_paths()``) keeps its series on its device
        between passes; a chunk is re-simulated for each pass and its counts
        are copied to the host before the next chunk launches, so at most
        one chunk's series are live at a time.
        """
        t_start = time.perf_counter()
        R = self.retirement_years
        dev = self.device
        chunks, resident = self._chunks(n)
        qs = [np.asarray(TRAJECTORY_PERCENTILES, np.float32)] * 2 + [
            np.asarray(WITHDRAWAL_RATE_PERCENTILES, np.float32)]
        t_sim = 0.0
        launches = 0

        def simulate(chunk):
            """The chunk's shards launched (all before any read): each
            shard's full outputs, and for a shard with real paths its three
            (paths, C) tables with their masks: trajectory, real trajectory,
            withdrawal rate."""
            nonlocal t_sim, launches
            t0 = time.perf_counter()
            outs = [(s, simulate_full(
                self._pack(working_months, stream, s.block_offset, s.device),
                self.statics, R, chunk.launch, traj_len)) for s in chunk.shards]
            parts = []
            for s, full in outs:
                if s.paths:
                    p = s.paths
                    traj, wr = full["trajectory"][:p], full["withdrawal_rates"][:p]
                    parts.append((s, [
                        (traj, None),
                        (real_series(traj, full["price_levels"][:p]), None),
                        (wr, ~torch.isnan(wr))]))
            for d in {s.device for s in chunk.shards if s.device.type == "cuda"}:
                torch.cuda.synchronize(d)
            t_sim += time.perf_counter() - t0
            launches += len(outs)
            return outs, parts

        k = sample_idx.shape[0]
        samples = [torch.zeros((k, traj_len), dtype=self.dtype, device=dev)
                   for _ in range(2)]
        owned = torch.zeros(k, dtype=torch.bool, device=dev)
        margin = len(chunks) * (self.mesh.size if self.mesh else 1) + 8
        cols = [traj_len, traj_len, R]
        brk_lo = [np.full((c, len(q)), np.inf, np.float32)
                  for c, q in zip(cols, qs)]
        brk_hi = [np.full((c, len(q)), -np.inf, np.float32)
                  for c, q in zip(cols, qs)]
        wr_counts = np.zeros(R, dtype=np.int64)
        vec_parts, kept = [], []
        for chunk in chunks:
            outs, parts = simulate(chunk)
            vec_parts.append({
                name: self._gather([full[name] for _, full in outs])[:chunk.paths]
                for name in VECTOR_FIELDS})
            for s, tables in parts:
                local = sample_idx.to(s.device) - s.start
                rows = torch.clamp(local, 0, s.paths - 1)
                inside = ((local >= 0) & (local < s.paths)).to(dev)
                owned |= inside
                for i in range(2):
                    samples[i] = torch.where(
                        inside[:, None], tables[i][0][rows].to(dev), samples[i])
                cnt_s = tables[2][1].sum(dim=0).cpu().numpy()
                wr_counts += cnt_s
                for i, ((x, valid), q, nv) in enumerate(zip(
                        tables, qs, [np.full(traj_len, s.paths)] * 2 + [cnt_s])):
                    lo_r, hi_r = bracket_ranks(q, nv, margin)
                    both = floor_values(
                        x, np.concatenate([lo_r, hi_r], axis=1), valid
                    ).cpu().numpy()
                    # An empty column counts nothing: its statistics stay out.
                    empty = (nv == 0)[:, None]
                    brk_lo[i] = np.minimum(brk_lo[i], np.where(
                        empty, np.float32(np.inf), both[:, :len(q)]))
                    brk_hi[i] = np.maximum(brk_hi[i], np.where(
                        empty, np.float32(-np.inf), both[:, len(q):]))
            kept.append(parts if resident else None)
            del outs, parts

        wr_counts = self._reduce(wr_counts)
        brk_lo = [self._reduce(b, "min") for b in brk_lo]
        brk_hi = [self._reduce(b, "max") for b in brk_hi]
        samples = self._gather_samples(samples, owned)
        all_paths = np.full(traj_len, n, dtype=np.int64)
        search = BandSearch(qs, [all_paths, all_paths, wr_counts],
                            edges_per_rank=BAND_EDGES)
        search.seed_intervals(brk_lo, brk_hi)

        def accumulate(count, acc, merge):
            """One pass over the units: ``count(x, valid, i)`` per table,
            launched on every shard of a unit before its results are copied
            to the host and merged into ``acc`` by ``merge(acc, part)``."""
            for c, chunk in enumerate(chunks):
                parts = kept[c] if resident else simulate(chunk)[1]
                launched = [[count(x, valid, i)
                             for i, (x, valid) in enumerate(tables)]
                            for _, tables in parts]
                for shard in launched:
                    acc = [merge(a, _to_host(p)) for a, p in zip(acc, shard)]
                del parts, launched
            return acc

        on_device = {}

        def placed(values, device):
            """``values`` (host arrays, one per table) on ``device``, once
            per pass."""
            if device not in on_device:
                on_device[device] = [torch.as_tensor(v, device=device)
                                     for v in values]
            return on_device[device]

        while not search.resolved:
            edges = search.edges()
            on_device.clear()
            totals = accumulate(
                lambda x, valid, i: count_le(x, placed(edges, x.device)[i],
                                             valid),
                [np.zeros(e.shape, dtype=np.int64) for e in edges], np.add)
            search.update([self._reduce(t) for t in totals])
        v_lo = search.floor_values()
        on_device.clear()
        ceil = accumulate(
            lambda x, valid, i: ceil_stats(x, placed(v_lo, x.device)[i], valid),
            [[np.zeros(v.shape, dtype=np.int64),
              np.full(v.shape, np.inf, np.float32)] for v in v_lo],
            lambda a, p: [a[0] + p[0], np.minimum(a[1], p[1])])
        traj_pcts, real_pcts, wr_pcts = search.interpolate(
            [self._reduce(c[0]) for c in ceil],
            [self._reduce(c[1], "min") for c in ceil])
        del kept

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
        stats = {"chunks": len(chunks), "resident": resident,
                 "shards": self.mesh.size if self.mesh else 1,
                 "band_passes": search.rounds + 1,
                 "full_launches": launches, "wall_s": wall,
                 "simulation_s": t_sim, "count_s": wall - t_sim}
        log.info(
            "phase=final_run device=%s paths=%d months=%d reduced=%s "
            "chunks=%d shards=%d band_passes=%d full_launches=%d: %.3f s "
            "(simulation %.3f s)",
            self.device, n, working_months, reduced, len(chunks),
            stats["shards"], stats["band_passes"], launches, wall, t_sim,
            extra={"chunked": stats},
        )
        return self._result(working_months, n, host, s, bins)

    def _gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Local shards' per-path vectors joined on this engine's device in
        global order, over the processes of the mesh's group."""
        if self.mesh is None:
            return torch.cat(parts)
        return gather_paths(parts, self.mesh)

    def _reduce(self, arr: np.ndarray, op: str = "sum") -> np.ndarray:
        """A host array reduced over the processes of the mesh's group."""
        if self.mesh is None or not self.mesh.grouped:
            return arr
        return distributed.all_reduce(
            torch.from_numpy(np.ascontiguousarray(arr)), op).numpy()

    def _gather_samples(self, samples: List[torch.Tensor],
                        owned: torch.Tensor) -> List[torch.Tensor]:
        """Each sample row from the process whose shard holds it."""
        if self.mesh is None or not self.mesh.grouped:
            return samples
        rows = distributed.all_gather(torch.cat(samples, dim=1))
        owners = distributed.all_gather(owned.to(torch.uint8))
        pick = torch.stack(owners).argmax(dim=0)
        both = torch.stack(rows)[pick, torch.arange(owned.shape[0],
                                                    device=owned.device)]
        return list(both.split(samples[0].shape[1], dim=1))

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
