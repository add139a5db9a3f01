"""Scenario batches: configs as launches of the grid kernel.

Counterpart of the JAX package's ``engine/scenario_batch.py``.

``run_scenario_grid`` (JAX lines 255-392): a grid is K configs that share
their compile-time ``Statics`` and ``retirement_years``; their parameters
are stacked (``stack_params``) into one (K, F.NUM + 5*S) block, one row per
scenario (``cuda_kernel.pack_grid``), and each chunk of rows is one launch
of the grid kernel (``cuda_kernel.grid``; its plain version on the CPU), or
with ``mesh=`` one sharded launch (``engine/sharded.grid_raw_sharded``).
Shocks depend only on (stream seed, path block, month, lane), never on the
row, so the whole grid shares them (common random numbers) and chunking
never changes a result. After each launch the per-scenario statistics
(``_grid_stats``) are reduced on the device and only a (K, 9) table leaves
it. Launches are asynchronous on the card, so the host packs and launches
chunk i+1 before it copies chunk i's table back (an in-flight window of
``MCRT_GRID_WINDOW`` chunks).

``run_scenario_grid(backend="scan")`` runs JAX's scan branch instead:
each chunk through ``run_scenario_batch(backend="scan")`` in float32, as
JAX's grid does.

``run_scenario_batch`` (JAX lines 74-161) takes a batch whose rows may mix
tax systems, crashes and longevity. By default the port groups the rows by
``Statics`` and launches each group on its own build of the grid kernel.
The draws depend only on (seed, block, month, lane), and a disabled
feature compiles out without moving them, so the groups share their
shocks as one launch's rows would. ``backend="scan"`` is JAX's own route
(``_batch_impl``): threefry scans of every row on the final stream's key,
with the crash and longevity draws on for the whole batch when any row
has them (a row without them takes the rules' no-op sentinels), so on
the same seed every row equals JAX's to round-off.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..models.retirement import stack_params
from ..ops.quantiles import exact_quantiles
from ..ops.shocks import stream_keys
from ..parallel.mesh import PathMesh, mesh_device
from ..utils import profiling
from .cuda_kernel import (
    Statics,
    body_steps_all,
    check_grid_statics,
    grid,
    pack_grid,
    record_steps,
    require_device,
    statics_from_config,
)
from .kernel import scan_rows, scan_statics
from .sharded import grid_raw_sharded

__all__ = [
    "GRID_FINAL_PERCENTILES",
    "ScenarioBatchResult",
    "grid_statics",
    "run_scenario_batch",
    "run_scenario_grid",
    "stack_params",
]

log = logging.getLogger("mcrt.grid")

# Decision-grade per-scenario final-balance bands (grid serving payload).
GRID_FINAL_PERCENTILES = (0.05, 0.25, 0.50, 0.75, 0.95)


class ScenarioBatchResult(NamedTuple):
    success_probability: np.ndarray  # (k,) percent
    median_final_balance: np.ndarray  # (k,)
    mean_final_balance: np.ndarray  # (k,)
    success_sigma: np.ndarray  # (k,) one-sigma binomial MC error, percent
    final_balance_percentiles: np.ndarray  # (k, 5) at GRID_FINAL_PERCENTILES

    def concat(self, other: "ScenarioBatchResult") -> "ScenarioBatchResult":
        return ScenarioBatchResult(
            *(np.concatenate([a, b]) for a, b in zip(self, other))
        )


def grid_statics(configs: Sequence[Config]) -> Statics:
    """The shared compile-time Statics of a scenario batch.

    The grid kernel bakes tax systems and stream structure into its template
    instance, so every config of one grid must share them. Raises
    ValueError when the batch mixes them (the JAX message)."""
    statics = {statics_from_config(c) for c in configs}
    if len(statics) != 1:
        raise ValueError(
            "all configs in a scenario grid must share tax systems and "
            "stream structure (compile-time Statics); split the batch by "
            f"statics. Got {len(statics)} distinct combinations."
        )
    return next(iter(statics))


def _grid_stats(success: torch.Tensor, final: torch.Tensor, n_paths: int):
    """Per-scenario reductions of (k, n) tables on their device: success %
    and its binomial sigma, the mean final balance and the
    GRID_FINAL_PERCENTILES bands over all n paths (ruined paths keep the
    final balance the kernel gave them). Returns (p, median, mean, sigma,
    percentiles (k, 5)); success and sigma in float64, counted exactly."""
    succ = success[:, :n_paths]
    fin = final[:, :n_paths]
    p = succ.sum(dim=1, dtype=torch.float64) / n_paths * 100.0
    frac = p / 100.0
    sigma = torch.sqrt(torch.clamp(frac * (1.0 - frac), min=0.0) / n_paths) * 100.0
    mean_final = fin.mean(dim=1, dtype=torch.float64)
    # The (n, k) view of the (k, n) table: the quantiles sort its rows
    # without a copy of the input.
    pcts = exact_quantiles(fin.t(), GRID_FINAL_PERCENTILES)  # (5, k)
    return p, pcts[2], mean_final, sigma, pcts.t()


def _grid_stream_seed(seed: int) -> int:
    """Stable 31-bit Philox seed for the grid's 'final' stream — the same
    derivation as Engine._stream_seed(stream='final')."""
    state = np.random.SeedSequence([int(seed), 1]).generate_state(1)
    return int(state[0] % (2**31))


def _stats_table(stats, steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The five statistics as one (k, 9) float64 table, and with the
    launch's body ``steps`` (k,) a tenth column: one copy to host."""
    p, med, mean, sigma, pcts = stats
    cols = [p, med.to(torch.float64), mean, sigma]
    parts = [torch.stack(cols, dim=1), pcts.to(torch.float64)]
    if steps is not None:
        parts.append(steps.to(torch.float64)[:, None])
    return torch.cat(parts, dim=1)


def _from_table(table: np.ndarray) -> ScenarioBatchResult:
    return ScenarioBatchResult(
        success_probability=table[:, 0],
        median_final_balance=table[:, 1],
        mean_final_balance=table[:, 2],
        success_sigma=table[:, 3],
        final_balance_percentiles=table[:, 4:9],
    )


@profiling.traced("grid.run")
def run_scenario_grid(
    configs: Sequence[Config],
    working_months: Sequence[int],
    num_simulations: int,
    seed: int = 0,
    chunk_size: Optional[int] = None,
    device="cuda",
    mesh: Optional[PathMesh] = None,
    progress_callback: Optional[Callable[[dict], None]] = None,
    backend: Optional[str] = None,
) -> ScenarioBatchResult:
    """Serve a whole scenario grid: chunked launches + progress.

    Chunks of ``chunk_size`` scenarios (default ``MCRT_GRID_CHUNK``, 16)
    run as one launch each of the grid kernel on ``device="cuda"`` (float32;
    raises without a card) or of its plain version on ``device="cpu"``
    (float64); with ``mesh`` (of ``device``'s kind) as one sharded launch
    over its shards, the statistics then reduced over the first
    ``num_simulations`` paths on the mesh's first device.
    ``progress_callback`` receives a ``grid_chunk`` event (``done``,
    ``total``, ``elapsed_s``) after each chunk is collected. Shocks are
    shared across the WHOLE grid, so chunking preserves CRN.

    ``backend`` (default ``MCRT_GRID_BACKEND``, else "auto"): "pallas" the
    grid kernel on one device, "pallas_sharded" over ``mesh``, "scan" the
    JAX scan branch (each chunk through ``run_scenario_batch(backend=
    "scan")`` in float32, on ``device``, the mesh unused); "auto" is
    "pallas_sharded" with a mesh and "pallas" without, on either device.
    """
    configs = list(configs)
    working_months = [int(m) for m in working_months]
    if len(working_months) != len(configs):
        raise ValueError("working_months must align with configs")
    if not configs:
        raise ValueError("scenario grid needs at least one config")
    if any(m < 0 for m in working_months):
        raise ValueError("working_months must be >= 0")
    statics = grid_statics(configs)  # raises on mixed structure
    device = mesh_device(mesh, device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    if backend is None:
        backend = os.environ.get("MCRT_GRID_BACKEND", "auto")
    if backend == "auto":
        backend = "pallas" if mesh is None else "pallas_sharded"
    if backend not in ("scan", "pallas", "pallas_sharded"):
        raise ValueError(f"unknown grid backend {backend!r}")
    if backend == "pallas_sharded" and mesh is None:
        raise ValueError("grid backend 'pallas_sharded' needs a mesh")
    R = configs[0].retirement_years
    n = int(num_simulations)
    if n < 1:
        raise ValueError(f"num_simulations must be >= 1, got {n}")
    if chunk_size is None:
        chunk_size = int(os.environ.get("MCRT_GRID_CHUNK", "16"))
    chunk_size = max(1, int(chunk_size))
    # Device-memory guard: one launch holds two (k, n) float tables plus
    # the sort's copies, so bound k x n cells per launch by shrinking the
    # chunk. Chunking is exact under grid-wide CRN; the in-flight window
    # below holds up to window + 1 launches live.
    cell_budget = int(
        os.environ.get("MCRT_GRID_CELL_BUDGET", str(256 * 1024 * 1024))
    )
    chunk_size = max(1, min(chunk_size, cell_budget // n))
    window = max(0, int(os.environ.get("MCRT_GRID_WINDOW", "2")))
    stream_seed = _grid_stream_seed(seed)
    horizon = max(working_months) + 12 * R  # the scan's one horizon

    total = len(configs)
    done = 0
    t0 = time.perf_counter()
    parts: List[ScenarioBatchResult] = []
    # (k, (k, 9) table on the device, or the scan's result, the body steps
    # in range), oldest first
    pending: list = []

    def collect_one():
        nonlocal done
        k, table, steps_all = pending.pop(0)
        if not isinstance(table, ScenarioBatchResult):
            with profiling.span("card.sync", what="grid") as sync:
                host = table.cpu().numpy()
                if host.shape[1] > 9:
                    sync.set(**record_steps("grid", host[:, 9].sum(), steps_all))
            table = _from_table(host)
        parts.append(table)
        done += k
        if progress_callback is not None:
            progress_callback(
                {
                    "type": "grid_chunk",
                    "done": done,
                    "total": total,
                    "elapsed_s": round(time.perf_counter() - t0, 3),
                }
            )
        log.info(
            "phase=grid device=%s scenarios=%d/%d paths=%d: %.3f s",
            device, done, total, n, time.perf_counter() - t0,
        )

    for i in range(0, total, chunk_size):
        chunk_cfgs = configs[i : i + chunk_size]
        params = stack_params(chunk_cfgs)
        check_grid_statics(params, statics)
        months = working_months[i : i + chunk_size]
        steps_all = 0
        if backend == "scan":
            # JAX's scan branch: its run_scenario_batch at its default
            # float32, every chunk on one horizon.
            stats = run_scenario_batch(chunk_cfgs, months, n, seed=seed,
                                       t_scan=horizon, device=device,
                                       backend="scan", dtype=torch.float32)
        else:
            if backend == "pallas":
                out = grid(pack_grid(params, stream_seed, months, R,
                                     dtype=dtype, device=device), statics, R, n)
                succ, fin = out.success, out.final_balance
            else:
                out = grid_raw_sharded(params, stream_seed, months, R, n,
                                       statics, mesh=mesh, dtype=dtype)
                # The first n paths as the (k, n) table a mesh-less launch
                # gives, so the reductions see the same layout.
                succ = out.success[:, :n].contiguous()
                fin = out.final_balance[:, :n].contiguous()
            stats = _stats_table(_grid_stats(succ, fin, n), out.steps)
            steps_all = body_steps_all(len(chunk_cfgs), out.success.shape[1], R)
        pending.append((len(chunk_cfgs), stats, steps_all))
        while len(pending) > window:
            collect_one()
    while pending:
        collect_one()
    result = parts[0]
    for part in parts[1:]:
        result = result.concat(part)
    return result


def _scan_groups(configs) -> dict:
    """The scan route's groups: rows that share tax systems and stream
    kinds (the loop's structure), in the caller's order."""
    groups: dict = {}
    for i, cfg in enumerate(configs):
        st = statics_from_config(cfg)
        key = (st.use_real1, st.use_real2, st.stream_indexed, st.stream_capped)
        groups.setdefault(key, []).append(i)
    return groups


def _scan_flags(configs) -> dict:
    """The scan route's draws: crash and longevity draws for every group
    when any row has them (the batch shares ``antithetic``)."""
    return dict(
        antithetic=bool(configs[0].antithetic),
        jumps=any(c.market_crashes is not None for c in configs),
        mortality=any(c.longevity is not None for c in configs),
    )


def scan_batch_statics(configs: Sequence[Config]) -> List[Statics]:
    """The structure each group of :func:`run_scenario_batch`'s scan route
    runs under (``kernel.scan_statics`` of its stacked rows): the Statics
    of its scan kernel's libraries, one per group, to build ahead."""
    configs = list(configs)
    flags = _scan_flags(configs)
    return [scan_statics(stack_params([configs[i] for i in rows]), **flags)
            for rows in _scan_groups(configs).values()]


def run_scenario_batch(
    configs: Sequence[Config],
    working_months: Sequence[int],
    num_simulations: int,
    seed: int = 0,
    t_scan: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
) -> ScenarioBatchResult:
    """Simulate every (config, working_months) pair on the grid's shared
    shocks; the rows may mix tax systems, crashes and longevity.

    The JAX package's rules hold: ``working_months`` is per scenario, the
    configs share ``retirement_years`` and their pruned income-stream count
    (``stack_params``), a batch may not mix ``antithetic`` (the sampling
    mode pairs blocks), and ``t_scan`` (default: the longest horizon) may
    not fall below the longest horizon. Results come back in the caller's
    order.

    ``backend`` (default ``MCRT_GRID_BACKEND``, else "auto"):

    * "auto" / "pallas": each group of rows that shares its ``Statics`` is
      one launch of that Statics' grid kernel (its plain version on the
      CPU) on the Philox stream of ``run_scenario_grid``, each row equal
      to the same row run alone there. ``dtype`` (default float32 on the
      card, float64 on the CPU): the kernel runs in float32 only.
    * "scan": JAX's ``run_scenario_batch`` (``_batch_impl``): threefry
      scans of every row at its own W on ``stream_keys(seed)[1]``, over
      ``t_scan`` months, in ``dtype`` (default float32, JAX's default):
      one scan-kernel launch per group on the card, its plain chain on the
      CPU.
      The loop keeps tax systems and stream kinds as structure, so the
      rows run in groups that share them; the crash and longevity draws
      are on for every group when any row of the batch has them.
    * "pallas_sharded" raises: a batch has no mesh.
    """
    configs = list(configs)
    if len(working_months) != len(configs):
        raise ValueError("working_months must align with configs")
    months = [int(m) for m in working_months]
    stack_params(configs)  # shared retirement_years and stream count
    R = int(configs[0].retirement_years)
    horizon = max(months) + 12 * R
    t = t_scan or horizon
    if t < horizon:
        raise ValueError("t_scan below the longest scenario horizon")
    anti = {bool(c.antithetic) for c in configs}
    if len(anti) != 1:
        raise ValueError(
            "all configs in a scenario batch must share 'antithetic' "
            "(sampling mode is compile-time structure)"
        )
    n = int(num_simulations)
    if n < 1:
        raise ValueError(f"num_simulations must be >= 1, got {n}")
    if backend is None:
        backend = os.environ.get("MCRT_GRID_BACKEND", "auto")
    if backend == "auto":
        backend = "pallas"
    if backend == "pallas_sharded":
        raise ValueError("scenario batch backend 'pallas_sharded' needs a "
                         "mesh; run_scenario_batch runs on one device")
    if backend not in ("scan", "pallas"):
        raise ValueError(f"unknown grid backend {backend!r}")
    device = torch.device(device)
    if backend == "pallas" and device.type == "cuda" and dtype not in (
            None, torch.float32):
        raise ValueError(f"the grid kernel runs in float32, not {dtype}; "
                         "take backend='scan' for another dtype")
    require_device(device)
    groups: dict = {}
    if backend == "scan":
        dtype = torch.float32 if dtype is None else dtype
        groups = _scan_groups(configs)
        final_key = stream_keys(seed)[1]
        flags = _scan_flags(configs)

        def run_group(rows):
            out = scan_rows(stack_params([configs[i] for i in rows]),
                            [months[i] for i in rows], final_key, n_paths=n,
                            t_scan=t, retirement_years=R, dtype=dtype,
                            device=device, **flags)
            return _stats_table(_grid_stats(out["success"],
                                            out["final_balance"], n))
    else:
        if dtype is None:
            dtype = torch.float32 if device.type == "cuda" else torch.float64
        stream_seed = _grid_stream_seed(seed)
        for i, cfg in enumerate(configs):
            groups.setdefault(statics_from_config(cfg), []).append(i)

        def run_group(rows):
            statics = statics_from_config(configs[rows[0]])
            params = stack_params([configs[i] for i in rows])
            out = grid(pack_grid(params, stream_seed, [months[i] for i in rows],
                                 R, dtype=dtype, device=device), statics, R, n)
            # Row by row: each row's reductions see the (1, n) table that
            # row alone would give.
            return torch.cat([_stats_table(_grid_stats(
                out.success[j:j + 1], out.final_balance[j:j + 1], n))
                for j in range(len(rows))])
    # Every group launches before the first table is copied back.
    tables = [(rows, run_group(rows)) for rows in groups.values()]
    table = np.empty((len(configs), 4 + len(GRID_FINAL_PERCENTILES)))
    for rows, part in tables:
        table[rows] = part.cpu().numpy()
    log.info("phase=batch backend=%s device=%s scenarios=%d groups=%d paths=%d",
             backend, device, len(configs), len(groups), n)
    return _from_table(table)
