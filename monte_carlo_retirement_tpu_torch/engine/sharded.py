"""The month-loop kernels over a paths mesh: the five sharded launches.

Counterparts of the JAX package's ``pallas_probe_sharded``
(``pallas_kernel.py:1722``), ``pallas_simulate_sharded`` (``:1802``),
``pallas_scenario_grid_sharded`` (``:1864``),
``pallas_scenario_grid_raw_sharded`` (``:1931``) and
``pallas_simulate_full_sharded`` (``:1998``). JAX wraps each kernel in
``shard_map``; here each local shard of the mesh (``parallel/mesh.py``)
packs its own parameter block on its own device with its global block
offset (``pack_params``/``pack_grid``) and calls the kernel's wrapper in
``cuda_kernel`` at ``local_pad`` paths — the kernel on a card, its plain
version on a CPU shard. Every shard is launched before any result is read,
so the cards of a mesh run at once.

The Philox stream is a pure function of (seed, global block, month, lane),
so the shards' paths are the single-device run's paths, and JAX's
semantics hold as they are:

  * ``probe_sharded`` and ``grid_sharded`` count survivors over every
    simulated path, padding included: a launch at n paths equals a single
    launch at ``n_dev * local_pad`` paths. JAX means each shard's paths and
    ``pmean``s the means; the survivor counts here are exact integers,
    summed over the local shards and then over the processes.
  * ``simulate_sharded``, ``grid_raw_sharded`` and ``simulate_full_sharded``
    return ``n_dev * local_pad`` entries, gathered on the mesh's first
    device; their first n are the single-device run's n paths.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..models.retirement import SimParams
from ..parallel import distributed
from ..parallel.mesh import PathMesh, Shard, ShardPlan
from .cuda_kernel import (
    ProbeOut,
    SimulateOut,
    Statics,
    check_grid_statics,
    grid,
    pack_grid,
    pack_params,
    probe,
    simulate,
    simulate_full,
)


class SurvivorCounts(NamedTuple):
    """Survivors per candidate or scenario over every simulated path."""

    counts: np.ndarray  # (K,) int64
    simulated: int  # n_dev * local_pad

    @property
    def percent(self) -> np.ndarray:
        """Success probability per row, percent (float64)."""
        return self.counts.astype(np.float64) / self.simulated * 100.0


def _dtype(mesh: PathMesh, dtype):
    if dtype is not None:
        return dtype
    return torch.float32 if mesh.device.type == "cuda" else torch.float64


def _sum_counts(parts: List[torch.Tensor], mesh: PathMesh) -> np.ndarray:
    """Local shards' counts, read after every shard launched, summed, then
    summed over the processes."""
    local = sum(p.cpu() for p in parts)
    if mesh.grouped:
        local = distributed.all_reduce(local, "sum")
    return local.numpy().astype(np.int64)


def gather_paths(parts: List[torch.Tensor], mesh: PathMesh,
                  dim: int = 0) -> torch.Tensor:
    """The shards' tensors joined along their path axis ``dim`` in global
    shard order, on the mesh's first device."""
    local = torch.cat([p.to(mesh.device) for p in parts], dim=dim)
    if not mesh.grouped:
        return local
    return torch.cat(distributed.all_gather(local), dim=dim)


def _launch_per_shard(kernel, pack, params, seed, months,
                      retirement_years: int, n_paths: int, statics: Statics,
                      mesh: PathMesh, block_offset: int = 0, dtype=None
                      ) -> Tuple[ShardPlan, List[ProbeOut]]:
    """``kernel`` on every local shard at ``local_pad`` paths, each shard's
    block packed by ``pack`` on its device with its global block offset."""
    plan = mesh.plan(n_paths, block_offset=block_offset)
    outs = [
        kernel(pack(params, seed, months, retirement_years,
                    block_offset=s.block_offset, dtype=_dtype(mesh, dtype),
                    device=s.device),
               statics, retirement_years, plan.local_pad)
        for s in plan.shards
    ]
    return plan, outs


def probe_sharded(params: SimParams, seed: int, months, retirement_years: int,
                  n_paths: int, statics: Statics, *, mesh: PathMesh,
                  block_offset: int = 0, dtype=None) -> SurvivorCounts:
    """Candidate probe over the mesh: survivors per candidate over
    ``n_dev * local_pad`` paths. ``block_offset`` shifts every shard's
    global blocks (``Engine.probe`` chunks a path count beyond its budget
    into mesh-sized launches that cover the same global blocks)."""
    plan, outs = _launch_per_shard(probe, pack_params, params, seed, months,
                                   retirement_years, n_paths, statics, mesh,
                                   block_offset, dtype)
    return SurvivorCounts(_sum_counts([o.counts for o in outs], mesh),
                          plan.simulated)


def grid_sharded(params_batch: SimParams, seed: int, months,
                 retirement_years: int, n_paths: int, statics: Statics, *,
                 mesh: PathMesh, dtype=None) -> SurvivorCounts:
    """Scenario grid over the mesh: survivors per scenario over ``n_dev *
    local_pad`` paths, every shard on the grid's shared shocks."""
    check_grid_statics(params_batch, statics)
    plan, outs = _launch_per_shard(grid, pack_grid, params_batch, seed, months,
                                   retirement_years, n_paths, statics, mesh,
                                   dtype=dtype)
    return SurvivorCounts(_sum_counts([o.counts for o in outs], mesh),
                          plan.simulated)


def grid_raw_sharded(params_batch: SimParams, seed: int, months,
                     retirement_years: int, n_paths: int, statics: Statics, *,
                     mesh: PathMesh, dtype=None) -> ProbeOut:
    """Scenario grid over the mesh returning the per-path tables: survivors
    (K,) over every simulated path, success and final balance (K, n_dev *
    local_pad) on the mesh's first device, and the body steps (K,) of every
    shard's launch."""
    check_grid_statics(params_batch, statics)
    _, outs = _launch_per_shard(grid, pack_grid, params_batch, seed, months,
                                retirement_years, n_paths, statics, mesh,
                                dtype=dtype)
    tally = torch.as_tensor(_sum_counts(
        [torch.stack((o.counts, o.steps)) for o in outs], mesh)).to(mesh.device)
    return ProbeOut(tally[0],
                    gather_paths([o.success for o in outs], mesh, dim=1),
                    gather_paths([o.final_balance for o in outs], mesh, dim=1),
                    tally[1])


def simulate_sharded(params: SimParams, seed: int, working_months: int,
                     retirement_years: int, n_paths: int, statics: Statics, *,
                     mesh: PathMesh, dtype=None) -> SimulateOut:
    """One working-months value over the mesh: per-path success flags and
    final balances, ``n_dev * local_pad`` entries on the mesh's first
    device."""
    _, outs = _launch_per_shard(simulate, pack_params, params, seed,
                                working_months, retirement_years, n_paths,
                                statics, mesh, dtype=dtype)
    return SimulateOut(gather_paths([o.success for o in outs], mesh),
                       gather_paths([o.final_balance for o in outs], mesh))


def full_shards(params: SimParams, seed: int, working_months: int,
                retirement_years: int, n_paths: int, traj_len: int,
                statics: Statics, *, mesh: PathMesh, block_offset: int = 0,
                start: int = 0, dtype=None
                ) -> Tuple[ShardPlan, List[Tuple[Shard, Dict[str, torch.Tensor]]]]:
    """The full kernel on every local shard, each at ``local_pad`` paths on
    its own device, every shard launched before this returns (nothing is
    read). ``start`` is the global path index of the launch's first path
    (a chunk of a longer run)."""
    plan = mesh.plan(n_paths, block_offset=block_offset, start=start)
    outs = [
        (s, simulate_full(
            pack_params(params, seed, working_months, retirement_years,
                        block_offset=s.block_offset, dtype=_dtype(mesh, dtype),
                        device=s.device),
            statics, retirement_years, plan.local_pad, traj_len))
        for s in plan.shards
    ]
    return plan, outs


def simulate_full_sharded(params: SimParams, seed: int, working_months: int,
                          retirement_years: int, n_paths: int, traj_len: int,
                          statics: Statics, *, mesh: PathMesh,
                          block_offset: int = 0, dtype=None
                          ) -> Dict[str, torch.Tensor]:
    """Full statistics over the mesh: the ``simulate_full`` dict with
    ``n_dev * local_pad`` entries on the mesh's first device (vectors (N,),
    series (N, L) and (N, R))."""
    _, outs = full_shards(params, seed, working_months, retirement_years,
                          n_paths, traj_len, statics, mesh=mesh,
                          block_offset=block_offset, dtype=dtype)
    return {name: gather_paths([full[name] for _, full in outs], mesh)
            for name in outs[0][1]}
