"""Multi-process runtime: ``torch.distributed`` glue and the collectives.

Counterpart of the JAX package's ``parallel/distributed.py``. The pattern
is the same multi-controller one:

  * every process runs the SAME program;
  * :func:`initialize` (or :func:`initialize_from_env`) forms the process
    group before any simulation;
  * ``parallel.mesh.make_mesh()`` then places this process's shards after
    those of the processes before it, so shard ``g = process_index *
    n_local + i`` simulates the same global 4096-path blocks whatever the
    split of the mesh over processes;
  * the kernels need no change: their Philox stream is a pure function of
    (seed, global block, month, lane), so an (H processes x D shards) mesh
    reproduces the single-process run bit for bit.

JAX's collectives are placed by XLA; here they are explicit and few:
:func:`all_reduce` (survivor counts, the band search's counts and brackets)
and :func:`all_gather` (the per-path vectors and the grid's raw tables).
Counts are exact integers, so a sum over processes never depends on the
order of the reduction.

Gloo matches the messages of a pair of processes in the order they arrive
(the JAX module's note on asynchronous dispatch, lines 87-97), so every
process must issue the same collectives in the same order: none of them
sits inside a data-dependent branch, and the band search's loop runs the
same rounds everywhere because its counts are reduced before they are
read. Gloo takes card tensors for few collectives, so under gloo every
collective is staged through a host tensor (they carry counts and small
vectors); NCCL takes the card tensors themselves.

JAX's ``force_local_device_count`` has no counterpart: a mesh of
``MCRT_LOCAL_DEVICE_COUNT`` CPU shards needs no process-wide flag
(``parallel/mesh.py``). Side effects (plots, files, HTTP responses) belong
to the coordinator only: gate them on :func:`is_coordinator`.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("mcrt.distributed")

ENV_COORDINATOR = "MCRT_COORDINATOR"
ENV_NUM_PROCESSES = "MCRT_NUM_PROCESSES"
ENV_PROCESS_ID = "MCRT_PROCESS_ID"
ENV_LOCAL_DEVICES = "MCRT_LOCAL_DEVICE_COUNT"

# How long a process waits for its peers (and a collective for its
# partners): jax.distributed.initialize's default initialization timeout.
TIMEOUT_S = 300

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def group_active() -> bool:
    """True once this process belongs to a process group (of any size: a
    one-rank group still runs its collectives)."""
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join (or form) the process group. Idempotent.

    ``coordinator_address`` is ``host:port`` of process 0 (a ``tcp://``
    prefix is optional). Without it the call is a no-op returning False:
    single-process mode, nothing changes. An explicit address that fails
    raises: a request to distribute is never dropped.

    ``backend`` defaults to ``nccl`` when this machine has a card and to
    ``gloo`` otherwise. JAX picks its transport itself; the argument exists
    because NCCL refuses two ranks on one card, so a check of a
    multi-process mesh on a one-card machine needs ``gloo``.

    Returns True iff the process is part of a group of more than one
    process after the call.
    """
    if group_active():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        logger.debug("single-process mode (no coordinator address)")
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator address needs num_processes and process_id"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        backend=backend,
        init_method=address,
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    logger.info(
        "process group up: process %d/%d over %s",
        dist.get_rank(), dist.get_world_size(), backend,
    )
    return dist.get_world_size() > 1


def initialize_from_env(backend: Optional[str] = None) -> bool:
    """Initialize from ``MCRT_COORDINATOR`` / ``MCRT_NUM_PROCESSES`` /
    ``MCRT_PROCESS_ID`` (all three required together). No-op returning
    False when unset. ``MCRT_LOCAL_DEVICE_COUNT`` is read by
    ``parallel.mesh.make_mesh`` (the CPU shards per process)."""
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return False
    nproc = os.environ.get(ENV_NUM_PROCESSES)
    pid = os.environ.get(ENV_PROCESS_ID)
    if nproc is None or pid is None:
        raise ValueError(
            f"{ENV_COORDINATOR} is set but {ENV_NUM_PROCESSES}/"
            f"{ENV_PROCESS_ID} are not — all three are required"
        )
    return initialize(coord, int(nproc), int(pid), backend=backend)


def process_index() -> int:
    return dist.get_rank() if group_active() else 0


def process_count() -> int:
    return dist.get_world_size() if group_active() else 1


def is_distributed() -> bool:
    return process_count() > 1


def is_coordinator() -> bool:
    """True on the process that should perform side effects (plots, files,
    responses). Always True single-process."""
    return process_index() == 0


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where the backend takes it: the host
    under gloo, a card under NCCL (the current one for a host tensor)."""
    if dist.get_backend() == "nccl":
        dev = t.device if t.device.type == "cuda" else torch.device(
            "cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return t.detach().to(dev).contiguous().clone()


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over every process of the group (``op``: sum, min or
    max), on ``t``'s device; ``t`` itself without a group."""
    if not group_active():
        return t
    staged = _staged(t)
    if staged.device.type == "cuda":
        with torch.cuda.device(staged.device):
            dist.all_reduce(staged, op=getattr(dist.ReduceOp, _OPS[op]))
    else:
        dist.all_reduce(staged, op=getattr(dist.ReduceOp, _OPS[op]))
    return staged.to(t.device)


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (the same shape everywhere), in process order,
    on ``t``'s device; ``[t]`` without a group."""
    if not group_active():
        return [t]
    staged = _staged(t)
    parts = [torch.empty_like(staged) for _ in range(dist.get_world_size())]
    if staged.device.type == "cuda":
        with torch.cuda.device(staged.device):
            dist.all_gather(parts, staged)
    else:
        dist.all_gather(parts, staged)
    return [p.to(t.device) for p in parts]
