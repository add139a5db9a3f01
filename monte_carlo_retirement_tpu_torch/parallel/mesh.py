"""The paths mesh: path-parallel launches over torch devices.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX shards the path
axis of an array over a ``jax.sharding.Mesh`` and lets XLA place the
collectives. Here a :class:`PathMesh` is the ordered tuple of torch devices
this process drives (its shards), with the process's place in the job
(``parallel/distributed.py``); ``engine/sharded.py`` launches one kernel
per shard and reduces or gathers the results explicitly.

Shard ``g = process_index * n_local + i`` of an ``n_dev``-shard mesh runs
``local_blocks`` whole 4096-path blocks, the global blocks ``[offset + g *
local_blocks, offset + (g + 1) * local_blocks)``, so the shards' paths are
contiguous and the padding of the last real shard never sits between real
paths (the JAX ``_local_blocks`` rule, ``pallas_kernel.py:206-209``).

A device may repeat: ``make_mesh(["cuda:0"] * 4)`` is four shards on one
card (they run in turn), the counterpart of the JAX suite's virtual CPU
devices; the tests use CPU shards the same way.

JAX's ``paths_sharding``, ``replicated`` and ``constrain_paths_axis`` have
no torch meaning (no tensor carries a sharding: each shard's tensors live
on its own device), so they are not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..engine.cuda_kernel import require_device
from ..ops.shocks import BLOCK_PATHS
from . import distributed


def local_device_count() -> int:
    """CPU shards per process of a default mesh: ``MCRT_LOCAL_DEVICE_COUNT``
    (default 1)."""
    return max(1, int(os.environ.get(distributed.ENV_LOCAL_DEVICES, "1")))


def local_blocks(n_paths: int, n_dev: int, block_paths: int = BLOCK_PATHS) -> int:
    """Blocks each shard runs: ceil(ceil(n_paths / n_dev) / block_paths)
    (the JAX ``_local_blocks``)."""
    per_dev = (int(n_paths) + n_dev - 1) // n_dev
    return max(1, (per_dev + block_paths - 1) // block_paths)


def pad_to_devices(n_paths: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` that is >= ``n_paths``."""
    return ((n_paths + n_devices - 1) // n_devices) * n_devices


class Shard(NamedTuple):
    """One local shard of a launch over the mesh."""

    device: torch.device
    start: int  # global index of the shard's first path
    paths: int  # real paths in the shard (0 for a shard beyond n)
    block_offset: int  # global block of the shard's first path


class ShardPlan(NamedTuple):
    """The launch of ``n_paths`` paths over an ``n_dev``-shard mesh: every
    shard runs ``local_pad`` paths; this process's shards in order."""

    n_dev: int
    local_blocks: int
    local_pad: int
    shards: Tuple[Shard, ...]

    @property
    def simulated(self) -> int:
        """Paths simulated over the whole mesh, padding included."""
        return self.n_dev * self.local_pad


@dataclasses.dataclass(frozen=True)
class PathMesh:
    """This process's shards on the paths axis and its place in the job."""

    devices: Tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1
    # Spans the process group (of any size): its results are reduced and
    # gathered over the group's processes.
    grouped: bool = False

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over every process."""
        return self.n_local * self.process_count

    @property
    def device(self) -> torch.device:
        """Where this process gathers per-path results: its first shard."""
        return self.devices[0]

    def plan(self, n_paths: int, block_offset: int = 0,
             start: int = 0) -> ShardPlan:
        """The shards of a launch of ``n_paths`` paths whose first global
        block is ``block_offset`` and first global path ``start``."""
        n = int(n_paths)
        if n < 1:
            raise ValueError(f"a launch needs paths, got {n}")
        lb = local_blocks(n, self.size)
        pad = lb * BLOCK_PATHS
        first = self.process_index * self.n_local
        shards = tuple(
            Shard(device=dev, start=start + g * pad,
                  paths=max(0, min(pad, n - g * pad)),
                  block_offset=int(block_offset) + g * lb)
            for g, dev in enumerate(self.devices, start=first)
        )
        return ShardPlan(self.size, lb, pad, shards)


def _normalize(device) -> torch.device:
    device = torch.device(device)
    require_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices: Optional[Sequence] = None) -> PathMesh:
    """A mesh over ``devices`` (default: every visible card, or without a
    card ``MCRT_LOCAL_DEVICE_COUNT`` shards of the CPU), after those of the
    processes before this one when a process group is up. A CUDA device
    without a card raises. Every process of a group must bring as many
    shards."""
    if devices is None:
        if torch.cuda.is_available():
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        else:
            devices = ["cpu"] * local_device_count()
    devices = tuple(_normalize(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    n = len(devices)
    grouped = distributed.group_active()
    if grouped:
        # One collective on every process: the largest count and the
        # negated smallest.
        ext = distributed.all_reduce(torch.tensor([n, -n]), "max").tolist()
        if ext != [n, -n]:
            raise ValueError(
                f"every process must bring as many shards: this one has {n}, "
                f"the group between {-ext[1]} and {ext[0]}"
            )
    return PathMesh(devices, distributed.process_index(),
                    distributed.process_count(), grouped)


def shard_paths(mesh: PathMesh, tensor: torch.Tensor):
    """This process's shards of ``tensor``'s leading (paths) axis, split
    evenly over the whole mesh, each on its shard's device."""
    n = tensor.shape[0]
    if n % mesh.size:
        raise ValueError(
            f"{n} paths do not split evenly over {mesh.size} shards"
        )
    per = n // mesh.size
    first = mesh.process_index * mesh.n_local
    return [tensor[(first + i) * per:(first + i + 1) * per].to(dev)
            for i, dev in enumerate(mesh.devices)]


def mesh_device(mesh: Optional[PathMesh], device) -> torch.device:
    """The device a call gathers on: ``device`` without a mesh, the mesh's
    first shard with one. Raises when they are of different kinds (a CPU
    mesh under ``device="cuda"``): nothing silently moves to another kind
    of device."""
    require_device(device)
    device = torch.device(device)
    if mesh is None:
        return device
    kinds = {d.type for d in mesh.devices}
    if kinds != {device.type}:
        raise ValueError(
            f"mesh on {sorted(kinds)} but device={device}; pass the mesh's "
            "kind of device"
        )
    return mesh.device
