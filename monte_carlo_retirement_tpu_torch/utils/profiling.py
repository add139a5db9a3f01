"""Tracing and profiling: per-phase device timing and trace capture.

Counterpart of the JAX package's ``utils/profiling.py``. ``device_timer``
times a phase on the host's clock and, before it stops, waits for the
devices of the phase's result (CUDA work is asynchronous, as JAX dispatch
is); ``trace_to`` captures a ``torch.profiler`` trace where the JAX module
captures a ``jax.profiler`` one. The first call of a phase usually includes
building its kernels (``engine/_build.py``); the log flags it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, Optional

import torch

log = logging.getLogger("mcrt.profiling")

# Accumulated wall time per phase name for the current process.
_PHASE_TOTALS: Dict[str, float] = {}
_PHASE_COUNTS: Dict[str, int] = {}


class _PhaseHandle:
    """Mutable handle yielded by ``device_timer``: assign the block's output
    to ``handle.result`` so the timer can wait for it at exit — a value
    passed at context ENTRY could only ever be an input, which is ready
    already and under-reports device time."""

    result = None


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of every tensor in ``tree`` (tensors, sequences,
    mappings, named tuples and dataclasses of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), found)
    return found


@contextlib.contextmanager
def device_timer(phase: str, result=None) -> Iterator[_PhaseHandle]:
    """Time a device-bound phase.

    Usage::

        with device_timer("final_run") as t:
            t.result = engine_step(...)   # the timer waits for this at exit

    ``result`` may also be passed at entry for existing tensors. Logs the
    elapsed wall time and accumulates per-phase totals retrievable with
    ``phase_timings()``.
    """
    first = phase not in _PHASE_TOTALS
    handle = _PhaseHandle()
    handle.result = result
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        for dev in _cuda_devices(handle.result, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        _PHASE_TOTALS[phase] = _PHASE_TOTALS.get(phase, 0.0) + dt
        _PHASE_COUNTS[phase] = _PHASE_COUNTS.get(phase, 0) + 1
        log.info(
            "phase '%s': %.1f ms%s",
            phase,
            dt * 1000,
            " (first call — includes kernel builds)" if first else "",
        )


def phase_timings() -> Dict[str, Dict[str, float]]:
    """Per-phase totals: {phase: {total_s, calls, mean_ms}}."""
    return {
        phase: {
            "total_s": total,
            "calls": _PHASE_COUNTS[phase],
            "mean_ms": total / _PHASE_COUNTS[phase] * 1000.0,
        }
        for phase, total in _PHASE_TOTALS.items()
    }


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    when a card is present) around a block and write it into ``log_dir``
    as a Chrome trace (``trace_<pid>_<time>.json``).

    No-op when ``log_dir`` is falsy, so call sites can be left in place and
    enabled via a flag/env var.
    """
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)
