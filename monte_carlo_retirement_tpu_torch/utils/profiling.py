"""Tracing and profiling: per-phase device timing, trace capture, spans.

Counterpart of the JAX package's ``utils/profiling.py``. ``device_timer``
times a phase on the host's clock and, before it stops, waits for the
devices of the phase's result (CUDA work is asynchronous, as JAX dispatch
is); ``trace_to`` captures a ``torch.profiler`` trace where the JAX module
captures a ``jax.profiler`` one. The first call of a phase usually includes
building its kernels (``engine/_build.py``); the log flags it.

``span`` records where the served path spends its time: each span is
``{id, name, parent, request, tid, t0, t1, attrs}``, ``t0``/``t1`` from
``time.time_ns()`` (the clock a ``torch.profiler`` chrome trace is based
on, ``baseTimeNanoseconds``) and ``tid`` from ``threading.get_native_id()``
(the thread ids the profiler records). The open span and the request id
live in one ``ContextVar``, so asyncio tasks parent correctly, and so does
work handed to a thread under a copy of the caller's context
(``asyncio.to_thread`` copies it; ``run_in_executor`` needs
``contextvars.copy_context().run``). The recorder is off unless
``enable()`` is called; off, ``span`` returns one shared no-op context
after one check, reading no clock and taking no lock. Spans stay in memory
until ``drain()``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import itertools
import logging
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

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


# ---------------------------------------------------------------------------
# spans of the served path
# ---------------------------------------------------------------------------
_RECORDING = False
_SPANS: List[dict] = []
_SPANS_LOCK = threading.Lock()
_IDS = itertools.count(1)
# (id of the open span, request id) of the running task or thread.
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "mcrt_open_span", default=(None, None))


class _Span:
    """One span: opened on ``__enter__``, kept on ``__exit__``."""

    __slots__ = ("record", "_token", "_new_request")

    def __init__(self, name: str, attrs: dict, new_request: bool = False):
        self.record = {"id": None, "name": name, "parent": None,
                       "request": None, "tid": None, "t0": None, "t1": None,
                       "attrs": attrs}
        self._new_request = new_request
        self._token = None

    def __enter__(self) -> "_Span":
        parent, request = _OPEN.get()
        rec = self.record
        rec["id"] = next(_IDS)
        if self._new_request:
            request = rec["id"]
        rec["parent"], rec["request"] = parent, request
        rec["tid"] = threading.get_native_id()
        self._token = _OPEN.set((rec["id"], request))
        rec["t0"] = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.record["t1"] = time.time_ns()
        _OPEN.reset(self._token)
        with _SPANS_LOCK:
            _SPANS.append(self.record)
        return False

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open."""
        self.record["attrs"].update(attrs)


class _NoSpan:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager recording ``name`` around its block as a child of
    the open span, in the open request."""
    if not _RECORDING:
        return _NO_SPAN
    return _Span(name, attrs)


def request_span(name: str, **attrs):
    """``span`` that starts a request: its own id is the request id of
    every span opened inside it."""
    if not _RECORDING:
        return _NO_SPAN
    return _Span(name, attrs, new_request=True)


def traced(name: str, attrs: Optional[Callable[..., dict]] = None):
    """Decorator: every call of the function is a span ``name``; ``attrs``,
    called with the call's arguments, gives the span's attributes."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _RECORDING:
                return fn(*args, **kwargs)
            with _Span(name, attrs(*args, **kwargs) if attrs else {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def stamp() -> Optional[int]:
    """``time.time_ns()`` while recording, else None: the start of a span
    that ``record`` closes on another thread."""
    return time.time_ns() if _RECORDING else None


def record(name: str, t0: Optional[int], **attrs) -> None:
    """Keep a span ``name`` from ``t0`` (``stamp()``) to now, on this
    thread, as a child of the open span. Nothing for ``t0=None``."""
    if not _RECORDING or t0 is None:
        return
    t1 = time.time_ns()
    parent, request = _OPEN.get()
    rec = {"id": next(_IDS), "name": name, "parent": parent,
           "request": request, "tid": threading.get_native_id(),
           "t0": t0, "t1": t1, "attrs": attrs}
    with _SPANS_LOCK:
        _SPANS.append(rec)


def enable() -> None:
    """Start recording spans."""
    global _RECORDING
    _RECORDING = True


def disable() -> None:
    """Stop recording; what was kept stays until ``clear``/``drain``."""
    global _RECORDING
    _RECORDING = False


def clear() -> None:
    """Forget every kept span."""
    with _SPANS_LOCK:
        _SPANS.clear()


def drain() -> List[dict]:
    """The spans kept so far, closed ones only, in the order they closed;
    the recorder keeps none of them."""
    global _SPANS
    with _SPANS_LOCK:
        out, _SPANS = _SPANS, []
    return out
