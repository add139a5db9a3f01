"""The server under test, started in a process of its own.

``python -m benchmark.launcher --trace 0|1`` serves the port's app
(``hosts/server.create_app(device="cuda")``) on 127.0.0.1 at a port the OS
picks, prints ``PORT <n>`` on its standard output, and serves until
``POST /bench/shutdown``. Besides the program's routes it answers:

- ``GET /bench/state``: peak device memory, the program's launch counters
  and any JAX module loaded here;
- ``POST /bench/reset``: the counters and spans start again;
- ``POST /bench/profile/start`` and ``/stop`` (traced runs): torch.profiler
  over the card, its kernels kept;
- ``GET /bench/trace``: the spans and the profiled device operations.

In a traced run the functions that enter each layer are wrapped by name
(PERF.md §3), so each call leaves a span (name, thread, parent, start,
end, a few attributes) in memory; nothing of the program is edited.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import itertools
import json
import os
import sys
import tempfile
import threading
import time
from typing import List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "monte_carlo_retirement_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Tracer:
    """Spans in memory: one stack per thread gives each span its parent."""

    def __init__(self):
        self.spans: List[dict] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def clear(self):
        with self._lock:
            self.spans = []

    def _open(self, name: str) -> dict:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        span = {"id": next(self._ids), "name": name,
                "parent": stack[-1]["id"] if stack else None,
                "tid": threading.get_native_id(), "t0": time.time_ns(), "attrs": {}}
        stack.append(span)
        return span

    def _close(self, span: dict):
        span["t1"] = time.time_ns()
        self._local.stack.pop()
        with self._lock:
            self.spans.append(span)

    def wrap(self, owner, attr: str, name: str, attrs=None):
        """Replace ``owner.attr`` by a wrapper that records a span; ``attrs
        (span, args, kwargs, result)`` adds attributes."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            span = self._open(name)
            try:
                result = fn(*args, **kwargs)
            finally:
                self._close(span)
            if attrs is not None:
                attrs(span, args, kwargs, result)
            return result

        setattr(owner, attr, wrapper)

    def wrap_handler(self, owner, attr: str, name: str):
        """An aiohttp handler: the span carries the request's engine seed,
        which the engine-thread spans of the same request carry too."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        async def handler(request):
            span = {"id": next(self._ids), "name": name, "parent": None,
                    "tid": threading.get_native_id(), "t0": time.time_ns(),
                    "attrs": {}}
            try:
                return await fn(request)
            finally:
                span["t1"] = time.time_ns()
                try:
                    span["attrs"]["seed"] = (await request.json())["config"]["seed"]
                except (ValueError, KeyError, TypeError):
                    pass
                with self._lock:
                    self.spans.append(span)

        setattr(owner, attr, handler)


def _months(packed) -> List[int]:
    return [int(v) for v in packed.ip[:, 0].tolist()]


def install_spans(tracer: Tracer):
    """The layer boundaries of the served path (PERF.md §3)."""
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel, runner, scenario_batch
    from monte_carlo_retirement_tpu_torch.engine.simulator import (
        RetirementMonteCarloSimulator,
    )
    from monte_carlo_retirement_tpu_torch.hosts import grid as grid_host
    from monte_carlo_retirement_tpu_torch.hosts import server

    tracer.wrap_handler(server, "simulate", "server.simulate")
    tracer.wrap_handler(server, "grid", "server.grid")

    def seed_of(span, args, kwargs, result):
        span["attrs"]["seed"] = args[0].seed

    def grid_seed(span, args, kwargs, result):
        span["attrs"]["seed"] = args[0][0][0].seed

    def run_attrs(span, args, kwargs, result):
        span["attrs"].update(months=int(args[1]), paths=int(args[2]),
                             success_pct=float(result.success_probability))

    def rows_attrs(span, args, kwargs, result):
        span["attrs"].update(months=_months(args[0]), paths=int(args[3]))
        span["counts"] = result.counts  # read after the window

    def full_attrs(span, args, kwargs, result):
        span["attrs"].update(months=_months(args[0]), paths=int(args[3]),
                             traj_len=int(args[4]))

    tracer.wrap(server, "_run_simulation", "server.run_simulation", seed_of)
    tracer.wrap(RetirementMonteCarloSimulator, "find_minimum_working_months", "search")
    tracer.wrap(server, "build_result", "payload.build_result")
    tracer.wrap(runner.Engine, "run", "engine.run", run_attrs)
    tracer.wrap(server, "run_prepared_grid", "grid.run_prepared_grid", grid_seed)
    tracer.wrap(grid_host, "run_scenario_grid", "grid.run_scenario_grid")
    for owner, attr in ((runner, "probe_kernel"), (cuda_kernel, "probe")):
        tracer.wrap(owner, attr, "launch.probe", rows_attrs)
    for owner, attr in ((scenario_batch, "grid"), (cuda_kernel, "grid")):
        tracer.wrap(owner, attr, "launch.grid", rows_attrs)
    for owner, attr in ((runner, "simulate_full"), (cuda_kernel, "simulate_full")):
        tracer.wrap(owner, attr, "launch.full", full_attrs)


def install_fault(fault: str):
    """A broken timed path, for the harness's own tests: ``half_batch``
    simulates half the paths and takes every statistic over them;
    ``answer_altered`` alters what the kernels produce by 1%."""
    import torch

    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel, runner, scenario_batch

    def rows(fn):
        def broken(packed, statics, years, n):
            if fault == "half_batch":
                out = fn(packed, statics, years, n // 2)
                rep = lambda t: torch.cat([t, t], dim=1)[:, :n]
                return cuda_kernel.ProbeOut(out.counts * n // (n // 2), rep(out.success),
                                            rep(out.final_balance))
            out = fn(packed, statics, years, n)
            return cuda_kernel.ProbeOut(out.counts + n // 100, out.success,
                                        out.final_balance * 1.01)
        return broken

    def full(fn):
        def broken(packed, statics, years, n, traj_len):
            if fault == "half_batch":
                out = fn(packed, statics, years, n // 2, traj_len)
                return {k: torch.cat([v, v])[:n] for k, v in out.items()}
            out = fn(packed, statics, years, n, traj_len)
            out["final_balance"] = out["final_balance"] * 1.01
            out["trajectory"] = out["trajectory"] * 1.01
            return out
        return broken

    runner.probe_kernel = rows(runner.probe_kernel)
    scenario_batch.grid = rows(scenario_batch.grid)
    runner.simulate_full = full(runner.simulate_full)


class Profile:
    """torch.profiler over the card for the window (started before its
    first request and stopped after its last)."""

    def __init__(self):
        self.prof = None
        self.window = None
        self.ops: List[list] = []

    def start(self):
        import torch

        from torch.profiler import ProfilerActivity, profile

        kind = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
        self.prof = profile(activities=[kind])
        self.prof.start()
        self.window = [time.time_ns(), None]

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window[1] = time.time_ns()
        self.prof.stop()

    def read(self):
        """The profiled device operations (once, after the window)."""
        if self.prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as fh:
                trace = json.load(fh)
        finally:
            os.unlink(path)
        self.ops = device_ops(trace)
        self.prof = None


def device_ops(trace: dict) -> List[list]:
    """Every device operation of a chrome trace as [name, category, start
    ns, duration ns, the profiler's id of the launching thread or None,
    launch ns or None], on the host clock of ``time.time_ns``."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), base + int(float(e["ts"]) * 1000))
    ops = []
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            corr = (e.get("args") or {}).get("correlation")
            tid, t_launch = launches.get(corr, (None, None))
            ops.append([e["name"], e["cat"], base + int(float(e["ts"]) * 1000),
                        int(float(e.get("dur", 0)) * 1000),
                        tid if isinstance(tid, int) else None, t_launch])
    return ops


def build_app(device: str, trace: bool, fault: Optional[str]):
    import torch
    from aiohttp import web

    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel
    from monte_carlo_retirement_tpu_torch.hosts import server

    tracer = Tracer() if trace else None
    if tracer is not None:
        install_spans(tracer)
    if fault:
        install_fault(fault)
    app = server.create_app(device)
    profile = Profile()
    done = asyncio.Event()
    on_card = device != "cpu"

    async def state(_request):
        return web.json_response({
            "kind": torch.cuda.get_device_name() if on_card else "cpu",
            "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0,
            "launches": dict(cuda_kernel.LAUNCHES),
            "plain_calls": dict(cuda_kernel.PLAIN_CALLS),
            "forbidden_modules": forbidden_modules(),
        })

    async def reset(_request):
        cuda_kernel.reset_counts()
        if tracer is not None:
            tracer.clear()
        return web.json_response({"ok": True})

    async def profile_start(_request):
        await asyncio.to_thread(profile.start)
        return web.json_response({"ok": True})

    async def profile_stop(_request):
        await asyncio.to_thread(profile.stop)
        return web.json_response({"ok": True})

    async def trace_out(_request):
        def collect():
            profile.read()
            spans = []
            for s in tracer.spans:
                s = dict(s)
                counts = s.pop("counts", None)
                if counts is not None:
                    s["attrs"]["survivors"] = [int(v) for v in counts.tolist()]
                spans.append(s)
            return {"spans": spans, "ops": profile.ops, "window": profile.window}
        return web.json_response(await asyncio.to_thread(collect))

    async def shutdown(_request):
        done.set()
        return web.json_response({"ok": True})

    app.router.add_get("/bench/state", state)
    app.router.add_post("/bench/reset", reset)
    app.router.add_post("/bench/profile/start", profile_start)
    app.router.add_post("/bench/profile/stop", profile_stop)
    app.router.add_get("/bench/trace", trace_out)
    app.router.add_post("/bench/shutdown", shutdown)
    return app, done


async def serve(device: str, trace: bool, fault: Optional[str]):
    from aiohttp import web

    from monte_carlo_retirement_tpu_torch.logging_utils import configure_logging

    # As the server's own main() serves: INFO to stderr and server.log.
    configure_logging(logfile="server.log")
    app, done = build_app(device, trace, fault)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    print(f"PORT {port}", flush=True)
    await done.wait()
    await asyncio.sleep(0.05)
    await runner.cleanup()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.launcher")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--fault", default="")
    args = parser.parse_args(argv)
    asyncio.run(serve(args.device, bool(args.trace), args.fault or None))
    # The engine pool's threads are the program's; the process ends here.
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
