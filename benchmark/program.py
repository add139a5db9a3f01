"""The program's own spans (``utils/profiling.py``) in a traced run of a cell.

    python -m benchmark.program --workload <cell> --seed <n> --seconds <s>
        [--launcher-spans 0|1] [--out FILE]

Runs the cell's traced run as ``python -m benchmark.run ... --trace 1``
does (``run.run_cell``: the launcher's wrapped spans, the card profiled
over the window's first 20 s, the reference check), with two additions:
the server's span recorder is on (``profiling.enable()`` before
``create_app``, cleared with the counters at ``/bench/reset``), and its
spans come back beside the launcher's. Prints one JSON object:

- ``result``: the traced run's result line (every per-layer metric of
  ``BENCHMARK.json`` read by the launcher's spans, ``correct``);
- ``program``: the numbers read from the program's spans
  (``PROGRAM_METRICS``), the launcher's span metrics recomputed from
  them (``RECOMPUTED``), spans per request, the card's idle stretches by
  the innermost program span open, and the clock check: how many of the
  window's month-loop kernels launched inside a ``kernel.*`` program span
  of their own thread; ``copy_wait_ms``, the time the engine thread of a
  search, final run or grid spent in copies between host and card, from
  the device trace, and ``runtime_ms``, its time in long CUDA runtime
  calls by call; ``self_ms``, each span's self time per request;
  ``stretch_ms``, the stretches of a request in no span of its own
  (``STRETCHES``).

``--launcher-spans 0`` leaves the launcher's wrapped spans out: their
attributes read each launch's months back from the card, a wait for the
stream after every launch that the program's spans would otherwise not
see where the served path meets it.

The benchmark's own runs (``benchmark.run``) leave the recorder off.
Program spans are ``{id, name, parent, request, tid, t0, t1, attrs}`` on
the clock of ``time.time_ns`` and the threads of
``threading.get_native_id``, as the launcher's spans and the profiled
device operations are.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import tempfile
import types
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from benchmark import endtoend, launcher, layers, run, spec
from benchmark.layers import dur_ms, mean

# CUDA runtime calls at least this long (µs) come back with the spans.
RUNTIME_MIN_US = 100


class Spans:
    """Program spans by name, parent and request."""

    def __init__(self, spans: List[dict]):
        self.spans = spans
        self.children: Dict[int, List[dict]] = defaultdict(list)
        for s in spans:
            if s["parent"] is not None:
                self.children[s["parent"]].append(s)

    def named(self, name: str) -> List[dict]:
        return [s for s in self.spans if s["name"] == name]

    def requests(self, name: str) -> List[dict]:
        """The request spans ``name`` (``profiling.request_span``)."""
        return [s for s in self.named(name) if s["request"] == s["id"]]

    def descendants(self, span: dict, name: str) -> List[dict]:
        out, todo = [], list(self.children[span["id"]])
        while todo:
            s = todo.pop()
            if s["name"] == name:
                out.append(s)
            todo.extend(self.children[s["id"]])
        return out

    def under(self, root: str, name: str) -> List[dict]:
        """Every ``name`` span of the window's ``root`` requests."""
        return [s for r in self.requests(root) for s in self.descendants(r, name)]

    def per_request_ms(self, root: str, name: str) -> Optional[float]:
        """Mean over the ``root`` requests that have one of the time in
        their ``name`` spans, ms."""
        totals = []
        for r in self.requests(root):
            found = self.descendants(r, name)
            if found:
                totals.append(sum(dur_ms(s) for s in found))
        return mean(totals)

    def less(self, outers: List[dict], inner: str) -> Optional[float]:
        """Mean over ``outers`` of their time less their ``inner``
        descendants', ms."""
        return mean([dur_ms(o) - sum(dur_ms(s) for s in self.descendants(o, inner))
                     for o in outers])


def search_host_ms(sp: Spans) -> Optional[float]:
    """Host time per search in which the engine thread did not wait on the
    card: ``plan.search`` less its ``card.sync`` descendants."""
    return sp.less(sp.under("http.simulate", "plan.search"), "card.sync")


def final_card_wait_ms(sp: Spans) -> Optional[float]:
    """Time per final run in blocking device-to-host reads: the
    ``card.sync`` descendants of each ``plan.final``."""
    return mean([sum(dur_ms(s) for s in sp.descendants(f, "card.sync"))
                 for f in sp.under("http.simulate", "plan.final")])


# Per-layer numbers read from the program's spans: name -> read(Spans).
PROGRAM_METRICS: Dict[str, Callable[[Spans], Optional[float]]] = {
    "pool.wait_ms.plan": lambda sp: sp.per_request_ms("http.simulate", "pool.wait"),
    "server.respond_ms.plan": lambda sp: sp.per_request_ms("http.simulate",
                                                           "http.respond"),
    "server.respond_ms.grid": lambda sp: sp.per_request_ms("http.grid", "http.respond"),
    "grid.parse_ms": lambda sp: sp.per_request_ms("http.grid", "http.parse"),
    "search.host_ms": search_host_ms,
    "final.card_wait_ms": final_card_wait_ms,
}


def _server_self_plan(sp: Spans, tr) -> Optional[float]:
    return mean([dur_ms(h) - sum(dur_ms(s) for s in sp.descendants(h, "plan.search")
                                 + sp.descendants(h, "plan.payload"))
                 for h in sp.requests("http.simulate")])


def _search_probes(sp: Spans, tr) -> Optional[float]:
    searches = len(sp.under("http.simulate", "plan.search"))
    return len(sp.under("http.simulate", "kernel.probe")) / searches if searches else None


def _reductions_card_ms(sp: Spans, tr) -> Optional[float]:
    runs = [s for s in sp.under("http.simulate", "plan.final") if tr.profiled(s)]
    if not runs:
        return None
    total = sum((op.t1 - op.t0) / 1e6 for op in tr.ops
                if op.cat == "kernel" and not op.month_loop
                and tr.owner(op, runs) is not None)
    return total / len(runs)


def _grid_host_gap_ms(sp: Spans, tr) -> Optional[float]:
    grids = [s for s in sp.under("http.grid", "grid.run") if tr.profiled(s)]
    return mean([dur_ms(s) - 1e3 * tr.busy_s(s["t0"], s["t1"]) for s in grids])


# The launcher's span metrics of BENCHMARK.json, recomputed from program
# spans: name -> read(Spans, layers.Trace). ``search.probes`` counts
# ``kernel.probe`` spans (the launcher reads the launch counter, which the
# CPU's plain versions leave at 0).
RECOMPUTED: Dict[str, Callable] = {
    "server.self_ms.plan": _server_self_plan,
    "server.self_ms.grid": lambda sp, tr: sp.less(sp.requests("http.grid"), "grid.run"),
    "search.ms": lambda sp, tr: mean([dur_ms(s) for s in
                                      sp.under("http.simulate", "plan.search")]),
    "search.probes": _search_probes,
    "payload.self_ms": lambda sp, tr: sp.less(sp.under("http.simulate", "plan.payload"),
                                              "plan.final"),
    "final.ms": lambda sp, tr: mean([dur_ms(s) for s in
                                     sp.under("http.simulate", "plan.final")]),
    "reductions.card_ms": _reductions_card_ms,
    "grid.host_gap_ms": _grid_host_gap_ms,
}


def thread_map(ops, spans: List[dict]) -> Dict[int, int]:
    """The profiler's thread ids as native ids, voted as
    ``layers.Trace.thread`` votes, from ``spans`` (``kernel.*`` program
    spans, where a run has no launcher spans)."""
    votes: Dict[int, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for op in ops:
        if op.month_loop and op.t_launch is not None:
            hits = [s for s in spans if s["t0"] <= op.t_launch <= s["t1"]]
            if len(hits) == 1:
                votes[op.tid][hits[0]["tid"]] += 1
    return {tid: max(v, key=v.get) for tid, v in votes.items()}


def copy_wait_ms(tr, spans: List[dict]) -> Optional[float]:
    """Mean over the profiled ``spans`` of the time their thread spent in
    host-device copies (``Memcpy HtoD`` / ``DtoH``) launched inside them,
    from the launch to the copy's end on the card: torch's copies to and
    from the host synchronise the stream, so this is the thread's wait for
    the card, wherever the copy sits (a ``.cpu()`` in a ``card.sync`` span,
    or a tensor made on the card from host values)."""
    copies = [o for o in tr.ops if o.cat == "gpu_memcpy" and o.t_launch is not None
              and ("HtoD" in o.name or "DtoH" in o.name)]
    by_thread = defaultdict(list)
    for o in copies:
        by_thread[tr.thread.get(o.tid, o.tid)].append(o)
    waits = []
    for s in spans:
        if tr.profiled(s):
            waits.append(sum((min(o.t1, s["t1"]) - o.t_launch) / 1e6
                             for o in by_thread.get(s["tid"], ())
                             if s["t0"] <= o.t_launch <= s["t1"]))
    return mean(waits)


def runtime_ms(tr, spans: List[dict]) -> Dict[str, float]:
    """Mean over the profiled ``spans`` of the time their thread spent in
    each CUDA runtime call of ``RUNTIME_MIN_US`` or more that started inside
    them, by call (``cudaStreamSynchronize``, ``cudaMemcpyAsync``, ...)."""
    by_thread = defaultdict(list)
    for name, tid, t0, dur in tr.runtime:
        by_thread[tr.thread.get(tid, tid)].append((name, t0, dur))
    totals: Dict[str, float] = defaultdict(float)
    profiled = [s for s in spans if tr.profiled(s)]
    for s in profiled:
        for name, t0, dur in by_thread.get(s["tid"], ()):
            if s["t0"] <= t0 <= s["t1"]:
                totals[name] += min(dur, s["t1"] - t0) / 1e6
    return {k: v / len(profiled) for k, v in totals.items()}


def self_ms(sp: Spans, root: str) -> Dict[str, float]:
    """Per ``root`` request, the self time of its spans by name (a span
    less its children, on whatever thread they ran), ms."""
    roots = sp.requests(root)
    ids = {r["id"] for r in roots}
    totals: Dict[str, float] = defaultdict(float)
    for s in sp.spans:
        if s["request"] in ids:
            totals[s["name"]] += dur_ms(s) - sum(dur_ms(c) for c in sp.children[s["id"]])
    return {k: v / len(roots) for k, v in totals.items()}


def between(sp: Spans, root: str, first: str, second: str) -> List[dict]:
    """Per ``root`` request, the stretch from the end of its ``first``
    span to the start of its ``second``, on ``first``'s thread, as a span."""
    out = []
    for r in sp.requests(root):
        a, b = sp.descendants(r, first), sp.descendants(r, second)
        if a and b:
            out.append({"tid": a[0]["tid"], "t0": a[0]["t1"], "t1": b[0]["t0"]})
    return out


# Stretches of a request in no span of its own: the engine thread's start
# to the search or grid (``_run_simulation`` building the simulator and
# its parameters on the card), and the engine's end to the response (the
# grid's assembly, the hop back to the event loop).
STRETCHES = (("http.simulate", "pool.wait", "plan.search"),
             ("http.simulate", "plan.payload", "http.respond"),
             ("http.grid", "pool.wait", "grid.run"),
             ("http.grid", "grid.run", "http.respond"))


def clock_check(sp: Spans, tr) -> dict:
    """The window's month-loop kernels, and how many of them launched
    inside a ``kernel.*`` program span on their own thread (the profiler's
    thread ids mapped to native ids as ``layers.Trace.thread`` maps them)."""
    kernels = [s for s in sp.spans if s["name"].startswith("kernel.")]
    month = [o for o in tr.ops if o.month_loop]
    return {"month_loop_kernels": len(month),
            "inside_kernel_span": sum(tr.owner(o, kernels) is not None for o in month)}


def report(tr) -> dict:
    """Everything ``program`` holds, of one traced run's ``layers.Trace``
    whose ``program`` holds the program's spans."""
    sp = Spans(tr.program)
    out = {"spans": len(sp.spans), "metrics": {}, "recomputed": {}, "spans_per_request": {}}
    for name, read in PROGRAM_METRICS.items():
        value = read(sp)
        if value is not None:
            out["metrics"][name] = value
    for name, read in RECOMPUTED.items():
        value = read(sp, tr)
        if value is not None:
            out["recomputed"][name] = value
    out["self_ms"] = {}
    for root in ("http.simulate", "http.grid"):
        roots = sp.requests(root)
        if roots:
            ids = {r["id"] for r in roots}
            mine = sum(s["request"] in ids for s in sp.spans)
            out["spans_per_request"][root] = mine / len(roots)
            out["self_ms"][root] = self_ms(sp, root)
    if tr.window and tr.window[1]:
        view = types.SimpleNamespace(spans=sp.spans, ops=tr.ops, window=tr.window)
        out["idle_gaps"] = endtoend.breakdown(view)["idle_gaps"]
        out["clock"] = clock_check(sp, tr)
        out["copy_wait_ms"], out["runtime_ms"], out["stretch_ms"] = {}, {}, {}
        for root, first, second in STRETCHES:
            stretch = between(sp, root, first, second)
            if stretch:
                key = f"{first}..{second}"
                out["stretch_ms"][key] = mean([dur_ms(s) for s in stretch])
                out["runtime_ms"][key] = runtime_ms(tr, stretch)
        for root, name in (("http.simulate", "plan.search"), ("http.simulate", "plan.final"),
                           ("http.grid", "grid.run")):
            value = copy_wait_ms(tr, sp.under(root, name))
            if value is not None:
                out["copy_wait_ms"][name] = value
                out["runtime_ms"][name] = runtime_ms(tr, sp.under(root, name))
    return out


class _Server(run.Server):
    """The launcher child with the program's recorder on (``serve``)."""

    def __init__(self, trace: bool, device: str, fault: Optional[str],
                 launcher_spans: bool = True):
        self.log = tempfile.TemporaryFile()
        cmd = [sys.executable, "-m", "benchmark.program", "serve",
               "--launcher-spans", str(int(launcher_spans)), "--device", device,
               "--trace", str(int(trace))]
        if fault:
            cmd += ["--fault", fault]
        self.proc = subprocess.Popen(cmd, cwd=str(spec.ROOT), stdout=subprocess.PIPE,
                                     stderr=self.log)
        self.port = None

    def json(self, method: str, path: str):
        if (method, path) == ("POST", "/bench/reset"):
            super().json("POST", "/bench/program/clear")
        out = super().json(method, path)
        if (method, path) == ("GET", "/bench/trace"):
            program = super().json("GET", "/bench/program")
            out["program_spans"], out["program_runtime"] = program["spans"], program["runtime"]
        return out


def traced_run(cell: str, seed: int, seconds: float, device: str = "cuda",
               sizes: Optional[dict] = None, launcher_spans: bool = True):
    """``run.run_cell(cell, seed, seconds, trace=True)`` with the program's
    spans: returns its result and its ``layers.Trace``, whose ``program``
    holds them. ``launcher_spans=False`` leaves out the launcher's wrapped
    spans, whose attributes read each launch's months back from the card
    (a wait for the stream after every launch): the program's spans then
    see the waits where the served path meets them, and the launcher's
    span metrics are not read."""
    kept = []

    class Kept(layers.Trace):
        def __init__(self, data, ctx):
            super().__init__(data, ctx)
            self.program = data.get("program_spans", [])
            self.runtime = data.get("program_runtime", [])
            if not self.thread:
                self.thread = thread_map(self.ops, [s for s in self.program
                                                    if s["name"].startswith("kernel.")])
            kept.append(self)

    saved = run.Server, layers.Trace
    run.Server = functools.partial(_Server, launcher_spans=launcher_spans)
    layers.Trace = Kept
    try:
        result = run.run_cell(cell, seed, seconds, True, device=device, sizes=sizes)
    finally:
        run.Server, layers.Trace = saved
    return result, kept[-1]


def serve(argv: List[str]) -> int:
    """The launcher (``benchmark.launcher``) with the recorder on in a
    traced run, two more routes, ``GET /bench/program`` (the spans,
    drained, and the profile's CUDA runtime calls of ``RUNTIME_MIN_US`` or
    more) and ``POST /bench/program/clear``, and with ``--launcher-spans
    0`` none of the launcher's wrapped spans."""
    import asyncio

    from aiohttp import web

    from monte_carlo_retirement_tpu_torch.utils import profiling

    parser = argparse.ArgumentParser(prog="benchmark.program serve")
    parser.add_argument("--launcher-spans", type=int, choices=(0, 1), default=1)
    args, argv = parser.parse_known_args(argv)
    if not args.launcher_spans:
        launcher.install_spans = lambda tracer: None
    build, ops_of = launcher.build_app, launcher.device_ops
    runtime: List[list] = []

    def device_ops(trace: dict) -> List[list]:
        base = int(trace.get("baseTimeNanoseconds", 0))
        runtime[:] = [[e["name"], e.get("tid"), base + int(float(e["ts"]) * 1000),
                       int(float(e["dur"]) * 1000)]
                      for e in trace.get("traceEvents", [])
                      if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and float(e.get("dur", 0)) >= RUNTIME_MIN_US]
        return ops_of(trace)

    def build_app(device: str, trace: bool, fault: Optional[str]):
        if trace:
            profiling.enable()
        app, done = build(device, trace, fault)

        async def drained(_request):
            spans = await asyncio.to_thread(profiling.drain)
            return web.json_response({"spans": spans, "runtime": runtime})

        async def cleared(_request):
            profiling.clear()
            return web.json_response({"ok": True})

        app.router.add_get("/bench/program", drained)
        app.router.add_post("/bench/program/clear", cleared)
        return app, done

    launcher.build_app, launcher.device_ops = build_app, device_ops
    return launcher.main(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["serve"]:
        return serve(argv[1:])
    parser = argparse.ArgumentParser(prog="benchmark.program")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--launcher-spans", type=int, choices=(0, 1), default=1)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    try:
        result, tr = traced_run(args.workload, args.seed, args.seconds,
                                launcher_spans=bool(args.launcher_spans))
    except run.RunError as exc:
        sys.stderr.write(f"traced run failed: {exc}\n")
        return 2
    line = json.dumps({"workload": args.workload, "seed": args.seed,
                       "launcher_spans": args.launcher_spans, "result": result,
                       "program": report(tr)})
    if args.out:
        with open(args.out, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
