"""The benchmark of the PyTorch/CUDA port, one cell per run.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Starts the port's server (``benchmark/launcher.py``) in a child process on
127.0.0.1, waits for ``/api/health``, sends one untimed request of the
cell's own traffic per client (the library build and every shape the
window uses), then drives closed-loop clients from this process for
``--seconds``. Every request is timed from its send until its response
body has been read. The last line on standard output is the result as one
JSON object; the numbers that decide ``correct`` are printed, each beside
its limit, as the last lines on standard error and under ``checks`` at the
end of that object. With ``--trace 1`` the server records spans and
profiles the card over the window, and the line carries the
per-layer metrics instead of the end-to-end ones. A traced run's window
is its first ``TRACE_WINDOW_S`` seconds at most: reading a profile back
takes longer than the window it covers.

A run needs a CUDA card: without one it exits with code 2 and prints no
result. It reads and writes only inside its checkout and ``TMPDIR``.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import http.client  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import endtoend, spec, traffic  # noqa: E402
from benchmark.launcher import forbidden_modules  # noqa: E402

CHILD_START_S = 300
REQUEST_TIMEOUT_S = 900
DRAIN_S = 120
TRACE_WINDOW_S = 20
WARM_SEED_OFFSET = 1 << 40


class RunError(RuntimeError):
    """A run that cannot give a result."""


class Server:
    """The launcher child: its port, its log, its end."""

    def __init__(self, trace: bool, device: str, fault: Optional[str]):
        self.log = tempfile.TemporaryFile()
        cmd = [sys.executable, "-m", "benchmark.launcher", "--device", device,
               "--trace", str(int(trace))]
        if fault:
            cmd += ["--fault", fault]
        self.proc = subprocess.Popen(cmd, cwd=str(spec.ROOT), stdout=subprocess.PIPE,
                                     stderr=self.log)
        self.port = None

    def wait_port(self):
        line = self.proc.stdout.readline().decode()
        if not line.startswith("PORT "):
            raise RunError(f"server did not start ({self.proc.poll()}):\n{self.tail()}")
        self.port = int(line.split()[1])
        deadline = time.monotonic() + CHILD_START_S
        while time.monotonic() < deadline:
            try:
                if self.call("GET", "/api/health")[0] == 200:
                    return
            except OSError:
                pass
            time.sleep(0.05)
        raise RunError("server never answered /api/health")

    def call(self, method: str, path: str, body: bytes = None, timeout=REQUEST_TIMEOUT_S):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def json(self, method: str, path: str):
        status, data = self.call(method, path)
        if status != 200:
            raise RunError(f"{method} {path}: {status} {data[:200]!r}")
        return json.loads(data)

    def tail(self, size: int = 6000) -> str:
        self.log.seek(0, os.SEEK_END)
        end = self.log.tell()
        self.log.seek(max(0, end - size))
        return self.log.read().decode(errors="replace")

    def stop(self):
        if self.port is None:
            self.proc.kill()
        elif self.proc.poll() is None:
            try:
                self.call("POST", "/bench/shutdown", timeout=30)
            except OSError:
                pass
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()


class Clients:
    """Closed-loop clients sharing one sequence of requests."""

    def __init__(self, server: Server, route: str, bodies, count: int):
        self.server, self.route, self.bodies, self.count = server, route, bodies, count
        self.lock = threading.Lock()
        self.records: List[dict] = []

    def next_body(self) -> dict:
        with self.lock:
            return next(self.bodies)

    def one(self, conn, body: dict) -> dict:
        data = traffic.wire(body)
        t_send = time.monotonic()
        try:
            conn.request("POST", self.route, body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            status = resp.status
        except (OSError, http.client.HTTPException) as exc:
            raw, status = repr(exc).encode(), -1
        return {"t_send": t_send, "t_done": time.monotonic(), "status": status,
                "raw": raw, "body": body}

    def loop(self, deadline: float):
        conn = http.client.HTTPConnection("127.0.0.1", self.server.port,
                                          timeout=REQUEST_TIMEOUT_S)
        try:
            while time.monotonic() < deadline:
                rec = self.one(conn, self.next_body())
                with self.lock:
                    self.records.append(rec)
                if rec["status"] < 0:
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", self.server.port,
                                                      timeout=REQUEST_TIMEOUT_S)
        finally:
            conn.close()

    def warm(self, bodies: List[dict]) -> List[dict]:
        """One untimed request per client, all at once."""
        out: List[dict] = [None] * len(bodies)

        def go(i):
            conn = http.client.HTTPConnection("127.0.0.1", self.server.port,
                                              timeout=REQUEST_TIMEOUT_S)
            try:
                out[i] = self.one(conn, bodies[i])
            finally:
                conn.close()

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def run(self, seconds: float) -> float:
        start = time.monotonic()
        deadline = start + seconds
        threads = [threading.Thread(target=self.loop, args=(deadline,))
                   for _ in range(self.count)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + REQUEST_TIMEOUT_S + DRAIN_S)
            if t.is_alive():
                raise RunError("a client never returned")
        return start


def card_check(chips: int):
    """The cards this run needs; raises without them. Opens no context on
    a card: the server is the only process that uses it, and names it."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: no CUDA card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"{torch.cuda.device_count()} CUDA cards, the cell needs {chips}")


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def warm_bodies(cell: spec.Cell, seed: int, count: int) -> List[dict]:
    """Requests of the cell's own traffic that the window never sends:
    those of a seed beyond any that a run is given."""
    gen = traffic.requests(cell.config, cell.mix, int(seed) + WARM_SEED_OFFSET)
    return [next(gen) for _ in range(count)]


def checked(cell: spec.Cell, records: List[dict], seed: int, dtype, device) -> Dict[str, float]:
    """The numbers of the answers sampled from the window (seed-drawn,
    with the longest in it) against the reference."""
    from benchmark.reference import check

    answered = [r for r in records if r["status"] in (200, 400)]
    if not answered:
        raise RunError("no request of the window was answered")
    rng = np.random.default_rng([int(seed), 3])
    if cell.mix["route"] == "/api/grid":
        rec = answered[int(rng.integers(len(answered)))]
        rows = sorted(rng.choice(len(rec["body"]["variants"]),
                                 size=int(cell.mix["check_rows"]), replace=False).tolist())
        answer = check.grid_answer(json.loads(rec["raw"]), rows)
        return check.grid_numbers(rec["body"], answer, rows, dtype, device)

    def months(r):
        if r["status"] != 200:
            return -1
        return json.loads(r["raw"])["summary"]["required_working_months"]

    longest = max(range(len(answered)), key=lambda i: months(answered[i]))
    k = min(int(cell.mix["check_requests"]), len(answered))
    others = [i for i in range(len(answered)) if i != longest]
    pick = [longest] + rng.choice(others, size=k - 1, replace=False).tolist()
    readings = []
    for i in pick:
        r = answered[i]
        body = json.loads(r["raw"]) if r["status"] == 200 else None
        answer = check.answer_from_payload(r["status"], body)
        readings.append(check.plan_numbers(r["body"], answer, dtype, device))
    return check.worst(readings)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault: Optional[str] = None, sizes: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result object. ``device="cpu"`` and
    ``sizes`` (mix keys replaced) serve the harness's own tests."""
    cell = spec.Cell(name)
    if sizes:
        cell.mix = dict(cell.mix, **sizes)
    server = Server(trace, device, fault)
    try:
        if device != "cpu":
            card_check(cell.chips)
        power = power_limit() if device != "cpu" else None
        server.wait_port()
        clients = Clients(server, cell.mix["route"],
                          traffic.requests(cell.config, cell.mix, seed),
                          int(cell.mix["clients"]))
        for rec in clients.warm(warm_bodies(cell, seed, clients.count)):
            if rec["status"] not in (200, 400):
                raise RunError(f"warm-up request failed: {rec['status']} "
                               f"{rec['raw'][:300]!r}")
        server.json("POST", "/bench/reset")
        setup_s = time.monotonic() - T0

        if trace:
            # Started and stopped while no request runs: the profiler's
            # start and stop are not safe beside threads that launch.
            seconds = min(seconds, TRACE_WINDOW_S)
            server.json("POST", "/bench/profile/start")
        start = clients.run(seconds)
        if trace:
            server.json("POST", "/bench/profile/stop")
        state = server.json("GET", "/bench/state")
        t_read = time.monotonic()
        trace_data = server.json("GET", "/bench/trace") if trace else None
        t_read = time.monotonic() - t_read
    except (RunError, OSError):
        sys.stderr.write(server.tail())
        raise
    finally:
        server.stop()
    if state["forbidden_modules"]:
        raise RunError(f"the server process loaded {state['forbidden_modules']}")
    if any(state["plain_calls"].values()) and device != "cpu":
        raise RunError(f"the served path ran plain versions: {state['plain_calls']}")

    window = endtoend.Window(clients.records, start, seconds)
    result = {
        "correct": None,
        "attempted": window.attempted,
        "failed": window.failed,
        "metrics": {},
        "device": {"platform": "gpu" if device != "cpu" else "cpu", "kind": state["kind"],
                   "count": cell.chips, "memory_peak_bytes": state["memory_peak_bytes"]},
    }
    if power:
        result["device"]["power_limit"] = power
    sys.stderr.write(f"{state['kind']} ({power}); window {seconds} s: {window.summary()}\n")
    if trace:
        from benchmark import layers

        tr = layers.Trace(trace_data, {"config": cell.config,
                                       "config_file": cell.config_file})
        ctx = {"trace": tr, "launches": state["launches"]}
        for metric in cell.per_layer:
            value = spec.reader(metric["name"])(ctx)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        month_loop = [o for o in tr.ops if o.month_loop]
        launches = [s for s in tr.spans if s["name"].startswith("launch.")]
        sys.stderr.write(
            f"trace: read back in {t_read:.1f} s; {len(tr.ops)} device ops in "
            f"{tr.window_s():.3f} s, "
            f"{sum(tr.owner(o, launches) is not None for o in month_loop)} of "
            f"{len(month_loop)} month-loop kernels inside their launch span\n")
        if tr.window and tr.window[1]:
            result["device"]["busy_s"] = tr.busy_s()
            result["device"]["window_s"] = tr.window_s()
            result["breakdown"] = endtoend.breakdown(tr)
    else:
        values = window.metrics(setup_s)
        for metric in cell.end_to_end:
            result["metrics"][metric["name"]] = {"value": values[metric["name"]],
                                                 "unit": metric["unit"]}

    import torch

    dtype = torch.float32 if device != "cpu" else torch.float64
    t_check = time.monotonic()
    numbers = checked(cell, window.answered, seed, dtype, device)
    sys.stderr.write(f"reference check: {time.monotonic() - t_check:.1f} s\n")
    checks = {}
    ok = window.failed == 0
    for key, lim in cell.limits.items():
        value = numbers.get(key)
        checks[key] = {"value": value, "limit": lim}
        ok = ok and value is not None and value <= lim
    result["correct"] = bool(ok)
    result["checks"] = checks
    for key, c in checks.items():
        sys.stderr.write(f"check {key} = {c['value']!r} (limit {c['limit']!r})\n")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except RunError as exc:
        sys.stderr.write(f"benchmark run failed: {exc}\n")
        return 2
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"this process loaded {found}: no result\n")
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
