"""End-to-end arithmetic over the client's records of one window.

A record is one request: its send and done times (``time.monotonic``), its
HTTP status and body. The clients send only inside the window and wait for
every request they sent, so the records are every request of the window,
those still running at its close included. An answer is a 200, or the 400
"target not met" of a household whose target cannot be met within 70
years. Anything else, or a request that never returned, failed.

- ``plan_ms.p90``: the 90th percentile (numpy's linear rule) of the
  latency of every answer to a request sent in the window, in ms;
- ``plans_per_s``: the answers the window completed over its seconds; an
  answer still running at the close counts for the share of its time that
  lay inside the window (so a window of 1.75 s analyses is not rounded to
  a whole count);
- ``analysis_s``: the window's seconds over the analyses it completed,
  counted so;
- ``setup_s``: from process start to the first timed request.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

ANSWERS = (200, 400)


class Window:
    def __init__(self, records: List[dict], start: float, seconds: float):
        self.start = start
        self.seconds = seconds
        self.end = start + seconds
        self.attempted = len(records)
        self.failed = sum(r["status"] not in ANSWERS for r in records)
        self.answered = sorted((r for r in records if r["status"] in ANSWERS),
                               key=lambda r: r["t_done"])

    def latencies_ms(self) -> List[float]:
        return [(r["t_done"] - r["t_send"]) * 1e3 for r in self.answered]

    def work(self) -> float:
        """Answers completed in the window, one still running at its close
        counted for the share of its time inside it."""
        done = 0.0
        for r in self.answered:
            if r["t_done"] <= self.end:
                done += 1.0
            elif r["t_send"] < self.end:
                done += (self.end - r["t_send"]) / (r["t_done"] - r["t_send"])
        return done

    def metrics(self, setup_s: float) -> Dict[str, float]:
        work = self.work()
        lat = self.latencies_ms()
        return {
            "setup_s": setup_s,
            "plan_ms.p90": float(np.percentile(lat, 90)) if lat else None,
            "plans_per_s": work / self.seconds if work else None,
            "analysis_s": self.seconds / work if work else None,
        }

    def summary(self) -> str:
        lat = self.latencies_ms()
        no_target = sum(r["status"] == 400 for r in self.answered)
        late = sum(r["t_done"] > self.end for r in self.answered)
        if not lat:
            return f"{self.attempted} sent, none answered"
        return (f"{self.attempted} sent, {len(lat)} answered ({no_target} target not met, "
                f"{late} after the close, {self.work():.4f} answers' work in the window), "
                f"{self.failed} failed; latency ms median {np.median(lat):.1f} "
                f"p90 {np.percentile(lat, 90):.1f} max {max(lat):.1f}")


def breakdown(tr, top: int = 10) -> dict:
    """The profiled device operations that took most time, and the longest
    idle stretches of the card by the innermost host span open at their
    middle."""
    by_op: Dict[str, float] = defaultdict(float)
    for op in tr.ops:
        by_op[op.name[:160]] += (op.t1 - op.t0) / 1e9
    gaps: Dict[str, float] = defaultdict(float)
    spans = sorted(tr.spans, key=lambda s: s["t0"])
    active, nxt, end = [], 0, tr.window[0]
    for op in tr.ops + [None]:
        t = tr.window[1] if op is None else op.t0
        if t > end:
            mid = (end + t) // 2
            while nxt < len(spans) and spans[nxt]["t0"] <= mid:
                active.append(spans[nxt])
                nxt += 1
            active = [s for s in active if s["t1"] >= mid]
            name = max(active, key=lambda s: s["t0"])["name"] if active else "no span"
            gaps[name] += (t - end) / 1e9
        if op is not None:
            end = max(end, op.t1)
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": order(by_op), "idle_gaps": order(gaps)}
