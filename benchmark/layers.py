"""Span and trace arithmetic shared by the per-layer readers.

``Trace`` holds what a traced run brought back: the spans recorded around
the calls into each layer (``launcher.install_spans``), the device
operations of the profiled part of the window, the client's records and
the program's launch counters. Times are host nanoseconds
(``time.time_ns``, the profiler's clock too). The idle arithmetic is
``hosts/profile_card.py``'s: busy is the time in which a device operation
ran, idle the rest of the window.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from . import roofline

MONTH_LOOP = ("probe_kernel", "full_kernel", "grid_kernel", "scan_rows_kernel",
              "scan_full_kernel", "jvp_kernel")


class Op:
    __slots__ = ("name", "cat", "t0", "t1", "tid", "t_launch")

    def __init__(self, name, cat, t0, dur, tid, t_launch):
        self.name, self.cat, self.tid, self.t_launch = name, cat, tid, t_launch
        self.t0, self.t1 = int(t0), int(t0) + int(dur)

    @property
    def month_loop(self) -> bool:
        return any(k in self.name for k in MONTH_LOOP)


class Trace:
    def __init__(self, data: dict, ctx: dict):
        self.spans: List[dict] = data.get("spans", [])
        self.window = data.get("window")
        ops = [Op(*o) for o in data.get("ops", [])]
        if self.window and self.window[1]:
            ops = [o for o in ops if o.t0 >= self.window[0] and o.t1 <= self.window[1]]
        self.ops = sorted(ops, key=lambda o: o.t0)
        self.ctx = ctx
        self.by_id = {s["id"]: s for s in self.spans}
        self.children = defaultdict(list)
        for s in self.spans:
            if s["parent"] is not None:
                self.children[s["parent"]].append(s)
        self._index, self._keep = {}, []
        self.thread = self._thread_map()

    def _thread_map(self) -> Dict[int, int]:
        """The profiler's thread ids as the spans' native ids: each
        month-loop kernel's launch lies in exactly one launch span, whose
        thread gets that kernel's vote."""
        launches = [s for s in self.spans if s["name"].startswith("launch.")]
        votes: Dict[int, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
        for op in self.ops:
            if op.month_loop and op.t_launch is not None:
                hits = [s for s in launches if s["t0"] <= op.t_launch <= s["t1"]]
                if len(hits) == 1:
                    votes[op.tid][hits[0]["tid"]] += 1
        return {tid: max(v, key=v.get) for tid, v in votes.items()}

    # --- spans ---------------------------------------------------------
    def named(self, name: str) -> List[dict]:
        return [s for s in self.spans if s["name"] == name]

    def descendants(self, span: dict, name: str) -> List[dict]:
        out, todo = [], list(self.children[span["id"]])
        while todo:
            s = todo.pop()
            if s["name"] == name:
                out.append(s)
            todo.extend(self.children[s["id"]])
        return out

    def by_seed(self, name: str) -> Dict[int, dict]:
        return {s["attrs"].get("seed"): s for s in self.named(name)}

    def profiled(self, span: dict) -> bool:
        return bool(self.window and self.window[1]) and (
            span["t0"] >= self.window[0] and span["t1"] <= self.window[1])

    # --- device ----------------------------------------------------------
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self, lo: Optional[int] = None, hi: Optional[int] = None) -> float:
        """Seconds in [lo, hi] (default the profiled window) in which a
        device operation ran: the union of their intervals."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        busy, end = 0, lo
        for o in self.ops:
            a, b = max(o.t0, end), min(o.t1, hi)
            if b > a:
                busy += b - a
                end = b
        return busy / 1e9

    def owner(self, op: Op, spans: List[dict]) -> Optional[dict]:
        """The span of ``spans`` that launched ``op``: on its launching
        thread, around its launch (spans of one thread do not overlap
        unless nested, and ``spans`` holds one name)."""
        if op.t_launch is None:
            return None
        index = self._index.get(id(spans))
        if index is None:
            index = defaultdict(list)
            for s in sorted(spans, key=lambda s: s["t0"]):
                index[s["tid"]].append(s)
            index = {tid: ([s["t0"] for s in ss], ss) for tid, ss in index.items()}
            self._index[id(spans)] = index
            self._keep.append(spans)
        starts, ss = index.get(self.thread.get(op.tid, op.tid), ((), ()))
        i = bisect.bisect_right(starts, op.t_launch) - 1
        if i >= 0 and op.t_launch <= ss[i]["t1"]:
            return ss[i]
        return None

    def roofline_pct(self, kernel: str, launch: str) -> Optional[float]:
        """Share of ``kernel``'s profiled device time that its floor
        (``roofline.py``) accounts for, over the launches found."""
        launches = self.named(launch)
        ess = self.ctx["config_file"]["essential_ops"]
        years = int(self.ctx["config"]["retirement_years"])
        floor = device = 0.0
        for op in self.ops:
            if kernel not in op.name:
                continue
            span = self.owner(op, launches)
            if span is None:
                continue
            a = span["attrs"]
            if launch == "launch.full":
                parent = self.by_id.get(span["parent"])
                while parent is not None and parent["name"] != "engine.run":
                    parent = self.by_id.get(parent["parent"])
                if parent is None:
                    continue
                n = a["paths"]
                surv = int(round(parent["attrs"]["success_pct"] * n / 100.0))
                w = roofline.full_work(ess, a["months"][0], surv, n, years, a["traj_len"])
            else:
                w = roofline.rows_work(ess, a["months"], a["survivors"], a["paths"], years)
            floor += roofline.floor_s(w["ops"], w["bytes"])
            device += (op.t1 - op.t0) / 1e9
        return 100.0 * floor / device if device > 0 else None


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def dur_ms(span: dict) -> float:
    return (span["t1"] - span["t0"]) / 1e6
