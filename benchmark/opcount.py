"""The essential operations of the month loop, counted on the reference.

``count(config)`` runs a year of accumulation months and a year of
retirement months of ``reference/loop.py`` on one row of paths under a
dispatch mode, each month from the same state, and counts,
per path, one operation for each arithmetic operation, comparison, select,
conversion and transcendental; a multiply whose only consumer is an add or
subtract counts with it as one; negations (a sign bit on an operand),
logical operations on masks, copies, fills and indexing count nothing. A
draw is priced from the Philox4x32-10 algorithm itself
(``reference/philox.py``), not from its 16-bit emulation in torch
(``draw_ops``, with a crash's draws more); the
gross factors of a path-month (two products, three multiply-adds, three
exponentials and the asset-2 product, with a crash's jump more) count once
per path-month. Work done once a year (a gain bill, a guardrail's step,
the tracked run's records) is spread over the year's months: the second
retirement year's for ``retirement``, the first's for
``tracked_retirement``, where the first-year records fall (a guardrail
steps first at the second year's start, so its step is not in that
count). The counts are frozen in each
``configs/<config>.json`` under ``essential_ops``; ``tests`` recompute them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .reference import loop, philox

COUNTED = {
    "add", "sub", "rsub", "mul", "div", "abs", "clamp", "clamp_min", "clamp_max",
    "minimum", "maximum", "floor", "ceil", "pow", "gt", "ge", "lt", "le", "eq", "ne",
    "where", "exp", "log", "log1p", "sqrt", "bitwise_right_shift", "__rshift", "_to_copy",
}
FUSING = {"add", "sub", "rsub"}
# A uniform from its word: the shift, the conversion and the product.
OPS_PER_UNIFORM = 3


class _Counter(TorchDispatchMode):
    """Records every op with its inputs; counts the live counted ones."""

    def __init__(self):
        super().__init__()
        self.ops = []  # (name, elements, input op indices, in place)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        raw = func.overloadpacket.__name__
        name = raw.rstrip("_")
        if not isinstance(out, torch.Tensor):
            return out
        if name == "_to_copy" and kwargs.get("dtype") in (None, args[0].dtype):
            name = "copy"
        srcs = [getattr(a, "_opc", None) for a in args if isinstance(a, torch.Tensor)]
        self.ops.append((name, out.numel(), [s for s in srcs if s is not None],
                         raw.endswith("_") and not raw.startswith("_")))
        out._opc = len(self.ops) - 1
        return out

    def total(self, roots) -> int:
        live = {i for i, op in enumerate(self.ops) if op[3]}
        live |= {getattr(t, "_opc") for t in roots if hasattr(t, "_opc")}
        todo = list(live)
        while todo:
            for s in self.ops[todo.pop()][2]:
                if s not in live:
                    live.add(s)
                    todo.append(s)
        consumers: Dict[int, int] = {}
        for i in live:
            for s in self.ops[i][2]:
                consumers[s] = consumers.get(s, 0) + 1
        total = 0
        for i in sorted(live):
            name, n, srcs, _ = self.ops[i]
            if name not in COUNTED:
                continue
            total += n
            if name in FUSING:
                fused = next((s for s in srcs if self.ops[s][0] == "mul"
                              and consumers[s] == 1), None)
                if fused is not None:
                    total -= self.ops[fused][1]
        return total


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def _per_path(fn, n: int) -> float:
    with _Counter() as c:
        result = fn()
    return c.total(list(_tensors(result))) / n


def draw_ops(config: Optional[dict] = None) -> float:
    """A path-month's Philox draw and its three normals; with crashes, the
    uniform of word 3 and a second draw's normal. An antithetic pair
    shares one draw, counted once for its two paths, and its second path
    reflects the crash uniform (one subtraction). The lifetime's draw,
    once per path, is not counted."""
    rules = loop.structure(config) if config is not None else None
    ops = philox.ROUNDS * philox.OPS_PER_ROUND + philox.NORMALS_PER_DRAW * philox.OPS_PER_NORMAL
    if rules and rules.jumps:
        ops += OPS_PER_UNIFORM + philox.ROUNDS * philox.OPS_PER_ROUND + philox.OPS_PER_NORMAL
    if rules and rules.antithetic:
        ops = ops / 2.0 + (0.5 if rules.jumps else 0.0)
    return float(ops)


def count(config: dict, n: int = 4096) -> Dict[str, float]:
    """Essential operations per path-month of ``config``'s loop: ``draw``,
    ``factors``, and per row ``accumulation`` / ``retirement`` months,
    with the tracked run's ``tracked_accumulation`` /
    ``tracked_retirement``."""
    cfg = dict(config, seed=1)
    w = 24
    run = loop.Loop([cfg], [w], 7, n, torch.float32)
    g = run.draw(1)
    st = run.initial(1)
    st_acc = run.accumulate(1, st, g)

    acc_year = _per_path(lambda: [run.accumulate(m, st, g) for m in range(1, 13)], n)
    out = {
        "draw": draw_ops(cfg),
        # The first draw(1) drew the month: this counts its factors alone.
        "factors": _per_path(lambda: run.draw(1), n),
        "accumulation": acc_year / 12.0,
        # The second retirement year, the first with a year-start month.
        "retirement": _per_path(
            lambda: [run.retire(m, st_acc, g) for m in range(w + 13, w + 25)], n) / 12.0,
    }
    # The tracked accumulation adds one sum of the balances a year.
    out["tracked_accumulation"] = (acc_year + 1.0) / 12.0
    full = loop.Loop([cfg], [w], 7, n, torch.float32)
    z = lambda: torch.zeros((1, n))
    track = dict(yg=z(), yr=z(), fyg=z(), fyr=z(), ytr=z(),
                 traj=torch.zeros((4 + full.R, n)), price=torch.ones((4 + full.R, n)),
                 wr=torch.zeros((full.R, n)), full_wy=2, partial_wy=0,
                 start=st_acc["b1"] + st_acc["b2"], infl_ret=st_acc["infl"])
    out["tracked_retirement"] = _per_path(
        lambda: ([full.retire(m, st_acc, g, track=track) for m in range(w + 1, w + 13)],
                 track), n) / 12.0
    return {k: round(v, 4) for k, v in out.items()}
