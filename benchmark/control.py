"""The control of ``correct``: the reference in bfloat16 in the program's place.

The configurations state float32, and the month loop has no matrix
product, so the nearest lower precision is bfloat16. The control answers a
cell's own requests as the server would (the search's ladder and
verification over 16-candidate probes, then the full run at the month
found; or a grid's rows) with ``reference/loop.py`` in bfloat16, and the
same comparison as a run's (``reference/check.py``) reads its answers
against the float32 reference. Every number it gives is an upper reading
for that number's limit (PERF.md).

    python -m benchmark.control --workload <cell> --seeds 11 12 13 [--requests 2]

prints one JSON line per seed with the control's numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Callable, List, Sequence

import numpy as np
import torch

from benchmark import spec, traffic
from benchmark.reference import check, loop, philox, stats

LOW = torch.bfloat16
LADDER_CHUNK = 16
VERIFY_CHUNK = 16


def search(probe: Callable[[Sequence[int]], Sequence[float]], start: int, target: float,
           n: int):
    """The served search's rule: a 12-month ladder (the start alone, then
    chunks of 16) up to the first chunk with a hit, then every month from
    one tested point before the first near-target one up to that hit; the
    smallest month meeting the target. Returns (months or -1, probability)."""
    top = start + check.SEARCH_YEARS * 12
    ladder = list(range(start, top + 1, 12))
    if ladder[-1] != top:
        ladder.append(top)
    cache = {}

    def evaluate(months):
        fresh = [m for m in months if m not in cache]
        for i in range(0, len(fresh), VERIFY_CHUNK):
            part = fresh[i:i + VERIFY_CHUNK]
            cache.update(zip(part, probe(part)))

    first_hit = None
    for lo, hi in [(0, 1)] + [(i, i + LADDER_CHUNK) for i in range(1, len(ladder), LADDER_CHUNK)]:
        evaluate(ladder[lo:hi])
        hits = [m for m in ladder[lo:hi] if cache[m] >= target]
        if hits:
            first_hit = min(hits)
            break
    if cache[start] >= target:
        return start, cache[start]
    if first_hit is None:
        return -1, max(cache.values())
    margin = min(100.0, 150.0 / math.sqrt(n))
    tested = sorted(m for m in cache if m <= first_hit)
    near = next((i for i, m in enumerate(tested) if cache[m] >= target - margin),
                len(tested) - 1)
    evaluate(range(max(start, tested[max(0, near - 1)]), first_hit + 1))
    best = min(m for m, p in cache.items() if start <= m <= first_hit and p >= target)
    return best, cache[best]


def plan_answer(request: dict, device) -> dict:
    """The control's answer to one /api/simulate request."""
    cfg = request["config"]
    seed = philox.stream_seed(cfg["seed"], 0)
    n = int(cfg["num_simulations_search"])
    months, prob = search(
        lambda ms: loop.success_pct([cfg], ms, seed, n, LOW, device),
        int(cfg["starting_working_months_search"]), float(cfg["target_probability"]), n)
    if months < 0:
        return {"status": 400}
    run = loop.Loop([cfg], [months], philox.stream_seed(cfg["seed"], 1),
                    cfg["num_simulations_main"], LOW, device)
    served = stats.served(run.tracked(), int(cfg["retirement_years"]))
    return {"status": 200, "months": months, "search_prob": prob, "served": served}


def readings(cell: spec.Cell, seed: int, requests: int, device) -> dict:
    """The control's numbers on the first answers of ``seed``'s traffic."""
    gen = traffic.requests(cell.config, cell.mix, seed)
    if cell.mix["route"] == "/api/grid":
        body = next(gen)
        rng = np.random.default_rng([int(seed), 3])
        rows = sorted(rng.choice(len(body["variants"]), size=int(cell.mix["check_rows"]),
                                 replace=False).tolist())
        answer = check.grid_reference(body, rows, LOW, device)
        return check.grid_numbers(body, answer, rows, torch.float32, device)
    out: List[dict] = []
    for _ in range(requests):
        body = next(gen)
        out.append(check.plan_numbers(body, plan_answer(body, device), torch.float32, device))
    return check.worst(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--requests", type=int, default=2)
    args = parser.parse_args(argv)
    cell = spec.Cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        numbers = readings(cell, seed, args.requests, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
