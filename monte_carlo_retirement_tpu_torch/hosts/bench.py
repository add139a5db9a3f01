"""The headline measurement on the card: 1M paths x 600 months.

    python -m monte_carlo_retirement_tpu_torch.hosts.bench [--paths 1000000] \
        [--device {cuda,cpu}]

Port of ``bench.py`` on its workload: config.json with retirement_years 50,
initial balance 1.5e6 and expenses 4,000 a month, retired at W = 0, so
every path simulates 600 months. Two times, each the least over REPEATS
chains of runs with distinct seeds, per run, by CUDA events around the
chain:

  * ``value``: ``cuda_kernel.simulate`` (the grid kernel's one-row launch)
    plus the success mean on the card, CHAIN runs per chain;
  * ``full_stats_ms``: the full kernel plus every reduction
    ``Engine.run(reduced=True)`` makes on the card (``ops/stats.summarize``
    and ``serving_bins``), half as many runs per chain (each holds ~0.6 GB
    of series).

Every run's parameter block is packed before the clock starts. Prints one
JSON line: ``metric``, ``value``, ``unit``, ``success_rate_pct``,
``full_stats_ms`` and the card's ``card_name`` and ``power_limit`` (from
nvidia-smi). bench.py's ``vs_baseline``, ``full_stats_target_ms`` and
``full_stats_vs_target`` are left out: their 50 and 150 ms are TPU
targets. ``--device cuda`` (the default) raises without a card; ``--device
cpu`` times the float32 plain versions with the host clock and names the
CPU (no power limit).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import Config, load_config_from_json
from ..engine import cuda_kernel as ck
from ..engine.cuda_kernel import require_device
from ..engine.runner import Engine
from ..ops.stats import serving_bins, summarize

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_PATHS = 1_000_000
RETIREMENT_YEARS = 50  # 600 months
REPEATS = 5
CHAIN = 10


def workload(n_paths: int = N_PATHS, device="cuda") -> Engine:
    """bench.py's scenario on ``device`` (float32)."""
    raw = load_config_from_json(os.path.join(REPO, "config.json"))
    raw.update(retirement_years=RETIREMENT_YEARS, initial_balance=1_500_000.0,
               monthly_expenses=4_000.0)
    return Engine(Config(**raw), device=device, dtype=torch.float32)


def card(device) -> tuple:
    """(name, power limit) of the card as nvidia-smi gives them; the CPU's
    name and None on the CPU."""
    if torch.device(device).type == "cpu":
        return platform.processor() or platform.machine(), None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (part.strip() for part in out.rsplit(",", 1))
    return name, limit


def _per_run_ms(chain, device) -> float:
    """Milliseconds per run of one chain (a list of thunks)."""
    if torch.device(device).type == "cpu":
        t0 = time.perf_counter()
        for fn in chain:
            fn()
        return (time.perf_counter() - t0) * 1e3 / len(chain)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for fn in chain:
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(chain)


def bench(n_paths: int = N_PATHS, device="cuda") -> dict:
    """Both times on ``device``; returns the JSON line's fields."""
    require_device(device)
    repeats, chain = REPEATS, CHAIN
    eng = workload(n_paths, device)
    st, R, n = eng.statics, eng.retirement_years, int(n_paths)
    L = 1 + eng._t_scan(0) // 12
    sample_idx = torch.as_tensor(
        np.random.default_rng(eng.main_seed).choice(n, size=min(5, n), replace=False),
        device=eng.device)

    def packed(seed):
        return ck.pack_params(eng.params, seed, [0], R, device=eng.device)

    def run(p):
        out = ck.simulate(p, st, R, n)
        return out.success.mean() * 100.0

    def run_full(p):
        full = ck.simulate_full(p, st, R, n, L)
        return summarize(full, sample_idx), serving_bins(full, R)

    full_chain = max(1, chain // 2)
    seeds = iter(range(1 + (repeats + 1) * (chain + full_chain)))
    warm = packed(next(seeds))
    rate = float(run(warm))
    times, full_times = [], []
    for rep in range(repeats + 1):  # the first chain of each warms up
        blocks = [packed(next(seeds)) for _ in range(chain)]
        ms = _per_run_ms([lambda p=p: run(p) for p in blocks], device)
        blocks = [packed(next(seeds)) for _ in range(full_chain)]
        full_ms = _per_run_ms([lambda p=p: run_full(p) for p in blocks], device)
        if rep:
            times.append(ms)
            full_times.append(full_ms)
    name, limit = card(device)
    return {
        "metric": f"{n:,} paths x {12 * R}-month retirement MC, one "
                  f"{'card' if eng.device.type == 'cuda' else 'CPU'}",
        "value": round(min(times), 3),
        "unit": "ms",
        "success_rate_pct": round(rate, 2),
        "full_stats_ms": round(min(full_times), 3),
        "card_name": name,
        "power_limit": limit,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", type=int, default=N_PATHS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    line = bench(args.paths, args.device)
    if not (math.isfinite(line["value"]) and math.isfinite(line["full_stats_ms"])):
        raise RuntimeError(f"non-finite times: {line}")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
