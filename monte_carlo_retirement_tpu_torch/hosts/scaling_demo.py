"""Path-parallel scaling of the scan over a paths mesh.

    python -m monte_carlo_retirement_tpu_torch.hosts.scaling_demo \
        [--paths 131072] [--device {cuda,cpu}] [--repeats 3]

Port of ``scripts/scaling_demo.py``: the same batch (config.json with 10
retirement years, the final key of ``stream_keys(7)``, W = 0, T = 120
months, float32) over 1, 2, 4 and 8 shards, the scan's rows split over
the shards (each draws its own global rows) and the survivors summed.
Each line gives the best of ``--repeats`` walls, the speed-up over one
shard and the success rate, which must be the same at every shard count.
Then the same batch through the sharded kernel (``engine/sharded.
simulate_sharded``, the Philox stream).

On the card the shards are ``cuda:0`` repeated: they run in turn on one
card, so the speed-up there measures the cost of splitting, not scaling
across cards. ``--device cpu`` runs CPU shards in one process, as the
JAX script runs virtual CPU devices.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, NamedTuple

import torch

from ..config import Config, load_config_from_json
from ..engine.cuda_kernel import require_device, statics_from_config
from ..engine.kernel import scan_rows
from ..engine.sharded import simulate_sharded
from ..models.retirement import SimParams
from ..ops.shocks import stream_keys
from ..parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_PATHS = 128 * 1024
T_SCAN = 120
RETIREMENT_YEARS = 10
SHARDS = (1, 2, 4, 8)


class Line(NamedTuple):
    engine: str
    shards: int
    best_ms: float
    speedup: float
    success_pct: float


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _params(device):
    raw = load_config_from_json(os.path.join(REPO, "config.json"))
    raw["retirement_years"] = RETIREMENT_YEARS
    config = Config(**raw)
    return config, SimParams.from_config(config, device=device)


def scan_success(params, key, n: int, shards: int, device) -> float:
    """The batch's success rate with its rows split over ``shards``
    shards of ``device``: every shard launched, then the counts read."""
    per = -(-n // shards)
    counts = []
    for g in range(shards):
        rows = min(per, n - g * per)
        if rows <= 0:
            continue
        out = scan_rows(params, [0], key, n_paths=rows, t_scan=T_SCAN,
                        retirement_years=RETIREMENT_YEARS,
                        dtype=torch.float32, row_offset=g * per,
                        device=device)
        counts.append((out["success"][0] > 0.5).sum())
    return float(sum(c.cpu() for c in counts)) / n * 100.0


def _timed(fn, repeats: int, device):
    value, times = fn(), []  # the first call warms up
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        value = fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return min(times), value


def demo(n: int = N_PATHS, device="cuda", repeats: int = 3) -> List[Line]:
    require_device(device)
    config, params = _params(device)
    _, key = stream_keys(7)
    statics = statics_from_config(config)
    lines: List[Line] = []
    for engine in ("scan", "kernel"):
        base = None
        for k in SHARDS:
            if engine == "scan":
                fn = lambda k=k: scan_success(params, key, n, k, device)
            else:
                mesh = make_mesh([device] * k)
                fn = lambda mesh=mesh: float(
                    (simulate_sharded(params, 7, 0, RETIREMENT_YEARS, n,
                                      statics, mesh=mesh).success[:n] > 0.5)
                    .double().mean()) * 100.0
            best, rate = _timed(fn, repeats, device)
            base = best if base is None else base
            lines.append(Line(engine, k, best * 1e3, base / best, rate))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", type=int, default=N_PATHS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print("shards are cuda:0 repeated: they run in turn on one card, so "
              "the speed-up is not scaling across cards")
    for ln in demo(args.paths, args.device, args.repeats):
        print(f"{ln.engine:6s} {ln.shards} shard(s): {ln.best_ms:8.1f} ms   "
              f"speedup {ln.speedup:4.2f}x   success {ln.success_pct:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
