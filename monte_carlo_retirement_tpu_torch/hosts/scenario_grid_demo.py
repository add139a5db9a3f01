"""BASELINE stretch config #5: a 256-variant scenario grid on one card.

    python -m monte_carlo_retirement_tpu_torch.hosts.scenario_grid_demo \
        [n_paths] [chunk] [seed] [--device {cuda,cpu}]

Port of ``scripts/scenario_grid_demo.py``: a 16 x 16 (expenses x equity
mean) grid of config.json at W = 231 through ``run_scenario_grid`` (the
grid kernel: one parameter row per scenario, shocks shared by the whole
grid), in chunks of ``chunk`` rows. Same arguments, defaults and table,
plus ``seed`` (the configs' and the grid's seed, default 1 as the JAX
script's configs): at seed 2026 and 1,000,000 paths it is the grid of
``chip_smoke.py`` phases 6 and 8a. ``--device cuda`` (the default) raises
without a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..config import Config, load_config_from_json
from ..engine.scenario_batch import run_scenario_grid

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
W = 231
R = 50
SIDE = 16
EXPENSES = np.linspace(4_000, 14_000, SIDE)
EQ_MEANS = np.linspace(0.06, 0.14, SIDE)


def grid_configs(seed: int = 1):
    """The 256 configs, expenses-major: row i * 16 + j has EXPENSES[i] and
    EQ_MEANS[j]."""
    raw = load_config_from_json(os.path.join(REPO, "config.json"))
    raw["seed"] = seed
    return [Config(**{**raw, "monthly_expenses": float(e), "inv1_returns_mean": float(m)})
            for e in EXPENSES for m in EQ_MEANS]


def run_demo(n_paths: int = 131_072, chunk: int = 16, seed: int = 1,
             device="cuda"):
    """(success % grid (16, 16), wall seconds)."""
    configs = grid_configs(seed)
    t0 = time.perf_counter()
    res = run_scenario_grid(configs, [W] * len(configs), n_paths, seed=seed,
                            chunk_size=chunk, device=device)
    elapsed = time.perf_counter() - t0
    return res.success_probability.reshape(SIDE, SIDE), elapsed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_paths", type=int, nargs="?", default=131_072)
    ap.add_argument("chunk", type=int, nargs="?", default=16)
    ap.add_argument("seed", type=int, nargs="?", default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(f"{SIDE * SIDE} scenarios x {args.n_paths:,} paths x {W + 12 * R} months, "
          f"chunks of {args.chunk}")
    grid, elapsed = run_demo(args.n_paths, args.chunk, args.seed, args.device)
    total_path_months = SIDE * SIDE * args.n_paths * (W + 12 * R)
    print(f"done in {elapsed:.1f}s  ({total_path_months / elapsed / 1e9:.2f}B "
          f"path-months/s)")
    print("success% grid (rows: expenses 4k->14k, cols: equity mean 6%->14%):")
    for e, row in zip(EXPENSES, grid):
        print(f"  {e:7,.0f}: " + " ".join(f"{v:5.1f}" for v in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
