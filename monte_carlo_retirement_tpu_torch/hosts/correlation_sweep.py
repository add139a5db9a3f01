"""BASELINE parity config #3: equity-inflation correlation sweep.

    python -m monte_carlo_retirement_tpu_torch.hosts.correlation_sweep \
        [--device {cuda,cpu}]

Port of ``scripts/correlation_sweep.py``: rho over [-1, 1] (9 values) on
config.json (seed 2026) at W = 240, 2,000 paths each, through
``run_scenario_batch`` with shared shocks (identical draws, only the
correlation mixing differs); the rows share their Statics, so it is one
grid-kernel launch. Same table. ``--device cuda`` (the default) raises
without a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import Config, load_config_from_json
from ..engine.scenario_batch import run_scenario_batch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2026
W = 240
N_PATHS = 2000
RHOS = np.linspace(-1.0, 1.0, 9)


def sweep_configs():
    raw = load_config_from_json(os.path.join(REPO, "config.json"))
    raw["seed"] = SEED
    return [Config(**{**raw, "equity_inflation_correlation": float(r)}) for r in RHOS]


def run_sweep(n_paths: int = N_PATHS, device="cuda"):
    """The batch result of the 9 rows (``ScenarioBatchResult``)."""
    configs = sweep_configs()
    return run_scenario_batch(configs, [W] * len(configs), num_simulations=n_paths,
                              seed=SEED, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    result = run_sweep(N_PATHS, args.device)
    print(f"{'rho':>6} {'success %':>10} {'median final':>16}")
    for r, p, m in zip(RHOS, result.success_probability, result.median_final_balance):
        print(f"{r:6.2f} {p:10.2f} {m:16,.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
