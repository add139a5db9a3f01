"""Cross-backend statistical parity: the scan engine against the kernel.

    python -m monte_carlo_retirement_tpu_torch.hosts.cross_backend_check \
        [--paths 131072] [--device {cuda,cpu}]

Port of ``scripts/cross_backend_check.py``. Three cases (config.json at
W = 231 and W = 216 with 50 retirement years, jorge.json at W = 76 with
40) run at N paths in float32 through the two engines, each on its own
stream:

  * the scan, ``engine/kernel.simulate_paths`` on the final key of
    ``stream_keys(2026)`` (threefry);
  * the kernel, the grid kernel's one-row launch ``cuda_kernel.simulate``
    on stream seed 2026 (Philox; its float32 plain version on the CPU).

Each line gives both success rates, their difference and 3 sigma of the
difference (binomial, both engines at N). The two must agree within
``max(3 sigma, 0.5)`` points (BASELINE's parity criterion); the script
exits 1 when a case does not. ``--device cuda`` (the default) raises
without a card.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import List, NamedTuple

import torch

from ..config import Config, load_config_from_json
from ..engine import cuda_kernel as ck
from ..engine.kernel import simulate_paths
from ..models.retirement import SimParams
from ..ops.shocks import stream_keys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_PATHS = 131_072
SEED = 2026
TOLERANCE_PTS = 0.5  # the floor of the rule, points

CASES = (
    ("config.json @ W=231", "config.json", 231, 50),
    ("config.json @ W=216", "config.json", 216, 50),
    ("jorge.json  @ W=76", "jorge.json", 76, 40),
)


class CaseResult(NamedTuple):
    name: str
    scan_pct: float
    kernel_pct: float
    diff: float
    three_sigma: float

    @property
    def ok(self) -> bool:
        return abs(self.diff) <= max(self.three_sigma, TOLERANCE_PTS)


def run_case(name: str, fname: str, W: int, R: int, n: int = N_PATHS,
             device="cuda") -> CaseResult:
    """One case: the scan's and the kernel's success rates at W."""
    raw = load_config_from_json(os.path.join(REPO, fname))
    raw["retirement_years"] = R
    config = Config(**raw)
    params = SimParams.from_config(config, device=device)
    _, key = stream_keys(SEED)
    t_scan = ((W + 12 * R + 59) // 60) * 60
    outs = simulate_paths(params, W, key, n_paths=n, t_scan=t_scan,
                          retirement_years=R, traj_len=0,
                          dtype=torch.float32)
    p_scan = float(outs.success.double().mean()) * 100.0
    sim = ck.simulate(ck.pack_params(params, SEED, W, R, device=device),
                      ck.statics_from_config(config), R, n)
    p_kernel = float((sim.success[:n] > 0.5).double().mean()) * 100.0
    p = (p_scan + p_kernel) / 200.0
    se3 = 3.0 * math.sqrt(2 * p * (1 - p) / n) * 100.0
    return CaseResult(name, p_scan, p_kernel, p_scan - p_kernel, se3)


def check(n: int = N_PATHS, device="cuda") -> List[CaseResult]:
    ck.require_device(device)
    return [run_case(name, fname, W, R, n, device)
            for name, fname, W, R in CASES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", type=int, default=N_PATHS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(f"{'case':24s} {'scan %':>8} {'kernel %':>9} {'diff':>7} {'3σ':>6}")
    results = check(args.paths, args.device)
    for r in results:
        flag = "" if r.ok else "  <-- MISMATCH"
        print(f"{r.name:24s} {r.scan_pct:8.3f} {r.kernel_pct:9.3f} "
              f"{r.diff:7.3f} {r.three_sigma:6.3f}{flag}")
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
