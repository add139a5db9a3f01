"""Edge scenarios through the float32 kernels on the card.

    python -m monte_carlo_retirement_tpu_torch.hosts.edge_sweep \
        [--paths 4096] [--device {cuda,cpu}]

Port of ``scripts/edge_sweep_tpu.py``: the same ten extremes of config.json
(seed 7, retirement_years 10) — zero volatility, rho = +-1, a zero balance
funded by a pension, ruinous expenses, a $1e12 balance, one asset, maximal
volatility, a late capped stream, the annual mark-to-market bills — and the
four edge scenarios of ``tests/test_torch_oracle.py``. Each goes through
``Engine`` (``probe([0, 7, 24])`` on the search stream and ``run(7)`` on
the final stream) with the JAX script's checks: probes finite and in
[0, 100], success, final balances and trajectory percentiles finite, SWR
finite or NaN. Then the probe, grid and full kernels of its Statics are
held to their float64 plain versions at its month (120 for the ten, the
oracle test's own for the four), as ``hosts/fuzz.py`` holds them
(``fuzz.check_kernels``). Where every path lies beyond the $1e9
conditioning bound (the $1e12 balance) the float64 funding predicates mean
nothing, and the kernels are held to the float32 plain versions instead.

``--device cuda`` (the default) raises without a card; ``--device cpu``
runs the plain versions (the engine in float64, the kernels' side in
float32). Exit 0 = every edge clean, 1 = a check failed.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config, load_config_from_json
from ..engine.cuda_kernel import require_device, statics_from_config
from ..engine.runner import Engine
from . import fuzz

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SWEEP_MONTHS = (0, 7, 24)  # the probe's candidates: a partial working year
RUN_MONTHS = 7
# The month of the ten config.json edges' kernel check: at 7 most of them
# ruin every path; at 120 most are neither all ruined nor all safe.
CHECK_MONTHS = 120

# scripts/edge_sweep_tpu.py:32-61
EDGES = {
    "zero-vol deterministic": dict(
        inv1_returns_volatility=0.0, inv2_premium_over_inflation_volatility=0.0,
        inflation_rate_volatility=0.0,
    ),
    "rho=+1": dict(equity_inflation_correlation=1.0,
                   inv1_returns_volatility=0.2),
    "rho=-1": dict(equity_inflation_correlation=-1.0,
                   inv1_returns_volatility=0.2),
    "zero balance, pension-funded": dict(
        initial_balance=0.0, monthly_contribution=0.0,
        other_income_streams=[dict(
            name="pension", monthly_amount_today=10_000.0, start_at_age=40.0,
            duration_years=None, inflation_indexed=True, tax_rate=0.0)],
    ),
    "ruinous expenses": dict(monthly_expenses=500_000.0),
    "huge balance": dict(initial_balance=1e12, monthly_expenses=1e6),
    "all-in one asset": dict(allocation_inv1_pct=1.0),
    "max vol": dict(inv1_returns_volatility=1.0,
                    inflation_rate_volatility=0.05),
    "late stream + cap": dict(other_income_streams=[dict(
        name="late", monthly_amount_today=3_000.0, start_at_age=88.0,
        duration_years=1, inflation_indexed=False, tax_rate=0.5)]),
    "annual mark-to-market": dict(
        inv1_use_realized_gains_tax_system=False,
        inv1_annual_tax_on_gains_rate=0.4,
        inv2_use_realized_gains_tax_system=False,
        inv2_annual_tax_on_gains_rate=0.4,
    ),
}

# tests/test_torch_oracle.py::test_plain_loop_matches_oracle_on_edge_scenarios:
# overrides of its base scenario and the working months it runs at.
ORACLE_BASE = dict(
    retirement_years=3, seed=4242, monthly_expenses=1_800.0,
    inv1_use_realized_gains_tax_system=True, inv1_realized_gains_tax_rate=0.15,
    inv2_annual_tax_on_gains_rate=0.2, inv2_use_realized_gains_tax_system=False,
)
ORACLE_EDGES = {
    "oracle: single asset (inv2 only)": (dict(allocation_inv1_pct=0.0), 7),
    "oracle: single asset (inv1 only)": (dict(allocation_inv1_pct=1.0), 25),
    "oracle: empty": (dict(initial_balance=0.0, monthly_contribution=0.0), 0),
    "oracle: deflation, rho=-1": (dict(equity_inflation_correlation=-1.0,
                                       inflation_rate_mean=-0.005), 13),
}


def edge_configs() -> List[Tuple[str, Config, int]]:
    """(name, Config, working months of its kernel check) of every edge."""
    base = load_config_from_json(os.path.join(REPO, "config.json"))
    base.update(seed=7, retirement_years=10)
    out = [(name, Config(**{**base, **over}), CHECK_MONTHS)
           for name, over in EDGES.items()]
    out += [(name, fuzz.make_config(**ORACLE_BASE, **over), w)
            for name, (over, w) in ORACLE_EDGES.items()]
    return out


def sweep_edge(cfg: Config, n_paths: int = fuzz.PATHS, device="cuda") -> Dict:
    """The JAX script's drive of one edge: ``probe(SWEEP_MONTHS)`` and
    ``run(RUN_MONTHS)`` through ``Engine``, and its checks. Returns the
    probes, the run and the names of the checks that failed."""
    eng = Engine(cfg, device=device)
    probs = eng.probe(list(SWEEP_MONTHS), n_paths, stream="search")
    res = eng.run(RUN_MONTHS, n_paths, stream="final")
    checks = {
        "probe finite": all(math.isfinite(p) for p in probs),
        "probe in [0,100]": all(0.0 <= p <= 100.0 for p in probs),
        "success finite": math.isfinite(res.success_probability),
        "final balances finite": bool(np.isfinite(res.final_balance).all()),
        "trajectory finite": bool(np.isfinite(res.trajectory_percentiles).all()),
        "swr finite or nan": math.isfinite(res.swr) or math.isnan(res.swr),
    }
    return {"probes": probs, "run": res,
            "failed": [name for name, ok in checks.items() if not ok]}


def check_edge(cfg: Config, working_months: int, n_paths: int = fuzz.PATHS,
               device="cuda") -> Dict:
    """``fuzz.check_kernels`` at the edge's month; against the float32
    plain versions where every path is beyond the conditioning bound.
    Adds ``reference``: the plain versions' dtype."""
    check = fuzz.check_kernels(cfg, working_months, n_paths, device)
    check["reference"] = "float64"
    if check["skipped"] == n_paths:
        check = fuzz.check_kernels(cfg, working_months, n_paths, device,
                                   ref_dtype=torch.float32)
        check["reference"] = "float32 (every path beyond the bound)"
    return check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", type=int, default=fuzz.PATHS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    edges = edge_configs()
    if args.device == "cuda":
        built, wall = fuzz.build_libraries([statics_from_config(c)
                                            for _, c, _ in edges])
        print(f"built {built} month-loop libraries in {wall:.1f} s")
    failures = []
    for name, cfg, w in edges:
        out = sweep_edge(cfg, args.paths, args.device)
        check = check_edge(cfg, w, args.paths, args.device)
        bad = out["failed"] + ([] if check["ok"] else ["kernels vs plain"])
        print(f"{'OK ' if not bad else 'FAIL'} {name:34s} probes="
              f"{['%.1f' % p for p in out['probes']]} success="
              f"{out['run'].success_probability:.1f}%; kernels at W={w} vs "
              f"{check['reference']} plain: {fuzz.describe(check)}", flush=True)
        if bad:
            failures.append((name, bad))
    if failures:
        print("\nFAILURES:", failures)
        return 1
    print(f"\nall {len(edges)} edge scenarios clean on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
