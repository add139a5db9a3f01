"""The month-loop kernels against their float64 plain versions over random
scenarios: the kernel leg of the oracle fuzz campaign.

    python -m monte_carlo_retirement_tpu_torch.hosts.fuzz [--trials 500] \
        [--seed 0] [--paths 4096] [--device {cuda,cpu}]

Port of ``scripts/oracle_fuzz_campaign.py``. Each trial draws one random
scenario and its working months W from ``np.random.default_rng(case
seed)`` exactly as ``tests/test_fuzz_parity.py::run_differential_case``
does (the generator and its base config are copied here:
:func:`random_config`, :func:`base_config_dict`), then holds three kernels,
built for that scenario's ``Statics``, to their plain versions run in
float64 on the same device and on the same Philox draws (the plain loop
draws the kernel's float32 normals and widens them, so precision is the
only difference):

  * ``probe_kernel`` on 16 candidates around W;
  * ``grid_kernel`` on a 3-row block of the scenario at W and two other
    months;
  * ``full_kernel`` at W.

The bounds are gate (b)'s, the ones the JAX suite holds Pallas to against
the scan kernel (``tests/test_pallas_parity.py:128-133, 311-323``), per run
of n paths: a probe or grid row's success flags mismatching on fewer than
3e-3 of the paths (a full run's on fewer than 1e-3), and fewer than 1e-3
of the final balances off by more than 5e-3 relative and $5
(:func:`compare_rows`, :func:`compare_full`; ``chip_smoke.py`` holds the
kernels to their float32 plain versions with the same two). Paths whose
balances cross the $1e9 conditioning bound of the float64 funding
predicates (``docs/PARITY.md:160-184``) are skipped and counted. The
float64 plain loop is itself held to the NumPy oracle on the CPU
(``tests/test_torch_oracle.py``), so a clean campaign ties the kernels to
the oracle.

Every trial's library is built before the first trial, one nvcc each, all
started together. The campaign stops at the first failing trial and prints
its case seed. ``--device cuda`` (the default) raises without a card;
``--device cpu`` holds the float32 plain versions (what the wrappers run on
a CPU tensor) to the float64 ones. Exit 0 = every trial clean, 1 = a trial
failed.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..config import Config
from ..engine import _build
from ..engine import cuda_kernel as ck
from ..engine.cuda_kernel import pack_grid, pack_params, require_device
from ..engine.kernel import drawn_shocks
from ..engine.runner import Engine
from ..models.retirement import stack_params

PATHS = 4096  # one global Philox block
# scripts/fuzz_campaign.py:75: above it the float64 funding predicates'
# absolute epsilon is below one ulp of the balance (docs/PARITY.md).
PREDICATE_SCALE_BOUND = 1e9
FLAG_MISMATCH = 3e-3  # share of a probe or grid row's paths whose flag may differ
FIELD_RTOL = 5e-3  # relative bound of a value (|reference| floored at 1)
DUST_USD = 5.0  # balances off by less than this are no divergence
PATH_SHARE = 1e-3  # share of a run's entries (a full run's flags) off the bounds
PROBE_TOL_PTS = 0.3  # per-row success, points (or one path at small n)
ONE_MONTH_YEARS = 1.0 / 12.0

# tests/conftest.py::base_config_dict
BASE_CONFIG = {
    "scenario": "test",
    "initial_balance": 500_000.0,
    "monthly_contribution": 0.0,
    "contribution_growth_rate_annual": 0.0,
    "monthly_expenses": 2_000.0,
    "current_age": 40.0,
    "retirement_years": 10,
    "allocation_inv1_pct": 0.6,
    "inv1_returns_mean": 0.08,
    "inv1_returns_volatility": 0.15,
    "inv1_annual_tax_on_gains_rate": 0.0,
    "inv1_realized_gains_tax_rate": 0.0,
    "inv1_use_realized_gains_tax_system": False,
    "inv2_premium_over_inflation_mean": 0.02,
    "inv2_premium_over_inflation_volatility": 0.01,
    "inv2_annual_tax_on_gains_rate": 0.0,
    "inv2_realized_gains_tax_rate": 0.0,
    "inv2_use_realized_gains_tax_system": False,
    "inflation_rate_mean": 0.03,
    "inflation_rate_volatility": 0.01,
    "equity_inflation_correlation": 0.0,
    "num_simulations_main": 50,
    "num_simulations_search": 40,
    "target_probability": 80.0,
    "starting_working_months_search": 0,
    "seed": 42,
    "num_processes": 1,
    "other_income_streams": [],
}

# What a trial can exercise beyond config.json's Statics (random_config
# never sets antithetic).
EXTENSIONS = ("longevity", "crashes", "guardrails", "glide", "annual bills",
              "fixed streams", "capped streams")


def base_config_dict(**overrides) -> dict:
    data = dict(BASE_CONFIG, other_income_streams=[])
    data.update(overrides)
    return data


def make_config(**overrides) -> Config:
    return Config(**base_config_dict(**overrides))


def random_config(rng: np.random.Generator, extensions: bool = True) -> Config:
    """Random scenario, draw for draw ``tests/test_fuzz_parity.py::
    _random_config``: the same generator state gives the same Config.
    ``extensions=False`` drops the glide, guardrail, crash, longevity and
    fee fields after drawing them."""
    n_streams = int(rng.integers(0, 3))
    streams = []
    for s in range(n_streams):
        streams.append(
            {
                "name": f"s{s}",
                "monthly_amount_today": float(rng.uniform(0, 3000)),
                "start_at_age": float(rng.uniform(40, 70)),
                "duration_years": (
                    None if rng.random() < 0.5 else int(rng.integers(0, 15))
                ),
                "inflation_indexed": bool(rng.random() < 0.5),
                "tax_rate": float(rng.uniform(0, 0.4)),
            }
        )
    use_real1 = bool(rng.random() < 0.5)
    use_real2 = bool(rng.random() < 0.5)
    glide = None if rng.random() < 0.5 else float(rng.uniform(0, 1))
    guardrails = (
        None if rng.random() < 0.67 else {
            "upper_wr_pct": float(rng.uniform(4.0, 12.0)),
            "lower_wr_pct": float(rng.uniform(0.5, 3.5)),
            "adjustment_pct": float(rng.uniform(5.0, 20.0)),
            "floor_pct": float(rng.uniform(30.0, 80.0)),
            "cap_pct": float(rng.uniform(120.0, 250.0)),
        }
    )
    crashes = (
        None if rng.random() < 0.67 else {
            "frequency_per_year": float(rng.uniform(0.1, 4.0)),
            "mean_drop_pct": float(rng.uniform(5.0, 50.0)),
            "size_volatility": float(rng.uniform(0.0, 0.6)),
            "inv2_beta": float(rng.uniform(0.0, 1.0)),
        }
    )
    current_age = float(rng.uniform(30, 55))
    longevity = (
        None if rng.random() < 0.67 else {
            "mode_age": float(current_age + rng.uniform(-3.0, 15.0)),
            "dispersion_years": float(rng.uniform(2.0, 15.0)),
            "max_age": float(current_age + rng.uniform(16.0, 50.0)),
        }
    )
    fee1 = 0.0 if rng.random() < 0.5 else float(rng.uniform(0.0, 0.02))
    fee2 = 0.0 if rng.random() < 0.5 else float(rng.uniform(0.0, 0.02))
    if not extensions:
        glide = guardrails = crashes = longevity = None
        fee1 = fee2 = 0.0
    return make_config(
        inv1_expense_ratio_annual=fee1,
        inv2_expense_ratio_annual=fee2,
        initial_balance=float(rng.uniform(0, 400_000)),
        monthly_contribution=float(rng.uniform(0, 6000)),
        contribution_growth_rate_annual=float(rng.uniform(0, 0.06)),
        monthly_expenses=float(rng.uniform(500, 6000)),
        current_age=current_age,
        retirement_years=int(rng.integers(1, 7)),
        allocation_inv1_pct=float(rng.uniform(0, 1)),
        allocation_inv1_final_pct=glide,
        spending_guardrails=guardrails,
        market_crashes=crashes,
        longevity=longevity,
        inv1_returns_mean=float(rng.uniform(-0.05, 0.15)),
        inv1_returns_volatility=float(rng.uniform(0, 0.25)),
        inv1_annual_tax_on_gains_rate=float(rng.uniform(0, 0.4)),
        inv1_realized_gains_tax_rate=float(rng.uniform(0, 0.3)),
        inv1_use_realized_gains_tax_system=use_real1,
        inv2_premium_over_inflation_mean=float(rng.uniform(-0.02, 0.08)),
        inv2_premium_over_inflation_volatility=float(rng.uniform(0, 0.05)),
        inv2_annual_tax_on_gains_rate=float(rng.uniform(0, 0.4)),
        inv2_realized_gains_tax_rate=float(rng.uniform(0, 0.3)),
        inv2_use_realized_gains_tax_system=use_real2,
        inflation_rate_mean=float(rng.uniform(-0.01, 0.09)),
        inflation_rate_volatility=float(rng.uniform(0, 0.04)),
        equity_inflation_correlation=float(rng.uniform(-1, 1)),
        other_income_streams=streams,
        seed=int(rng.integers(0, 2**31)),
    )


def case_seed(seed: int, trial: int) -> int:
    """``oracle_fuzz_campaign.py``'s case seed of trial ``trial``."""
    return seed * 1_000_000 + 7_000_000 + trial


def trial_case(seed: int):
    """(Config, W) of one case seed: the scenario, then W, from one rng."""
    rng = np.random.default_rng(seed)
    cfg = random_config(rng)
    return cfg, int(rng.integers(0, 40))


def extensions_of(statics) -> Dict[str, bool]:
    """Which of EXTENSIONS a Statics turns on."""
    return {
        "longevity": statics.mortality, "crashes": statics.jumps,
        "guardrails": statics.guardrails, "glide": statics.glide,
        "annual bills": statics.bill1 or statics.bill2,
        "fixed streams": not all(statics.stream_indexed),
        "capped streams": any(statics.stream_capped),
    }


def build_libraries(statics: Sequence) -> tuple:
    """Build every month-loop library of ``statics`` that is not built yet,
    one nvcc each, all started together: (libraries built, wall s)."""
    t0 = time.perf_counter()
    _paths, built = _build.build_many(list(statics))
    return built, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# the comparison: gate (b), here and in chip_smoke.py
# ---------------------------------------------------------------------------
def _off(a: torch.Tensor, b: torch.Tensor, dust: bool) -> torch.Tensor:
    """Entries of ``a`` beyond FIELD_RTOL of the reference ``b`` (|b|
    floored at 1), and with ``dust`` also beyond DUST_USD; NaN == NaN."""
    a, b = a.double(), b.double()
    diff = (a - b).abs()
    off = diff > FIELD_RTOL * b.abs().clamp_min(1.0)
    if dust:
        off &= diff > DUST_USD
    return off & ~(a.isnan() & b.isnan())


def _q999(a: torch.Tensor, b: torch.Tensor) -> float:
    """The 99.9th percentile of the final balances' relative error."""
    rel = (a.double() - b.double()).abs() / b.double().abs().clamp_min(1.0)
    return float(np.quantile(rel.flatten().cpu().numpy(), 0.999)) if rel.numel() else 0.0


def compare_rows(out_k: ck.ProbeOut, out_p: ck.ProbeOut, keep: torch.Tensor) -> dict:
    """Gate (b) of a probe or grid launch (K, n) against its reference on
    the paths ``keep``: the kernel's counts equal its own flags, and per row
    the success within PROBE_TOL_PTS points (or one path), flags
    mismatching on fewer than FLAG_MISMATCH of the paths, final balances
    off (beyond FIELD_RTOL and DUST_USD) on fewer than PATH_SHARE of them.
    Each share is the worst row's."""
    flags_k, flags_p = out_k.success > 0.5, out_p.success > 0.5
    counts = torch.equal(out_k.counts.cpu(), flags_k.sum(dim=1).cpu())
    m = int(keep.sum())
    if m == 0:
        return {"counts": counts, "d_success": 0.0, "flags": 0.0, "off": 0.0,
                "q999": 0.0, "ok": counts}
    fk, fp = flags_k[:, keep], flags_p[:, keep]
    pk = fk.sum(dim=1).double() / m * 100
    pp = fp.sum(dim=1).double() / m * 100
    d_success = float((pk - pp).abs().max())
    flags = float((fk != fp).double().mean(dim=1).max())
    a, b = out_k.final_balance[:, keep], out_p.final_balance[:, keep]
    off = float(_off(a, b, dust=True).double().mean(dim=1).max())
    return {
        "counts": counts, "d_success": d_success, "flags": flags, "off": off,
        "q999": _q999(a, b),
        "ok": (counts and d_success <= max(PROBE_TOL_PTS, 100.0 / m)
               and flags < FLAG_MISMATCH and off < PATH_SHARE),
    }


def compare_full(k: dict, p: dict, keep: torch.Tensor, guardrails: bool,
                 dust: bool = True) -> dict:
    """Gate (b) of a full run against its reference on the paths ``keep``:
    success flags differing on fewer than PATH_SHARE of them; each
    balance and the price levels off on fewer than PATH_SHARE of their
    entries (the balances beyond FIELD_RTOL and, with ``dust``, DUST_USD);
    years-to-ruin NaN alike but on PATH_SHARE of the paths, a ruin month
    moved on fewer than PATH_SHARE of them and by at most one month;
    withdrawal rates NaN alike but on PATH_SHARE of the entries and within
    1e-4 + FIELD_RTOL (with guardrails, PATH_SHARE of the entries may
    differ: a path within round-off of a band takes the other branch).
    ``wr_err`` is the largest withdrawal-rate difference (points)."""
    m = int(keep.sum())
    if m == 0:
        return {"flags": 0.0, "q999": 0.0, "off": {}, "wr_err": 0.0, "ok": True}
    k = {name: v[keep] for name, v in k.items()}
    p = {name: v[keep] for name, v in p.items()}
    flags = float(((k["success"] > 0.5) != (p["success"] > 0.5)).double().mean())
    off = {name: float(_off(k[name], p[name], dust=dust and name != "price_levels"
                            and name != "inflation_at_retirement").double().mean())
           for name in ("final_balance", "start_balance", "first_year_gross",
                        "first_year_real_gross", "inflation_at_retirement",
                        "trajectory", "price_levels")}
    ytr_k, ytr_p = k["years_to_ruin"], p["years_to_ruin"]
    ytr_nan = float((ytr_k.isnan() != ytr_p.isnan()).double().mean())
    both = ~ytr_k.isnan() & ~ytr_p.isnan()
    ytr_diff = (ytr_k[both].double() - ytr_p[both].double()).abs()
    ytr_moved = float((ytr_diff > 1e-5).double().sum()) / m
    ytr_err = float(ytr_diff.max()) if bool(both.any()) else 0.0
    wr_k, wr_p = k["withdrawal_rates"].double(), p["withdrawal_rates"].double()
    wr_nan = float((wr_k.isnan() != wr_p.isnan()).double().mean())
    both = ~wr_k.isnan() & ~wr_p.isnan()
    wr_diff = (wr_k - wr_p).abs()[both]
    wr_bad = float((wr_diff > 1e-4 + FIELD_RTOL * wr_p.abs()[both]).double().sum()
                   ) / max(wr_k.numel(), 1)
    return {
        "flags": flags, "q999": _q999(k["final_balance"], p["final_balance"]),
        "off": off, "ytr_nan": ytr_nan, "ytr_moved": ytr_moved,
        "ytr_err": ytr_err, "wr_nan": wr_nan, "wr_bad": wr_bad,
        "wr_err": float(wr_diff.max()) if wr_diff.numel() else 0.0,
        "ok": (flags < PATH_SHARE and all(v < PATH_SHARE for v in off.values())
               and ytr_nan < PATH_SHARE and ytr_moved < PATH_SHARE
               and ytr_err <= ONE_MONTH_YEARS + 1e-5 and wr_nan < PATH_SHARE
               and (wr_bad < PATH_SHARE if guardrails else wr_bad == 0.0)),
    }


def check_kernels(cfg: Config, working_months: int, n_paths: int = PATHS,
                  device="cuda", ref_dtype=torch.float64) -> dict:
    """The probe, grid and full kernels of ``cfg``'s Statics against their
    plain versions in ``ref_dtype`` on ``device``, all on the final
    stream's draws (``kernel.drawn_shocks`` for the plain versions): the
    probe on 16 candidates around W, the grid on three rows of ``cfg`` at
    W, W + 12 and W // 2, the full run at W. On a CPU device the "kernel"
    side is the float32 plain version the wrappers run there. With a
    float64 reference, paths beyond PREDICATE_SCALE_BOUND in any of the
    reference's runs are skipped and counted. Returns {"probe", "grid",
    "full": gate (b)'s stats, "skipped": paths, "ok": bool}."""
    W = int(working_months)
    lo = max(0, W - 8)
    probe_months = list(range(lo, lo + 16))
    grid_months = [W, W + 12, W // 2]
    eng = Engine(cfg, device=device, dtype=torch.float32)
    st, R, n, dev = eng.statics, eng.retirement_years, int(n_paths), eng.device
    seed = eng._stream_seed("final")
    # The references' draws, all months at once (the plain loop would draw
    # them month by month, three times): the very values the kernels draw.
    T = max(list(probe_months) + list(grid_months) + [W]) + 12 * R
    shocks = drawn_shocks(st, seed, n, T, device=dev)

    def pack(months, dtype=torch.float32):
        return pack_params(eng.params, seed, months, R, dtype=dtype, device=dev)

    batch = stack_params([cfg] * len(grid_months))
    probe_k = ck.probe(pack(probe_months), st, R, n)
    probe_p = ck.probe_plain(pack(probe_months, ref_dtype), st, R, n, shocks)
    grid_k = ck.grid(pack_grid(batch, seed, grid_months, R, device=dev), st, R, n)
    grid_p = ck.grid_plain(pack_grid(batch, seed, grid_months, R, dtype=ref_dtype,
                                     device=dev), st, R, n, shocks)
    L = 1 + eng._t_scan(W) // 12
    full_k = ck.simulate_full(pack(W), st, R, n, L)
    full_p = ck.simulate_full_plain(pack(W, ref_dtype), st, R, n, L, shocks)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    if ref_dtype == torch.float64:
        scale = torch.stack([
            full_p["trajectory"].amax(dim=1), full_p["start_balance"],
            probe_p.final_balance.amax(dim=0), grid_p.final_balance.amax(dim=0)])
        keep = ~(scale.amax(dim=0) > PREDICATE_SCALE_BOUND)
    out = {"probe": compare_rows(probe_k, probe_p, keep),
           "grid": compare_rows(grid_k, grid_p, keep),
           "full": compare_full(full_k, full_p, keep, st.guardrails),
           "skipped": n - int(keep.sum())}
    out["ok"] = all(out[name]["ok"] for name in ("probe", "grid", "full"))
    return out


def describe(check: dict) -> str:
    """One line: each kernel's flag mismatch and q999 final-balance error."""
    return "; ".join(
        f"{name} flags {check[name]['flags']:.2e} q999 {check[name]['q999']:.2e}"
        for name in ("probe", "grid", "full")) + f"; skipped {check['skipped']}"


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------
def run_campaign(trials: int = 500, seed: int = 0, n_paths: int = PATHS,
                 device="cuda", log: Callable[[str], None] = print) -> dict:
    """Run ``trials`` trials; stop at the first that fails. Returns the
    campaign's summary: trials run and clean, the failing case seed (or
    None), the extension mix, paths skipped, the worst flag mismatch and
    q999 final-balance error per kernel and the campaign's wall."""
    require_device(device)
    cases = [(i, case_seed(seed, i), *trial_case(case_seed(seed, i)))
             for i in range(trials)]
    statics = [ck.statics_from_config(cfg) for _, _, cfg, _ in cases]
    if torch.device(device).type == "cuda":
        built, build_s = build_libraries(statics)
        log(f"built {built} month-loop libraries for {len(set(statics))} "
            f"Statics in {build_s:.1f} s (one nvcc each, started together)")
    mix = dict.fromkeys(EXTENSIONS, 0)
    worst = {name: {"flags": 0.0, "q999": 0.0} for name in ("probe", "grid", "full")}
    summary = {"trials": trials, "clean": 0, "failed_seed": None, "mix": mix,
               "skipped": 0, "paths": n_paths, "worst": worst}
    t0 = time.perf_counter()
    for (i, cs, cfg, W), st in zip(cases, statics):
        check = check_kernels(cfg, W, n_paths, device)
        summary["skipped"] += check["skipped"]
        on = [name for name, v in extensions_of(st).items() if v]
        log(f"trial {i} (seed {cs}): W={W} R={cfg.retirement_years} "
            f"{'+'.join(on) or 'no extensions'}: {describe(check)}")
        if not check["ok"]:
            summary["failed_seed"] = cs
            log(f"TRIAL {i} (seed {cs}) FAILED: {check}")
            break
        summary["clean"] += 1
        for name in mix:
            mix[name] += int(name in on)
        for name in worst:
            for key in ("flags", "q999"):
                worst[name][key] = max(worst[name][key], check[name][key])
    summary["wall_s"] = time.perf_counter() - t0
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", type=int, default=PATHS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    s = run_campaign(args.trials, args.seed, args.paths, args.device,
                     log=lambda line: print(line, flush=True))
    if s["failed_seed"] is not None:
        return 1
    rate = s["clean"] / max(s["wall_s"], 1e-9)
    worst = ", ".join(f"{k} flags {v['flags']:.2e} q999 {v['q999']:.2e}"
                      for k, v in s["worst"].items())
    print(f"CLEAN: {s['trials']} trials x {s['paths']:,} paths on {args.device} in "
          f"{s['wall_s']:.1f} s ({rate:.2f} trials/s); worst {worst}; paths "
          f"skipped beyond ${PREDICATE_SCALE_BOUND:.0e}: {s['skipped']}; "
          f"extension mix: {s['mix']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
