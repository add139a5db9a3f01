"""Card-time breakdown of the port's hot path.

    python -m monte_carlo_retirement_tpu_torch.hosts.profile_card

On one CUDA card, with config.json (seed 2026):

  * the spread over 10 warm CUDA-event-timed runs of one 16-candidate
    probe, the full kernel alone, and the full kernel plus ``summarize``, at
    1M paths x 600 months (retirement_years=50, W=0; the scenario of
    chip_smoke.py phase 6);
  * the same spread for one 16-row chunk of the 16 x 16 scenario grid
    (expenses 4,000-14,000 x equity mean 0.06-0.14, W=231, R=50, 1M paths);
  * ``torch.profiler`` tables of full + summarize at that size, of the
    main path (search, then final run) at 1M search + 1M final paths and of
    the whole 256-variant x 1M grid through ``run_scenario_grid``, each
    with its wall time, the card's busy time (the sum of device-side events)
    and the idle share 1 - busy / wall.

Run it from the repository root (it reads ``config.json`` there).
"""

from __future__ import annotations

import json
import logging
import subprocess
import time

N_PATHS = 1_000_000
SEED = 2026
GRID_W = 231


def _config(**overrides):
    from ..config import Config

    with open("config.json", encoding="utf-8") as fh:
        raw = json.load(fh)
    raw["seed"] = SEED
    raw.update(overrides)
    return Config(**raw)


def _grid_configs():
    """The 256 variants of the 16 x 16 grid, expenses-major."""
    import numpy as np

    return [
        _config(monthly_expenses=float(e), inv1_returns_mean=float(m))
        for e in np.linspace(4_000, 14_000, 16)
        for m in np.linspace(0.06, 0.14, 16)
    ]


def _spread(fn, runs=10):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return sorted(out)


def _trace(label, fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    ) / 1e3
    print(f"--- {label}: wall {wall_ms:.1f} ms, card busy {busy_ms:.1f} ms, "
          f"idle share {1.0 - busy_ms / wall_ms:.3f}")
    print(events.table(sort_by="self_device_time_total", row_limit=12))


def main() -> int:
    import torch

    from ..engine import cuda_kernel as ck
    from ..engine.runner import Engine
    from ..engine.simulator import RetirementMonteCarloSimulator
    from ..ops.stats import summarize

    ck.require_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    eng = Engine(_config(retirement_years=50, initial_balance=1.5e6,
                         monthly_expenses=4000.0), device="cuda")
    R, n = eng.retirement_years, N_PATHS
    L = 1 + eng._t_scan(0) // 12
    probe_packed = eng._pack(list(range(16)), "search")
    full_packed = eng._pack(0, "final")
    sample_idx = torch.arange(5, device="cuda")

    def full():
        return ck.simulate_full(full_packed, eng.statics, R, n, L)

    for name, fn in (
        ("probe", lambda: ck.probe(probe_packed, eng.statics, R, n)),
        ("full kernel", full),
        ("full + summarize", lambda: summarize(full(), sample_idx)),
    ):
        ts = _spread(fn)
        print(f"{name}: min {ts[0]:.3f} median {(ts[4] + ts[5]) / 2:.3f} "
              f"max {ts[-1]:.3f} ms (10 runs, 1M x 600)")
    _trace("full + summarize, 1M x 600", lambda: summarize(full(), sample_idx))

    def main_path():
        cfg = _config(num_simulations_search=n, num_simulations_main=n)
        sim = RetirementMonteCarloSimulator(cfg, device="cuda")
        months, _, curve = sim.find_minimum_working_months(verbose=False)
        sim.use_final_seeds()
        sim.run_monte_carlo_simulations(months, n)
        return months, len(curve)

    months, n_cand = main_path()  # warm
    ck.reset_counts()
    _trace("main path, 1M search + 1M final paths", main_path)
    print(f"main path: {months} months, {n_cand} candidates; launches {ck.LAUNCHES}")

    from ..engine.scenario_batch import grid_statics, run_scenario_grid
    from ..models.retirement import stack_params

    logging.getLogger("mcrt.config").setLevel(logging.ERROR)  # 256 warnings
    configs = _grid_configs()
    chunk = configs[10 * 16:11 * 16]
    statics = grid_statics(chunk)
    GR = chunk[0].retirement_years
    packed = ck.pack_grid(stack_params(chunk), SEED, [GRID_W] * 16, GR,
                          device="cuda")
    ts = _spread(lambda: ck.grid(packed, statics, GR, n))
    print(f"grid chunk: min {ts[0]:.3f} median {(ts[4] + ts[5]) / 2:.3f} "
          f"max {ts[-1]:.3f} ms (10 runs, 16 x 1M x {GRID_W + 12 * GR})")

    def grid():
        return run_scenario_grid(configs, [GRID_W] * len(configs), n,
                                 seed=SEED, device="cuda")

    grid()  # warm
    ck.reset_counts()
    _trace(f"256-variant x 1M scenario grid, W={GRID_W}, R={GR}", grid)
    print(f"scenario grid: launches {ck.LAUNCHES}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
