"""Tile shapes of the probe and grid kernels on the card, side by side.

    python -m monte_carlo_retirement_tpu_torch.hosts.tile_sweep

On one CUDA card, at chip_smoke.py phase 6's shapes (CUDA events, warm, min
of 3): the 16-candidate probe at 1M paths x 600 months under config.json's
Statics, under chip_smoke.ALL_ON and with crashes, guardrails or six
streams alone; one 16-row chunk of the 16 x 16 scenario grid (W=231, R=50,
1M paths) under config.json's Statics and under ALL_ON; and ``simulate``'s
one-row launch at 1M x 600, for

  * 16-row launches: rows per block C and months per draw tile M in
    (16, 64), (16, 32), (8, 64), (8, 32) (the first is
    ``cuda_kernel.tile_plan``'s choice);
  * the one-row launch: M in {16, 4, 8, 32} (16 is ``tile_plan``'s);
  * the kernels' launch bound as shipped, ``__launch_bounds__(512, 2)`` (at
    most 64 registers), and ``__launch_bounds__(512)``, built from a copy
    of ``engine/csrc`` with that one line changed;

with each build's ptxas registers and spills. Every variant's outputs must
equal the first's bit for bit (the tiling changes no result). Run it from
the repository root (chip_smoke.py and config.json live there).
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import tempfile

ROW_PLANS = ((16, 64), (16, 32), (8, 64), (8, 32))
ONE_ROW_MONTHS = (16, 4, 8, 32)
SHIPPED = "__launch_bounds__(kTileThreads, kTileBlocks)"
BOUNDS = {"512,2": SHIPPED, "512": "__launch_bounds__(kTileThreads)"}


def _regs(log: str):
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in ("probe_kernel", "grid_kernel") if k in m.group(1)),
                        None)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name + " spills"] = f"{m.group(1)}/{m.group(2)} B"
    return out


def main() -> int:
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ..engine import _build
    from ..engine import cuda_kernel as ck
    from ..engine.runner import Engine
    from ..engine.scenario_batch import _grid_stream_seed, grid_statics
    from ..models.retirement import stack_params

    ck.require_device("cuda")
    print(f"card: {cs._card_line()}; torch {torch.__version__}")
    n = cs.N_FULL
    scen = dict(retirement_years=50, initial_balance=1_500_000.0,
                monthly_expenses=4_000.0)
    engines = {
        "slice": Engine(cs._config(**scen), device="cuda"),
        "all-on": Engine(cs._config(**scen, **cs.ALL_ON), device="cuda"),
    }
    for name in ("jumps", "guardrails", "streams"):
        engines[name] = Engine(cs._config(**scen, **dict(cs.EXTENSIONS[name])),
                               device="cuda")
    seed = _grid_stream_seed(cs.SEED)
    grids = {}
    for label, over in (("slice", {}), ("all-on", dict(cs.ALL_ON))):
        configs = [cs._config(**over, monthly_expenses=c.monthly_expenses,
                              inv1_returns_mean=c.inv1_returns_mean)
                   for c in cs._grid_chunk_configs()]
        GR = configs[0].retirement_years
        grids[label] = (ck.pack_grid(stack_params(configs), seed,
                                     [cs.GRID_W] * len(configs), GR,
                                     device="cuda"), grid_statics(configs))
    cases = {}
    for label, eng in engines.items():
        cases[f"probe {label}"] = ("mcrt_probe", "probe",
                                   eng._pack(list(range(16)), "search"), eng.statics)
    for label, (packed, st) in grids.items():
        cases[f"grid {label}"] = ("mcrt_grid", "grid", packed, st)
    one = engines["slice"]._pack(0, "final")
    cases["simulate slice"] = ("mcrt_grid", "grid", ck.Packed(
        fp=one.fp.reshape(1, -1), ip=one.ip, n_streams=one.n_streams),
        engines["slice"].statics)

    def plans(K, st, kind):
        base = (ck.probe_plan(K, n, st) if kind == "probe"
                else ck.tile_plan(K, n, st, kind))
        if K == 1:
            return [base._replace(months_per_chunk=m) for m in ONE_ROW_MONTHS]
        return [base._replace(rows_per_block=c, months_per_chunk=m)
                for c, m in ROW_PLANS]

    shipped = _build.CSRC
    tmp = tempfile.mkdtemp(prefix="tile_sweep_")
    reference = {}
    try:
        for label, text in BOUNDS.items():
            if text == SHIPPED:
                csrc = shipped
            else:
                csrc = os.path.join(tmp, "csrc")
                shutil.copytree(shipped, csrc)
                path = os.path.join(csrc, "month_loop.cu")
                src = open(path).read()
                if src.count(SHIPPED) != 2:
                    raise AssertionError("launch bounds not found in month_loop.cu")
                open(path, "w").write(src.replace(SHIPPED, text))
            _build.CSRC = type(shipped)(csrc)
            _build._LIBS.clear()
            statics = list(dict.fromkeys(st for _, _, _, st in cases.values()))
            _build.build_many(statics)
            print(f"--- __launch_bounds__({label}): " + "; ".join(
                f"{cs._statics_label(st)} {_regs(_build.build_log(st))}"
                for st in statics))
            for name, (entry, kind, packed, st) in cases.items():
                for plan in plans(packed.ip.shape[0], st, kind):
                    out = ck._launch_rows(entry, packed, st, n, plan)
                    torch.cuda.synchronize()
                    ref = reference.setdefault(name, out)
                    same = (torch.equal(out.success, ref.success)
                            and torch.equal(out.final_balance, ref.final_balance)
                            and torch.equal(out.counts, ref.counts))
                    ms = cs._time_ms(lambda: ck._launch_rows(entry, packed, st, n,
                                                             plan), repeats=3)
                    print(f"{name:16s} C={plan.rows_per_block:2d} "
                          f"M={plan.months_per_chunk:2d} "
                          f"threads={plan.threads} smem={plan.smem_bytes} B: "
                          f"{ms:.3f} ms; outputs equal the first variant's: {same}")
                    if not same:
                        raise AssertionError(f"{name} {plan} changed the outputs")
    finally:
        _build.CSRC = shipped
        _build._LIBS.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
