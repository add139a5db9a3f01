"""Two checkouts of the port on one card: the same launches, their results
and their times.

    python3 monte_carlo_retirement_tpu_torch/hosts/compare_trees.py run ROOT LABEL OUT.jsonl
    python3 monte_carlo_retirement_tpu_torch/hosts/compare_trees.py report OUT.jsonl

``run`` imports the package and ``chip_smoke.py`` of the checkout at ROOT
(its kernels build into ROOT's own build directory) and appends one JSON
line to OUT.jsonl: at chip_smoke.py phase 6's shapes, for the 16-candidate
probe at 1M x 600 under config.json's Statics and under
``chip_smoke.ALL_ON``; at the search's shapes, config.json's own household
(1M paths, R=50) probed at its two ladders, W = 12-192 and 204-384, and at
a verify probe of 11 rows, W = 194-204, padded with 5 more at 204; one
16-row chunk of the 16 x 16 grid (W=231, R=50,
1M paths), ``simulate`` at 1M x 600 and the full kernel at 1M x 600, and
the scan kernels at the same shapes in float32 and float64
(``scan_rows_kernel``: the 16 rows at 1M x 600; ``scan_full_kernel``: 1M x
600): the per-row survivor counts, the float64 sum of each row's final
balances, a checksum of the bits of every output, the tiled launches'
body steps per row, and the CUDA-event time
(warm, min of 5); then the CUDA-event time of the plain versions of the probe, the
grid chunk, ``simulate`` and the full run (and of the full run under
``ALL_ON``), min of 2. Run it once per checkout in turns (parent, change, change,
parent) so both see the same card. ``report`` prints the times side by
side and every result that differs between the labels.
"""

from __future__ import annotations

import importlib
import json
import os
import sys


def _digest(t) -> int:
    """A position-weighted checksum of a tensor's bits."""
    import torch

    bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int((bits * weight).sum())


def run(root: str, label: str, out_path: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    cs = importlib.import_module("chip_smoke")
    pkg = cs.PKG
    ck = importlib.import_module(f"{pkg}.engine.cuda_kernel")
    Engine = importlib.import_module(f"{pkg}.engine.runner").Engine
    sb = importlib.import_module(f"{pkg}.engine.scenario_batch")
    stack_params = importlib.import_module(f"{pkg}.models.retirement").stack_params
    if not ck.__file__.startswith(root):
        raise AssertionError(f"imported {ck.__file__}, not the checkout at {root}")

    n = cs.N_FULL
    scen = dict(retirement_years=50, initial_balance=1_500_000.0,
                monthly_expenses=4_000.0)
    eng = Engine(cs._config(**scen), device="cuda")
    eng_on = Engine(cs._config(**scen, **cs.ALL_ON), device="cuda")
    R = eng.retirement_years
    L = 1 + eng._t_scan(0) // 12
    configs = cs._grid_chunk_configs()
    gst = sb.grid_statics(configs)
    GR = configs[0].retirement_years
    gpacked = ck.pack_grid(stack_params(configs), sb._grid_stream_seed(cs.SEED),
                           [cs.GRID_W] * len(configs), GR, device="cuda")
    probe = eng._pack(list(range(16)), "search")
    probe_on = eng_on._pack(list(range(16)), "search")
    full = eng._pack(0, "final")
    house = Engine(cs._config(), device="cuda")
    search_shapes = {
        "probe_w12_192": list(range(12, 193, 12)),
        "probe_w204_384": list(range(204, 385, 12)),
        "probe_verify": list(range(194, 205)) + [204] * 5,
    }

    cases = {
        "probe": lambda: ck.probe(probe, eng.statics, R, n),
        "probe_all_on": lambda: ck.probe(probe_on, eng_on.statics, R, n),
        "grid": lambda: ck.grid(gpacked, gst, GR, n),
        "simulate": lambda: ck.simulate(full, eng.statics, R, n),
        "full": lambda: ck.simulate_full(full, eng.statics, R, n, L),
    }
    for name, months in search_shapes.items():
        packed = house._pack(months, "search")
        cases[name] = (lambda packed=packed: ck.probe(
            packed, house.statics, house.retirement_years, n))
    kernel = importlib.import_module(f"{pkg}.engine.kernel")
    flags = cs._scan_flags(cs._config(**scen))
    t_probe, t_full = eng._t_scan(15), eng._t_scan(0)
    search, final_key = eng._key("search"), eng._key("final")
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        rows, st = kernel.scan_block(eng.params, list(range(16)), R, dtype,
                                     **flags)
        one, _ = kernel.scan_block(eng.params, [0], R, dtype, statics=st)
        cases[f"scan_rows_{tag}"] = (
            lambda rows=rows, st=st: ck.scan_rows(rows, st, R, n, search,
                                                  t_scan=t_probe))
        cases[f"scan_full_{tag}"] = (
            lambda one=one, st=st: ck.scan_full(one, st, R, n, L, final_key,
                                                t_scan=t_full))
    line = {"label": label, "root": root, "card": cs._card_line()}
    for name, fn in cases.items():
        out = fn()
        torch.cuda.synchronize()
        if isinstance(out, dict):  # the full kernels' fields
            res = {k: _digest(v) for k, v in out.items()}
        else:
            success, final = out.success, out.final_balance
            if name == "simulate":
                success, final = success[None], final[None]
            res = {
                "counts": (success > 0.5).sum(dim=1).tolist(),
                "kernel_counts": (out.counts.tolist() if name != "simulate"
                                  else None),
                "final_sum": final.double().sum(dim=1).tolist(),
                "success_bits": _digest(success),
                "final_bits": _digest(final),
                "steps": (out.steps.tolist() if getattr(out, "steps", None)
                          is not None else None),
            }
        res["ms"] = cs._time_ms(fn)
        line[name] = res
        print(f"[{label}] {name}: {res['ms']:.3f} ms")
    # The plain versions of the same launches (launch-bound torch loops).
    full_on = eng_on._pack(0, "final")
    L_on = 1 + eng_on._t_scan(0) // 12
    plains = {
        "probe_plain": lambda: ck.probe_plain(probe, eng.statics, R, n),
        "grid_plain": lambda: ck.grid_plain(gpacked, gst, GR, n),
        "simulate_plain": lambda: ck.simulate_plain(full, eng.statics, R, n),
        "full_plain": lambda: ck.simulate_full_plain(full, eng.statics, R, n, L),
        "full_plain_all_on": lambda: ck.simulate_full_plain(
            full_on, eng_on.statics, R, n, L_on),
    }
    for name, fn in plains.items():
        line[name] = {"ms": cs._time_ms(fn, repeats=2, warm=False)}
        print(f"[{label}] {name}: {line[name]['ms']:.3f} ms")
    with open(out_path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(line) + "\n")
    return 0


def report(out_path: str) -> int:
    with open(out_path, encoding="utf-8") as fh:
        lines = [json.loads(s) for s in fh if s.strip()]
    names = [k for k in lines[0] if isinstance(lines[0][k], dict)]
    print(f"card: {lines[0]['card']}; order: " + ", ".join(x["label"] for x in lines))
    for name in names:
        print(f"{name}: " + " / ".join(f"{x[name]['ms']:.3f}" for x in lines) + " ms")
    first = {}
    differ = 0
    for x in lines:
        ref = first.setdefault(x["label"], x)
        for name in names:
            a = {k: v for k, v in x[name].items() if k != "ms"}
            b = {k: v for k, v in ref[name].items() if k != "ms"}
            if a != b:
                differ += 1
                print(f"{name}: {x['label']} differs between its own runs")
    labels = list(first)
    for other in labels[1:]:
        for name in names:
            a, b = first[labels[0]][name], first[other][name]
            for key in a:
                if key != "ms" and a[key] != b[key]:
                    differ += 1
                    print(f"{name}.{key}: {labels[0]} {a[key]} vs {other} {b[key]}")
    print(f"results that differ: {differ}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "run":
        raise SystemExit(run(*sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "report":
        raise SystemExit(report(sys.argv[2]))
    raise SystemExit(__doc__)
