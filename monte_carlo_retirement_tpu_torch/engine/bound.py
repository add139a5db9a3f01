"""The least time the card could take for a month-loop launch.

A launch's work is counted in parts (``cuda_kernel.tile_work`` for the
probe, grid and scan-rows kernels, the probe's accumulation pass included,
:func:`full_work` for the full, scan-full and JVP kernels): draws
(path-months), parameter applications of the grid's rows, accumulation
months and retirement months (row-path-months).
Each part is priced from the SASS of its one-step kernel in
``csrc/op_count.cu`` (``_build.count_sass``; for the scan kernels, the
op-count unit of their scalar type and threefry draws):

  * every instruction of the kernel's main body (up to its unpredicated
    EXIT; the slow-path subroutines of IEEE division and square root after
    it are not counted) goes to its pipe, with the compute-capability-9.0
    throughputs per SM per clock of the CUDA C++ Programming Guide's
    arithmetic-instruction table: FP32 add, multiply and multiply-add 128;
    FP64 add, multiply, multiply-add and compare 64 (in float64, exp and
    log1p are software sequences of these, not MUFU);
    32-bit integer multiply-add 64 (it takes the FMA pipe's heavy half);
    other integer, compare, min/max, select, logic and shift 64;
    special functions (MUFU) and conversions 16; warp shuffles 32;
    loads, stores, uniform-datapath and control instructions are not
    counted (the loop holds its operands in registers);
  * a part's load on each pipe is its instructions there over the pipe's
    throughput, in SM-cycles per thread, and its issue load its
    instructions over 128 (one warp-instruction per scheduler per cycle);
  * a month's yearly code (annual bills, the guardrails' year start, the
    terminal settle) is charged once in 12 months: ``plain + (every branch
    - plain) / 12``;
  * a threefry draw's normals branch into the bands of XLA's erfinv, which
    the main body would count all of: the op-count unit runs band 0 for
    every normal, and each colder band (``count_normal_band1/2``) is added
    at the share of the normals that take it (:func:`band_shares`), its
    count less band 0's; warps that split between bands run both, which is
    the kernel's cost, not the draw's work;
  * the JVP's parts come from a JVP op-count unit of the launch's scalar
    type and draws, every value but the draws a Dual (``count_jvp_*``,
    :func:`jvp_part_loads`), with as many tangents as the function has
    directions: one pass of :func:`full_work` then prices what the
    function needs, the draws and the primal once and each direction
    once, however many launches the kernel splits the directions into
    (each launch redoes the draws and the primal: the kernel's cost, not
    the function's work);
  * a launch's loads are the sums of its parts' loads times their counts,
    and it takes at least its busiest load: the pipes run side by side.

The operations bound is the work's SM-cycles over the card's SMs and its
largest SM clock; the bytes bound is the launch's outputs (and its small
parameter block) over 3.35 TB/s. The bound is the larger of the two.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

MEMORY_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3

# Lanes per SM per clock (CUDA C++ Programming Guide, compute capability 9.0).
THROUGHPUT = {"fp32": 128, "fp64": 64, "imad": 64, "alu": 64, "xu": 16,
              "shfl": 32}
ISSUE_LANES = 128

_FP32 = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "HADD2",
         "HMUL2", "HFMA2"}
_FP64 = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX"}
_IMAD = {"IMAD", "IMUL", "IMAD32I", "IMUL32I"}
_XU = {"MUFU", "F2F", "F2I", "I2F", "FRND", "POPC", "FLO", "BREV"}
_SHFL = {"SHFL"}
_SKIP_PREFIX = ("LD", "ST", "ATOM", "RED", "U", "S2", "CS2", "BAR", "MEMBAR",
                "CCTL", "ERRBAR", "FENCE")
_SKIP = {"NOP", "EXIT", "BRA", "BRX", "JMP", "JMX", "CALL", "RET", "BSSY",
         "BSYNC", "BREAK", "BMOV", "WARPSYNC", "YIELD", "DEPBAR", "KILL",
         "NANOSLEEP", "ACQBULK", "ELECT", "ENDCOLLECTIVE"}

PARTS = ("count_draw_probe", "count_draw_grid", "count_growth", "count_accum",
         "count_accum_plain", "count_retire", "count_retire_plain",
         "count_retire_track", "count_retire_track_plain")
JVP_PARTS = ("count_jvp_draw", "count_jvp_accum", "count_jvp_accum_plain",
             "count_jvp_retire", "count_jvp_retire_plain")

# One normal through each band of XLA's erfinv (csrc/op_count.cu), and the
# w = -log1p(-u^2) at which each band after the first begins, by the scan
# unit's scalar type.
BANDS = ("count_normal_band0", "count_normal_band1", "count_normal_band2")
ERFINV_EDGES = {"float": (5.0,), "double": (6.25, 16.0)}

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)(.*?);")


def pipe_of(opcode: str):
    """The pipe a SASS opcode issues to, or None when it is not counted."""
    base = opcode.split(".")[0]
    if base in _SKIP or base.startswith(_SKIP_PREFIX):
        return None
    if base in _FP32:
        return "fp32"
    if base in _FP64:
        return "fp64"
    if base in _IMAD:
        return "imad"
    if base in _XU:
        return "xu"
    if base in _SHFL:
        return "shfl"
    return "alu"


def sass_pipes(sass: str) -> Dict[str, Dict[str, int]]:
    """{kernel: {pipe: instructions}} over each kernel's main body in a
    ``cuobjdump -sass`` listing."""
    out: Dict[str, Dict[str, int]] = {}
    name, label, done = None, None, True
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name, label, done = m.group(1), None, False
            out[name] = {pipe: 0 for pipe in THROUGHPUT}
            continue
        if name is None or done:
            continue
        m = _LABEL.match(line)
        if m:
            label = m.group(1)
            continue
        m = _INSTR.search(line)
        if not m:
            continue
        predicate, opcode, operands = m.groups()
        if (opcode == "EXIT" and not predicate) or (
                opcode.startswith("BRA") and label and f"({label})" in operands):
            done = True  # the main body's end; subroutines and the trap follow
            continue
        label = None
        pipe = pipe_of(opcode)
        if pipe is not None:
            out[name][pipe] += 1
    return out


def loads(pipes: Dict[str, int]) -> Dict[str, float]:
    """SM-cycles per thread of one part on each pipe and on issue; FP32 and
    integer multiply-adds share the FMA pipe."""
    out = {p: pipes.get(p, 0) / THROUGHPUT[p] for p in THROUGHPUT}
    out["fma"] = (pipes.get("fp32", 0) + pipes.get("imad", 0)) / THROUGHPUT["fp32"]
    out["issue"] = sum(pipes.values()) / ISSUE_LANES
    return out


def band_shares(real: str) -> Tuple[float, ...]:
    """The share of the normals whose erfinv runs each band, in a ``real``
    ("float" or "double") unit: u is uniform on (-1, 1), and w >= e exactly
    where |u| >= sqrt(1 - exp(-e))."""
    tails = ([1.0] + [1.0 - math.sqrt(-math.expm1(-e))
                      for e in ERFINV_EDGES[real]] + [0.0])
    return tuple(a - b for a, b in zip(tails, tails[1:]))


def _named_loads(sass: str, names, normals: int, real: str):
    """Each named kernel's loads, and the colder erfinv bands of a draw of
    ``normals`` threefry normals at their shares (zero without normals)."""
    pipes = sass_pipes(sass)
    bands = BANDS[:len(ERFINV_EDGES[real]) + 1] if normals else ()
    missing = [p for p in tuple(names) + bands if p not in pipes]
    if missing:
        raise ValueError(f"op-count kernels missing from the SASS: {missing}")
    c = {name: loads(pipes[name]) for name in tuple(names) + bands}
    cold = {k: 0.0 for k in c[names[0]]}
    for name, share in zip(bands[1:], band_shares(real)[1:]):
        for k in cold:
            cold[k] += normals * share * (c[name][k] - c[bands[0]][k])

    def month(general, plain):
        return {k: c[plain][k] + max(0.0, c[general][k] - c[plain][k]) / 12.0
                for k in c[plain]}

    return c, cold, month


def part_loads(sass: str, normals: int = 0,
               real: str = "float") -> Dict[str, Dict[str, float]]:
    """The loads of each part of the month loop, the yearly code charged
    once in 12 months; a scan unit's draw of ``normals`` threefry normals
    gains its colder erfinv bands at their shares."""
    c, cold, month = _named_loads(sass, PARTS, normals, real)
    return {
        "draw_probe": {k: v + cold[k] for k, v in c["count_draw_probe"].items()},
        "draw_grid": {k: v + cold[k] for k, v in c["count_draw_grid"].items()},
        "growth": c["count_growth"],
        "accum": month("count_accum", "count_accum_plain"),
        "retire": month("count_retire", "count_retire_plain"),
        "retire_track": month("count_retire_track", "count_retire_track_plain"),
    }


def jvp_part_loads(sass: str, normals: int = 0,
                   real: str = "float") -> Dict[str, Dict[str, float]]:
    """The JVP kernel's parts from a JVP unit's SASS: a draw with its Dual
    growth factors (threefry: plus the colder bands), a Dual accumulation
    month and a Dual retirement month, the yearly code once in 12."""
    c, cold, month = _named_loads(sass, JVP_PARTS, normals, real)
    return {
        "draw": {k: v + cold[k] for k, v in c["count_jvp_draw"].items()},
        "accum": month("count_jvp_accum", "count_jvp_accum_plain"),
        "retire": month("count_jvp_retire", "count_jvp_retire_plain"),
    }


def full_work(n_paths: int, working_months: int, t_end: int,
              acc_cap: Optional[int] = None) -> Dict[str, int]:
    """The full kernel's work: every path draws and runs every month it
    runs, its accumulation months up to W (or the scan's ``acc_cap``,
    where lower) and its retirement months W+1..t_end."""
    n, w, t = int(n_paths), int(working_months), int(t_end)
    acc = w if acc_cap is None else max(0, min(w, int(acc_cap)))
    return {"draws": n * (acc + t - w), "accum": n * acc, "retire": n * (t - w)}


def bound_ms(kind: str, work: Dict[str, int],
             parts: Dict[str, Dict[str, float]], out_bytes: int,
             sm_count: int, clock_hz: float) -> Tuple[float, str]:
    """(bound in ms, "operations" or "bytes") of a ``kind`` launch
    ("probe", "grid" or "full"; the scan-rows kernel is "probe" with one
    shared parameter block and "grid" with one per row, the scan-full
    kernel "full"; "jvp" the JVP, its ``work`` from :func:`full_work`)
    doing ``work`` and writing ``out_bytes``; ``parts`` from
    :func:`part_loads` of the launch's own library (for "jvp",
    :func:`jvp_part_loads` of a JVP unit with one tangent per direction)."""
    if kind == "probe":
        terms = [("draw_probe", work["draws"]), ("accum", work["accum"]),
                 ("retire", work["retire"])]
    elif kind == "grid":
        terms = [("draw_grid", work["draws"]),
                 ("growth", work["accum"] + work["retire"]),
                 ("accum", work["accum"]), ("retire", work["retire"])]
    elif kind == "full":
        terms = [("draw_probe", work["draws"]), ("accum", work["accum"]),
                 ("retire_track", work["retire"])]
    elif kind == "jvp":
        terms = [("draw", work["draws"]), ("accum", work["accum"]),
                 ("retire", work["retire"])]
    else:
        raise ValueError(f"unknown launch kind {kind!r}")
    total = {k: sum(count * parts[part][k] for part, count in terms)
             for k in parts[terms[0][0]]}
    ops_ms = max(total.values()) / (sm_count * clock_hz) * 1e3
    bytes_ms = out_bytes / MEMORY_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
