"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

The sources are ``engine/csrc/`` of this checkout, compiled for Hopper
(``sm_90a``) into ``build/torch_kernels/`` at the root of the checkout
(``MCRT_TORCH_BUILD_DIR`` overrides it) on first use, and again whenever
the sources or flags change: a library's file name carries their hash.

The month-loop kernels (``month_loop.cu``) are built once per ``Statics``,
scalar type and draw source (a :class:`Unit`), as the JAX package builds
one executable per Statics: a small generated unit defines every flag of
the Statics as a constant and includes the source, so each library holds
one instance of each kernel, with every disabled feature compiled out. The
Philox source in float32 holds the probe, grid and full kernels (and,
without a glide path, the probe's accumulation pass); the
threefry source, in float32 or float64, the scan's two kernels; a JVP
unit (``tk`` tangents, either type, either draw source) the JVP kernel of
``sensitivity_ad``. A new library costs one nvcc run of a few seconds on
first use;
:func:`build_many` starts several at once. The stream check
(``normals.cu``) is one library of its own.

The libraries have a plain C interface; every pointer and the stream go
through ``ctypes.c_void_p``, and every entry returns its launch's
``cudaGetLastError()``, which :func:`check` turns into an exception.

Beside a library, a Statics can have its op-count cubin (``op_count.cu``,
never launched): :func:`count_sass` returns its SASS, which
``engine/bound.py`` prices into the kernels' bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("philox.cuh", "threefry.cuh", "dual.cuh", "month_loop.cu",
           "normals.cu", "op_count.cu")
# No --use_fast_math: division and sqrt stay IEEE. -Xptxas -v only prints
# each kernel's registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The op-count unit: device code only, into a cubin for cuobjdump.
COUNT_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
)
# A float64 unit rounds every multiply and add on its own, as the plain
# chain's separate torch ops do: no contraction into a fused multiply-add.
DOUBLE_FLAGS = ("-fmad=false",)
NVCC_TIMEOUT_S = 1200

_LOCK = threading.Lock()
_LIBS: Dict[object, ctypes.CDLL] = {}


def build_dir() -> Path:
    override = os.environ.get("MCRT_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _cuda_tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (
        os.environ.get(name.upper()),
        shutil.which(name),
        os.path.join(cuda_home, "bin", name),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"{name} not found (set {name.upper()} or CUDA_HOME); the CUDA "
        "kernels are built from engine/csrc on the machine with the card"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


class Unit(NamedTuple):
    """One month-loop library: a Statics, the scalar type of its month step
    ("float" or "double"), its draws ("philox": the probe, grid and full
    kernels, float only; "threefry": the scan kernels) and the tangents its
    JVP kernel carries (``tk`` > 0: that kernel alone, in either type on
    either draw source). Wherever a library is named, a bare Statics stands
    for ``Unit(statics)``."""

    statics: object
    real: str = "float"
    draws: str = "philox"
    tk: int = 0


def _unit(lib) -> Optional[Unit]:
    if lib is None or isinstance(lib, Unit):
        return lib
    return Unit(lib)


# The extensions of a Statics, in the order statics_tag names them.
EXTENSIONS = ("bill1", "bill2", "glide", "guardrails", "jumps", "mortality",
              "antithetic")


def statics_tag(statics) -> str:
    """The extensions ``statics`` turns on, as one short string ("" for
    none): the ``statics`` attribute of the kernel spans and of
    ``kernel.load``."""
    return "+".join(name for name in EXTENSIONS if getattr(statics, name))


def statics_unit(statics, source: str = "month_loop.cu", real: str = "float",
                 draws: str = "philox", tk: int = 0) -> str:
    """The generated translation unit of one Statics: each flag as a
    constant, then ``source`` (the kernels, or the op-count unit). A
    stream's kind is one int: bit 0 CPI-indexed, bit 1 duration-capped.
    The threefry draws add ``MCRT_THREEFRY``, float64 ``MCRT_REAL_DOUBLE``,
    a JVP unit ``MCRT_JVP_TK``; the Philox float32 unit is the flags
    alone."""
    if len(statics.stream_indexed) != len(statics.stream_capped):
        raise ValueError("stream_indexed and stream_capped differ in length")
    if real not in ("float", "double") or draws not in ("philox", "threefry"):
        raise ValueError(f"no month-loop library draws {draws!r} in {real!r}")
    if int(tk) < 0:
        raise ValueError(f"a JVP unit carries tk >= 1 tangents, got {tk}")
    if (real, draws, int(tk) > 0) == ("double", "philox", False):
        raise ValueError(f"no month-loop library draws {draws!r} in {real!r}: "
                         "the Philox kernels run in float32, float64 Philox "
                         "draws only feed the JVP kernel (tk >= 1)")
    kinds = ", ".join(
        str(int(bool(i)) | 2 * int(bool(c)))
        for i, c in zip(statics.stream_indexed, statics.stream_capped)
    )
    flags = {
        "MCRT_USE_REAL1": statics.use_real1,
        "MCRT_USE_REAL2": statics.use_real2,
        "MCRT_BILL1": statics.bill1,
        "MCRT_BILL2": statics.bill2,
        "MCRT_ANTITHETIC": statics.antithetic,
        "MCRT_GLIDE": statics.glide,
        "MCRT_GUARDRAILS": statics.guardrails,
        "MCRT_JUMPS": statics.jumps,
        "MCRT_MORTALITY": statics.mortality,
    }
    lines = [f"#define {name} {int(bool(v))}" for name, v in flags.items()]
    lines += [
        f"#define MCRT_NS {len(statics.stream_indexed)}",
        f"#define MCRT_STREAM_KINDS {kinds}",
    ]
    if draws == "threefry":
        lines.append("#define MCRT_THREEFRY 1")
    if real == "double":
        lines.append("#define MCRT_REAL_DOUBLE 1")
    if tk:
        lines.append(f"#define MCRT_JVP_TK {int(tk)}")
    lines.append(f'#include "{source}"')
    return "\n".join(lines) + "\n"


def _unit_text(lib: Unit, source: str) -> str:
    return statics_unit(lib.statics, source, lib.real, lib.draws, lib.tk)


def _unit_flags(lib: Unit) -> Tuple[str, ...]:
    return DOUBLE_FLAGS if lib.real == "double" else ()


def _unit_tag(lib: Unit, source: str) -> str:
    text = _unit_text(lib, source) + " ".join(_unit_flags(lib))
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def library_path(statics=None) -> Path:
    """The month-loop library of ``statics`` (a Statics or a
    :class:`Unit`); the stream check's for None."""
    lib = _unit(statics)
    if lib is None:
        return build_dir() / f"normals_{source_hash()}.so"
    return build_dir() / (f"month_loop_{source_hash()}_"
                          f"{_unit_tag(lib, 'month_loop.cu')}.so")


def count_path(statics) -> Path:
    """The op-count cubin of ``statics`` (a Statics or a :class:`Unit`)."""
    tag = _unit_tag(_unit(statics), "op_count.cu")
    return build_dir() / f"op_count_{source_hash()}_{tag}.cubin"


def _start(statics, out: Path):
    """Write the unit (for a Statics or a :class:`Unit`) and start nvcc on
    it: a library, or for a ``.cubin`` target the op-count unit."""
    count = out.suffix == ".cubin"
    lib = _unit(statics)
    if lib is None:
        unit = CSRC / "normals.cu"
    else:
        unit = out.with_suffix(".cu")
        unit.write_text(_unit_text(lib, "op_count.cu" if count
                                   else "month_loop.cu"))
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.tmp{out.suffix}")
    flags = (COUNT_FLAGS if count else NVCC_FLAGS) + (
        _unit_flags(lib) if lib is not None else ())
    cmd = [_cuda_tool("nvcc"), *flags, "-I", str(CSRC), "-o", str(tmp),
           str(unit)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, cmd, tmp


def build_many(statics_list: Sequence[Optional[object]],
               count_statics: Sequence[object] = ()) -> Tuple[List[Path], int]:
    """Build the libraries of every Statics or :class:`Unit` in
    ``statics_list`` (None: the stream check) and the op-count cubins of
    ``count_statics`` that do not exist yet, one nvcc each, all started together; returns their paths in
    order, the libraries' first, and how many were built."""
    paths = ([library_path(s) for s in statics_list]
             + [count_path(s) for s in count_statics])
    todo = {}
    for s, out in zip(list(statics_list) + list(count_statics), paths):
        if not out.exists() and out not in todo:
            todo[out] = s
    if not todo:
        return paths, 0
    build_dir().mkdir(parents=True, exist_ok=True)
    running = [(out, *_start(s, out)) for out, s in todo.items()]
    failures = []
    try:
        for so, proc, cmd, tmp in running:
            out, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
            so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"{so.name}: nvcc failed ({proc.returncode}):\n"
                                f"{err[-6000:]}")
            else:
                os.replace(tmp, so)
    finally:
        for _so, proc, _cmd, _tmp in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths, len(todo)


def build(statics=None) -> Path:
    """Compile one library unless it exists."""
    return build_many([statics])[0][0]


def build_log(statics=None) -> str:
    log = library_path(statics).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def count_sass(statics) -> str:
    """``cuobjdump -sass`` of the op-count cubin of ``statics`` (a Statics
    or a :class:`Unit`; built unless it exists)."""
    cubin = build_many([], [statics])[0][0]
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True,
                          timeout=NVCC_TIMEOUT_S).stdout


def _bind(lib: ctypes.CDLL, unit: Optional[Unit]) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if unit is None:
        entries = {"mcrt_normals": [vp, i, vp, vp, vp],
                   "mcrt_threefry": [vp, i, vp, vp, vp, vp]}
    elif unit.tk:
        entries = {"mcrt_jvp": [vp, vp, vp, vp, i, i, i, i, i, i, ll, vp, vp,
                                vp, vp]}
    elif unit.draws == "threefry":
        entries = {
            "mcrt_scan_rows": [vp, vp, vp, i, i, i, i, i, i, i, i, i, i, ll,
                               vp, vp, vp, vp, vp],
            "mcrt_scan_full": [vp, vp, vp, i, i, i, i, i, i, ll, vp, vp, vp,
                               vp, vp],
        }
    else:
        entries = {
            "mcrt_probe": [vp, vp, i, i, i, i, i, i, i, i, i, vp, vp, vp, vp,
                           vp, vp],
            "mcrt_grid": [vp, vp, i, i, i, i, i, i, i, vp, vp, vp, vp, vp],
            "mcrt_full": [vp, vp, i, i, i, i, vp, vp, vp, vp, vp],
        }
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.mcrt_error_string.argtypes = [i]
    lib.mcrt_error_string.restype = ctypes.c_char_p


def load(statics=None) -> ctypes.CDLL:
    """The month-loop library of ``statics`` (a Statics or a :class:`Unit`;
    the stream check's for None), built on first use and loaded once per
    process. Its first use is a span ``kernel.load``: attributes
    ``statics`` (:func:`statics_tag`; None for the stream check) and
    ``built`` (whether nvcc ran, or the library was read from the build
    directory)."""
    from ..utils import profiling

    key = _unit(statics)
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            tag = None if key is None else statics_tag(key.statics)
            with profiling.span("kernel.load", statics=tag) as span:
                span.set(built=not library_path(key).exists())
                lib = ctypes.CDLL(str(build(key)))
                _bind(lib, key)
            _LIBS[key] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error."""
    if rc != 0:
        msg = lib.mcrt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
