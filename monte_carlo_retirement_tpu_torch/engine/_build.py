"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

The sources are ``engine/csrc/*.cu`` of this checkout, compiled for
Hopper (``sm_90a``) into ``build/torch_kernels/`` at the root of the
checkout (``MCRT_TORCH_BUILD_DIR`` overrides it) on first use, and again
whenever the sources or flags change: the library's file name carries their
hash. The library has a plain C interface; every pointer and the stream go
through ``ctypes.c_void_p``, and every entry returns its launch's
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("month_loop.cu",)
# No --use_fast_math: division and sqrt stay IEEE. -Xptxas -v only prints
# each kernel's registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIB = None


def build_dir() -> Path:
    override = os.environ.get("MCRT_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(cuda_home, "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME); the CUDA kernels are built "
        "from engine/csrc on the machine with the card"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"month_loop_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
    log = so.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}"
        )
    os.replace(tmp, so)
    return so


def build_log() -> str:
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.mcrt_probe.argtypes = [vp, vp, i, i, i, i, i, i, vp, vp, vp, vp]
            lib.mcrt_grid.argtypes = [vp, vp, i, i, i, i, i, i, vp, vp, vp, vp]
            lib.mcrt_full.argtypes = [vp, vp, i, i, i, i, i, i, vp, vp, vp, vp, vp]
            lib.mcrt_normals.argtypes = [vp, i, vp, vp, vp]
            for fn in (lib.mcrt_probe, lib.mcrt_grid, lib.mcrt_full,
                       lib.mcrt_normals):
                fn.restype = i
            lib.mcrt_error_string.argtypes = [i]
            lib.mcrt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error."""
    if rc != 0:
        msg = lib.mcrt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
