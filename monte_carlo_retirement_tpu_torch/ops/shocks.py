"""The port's counter-based shock stream (Philox4x32-10), in torch.

Every normal is a pure function of (stream seed, global path block, month,
lane): the key is ``(stream_seed, global_block)`` with
``global_block = path // 4096 + block_offset`` and the counter is
``(month, path % 4096, 0, 0)``. That keeps the JAX Pallas kernel's seeding
structure (``pallas_kernel.py:469-485``): candidates never enter the key,
so working-month candidates share their shocks (common random numbers), and
a run split into chunks of whole blocks draws exactly what one dispatch
draws. Words 0, 1 and 2 of each draw become the equity, independent
inflation and premium normals; word 3 is reserved for the crash draw.

Each word becomes a normal through exactly the Pallas ``_normal`` transform
(``pallas_kernel.py:283-300``) in float32: 23 bits -> x uniform on
[-1+2^-23, 1-2^-23] -> z = x * P(sqrt(-log1p(-x^2))) with the degree-9
polynomial below. ``engine/csrc/month_loop.cu`` computes the same bits and,
with the same float32 operation order, the same normals.

torch has no uint32 arithmetic, so the words live in int64 masked to 32
bits; the 32x32 -> 64 bit product overflows int64, so it is split into
16-bit halves.
"""

from __future__ import annotations

from typing import Tuple

import torch

BLOCK_PATHS = 4096  # paths per Philox key (one key per 4096-path block)

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF

# The Pallas sampler's constants (pallas_kernel.py:116-130).
INV_2_22 = 1.0 / float(1 << 22)
X_OFFSET = 1.0 / float(1 << 23) - 1.0
ZPOLY = (
    0.0001782477551054519, -0.0028148533007281555,
    0.016944312865490738, -0.04569300513968381,
    0.04307398034973402, 0.014180894039555763,
    -0.028215645346410155, 0.3470778790734455,
    -0.003963483920460122, 1.2534926535177795,
)


def _mulhilo(a: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product a * x (a < 2^32 a
    constant, x int64 in [0, 2^32)), without overflowing int64."""
    xl = x & 0xFFFF
    t = xl * a  # < 2^48
    u = (x >> 16) * a + (t >> 16)  # < 2^48 + 2^32
    hi = u >> 16
    lo = ((u & 0xFFFF) << 16) | (t & 0xFFFF)
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32 with 10 rounds (Salmon et al., SC'11) on int64 tensors or
    Python ints holding uint32 values; all arguments broadcast. Returns
    the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3, k0, k1 = (
        torch.as_tensor(v, dtype=torch.int64) for v in (c0, c1, c2, c3, k0, k1)
    )
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> standard normals, float32, the Pallas
    ``_normal`` transform operation for operation."""
    r = (bits >> 9).to(torch.float32)
    x = r * INV_2_22 + X_OFFSET
    s = torch.sqrt(-torch.log1p(-(x * x)))
    acc = torch.full_like(x, ZPOLY[0])
    for c in ZPOLY[1:]:
        acc = acc * s + c
    return acc * x


def path_keys(
    n_paths: int, block_offset: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global block, lane) of every path, int64 tensors of shape (n,)."""
    p = torch.arange(n_paths, dtype=torch.int64, device=device)
    return (p // BLOCK_PATHS + int(block_offset)) & _MASK32, p % BLOCK_PATHS


def month_words(seed: int, gblock, month: int, lane):
    """The four Philox words of one month for the given paths."""
    return philox4x32_10(
        int(month) & _MASK32, lane, 0, 0, int(seed) & _MASK32, gblock
    )


def month_normals(seed: int, gblock, month: int, lane) -> torch.Tensor:
    """(3, n) float32 normals (z_eq, z_ind, z_prem) for one month."""
    w0, w1, w2, _w3 = month_words(seed, gblock, month, lane)
    return torch.stack([bits_to_normal(w) for w in (w0, w1, w2)])
