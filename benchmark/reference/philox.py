"""The Philox4x32-10 stream of the month loop, frozen for the benchmark.

A path's draws are a pure function of (stream seed, global 4096-path block,
month, lane): key ``(seed, block)``, counter ``(month, lane, 0, 0)``. Words
0, 1 and 2 of a month's draw become the equity, independent-inflation and
premium normals through a 23-bit uniform on (-1, 1) and the odd polynomial
``z = x * P(sqrt(-log1p(-x^2)))``, in float32. Candidates never enter the
key, so every row of a launch sees the same shocks (common random numbers).

The words live in int64 masked to 32 bits; the 32 x 32 -> 64 bit product
is split into 16-bit halves so that it never overflows.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_PATHS = 4096
ROUNDS = 10
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF

INV_2_22 = 1.0 / float(1 << 22)
X_OFFSET = 1.0 / float(1 << 23) - 1.0
ZPOLY = (
    0.0001782477551054519, -0.0028148533007281555,
    0.016944312865490738, -0.04569300513968381,
    0.04307398034973402, 0.014180894039555763,
    -0.028215645346410155, 0.3470778790734455,
    -0.003963483920460122, 1.2534926535177795,
)

# Operations of one draw counted for the roofline (``opcount.py``): per
# round two 32x32 -> 64 bit products (hi and lo: 2 each), four xors and the
# two key bumps; per normal the shift, the conversion, one multiply-add,
# x * x, log1p, sqrt, the polynomial's 9 multiply-adds and the final
# product (the two negations ride on their operands' sign bits).
OPS_PER_ROUND = 2 * 2 + 4 + 2
OPS_PER_NORMAL = 1 + 1 + 1 + 1 + 1 + 1 + (len(ZPOLY) - 1) + 1
NORMALS_PER_DRAW = 3


def stream_seed(main_seed: int, stream: int) -> int:
    """The 31-bit Philox seed of a request's stream: 0 the search, 1 the
    final run and the grid."""
    state = np.random.SeedSequence([int(main_seed), int(stream)]).generate_state(1)
    return int(state[0] % (2**31))


def _mulhilo(a: int, x: torch.Tensor):
    xl = x & 0xFFFF
    t = xl * a
    u = (x >> 16) * a + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def words(seed: int, block: torch.Tensor, month, lane: torch.Tensor, counter: int = 0):
    """The four output words of one month's draw (or of a (T, 1) tensor of
    months) for every path; ``counter`` is the counter's third word, 0 for
    the month's own draw (the extensions draw beside it: 1 the crash
    normal, 2 the lifetime uniform)."""
    month = torch.as_tensor(month, dtype=torch.int64, device=lane.device) & MASK
    c0 = month + torch.zeros_like(lane)
    c1, c2, c3 = lane.expand_as(c0), torch.full_like(c0, counter), torch.zeros_like(c0)
    k0, k1 = int(seed) & MASK, block
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & MASK
            k1 = (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def to_normal(bits: torch.Tensor) -> torch.Tensor:
    """A 32-bit word as a standard normal, float32."""
    x = (bits >> 9).to(torch.float32) * INV_2_22 + X_OFFSET
    s = torch.sqrt(-torch.log1p(-(x * x)))
    acc = torch.full_like(x, ZPOLY[0])
    for c in ZPOLY[1:]:
        acc = acc * s + c
    return acc * x


def path_index(n_paths: int, device):
    """(global block, lane) of paths 0 .. n_paths - 1 of a launch at block
    offset 0."""
    p = torch.arange(int(n_paths), dtype=torch.int64, device=device)
    return p // BLOCK_PATHS, p % BLOCK_PATHS


def month_normals(seed: int, block, lane, month) -> torch.Tensor:
    """(3, n) float32 normals (equity, independent inflation, premium), or
    (3, T, n) for a (T, 1) tensor of months."""
    w0, w1, w2, _ = words(seed, block, month, lane)
    return torch.stack([to_normal(w) for w in (w0, w1, w2)])
