"""The port's counter-based shock streams, in torch: the kernels' Philox
stream and, at the end, the scan engine's threefry draws.

Every Philox normal is a pure function of (stream seed, global path block, month,
lane): the key is ``(stream_seed, global_block)`` with
``global_block = path // 4096 + block_offset`` and the counter is
``(month, path % 4096, 0, 0)``. That keeps the JAX Pallas kernel's seeding
structure (``pallas_kernel.py:469-485``): candidates never enter the key,
so working-month candidates share their shocks (common random numbers), and
a run split into chunks of whole blocks draws exactly what one dispatch
draws. Words 0, 1 and 2 of each draw become the equity, independent
inflation and premium normals.

The extensions draw beside that stream, never from it, so the base normals
are bit for bit the same with them on or off (``docs/CONFIG.md:112-116``):
  * market crashes (``pallas_kernel.py:507-528``): the crash uniform ``u``
    is word 3 of the month's draw; the crash normal ``z_j`` is word 0 of a
    second draw at counter ``(month, lane, 1, 0)`` under the same key;
  * longevity (``pallas_kernel.py:530-556``): one uniform per path, word 0
    of the draw with key ``(stream_seed ^ 668265261, global_block)`` (the
    Pallas kernel's salt) and counter ``(0, lane, 2, 0)``, which no month
    draw uses (months start at 1);
  * antithetic pairing (``pallas_kernel.py:475-482``): global blocks 2k and
    2k+1 share key block k; the odd block negates every normal and
    reflects every uniform, ``u -> 1 - u``.
Uniforms take 23 bits, as the Pallas ``_uniform``: ``(bits >> 9) * 2^-23``.

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

from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import MONTHS_PER_YEAR
from . import threefry

BLOCK_PATHS = 4096  # paths per Philox key (one key per 4096-path block)

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF

MORT_SALT = 668265261  # pallas_kernel.py:544
CRASH_COUNTER = 1  # third counter word of the crash normal's draw
MORT_COUNTER = 2  # third counter word of the longevity draw

# The Pallas sampler's constants (pallas_kernel.py:116-130).
INV_2_22 = 1.0 / float(1 << 22)
INV_2_23 = 1.0 / float(1 << 23)
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


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> uniforms on [0, 1 - 2^-23], float32 (exact),
    the Pallas ``_uniform``."""
    return (bits >> 9).to(torch.float32) * INV_2_23


def path_keys(
    n_paths: int, block_offset: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global block, lane) of every path, int64 tensors of shape (n,)."""
    p = torch.arange(n_paths, dtype=torch.int64, device=device)
    return (p // BLOCK_PATHS + int(block_offset)) & _MASK32, p % BLOCK_PATHS


def _month(month):
    """A month counter (an int, or an int64 tensor of months that
    broadcasts against the paths) as uint32 bits."""
    return torch.as_tensor(month, dtype=torch.int64) & _MASK32


def month_words(seed: int, gblock, month, lane):
    """The four Philox words of one month (or of a tensor of months) for
    the given paths."""
    return philox4x32_10(_month(month), lane, 0, 0, int(seed) & _MASK32, gblock)


def pair_blocks(gblock: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Antithetic pairing: (key block, sign) per path — blocks 2k and 2k+1
    draw key block k; the odd one's sign is -1 (float32)."""
    sign = (1 - 2 * (gblock & 1)).to(torch.float32)
    return gblock >> 1, sign


def month_normals(seed: int, gblock, month: int, lane) -> torch.Tensor:
    """(3, n) float32 normals (z_eq, z_ind, z_prem) for one month."""
    return month_draws(seed, gblock, month, lane)


def month_draws(seed: int, gblock, month, lane, jumps: bool = False,
                sign: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One month's draws, float32: (3, n) normals (z_eq, z_ind, z_prem), or
    with ``jumps`` (5, n) adding the crash uniform and normal (u, z_j). A
    (T, 1) tensor of months gives (3 or 5, T, n), every month's draws at
    once.
    ``sign`` (the antithetic pairing's, per path) negates the normals and
    reflects the uniform where it is -1."""
    w0, w1, w2, w3 = month_words(seed, gblock, month, lane)
    z = [bits_to_normal(w) for w in (w0, w1, w2)]
    if jumps:
        u = bits_to_uniform(w3)
        z_j = bits_to_normal(philox4x32_10(
            _month(month), lane, CRASH_COUNTER, 0, int(seed) & _MASK32, gblock)[0])
        z += [u, z_j]
    if sign is not None:
        z = [v * sign for v in z]
        if jumps:
            z[3] = torch.where(sign > 0, u, 1.0 - u)
    return torch.stack(z)


def mortality_uniform(seed: int, gblock, lane,
                      sign: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The longevity uniform of each path, float32, reflected where the
    antithetic ``sign`` is -1."""
    w = philox4x32_10(0, lane, MORT_COUNTER, 0,
                      (int(seed) ^ MORT_SALT) & _MASK32, gblock)[0]
    u = bits_to_uniform(w)
    if sign is not None:
        u = torch.where(sign > 0, u, 1.0 - u)
    return u


def gompertz_remaining_months(u, g0, b12, cap, working_months):
    """Remaining lifetime in retirement months from the longevity uniform
    (the JAX ``ops/shocks.py::gompertz_remaining_months``): the Gompertz
    inverse survival conditioned on being alive at the retirement date,
    with g_ret = g0 - W / b12,
        t = b12 * ln(1 - ln(u) * exp(g_ret)),
    in the overflow-stable two-branch form, capped at ``cap - W``. u = 0
    gives +inf, absorbed by the cap; rows with b12 = 0 (no rule) return
    +inf. Computed in the dtype of ``u``; the parameters broadcast."""
    w_f = torch.as_tensor(working_months, device=u.device).to(u.dtype)
    g_ret = g0 - w_f / b12
    log_u = torch.log(u)
    t_low = torch.log1p(-log_u * torch.exp(g_ret))
    t_high = g_ret + torch.log(torch.exp(-g_ret) - log_u)
    t = b12 * torch.where(g_ret > 0, t_high, t_low)
    d = torch.minimum(t, torch.clamp(cap - w_f, min=0.0))
    return torch.where(b12 > 0, d, torch.full_like(d, float("inf")))


# ---------------------------------------------------------------------------
# The scan engine's draws: threefry keys, one per absolute month (the JAX
# package's ``ops/shocks.py``). A month's draw is one array over the paths,
# row p for path p, so a path's shocks are a pure function of (stream key,
# month, path) whatever the batch size; ``row_offset`` draws the rows of a
# shard (global paths ``row_offset ..``) alone.
# ---------------------------------------------------------------------------
SQRT_MONTHS = MONTHS_PER_YEAR ** 0.5

# The crash and longevity streams fold at offsets disjoint from the months,
# so the base shocks are the same with either rule on or off.
JUMP_FOLD_OFFSET = 1 << 20
MORT_FOLD_OFFSET = 1 << 21


def stream_keys(main_seed: int) -> Tuple[threefry.Key, threefry.Key]:
    """The two root keys (search, final): ``fold_in(PRNGKey(seed), 0)`` and
    ``fold_in(..., 1)`` (the JAX ``stream_keys``). A seed outside [0,
    2**63) folds its full entropy through numpy's SeedSequence, so distinct
    huge seeds keep distinct streams."""
    s = int(main_seed)
    if not 0 <= s < (1 << 63):
        s = int(np.random.SeedSequence(s).generate_state(1, np.uint64)[0] >> 1)
    root = threefry.prng_key(s)
    return threefry.fold_in(root, 0), threefry.fold_in(root, 1)


def _paired_rows(n_paths: int, row_offset: int, antithetic: bool, device):
    """Draw rows and pairing signs of the paths ``row_offset ..
    row_offset + n_paths``: path p reads row p (iid) or row p // 2, negated
    on odd p (antithetic; a trailing odd path stays an unpaired +z draw).
    Returns (first row, row count, index into the drawn rows or None, odd
    mask or None)."""
    if not antithetic:
        return int(row_offset), int(n_paths), None, None
    p = torch.arange(int(row_offset), int(row_offset) + int(n_paths),
                     dtype=torch.int64, device=device)
    first = int(row_offset) // 2
    last = (int(row_offset) + int(n_paths) - 1) // 2
    return first, last - first + 1, p // 2 - first, (p % 2) == 1


def monthly_shocks(stream_key, month: int, n_paths: int, rho, dtype,
                   antithetic: bool = False, row_offset: int = 0,
                   device="cpu"):
    """Standard-normal shocks (z_equity, z_inflation, z_premium) of one
    month (the JAX ``monthly_shocks``): ``normal(fold_in(key, month), (n,
    3))``, the inflation shock rho-mixed as ``rho * z_eq + sqrt(max(0, 1 -
    rho^2)) * z_ind``; with ``antithetic`` path 2i+1 takes the negated row
    of path 2i. ``rho`` is a float or a tensor that broadcasts over the
    paths."""
    return _mix(monthly_normals(stream_key, month, n_paths, dtype, antithetic,
                                row_offset, device), rho)


def monthly_normals(stream_key, month: int, n_paths: int, dtype,
                    antithetic: bool = False, row_offset: int = 0,
                    device="cpu") -> torch.Tensor:
    """The month's three unmixed normals (z_eq, z_ind, z_prem), (3, n)."""
    first, rows, idx, odd = _paired_rows(n_paths, row_offset, antithetic,
                                         device)
    z = threefry.normal(threefry.fold_in(stream_key, month), (rows, 3), dtype,
                        row_offset=first, device=device)
    if idx is not None:
        z = torch.where(odd[:, None], -z[idx], z[idx])
    return z.t()


def _mix(z: torch.Tensor, rho):
    rho = torch.as_tensor(rho, dtype=z.dtype, device=z.device)
    z_inf = rho * z[0] + torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)) * z[1]
    return z[0], z_inf, z[2]


def monthly_jump_draws(stream_key, month: int, n_paths: int, dtype,
                       antithetic: bool = False, row_offset: int = 0,
                       device="cpu"):
    """Crash draws of one month (the JAX ``monthly_jump_draws``): u ~
    U[0, 1) and z ~ N(0, 1) from the two halves of ``split(fold_in(key,
    JUMP_FOLD_OFFSET + month))``; antithetic pairs take ``1 - u`` and
    ``-z``."""
    ku, kz = threefry.split(threefry.fold_in(stream_key,
                                             JUMP_FOLD_OFFSET + int(month)))
    first, rows, idx, odd = _paired_rows(n_paths, row_offset, antithetic,
                                         device)
    u = threefry.uniform(ku, (rows,), dtype, row_offset=first, device=device)
    z = threefry.normal(kz, (rows,), dtype, row_offset=first, device=device)
    if idx is not None:
        u, z = u[idx], z[idx]
        u = torch.where(odd, 1.0 - u, u)
        z = torch.where(odd, -z, z)
    return u, z


def threefry_mortality_uniform(stream_key, n_paths: int, dtype,
                               antithetic: bool = False, row_offset: int = 0,
                               device="cpu") -> torch.Tensor:
    """The scan stream's longevity percentile, one uniform per path, from
    ``fold_in(key, MORT_FOLD_OFFSET)``: the JAX ``ops/shocks.py::
    mortality_uniform`` (``mortality_uniform`` above is the Philox
    stream's); antithetic pairs take ``1 - u``."""
    key = threefry.fold_in(stream_key, MORT_FOLD_OFFSET)
    first, rows, idx, odd = _paired_rows(n_paths, row_offset, antithetic,
                                         device)
    u = threefry.uniform(key, (rows,), dtype, row_offset=first, device=device)
    if idx is not None:
        u = u[idx]
        u = torch.where(odd, 1.0 - u, u)
    return u


def monthly_gross_factors(z_eq, z_inf, z_prem, mu1, sigma1, mu_inf,
                          sigma_inf, mu_prem, sigma_prem):
    """Monthly gross factors (asset 1, inflation, asset 2) from annual
    lognormal parameters: ``exp(mu / 12 + sigma / sqrt(12) * z)``, asset 2
    compounding inflation times its premium (the JAX
    ``monthly_gross_factors``)."""
    g1 = torch.exp(mu1 / MONTHS_PER_YEAR + sigma1 / SQRT_MONTHS * z_eq)
    gi = torch.exp(mu_inf / MONTHS_PER_YEAR + sigma_inf / SQRT_MONTHS * z_inf)
    gp = torch.exp(mu_prem / MONTHS_PER_YEAR + sigma_prem / SQRT_MONTHS * z_prem)
    return g1, gi, gi * gp
