"""Threefry-2x32 keys and draws in torch, bit for bit those of ``jax.random``.

The counterpart of JAX's default PRNG as the JAX package runs it
(``jax_threefry_partitionable`` on, the default since JAX 0.5): a key is two
32-bit words; ``fold_in(key, d)`` and ``split(key)[i]`` hash the counter
pair ``(0, d)`` (``(0, i)``) under the key; the random bits of an array of
shape ``s`` hash the pair ``(hi, lo)`` of each element's flat row-major
index under the key, giving the words ``(y0, y1)``, and a 32-bit draw is
``y0 ^ y1``, a 64-bit one ``y0 << 32 | y1``. ``uniform`` keeps the top
mantissa bits of a draw under the exponent of 1.0 and subtracts 1
(``jax/_src/random.py::_uniform``); ``normal`` maps a uniform on
``(nextafter(-1, 0), 1)`` through ``sqrt(2) * erfinv`` (``_normal_real``).

Because every element hashes its own flat index, element ``i`` of a draw
is the same for any array that holds it at that index: rows of an
``(n, c)`` draw do not depend on ``n``, and a shard draws its rows alone
(``row_offset``).

Keys are pairs of Python ints and are hashed on the host; per-element
words are int64 tensors holding uint32 values (torch has no uint32
shifts), on whatever device the counters live. The inverse error
function is XLA's polynomial (``erf_inv`` of XLA's math library: Giles'
single-precision form for float32, the three-branch form for float64),
evaluated in the same order. ``torch.erfinv`` is not that function (90
ulps from JAX's float32 normals, 4,807 from its float64 ones); with the
polynomial the normals differ from JAX's on the CPU only through XLA's own
``log1p`` and ``sqrt``: at most 3 ulps in float32 and 31 in float64 over
3M draws of each of four seeds (``tests/test_torch_threefry.py``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]
Words = Union[int, torch.Tensor]


def _rotl(x: Words, r: int) -> Words:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: Key, x0: Words, x1: Words) -> Tuple[Words, Words]:
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x0, x1)``
    under ``key`` (``jax/_src/prng.py::_threefry2x32_lowering``). The
    counters, and the key's two words, are Python ints or int64 tensors of
    uint32 values (they broadcast: a tensor key hashes under one key per
    element); so are the two output words."""
    k0, k1 = (k & MASK32 if isinstance(k, torch.Tensor) else int(k) & MASK32
              for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**63): the high and
    low 32-bit words of the seed."""
    seed = int(seed)
    if not 0 <= seed < (1 << 63):
        raise ValueError(f"a key's seed lies in [0, 2**63), got {seed}")
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for ``data`` in [0, 2**32)."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data must be a uint32, got {data}")
    return threefry2x32(key, 0, data)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``: key i hashes the counter (0, i)."""
    return tuple(threefry2x32(key, 0, i) for i in range(int(num)))


def _flat_counters(shape: Sequence[int], row_offset: int, device):
    """(hi, lo) words of every element's flat row-major index, for the
    rows ``row_offset ..`` of an array whose other dimensions are
    ``shape[1:]``."""
    shape = tuple(int(d) for d in shape)
    per_row = math.prod(shape[1:])
    start = int(row_offset) * per_row
    idx = torch.arange(start, start + math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & MASK32


def random_words(key: Key, shape: Sequence[int], row_offset: int = 0,
                 device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The two hash words (y0, y1) of every element of a draw of shape
    ``shape`` (``_threefry_random_bits_partitionable``), int64 tensors of
    uint32 values. ``row_offset`` draws rows ``row_offset ..`` of a larger
    array: the words of those rows in the larger draw."""
    hi, lo = _flat_counters(shape, row_offset, device)
    return threefry2x32(key, hi, lo)


def random_bits(key: Key, bit_width: int, shape: Sequence[int],
                row_offset: int = 0, device="cpu") -> torch.Tensor:
    """``jax.random.bits`` at 32 bits (``y0 ^ y1``) as int64 tensors of
    uint32 values, or at 64 bits (``y0 << 32 | y1``) as int64 tensors of
    the same bit pattern (two's complement above 2**63)."""
    y0, y1 = random_words(key, shape, row_offset, device)
    if bit_width == 32:
        return y0 ^ y1
    if bit_width == 64:
        return (y0 << 32) | y1
    raise ValueError(f"bit_width is 32 or 64, got {bit_width}")


def _unit_floats(y0: torch.Tensor, y1: torch.Tensor, dtype) -> torch.Tensor:
    """Floats in [1, 2) whose mantissa is the top bits of the draw."""
    if dtype == torch.float32:
        return (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    if dtype == torch.float64:
        # (y0 << 32 | y1) >> 12, kept below 2**52 so int64 holds it.
        mant = (y0 << 20) | (y1 >> 12)
        return (mant | 0x3FF0000000000000).view(torch.float64)
    raise TypeError(f"uniform draws float32 or float64, got {dtype}")


def uniform(key: Key, shape: Sequence[int], dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0, row_offset: int = 0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: bit for
    bit where ``maxval - minval`` is a power of two (the [0, 1) draws and
    the normals' range), whose scaling is exact; otherwise within an ulp
    of the span, since XLA fuses the scale and the shift into one
    rounding."""
    y0, y1 = random_words(key, shape, row_offset, device)
    return uniform_from_words(y0, y1, dtype, minval, maxval)


def uniform_from_words(y0: torch.Tensor, y1: torch.Tensor, dtype,
                       minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """:func:`uniform` of draws whose words (y0, y1) are given."""
    floats = _unit_floats(y0, y1, dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's ErfInv polynomials (its math library's ErfInv), highest power
# first: float32 in w = -log1p(-x^2) - 2.5 below w = 5, sqrt(w) - 3 above;
# float64 in three bands of w (6.25, 16).
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682),
)
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221),
)


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = c + p * w
    return p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` on float32 or float64 ``x`` in [-1, 1]: the
    polynomial in ``w = -log1p(-x^2)`` of the dtype's form, times ``x``;
    +-1 give +-inf."""
    w = -torch.log1p(-x * x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        p = torch.where(lt, _horner(_ERFINV32[0], w - 2.5),
                        _horner(_ERFINV32[1], torch.sqrt(w) - 3.0))
    elif x.dtype == torch.float64:
        b1 = w < 6.25
        b2 = w < 16.0
        # The third band takes sqrt(w) - 5; the first two share the branch
        # structure of XLA's select chain.
        p = torch.where(
            b1, _horner(_ERFINV64[0], w - 3.125),
            torch.where(b2, _horner(_ERFINV64[1], torch.sqrt(w) - 3.25),
                        _horner(_ERFINV64[2], torch.sqrt(w) - 5.0)))
    else:
        raise TypeError(f"erfinv takes float32 or float64, got {x.dtype}")
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: Key, shape: Sequence[int], dtype=torch.float32,
           row_offset: int = 0, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform on ``(nextafter(-1, 0), 1)``."""
    y0, y1 = random_words(key, shape, row_offset, device)
    return normal_from_words(y0, y1, dtype)


def normal_from_words(y0: torch.Tensor, y1: torch.Tensor, dtype) -> torch.Tensor:
    """:func:`normal` of draws whose words (y0, y1) are given."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    u = uniform_from_words(y0, y1, dtype, lo, 1.0)
    return erfinv(u) * torch.tensor(float(np.sqrt(np_dtype(2.0))), dtype=dtype,
                                    device=u.device)
