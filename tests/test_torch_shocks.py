"""The port's counter-based shock stream (ops/shocks.py).

Philox4x32-10 against a pure-Python big-integer implementation written here
from its definition (Salmon, Moraes, Dror, Shaw: "Parallel random numbers:
as easy as 1, 2, 3", SC'11); the bits -> normal map against a numpy build
of the JAX Pallas sampler's own constants; the normals against scipy's
erfinv (as tests/test_sampler_polynomial.py checks the Pallas sampler); and
the stream's moments.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
scipy_special = pytest.importorskip("scipy.special")

from monte_carlo_retirement_tpu.engine.pallas_kernel import (  # noqa: E402
    _INV_2_22,
    _X_OFFSET,
    _ZPOLY,
)
from monte_carlo_retirement_tpu_torch.ops import shocks  # noqa: E402

torch.set_num_threads(2)
MASK = (1 << 32) - 1


def _philox_reference(ctr, key, rounds=10):
    """Philox4x32: each round multiplies words 0 and 2 by M0, M1 into 64-bit
    products, then out = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0); the key
    is bumped by the Weyl constants (W0, W1) between rounds."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & MASK, (k1 + 0xBB67AE85) & MASK
        p0 = 0xD2511F53 * c0
        p1 = 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & MASK)
    return c0, c1, c2, c3


def test_philox_matches_big_int_definition():
    rng = np.random.default_rng(11)
    n = 2000
    words = rng.integers(0, 1 << 32, size=(6, n), dtype=np.uint64)
    words[:, :4] = [[0] * 4, [0] * 4, [MASK] * 4, [MASK] * 4,
                    [0, MASK, 1, 2], [MASK, 0, 3, 4]]
    ctr = [torch.from_numpy(words[i].astype(np.int64)) for i in range(4)]
    key = [torch.from_numpy(words[i].astype(np.int64)) for i in (4, 5)]
    got = torch.stack(shocks.philox4x32_10(*ctr, *key)).numpy()
    for j in range(n):
        want = _philox_reference([int(words[i, j]) for i in range(4)],
                                 [int(words[4, j]), int(words[5, j])])
        assert tuple(int(v) for v in got[:, j]) == want, j
    assert ((got >= 0) & (got <= MASK)).all()


def test_month_words_use_block_key_and_lane_counter():
    gblock, lane = shocks.path_keys(3 * 4096 + 5, block_offset=7, device="cpu")
    seed, month = 2026, 42
    got = torch.stack(shocks.month_words(seed, gblock, month, lane)).numpy()
    for p in (0, 1, 4095, 4096, 3 * 4096 + 4):
        want = _philox_reference([month, p % 4096, 0, 0], [seed, p // 4096 + 7])
        assert tuple(int(v) for v in got[:, p]) == want, p


def _numpy_normal(bits: np.ndarray) -> np.ndarray:
    f32 = np.float32
    r = (bits >> 9).astype(f32)
    x = r * f32(_INV_2_22) + f32(_X_OFFSET)
    s = np.sqrt(-np.log1p(-(x * x), dtype=f32), dtype=f32)
    acc = np.full(bits.shape, _ZPOLY[0], f32)
    for c in _ZPOLY[1:]:
        acc = acc * s + f32(c)
    return (acc * x).astype(f32)


def test_bits_to_normal_equals_the_pallas_sampler():
    assert shocks.ZPOLY == _ZPOLY
    assert shocks.INV_2_22 == _INV_2_22 and shocks.X_OFFSET == _X_OFFSET
    rng = np.random.default_rng(3)
    bits = np.concatenate([
        rng.integers(0, 1 << 32, size=200_000, dtype=np.int64),
        np.array([0, 511, 512, MASK, MASK - 511, 1 << 31], dtype=np.int64),
    ])
    got = shocks.bits_to_normal(torch.from_numpy(bits)).numpy()
    want = _numpy_normal(bits)
    assert got.dtype == np.float32
    # Same float32 operation order; only log1p's last bit may differ
    # between libraries.
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert float(rel.max()) <= 2e-6
    assert float((got == want).mean()) > 0.95


def test_normals_match_erfinv():
    r = np.unique(np.concatenate([
        np.arange(0, 1 << 23, 31, dtype=np.int64),
        np.array([0, 1, 2, (1 << 23) - 3, (1 << 23) - 2, (1 << 23) - 1]),
    ]))
    z = shocks.bits_to_normal(torch.from_numpy(r << 9)).numpy().astype(np.float64)
    x = (r.astype(np.float32) * np.float32(_INV_2_22)
         + np.float32(_X_OFFSET)).astype(np.float64)
    true = np.sqrt(2.0) * scipy_special.erfinv(x)
    rel = np.abs(z - true) / np.maximum(np.abs(true), 1e-12)
    assert float(rel.max()) < 2.0e-4
    assert np.isfinite(z).all() and (np.diff(z) > 0).all()


def test_stream_moments():
    n_paths = 1 << 16
    gblock, lane = shocks.path_keys(n_paths, 0, "cpu")
    z = torch.cat([
        shocks.month_normals(99, gblock, m, lane).reshape(-1)
        for m in (1, 2, 3, 600, 1439, 1440)
    ])[: 1 << 20].double()
    n = z.numel()
    assert n == 1 << 20
    mean, var = z.mean().item(), z.var().item()
    kurt = ((z - mean) ** 4).mean().item() / var**2
    # Monte Carlo standard errors: 1/sqrt(n), sqrt(2/n), sqrt(96/n).
    assert abs(mean) < 5 / np.sqrt(n)
    assert abs(var - 1.0) < 5 * np.sqrt(2 / n)
    assert abs(kurt - 3.0) < 5 * np.sqrt(96 / n)
    # The three words of a draw are independent normals.
    w = torch.stack(shocks.month_normals(5, gblock, 7, lane).double().unbind(0))
    corr = np.corrcoef(w.numpy())
    assert np.abs(corr - np.eye(3)).max() < 5 / np.sqrt(n_paths)
