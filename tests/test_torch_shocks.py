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


def test_crash_and_longevity_draws_follow_their_counters():
    """The crash uniform is word 3 of the month's draw, the crash normal
    word 0 of counter (month, lane, 1, 0), the longevity uniform word 0 of
    key (seed ^ 668265261, block) at counter (0, lane, 2, 0); uniforms are
    the top 23 bits times 2^-23, as the Pallas ``_uniform``."""
    gblock, lane = shocks.path_keys(2 * 4096 + 3, block_offset=5, device="cpu")
    seed, month = 77, 13
    d = shocks.month_draws(seed, gblock, month, lane, jumps=True)
    u_mort = shocks.mortality_uniform(seed, gblock, lane)
    for p in (0, 4095, 4096, 2 * 4096 + 2):
        key = [seed, p // 4096 + 5]
        w = _philox_reference([month, p % 4096, 0, 0], key)
        wj = _philox_reference([month, p % 4096, 1, 0], key)
        wm = _philox_reference([0, p % 4096, 2, 0], [seed ^ 668265261, key[1]])
        assert float(d[3, p]) == (w[3] >> 9) / 2.0**23
        assert float(d[4, p]) == float(_numpy_normal(np.array([wj[0]]))[0])
        assert float(u_mort[p]) == (wm[0] >> 9) / 2.0**23
    # The base normals are the same words with the crash draws on.
    assert torch.equal(d[:3], shocks.month_normals(seed, gblock, month, lane))
    assert d.dtype == torch.float32 and float(d[3].max()) < 1.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gompertz_remaining_months_matches_jax(dtype):
    import jax.numpy as jnp

    from monte_carlo_retirement_tpu.ops.shocks import (
        gompertz_remaining_months as jax_gompertz,
    )

    rng = np.random.default_rng(8)
    u = np.concatenate([rng.uniform(size=2000), [0.0, 2.0**-23, 0.5,
                                                  1.0 - 2.0**-23]])
    # rows: (g0, b12, cap, W) — young and old retirees (both branches), a
    # binding cap, and a sentinel row without a rule (b12 = 0)
    rows = np.array([[4.8, 120.0, 840.0, 0.0], [4.8, 120.0, 840.0, 300.0],
                     [0.5, 48.0, 360.0, 200.0], [2.0, 60.0, 100.0, 24.0],
                     [0.0, 0.0, 3.0e7, 12.0]])
    want = np.asarray(jax_gompertz(
        jnp.asarray(u, dtype)[None], *(jnp.asarray(rows[:, i:i + 1], dtype)
                                        for i in range(4)), getattr(jnp, dtype)))
    t = lambda a: torch.as_tensor(a, dtype=getattr(torch, dtype))  # noqa: E731
    got = shocks.gompertz_remaining_months(
        t(u)[None], *(t(rows[:, i:i + 1]) for i in range(3)), t(rows[:, 3:4])
    ).numpy()
    assert np.isinf(got[-1]).all() and (got[:-1] <= rows[:-1, 2:3]).all()
    # Relative round-off of the log chain, or of a month when t is tiny.
    rtol, atol = (1e-12, 1e-9) if dtype == "float64" else (2e-6, 1e-4)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert got[0, -4] == rows[0, 2]  # u = 0: the longest life, the cap
