"""The port's threefry stream against ``jax.random`` and the scan's draws
against the JAX package's ``ops/shocks.py``.

Keys, ``fold_in``, ``split``, the random bits and the uniforms must be bit
for bit those of ``jax.random`` (JAX's partitionable threefry). Normals go
through the same polynomial as XLA's ``erf_inv``, but XLA's CPU ``log1p``
and ``sqrt`` are not torch's, so they may differ in the last bits: measured
at most 3 ulps in float32 and 31 ulps in float64 (3M draws each of four
seeds), held here within 4 and 32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.ops import shocks as jshocks  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import shocks  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import threefry as tf  # noqa: E402

torch.set_num_threads(2)

SEEDS = (0, 7, 2026, 2**32 + 5, 2**40 + 3, 2**63 - 1)
SHAPES = ((7,), (1001, 3), (5, 4, 3), (2,))
ULPS = {torch.float32: 4, torch.float64: 32}
DTYPES = ((torch.float32, jnp.float32), (torch.float64, jnp.float64))


def _key(jkey) -> tuple:
    return tuple(int(v) for v in np.asarray(jkey))


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want) / np.spacing(np.abs(want))))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_split_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    key = tf.prng_key(seed)
    assert key == _key(jk)
    for data in (0, 1, 600, shocks.JUMP_FOLD_OFFSET + 5, shocks.MORT_FOLD_OFFSET,
                 2**32 - 1):
        assert tf.fold_in(key, data) == _key(jax.random.fold_in(jk, data))
    for num in (2, 3):
        assert list(tf.split(key, num)) == [_key(k) for k in
                                            jax.random.split(jk, num)]


def test_prng_key_and_fold_in_reject_out_of_range():
    with pytest.raises(ValueError):
        tf.prng_key(-1)
    with pytest.raises(ValueError):
        tf.prng_key(2**63)
    with pytest.raises(ValueError):
        tf.fold_in(tf.prng_key(0), 2**32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", (0, 2026, 2**40 + 3))
def test_random_bits_equal_jax(seed, shape):
    jk = jax.random.PRNGKey(seed)
    b32 = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(
        tf.random_bits(tf.prng_key(seed), 32, shape).numpy(), b32)
    b64 = np.asarray(jax.random.bits(jk, shape, jnp.uint64)).view(np.int64)
    np.testing.assert_array_equal(
        tf.random_bits(tf.prng_key(seed), 64, shape).numpy(), b64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=("f32", "f64"))
def test_uniform_bit_equal_jax(dtypes, shape):
    tdt, jdt = dtypes
    for seed in (7, 2**32 + 5):
        jk = jax.random.PRNGKey(seed)
        for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-2.0, 2.0), (-2.0, 3.0)):
            want = np.asarray(jax.random.uniform(jk, shape, jdt, lo, hi))
            got = tf.uniform(tf.prng_key(seed), shape, tdt, lo, hi).numpy()
            assert got.dtype == want.dtype
            if hi - lo in (1.0, 2.0, 4.0):
                np.testing.assert_array_equal(got, want)
            else:  # XLA fuses the scale and shift into one rounding
                span_ulp = np.spacing(want.dtype.type(hi - lo))
                assert np.abs(got - want).max() <= span_ulp


@pytest.mark.parametrize("shape", ((100_003, 3), (5, 4, 3)))
@pytest.mark.parametrize("dtypes", DTYPES, ids=("f32", "f64"))
def test_normal_within_stated_ulps_of_jax(dtypes, shape):
    tdt, jdt = dtypes
    for seed in (2026, 2**40 + 3):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jdt))
        got = tf.normal(tf.prng_key(seed), shape, tdt).numpy()
        assert got.dtype == want.dtype and np.isfinite(got).all()
        assert _ulps(got, want) <= ULPS[tdt]


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_erfinv_edges_and_row_offset(dtype):
    x = torch.tensor([-1.0, 0.0, 1.0], dtype=dtype)
    np.testing.assert_array_equal(tf.erfinv(x).numpy(), [-np.inf, 0.0, np.inf])
    key = tf.prng_key(11)
    full = tf.normal(key, (1000, 3), dtype)
    part = tf.normal(key, (217, 3), dtype, row_offset=401)
    assert torch.equal(part, full[401:618])
    whole = tf.random_bits(key, 32, (64,))
    assert torch.equal(tf.random_bits(key, 32, (9,), row_offset=50), whole[50:59])


@pytest.mark.parametrize("seed", (0, 2026, 2**63 - 1, 2**63, 2**70 + 9))
def test_stream_keys_equal_jax(seed):
    got = shocks.stream_keys(seed)
    want = jshocks.stream_keys(seed)
    assert got == tuple(_key(k) for k in want)
    assert got[0] != got[1]


def test_stream_keys_reject_a_negative_seed_as_jax_does():
    with pytest.raises(ValueError):
        jshocks.stream_keys(-5)
    with pytest.raises(ValueError):
        shocks.stream_keys(-5)


@pytest.mark.parametrize("antithetic", (False, True), ids=("iid", "anti"))
@pytest.mark.parametrize("n", (1, 6, 1001))
@pytest.mark.parametrize("dtypes", DTYPES, ids=("f32", "f64"))
def test_monthly_shocks_equal_jax(dtypes, n, antithetic):
    tdt, jdt = dtypes
    _, jkey = jshocks.stream_keys(2026)
    _, key = shocks.stream_keys(2026)
    for month in (1, 600):
        want = jshocks.monthly_shocks(jkey, month, n, jnp.asarray(-0.3, jdt), jdt,
                                      antithetic=antithetic)
        got = shocks.monthly_shocks(key, month, n, -0.3, tdt,
                                    antithetic=antithetic)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=4 * ULPS[tdt] * np.spacing(w.dtype.type(4)))
        if antithetic and n > 1:
            z_eq = got[0]
            pairs = n // 2
            assert torch.equal(z_eq[1:2 * pairs:2], -z_eq[0:2 * pairs:2])
            # The even half is the iid draw of half the paths.
            iid = shocks.monthly_shocks(key, month, (n + 1) // 2, -0.3, tdt)[0]
            assert torch.equal(z_eq[0::2], iid)


@pytest.mark.parametrize("antithetic", (False, True), ids=("iid", "anti"))
@pytest.mark.parametrize("dtypes", DTYPES, ids=("f32", "f64"))
def test_jump_and_mortality_draws_equal_jax(dtypes, antithetic):
    tdt, jdt = dtypes
    n = 1001
    _, jkey = jshocks.stream_keys(7)
    _, key = shocks.stream_keys(7)
    for month in (1, 5, 600):
        ju, jz = jshocks.monthly_jump_draws(jkey, month, n, jdt, antithetic)
        u, z = shocks.monthly_jump_draws(key, month, n, tdt, antithetic)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        jz = np.asarray(jz)
        assert _ulps(z.numpy(), jz) <= ULPS[tdt] or np.allclose(z.numpy(), jz, rtol=0,
                                                               atol=1e-6)
    want = np.asarray(jshocks.mortality_uniform(jkey, n, jdt, antithetic))
    got = shocks.threefry_mortality_uniform(key, n, tdt, antithetic)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("antithetic", (False, True), ids=("iid", "anti"))
def test_draws_of_a_shard_are_its_rows_of_the_whole(antithetic):
    _, key = shocks.stream_keys(3)
    n, start, rows = 999, 257, 300
    whole = shocks.monthly_normals(key, 9, n, torch.float64, antithetic)
    part = shocks.monthly_normals(key, 9, rows, torch.float64, antithetic,
                                  row_offset=start)
    assert torch.equal(part, whole[:, start:start + rows])
    u_all, z_all = shocks.monthly_jump_draws(key, 9, n, torch.float32, antithetic)
    u, z = shocks.monthly_jump_draws(key, 9, rows, torch.float32, antithetic,
                                     row_offset=start)
    assert torch.equal(u, u_all[start:start + rows])
    assert torch.equal(z, z_all[start:start + rows])
    m_all = shocks.threefry_mortality_uniform(key, n, torch.float32, antithetic)
    m = shocks.threefry_mortality_uniform(key, rows, torch.float32, antithetic,
                                          row_offset=start)
    assert torch.equal(m, m_all[start:start + rows])


def test_monthly_gross_factors_equal_jax():
    rng = np.random.default_rng(5)
    z = [rng.standard_normal(257) for _ in range(3)]
    pars = [0.09, 0.17, 0.03, 0.02, 0.04, 0.06]
    want = jshocks.monthly_gross_factors(*[jnp.asarray(v) for v in z],
                                         *[jnp.asarray(p) for p in pars])
    got = shocks.monthly_gross_factors(*[torch.from_numpy(v) for v in z],
                                       *[torch.tensor(p, dtype=torch.float64)
                                         for p in pars])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)
