"""The port's quantiles and run summary vs numpy and the JAX ``ops/stats.py``.

Same per-path float64 arrays into both: ``exact_quantiles`` against
``np.percentile`` / ``np.nanpercentile`` and ``summarize`` against JAX
``summarize``, with NaN withdrawal rates, ties, and a batch with no
successful path, at 1e-12 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.engine.kernel import PathOutputs  # noqa: E402
from monte_carlo_retirement_tpu.ops.stats import (  # noqa: E402
    summarize as jax_summarize,
)
from monte_carlo_retirement_tpu_torch.ops.quantiles import (  # noqa: E402
    exact_quantiles,
    quantiles_percol,
)
from monte_carlo_retirement_tpu_torch.ops.stats import summarize  # noqa: E402

torch.set_num_threads(2)
QS = (0.0, 0.01, 0.05, 0.1, 0.25, 0.333, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)


def _table(rng, n, C):
    x = rng.lognormal(12.0, 1.0, size=(n, C))
    x[: n // 10] = np.round(x[: n // 10], -4)  # ties
    x[n // 10 : n // 5] = 0.0
    return rng.permuted(x, axis=0)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4099])
def test_exact_quantiles_equal_np_percentile(n):
    rng = np.random.default_rng(n)
    x = _table(rng, n, 5)
    got = exact_quantiles(torch.from_numpy(x), QS).numpy()
    want = np.percentile(x, np.asarray(QS) * 100, axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # The kernels' (C, n) layout, read through an (n, C) view.
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    np.testing.assert_allclose(exact_quantiles(xt.t(), QS).numpy(), want,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("n", [3, 1000])
def test_masked_quantiles_equal_np_nanpercentile(n):
    rng = np.random.default_rng(100 + n)
    x = _table(rng, n, 6)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[:, 4] = np.nan  # a column with no valid entry -> NaN
    x[1:, 5] = np.nan  # a single valid entry
    valid = ~np.isnan(x)
    got = exact_quantiles(torch.from_numpy(x), QS,
                          valid=torch.from_numpy(valid)).numpy()
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = np.nanpercentile(x, np.asarray(QS) * 100, axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)
    qmat = torch.tensor([[0.5, 0.9]] * 6, dtype=torch.float64)
    per = quantiles_percol(torch.from_numpy(x), qmat, torch.from_numpy(valid))
    np.testing.assert_allclose(per.numpy(), want[[6, 8]].T, rtol=1e-12,
                               equal_nan=True)


def _outs(rng, n, L, R, succ_rate):
    success = rng.random(n) < succ_rate
    start = rng.lognormal(13.0, 0.5, n)
    start[:3] = 0.0
    final = np.where(success, rng.lognormal(13.5, 1.0, n), 0.0)
    fyr = start * rng.uniform(0.03, 0.07, n)
    traj = rng.lognormal(12.0, 1.0, (n, L))
    price = np.cumprod(rng.uniform(1.0, 1.08, (n, L)), axis=1)
    price[:2, 1:] = 0.0  # exercise the price <= EPS branch of the real table
    wr = rng.uniform(2.0, 9.0, (n, R))
    wr[rng.random((n, R)) < 0.2] = np.nan
    wr[:, -1] = np.nan  # a year with no observation
    ytr = np.where(success, np.nan, rng.uniform(0, R, n))
    return dict(success=success, final_balance=final, start_balance=start,
                years_to_ruin=ytr, first_year_gross=fyr * 1.1,
                first_year_real_gross=fyr, inflation_at_retirement=price[:, 0],
                trajectory=traj, price_levels=price, withdrawal_rates=wr)


@pytest.mark.parametrize("succ_rate", [0.0, 0.7, 1.0])
def test_summarize_equals_jax_summarize(succ_rate):
    rng = np.random.default_rng(int(succ_rate * 10))
    n, L, R = 3001, 9, 6
    arrs = _outs(rng, n, L, R, succ_rate)
    sample_idx = rng.choice(n, size=5, replace=False)
    want = jax_summarize(
        PathOutputs(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        jnp.asarray(sample_idx),
    )
    got = summarize({k: torch.from_numpy(v) for k, v in arrs.items()},
                    torch.from_numpy(sample_idx))
    assert got._fields == want._fields
    # JAX averages the success flags in float32; the port in the batch's
    # dtype, so it equals numpy's float64 mean.
    np.testing.assert_allclose(float(got.success_probability),
                               arrs["success"].mean() * 100.0, rtol=1e-12)
    np.testing.assert_allclose(float(got.success_probability),
                               float(want.success_probability), rtol=1e-6)
    for name in got._fields[1:]:
        g = np.asarray(getattr(got, name).numpy(), dtype=np.float64)
        w = np.asarray(getattr(want, name), dtype=np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True,
                                   err_msg=name)
    if succ_rate == 0.0:
        assert np.isnan(float(got.median_final_successful))
    assert float(got.wr_observation_counts[-1]) == 0
    assert np.isnan(got.wr_percentiles[:, -1].numpy()).all()
