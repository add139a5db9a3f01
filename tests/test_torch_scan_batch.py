"""The scan route of the port's ``run_scenario_batch`` against the JAX
package's ``run_scenario_batch``, on the CPU.

``backend="scan"`` is JAX's own route (``_batch_impl``): threefry scans of
every row on ``stream_keys(seed)[1]``, the crash and longevity draws on for
the whole batch when any row has them. So on the same seed, in float64,
every row counts the same survivors as JAX's and its mean, median and five
percentiles agree to round-off (1e-10 relative), for batches that mix
realized against mark-to-market tax on each asset, CPI-indexed against
fixed-nominal against capped streams, crashes and longevity, and for an
antithetic batch. JAX averages the flags in float32, so the percentages
are compared through their survivor counts. At JAX's default float32 the
statistics agree within 1e-4 relative, and within a cent where a ruined
path's balance is float32 dust (JAX left $6.1e-5 where the port has 0).
The refusals are JAX's, type and message; ``run_scenario_grid(backend=
"scan")`` is this route chunk by chunk, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import scenario_batch as jax_sb  # noqa: E402
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import scenario_batch as sb  # noqa: E402
from tests.conftest import base_config_dict  # noqa: E402

torch.set_num_threads(2)

R = 3
N = 4096 + 500
SEED = 4
STAT_RTOL = 1e-10  # float64: round-off
F32_RTOL = 1e-4  # float32 at JAX's default dtype
DUST = 0.01  # dollars: a ruined path's float32 residue counts as zero


def _stream(indexed=True, years=None):
    return {"name": "P", "monthly_amount_today": 400.0, "start_at_age": 40.5,
            "duration_years": years, "inflation_indexed": indexed,
            "tax_rate": 0.1}


CRASHES = {"frequency_per_year": 0.3, "mean_drop_pct": 25.0,
           "size_volatility": 0.1, "inv2_beta": 0.3}
LONGEVITY = {"mode_age": 45.0, "dispersion_years": 4.0, "max_age": 60.0}
INV1_REAL = dict(inv1_use_realized_gains_tax_system=True,
                 inv1_realized_gains_tax_rate=0.1)
INV2_REAL = dict(inv2_use_realized_gains_tax_system=True,
                 inv2_realized_gains_tax_rate=0.15)
# (working months, overrides), one stream in every row: tax systems on
# each asset, the three stream kinds (and fixed + capped), crashes,
# longevity and W mixed, the groups interleaved so the order matters.
MIXED = [
    (6, dict(INV1_REAL, other_income_streams=[_stream()])),
    (12, dict(inv1_annual_tax_on_gains_rate=0.25,
              other_income_streams=[_stream(indexed=False)])),
    (0, dict(INV2_REAL, market_crashes=CRASHES,
             other_income_streams=[_stream(years=2)])),
    (9, dict(INV1_REAL, **INV2_REAL, monthly_expenses=3_600.0,
             other_income_streams=[_stream()])),
    (3, dict(longevity=LONGEVITY, inv2_annual_tax_on_gains_rate=0.2,
             other_income_streams=[_stream()])),
    (12, dict(market_crashes=CRASHES, monthly_expenses=2_600.0,
              other_income_streams=[_stream(indexed=False, years=2)])),
    (7, dict(inv1_annual_tax_on_gains_rate=0.25,
             inv2_annual_tax_on_gains_rate=0.2, longevity=LONGEVITY,
             other_income_streams=[_stream(years=2)])),
    (5, dict(other_income_streams=[_stream()])),
]
ANTITHETIC = [
    (4, dict(antithetic=True, **INV1_REAL)),
    (10, dict(antithetic=True, market_crashes=CRASHES,
              inv2_annual_tax_on_gains_rate=0.2)),
    (0, dict(antithetic=True, monthly_expenses=3_400.0)),
]
BATCHES = {"mixed": MIXED, "antithetic": ANTITHETIC}


def _raw(**overrides):
    return base_config_dict(**{"retirement_years": R, "seed": SEED,
                               "initial_balance": 110_000.0,
                               "monthly_expenses": 3_100.0, **overrides})


def _both(rows):
    return ([Config(**_raw(**over)) for _, over in rows],
            [JaxConfig(**_raw(**over)) for _, over in rows],
            [w for w, _ in rows])


def _counts(pct):
    return np.rint(np.asarray(pct, dtype=float) * N / 100.0).astype(int)


STATS = ("median_final_balance", "mean_final_balance",
         "final_balance_percentiles")


def _largest_rel(got, want, floor=1e-300):
    """The largest deviation of the five statistics' tables relative to
    JAX's value, or to ``floor`` where that is smaller."""
    worst = 0.0
    for name in STATS:
        a = np.asarray(getattr(got, name), dtype=float)
        b = np.asarray(getattr(want, name), dtype=float)
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
            np.abs(b), floor))))
    return worst


@pytest.mark.parametrize("batch", list(BATCHES))
def test_scan_batch_equals_jax_in_float64(batch):
    configs, jax_configs, months = _both(BATCHES[batch])
    got = sb.run_scenario_batch(configs, months, N, seed=SEED, device="cpu",
                                backend="scan", dtype=torch.float64)
    want = jax_sb.run_scenario_batch(jax_configs, months, N, seed=SEED,
                                     dtype=jnp.float64)
    np.testing.assert_array_equal(_counts(got.success_probability),
                                  _counts(want.success_probability))
    # The port's percentage is the exact count over N.
    np.testing.assert_array_equal(got.success_probability,
                                  _counts(got.success_probability) / N * 100.0)
    p = got.success_probability
    assert 0.0 < p.min() and p.max() < 100.0  # every row non-degenerate
    worst = _largest_rel(got, want)
    print(f"\n{batch}: largest relative deviation from JAX {worst:.3e}")
    assert worst <= STAT_RTOL, worst
    np.testing.assert_allclose(got.success_sigma,
                               np.asarray(want.success_sigma, dtype=float),
                               rtol=1e-6)


def test_scan_batch_mixes_every_structure():
    """The mixed batch covers both tax systems on each asset, the stream
    kinds, crashes and longevity, and runs in groups of shared structure."""
    configs, _, _ = _both(MIXED)
    st = [ck.statics_from_config(c) for c in configs]
    assert {s.use_real1 for s in st} == {s.use_real2 for s in st} == {True, False}
    assert {s.bill1 for s in st} == {s.bill2 for s in st} == {True, False}
    kinds = {(s.stream_indexed, s.stream_capped) for s in st}
    assert kinds == {((True,), (False,)), ((False,), (False,)),
                     ((True,), (True,)), ((False,), (True,))}
    assert {s.jumps for s in st} == {s.mortality for s in st} == {True, False}


def test_scan_batch_float32_default_dtype_agrees_with_jax():
    configs, jax_configs, months = _both(MIXED)
    got = sb.run_scenario_batch(configs, months, N, seed=SEED, device="cpu",
                                backend="scan")
    want = jax_sb.run_scenario_batch(jax_configs, months, N, seed=SEED)
    assert np.asarray(want.mean_final_balance).dtype == np.float32
    np.testing.assert_allclose(got.success_probability,
                               np.asarray(want.success_probability, dtype=float),
                               rtol=F32_RTOL)
    for name in STATS:
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name), dtype=float),
                                   rtol=F32_RTOL, atol=DUST, err_msg=name)
    worst = _largest_rel(got, want, floor=1.0)
    print(f"\nfloat32: largest relative deviation from JAX (above $1) "
          f"{worst:.3e}")


def _refusal(call):
    with pytest.raises(Exception) as info:
        call()
    return type(info.value), str(info.value)


def test_scan_batch_refusals_are_jax_refusals():
    a = _raw()
    cases = {
        "align": ([a], [1, 2], {}),
        "retirement_years": ([a, base_config_dict(retirement_years=R + 1)],
                             [1, 1], {}),
        "streams": ([a, _raw(other_income_streams=[_stream()])], [1, 1], {}),
        "antithetic": ([a, _raw(antithetic=True)], [1, 1], {}),
        "t_scan": ([a], [12], {"t_scan": 12}),
    }
    for name, (raws, months, kw) in cases.items():
        want = _refusal(lambda: jax_sb.run_scenario_batch(
            [JaxConfig(**r) for r in raws], months, 16, dtype=jnp.float64, **kw))
        got = _refusal(lambda: sb.run_scenario_batch(
            [Config(**r) for r in raws], months, 16, device="cpu",
            backend="scan", dtype=torch.float64, **kw))
        assert got == want, name


def test_grid_scan_is_the_batch_scan_bit_for_bit():
    """``run_scenario_grid(backend="scan")`` runs each chunk through the
    batch's scan route in float32 on the grid's one horizon."""
    raws = [_raw(monthly_expenses=e, inv1_annual_tax_on_gains_rate=0.2)
            for e in (2_800.0, 3_100.0, 3_400.0, 3_700.0, 4_000.0)]
    months = [0, 12, 6, 3, 9]
    configs = [Config(**r) for r in raws]
    batch = sb.run_scenario_batch(configs, months, N, seed=SEED, device="cpu",
                                  backend="scan", dtype=torch.float32)
    for chunk in (None, 2):
        grid = sb.run_scenario_grid(configs, months, N, seed=SEED,
                                    device="cpu", backend="scan",
                                    chunk_size=chunk)
        for name, a, b in zip(batch._fields, grid, batch):
            np.testing.assert_array_equal(a, b, err_msg=f"{chunk} {name}")


def test_backend_and_dtype_resolution(monkeypatch):
    configs, _, months = _both(MIXED[:3])
    ck.reset_counts()
    scan = sb.run_scenario_batch(configs, months, 300, seed=SEED, device="cpu",
                                 backend="scan")
    # The scan runs no kernel's plain version: its own plain chain, once
    # per group of rows (the CPU's scan), and nothing else.
    assert ck.PLAIN_CALLS == {"probe": 0, "grid": 0, "simulate": 0,
                              "full": 0, "scan": 3, "ad": 0}
    monkeypatch.setenv("MCRT_GRID_BACKEND", "scan")
    knob = sb.run_scenario_batch(configs, months, 300, seed=SEED, device="cpu")
    for a, b in zip(scan, knob):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("MCRT_GRID_BACKEND", "auto")
    auto = sb.run_scenario_batch(configs, months, 300, seed=SEED, device="cpu")
    assert ck.PLAIN_CALLS["grid"] == 3  # the default: one launch per Statics
    pallas = sb.run_scenario_batch(configs, months, 300, seed=SEED,
                                   device="cpu", backend="pallas")
    for a, b in zip(auto, pallas):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown grid backend 'bogus'"):
        sb.run_scenario_batch(configs, months, 300, device="cpu",
                              backend="bogus")
    with pytest.raises(ValueError, match="needs a mesh"):
        sb.run_scenario_batch(configs, months, 300, device="cpu",
                              backend="pallas_sharded")
    # The grid kernel is float32: another dtype on the card is refused
    # before any launch, on any machine.
    with pytest.raises(ValueError, match="runs in float32"):
        sb.run_scenario_batch(configs, months, 300, device="cuda",
                              backend="pallas", dtype=torch.float64)


def test_pallas_route_float32_on_the_cpu():
    """The default route's plain version in float32 agrees with its float64
    run within float32 round-off."""
    configs, _, months = _both(MIXED[:4])
    lo = sb.run_scenario_batch(configs, months, 600, seed=SEED, device="cpu",
                               dtype=torch.float32)
    hi = sb.run_scenario_batch(configs, months, 600, seed=SEED, device="cpu")
    np.testing.assert_allclose(lo.success_probability, hi.success_probability,
                               atol=100.0 / 600)
    np.testing.assert_allclose(lo.mean_final_balance, hi.mean_final_balance,
                               rtol=1e-4)


def test_scan_batch_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    configs, _, months = _both(MIXED[:2])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sb.run_scenario_batch(configs, months, 64, backend="scan")
