"""The port's mixed-Statics scenario batch (``run_scenario_batch``) vs the
JAX package's, on the CPU.

``run_scenario_batch`` keeps the JAX rules and messages
(``tests/test_scenario_batch.py:38-94``) and accepts rows that mix tax
systems, crashes and longevity (``:208-254``). The port groups the rows by
``Statics`` and launches each group on the grid path, so every row must
equal the same row run alone through ``run_scenario_grid``, exactly; and
each row must agree with JAX's scan-engine batch within 4 sigma (Philox
here, threefry there).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import scenario_batch as jax_sb  # noqa: E402
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import scenario_batch as sb  # noqa: E402
from tests.conftest import base_config_dict, binomial_sigma_pct  # noqa: E402

torch.set_num_threads(2)

R = 3
N = 4096 + 500
SEED = 4
PENSION = {"name": "P", "monthly_amount_today": 100.0, "start_at_age": 60.0,
           "duration_years": None, "inflation_indexed": True, "tax_rate": 0.0}
CRASHES = {"frequency_per_year": 0.3, "mean_drop_pct": 25.0,
           "size_volatility": 0.1, "inv2_beta": 0.3}
LONGEVITY = {"mode_age": 45.0, "dispersion_years": 4.0, "max_age": 60.0}
# (working months, overrides): tax systems, crashes, longevity and per-row
# W mixed, the Statics groups interleaved so the caller's order matters.
ROWS = [
    (6, dict(inv1_use_realized_gains_tax_system=True,
             inv1_realized_gains_tax_rate=0.1)),
    (12, dict(inv1_annual_tax_on_gains_rate=0.25)),
    (0, dict(market_crashes=CRASHES)),
    (9, dict(inv1_use_realized_gains_tax_system=True,
             inv1_realized_gains_tax_rate=0.1, monthly_expenses=3_600.0)),
    (3, dict(longevity=LONGEVITY)),
    (12, dict(market_crashes=CRASHES, monthly_expenses=2_600.0)),
]


def _raw(**overrides):
    return base_config_dict(**{"retirement_years": R, "seed": SEED,
                               "initial_balance": 110_000.0,
                               "monthly_expenses": 3_100.0, **overrides})


def _batch():
    return ([Config(**_raw(**over)) for _, over in ROWS],
            [w for w, _ in ROWS])


def test_batch_validates_structure_like_jax():
    a = Config(**_raw())
    b = Config(**base_config_dict(retirement_years=R + 1))
    with pytest.raises(ValueError, match="retirement_years"):
        sb.stack_params([a, b])
    with pytest.raises(ValueError, match="retirement_years"):
        sb.run_scenario_batch([a, b], [1, 1], 16, device="cpu")
    c = Config(**_raw(other_income_streams=[PENSION]))
    with pytest.raises(ValueError, match="effective income"):
        sb.run_scenario_batch([a, c], [1, 1], 16, device="cpu")
    with pytest.raises(ValueError, match="align"):
        sb.run_scenario_batch([a], [1, 2], 16, device="cpu")
    # A zero-amount stream is pruned: raw counts match, effective ones not.
    padded = Config(**_raw(other_income_streams=[
        dict(PENSION, name="pad", monthly_amount_today=0.0)]))
    with pytest.raises(ValueError, match="effective income"):
        sb.stack_params([c, padded])
    anti = Config(**_raw(antithetic=True))
    with pytest.raises(ValueError, match="antithetic"):
        sb.run_scenario_batch([a, anti], [1, 1], 16, device="cpu")
    with pytest.raises(ValueError, match="t_scan"):
        sb.run_scenario_batch([a], [12], 16, t_scan=12, device="cpu")
    # The JAX batch raises on the same inputs.
    with pytest.raises(ValueError, match="antithetic"):
        jax_sb.run_scenario_batch([JaxConfig(**_raw()),
                                   JaxConfig(**_raw(antithetic=True))],
                                  [1, 1], 16)
    with pytest.raises(ValueError, match="align"):
        jax_sb.run_scenario_batch([JaxConfig(**_raw())], [1, 2], 16)


def test_mixed_tax_systems_accepted_by_batch_only():
    """The grid refuses mixed Statics; the batch accepts them (JAX
    ``test_mixed_tax_systems_rejected_by_pallas_grid_only``)."""
    configs, months = _batch()
    with pytest.raises(ValueError, match="Statics"):
        sb.run_scenario_grid(configs[:2], months[:2], 64, device="cpu")
    res = sb.run_scenario_batch(configs[:2], months[:2], 64, seed=SEED,
                                device="cpu")
    assert res.success_probability.shape == (2,)
    assert res.final_balance_percentiles.shape == (2, 5)


def test_mixed_batch_rows_equal_each_row_alone():
    configs, months = _batch()
    assert len({ck.statics_from_config(c) for c in configs}) == 4
    ck.reset_counts()
    got = sb.run_scenario_batch(configs, months, N, seed=SEED, device="cpu")
    # One plain grid launch per Statics group.
    assert ck.PLAIN_CALLS["grid"] == 4
    for i, (cfg, w) in enumerate(zip(configs, months)):
        alone = sb.run_scenario_grid([cfg], [w], N, seed=SEED, device="cpu")
        for name, a, b in zip(got._fields, got, alone):
            np.testing.assert_array_equal(a[i], b[0], err_msg=f"row {i} {name}")
    p = got.success_probability
    assert 0.0 < p.min() and p.max() < 100.0  # every row non-degenerate


def test_mixed_batch_agrees_with_jax_within_4_sigma():
    configs, months = _batch()
    got = sb.run_scenario_batch(configs, months, N, seed=SEED, device="cpu")
    want = jax_sb.run_scenario_batch(
        [JaxConfig(**_raw(**over)) for _, over in ROWS], months, N, seed=SEED)
    for i, (p, q) in enumerate(zip(got.success_probability,
                                   np.asarray(want.success_probability))):
        sigma = math.hypot(binomial_sigma_pct(p, N), binomial_sigma_pct(q, N))
        assert abs(p - q) <= 4 * sigma, (i, p, q, sigma)
