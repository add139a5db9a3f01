"""The scan route of the port's ``sensitivity_ad`` against the JAX
package's ``sensitivity_ad``, on the CPU.

``backend="scan"`` differentiates JAX's own function: ``torch.func.jacfwd``
of the mean of ``simulate_paths``' final balances on ``stream_keys(seed)[1]``
over ``W + 12 R`` months, the loop's structure fixed once from the base
parameters (``kernel.scan_rows(statics=)``). On the same seed in float64
the value agrees with JAX's within 1e-10 relative and every gradient
within 1e-8 relative (1e-8 absolute where JAX's is below 1): for the 8
default parameters, a fee, the allocation without a glide (the
``alloc1_final`` mirror), an annual tax rate at a zero base (JAX bills at
rate 0 as data), and each extension case of
``test_torch_ad.py::test_extension_statics_under_ad``. Under
``MCRT_GRID_BACKEND=scan`` the finite difference and AD share their draws:
the scan FD's central difference agrees with the scan AD within 5%.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import sensitivity as jax_sens  # noqa: E402
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.sensitivity import (  # noqa: E402
    DEFAULT_PARAMS,
    sensitivity_ad,
    sensitivity_fd,
)
from tests.conftest import base_config_dict  # noqa: E402
from tests.test_torch_ad import CRASHES, EXTENSION_CASES  # noqa: E402

torch.set_num_threads(2)

SEED = 77
VALUE_RTOL = 1e-10
GRAD_RTOL = 1e-8
GRAD_ATOL = 1e-8  # where JAX's gradient is below 1 in magnitude


def _main_raw(**over):
    return base_config_dict(**{"seed": SEED, "retirement_years": 4,
                               "monthly_expenses": 4_000.0,
                               "inv1_returns_volatility": 0.15, **over})


def _extension_raw(over):
    return base_config_dict(retirement_years=8, initial_balance=260_000.0,
                            monthly_expenses=2_300.0,
                            inv1_returns_volatility=0.16,
                            num_simulations_main=64, **over)


# name -> (raw config, W, paths, parameters)
CASES = {
    "defaults": (_main_raw(), 24, 2000, list(DEFAULT_PARAMS)),
    "fee": (_main_raw(inv1_expense_ratio_annual=0.005,
                      inv2_expense_ratio_annual=0.002), 24, 1000,
            ["inv1_expense_ratio_annual", "inv2_expense_ratio_annual"]),
    "allocation_no_glide": (_main_raw(), 0, 1000, ["allocation_inv1_pct"]),
    "annual_tax_at_zero": (_main_raw(inv2_annual_tax_on_gains_rate=0.2), 24,
                           1000, ["inv1_annual_tax_on_gains_rate",
                                  "inv2_annual_tax_on_gains_rate",
                                  "allocation_inv1_pct"]),
    **{f"extension_{case}": (_extension_raw(over), 6, 512,
                             ["initial_balance", "monthly_expenses"])
       for case, (over, _dotted, _smooth) in EXTENSION_CASES.items()},
}


def _compare(got, want):
    """The value's and the gradients' largest deviations from JAX's."""
    value_rel = abs(got["mean_final_balance"] - want["mean_final_balance"]) / abs(
        want["mean_final_balance"])
    grad_dev = 0.0
    for name, w in want["d_mean_final"].items():
        g = got["d_mean_final"][name]
        dev = abs(g - w) / abs(w) if abs(w) >= 1.0 else abs(g - w)
        grad_dev = max(grad_dev, dev)
    return value_rel, grad_dev


@pytest.mark.parametrize("case", list(CASES))
def test_scan_ad_equals_jax_in_float64(case):
    raw, w, n, names = CASES[case]
    ck.reset_counts()
    got = sensitivity_ad(Config(**raw), w, num_paths=n, seed=SEED,
                         params=names, device="cpu", backend="scan",
                         dtype=torch.float64)
    assert ck.PLAIN_CALLS["ad"] == 1 and ck.PLAIN_CALLS["grid"] == 0
    want = jax_sens.sensitivity_ad(JaxConfig(**raw), w, num_paths=n,
                                   seed=SEED, params=names, dtype=jnp.float64)
    assert list(got["d_mean_final"]) == names
    value_rel, grad_dev = _compare(got, want)
    print(f"\n{case}: value rel {value_rel:.3e}, gradients {grad_dev:.3e}")
    assert value_rel <= VALUE_RTOL, value_rel
    for name in names:
        g, w_ = got["d_mean_final"][name], want["d_mean_final"][name]
        assert math.isfinite(g), name
        if abs(w_) >= 1.0:
            assert abs(g - w_) <= GRAD_RTOL * abs(w_), (name, g, w_)
        else:
            assert abs(g - w_) <= GRAD_ATOL, (name, g, w_)


def test_scan_ad_bills_a_differentiated_zero_rate():
    """JAX's scan bills an annual-system asset at rate 0 as data, so the
    derivative at a zero base rate is the bill's: negative, as JAX's."""
    raw, w, n, _ = CASES["annual_tax_at_zero"]
    got = sensitivity_ad(Config(**raw), w, num_paths=n, seed=SEED,
                         params=["inv1_annual_tax_on_gains_rate"],
                         device="cpu", backend="scan", dtype=torch.float64)
    assert Config(**raw).inv1_annual_tax_on_gains_rate == 0.0
    assert got["d_mean_final"]["inv1_annual_tax_on_gains_rate"] < 0.0


def test_scan_fd_and_ad_share_their_draws_under_the_knob(monkeypatch):
    """``MCRT_GRID_BACKEND=scan`` sends both the CRN finite difference and
    AD to the scan: their slopes of the mean final balance agree."""
    monkeypatch.setenv("MCRT_GRID_BACKEND", "scan")
    cfg = Config(**_main_raw())
    names = ["monthly_expenses", "inv1_returns_mean"]
    ck.reset_counts()
    ad = sensitivity_ad(cfg, 24, num_paths=2000, seed=SEED, params=names,
                        device="cpu")
    rows = sensitivity_fd(cfg, 24, num_paths=2000, seed=SEED, params=names,
                          device="cpu", rel_step=0.002, abs_step=0.0005)
    assert not any(ck.PLAIN_CALLS[k] for k in ("grid", "probe", "full"))
    fd = {r.param: r.d_mean_final for r in rows}
    scan = sensitivity_ad(cfg, 24, num_paths=2000, seed=SEED, params=names,
                          device="cpu", backend="scan")
    assert ad == scan
    for name in names:
        assert ad["d_mean_final"][name] == pytest.approx(fd[name], rel=0.05)
    assert ad["d_mean_final"]["monthly_expenses"] < 0.0
    assert ad["d_mean_final"]["inv1_returns_mean"] > 0.0


def test_scan_ad_routes_and_refusals(monkeypatch):
    cfg = Config(**_main_raw())
    names = ["monthly_expenses"]
    default = sensitivity_ad(cfg, 24, num_paths=300, seed=SEED, params=names,
                             device="cpu")
    for backend in ("auto", "pallas", "pallas_sharded"):
        assert sensitivity_ad(cfg, 24, num_paths=300, seed=SEED, params=names,
                              device="cpu", backend=backend) == default
    scan = sensitivity_ad(cfg, 24, num_paths=300, seed=SEED, params=names,
                          device="cpu", backend="scan")
    assert scan != default  # threefry paths, not the grid kernel's
    with pytest.raises(ValueError, match="unknown grid backend 'bogus'"):
        sensitivity_ad(cfg, 24, num_paths=300, params=names, device="cpu",
                       backend="bogus")
    with pytest.raises(ValueError, match="FD-only"):
        sensitivity_ad(Config(**_main_raw(market_crashes=dict(CRASHES))), 24,
                       params=["market_crashes.frequency_per_year"],
                       device="cpu", backend="scan")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            sensitivity_ad(cfg, 24, num_paths=8, params=names, backend="scan")


def test_scan_ad_float32_value_is_jax_and_slopes_are_its_fd():
    """The card's default dtype, here on the CPU: the value equals JAX's
    float32 value (the same float32 draws), and each gradient the float32
    scan's CRN central difference within 0.1% (measured within 1e-6).
    JAX's own float32 AD is not the yardstick: its d/d equity mean
    (1.788e6) is 19% below its own float32 finite difference (2.208e6),
    which the port's AD meets."""
    raw = _main_raw()
    names = ["monthly_expenses", "initial_balance", "inv1_returns_mean"]
    got = sensitivity_ad(Config(**raw), 24, num_paths=1000, seed=SEED,
                         params=names, device="cpu", backend="scan",
                         dtype=torch.float32)
    want = jax_sens.sensitivity_ad(JaxConfig(**raw), 24, num_paths=1000,
                                   seed=SEED, params=names, dtype=jnp.float32)
    value_rel, _ = _compare(got, want)
    print(f"\nfloat32: value rel {value_rel:.3e}")
    assert value_rel <= 1e-4
    rows = sensitivity_fd(Config(**raw), 24, num_paths=1000, seed=SEED,
                          params=names, device="cpu", backend="scan",
                          rel_step=0.002, abs_step=0.002)
    for r in rows:
        print(f"{r.param}: AD {got['d_mean_final'][r.param]:.7g} "
              f"FD {r.d_mean_final:.7g}")
        assert got["d_mean_final"][r.param] == pytest.approx(
            r.d_mean_final, rel=1e-3), r.param
