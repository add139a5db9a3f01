"""The port's forward-mode AD sensitivity (``engine/sensitivity.sensitivity_ad``).

``torch.func.jacfwd`` through the plain month loop, in float64 on the CPU,
held as the JAX suite holds ``jax.jacfwd`` through its scan
(``tests/test_sensitivity.py:146-200``): against the port's own
common-random-numbers finite differences of the same metric (the AD paths
are the grid's), with the economic signs; the allocation mirror without a
glide; the differentiable lognormal conversion; the fee, crash, guardrail
and longevity cases (``test_fees.py:112``, ``test_crashes.py:368-420``,
``test_guardrails.py:202-226``, ``test_longevity.py:522-557``); and
against the JAX package's AD on the same config within 4 sigma of the
per-path derivatives' spread (the two packages draw different paths).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import sensitivity as jax_sens  # noqa: E402
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import kernel  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (  # noqa: E402
    _grid_stream_seed,
)
from monte_carlo_retirement_tpu_torch.engine.sensitivity import (  # noqa: E402
    _log_params_ad,
    _params_from_theta,
    sensitivity_ad,
    sensitivity_fd,
)
from monte_carlo_retirement_tpu_torch.models.retirement import (  # noqa: E402
    arithmetic_to_log_params,
)
from tests.conftest import base_config_dict  # noqa: E402

torch.set_num_threads(2)

# The JAX suite's scale: 120 working months + 10 years of retirement.
W = 120
N = 2000
R_YEARS = 10
SEED = 77
CRASHES = {"frequency_per_year": 0.5, "mean_drop_pct": 30.0,
           "size_volatility": 0.2, "inv2_beta": 0.3}


def _raw(**overrides):
    base = dict(seed=SEED, retirement_years=R_YEARS, monthly_expenses=4_000.0,
                inv1_returns_volatility=0.15, num_simulations_main=N)
    base.update(overrides)
    return base_config_dict(**base)


def _cfg(**overrides):
    return Config(**_raw(**overrides))


def _ad_and_fd(cfg, w, names, n, **fd_steps):
    ad = sensitivity_ad(cfg, w, num_paths=n, seed=SEED, params=names,
                        device="cpu")
    rows = sensitivity_fd(cfg, w, num_paths=n, seed=SEED, params=names,
                          device="cpu", **fd_steps)
    return ad, {r.param: r.d_mean_final for r in rows}


def test_ad_matches_fd_on_mean_final():
    names = ["monthly_expenses", "inv1_returns_mean"]
    ck.reset_counts()
    ad, fd = _ad_and_fd(_cfg(), W, names, N, rel_step=0.002, abs_step=0.0005)
    assert ck.PLAIN_CALLS["ad"] == 1 and ck.PLAIN_CALLS["grid"] == 1
    for name in names:
        grad = ad["d_mean_final"][name]
        assert math.isfinite(grad)
        assert grad == pytest.approx(fd[name], rel=0.05), (name, grad, fd[name])
    assert ad["d_mean_final"]["monthly_expenses"] < 0
    assert ad["d_mean_final"]["inv1_returns_mean"] > 0
    assert ad["mean_final_balance"] > 0


def test_ad_allocation_gradient_covers_retirement_phase():
    """Without a glide the retirement phase reads alloc1_final, which
    mirrors alloc1: theta must move both leaves. At W = 0 every month is a
    retirement month."""
    cfg = _cfg()
    assert cfg.allocation_inv1_final_pct is None
    ad, fd = _ad_and_fd(cfg, 0, ["allocation_inv1_pct"], N, abs_step=0.002)
    grad = ad["d_mean_final"]["allocation_inv1_pct"]
    assert math.isfinite(grad) and abs(fd["allocation_inv1_pct"]) > 0
    assert grad == pytest.approx(fd["allocation_inv1_pct"], rel=0.1)
    p = _params_from_theta(cfg, ["allocation_inv1_pct"],
                           torch.tensor([0.37], dtype=torch.float64))
    assert float(p.alloc1) == float(p.alloc1_final) == 0.37
    glide = _cfg(allocation_inv1_final_pct=0.5)
    p = _params_from_theta(glide, ["allocation_inv1_pct"],
                           torch.tensor([0.37], dtype=torch.float64))
    assert float(p.alloc1) == 0.37 and float(p.alloc1_final) == 0.5


@pytest.mark.parametrize("mean,vol", [(0.08, 0.15), (0.0, 0.0), (0.02, 0.0),
                                      (-0.5, 0.3)])
def test_log_params_ad_matches_host_conversion(mean, vol):
    mu_h, sigma_h = arithmetic_to_log_params(mean, vol)
    mu_d, sigma_d = _log_params_ad(torch.tensor(mean, dtype=torch.float64),
                                   torch.tensor(vol, dtype=torch.float64))
    assert float(mu_d) == pytest.approx(mu_h, abs=1e-12)
    assert float(sigma_d) == pytest.approx(sigma_h, abs=1e-12)


def test_log_params_ad_gradient_at_zero_vol():
    """d sigma / d vol -> 1/gross as vol -> 0, finite at 0 itself."""
    mean = torch.tensor(0.08, dtype=torch.float64)
    grad = torch.func.grad(lambda v: _log_params_ad(mean, v)[1])(
        torch.tensor(0.0, dtype=torch.float64))
    assert float(grad) == pytest.approx(1.0 / 1.08, rel=1e-6)


def test_fee_sensitivity_ad_matches_fd_and_is_negative():
    cfg = Config(**base_config_dict(
        retirement_years=6, initial_balance=300_000.0, monthly_expenses=1_500.0,
        inv1_returns_volatility=0.15, inv1_expense_ratio_annual=0.005,
        num_simulations_main=128))
    names = ["inv1_expense_ratio_annual"]
    ad = sensitivity_ad(cfg, 12, params=names, num_paths=256, device="cpu")
    rows = sensitivity_fd(cfg, 12, params=names, num_paths=256, device="cpu")
    g_ad = ad["d_mean_final"]["inv1_expense_ratio_annual"]
    assert np.isfinite(g_ad) and g_ad < 0.0
    assert rows[0].d_mean_final == pytest.approx(g_ad, rel=0.05)


# The extension cases of the JAX suite: each rule set on the base config,
# its dotted parameters refused by AD (FD-only), smooth parameters
# differentiated through its compiled-in branches (with the antithetic
# pairing on in the crash case). Guardrails switch a path's spending by
# whole steps where its withdrawal rate crosses a band: the finite
# difference counts those jumps, the a.e. derivative does not (about 8%
# apart here), so that case holds the signs only.
EXTENSION_CASES = {
    "crashes": (dict(market_crashes=dict(CRASHES), antithetic=True),
                "market_crashes.frequency_per_year", True),
    "guardrails": (dict(spending_guardrails={"upper_wr_pct": 6.0,
                                             "lower_wr_pct": 3.0}),
                   "spending_guardrails.upper_wr_pct", False),
    "longevity": (dict(current_age=62.0, longevity=dict(
        mode_age=68.0, dispersion_years=6.0, max_age=100.0)),
        "longevity.mode_age", True),
}


@pytest.mark.parametrize("case", list(EXTENSION_CASES))
def test_extension_statics_under_ad(case):
    over, dotted, smooth = EXTENSION_CASES[case]
    cfg = Config(**base_config_dict(
        retirement_years=8, initial_balance=260_000.0, monthly_expenses=2_300.0,
        inv1_returns_volatility=0.16, num_simulations_main=64, **over))
    with pytest.raises(ValueError, match="FD-only"):
        sensitivity_ad(cfg, 0, params=[dotted], num_paths=64, device="cpu")
    with pytest.raises(ValueError, match="unset"):
        sensitivity_ad(cfg, 0, params=["allocation_inv1_final_pct"],
                       num_paths=64, device="cpu")
    names = ["initial_balance", "monthly_expenses"]
    ad, fd = _ad_and_fd(cfg, 6, names, 512, rel_step=0.002)
    g = ad["d_mean_final"]
    assert np.isfinite(g["initial_balance"]) and g["initial_balance"] > 0.0
    assert g["monthly_expenses"] < 0.0
    for name in names:
        assert np.sign(g[name]) == np.sign(fd[name])
        if smooth:
            assert g[name] == pytest.approx(fd[name], rel=0.05), (case, name)


def test_ad_refuses_a_cuda_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sensitivity_ad(_cfg(), W, num_paths=8, params=["monthly_expenses"])


def _per_path_derivatives(cfg, names, w, n):
    """(n, P) d final_p / d theta of the port's AD paths."""
    statics = ck.statics_from_config(cfg)
    R = int(cfg.retirement_years)

    def finals(theta):
        p = _params_from_theta(cfg, names, theta)
        packed = ck.pack_params(p, _grid_stream_seed(SEED), [w], R,
                                dtype=torch.float64)
        return kernel.simulate(packed, statics, R, n)["final_balance"][0]

    dump = cfg.model_dump()
    theta0 = torch.tensor([float(dump[k]) for k in names], dtype=torch.float64)
    return torch.func.jacfwd(finals)(theta0).numpy()


def test_ad_agrees_with_the_jax_package_within_4_sigma():
    """The two packages draw different paths, so their mean derivatives
    agree within Monte Carlo error: 4 sigma of the difference of two
    independent means, each with the per-path derivatives' spread."""
    raw = _raw(retirement_years=4)
    names = ["monthly_expenses", "inv1_returns_mean", "initial_balance"]
    w, n = 24, N
    got = sensitivity_ad(Config(**raw), w, num_paths=n, seed=SEED,
                         params=names, device="cpu")
    want = jax_sens.sensitivity_ad(JaxConfig(**raw), w, num_paths=n,
                                   seed=SEED, params=names, dtype=jnp.float64)
    spread = _per_path_derivatives(Config(**raw), names, w, n).std(axis=0)
    for name, s in zip(names, spread):
        sigma = math.sqrt(2.0) * s / math.sqrt(n)
        diff = abs(got["d_mean_final"][name] - want["d_mean_final"][name])
        assert diff <= 4.0 * sigma, (name, diff, sigma)
    assert jax.config.jax_enable_x64
