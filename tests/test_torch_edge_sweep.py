"""The edge sweep (``hosts/edge_sweep.py``) on the CPU, against the JAX engine.

Each of the ten config.json edge scenarios runs through the port's
``Engine(device="cpu")`` in float64 and through the JAX engine on the CPU
(scan backend, float64) at 4096 paths, at the month of its kernel check
(the four oracle edges: ``tests/test_torch_oracle.py``). The two use
different random streams, so their success agrees within 4 sigma of the
pooled binomial error; the zero-volatility edge draws nothing that
matters, so there the success and the final-balance percentiles agree to
1e-9 relative. The sweep's own drive and checks, and the float32 fallback
of a kernel check whose every path is beyond the conditioning bound, run
here at a few paths.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine.runner import Engine as JaxEngine  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import edge_sweep, fuzz  # noqa: E402

torch.set_num_threads(2)
N_PATHS = 4096
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = {name: (cfg, w) for name, cfg, w in edge_sweep.edge_configs()}
DETERMINISTIC = ("zero-vol deterministic",)


def _jax_config(cfg) -> JaxConfig:
    dump = cfg.model_dump()
    dump.pop("allocation_inv2_pct", None)  # a derived property
    return JaxConfig(**dump)


def assert_edge_matches_jax(cfg, w, deterministic=False):
    """``cfg`` at ``w`` through both engines at N_PATHS paths."""
    port = Engine(cfg, device="cpu").run(w, N_PATHS)
    ref = JaxEngine(_jax_config(cfg)).run(w, N_PATHS, stream="final")
    a, b = port.success_probability, float(ref.success_probability)
    if deterministic:
        assert a == pytest.approx(b, rel=1e-9)
        np.testing.assert_allclose(port.final_balance_percentiles,
                                   np.asarray(ref.final_balance_percentiles),
                                   rtol=1e-9)
        return port
    p = (a + b) / 200.0
    sigma = 100.0 * math.sqrt(p * (1.0 - p) * 2.0 / N_PATHS)
    assert abs(a - b) <= 4.0 * sigma, (a, b, sigma)
    assert np.isfinite(port.final_balance_percentiles).all()
    return port


def test_the_sweep_has_the_scripts_edges():
    assert len(EDGES) == 14
    assert list(EDGES)[:10] == list(edge_sweep.EDGES)
    assert all(w == edge_sweep.CHECK_MONTHS for _, w in list(EDGES.values())[:10])


@pytest.mark.parametrize("name", list(edge_sweep.EDGES))
def test_edge_matches_the_jax_engine(name):
    cfg, w = EDGES[name]
    port = assert_edge_matches_jax(cfg, w, deterministic=name in DETERMINISTIC)
    if name in DETERMINISTIC:  # a month every path survives
        assert port.success_probability == 100.0
        assert port.final_balance_percentiles[4] > 0.0


@pytest.mark.parametrize("name", ["zero-vol deterministic", "rho=-1",
                                  "oracle: empty"])
def test_sweep_edge_drives_and_checks(name):
    out = edge_sweep.sweep_edge(EDGES[name][0], 64, "cpu")
    assert out["failed"] == [] and len(out["probes"]) == len(edge_sweep.SWEEP_MONTHS)
    assert out["run"].num_simulations == 64


def test_a_check_beyond_the_bound_falls_back_to_float32():
    cfg = fuzz.make_config(initial_balance=2e9, retirement_years=2)
    check = edge_sweep.check_edge(cfg, 3, 64, "cpu")
    assert check["ok"] and check["reference"].startswith("float32")
    assert check["skipped"] == 0
    small = fuzz.make_config(retirement_years=2)
    assert edge_sweep.check_edge(small, 3, 64, "cpu")["reference"] == "float64"


def test_income_that_covers_the_expenses_leaves_no_need():
    """The fault the edge sweep found on the card (ROADMAP C): with
    no balance and a pension that pays the expenses exactly, the need is
    exactly 0 (the JAX loop's rounded product minus the rounded income) and
    the path lives on; nvcc contracted the kernel's need into one fmaf,
    which keeps the product's round-off (up to half an ulp of expenses x
    price, far above the 1e-6 epsilon) and ruined every such path.

    Without a card this test can only show the arithmetic (numpy) and the
    float32 plain version, which was right before the repair, and pin the
    kernel source's rounded operations. The check that catches the fault
    coming back is ``chip_smoke.py`` phase 13a on the card: the kernels on
    this edge against their float64 plain versions."""
    cfg, _ = EDGES["zero balance, pension-funded"]
    assert Engine(cfg, device="cpu", dtype=torch.float32).probe([0, 7, 24], 256) == [
        100.0, 100.0, 100.0]
    expenses = np.float32(cfg.monthly_expenses)
    income = np.float32(cfg.other_income_streams[0].monthly_amount_today)
    rng = np.random.default_rng(7)
    price = np.cumprod(np.exp(rng.normal(0.005, 0.01, 600)).astype(np.float32),
                       dtype=np.float32)
    rounded = (expenses * price) - (income * price)  # float32, as JAX takes it
    fused = ((expenses.astype(np.float64) * price.astype(np.float64))
             - (income * price).astype(np.float64)).astype(np.float32)
    assert (rounded == 0.0).all()
    assert (fused > 1e-6).any()  # a contracted fmaf ruins these paths
    src = os.path.join(REPO, "monte_carlo_retirement_tpu_torch", "engine", "csrc",
                       "month_loop.cu")
    with open(src, encoding="utf-8") as fh:
        text = fh.read()
    # The month body is generic over float and double: the need and the
    # income go through r_sub_rn / r_mul_rn, whose overloads are the
    # rounded intrinsics (never contracted into a fused multiply-add).
    assert "r_sub_rn(need, net_income)" in text
    assert "r_mul_rn(nominal, sc.net[S])" in text
    for overload in (
            "float r_mul_rn(float a, float b) { return __fmul_rn(a, b); }",
            "double r_mul_rn(double a, double b) { return __dmul_rn(a, b); }",
            "float r_sub_rn(float a, float b) { return __fsub_rn(a, b); }",
            "double r_sub_rn(double a, double b) { return __dsub_rn(a, b); }"):
        assert overload in text, overload
