"""The port's float64 plain loop against the NumPy oracle, path by path.

``tests/oracle.py::simulate_path_oracle`` is the independent per-path
reference the JAX package's scan kernel is held to
(``tests/test_fuzz_parity.py:180-185``). Here the same random scenarios
(every extension in the mix) run through the port's tracked plain loop
(``cuda_kernel.simulate_full_plain``, float64, injected shocks in the
Pallas plane layout) and through the oracle on the same draws: the success
flag equal, the final balance within rel 1e-8 / abs 1e-6, and the start
balance and the price level at retirement likewise. Paths whose balances
cross the $1e9 conditioning bound of the reference's absolute-epsilon
funding predicates (``docs/PARITY.md:160-184``) are skipped and counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.kernel import shock_planes  # noqa: E402
from monte_carlo_retirement_tpu_torch.models.retirement import SimParams  # noqa: E402
from monte_carlo_retirement_tpu_torch.timing import expected_trajectory_length  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import edge_sweep  # noqa: E402
from tests.conftest import make_config  # noqa: E402
from tests.test_torch_edge_sweep import assert_edge_matches_jax  # noqa: E402
from tests.oracle import simulate_path_oracle  # noqa: E402
from tests.test_fuzz_parity import _random_config  # noqa: E402

torch.set_num_threads(2)

N_PATHS = 16
PREDICATE_SCALE_BOUND = 1e9  # scripts/fuzz_campaign.py:75


def _port_config(cfg) -> Config:
    dump = cfg.model_dump()
    dump.pop("allocation_inv2_pct", None)  # a derived property
    return Config(**dump)


def _differential(cfg, working_months, shock_seed):
    """Run one scenario through both; returns the number of paths skipped
    above the conditioning bound."""
    port_cfg = _port_config(cfg)
    R = port_cfg.retirement_years
    T = working_months + 12 * R
    statics = ck.statics_from_config(port_cfg)
    rng = np.random.default_rng(shock_seed)
    z = rng.standard_normal((T, shock_planes(statics), N_PATHS))
    if statics.jumps:
        z[:, 3] = rng.uniform(size=(T, N_PATHS))
    if statics.mortality:
        z[0, 5] = rng.uniform(1e-12, 1.0, size=N_PATHS)
    packed = ck.pack_params(SimParams.from_config(port_cfg), 0,
                            [working_months], R, dtype=torch.float64)
    L = expected_trajectory_length(working_months, R)
    out = ck.simulate_full_plain(packed, statics, R, N_PATHS, L,
                                 shocks=torch.from_numpy(z))
    out = {k: v.numpy() for k, v in out.items()}
    skipped = 0
    for p in range(N_PATHS):
        scale = max(float(out["trajectory"][p].max()),
                    float(out["start_balance"][p]))
        if scale > PREDICATE_SCALE_BOUND:
            skipped += 1
            continue
        want = simulate_path_oracle(
            cfg, working_months, z[:, :3, p],
            jump_shocks=z[:, 3:5, p] if statics.jumps else None,
            mort_u=float(z[0, 5, p]) if statics.mortality else None,
        )
        where = f"path {p} (W={working_months})"
        assert bool(out["success"][p] > 0.5) == want["success"], where
        assert out["final_balance"][p] == pytest.approx(
            want["final_balance"], rel=1e-8, abs=1e-6), where
        assert out["start_balance"][p] == pytest.approx(
            want["start_balance"], rel=1e-9, abs=1e-6), where
        assert out["inflation_at_retirement"][p] == pytest.approx(
            want["inflation_at_retirement"], rel=1e-12), where
    return skipped


@pytest.mark.parametrize("case", range(24))
def test_plain_loop_matches_oracle_on_random_scenarios(case):
    rng = np.random.default_rng(1000 + case)
    cfg = _random_config(rng)
    working_months = int(rng.integers(0, 40))
    skipped = _differential(cfg, working_months, 5000 + case)
    assert skipped < N_PATHS, "every path beyond the conditioning bound"


@pytest.mark.parametrize(
    "overrides,working_months",
    [
        (dict(allocation_inv1_pct=0.0), 7),     # single-asset (inv2 only)
        (dict(allocation_inv1_pct=1.0), 25),    # single-asset (inv1 only)
        (dict(initial_balance=0.0, monthly_contribution=0.0), 0),  # empty
        (dict(equity_inflation_correlation=-1.0,
              inflation_rate_mean=-0.005), 13),  # deflation + perfect anticorr
    ],
)
def test_plain_loop_matches_oracle_on_edge_scenarios(overrides, working_months):
    cfg = make_config(
        retirement_years=3, seed=4242, monthly_expenses=1_800.0,
        inv1_use_realized_gains_tax_system=True,
        inv1_realized_gains_tax_rate=0.15, inv2_annual_tax_on_gains_rate=0.2,
        inv2_use_realized_gains_tax_system=False, **overrides,
    )
    assert _differential(cfg, working_months, 77) == 0


@pytest.mark.parametrize("name", list(edge_sweep.ORACLE_EDGES))
def test_oracle_edges_match_the_jax_engine(name):
    """The four edges as hosts/edge_sweep.py runs them, through the port's
    float64 engine and the JAX engine at 4096 paths (within 4 sigma)."""
    cfg, w = {n: (c, w) for n, c, w in edge_sweep.edge_configs()}[name]
    assert_edge_matches_jax(cfg, w)
