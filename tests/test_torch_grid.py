"""The port's scenario grid vs the JAX package, on the CPU.

The grid's plain version runs K scenarios in one vectorised loop, each row
with its own parameters, all rows on the same shocks. Held to:
  * JAX ``pallas_simulate`` (``with_shocks=True, interpret=True``) on each
    row's own config and the same numpy normals — row k of the grid, since
    the grid shares its shocks — with the bounds of
    ``test_torch_kernel.py::test_probe_plain_matches_pallas_on_injected_shocks``
    (flag mismatch < 3e-3, dust-aware final balances);
  * the port's own probe on each row's block, bit for bit in float64;
  * JAX ``scenario_batch._grid_stats`` on the same numpy tables (success
    and sigma exact, percentiles equal ``np.percentile`` to 1e-9 relative);
  * JAX ``run_scenario_grid(backend="scan")`` within 4 sigma per row (the
    streams differ: Philox here, threefry there).
"""

import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import pallas_kernel as pk  # noqa: E402
from monte_carlo_retirement_tpu.engine import scenario_batch as jax_sb  # noqa: E402
from monte_carlo_retirement_tpu.models.retirement import (  # noqa: E402
    SimParams as JaxParams,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import scenario_batch as sb  # noqa: E402
from monte_carlo_retirement_tpu_torch.models.retirement import (  # noqa: E402
    SimParams,
    stack_params,
)
from tests.conftest import base_config_dict, binomial_sigma_pct  # noqa: E402
from tests.test_torch_kernel import (  # noqa: E402
    CASES,
    CRASHES,
    EXT_R,
    EXT_W,
    assert_probe_close,
    ext_config,
)

torch.set_num_threads(2)
N = pk.BLOCK_ROWS * 128

# Rows of one grid: (working-month offset, overrides) — expenses, equity
# mean, allocation, realized-gains rates and stream amounts differ by row.
ROWS = [
    (0, {}),
    (0, dict(monthly_expenses=2_900.0)),
    (5, dict(inv1_returns_mean=0.05, allocation_inv1_pct=0.8,
             stream_scale=1.6)),
    (2, dict(inv1_realized_gains_tax_rate=0.3, allocation_inv1_pct=0.35,
             inv2_realized_gains_tax_rate=0.25, monthly_expenses=1_900.0)),
]


def _raw(R, use1, use2, ns, seed=0, stream_scale=1.0, **overrides):
    streams = [
        {"name": "Pension", "monthly_amount_today": 900.0 * stream_scale,
         "start_at_age": 41.0, "duration_years": None,
         "inflation_indexed": True, "tax_rate": 0.2},
        {"name": "Annuity", "monthly_amount_today": 400.0 * stream_scale,
         "start_at_age": 40.5, "duration_years": None,
         "inflation_indexed": True, "tax_rate": 0.1},
    ][:ns]
    raw = base_config_dict(
        retirement_years=R,
        seed=seed,
        initial_balance=120_000.0,
        monthly_contribution=1_500.0,
        contribution_growth_rate_annual=0.03,
        monthly_expenses=2_200.0,
        inv1_returns_volatility=0.17,
        inv1_use_realized_gains_tax_system=use1,
        inv1_realized_gains_tax_rate=0.15,
        inv2_use_realized_gains_tax_system=use2,
        inv2_realized_gains_tax_rate=0.1,
        equity_inflation_correlation=0.2,
        other_income_streams=streams,
    )
    raw.update(overrides)
    return raw


def _grid_rows(W, R, use1, use2, ns):
    months = [W + dw for dw, _ in ROWS]
    raws = [_raw(R, use1, use2, ns, **over) for _, over in ROWS]
    return months, raws


@pytest.mark.parametrize("W,R,use1,use2,ns", CASES)
def test_grid_plain_matches_pallas_per_row_on_injected_shocks(W, R, use1, use2, ns):
    months, raws = _grid_rows(W, R, use1, use2, ns)
    T = max(months) + 12 * R
    z = np.random.default_rng(W * 10 + R + 7).standard_normal(
        (T, 3, N)).astype(np.float32)
    configs = [Config(**raw) for raw in raws]
    statics = sb.grid_statics(configs)
    # Month m reads row m - 1; one (T, 3, rows, 128) array serves every row.
    z_jax = jnp.asarray(z.reshape(T, 3, pk.BLOCK_ROWS, 128))
    ref = []
    for raw, w in zip(raws, months):
        jcfg = JaxConfig(**raw)
        jparams = JaxParams.from_config(jcfg, dtype=jnp.float32)
        succ_j, final_j = pk.pallas_simulate(
            jparams, w, 0, n_paths=N, retirement_years=R,
            n_streams=jparams.n_streams, statics=pk.statics_from_config(jcfg),
            shocks=z_jax, with_shocks=True, interpret=True,
        )
        ref.append((np.asarray(succ_j) > 0.5, np.asarray(final_j)))
    shocks = torch.from_numpy(z)
    for dtype in (torch.float32, torch.float64):
        packed = ck.pack_grid(stack_params(configs), 0, months, R, dtype=dtype)
        assert packed.fp.shape == (len(ROWS), ck.F.NUM + 5 * ns)
        out = ck.grid_plain(packed, statics, R, N, shocks=shocks)
        assert out.success.shape == (len(ROWS), N)
        for k, (succ_j, final_j) in enumerate(ref):
            succ_p = out.success[k].numpy() > 0.5
            assert int(out.counts[k]) == int(succ_p.sum())
            mismatch = float((succ_p != succ_j).mean())
            assert mismatch < 3e-3, f"{dtype} row {k}: mismatch {mismatch:.4f}"
            diff = np.abs(out.final_balance[k].numpy() - final_j)
            rel = diff / np.maximum(np.abs(final_j), 1.0)
            bad = (rel > 5e-3) & (diff > 5.0)
            assert float(bad.mean()) <= 1e-3, f"{dtype} row {k}: {bad.sum()} diverge"
        # Kernel 3's counterpart is the one-row grid: row 0 exactly.
        one = ck.pack_params(SimParams.from_config(configs[0]), 0, [months[0]], R,
                             dtype=dtype)
        sim = ck.simulate_plain(one, statics, R, N, shocks=shocks)
        assert torch.equal(sim.success, out.success[0])
        assert torch.equal(sim.final_balance, out.final_balance[0])


def test_grid_row_equals_probe_on_its_own_block():
    """Row k of the grid (Philox stream, float64) is the probe of row k's
    own parameters, bit for bit: rows never enter the key."""
    months, raws = _grid_rows(13, 4, True, True, 1)
    configs = [Config(**raw) for raw in raws]
    statics = sb.grid_statics(configs)
    n = 4096 + 1000  # a partial second Philox block
    out = ck.grid_plain(
        ck.pack_grid(stack_params(configs), 99, months, 4, block_offset=3,
                     dtype=torch.float64),
        statics, 4, n,
    )
    assert int(out.counts.min()) < n  # some row has ruined paths
    for k, (cfg, w) in enumerate(zip(configs, months)):
        one = ck.probe_plain(
            ck.pack_params(SimParams.from_config(cfg), 99, [w], 4,
                           block_offset=3, dtype=torch.float64),
            statics, 4, n,
        )
        assert torch.equal(out.success[k], one.success[0])
        assert torch.equal(out.final_balance[k], one.final_balance[0])
        assert int(out.counts[k]) == int(one.counts[0])


def test_pack_grid_equals_pallas_grid_packing():
    months, raws = _grid_rows(24, 5, True, False, 2)
    jbatch = jax_sb.stack_params([JaxConfig(**r) for r in raws], dtype=jnp.float32)
    ip, fp = pk._pack_params(jbatch, 4321, jnp.asarray(months), 5, block_offset=2)
    streams = []
    pk._stream_inputs(jbatch, [], streams)
    batch = stack_params([Config(**r) for r in raws])
    packed = ck.pack_grid(batch, 4321, months, 5, block_offset=2)
    np.testing.assert_array_equal(packed.ip.numpy(), np.asarray(ip))
    np.testing.assert_allclose(packed.fp[:, : ck.F.NUM].numpy(),
                               np.asarray(fp).T, rtol=1.2e-7, atol=0)
    S = 2
    for i, want in enumerate(streams):
        got = packed.fp[:, ck.F.NUM + i * S: ck.F.NUM + (i + 1) * S]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The JAX stacked leaves convert into the port's stacked form.
    converted = SimParams.from_jax(jax_sb.stack_params(
        [JaxConfig(**r) for r in raws], dtype=jnp.float64))
    for name in SimParams.field_names():
        a, b = getattr(converted, name), getattr(batch, name)
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert batch.n_streams == 2 and batch.initial_balance.shape == (len(raws),)


def test_grid_stats_match_jax_and_numpy():
    rng = np.random.default_rng(3)
    K, n = 4, 3001
    success = (rng.uniform(size=(K, n)) < [[0.2], [0.5], [0.97], [1.0]]).astype(
        np.float64)
    final = rng.lognormal(12.0, 1.5, size=(K, n)) * success  # ruined paths at 0
    final[1, :7] = -3.5  # a kernel's negative dust must stay in the bands
    ref = [np.asarray(a) for a in jax_sb._grid_stats(
        jnp.asarray(success), jnp.asarray(final), n)]
    got = [t.numpy() for t in sb._grid_stats(
        torch.from_numpy(success), torch.from_numpy(final), n)]
    np.testing.assert_array_equal(got[0], ref[0])  # success %
    np.testing.assert_array_equal(got[3], ref[3])  # sigma
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-12)  # mean
    want = np.percentile(final, np.asarray(sb.GRID_FINAL_PERCENTILES) * 100,
                         axis=1).T
    np.testing.assert_allclose(got[4], want, rtol=1e-9)
    np.testing.assert_allclose(ref[4], want, rtol=1e-9)
    np.testing.assert_allclose(got[1], want[:, 2], rtol=1e-9)
    assert sb.GRID_FINAL_PERCENTILES == jax_sb.GRID_FINAL_PERCENTILES
    assert sb._grid_stream_seed(17) == jax_sb._grid_stream_seed(17)


def _grid_configs(R=3, n_rows=5):
    return [
        Config(**_raw(R, True, True, 1, seed=5, monthly_expenses=e))
        for e in np.linspace(1_600.0, 3_400.0, n_rows)
    ]


def _run(monkeypatch, configs, months, n, chunk, window=2, budget=None):
    monkeypatch.setenv("MCRT_GRID_WINDOW", str(window))
    if budget is None:
        monkeypatch.delenv("MCRT_GRID_CELL_BUDGET", raising=False)
    else:
        monkeypatch.setenv("MCRT_GRID_CELL_BUDGET", str(budget))
    events = []
    out = sb.run_scenario_grid(configs, months, n, seed=2, chunk_size=chunk,
                               device="cpu", progress_callback=events.append)
    return out, [e["done"] for e in events], events


@pytest.mark.parametrize(
    "chunk,window,budget,done",
    [
        (1, 0, None, [1, 2, 3, 4, 5]),
        (3, 2, None, [3, 5]),
        (3, 0, None, [3, 5]),
        (16, 0, None, [5]),
        (16, 2, 2 * 700, [2, 4, 5]),  # the cell budget shrinks the chunks
        (16, 2, 1, [1, 2, 3, 4, 5]),  # below one row: single rows
    ],
)
def test_run_scenario_grid_chunking_is_exact(monkeypatch, chunk, window, budget,
                                             done):
    configs = _grid_configs()
    months = [12, 12, 18, 18, 24]
    n = 700
    whole, done_whole, _ = _run(monkeypatch, configs, months, n, 16)
    assert done_whole == [5]
    got, done_got, events = _run(monkeypatch, configs, months, n, chunk, window,
                                 budget)
    assert done_got == done
    assert all(e["type"] == "grid_chunk" and e["total"] == 5 for e in events)
    for a, b in zip(whole, got):
        np.testing.assert_array_equal(a, b)
    # More expenses never raise success under shared shocks (same months).
    p = whole.success_probability
    assert p[0] >= p[1] and p[2] >= p[3]
    assert whole.final_balance_percentiles.shape == (5, 5)


def test_run_scenario_grid_matches_jax_scan_within_4_sigma():
    raws = [_raw(5, True, True, 1, seed=8, monthly_expenses=e)
            for e in (1_700.0, 2_400.0, 3_100.0)]
    months = [6, 6, 12]
    n = 4096
    port = sb.run_scenario_grid([Config(**r) for r in raws], months, n, seed=8,
                                device="cpu")
    ref = jax_sb.run_scenario_grid([JaxConfig(**r) for r in raws], months, n,
                                   seed=8, backend="scan")
    for k in range(len(raws)):
        a, b = float(port.success_probability[k]), float(ref.success_probability[k])
        sigma = math.hypot(binomial_sigma_pct(a, n), binomial_sigma_pct(b, n))
        assert abs(a - b) <= max(4.0 * sigma, 0.3), (k, a, b)
        frac = a / 100.0
        assert float(port.success_sigma[k]) == pytest.approx(
            math.sqrt(frac * (1.0 - frac) / n) * 100.0, rel=1e-12)
    assert 5.0 < float(port.success_probability[-1]) < 99.0  # discriminating


def test_grid_guards_mirror_jax():
    realized = Config(**base_config_dict(
        inv1_use_realized_gains_tax_system=True,
        inv1_realized_gains_tax_rate=0.1, retirement_years=2))
    untaxed = Config(**base_config_dict(retirement_years=2))
    with pytest.raises(ValueError, match="Statics"):
        sb.grid_statics([realized, untaxed])
    with pytest.raises(ValueError, match="Statics"):
        sb.run_scenario_grid([realized, untaxed], [12, 12], 64, device="cpu")
    # A row that disagrees with the Statics the launch was built for.
    batch = stack_params([realized, untaxed])
    with pytest.raises(ValueError, match="Statics"):
        ck.check_grid_statics(batch, ck.statics_from_config(realized))

    def with_stream(indexed, amount=500.0):
        return Config(**base_config_dict(retirement_years=2, other_income_streams=[
            {"name": "P", "monthly_amount_today": amount, "start_at_age": 60.0,
             "duration_years": None, "inflation_indexed": indexed,
             "tax_rate": 0.0}]))

    indexed, nominal = with_stream(True), with_stream(False)
    with pytest.raises(ValueError, match="stream structure"):
        ck.check_grid_statics(stack_params([indexed, nominal]),
                              ck.statics_from_config(indexed))
    with pytest.raises(ValueError, match="Statics"):
        sb.run_scenario_grid([indexed, nominal], [0, 0], 64, device="cpu")
    with pytest.raises(ValueError, match="retirement_years"):
        stack_params([untaxed, Config(**base_config_dict(retirement_years=3))])
    with pytest.raises(ValueError, match="retirement_years"):
        sb.run_scenario_grid(
            [untaxed, Config(**base_config_dict(retirement_years=3))], [0, 0], 64,
            device="cpu")
    with pytest.raises(ValueError, match="effective income"):
        stack_params([indexed, with_stream(True, amount=0.0)])
    with pytest.raises(ValueError, match="at least one"):
        stack_params([])
    with pytest.raises(ValueError, match="months rows"):
        ck.pack_grid(stack_params([untaxed, untaxed]), 0, [12], 2)
    with pytest.raises(ValueError, match="align"):
        sb.run_scenario_grid([untaxed], [1, 2], 16, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        sb.run_scenario_grid([untaxed], [-1], 16, device="cpu")


# Per extension, how row 1 of the grid varies the extension's own
# parameter (rows 2 and 3 vary months, means, allocation and tax rates).
EXT_ROW_VARIATION = {
    "bills": dict(inv1_annual_tax_on_gains_rate=0.35),
    "fixed": dict(monthly_expenses=3_600.0),
    "antithetic": dict(monthly_expenses=3_600.0),
    "glide": dict(allocation_inv1_final_pct=0.8),
    "guardrails": dict(spending_guardrails={"upper_wr_pct": 9.0,
                                            "lower_wr_pct": 4.0}),
    "jumps": dict(market_crashes={**CRASHES, "frequency_per_year": 3.0}),
    "mortality": dict(longevity={"mode_age": 47.0, "dispersion_years": 6.0,
                                 "max_age": 95.0}),
}


@pytest.mark.parametrize("name", list(EXT_ROW_VARIATION))
def test_grid_extension_plain_matches_pallas_per_row(name):
    """The grid's plain loop under each extension's Statics, one row per
    scenario with its own months and parameters, vs JAX pallas_simulate on
    each row's own config and the same six planes of numpy draws."""
    W, R = EXT_W, EXT_R
    rows = [(0, {}), (4, EXT_ROW_VARIATION[name]),
            (9, dict(inv1_returns_mean=0.05, allocation_inv1_pct=0.8)),
            (2, dict(inv1_realized_gains_tax_rate=0.3,
                     inv2_realized_gains_tax_rate=0.25,
                     monthly_expenses=2_700.0))]
    months = [W + dw for dw, _ in rows]
    cfgs = [ext_config(name, seed=5, **over) for _, over in rows]
    configs = [Config(**c.model_dump(by_alias=True)) for c in cfgs]
    statics = sb.grid_statics(configs)
    T = max(months) + 12 * R
    z = np.random.default_rng(len(name) + 40).standard_normal(
        (T, 6, N)).astype(np.float32)
    z[:, 3] = np.random.default_rng(1).uniform(size=(T, N))
    z[:, 5] = np.random.default_rng(2).uniform(size=(T, N))
    z_jax = jnp.asarray(z.reshape(T, 6, pk.BLOCK_ROWS, 128))
    ref = []
    for cfg, w in zip(cfgs, months):
        jparams = JaxParams.from_config(cfg, dtype=jnp.float32)
        succ_j, final_j = pk.pallas_simulate(
            jparams, w, 0, n_paths=N, retirement_years=R,
            n_streams=jparams.n_streams, statics=pk.statics_from_config(cfg),
            shocks=z_jax, with_shocks=True, interpret=True,
        )
        ref.append((np.asarray(succ_j) > 0.5, np.asarray(final_j)))
    assert len({round(float(s.mean()), 3) for s, _ in ref}) > 1  # rows differ
    shocks = torch.from_numpy(z)
    for dtype in (torch.float32, torch.float64):
        packed = ck.pack_grid(stack_params(configs), 0, months, R, dtype=dtype)
        out = ck.grid_plain(packed, statics, R, N, shocks=shocks)
        for k, (succ_j, final_j) in enumerate(ref):
            succ_p = out.success[k].numpy() > 0.5
            assert int(out.counts[k]) == int(succ_p.sum())
            assert_probe_close(succ_p, out.final_balance[k].numpy(), succ_j,
                               final_j, f"{name} {dtype} row {k}")
        # Row 0 alone through simulate (kernel 3's counterpart), exactly.
        one = ck.pack_params(SimParams.from_config(configs[0]), 0, [months[0]],
                             R, dtype=dtype)
        sim = ck.simulate_plain(one, statics, R, N, shocks=shocks)
        assert torch.equal(sim.success, out.success[0])
        assert torch.equal(sim.final_balance, out.final_balance[0])


def test_grid_wrappers_on_a_cuda_tensor_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the wrappers would launch")
    cfg = Config(**_raw(4, True, True, 1))
    statics = ck.statics_from_config(cfg)
    rows = ck.pack_grid(stack_params([cfg, cfg]), 1, [0, 3], 4)
    one = ck.pack_params(SimParams.from_config(cfg), 1, [0], 4)
    # Blocks whose tensors claim the card: raise, never the plain version.
    on_card = lambda p: types.SimpleNamespace(  # noqa: E731
        fp=p.fp, ip=p.ip, n_streams=p.n_streams, device=torch.device("cuda"))
    before = dict(ck.PLAIN_CALLS)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ck.grid(on_card(rows), statics, 4, 64)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ck.simulate(on_card(one), statics, 4, 64)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sb.run_scenario_grid([cfg], [0], 64, device="cuda")
    assert ck.PLAIN_CALLS == before
    # The grid takes per-row blocks only, the probe shared blocks only.
    with pytest.raises(ValueError, match="pack_grid"):
        ck.grid(one, statics, 4, 64)
    with pytest.raises(ValueError, match="pack_params"):
        ck.probe(rows, statics, 4, 64)
    with pytest.raises(ValueError, match="one working_months"):
        ck.simulate(rows, statics, 4, 64)
    ck.reset_counts()
    ck.simulate(one, statics, 4, 64)
    ck.grid(rows, statics, 4, 64)
    assert ck.PLAIN_CALLS == {"probe": 0, "grid": 1, "simulate": 1, "full": 0,
                              "scan": 0, "ad": 0}
    assert not any(ck.LAUNCHES.values())
