"""The month loop's extensions in the port, against the JAX package.

The extensions are the compile-time Statics beyond the tax system: annual
mark-to-market bills, fixed-nominal and duration-capped income streams,
antithetic pairing, glide path, spending guardrails, market crashes and
longevity. Held here:
  * a randomised differential over Statics combinations (every flag in the
    mix, several candidate months in one probe, so the merged loop and each
    row's own W are covered) against JAX ``pallas_simulate`` on injected
    shocks, with the JAX suite's bounds (test_pallas_parity.py:230-323);
  * rule-off bit-identity: a flag that is off reads none of its parameters,
    and a flag that is on with a sentinel rule (no crash, no lifespan
    rule) draws the same base stream and gives the same bits;
  * antithetic pairing at block granularity: even blocks equal an iid
    run's blocks, odd blocks draw the negated normals and reflected
    uniforms (as tests/test_antithetic.py holds Pallas);
  * the crash and longevity draws stable under chunking by block offset;
  * the port's CPU engine against the JAX scan engine within 4 sigma on a
    config with every extension on.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine.pallas_kernel import (  # noqa: E402
    BLOCK_ROWS,
    pallas_simulate,
    statics_from_config as jax_statics,
)
from monte_carlo_retirement_tpu.engine.runner import Engine as JaxEngine  # noqa: E402
from monte_carlo_retirement_tpu.models.retirement import (  # noqa: E402
    SimParams as JaxParams,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.models.retirement import SimParams  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import shocks  # noqa: E402
from tests.conftest import binomial_sigma_pct, make_config  # noqa: E402
from tests.test_torch_kernel import assert_probe_close  # noqa: E402

torch.set_num_threads(2)
N = BLOCK_ROWS * 128
B = shocks.BLOCK_PATHS
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = ck.F


def _random_config(rng, all_on):
    """One scenario with a random Statics combination (every flag on when
    ``all_on``); rules sized so they bind within a few years."""
    on = lambda: all_on or rng.random() < 0.5  # noqa: E731
    streams = []
    for s in range(2 if all_on else int(rng.integers(0, 3))):
        streams.append({
            "name": f"s{s}",
            "monthly_amount_today": float(rng.uniform(300, 1500)),
            "start_at_age": float(rng.uniform(44, 50)),
            # all_on: one capped fixed-nominal and one uncapped indexed
            "duration_years": (int(rng.integers(1, 4)) if (s == 0 if all_on
                               else rng.random() < 0.5) else None),
            "inflation_indexed": bool(s == 1 if all_on else rng.random() < 0.5),
            "tax_rate": float(rng.uniform(0, 0.4)),
        })
    use1, use2 = (False, False) if all_on else (not on(), not on())
    return make_config(
        retirement_years=int(rng.integers(2, 5)),
        seed=int(rng.integers(0, 10_000)),
        current_age=45.0,
        initial_balance=float(rng.uniform(60_000, 250_000)),
        monthly_contribution=float(rng.uniform(0, 3_000)),
        monthly_expenses=float(rng.uniform(2_500, 5_000)),
        inv1_returns_volatility=float(rng.uniform(0.05, 0.25)),
        inv1_use_realized_gains_tax_system=use1,
        inv1_realized_gains_tax_rate=float(rng.uniform(0, 0.3)),
        inv1_annual_tax_on_gains_rate=float(rng.uniform(0.05, 0.3)),
        inv2_use_realized_gains_tax_system=use2,
        inv2_realized_gains_tax_rate=float(rng.uniform(0, 0.3)),
        inv2_annual_tax_on_gains_rate=float(rng.uniform(0.05, 0.3)),
        inflation_rate_volatility=float(rng.uniform(0, 0.03)),
        equity_inflation_correlation=float(rng.uniform(-0.9, 0.9)),
        other_income_streams=streams,
        antithetic=on(),
        allocation_inv1_final_pct=float(rng.uniform(0, 1)) if on() else None,
        spending_guardrails=({"upper_wr_pct": float(rng.uniform(5, 9)),
                              "lower_wr_pct": float(rng.uniform(2, 4))}
                             if on() else None),
        market_crashes=({"frequency_per_year": float(rng.uniform(0.5, 3.0)),
                         "mean_drop_pct": float(rng.uniform(10, 40)),
                         "size_volatility": float(rng.uniform(0, 0.4)),
                         "inv2_beta": float(rng.uniform(0, 1))}
                        if on() else None),
        longevity=({"mode_age": float(rng.uniform(47, 55)),
                    "dispersion_years": float(rng.uniform(3, 8)),
                    "max_age": 95.0} if on() else None),
    )


def _planes(rng, T):
    z = rng.standard_normal((T, 6, N)).astype(np.float32)
    z[:, 3] = rng.uniform(size=(T, N))
    z[:, 5] = rng.uniform(size=(T, N))
    return z


def test_random_statics_combinations_match_pallas():
    rng = np.random.default_rng(77)
    seen = set()
    for case in range(4):
        cfg = _random_config(rng, all_on=case == 0)
        statics = ck.statics_from_config(Config(**cfg.model_dump(by_alias=True)))
        assert tuple(statics) == tuple(jax_statics(cfg))
        seen |= {f for f in statics._fields[6:] if getattr(statics, f)}
        seen |= {"bills"} if statics.bill1 or statics.bill2 else set()
        seen |= {"fixed"} if not all(statics.stream_indexed) else set()
        seen |= {"capped"} if any(statics.stream_capped) else set()
        R = cfg.retirement_years
        months = sorted(int(m) for m in rng.choice(31, size=3, replace=False))
        T = max(months) + 12 * R
        z = _planes(rng, T)
        z_jax = jnp.asarray(z.reshape(T, 6, BLOCK_ROWS, 128))
        jparams = JaxParams.from_config(cfg, dtype=jnp.float32)
        ref = [
            pallas_simulate(
                jparams, w, 0, n_paths=N, retirement_years=R,
                n_streams=jparams.n_streams, statics=jax_statics(cfg),
                shocks=z_jax, with_shocks=True, interpret=True,
            )
            for w in months
        ]
        params = SimParams.from_config(Config(**cfg.model_dump(by_alias=True)))
        for dtype in (torch.float32, torch.float64):
            packed = ck.pack_params(params, 0, months, R, dtype=dtype)
            out = ck.probe_plain(packed, statics, R, N, shocks=torch.from_numpy(z))
            for k, (succ_j, final_j) in enumerate(ref):
                succ_p = out.success[k].numpy() > 0.5
                assert int(out.counts[k]) == int(succ_p.sum())
                assert_probe_close(succ_p, out.final_balance[k].numpy(),
                                   np.asarray(succ_j) > 0.5, np.asarray(final_j),
                                   f"case {case} W={months[k]} {dtype}")
    assert seen >= {"bills", "fixed", "capped", "antithetic", "glide",
                    "guardrails", "jumps", "mortality"}, seen


SIX_STREAMS = [
    {"name": f"s{s}", "monthly_amount_today": 250.0 + 150.0 * s,
     "start_at_age": 43.0 + 0.5 * s, "duration_years": (1 + s % 3) if s % 2 else None,
     "inflation_indexed": s % 3 != 1, "tax_rate": 0.05 * s}
    for s in range(6)
]


def test_six_streams_of_every_kind_match_pallas():
    """More streams than the first slice's cap of 4, every kind among them
    (CPI-indexed or fixed-nominal, capped or not), in the probe (two
    candidates) and the tracked loop, against JAX Pallas on injected
    shocks."""
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_simulate_full,
    )
    from monte_carlo_retirement_tpu_torch.timing import (
        expected_trajectory_length,
    )
    from tests.test_torch_kernel import assert_full_close

    cfg = make_config(
        retirement_years=3, seed=8, current_age=45.0, initial_balance=90_000.0,
        monthly_contribution=800.0, monthly_expenses=4_600.0,
        inv1_returns_volatility=0.2, other_income_streams=SIX_STREAMS)
    statics = ck.statics_from_config(Config(**cfg.model_dump(by_alias=True)))
    assert len(statics.stream_indexed) == 6
    assert set(zip(statics.stream_indexed, statics.stream_capped)) == {
        (True, False), (False, False), (True, True), (False, True)}
    months, R = [5, 14], 3
    T = max(months) + 12 * R
    z = _planes(np.random.default_rng(6), T)
    kw = dict(n_paths=N, retirement_years=R, n_streams=6,
              statics=jax_statics(cfg), shocks=jnp.asarray(
                  z.reshape(T, 6, BLOCK_ROWS, 128)), with_shocks=True,
              interpret=True)
    jparams = JaxParams.from_config(cfg, dtype=jnp.float32)
    ref = [pallas_simulate(jparams, w, 0, **kw) for w in months]
    L = expected_trajectory_length(months[1], R)
    ref_full = {k: np.asarray(v) for k, v in pallas_simulate_full(
        jparams, months[1], 0, traj_len=L, **kw).items()}
    assert 0.05 < float(np.asarray(ref[1][0]).mean()) < 0.995
    params = SimParams.from_config(Config(**cfg.model_dump(by_alias=True)))
    for dtype in (torch.float32, torch.float64):
        packed = ck.pack_params(params, 0, months, R, dtype=dtype)
        out = ck.probe_plain(packed, statics, R, N, shocks=torch.from_numpy(z))
        for k, (succ_j, final_j) in enumerate(ref):
            assert_probe_close(out.success[k].numpy() > 0.5,
                               out.final_balance[k].numpy(),
                               np.asarray(succ_j) > 0.5, np.asarray(final_j),
                               f"W={months[k]} {dtype}")
        one = ck.pack_params(params, 0, [months[1]], R, dtype=dtype)
        full = ck.simulate_full_plain(one, statics, R, N, L,
                                      shocks=torch.from_numpy(z))
        assert_full_close({k: v.numpy() for k, v in full.items()}, ref_full,
                          R, L, str(dtype))


def _base():
    """config-like scenario with every extension off: realized-gains tax
    on both assets, one CPI-indexed uncapped stream."""
    return Config(**make_config(
        retirement_years=3, seed=11, initial_balance=150_000.0,
        monthly_contribution=1_000.0, monthly_expenses=5_500.0,
        inv1_returns_volatility=0.18,
        inv1_use_realized_gains_tax_system=True,
        inv1_realized_gains_tax_rate=0.15,
        inv2_use_realized_gains_tax_system=True,
        inv2_realized_gains_tax_rate=0.1,
        other_income_streams=[{
            "name": "P", "monthly_amount_today": 800.0, "start_at_age": 41.0,
            "duration_years": None, "inflation_indexed": True,
            "tax_rate": 0.2}],
    ).model_dump(by_alias=True))


def _run_both(packed, statics, n=3_000):
    probe = ck.probe_plain(packed, statics, 3, n)
    one = ck.Packed(fp=packed.fp, ip=packed.ip[1:2], n_streams=packed.n_streams)
    full = ck.simulate_full_plain(one, statics, 3, n, 8)
    return [probe.success, probe.final_balance] + [full[k] for k in sorted(full)]


def _assert_bits_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(torch.nan_to_num(x, nan=-7.0),
                           torch.nan_to_num(y, nan=-7.0))


def test_rules_that_are_off_leave_the_bits_unchanged():
    cfg = _base()
    statics = ck.statics_from_config(cfg)
    assert not any(statics[6:]) and not statics.bill1 and not statics.bill2
    packed = ck.pack_params(SimParams.from_config(cfg), 123, [0, 7, 13], 3,
                            dtype=torch.float64)
    base = _run_both(packed, statics)
    assert 0 < int((base[0] < 0.5).sum())  # some paths are ruined
    # Poison every parameter a disabled feature would read.
    fp = packed.fp.clone()
    poison = {F.R_ANN1: 0.9, F.R_ANN2: 0.9, F.ALLOC1_F: 0.0, F.GR_UP: 1e-4,
              F.GR_LO: 10.0, F.GR_ADJ: 0.5, F.GR_FLOOR: 0.1, F.GR_CAP: 3.0,
              F.JP: 1.0, F.JMU: -2.0, F.JSIG: 1.0, F.JBETA: 1.0, F.JC1: 0.5,
              F.JC2: 0.5, F.MORT_G0: 0.1, F.MORT_B12: 1.0, F.MORT_CAP: 1.0,
              F.NUM + 2: 1.0}  # the uncapped stream's duration: one month
    for i, v in poison.items():
        fp[i] = v
    poisoned = ck.Packed(fp=fp, ip=packed.ip, n_streams=packed.n_streams)
    _assert_bits_equal(_run_both(poisoned, statics), base)
    # Crashes and longevity on, with sentinel rules (no crash ever, b12 = 0:
    # no lifespan rule): the base normals are the same words, so the bits
    # are too.
    sentinel = statics._replace(jumps=True, mortality=True)
    _assert_bits_equal(_run_both(packed, sentinel), base)


def test_antithetic_blocks_pair_and_even_blocks_match_iid():
    cfg = Config(**make_config(
        retirement_years=2, seed=303, initial_balance=400_000.0,
        monthly_contribution=2_000.0, monthly_expenses=3_000.0,
        inv1_returns_volatility=0.16, inflation_rate_volatility=0.012,
        equity_inflation_correlation=0.3,
        market_crashes={"frequency_per_year": 2.0, "mean_drop_pct": 25.0,
                        "size_volatility": 0.3, "inv2_beta": 0.5},
        longevity={"mode_age": 41.0, "dispersion_years": 4.0, "max_age": 90.0},
    ).model_dump(by_alias=True))
    iid = ck.statics_from_config(cfg)
    anti = iid._replace(antithetic=True)
    params = SimParams.from_config(cfg)
    packed = ck.pack_params(params, 99, [6], 2, dtype=torch.float64)
    a = ck.probe_plain(packed, anti, 2, 4 * B)
    i = ck.probe_plain(packed, iid, 2, 2 * B)
    fa, fi = a.final_balance[0], i.final_balance[0]
    assert torch.equal(fa[:B], fi[:B]) and torch.equal(fa[2 * B:3 * B], fi[B:])
    assert torch.equal(a.success[0][2 * B:3 * B], i.success[0][B:])
    assert not torch.equal(fa[B:2 * B], fa[:B])  # odd blocks are twins, not copies
    # The odd block's draws: every normal negated, every uniform reflected.
    gblock, lane = shocks.path_keys(4 * B, 0, "cpu")
    key, sign = shocks.pair_blocks(gblock)
    assert torch.equal(key, gblock // 2)
    d = shocks.month_draws(99, key, 5, lane, jumps=True, sign=sign)
    even, odd = d[:, :B], d[:, B:2 * B]
    for p in (0, 1, 2, 4):
        assert torch.equal(odd[p], -even[p])
    assert torch.equal(odd[3], 1.0 - even[3])
    u = shocks.mortality_uniform(99, key, lane, sign=sign)
    assert torch.equal(u[B:2 * B], 1.0 - u[:B])
    # Marginally the pair is still uniform / normal: means near 1/2 and 0.
    assert abs(float(d[3].double().mean()) - 0.5) < 1e-3
    assert abs(float(d[0].double().mean())) < 1e-6


def test_crash_and_longevity_draws_are_chunk_stable():
    gblock, lane = shocks.path_keys(3 * B + 100, 0, "cpu")
    g2, l2 = shocks.path_keys(2 * B + 100, 1, "cpu")  # a chunk from block 1
    for month in (1, 37, 600):
        whole = shocks.month_draws(2026, gblock, month, lane, jumps=True)
        part = shocks.month_draws(2026, g2, month, l2, jumps=True)
        assert torch.equal(whole[:, B:], part)
        # The base normals do not move when the crash draws are on.
        assert torch.equal(whole[:3], shocks.month_normals(2026, gblock, month, lane))
    assert torch.equal(shocks.mortality_uniform(2026, gblock, lane)[B:],
                       shocks.mortality_uniform(2026, g2, l2))
    # Antithetic pairing keys on global blocks, so a chunk starting at an
    # odd block draws its pair's reflections exactly.
    k_all, s_all = shocks.pair_blocks(gblock)
    k_part, s_part = shocks.pair_blocks(g2)
    assert torch.equal(shocks.month_draws(5, k_all, 3, lane, True, s_all)[:, B:],
                       shocks.month_draws(5, k_part, 3, l2, True, s_part))


def _all_on_raw(**overrides):
    """config.json with every extension on (the full-width config of the
    chip run), shortened to 10 retirement years."""
    with open(os.path.join(REPO, "config.json"), encoding="utf-8") as fh:
        raw = json.load(fh)
    raw.update(seed=2026, retirement_years=10,
               inv1_use_realized_gains_tax_system=False,
               inv1_annual_tax_on_gains_rate=0.15,
               antithetic=True, allocation_inv1_final_pct=0.4,
               spending_guardrails={"upper_wr_pct": 6.0, "lower_wr_pct": 3.0},
               market_crashes={"frequency_per_year": 0.2, "mean_drop_pct": 25.0,
                               "size_volatility": 0.1, "inv2_beta": 0.3},
               longevity={"mode_age": 88.0, "dispersion_years": 10.0,
                          "max_age": 110.0})
    raw["other_income_streams"][1]["monthly_amount_today"] = 1500.0
    raw.update(overrides)
    return raw


def test_chunked_all_on_probe_equals_single_dispatch(monkeypatch):
    eng = Engine(Config(**_all_on_raw(retirement_years=4)), device="cpu")
    assert all(eng.statics[6:]) and eng.statics.bill1
    assert eng.statics.stream_indexed == (True, False)
    assert eng.statics.stream_capped == (False, True)
    months, n = [20, 33, 45], 4096 + 904
    single = eng.probe(months, n)
    monkeypatch.setenv("MCRT_MAX_PROBE_PATHS", "4096")
    ck.reset_counts()
    assert eng.probe(months, n) == single
    assert ck.PLAIN_CALLS["probe"] == 2
    assert 0.0 < min(single) and max(single) < 100.0


def test_all_on_engine_matches_jax_scan_within_monte_carlo_error():
    raw = _all_on_raw(monthly_expenses=11_000.0)
    n, months = 8192, 130
    port = Engine(Config(**raw), device="cpu").run(months, n)
    ref = JaxEngine(JaxConfig(**raw)).run(months, n, stream="final")
    a, b = port.success_probability, ref.success_probability
    assert 50.0 < b < 99.0, b  # a month that discriminates
    sigma = math.hypot(binomial_sigma_pct(a, n), binomial_sigma_pct(b, n))
    assert abs(a - b) <= max(4.0 * sigma, 0.30), (a, b)
    for name in ("median_start_balance", "median_final_successful"):
        x, y = getattr(port, name), getattr(ref, name)
        assert abs(x - y) <= 0.05 * abs(y), (name, x, y)
    assert np.isfinite(port.trajectory_percentiles).all()
    counts = np.asarray(port.wr_observation_counts)
    assert counts[0] > 0 and (np.diff(counts) <= 0).all()
