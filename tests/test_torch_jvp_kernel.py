"""The JVP kernel's host side, held on the CPU.

``sensitivity_ad`` computes the parameter block's tangents along theta
(``ad_inputs``: ``torch.func.jacfwd`` of theta -> block, scalars only) and
hands them to ``cuda_kernel.simulate_jvp``: ``jvp_kernel`` on the card, its
plain version (``simulate_jvp_plain``: ``torch.func.jvp`` of the plain loop
along each direction) on the CPU. A CUDA kernel does not run here, so this
file holds what can be checked without a card, in float64:

* (a) the plain version's per-path final balances and tangents, reduced,
  equal ``torch.func.jacfwd`` of the mean through the plain loop (the AD
  pass as it was before the kernel) within 1e-12, on both draw sources,
  for a config.json-sized scenario, each extension case of
  ``tests/test_torch_ad.py`` and antithetic sampling;
* (b) on the scan's draws, the per-path tangents equal JAX's ``jax.jacfwd``
  of ``simulate_paths(...).final_balance`` along the same theta directions,
  within 1e-10 of each direction's largest tangent;
* (c) the tie rules the kernel copies from the chain, where real paths
  meet them: a ruined path (final exactly 0) carries zero tangents; a
  pension that pays the expenses exactly passes the need's tangent
  (``torch.clamp(min=0)`` at 0: the one-sided slope of rising expenses); a
  guardrail multiplier cut to its floor, or raised to its cap, exactly,
  takes half of each side (``torch.maximum``/``minimum`` at a tie: the
  central difference, between one-sided slopes 0 and twice it);
* (d) dispatch: a CPU block runs the plain version, counted once as
  ``"ad"``; a block on a CUDA device without a card raises; malformed
  directions raise; one library per (Statics, real, draws, tangents), the
  forward units unchanged, float64 without contraction;
* (e) the bound's JVP unit (one tangent per direction) and parts, from
  their shapes.

The kernel itself is held to its plain version on the card
(``chip_smoke.py`` phase 16, with these tie cases).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import sensitivity as jax_sens  # noqa: E402
from monte_carlo_retirement_tpu.engine.kernel import (  # noqa: E402
    simulate_paths as jax_simulate_paths,
)
from monte_carlo_retirement_tpu.ops import shocks as jshocks  # noqa: E402
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import _build, bound  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import kernel  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.cuda_kernel import F, Packed  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (  # noqa: E402
    _grid_stream_seed,
)
from monte_carlo_retirement_tpu_torch.engine.sensitivity import (  # noqa: E402
    DEFAULT_PARAMS,
    _params_from_theta,
    _scan_statics_ad,
    ad_inputs,
    sensitivity_ad,
)
from monte_carlo_retirement_tpu_torch.ops.shocks import stream_keys  # noqa: E402
from tests.conftest import base_config_dict  # noqa: E402
from tests.test_torch_ad import EXTENSION_CASES  # noqa: E402

torch.set_num_threads(2)

SEED = 77
CPU = torch.device("cpu")
F64 = torch.float64
REDUCED_RTOL = 1e-12  # (a): reduced value and gradients vs jacfwd
JAX_RTOL = 1e-10  # (b): per-path tangents vs JAX, of each direction's largest
SLICE = ck.Statics(True, True, False, False, (True,), (False,))
ROUTES = ("auto", "scan")


def _slice_raw(**over):
    """config.json's scenario cut to R = 10 (its streams, taxes, rates)."""
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "config.json"), encoding="utf-8") as fh:
        raw = json.load(fh)
    raw.update(seed=SEED, retirement_years=10, **over)
    return raw


def _extension_raw(over):
    return base_config_dict(retirement_years=8, initial_balance=260_000.0,
                            monthly_expenses=2_300.0,
                            inv1_returns_volatility=0.16,
                            num_simulations_main=64, **over)


# name -> (raw config, W, paths)
CASES = {
    "config.json": (_slice_raw(), 228, 256),
    "antithetic": (_slice_raw(antithetic=True), 228, 256),
    **{f"extension_{case}": (_extension_raw(over), 6, 256)
       for case, (over, _dotted, _smooth) in EXTENSION_CASES.items()},
}


def _jacfwd_ad(cfg, w, n, names, backend):
    """The AD pass before the kernel: torch.func.jacfwd of the mean final
    balance through the plain loop, in float64 on the CPU."""
    R = int(cfg.retirement_years)
    if backend == "scan":
        statics = _scan_statics_ad(cfg, names, CPU)
        key = stream_keys(SEED)[1]

        def finals(p):
            packed, _ = kernel.scan_block(p, [w], R, F64, device=CPU,
                                          statics=statics)
            return kernel.scan_chain(packed, statics, R, n, key,
                                     t_scan=w + 12 * R)["final_balance"][0]
    else:
        statics = ck.statics_from_config(cfg)
        seed = _grid_stream_seed(SEED)

        def finals(p):
            packed = ck.pack_params(p, seed, [w], R, dtype=F64, device=CPU)
            return kernel.simulate(packed, statics, R, n)["final_balance"][0]

    def metric(theta):
        mean = finals(_params_from_theta(cfg, names, theta)).mean()
        return mean, mean

    dump = cfg.model_dump()
    theta0 = torch.tensor([float(dump[k]) for k in names], dtype=F64)
    grads, value = torch.func.jacfwd(metric, has_aux=True)(theta0)
    return float(value), grads.numpy()


def _rel_to_largest(got, want):
    """Per direction (row): largest |got - want| over its largest |want|."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-300)
    return float((np.abs(got - want) / scale).max())


# ---------------------------------------------------------------------------
# (a) the plain version, reduced, is the jacfwd AD pass
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_jvp_reduces_to_the_jacfwd_ad_pass(case, route):
    raw, w, n = CASES[case]
    cfg = Config(**raw)
    names = list(DEFAULT_PARAMS)
    packed, fp_dot, statics, draws = ad_inputs(cfg, w, names, SEED, CPU,
                                               route, F64)
    ck.reset_counts()
    out = ck.simulate_jvp_plain(packed, fp_dot, statics,
                                cfg.retirement_years, n, **draws)
    assert ck.PLAIN_CALLS["ad"] == 1 and not any(ck.LAUNCHES.values())
    assert out.final_balance.shape == (n,) and out.success.shape == (n,)
    assert out.tangents.shape == (len(names), n)
    value, grads = _jacfwd_ad(cfg, w, n, names, route)
    got_value = float(out.final_balance.mean())
    got = out.tangents.mean(dim=1).numpy()
    assert abs(got_value - value) <= REDUCED_RTOL * abs(value)
    assert np.all(np.abs(got - grads) <= REDUCED_RTOL * np.abs(grads) + 1e-300)


# ---------------------------------------------------------------------------
# (b) the scan route's per-path tangents are JAX's
# ---------------------------------------------------------------------------
JAX_CASES = {
    "defaults": (base_config_dict(seed=SEED, retirement_years=4,
                                  monthly_expenses=4_000.0,
                                  inv1_returns_volatility=0.15), 24, 500,
                 list(DEFAULT_PARAMS)),
    "crashes, antithetic": (
        _extension_raw(EXTENSION_CASES["crashes"][0]), 6, 256,
        ["initial_balance", "monthly_expenses", "inv1_returns_mean"]),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_scan_tangents_per_path_equal_jax_jacfwd(case):
    raw, w, n, names = JAX_CASES[case]
    cfg, jcfg = Config(**raw), JaxConfig(**raw)
    R = int(cfg.retirement_years)
    packed, fp_dot, statics, draws = ad_inputs(cfg, w, names, SEED, CPU,
                                               "scan", F64)
    out = ck.simulate_jvp(packed, fp_dot, statics, R, n, **draws)

    def finals(theta):
        p = jax_sens._params_from_theta(jcfg, names, theta, jnp.float64)
        return jax_simulate_paths(
            p, jnp.asarray(w, jnp.int32), jshocks.stream_keys(SEED)[1],
            n_paths=n, t_scan=w + 12 * R, retirement_years=R, traj_len=0,
            dtype=jnp.float64, antithetic=bool(jcfg.antithetic),
            jumps=jcfg.market_crashes is not None,
            mortality=jcfg.longevity is not None).final_balance

    dump = cfg.model_dump()
    theta0 = jnp.asarray([float(dump[k]) for k in names], jnp.float64)
    want = np.asarray(jax.jacfwd(finals)(theta0)).T  # (K, n)
    want_final = np.asarray(finals(theta0))
    assert np.allclose(out.final_balance.numpy(), want_final, rtol=JAX_RTOL,
                       atol=0.0)
    rel = _rel_to_largest(out.tangents.numpy(), want)
    print(f"\n{case}: per-path tangents vs JAX, worst {rel:.3e} of each "
          f"direction's largest")
    assert np.abs(want).max(axis=1).min() > 0.0
    assert rel <= JAX_RTOL, rel


# ---------------------------------------------------------------------------
# (c) the tie rules, where real paths meet them
# ---------------------------------------------------------------------------
def _slopes(packed, statics, R, n, slot, h, draws):
    """(right, left, central) finite differences of the mean final balance
    along parameter slot ``slot`` (one finite slot moved; common draws)."""
    def mean(delta):
        fp = packed.fp.clone()
        fp[slot] += delta
        block = Packed(fp=fp, ip=packed.ip, n_streams=packed.n_streams)
        if draws:
            out = kernel.scan_chain(block, statics, R, n, draws["stream_key"],
                                    t_scan=draws["t_scan"])
        else:
            out = kernel.simulate(block, statics, R, n)
        return float(out["final_balance"][0].mean())

    m0, mp, mm = mean(0.0), mean(h), mean(-h)
    return (mp - m0) / h, (m0 - mm) / h, (mp - mm) / (2.0 * h)


@pytest.mark.parametrize("route", ROUTES)
def test_tie_ruined_paths_carry_zero_tangents(route):
    cfg = Config(**base_config_dict(retirement_years=6,
                                    initial_balance=100_000.0,
                                    monthly_expenses=1_500.0))
    packed, fp_dot, statics, draws = ad_inputs(
        cfg, 0, ["monthly_expenses", "initial_balance"], SEED, CPU, route, F64)
    out = ck.simulate_jvp(packed, fp_dot, statics, 6, 512, **draws)
    ruined = out.success < 0.5
    assert 0 < int(ruined.sum()) < 512  # some paths ruin, some live
    assert torch.all(out.final_balance[ruined] == 0.0)
    assert torch.all(out.tangents[:, ruined] == 0.0)
    assert torch.all(out.tangents[1, ~ruined] > 0.0)  # d final / d initial


@pytest.mark.parametrize("route", ROUTES)
def test_tie_pension_paying_the_expenses_passes_the_need_tangent(route):
    """need = clamp(expenses x price - income, min=0) is exactly 0 each
    retirement month; torch.clamp passes the tangent at the bound, so AD
    is the slope of rising expenses, while falling expenses change nothing."""
    pension = dict(name="pension", monthly_amount_today=3_000.0,
                   start_at_age=40.0, duration_years=None,
                   inflation_indexed=True, tax_rate=0.0)
    cfg = Config(**base_config_dict(retirement_years=4,
                                    initial_balance=200_000.0,
                                    monthly_expenses=3_000.0,
                                    other_income_streams=[pension]))
    packed, fp_dot, statics, draws = ad_inputs(
        cfg, 12, ["monthly_expenses"], SEED, CPU, route, F64)
    out = ck.simulate_jvp(packed, fp_dot, statics, 4, 256, **draws)
    right, left, _ = _slopes(packed, statics, 4, 256, F.EXPENSES, 1e-4, draws)
    ad = float(out.tangents[0].mean())
    assert torch.all(out.success > 0.5)
    assert left == 0.0 and right < 0.0
    assert ad == pytest.approx(right, rel=1e-7)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("bound_", ["floor", "cap"])
def test_tie_guardrail_at_floor_or_cap_takes_half_of_each_side(bound_, route):
    """A 10% cut from 1 lands on a 90% floor exactly (a 10% raise on a
    110% cap): torch.maximum / minimum at the tie take half of each side's
    tangent, so AD along the adjustment is the central difference, between
    one-sided slopes 0 and twice it. R = 2: one year start, one tie."""
    rule = (dict(upper_wr_pct=0.5, lower_wr_pct=0.0, adjustment_pct=10.0,
                 floor_pct=90.0) if bound_ == "floor" else
            dict(upper_wr_pct=100.0, lower_wr_pct=99.0, adjustment_pct=10.0,
                 cap_pct=110.0))
    cfg = Config(**base_config_dict(retirement_years=2,
                                    spending_guardrails=rule))
    packed, fp_dot, statics, draws = ad_inputs(
        cfg, 12, ["monthly_expenses"], SEED, CPU, route, F64)
    along = torch.zeros_like(fp_dot)
    along[0, F.GR_ADJ] = 1.0
    out = ck.simulate_jvp(packed, along, statics, 2, 256, **draws)
    right, left, central = _slopes(packed, statics, 2, 256, F.GR_ADJ, 1e-6,
                                   draws)
    ad = float(out.tangents[0].mean())
    assert right == 0.0
    assert left == pytest.approx(2.0 * central, rel=1e-6)
    assert abs(central) > 1.0
    assert ad == pytest.approx(central, rel=1e-7)


# ---------------------------------------------------------------------------
# (d) dispatch, refusals and libraries
# ---------------------------------------------------------------------------
def _small():
    cfg = Config(**base_config_dict(retirement_years=2))
    return cfg, ad_inputs(cfg, 6, ["monthly_expenses", "initial_balance"],
                          SEED, CPU, "auto", F64)


def test_cpu_blocks_run_the_plain_version_once_per_call():
    cfg, (packed, fp_dot, statics, _) = _small()
    ck.reset_counts()
    a = ck.simulate_jvp(packed, fp_dot, statics, 2, 64)
    assert ck.PLAIN_CALLS == {"probe": 0, "grid": 0, "simulate": 0, "full": 0,
                              "scan": 0, "ad": 1}
    assert not any(ck.LAUNCHES.values())
    b = ck.simulate_jvp_plain(packed, fp_dot, statics, 2, 64)
    assert ck.PLAIN_CALLS["ad"] == 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ck.reset_counts()
    names = ["monthly_expenses", "initial_balance"]
    for route in ROUTES:
        ad = sensitivity_ad(cfg, 6, num_paths=64, seed=SEED, params=names,
                            device="cpu", backend=route)
        # sensitivity_ad is the float64 mean of one simulate_jvp call.
        block, dirs, st, draws = ad_inputs(cfg, 6, names, SEED, CPU, route, F64)
        out = ck.simulate_jvp_plain(block, dirs, st, 2, 64, **draws)
        assert ad["mean_final_balance"] == float(out.final_balance.mean())
        assert list(ad["d_mean_final"].values()) == [
            float(g) for g in out.tangents.mean(dim=1)]
    assert ck.PLAIN_CALLS["ad"] == 4 and not any(ck.LAUNCHES.values())
    # The primal is the plain loop's own run.
    plain = kernel.simulate(packed, statics, 2, 64)
    assert torch.equal(a.final_balance, plain["final_balance"][0])
    assert torch.equal(a.success, plain["success"][0])


def test_a_block_on_the_card_launches_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the wrapper would launch")
    _, (packed, fp_dot, statics, draws) = _small()
    on_card = types.SimpleNamespace(fp=packed.fp, ip=packed.ip,
                                    n_streams=packed.n_streams,
                                    device=torch.device("cuda"))
    ck.reset_counts()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ck.simulate_jvp(on_card, fp_dot, statics, 2, 64)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sensitivity_ad(Config(**base_config_dict(retirement_years=2)), 6,
                       num_paths=8, params=["monthly_expenses"])
    assert not any(ck.PLAIN_CALLS.values()) and not any(ck.LAUNCHES.values())


def test_malformed_directions_and_draws_raise():
    _, (packed, fp_dot, statics, _) = _small()
    with pytest.raises(ValueError, match="tangent directions"):
        ck.simulate_jvp(packed, fp_dot[:, :-1], statics, 2, 64)
    with pytest.raises(ValueError, match="tangent directions"):
        ck.simulate_jvp(packed, fp_dot[:0], statics, 2, 64)
    with pytest.raises(TypeError, match="float32"):
        ck.simulate_jvp(packed, fp_dot.float(), statics, 2, 64)
    with pytest.raises(ValueError, match="stream_key and t_scan"):
        ck.simulate_jvp(packed, fp_dot, statics, 2, 64,
                        stream_key=stream_keys(SEED)[1])
    two = Packed(fp=packed.fp, ip=packed.ip.repeat(2, 1),
                 n_streams=packed.n_streams)
    with pytest.raises(ValueError, match="one working_months"):
        ck.simulate_jvp(two, fp_dot, statics, 2, 64)


def test_one_library_per_statics_real_draws_and_tangents():
    forward = [_build.Unit(SLICE), _build.Unit(SLICE, "float", "threefry"),
               _build.Unit(SLICE, "double", "threefry")]
    jvp = [_build.Unit(SLICE, real, draws, tk) for real in ("float", "double")
           for draws in ("philox", "threefry") for tk in (4, 8)]
    units = forward + jvp
    assert len({_build.library_path(u) for u in units}) == len(units)
    assert len({_build.count_path(u) for u in units}) == len(units)
    for u in forward:  # the forward units' text carries no tangents
        assert "MCRT_JVP_TK" not in _build.statics_unit(
            SLICE, "month_loop.cu", u.real, u.draws)
    for u in jvp:
        text = _build.statics_unit(SLICE, "month_loop.cu", u.real, u.draws, u.tk)
        assert text.endswith(f"#define MCRT_JVP_TK {u.tk}\n"
                             "#include \"month_loop.cu\"\n")
        assert ("#define MCRT_THREEFRY 1" in text) == (u.draws == "threefry")
        assert ("#define MCRT_REAL_DOUBLE 1" in text) == (u.real == "double")
        assert _build._unit_flags(u) == (("-fmad=false",) if u.real == "double"
                                         else ())
    with pytest.raises(ValueError, match="philox"):
        _build.statics_unit(SLICE, real="double")
    with pytest.raises(ValueError, match="tk >= 1"):
        _build.statics_unit(SLICE, tk=-1)
    assert "dual.cuh" in _build.SOURCES
    assert isinstance(ck.JVP_TK, int) and ck.JVP_TK >= 1


# ---------------------------------------------------------------------------
# (e) the bound's JVP unit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", ["jvp philox f32", "jvp threefry f32",
                                   "jvp philox f64", "jvp threefry f64"])
def test_jvp_bound_prices_each_direction_once(label):
    """The JVP bound's op-count unit is the library 8f launches but for its
    tangents: one per direction, so one pass of full_work prices the draws
    and the primal once, whatever launches the kernel splits them into."""
    import chip_smoke

    names = list(DEFAULT_PARAMS)
    unit = chip_smoke._counted_units()[label]
    launched = chip_smoke._jvp_unit(chip_smoke._config(), names, unit.real,
                                    unit.draws)
    assert unit.tk == len(names) == 8 and launched.tk == ck.JVP_TK
    assert unit._replace(tk=ck.JVP_TK) == launched
    n, w, R = 1000, 231, 50
    assert bound.full_work(n, w, w + 12 * R) == {
        "draws": n * (w + 12 * R), "accum": n * w, "retire": n * 12 * R}


def _listing(kernels):
    """A cuobjdump-like listing: each kernel's opcodes, then EXIT."""
    lines = []
    for name, ops in kernels.items():
        lines.append(f"        Function : {name}")
        addr = 0
        for op in list(ops) + ["EXIT"]:
            lines.append(f"        /*{addr:04x}*/                   {op} R0, R1 ;")
            addr += 16
    return "\n".join(lines)


def test_jvp_parts_price_the_dual_steps_and_yearly_code():
    kernels = {
        "count_jvp_draw": ["FFMA"] * 128 + ["MUFU.EX2"] * 3,
        "count_jvp_accum_plain": ["FFMA"] * 256,
        "count_jvp_accum": ["FFMA"] * (256 + 12 * 128),
        "count_jvp_retire_plain": ["DFMA"] * 64,
        "count_jvp_retire": ["DFMA"] * 64 + ["IMAD"] * (12 * 64),
    }
    parts = bound.jvp_part_loads(_listing(kernels))
    assert set(parts) == {"draw", "accum", "retire"}
    assert parts["draw"]["fp32"] == 1.0 and parts["draw"]["xu"] == 3 / 16
    # the yearly code once in 12 months: 2 + (14 - 2) / 12
    assert parts["accum"]["fp32"] == pytest.approx(3.0)
    assert parts["retire"]["fp64"] == 1.0 and parts["retire"]["imad"] == 1.0
    # 132,000 paths, W = 12, 12 retirement months: per thread 24 draws, 12
    # accumulation and 12 retirement months; the busiest load is issue:
    # 24 x 131/128 + 12 x 3 + 12 x 1.
    work = bound.full_work(132_000, 12, 24)
    ms, by = bound.bound_ms("jvp", work, parts, out_bytes=0, sm_count=132,
                            clock_hz=1e9)
    issue = 24 * 131 / 128 + 12 * 3.0 + 12 * 1.0
    assert by == "operations"
    assert ms == pytest.approx(issue * 1_000 / 1e9 * 1e3)
    with pytest.raises(ValueError, match="missing"):
        bound.jvp_part_loads(_listing({"count_jvp_draw": ["FADD"]}))


def test_chip_smoke_builds_every_jvp_library_its_phases_launch():
    """chip_smoke.py phase 1 builds the JVP library of every sensitivity_ad
    call and kernel check of phases 8f, 10d, 15b and 16, on both draw
    sources and in both types, before they run."""
    import chip_smoke

    units = set(chip_smoke._jvp_units())
    for _label, cfg, w, names in chip_smoke._jvp_cases():
        for real, dtype in (("float", torch.float32), ("double", F64)):
            for route, draws in (("auto", "philox"), ("scan", "threefry")):
                _, _, statics, _ = ad_inputs(cfg, w, names, chip_smoke.SEED,
                                             CPU, route, dtype)
                assert _build.Unit(statics, real, draws,
                                   ck.JVP_TK) in units
