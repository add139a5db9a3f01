"""The probe's shared working years: each path accumulates once per launch.

A probe's candidates differ only in their working months W. An
accumulation month reads the carry, the month, the growth factors and the
shared parameter block, and not W, except through the glide path, whose
target moves with each row's own W. So without a glide path a row's carry
at its month W is the carry a row with a larger W holds at that month,
bit for bit, and ``probe_kernel`` (``engine/csrc/month_loop.cu``) takes it
from ``accum_kernel``, which runs each path's accumulation once, to the
launch's largest W. On the CPU the plain month loop (``engine/kernel.py``)
holds that premise, and ``cuda_kernel`` the launch's plan and its counter
(``accum_counts``, ``BODY_STEPS["accum"]``; the work count behind the bound,
``tile_work``, is held in ``test_torch_tiling.py``). The tests marked ``card`` hold
the kernel's outputs, bit for bit, to the full kernel's per-row months;
they skip without a CUDA card. This file imports no JAX: on the card,

    python -m pytest --noconftest -m card tests/test_torch_shared_accum.py
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import kernel  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

SLICE = ck.Statics(True, True, False, False, (True,), (False,))
GLIDE = SLICE._replace(glide=True)
# config.json's household under each Statics whose accumulation the
# mechanism shares, and with a glide path, which it does not.
SETS = {"base": {}, "glide": chip_smoke.EXTENSIONS["glide"]}
SETS.update({k: chip_smoke.EXTENSIONS[k] for k in (
    "bills", "streams", "jumps", "mortality", "antithetic")})
SHARED = ("base", "bills", "streams", "jumps", "mortality", "antithetic")
# The search's probes in macunaima.plan: W = 0 x 16, the two ladders and
# the verify probe (11 rows and 5 padding rows).
LADDER_LOW = list(range(12, 193, 12))
LADDER_HIGH = list(range(204, 385, 12))
VERIFY = list(range(194, 205)) + [204] * 5


def _engine(name, device="cpu", dtype=None) -> Engine:
    kw = {} if dtype is None else {"dtype": dtype}
    return Engine(chip_smoke._config(**dict(SETS[name])), device=device, **kw)


def _carries(eng: Engine, dtype, short, long_w, n):
    """The plain loop's carry of rows that stop at their own W (t_end = W:
    no retirement month) and of a row at W = ``long_w`` run to each of
    those months, in one loop each; (K, n) tensors by field, the short
    rows first."""
    R = eng.retirement_years
    outs = []
    for w in short:
        packed = ck.pack_params(eng.params, 11, [w, long_w], R, dtype=dtype)
        ip = packed.ip.clone()
        ip[:, ck.I_T_END] = w  # the loop runs months 1..w
        rows = ck.Packed(fp=packed.fp, ip=ip, n_streams=packed.n_streams)
        outs.append(kernel.simulate(rows, eng.statics, R, n, carry=True)["carry"])
    return {f: torch.cat([torch.stack([o[f][i] for o in outs]) for i in (0, 1)])
            for f in outs[0]}


def _fields(statics):
    base = ["b1", "c1", "b2", "c2", "infl"]
    return base + (["g1a", "g2a", "preret"] if statics.bill1 or statics.bill2 else [])


# ---------------------------------------------------------------------------
# the premise, on the plain loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", SHARED)
def test_a_rows_carry_at_its_w_is_any_longer_rows_carry_there(name, dtype):
    eng = _engine(name)
    short = [7, 12, 30, 47]
    carry = _carries(eng, dtype, short, 60, 256)
    k = len(short)
    fields = _fields(eng.statics)
    assert len(fields) == ck.carry_fields(eng.statics)
    for f in fields:
        assert torch.equal(carry[f][:k], carry[f][k:]), f
    # the months did something: the carry moved between the rows' W
    assert not torch.equal(carry["b1"][0], carry["b1"][k - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_glide_path_makes_the_carries_differ(dtype):
    eng = _engine("glide")
    assert eng.statics.glide
    short = [12, 30, 47]
    carry = _carries(eng, dtype, short, 60, 256)
    k = len(short)
    for i in range(k):
        assert not torch.equal(carry["b1"][i], carry["b1"][k + i])


# ---------------------------------------------------------------------------
# the plan, its work and its counter
# ---------------------------------------------------------------------------
def test_the_probe_plan_shares_accumulation_only_without_a_glide_path():
    for st in (SLICE, SLICE._replace(bill1=True, jumps=True, mortality=True)):
        plan = ck.probe_plan(16, 1000, st)
        assert plan.accum_once
        assert plan._replace(accum_once=False) == ck.tile_plan(16, 1000, st, "probe")
    assert ck.probe_plan(16, 1000, GLIDE) == ck.tile_plan(16, 1000, GLIDE, "probe")
    assert not ck.tile_plan(16, 1000, SLICE, "probe").accum_once  # scan rows
    assert not ck.tile_plan(16, 1000, SLICE, "grid").accum_once
    assert ck.carry_fields(SLICE) == 5
    assert ck.carry_fields(SLICE._replace(bill2=True)) == 8


@pytest.mark.parametrize("months,run,rows", [
    ([0] * 16, 0, 0),
    (LADDER_LOW, 192, 1_632),
    (LADDER_HIGH, 384, 4_704),
    (VERIFY, 204, 2_189 + 5 * 204),
])
def test_accum_counts_of_the_searchs_probes(months, run, rows):
    n = 1_000_000
    plan = ck.probe_plan(16, n, SLICE)
    got = ck.accum_counts(plan, months)
    assert got == {"accum_run": n * run, "accum_rows": n * rows}
    t_end = [w + 600 for w in months]
    assert got["accum_run"] == ck.tile_work(plan, months, t_end)["accum"]
    glide = ck.accum_counts(ck.probe_plan(16, n, GLIDE), months)
    assert glide == {"accum_run": n * rows, "accum_rows": n * rows}


def test_a_plan_that_does_not_fit_the_statics_is_refused_before_building():
    n = 100
    packed = ck.Packed(fp=torch.zeros(ck.F.NUM + 5),
                       ip=torch.zeros((2, ck.NUM_IPARAMS), dtype=torch.int32),
                       n_streams=1)
    with pytest.raises(ValueError, match="once per path"):
        ck._launch_rows("mcrt_probe", packed, SLICE, n, ck.tile_plan(2, n, SLICE, "probe"))
    with pytest.raises(ValueError, match="per row"):
        ck._launch_rows("mcrt_probe", packed, GLIDE, n,
                        ck.tile_plan(2, n, GLIDE, "probe")._replace(accum_once=True))


def test_the_packing_keeps_the_rows_months_on_the_host():
    eng = _engine("base")
    packed = eng._pack([0, 36, 12], "search")
    assert packed.months == (0, 36, 12)
    assert ck.row_months(packed) == (0, 36, 12)
    bare = ck.Packed(fp=packed.fp, ip=packed.ip, n_streams=packed.n_streams)
    assert ck.row_months(bare) == (0, 36, 12)
    assert eng._pack(24, "final").months == (24,)


def test_a_plain_probe_counts_no_accumulation():
    ck.reset_counts()
    profiling.enable()
    profiling.drain()
    try:
        eng = _engine("base")
        ck.probe(eng._pack([0, 12], "search"), eng.statics, eng.retirement_years, 64)
        spans = [s for s in profiling.drain() if s["name"] == "kernel.probe"]
        assert [s["attrs"] for s in spans] == [{"statics": ""}]
        assert ck.BODY_STEPS["accum"] == [0, 0]
    finally:
        profiling.disable()
        profiling.drain()
        ck.reset_counts()


# ---------------------------------------------------------------------------
# the kernels, on the card
# ---------------------------------------------------------------------------
N_CARD = 65_536


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel runs only there")
    return torch.device("cuda")


CASES = {
    "unsorted": ([192, 12, 84, 0, 36, 144, 60, 108, 180, 24, 156, 48, 132, 96,
                  168, 72], N_CARD),
    "padding": (VERIFY, N_CARD),
    "w0_mixed": ([0] * 8 + list(range(204, 289, 12)), N_CARD),
    "one": ([199], N_CARD),
    "ragged_n": (LADDER_LOW, N_CARD + 37),
}


def _per_row(eng, packed, months, n):
    """The full kernel (every path runs its own months, W by W) per row:
    success and final balance, (K, n)."""
    R, T = eng.retirement_years, 12 * eng.retirement_years
    success, final = [], []
    for row, w in enumerate(months):
        one = ck.Packed(fp=packed.fp, ip=packed.ip[row:row + 1].contiguous(),
                        n_streams=packed.n_streams)
        out = ck.simulate_full(one, eng.statics, R, n, 2 + (w + T) // 12)
        success.append(out["success"])
        final.append(out["final_balance"])
    return torch.stack(success), torch.stack(final)


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["base", "bills"])
def test_the_shared_accumulation_changes_no_output(card, name, case):
    months, n = CASES[case]
    eng = _engine(name, card)
    packed = eng._pack(months, "search")
    out = ck.probe(packed, eng.statics, eng.retirement_years, n)
    success, final = _per_row(eng, packed, months, n)
    assert torch.equal(out.success, success)
    assert torch.equal(out.final_balance, final)
    assert out.counts.tolist() == (success > 0.5).sum(dim=1).tolist()


@pytest.mark.card
def test_a_probe_runs_the_accumulation_pass_at_most_once(card):
    from torch.profiler import ProfilerActivity, profile

    def launches(eng, months):
        ck.reset_counts()
        packed = eng._pack(months, "search")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ck.probe(packed, eng.statics, eng.retirement_years, N_CARD)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        return (sum("accum_kernel" in s for s in names),
                sum("probe_kernel" in s for s in names), list(ck.BODY_STEPS["accum"]))

    base, glide = _engine("base", card), _engine("glide", card)
    assert launches(base, LADDER_HIGH) == (1, 1, [N_CARD * 384, N_CARD * 4_704])
    assert launches(base, [0] * 16) == (0, 1, [0, 0])
    assert launches(glide, LADDER_HIGH) == (0, 1, [N_CARD * 4_704] * 2)
    ck.reset_counts()
