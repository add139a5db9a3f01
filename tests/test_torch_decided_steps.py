"""Decided warps in the probe under longevity: the counter of the months a
warp runs after every one of its paths is decided.

Under longevity (``Statics.mortality``) a path's success is settled once
it is ruined, or once its owner has died solvent: a dead owner spends
nothing, so the estate cannot fail. ``probe_kernel``
(``engine/csrc/month_loop.cu``, ``tile_body``) keeps running such a
warp's months, since the estate stays invested, and counts them where
its warps vote (the end of each retirement year and of each chunk):
``ProbeOut.decided``, ``BODY_STEPS["decided"]`` and ``steps_decided`` on
the probe's ``card.sync`` span. On the CPU the plain month loop counts the
same from its per-month flags, and is held here to a derivation from each
path's month of ruin (the tracked run) and month of death (its lifetime
draw); the tests marked ``card`` hold the kernel to that rule on its own
months of ruin, and its outputs to the full kernel's. This file imports no JAX: on the card,

    python -m pytest --noconftest -m card tests/test_torch_decided_steps.py
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import kernel  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops.shocks import (  # noqa: E402
    gompertz_remaining_months,
    mortality_uniform,
    pair_blocks,
    path_keys,
)
from monte_carlo_retirement_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

# config.json's household under Statics with and without longevity.
SETS = {"config.json": {}, "bills": chip_smoke.EXTENSIONS["bills"],
        "mortality": chip_smoke.EXTENSIONS["mortality"], "all-on": chip_smoke.ALL_ON}


def _engine(name, device="cpu") -> Engine:
    return Engine(chip_smoke._config(**SETS[name]), device=device)


def _months_of_ruin(eng: Engine, w: int, n: int) -> torch.Tensor:
    """Each path's retirement month of ruin at W = ``w`` (T + 1 where it
    never fails), from the tracked run's alive months (on the card, the
    full kernel's, which runs the probe's arithmetic on every month)."""
    T = 12 * eng.retirement_years
    packed = eng._pack([w], "search")
    full = ck.simulate_full(packed, eng.statics, eng.retirement_years, n, 2 + (w + T) // 12)
    ytr = full["years_to_ruin"]
    return torch.where(torch.isnan(ytr), torch.full_like(ytr, T + 1), torch.round(ytr * 12))


def _months_of_death(eng: Engine, w: int, n: int) -> torch.Tensor:
    """Each path's remaining lifetime at W = ``w``, in retirement months,
    from its longevity draw, in the engine's dtype."""
    packed = eng._pack([w], "search")
    seed, boff = (int(v) for v in packed.ip[0, [ck.I_SEED, ck.I_BLOCK_OFF]])
    gblock, lane = path_keys(n, boff, packed.device)
    sign = None
    if eng.statics.antithetic:
        gblock, sign = pair_blocks(gblock)
    u = mortality_uniform(seed, gblock, lane, sign=sign).to(packed.fp.dtype)
    fp = packed.fp
    return gompertz_remaining_months(u, fp[ck.F.MORT_G0], fp[ck.F.MORT_B12],
                                     fp[ck.F.MORT_CAP], w)


def _decided_by_derivation(eng: Engine, w: int, n: int, chunk: int):
    """(months run, months run once decided) of a row at W = ``w``, summed
    over its warps: a warp runs its retirement months up to the first
    place it looks (a year's or a chunk's end) after which none of its
    paths lives, and it is decided from the first place after which each
    of them is ruined or past its owner's death."""
    T = 12 * eng.retirement_years
    ruin, death = _months_of_ruin(eng, w, n), _months_of_death(eng, w, n)
    dev = ruin.device
    looks = torch.tensor([k for k in range(1, T + 1) if k % 12 == 0 or (w + k) % chunk == 0],
                         device=dev)
    warps = -(-n // ck.WARP)

    def first(flags):  # (looks, n) -> the first look at which a whole warp holds
        held = torch.nn.functional.pad(flags, (0, warps * ck.WARP - n), value=True)
        held = held.reshape(len(looks), warps, ck.WARP).all(dim=2)
        at = torch.where(held, looks[:, None], torch.full_like(held, T + 1, dtype=looks.dtype))
        return at.min(dim=0).values

    k = looks[:, None].to(ruin.dtype)
    stop = first(ruin[None] <= k).clamp(max=T)
    done = first((ruin[None] <= k) | (k >= death[None]))
    decided = torch.where(done <= T, stop - done, torch.zeros_like(stop))
    return int(stop.sum()), int(decided.sum())


@pytest.mark.parametrize("name,n,months", [
    ("mortality", 333, [0, 150, 231]), ("all-on", 333, [120, 178]),
    ("config.json", 200, [231]), ("bills", 200, [231])])
def test_plain_decided_steps_follow_the_months_of_death_and_ruin(name, n, months):
    eng = _engine(name)
    packed = eng._pack(months, "search")
    out = ck.probe_plain(packed, eng.statics, eng.retirement_years, n)
    if not eng.statics.mortality:
        assert out.decided is None
        return
    chunk = ck.tile_plan(len(months), n, eng.statics, "probe").months_per_chunk
    want = [_decided_by_derivation(eng, w, n, chunk) for w in months]
    assert out.steps.tolist() == [r for r, _ in want]
    assert out.decided.tolist() == [d for _, d in want]
    assert sum(d for _, d in want) > 0  # owners die before the horizon


@pytest.mark.parametrize("name", sorted(SETS))
def test_counting_leaves_the_outputs_alone(name):
    eng = _engine(name)
    packed = eng._pack([0, 120, 231], "search")
    args = (packed, eng.statics, eng.retirement_years, 300)
    counted = kernel.simulate(*args, decided=True)
    plain = kernel.simulate(*args)
    assert ("decided" in counted) == eng.statics.mortality
    for key in ("success", "final_balance", "steps"):
        assert torch.equal(counted[key], plain[key]), key


@pytest.fixture
def recorder():
    ck.reset_counts()
    profiling.enable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()
    ck.reset_counts()


def test_the_probe_brings_its_decided_steps_back_with_the_survivors(recorder):
    eng = _engine("mortality")
    n, months = 500, [0, 150, 231]
    eng.probe(months, n, backend="pallas")
    syncs = [s["attrs"] for s in profiling.drain() if s["name"] == "card.sync"]
    assert len(syncs) == 1 and syncs[0]["what"] == "probe"
    padded = months + [months[-1]] * (16 - len(months))
    out = ck.probe_plain(eng._pack(padded, "search"), eng.statics,
                         eng.retirement_years, n)
    decided, run = int(out.decided.sum()), int(out.steps.sum())
    assert 0 < decided < run
    every = ck.body_steps_all(16, n, eng.retirement_years)
    assert syncs[0] == {"what": "probe", "steps_run": run, "steps_all": every,
                        "steps_decided": decided}
    assert ck.BODY_STEPS["decided"] == [decided, every]
    assert ck.BODY_STEPS["probe"] == [run, every]
    ck.reset_counts()
    assert ck.BODY_STEPS["decided"] == [0, 0]


# ---------------------------------------------------------------------------
# the kernel, on the card
# ---------------------------------------------------------------------------
N_CARD = 65_536


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tiled kernels run only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name", ["mortality", "all-on"])
def test_the_kernel_counts_the_decided_steps_by_the_plain_rule(card, name):
    """The plain version's float32 arithmetic on the card may ruin a path a
    month or two away from the kernel's (its flags agree within the
    suites' bounds), which moves a warp's decided months: the kernel is
    held to the plain version's rule on its own months of ruin (the full
    kernel's) and the lifetimes of its draws."""
    from monte_carlo_retirement_tpu_torch.hosts import fuzz

    eng = _engine(name, card)
    months = [0, 60, 120, 150, 178, 200, 231, 260, 312]
    packed = eng._pack(months, "search")
    out = ck.probe(packed, eng.statics, eng.retirement_years, N_CARD)
    chunk = ck.tile_plan(len(months), N_CARD, eng.statics, "probe").months_per_chunk
    want = [_decided_by_derivation(eng, w, N_CARD, chunk) for w in months]
    assert out.steps.tolist() == [r for r, _ in want]
    assert out.decided.tolist() == [d for _, d in want]
    assert int(out.decided.sum()) > 0
    plain = ck.probe_plain(packed, eng.statics, eng.retirement_years, N_CARD)
    every = torch.ones(N_CARD, dtype=torch.bool, device=card)
    assert fuzz.compare_rows(out, plain, every)["ok"]


@pytest.mark.card
def test_the_all_on_probe_equals_the_full_kernel_bit_for_bit(card):
    """The full kernel runs every month of every path and counts nothing:
    the probe's outputs with the counter on are its outputs."""
    eng = _engine("all-on", card)
    months = [0, 120, 178, 231]
    R = eng.retirement_years
    out = ck.probe(eng._pack(months, "search"), eng.statics, R, N_CARD)
    for row, w in enumerate(months):
        full = ck.simulate_full(eng._pack([w], "search"), eng.statics, R, N_CARD,
                                2 + (w + 12 * R) // 12)
        assert torch.equal(out.success[row], full["success"]), w
        assert torch.equal(out.final_balance[row], full["final_balance"]), w
