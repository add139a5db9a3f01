"""Ruined paths in the tiled month loop: the work that stops, and why the
outputs stay the same.

``probe_kernel``, ``grid_kernel`` and ``scan_rows_kernel``
(``engine/csrc/month_loop.cu``, ``tile_body``) stop a warp's retirement
months once its 32 paths are all ruined, and a block's month loop, draws
included, once its warps are all done. That is exact because a ruined
path's carry is a fixed point of the retirement month. On the CPU the
plain month loop (``engine/kernel.py``) holds that invariant and the
meaning of the kernels' counter of body steps (the plain loop counts the
same steps from its per-month alive flags), and the program brings the
counter back with the survivors. The tests marked ``card`` hold the
kernels themselves to the full kernel (which runs every month of every
path) bit for bit, to the plain version, and to the count; they skip
without a CUDA card. This file imports no JAX: on the card,

    python -m pytest --noconftest -m card tests/test_torch_ruined_paths.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import kernel  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (  # noqa: E402
    run_scenario_grid,
)
from monte_carlo_retirement_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

# config.json's household (ruined within ~30 retirement months at low W)
# under each Statics the suites sweep.
SETS = {"config.json": {}, "all-on": chip_smoke.ALL_ON}
SETS.update({k: chip_smoke.EXTENSIONS[k] for k in (
    "bills", "fixed", "capped", "glide", "guardrails", "jumps", "mortality")})
# Live: phase 6's household (1.5M, 4,000 a month) lives through 50 years.
LIVE = dict(initial_balance=1_500_000.0, monthly_expenses=4_000.0)


def _engine(device="cpu", **over) -> Engine:
    return Engine(chip_smoke._config(**dict(over)), device=device)


def _rows(eng: Engine, w: int, t_ends) -> ck.Packed:
    """One shared block, one row per t_end, all retiring after month w."""
    base = eng._pack([w], "search")
    ip = base.ip.repeat(len(t_ends), 1)
    ip[:, ck.I_T_END] = torch.as_tensor(t_ends, dtype=ip.dtype)
    return ck.Packed(fp=base.fp, ip=ip, n_streams=base.n_streams)


def _steps_from_alive(alive_after: torch.Tensor, w: int, chunk: int) -> torch.Tensor:
    """The retirement months each warp runs, from its paths' alive flags
    after each of their T retirement months ((T, n), row k-1 = after month
    w + k): all T, or up to the first month that ends a retirement year or
    a chunk of ``chunk`` months after which none of them lives."""
    T, n = alive_after.shape
    warps = -(-n // ck.WARP)
    live = torch.nn.functional.pad(alive_after > 0.5, (0, warps * ck.WARP - n))
    live = live.reshape(T, warps, ck.WARP).any(dim=2)
    steps = torch.full((warps,), T, device=live.device)
    for k in range(T, 0, -1):
        if k % 12 == 0 or (w + k) % chunk == 0:
            steps = torch.where(live[k - 1], steps, torch.full_like(steps, k))
    return steps


# ---------------------------------------------------------------------------
# the invariant, on the plain month step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SETS))
def test_a_ruined_path_is_a_fixed_point_of_the_retirement_month(name):
    """Rows k and k + 1 stop after k and k + 1 retirement months, so on a
    path ruined within row k's months, row k + 1's last state is one more
    retirement month of row k's: every field of the carry is unchanged.
    W is a whole number of years, so no row's last month is a terminal
    settle. A fixed-nominal stream's slot may still freeze its amount after
    the ruin: it feeds only the month's need, which a ruined path never
    spends, and the balances and flags below hold the outputs to that."""
    eng = _engine(**dict(SETS[name]))
    W, T, n = 24, 60, 512
    out = kernel.simulate(_rows(eng, W, [W + k for k in range(1, T + 1)]),
                          eng.statics, eng.retirement_years, n, carry=True)
    carry = out["carry"]
    ruined = carry["alive"][:-1] < 0.5
    assert float(ruined.double().mean()) > 0.05  # the rows are ruined early
    fields = [key for key in carry if not key.startswith("fixed")]
    assert {"b1", "c1", "b2", "c2", "infl", "alive"} <= set(fields)
    for key in fields:
        before, after = carry[key][:-1], carry[key][1:]
        assert torch.equal(after[ruined], before[ruined]), key
    assert torch.equal(out["final_balance"][1:][ruined],
                       out["final_balance"][:-1][ruined])


# ---------------------------------------------------------------------------
# the counter's meaning, on the plain loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,n,w", [("config.json", 512, 12), ("config.json", 1_000, 7),
                                      ("bills", 1_000, 12), ("mortality", 777, 30)])
def test_plain_steps_count_the_months_each_warp_runs(name, n, w):
    """The plain loop's steps equal the months a warp runs by the rule the
    kernels follow, derived here from each path's alive flag after every
    retirement month (rows truncated month by month): a warp looks at the
    end of each retirement year and of each chunk its launch draws at once
    (48 months for 3 rows, 64 for 60). A ragged last warp counts its real
    paths only."""
    eng = _engine(**dict(SETS[name]))
    T = 120
    trunc = kernel.simulate(_rows(eng, w, [w + k for k in range(1, T + 1)]),
                            eng.statics, eng.retirement_years, n)
    full = kernel.simulate(_rows(eng, w, [w + T] * 3), eng.statics,
                           eng.retirement_years, n)
    chunks = [ck.tile_plan(k, n, eng.statics, "probe").months_per_chunk
              for k in (3, T)]
    assert chunks == [48, 64]
    per_warp = _steps_from_alive(trunc["success"], w, chunks[0])
    assert int(per_warp.min()) < T  # warps stop before their rows end
    assert full["steps"].tolist() == [int(per_warp.sum())] * 3
    # each truncated row ran its own months' share of the same rule
    per_warp = _steps_from_alive(trunc["success"], w, chunks[1])
    want = [int(torch.minimum(per_warp, torch.tensor(k)).sum())
            for k in range(1, T + 1)]
    assert trunc["steps"].tolist() == want


def test_plain_steps_skip_most_of_a_ruined_probe_and_none_of_a_live_one():
    n, R = 256, 50
    ruined = _engine()
    out = ck.probe_plain(ruined._pack([0] * 16, "search"), ruined.statics, R, n)
    assert int(out.counts.sum()) == 0
    every = ck.body_steps_all(16, n, R)
    assert int(out.steps.sum()) <= 0.1 * every
    live = _engine(**LIVE)
    out = ck.probe_plain(live._pack(list(range(16)), "search"), live.statics, R, n)
    assert int(out.counts.min()) > 0.95 * n
    assert out.steps.tolist() == [ck.body_steps_all(1, n, R)] * 16


@pytest.mark.parametrize("rows,n,R,want", [(1, 32, 1, 12), (16, 4_096, 50, 16 * 128 * 600),
                                           (3, 1_000, 40, 3 * 32 * 480)])
def test_body_steps_all_counts_every_warp_month(rows, n, R, want):
    assert ck.body_steps_all(rows, n, R) == want


# ---------------------------------------------------------------------------
# the counter on the served path: in the survivors' copy
# ---------------------------------------------------------------------------
@pytest.fixture
def recorder():
    ck.reset_counts()
    profiling.enable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()
    ck.reset_counts()


def _syncs(what):
    return [s["attrs"] for s in profiling.drain()
            if s["name"] == "card.sync" and s["attrs"].get("what") == what]


@pytest.mark.parametrize("backend", ["pallas", "scan"])
def test_probe_brings_its_steps_back_with_the_survivors(recorder, backend):
    eng = _engine()
    n, months = 500, [0, 0, 36]
    pct = eng.probe(months, n, backend=backend)
    assert pct == [0.0, 0.0, 0.0]
    kind = "probe" if backend == "pallas" else "scan"
    run, every = ck.BODY_STEPS[kind]
    assert every == ck.body_steps_all(16, n, eng.retirement_years)
    assert 16 <= run < 0.1 * every  # the padded rows repeat W = 36
    if backend == "pallas":
        assert _syncs("probe") == [{"what": "probe", "steps_run": run,
                                    "steps_all": every}]
    ck.reset_counts()
    assert ck.BODY_STEPS == {"probe": [0, 0], "grid": [0, 0], "scan": [0, 0],
                             "decided": [0, 0], "accum": [0, 0]}


def test_grid_brings_its_steps_back_in_its_table(recorder):
    configs = [chip_smoke._config(monthly_expenses=e) for e in (14_000.0, 4_000.0)]
    n = 256
    res = run_scenario_grid(configs, [0, 231], n, seed=3, device="cpu",
                            chunk_size=1)
    assert res.final_balance_percentiles.shape == (2, 5)
    syncs = _syncs("grid")
    assert len(syncs) == 2
    R = configs[0].retirement_years
    assert [s["steps_all"] for s in syncs] == [ck.body_steps_all(1, n, R)] * 2
    ruined, live = (s["steps_run"] for s in syncs)
    assert ruined < 0.1 * ck.body_steps_all(1, n, R) and live == ck.body_steps_all(1, n, R)
    assert ck.BODY_STEPS["grid"] == [ruined + live, 2 * ck.body_steps_all(1, n, R)]
    assert res.success_probability[0] == 0.0 and res.success_probability[1] > 90.0


# ---------------------------------------------------------------------------
# the kernels, on the card
# ---------------------------------------------------------------------------
N_CARD = 65_536


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tiled kernels run only there")
    return torch.device("cuda")


def _grid_block(exps, means, months, device):
    from monte_carlo_retirement_tpu_torch.models.retirement import stack_params

    configs = [chip_smoke._config(monthly_expenses=float(e), inv1_returns_mean=float(m))
               for e, m in zip(exps, means)]
    st = ck.statics_from_config(configs[0])
    packed = ck.pack_grid(stack_params(configs), 7, months,
                          configs[0].retirement_years, device=device)
    return packed, st, configs[0].retirement_years


def _case(name, device):
    """(kind, packed, statics, R, months) of a launch whose rows are ruined
    early: the household at W = 0 x 16 (the search's first probe) and at
    W = 12 .. 192 (its second), the grid's chunk at expenses 14,000 over
    equity means 0.06-0.14, and a grid launch of 17 rows, in blocks of 9
    and 8 rows (and a rowless warp), ruined rows at W = 0 beside live ones
    at W = 231."""
    means = np.linspace(0.06, 0.14, 16)
    if name.startswith("probe"):
        eng = _engine(device)
        months = [0] * 16 if name == "probe_w0" else list(range(12, 193, 12))
        return "probe", eng._pack(months, "search"), eng.statics, eng.retirement_years, months
    if name == "grid_14000":
        months = [231] * 16
        return ("grid", *_grid_block([14_000.0] * 16, means, months, device), months)
    months = [0 if i % 2 == 0 else 231 for i in range(17)]
    exps = [14_000.0 if i % 2 == 0 else 4_000.0 for i in range(17)]
    return ("grid", *_grid_block(exps, list(means) + [0.1], months, device), months)


def _full_rows(kind, packed, st, R, months, n):
    """The full kernel, which runs every month of every path, row by row:
    success, final balance and the steps its months of ruin imply."""
    T = 12 * R
    chunk = ck.tile_plan(len(months), n, st, kind).months_per_chunk
    k = torch.arange(1, T + 1, device=packed.device)[:, None]
    success, final, steps = [], [], []
    for row, w in enumerate(months):
        fp = packed.fp if kind == "probe" else packed.fp[row].contiguous()
        one = ck.Packed(fp=fp, ip=packed.ip[row:row + 1].contiguous(),
                        n_streams=packed.n_streams)
        out = ck.simulate_full(one, st, R, n, 2 + (w + T) // 12)
        # years_to_ruin: the retirement months a ruined path began alive
        ytr = out["years_to_ruin"]
        ruin = torch.where(torch.isnan(ytr), torch.full_like(ytr, T + 1),
                           torch.round(ytr * 12))
        steps.append(int(_steps_from_alive((ruin > k).double(), w, chunk).sum()))
        success.append(out["success"])
        final.append(out["final_balance"])
    return torch.stack(success), torch.stack(final), steps


@pytest.mark.card
@pytest.mark.parametrize("name", ["probe_w0", "probe_w12_192", "grid_14000",
                                  "grid_mixed_17"])
def test_tiled_kernels_skip_ruined_warps_exactly(card, name):
    from monte_carlo_retirement_tpu_torch.hosts import fuzz

    kind, packed, st, R, months = _case(name, card)
    launch = ck.probe if kind == "probe" else ck.grid
    out = launch(packed, st, R, N_CARD)
    success, final, steps = _full_rows(kind, packed, st, R, months, N_CARD)
    assert torch.equal(out.success, success)
    assert torch.equal(out.final_balance, final)
    assert out.steps.tolist() == steps
    assert int(out.steps.sum()) < ck.body_steps_all(len(months), N_CARD, R)
    plain = (ck.probe_plain if kind == "probe" else ck.grid_plain)(packed, st, R, N_CARD)
    every = torch.ones(N_CARD, dtype=torch.bool, device=card)
    assert fuzz.compare_rows(out, plain, every)["ok"]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_rows_kernel_skips_ruined_warps_exactly(card, dtype):
    from monte_carlo_retirement_tpu_torch.hosts import fuzz

    eng = _engine()
    R = eng.retirement_years
    months = [0] * 8 + list(range(12, 97, 12))
    rows, st = kernel.scan_block(eng.params, months, R, dtype, device=card)
    key, t_scan = eng._key("search"), eng._t_scan(max(months))
    out = ck.scan_rows(rows, st, R, N_CARD, key, t_scan=t_scan)
    full = [ck.scan_full(kernel.scan_block(eng.params, [w], R, dtype, statics=st,
                                           device=card)[0],
                         st, R, N_CARD, 2 + (w + 12 * R) // 12, key, t_scan=t_scan)
            for w in months]
    assert torch.equal(out.success, torch.stack([f["success"] for f in full]))
    assert torch.equal(out.final_balance, torch.stack([f["final_balance"] for f in full]))
    plain = ck.scan_rows_plain(rows, st, R, N_CARD, key, t_scan=t_scan)
    assert int(out.steps.sum()) < 0.5 * ck.body_steps_all(len(months), N_CARD, R)
    if dtype == torch.float64:  # the float64 kernel is the chain's bits
        assert torch.equal(out.success, plain.success)
        assert torch.equal(out.final_balance, plain.final_balance)
        assert torch.equal(out.steps, plain.steps)
    else:
        every = torch.ones(N_CARD, dtype=torch.bool, device=card)
        assert fuzz.compare_rows(out, plain, every)["ok"]


@pytest.mark.card
def test_the_counter_reads_the_skip(card):
    n, R = N_CARD, 50
    ruined = _engine(card)
    out = ck.probe(ruined._pack([0] * 16, "search"), ruined.statics, R, n)
    assert int(out.steps.sum()) <= 0.1 * ck.body_steps_all(16, n, R)
    live = _engine(card, **LIVE)
    out = ck.probe(live._pack(list(range(16)), "search"), live.statics, R, n)
    assert out.steps.tolist() == [ck.body_steps_all(1, n, R)] * 16
