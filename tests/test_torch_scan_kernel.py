"""The scan kernel's host side, held on the CPU to JAX and to the port.

The scan kernels (``engine/csrc/month_loop.cu``: ``scan_rows_kernel``,
``scan_full_kernel``) draw JAX's threefry stream in the kernel
(``csrc/threefry.cuh``) from a key table that the wrapper computes on the
host (``cuda_kernel.scan_keys``). A CUDA kernel does not run here, so this
file holds what can be checked without a card:

* the key table equals ``jax.random.fold_in`` / ``split`` for three seeds,
  months 1 and 600 and both fold offsets;
* a per-element model of the kernel's draw indexing -- global row g,
  month m, plane j -> the hashed flat index, the words, the uniform and
  the normal, written as ``threefry.cuh`` computes them -- equals
  ``ScanDraws`` and JAX's ``monthly_shocks`` / ``monthly_jump_draws`` /
  ``mortality_uniform`` element for element (words and uniforms exactly;
  normals exactly against the port, within JAX's CPU ulps against JAX),
  with antithetic pairing over an odd count from an odd row offset, and at
  flat indices above 2**32;
* dispatch: a CPU ``scan_rows`` runs the plain chain and counts it, a
  block that claims the card raises here and falls back to nothing, and
  ``sensitivity_ad(backend="scan")`` runs the plain chain by name
  (``kernel.scan_chain``), counted as ``"ad"``;
* one library per (Statics, dtype, draws) with the Philox unit unchanged;
* the bound's work count of a scan launch, from its shapes, and its
  pricing of the erfinv bands (band 0 for every normal, each colder band
  at the share of the uniforms that reach it);
* the plain chain's aten ops and bytes a month (``chain_traffic``, the
  count behind PERF.md's account of the chain's time);
* the plain chain's probe mode with the accumulation cap below a row's W
  (a short scan) against JAX's ``simulate_paths``, in float64.

The kernels themselves are held to the plain chain on the card
(``chip_smoke.py`` phase 14b).
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jax_prng  # noqa: E402

import chip_smoke  # noqa: E402
from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine.kernel import (  # noqa: E402
    simulate_paths as jax_simulate_paths,
)
from monte_carlo_retirement_tpu.models.retirement import (  # noqa: E402
    SimParams as JaxParams,
)
from monte_carlo_retirement_tpu.ops import shocks as jshocks  # noqa: E402
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import _build, bound  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import kernel  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.sensitivity import (  # noqa: E402
    sensitivity_ad,
)
from monte_carlo_retirement_tpu_torch.models.retirement import (  # noqa: E402
    SimParams,
)
from monte_carlo_retirement_tpu_torch.ops import shocks  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import threefry as tf  # noqa: E402

torch.set_num_threads(2)

SEEDS = (0, 2026, 2**40 + 3)
MONTHS = (1, 600)
MASK = 0xFFFFFFFF
SLICE = ck.Statics(True, True, False, False, (True,), (False,))
ULPS_JAX = {torch.float32: 4, torch.float64: 32}  # XLA's CPU log1p / sqrt


def _jkey(seed):
    return jshocks.stream_keys(seed)[1]


def _key(jkey) -> tuple:
    return tuple(int(v) for v in np.asarray(jkey))


def _row(table, m) -> list:
    return [int(v) & MASK for v in table[m].tolist()]


# ---------------------------------------------------------------------------
# the host's key table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_key_table_equals_jax_fold_in_and_split(seed):
    jk = _jkey(seed)
    key = shocks.stream_keys(seed)[1]
    assert key == _key(jk)
    table = ck.scan_keys(key, max(MONTHS), jumps=True, mortality=True)
    assert table.shape == (max(MONTHS) + 1, 6) and table.dtype == torch.int32
    for m in MONTHS:
        row = _row(table, m)
        assert tuple(row[:2]) == _key(jax.random.fold_in(jk, m))
        ku, kz = jax.random.split(
            jax.random.fold_in(jk, shocks.JUMP_FOLD_OFFSET + m))
        assert tuple(row[2:4]) == _key(ku)
        assert tuple(row[4:6]) == _key(kz)
    mort = _key(jax.random.fold_in(jk, shocks.MORT_FOLD_OFFSET))
    assert tuple(_row(table, 0)) == mort + (0, 0, 0, 0)


def test_key_table_leaves_unused_keys_zero_and_is_cached():
    key = shocks.stream_keys(7)[1]
    table = ck.scan_keys(key, 30)
    assert not table[:, 2:].any() and not table[0].any()
    assert ck.scan_keys(key, 30) is table
    assert not torch.equal(ck.scan_keys(key, 30, jumps=True)[1:, 2:],
                           table[1:, 2:])


# ---------------------------------------------------------------------------
# a per-element model of threefry.cuh's draw indexing
# ---------------------------------------------------------------------------
def _model_words(key, idx: int):
    """threefry.cuh tf_words: the (hi, lo) counter of a 64-bit flat index."""
    return tf.threefry2x32(key, idx >> 32, idx & MASK)


def _model_uniform(y, dtype) -> float:
    y0, y1 = y
    if dtype == torch.float32:
        unit = np.array([((y0 ^ y1) >> 9) | 0x3F800000], np.uint32).view(np.float32)
        return float(unit[0] - np.float32(1.0))
    mant = (y0 << 20) | (y1 >> 12)
    unit = np.array([mant | 0x3FF0000000000000], np.uint64).view(np.float64)
    return float(unit[0] - 1.0)


def _model_normal(y, dtype) -> float:
    """tf_normal: max(lo, f * 2 + lo), XLA's erfinv, times sqrt(2), each op
    rounded in ``dtype``."""
    npt = np.float32 if dtype == torch.float32 else np.float64
    f = npt(_model_uniform(y, dtype))
    lo = np.nextafter(npt(-1.0), npt(0.0))
    u = max(lo, npt(f * npt(2.0)) + lo)
    z = tf.erfinv(torch.tensor([float(u)], dtype=dtype))
    return float(z[0] * torch.tensor(float(np.sqrt(npt(2.0))), dtype=dtype))


def _model_draws(table, g: int, m: int, antithetic: bool, dtype):
    """ScanPath<T, ANTITHETIC> at global row g, month m: (z_eq, z_ind,
    z_prem), crash (u, z), longevity u, and the month words."""
    r, odd = (g >> 1, g & 1) if antithetic else (g, 0)
    row = _row(table, m)
    words = [_model_words(row[:2], 3 * r + j) for j in range(3)]
    z = [_model_normal(w, dtype) for w in words]
    u = _model_uniform(_model_words(row[2:4], r), dtype)
    zj = _model_normal(_model_words(row[4:6], r), dtype)
    mort = _model_uniform(_model_words(_row(table, 0)[:2], r), dtype)
    if odd:
        z = [-v for v in z]
        zj = -zj
        u = float(torch.tensor(1.0, dtype=dtype) - torch.tensor(u, dtype=dtype))
        mort = float(torch.tensor(1.0, dtype=dtype)
                     - torch.tensor(mort, dtype=dtype))
    return z, (u, zj), mort, words


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("antithetic", (False, True))
def test_model_of_the_kernel_draws_equals_scan_draws_and_jax(dtype, antithetic):
    seed, n, offset = 2026, 37, 5  # odd count from an odd global row
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    key = shocks.stream_keys(seed)[1]
    table = ck.scan_keys(key, 600, jumps=True, mortality=True)
    draws = kernel.ScanDraws(key, n, dtype, antithetic=antithetic, jumps=True,
                             row_offset=offset)
    mort_port = draws.mortality().numpy()
    n_all = offset + n  # JAX draws the whole batch; the shard is its tail
    mort_jax = np.asarray(jshocks.mortality_uniform(_jkey(seed), n_all, jdtype,
                                                    antithetic))[offset:]
    for m in MONTHS:
        port = draws(m).numpy()  # (5, n): z_eq, z_ind, z_prem, u, z_j
        z_eq, z_inf, z_prem = (np.asarray(v)[offset:] for v in jshocks.monthly_shocks(
            _jkey(seed), m, n_all, 0.0, jdtype, antithetic))
        ju, jz = (np.asarray(v)[offset:] for v in jshocks.monthly_jump_draws(
            _jkey(seed), m, n_all, jdtype, antithetic))
        jax_planes = np.stack([z_eq, z_inf, z_prem, ju, jz])  # rho = 0: z_ind
        words_jax = np.asarray(jax.random.bits(jax.random.fold_in(_jkey(seed), m),
                                               ((n_all + 1) // 2 if antithetic
                                                else n_all, 3), jnp.uint32))
        for p in range(n):
            g = offset + p
            z, (u, zj), mort, words = _model_draws(table, g, m, antithetic, dtype)
            model = np.array(z + [u, zj])
            r = g >> 1 if antithetic else g
            assert [w0 ^ w1 for w0, w1 in words] == [int(v) for v in words_jax[r]]
            # The port's chain: every value exactly (same ops, same libm).
            np.testing.assert_array_equal(model, port[:, p])
            assert mort == mort_port[p]
            # JAX: uniforms exactly, normals within XLA's CPU ulps.
            assert u == ju[p] and mort == mort_jax[p]
            normals = model[[0, 1, 2, 4]]
            want = jax_planes[[0, 1, 2, 4], p]
            ulps = np.abs(normals - want) / np.spacing(np.abs(want))
            assert ulps.max() <= ULPS_JAX[dtype], (m, p, ulps)


@pytest.mark.parametrize("g", (2**31 + 11, 1_431_655_766, 3 * 2**31 + 1))
def test_model_words_above_two_to_the_32(g):
    """The flat index 3r + j passes 2**32 near 1.43G rows: the counter is
    built from the 64-bit index, as JAX's partitionable threefry does."""
    key = shocks.stream_keys(2026)[1]
    table = ck.scan_keys(key, 5)
    row = _row(table, 5)
    jkey = jnp.asarray(row[:2], dtype=jnp.uint32)
    for j in range(3):
        idx = 3 * g + j
        assert idx >= 2**32
        y0, y1 = _model_words(row[:2], idx)
        want = np.asarray(jax_prng.threefry_2x32(
            jkey, jnp.asarray([idx >> 32, idx & MASK], dtype=jnp.uint32)))
        assert (y0, y1) == (int(want[0]), int(want[1]))
        port = tf.random_words(row[:2], (1, 3), row_offset=g)
        assert [int(w[0, j]) for w in port] == [y0, y1]


# ---------------------------------------------------------------------------
# dispatch and counts
# ---------------------------------------------------------------------------
def _cfg(**over):
    raw = chip_smoke._raw_config(**over)
    raw.update(retirement_years=4, monthly_expenses=6_000.0)
    return Config(**json.loads(json.dumps(raw)))


def test_cpu_scan_rows_runs_the_plain_chain_and_counts_it():
    params = SimParams.from_config(_cfg())
    key = shocks.stream_keys(3)[1]
    ck.reset_counts()
    rows = kernel.scan_rows(params, [10, 20], key, n_paths=64, t_scan=120,
                            retirement_years=4, dtype=torch.float64)
    assert ck.PLAIN_CALLS["scan"] == 1 and not any(ck.LAUNCHES.values())
    full = kernel.scan_rows(params, [10], key, n_paths=64, t_scan=120,
                            retirement_years=4, dtype=torch.float64,
                            traj_len=11)
    assert ck.PLAIN_CALLS == {"probe": 0, "grid": 0, "simulate": 0, "full": 0,
                              "scan": 2, "ad": 0}
    assert not any(ck.LAUNCHES.values())
    # The plain versions are the chain itself, uncounted by scan_chain.
    packed, statics = kernel.scan_block(params, [10, 20], 4, torch.float64,
                                         False, False, False, "cpu", None)
    out = ck.scan_rows_plain(packed, statics, 4, 64, key, t_scan=120)
    assert torch.equal(out.success, rows["success"])
    assert torch.equal(out.final_balance, rows["final_balance"])
    assert torch.equal(out.counts, (rows["success"] > 0.5).sum(dim=1))
    assert ck.PLAIN_CALLS["scan"] == 3
    assert torch.equal(full["final_balance"], rows["final_balance"][0])


def test_a_block_on_the_card_launches_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the wrappers would launch")
    import types

    params = SimParams.from_config(_cfg())
    packed, statics = kernel.scan_block(params, [10], 4, torch.float64,
                                         False, False, False, "cpu", None)
    on_card = types.SimpleNamespace(fp=packed.fp, ip=packed.ip,
                                    n_streams=packed.n_streams,
                                    device=torch.device("cuda"))
    key = shocks.stream_keys(3)[1]
    ck.reset_counts()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ck.scan_rows(on_card, statics, 4, 64, key, t_scan=120)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ck.scan_full(on_card, statics, 4, 64, 11, key, t_scan=120)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        kernel.scan_rows(params, [10], key, n_paths=64, t_scan=120,
                         retirement_years=4, dtype=torch.float64,
                         device="cuda")
    assert not any(ck.PLAIN_CALLS.values()) and not any(ck.LAUNCHES.values())
    with pytest.raises(ValueError, match="one working_months"):
        two, _ = kernel.scan_block(params, [10, 20], 4, torch.float64,
                                    False, False, False, "cpu", None)
        ck.scan_full(two, statics, 4, 64, 11, key, t_scan=120)


def test_scan_ad_runs_the_plain_chain_by_name():
    cfg = _cfg()
    ck.reset_counts()
    out = sensitivity_ad(cfg, 12, num_paths=128, seed=5,
                         params=["monthly_expenses"], device="cpu",
                         backend="scan", dtype=torch.float64)
    assert ck.PLAIN_CALLS == {"probe": 0, "grid": 0, "simulate": 0, "full": 0,
                              "scan": 0, "ad": 1}
    assert not any(ck.LAUNCHES.values())
    assert math.isfinite(out["d_mean_final"]["monthly_expenses"])


# ---------------------------------------------------------------------------
# libraries, tiles and the bound
# ---------------------------------------------------------------------------
def test_one_library_per_statics_dtype_and_draws():
    units = [_build.Unit(SLICE), _build.Unit(SLICE, "float", "threefry"),
             _build.Unit(SLICE, "double", "threefry")]
    texts = [_build.statics_unit(SLICE, "month_loop.cu", u.real, u.draws)
             for u in units]
    assert len(set(texts)) == 3
    assert len({_build.library_path(u) for u in units}) == 3
    assert len({_build.count_path(u) for u in units}) == 3
    assert _build.library_path(SLICE) == _build.library_path(units[0])
    # The Philox unit's flags stay as they were: the Statics alone.
    assert texts[0] == _build.statics_unit(SLICE) == (
        "#define MCRT_USE_REAL1 1\n#define MCRT_USE_REAL2 1\n"
        "#define MCRT_BILL1 0\n#define MCRT_BILL2 0\n"
        "#define MCRT_ANTITHETIC 0\n#define MCRT_GLIDE 0\n"
        "#define MCRT_GUARDRAILS 0\n#define MCRT_JUMPS 0\n"
        "#define MCRT_MORTALITY 0\n#define MCRT_NS 1\n"
        "#define MCRT_STREAM_KINDS 1\n#include \"month_loop.cu\"\n")
    assert "#define MCRT_THREEFRY 1" in texts[1]
    assert "MCRT_REAL_DOUBLE" not in texts[1]
    assert texts[2].endswith("#define MCRT_THREEFRY 1\n#define MCRT_REAL_DOUBLE 1\n"
                             "#include \"month_loop.cu\"\n")
    assert _build._unit_flags(units[2]) == ("-fmad=false",)
    assert _build._unit_flags(units[0]) == _build._unit_flags(units[1]) == ()
    with pytest.raises(ValueError, match="philox"):
        _build.statics_unit(SLICE, real="double")
    assert "threefry.cuh" in _build.SOURCES


def test_scan_tiles_hold_float64_and_fit_a_block():
    for rows, kind, jumps in ((16, "probe", False), (6, "grid", True),
                              (1, "probe", False)):
        st = SLICE._replace(jumps=jumps)
        plan = ck.tile_plan(rows, 1 << 20, st, kind, elem_bytes=8)
        f32 = ck.tile_plan(rows, 1 << 20, st, kind)
        assert plan.fields == (5 if kind == "grid" and jumps else 3)
        assert plan.smem_bytes == 8 * plan.months_per_chunk * plan.fields * 32 + 4
        assert f32.smem_bytes == 4 * (f32.months_per_chunk * f32.fields * 32 + 1)
        assert plan.smem_bytes <= 227 * 1024


def test_scan_work_follows_from_its_shapes():
    R, n = 50, 1000
    months = list(range(16))
    t_end = [w + 12 * R for w in months]
    plan = ck.tile_plan(16, n, SLICE, "probe", elem_bytes=8)
    assert not plan.accum_once  # the scan's rows accumulate per row
    cap = 660 - 12 * R  # t_scan 660
    work = ck.tile_work(plan, months, t_end, acc_cap=cap)
    assert work == {"draws": n * max(t_end), "accum": n * sum(months),
                    "retire": n * 16 * 12 * R}
    short = ck.tile_work(plan, months, t_end, acc_cap=5)
    assert short["accum"] == n * sum(min(w, 5) for w in months)
    assert short["retire"] == work["retire"] and short["draws"] == work["draws"]
    assert ck.tile_work(plan, months, t_end) == ck.tile_work(plan, months, t_end,
                                                            acc_cap=10**9)
    full = bound.full_work(n, 30, 30 + 12 * R, acc_cap=12)
    assert full == {"draws": n * (12 + 12 * R), "accum": n * 12,
                    "retire": n * 12 * R}
    assert bound.full_work(n, 30, 630) == bound.full_work(n, 30, 630, acc_cap=40)
    # Priced like any launch: the FP64 pipe at 64 lanes per SM per clock.
    zero = {k: 0.0 for k in ("fp32", "fp64", "imad", "alu", "xu", "shfl",
                             "fma", "issue")}
    parts = {k: dict(zero) for k in ("draw_probe", "draw_grid", "growth",
                                     "accum", "retire", "retire_track")}
    parts["draw_probe"].update(bound.loads({"fp64": 64, "alu": 128}))
    parts["retire"].update(bound.loads({"fp64": 128}))
    parts["accum"].update(bound.loads({"fp64": 64}))
    ms, by = bound.bound_ms("probe", work, parts, 16 * n * 16, 100, 1e9)
    # The busiest pipe over the launch: FP64 (the draw's ALU load is beside it).
    cycles = work["draws"] * 1.0 + work["retire"] * 2.0 + work["accum"] * 1.0
    assert by == "operations" and ms == pytest.approx(cycles / 1e11 * 1e3)


# ---------------------------------------------------------------------------
# the plain chain's short scan (a probe whose rows wait past the cap)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("antithetic", (False, True))
def test_short_scan_probe_rows_equal_jax(antithetic):
    """t_scan = 12 R caps accumulation at 0 months: rows W = 2 and W = 30
    wait until their W and then retire for 12 R months, as JAX's two-phase
    scan does, through months where no row accumulates or retires."""
    R, n, seed = 3, 203, 7
    raw = chip_smoke._raw_config(antithetic=antithetic)
    raw.update(retirement_years=R, monthly_expenses=3_000.0)
    raw = json.loads(json.dumps(raw))
    t_scan, months = 12 * R, [2, 30]
    got = kernel.scan_rows(SimParams.from_config(Config(**raw)), months,
                           shocks.stream_keys(seed)[1], n_paths=n,
                           t_scan=t_scan, retirement_years=R,
                           dtype=torch.float64, antithetic=antithetic)
    for k, w in enumerate(months):
        want = jax_simulate_paths(
            JaxParams.from_config(JaxConfig(**raw), dtype=jnp.float64),
            jnp.int32(w), jshocks.stream_keys(seed)[1], n_paths=n,
            t_scan=t_scan, retirement_years=R, traj_len=0, dtype=jnp.float64,
            antithetic=antithetic)
        np.testing.assert_array_equal(got["success"][k].numpy() > 0.5,
                                      np.asarray(want.success))
        np.testing.assert_allclose(got["final_balance"][k].numpy(),
                                   np.asarray(want.final_balance),
                                   rtol=1e-9, atol=1e-6)


# ---------------------------------------------------------------------------
# the bound's erfinv bands
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("real", ("float", "double"))
def test_band_shares_are_the_uniforms_beyond_each_edge(real):
    """A normal's erfinv runs band b where w = -log1p(-u^2) lies in the
    band; the shares follow from u uniform on (-1, 1), and agree with the
    bands that the port's own uniforms fall into."""
    shares = bound.band_shares(real)
    edges = bound.ERFINV_EDGES[real]
    assert len(shares) == len(edges) + 1 and sum(shares) == pytest.approx(1.0)
    assert shares[0] > 0.99 and all(x > 0 for x in shares)
    key = tf.fold_in(shocks.stream_keys(2026)[1], 1)
    u = tf.uniform(key, (2**20,), torch.float64) * 2 - 1
    w = -torch.log1p(-u * u)
    band = sum((w >= e).long() for e in edges)
    seen = [float((band == b).double().mean()) for b in range(len(shares))]
    assert seen[0] == pytest.approx(shares[0], abs=2e-4)
    assert seen[1] == pytest.approx(shares[1], rel=0.1)


@pytest.mark.parametrize("real,normals", (("float", 3), ("double", 4)))
def test_part_loads_add_each_colder_band_at_its_share(real, normals):
    """The scan unit's draw runs band 0 for every normal; each colder band
    adds its count less band 0's, times its share and the normals."""
    def _listing(kernels):  # a cuobjdump -sass listing: each body ends in EXIT
        return "\n".join(f"\t\tFunction : {name}\n" + "\n".join(
            f"        /*{16 * i:04x}*/   {ins} ;" for i, ins in
            enumerate(instrs + ["EXIT"])) for name, instrs in kernels)

    body = {name: ["DFMA R2, R4, R6, R8"] * 64 for name in bound.PARTS}
    bands = bound.BANDS[:len(bound.ERFINV_EDGES[real]) + 1]
    for b, name in enumerate(bands):
        body[name] = ["DFMA R2, R4, R6, R8"] * (40 + 10 * b) + ["MUFU.RSQ64H R1, R2"] * b
    sass = _listing(list(body.items()))
    plain = bound.part_loads(sass)
    parts = bound.part_loads(sass, normals, real)
    shares = bound.band_shares(real)
    extra_fp64 = normals * sum(s * 10 * b for b, s in enumerate(shares)) / 64
    extra_xu = normals * sum(s * b for b, s in enumerate(shares)) / 16
    for draw in ("draw_probe", "draw_grid"):
        assert parts[draw]["fp64"] == pytest.approx(plain[draw]["fp64"] + extra_fp64)
        assert parts[draw]["xu"] == pytest.approx(plain[draw]["xu"] + extra_xu)
    for other in ("growth", "accum", "retire", "retire_track"):
        assert parts[other] == plain[other]
    with pytest.raises(ValueError, match="missing"):
        bound.part_loads(_listing([(n, body[n]) for n in bound.PARTS]), 3, real)


# ---------------------------------------------------------------------------
# the plain chain's traffic (PERF.md: why the chain is slow at 16 x 2^20)
# ---------------------------------------------------------------------------
def chain_traffic(rows: int = 16, paths: int = 4096, dtype=torch.float32,
                  retirement_years: int = 50) -> dict:
    """The aten ops a month and the bytes each op reads and writes (its
    tensor inputs and outputs; a view moves none) of the scan's plain chain
    in the probe's form (config.json, rows at W = 0, 1, ...), counted by a
    ``TorchDispatchMode`` on the CPU, once for the whole chain and once for
    its draws alone. PERF.md's count is ``chain_traffic()``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        ops = moved = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops += 1
            if not func.is_view:
                self.moved += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out

    R, months = retirement_years, list(range(rows))
    raw = chip_smoke._raw_config(retirement_years=R)
    params = SimParams.from_config(Config(**json.loads(json.dumps(raw))))
    horizon = max(months) + 12 * R
    key = shocks.stream_keys(2026)[0]
    packed, statics = kernel.scan_block(params, months, R, dtype)
    with Count() as whole:
        kernel.scan_chain(packed, statics, R, paths, key,
                          t_scan=-(-horizon // 60) * 60)
    draws = kernel.ScanDraws(key, paths, dtype)
    with Count() as drawn:
        for m in range(1, horizon + 1):
            draws(m)
    cells = rows * paths * horizon
    return {"months": horizon, "ops_per_month": whole.ops / horizon,
            "draw_ops_per_month": drawn.ops / horizon,
            "bytes_per_row_path_month": whole.moved / cells,
            "draw_bytes_per_path_month": drawn.moved / (paths * horizon),
            "body_bytes_per_row_path_month": (whole.moved - drawn.moved) / cells}


def test_chain_traffic_splits_into_draws_and_body():
    """The draws' bytes (shared by the rows) and the body's add up to the
    whole, and the draws are a part of the ops."""
    c = chain_traffic(rows=2, paths=64, retirement_years=3)
    assert c["months"] == 1 + 12 * 3
    assert 0 < c["draw_ops_per_month"] < c["ops_per_month"]
    assert c["bytes_per_row_path_month"] == pytest.approx(
        c["draw_bytes_per_path_month"] / 2 + c["body_bytes_per_row_path_month"])
    assert c["body_bytes_per_row_path_month"] > 0
