"""The tiled launches of the probe and grid kernels, checked on the CPU.

``cuda_kernel.tile_plan`` decides how ``probe_kernel`` and ``grid_kernel``
(``engine/csrc/month_loop.cu``) cover K rows x n paths; ``TilePlan.cell``
mirrors the kernels' (block, thread) -> (row, path) map, so enumerating it
here shows what the card runs: every (row, path) once, threads per block a
whole number of warps, shared memory within a block's 227 KB. The work
count behind the bound (``tile_work``, ``engine/bound.py``) is held to the
same enumeration, and the SASS pricing to hand-made listings.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import _build, bound  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402

ROWS = (1, 3, 11, 16, 17)
PATHS = (1_000, 4_097, 65_536)
SLICE = ck.Statics(True, True, False, False, (True,), (False,))


def _statics_under_test():
    """config.json's Statics, each extension alone (six streams among
    them) and chip_smoke.ALL_ON."""
    configs = {"config.json": chip_smoke._config()}
    configs.update({name: chip_smoke._config(**dict(over))
                    for name, over in chip_smoke.EXTENSIONS.items()})
    configs["all-on"] = chip_smoke._config(**dict(chip_smoke.ALL_ON))
    return {name: ck.statics_from_config(cfg) for name, cfg in configs.items()}


STATICS = _statics_under_test()


def _cells(plan):
    """(row, path, block index) of every thread of the launch."""
    gx, gy = plan.grid
    bx, by, tid = np.meshgrid(np.arange(gx), np.arange(gy),
                              np.arange(plan.threads), indexing="ij")
    row, path = plan.cell(bx.ravel(), by.ravel(), tid.ravel())
    return row, path, (by * gx + bx).ravel()


@pytest.mark.parametrize("kind", ["probe", "grid"])
@pytest.mark.parametrize("n", PATHS)
@pytest.mark.parametrize("K", ROWS)
def test_tile_plan_covers_every_row_and_path_once(K, n, kind):
    plan = ck.tile_plan(K, n, SLICE, kind)
    assert plan.threads % ck.WARP == 0
    assert plan.threads <= 512  # the kernels' launch bound, <= 1024
    row, path, _ = _cells(plan)
    real = (row < K) & (path < n)
    keys = row[real].astype(np.int64) * n + path[real]
    assert keys.size == K * n
    assert np.array_equal(np.sort(keys), np.arange(K * n))
    # Padding is only a ragged path edge or a short last group of rows.
    assert row.max() < plan.grid[1] * plan.rows_per_block
    assert path.max() < plan.grid[0] * ck.WARP


@pytest.mark.parametrize("K,rows_per_block,months", [
    (1, 1, 16), (3, 3, 48), (11, 11, 64), (16, 16, 64), (17, 9, 64),
])
def test_tile_plan_shapes(K, rows_per_block, months):
    """Rows split into the fewest even groups of at most 16, one warp of
    32 paths per row; 16 months per row in the draw tile, up to 64."""
    plan = ck.tile_plan(K, 1_000_000, SLICE, "probe")
    assert (plan.rows_per_block, plan.months_per_chunk) == (rows_per_block, months)
    assert plan.threads == 32 * rows_per_block
    # each warp holds one row and 32 consecutive paths
    for tid in range(0, plan.threads, ck.WARP):
        cells = [plan.cell(0, 0, tid + lane) for lane in range(ck.WARP)]
        assert len({r for r, _ in cells}) == 1
        assert [p for _, p in cells] == list(range(32))


@pytest.mark.parametrize("name", sorted(STATICS))
def test_tile_shared_memory_fits_a_block(name):
    st = STATICS[name]
    for kind, K in itertools.product(("probe", "grid"), ROWS):
        plan = ck.tile_plan(K, 1_000_000, st, kind)
        assert plan.smem_bytes <= 227 * 1024  # a block's shared memory
        want = 5 if kind == "grid" and st.jumps else 3
        assert plan.fields == want
        # the sweep's wider tiles fit too
        assert plan._replace(rows_per_block=8).smem_bytes <= 227 * 1024


@pytest.mark.parametrize("rows,n,kind", [(0, 100, "probe"), (4, 0, "grid"),
                                         (4, 100, "scan")])
def test_tile_plan_refuses_what_the_kernel_cannot_launch(rows, n, kind):
    with pytest.raises(ValueError):
        ck.tile_plan(rows, n, SLICE, kind)


@pytest.mark.parametrize("K,n", [(1, 4_097), (3, 1_000), (11, 4_097),
                                 (16, 1_000), (17, 4_097)])
def test_tile_work_counts_draws_per_block_and_body_per_row(K, n):
    rng = np.random.default_rng(K * n)
    w = rng.integers(0, 481, size=K)
    t_end = w + 12 * rng.integers(1, 51, size=K)
    plan = ck.tile_plan(K, n, SLICE, "grid")
    work = ck.tile_work(plan, w, t_end)
    row, path, block = _cells(plan)
    real = (row < K) & (path < n)
    block, path, rows = block[real], path[real], row[real]
    t_max = np.zeros(block.max() + 1, dtype=np.int64)
    np.maximum.at(t_max, block, t_end[rows])
    pairs = np.unique(block.astype(np.int64) * n + path)  # (block, path) once
    assert work["draws"] == int(t_max[pairs // n].sum())
    assert work["accum"] == int(w[rows].sum())
    assert work["retire"] == int((t_end - w)[rows].sum())
    # A probe under a glide path accumulates per row too; without one it
    # accumulates once per path, to the rows' largest W.
    glide = SLICE._replace(glide=True)
    assert ck.tile_work(ck.probe_plan(K, n, glide), w, t_end) == work
    shared = ck.tile_work(ck.probe_plan(K, n, SLICE), w, t_end)
    assert shared["accum"] == n * int(w.max()) <= work["accum"]
    assert shared["retire"] == work["retire"]


def test_tile_work_shares_draws_across_the_rows_of_a_block():
    """16 candidates of one block draw once; the 17th row's group draws
    again, to its own largest t_end."""
    n = 8_192
    w = list(range(17))
    t_end = [v + 600 for v in w]
    one = ck.tile_work(ck.tile_plan(16, n, SLICE, "probe"), w[:16], t_end[:16])
    assert one["draws"] == n * 615
    assert one["retire"] == 16 * n * 600
    two = ck.tile_work(ck.tile_plan(17, n, SLICE, "probe"), w, t_end)
    assert two["draws"] == n * (608 + 616)
    # The probe's own plan: the accumulation pass draws months 1..15 (1..16)
    # once per path; a block draws from its rows' smallest W + 1 (blocks of
    # 9 and 8 rows: W 0-8 and 9-16).
    one = ck.tile_work(ck.probe_plan(16, n, SLICE), w[:16], t_end[:16])
    assert one["draws"] == n * (15 + 615) and one["accum"] == n * 15
    two = ck.tile_work(ck.probe_plan(17, n, SLICE), w, t_end)
    assert two["draws"] == n * (16 + 608 + 616 - 9)


@pytest.mark.parametrize("K,n", [(1, 4_097), (3, 1_000), (11, 4_097),
                                 (16, 1_000), (17, 4_097)])
def test_tile_work_counts_shared_accumulation_once_per_path(K, n):
    """The probe without a glide path: the accumulation pass draws and
    runs months 1..max W once per path; each block draws from its rows'
    smallest W + 1 to their largest t_end; retirement as per row."""
    rng = np.random.default_rng(K * n + 1)
    w = rng.integers(0, 481, size=K)
    t_end = w + 12 * rng.integers(1, 51, size=K)
    plan = ck.probe_plan(K, n, SLICE)
    work = ck.tile_work(plan, w, t_end)
    row, path, block = _cells(plan)
    real = (row < K) & (path < n)
    block, path, rows = block[real], path[real], row[real]
    t_max = np.zeros(block.max() + 1, dtype=np.int64)
    np.maximum.at(t_max, block, t_end[rows])
    w_lo = np.full(block.max() + 1, 10**9, dtype=np.int64)
    np.minimum.at(w_lo, block, w[rows])
    pairs = np.unique(block.astype(np.int64) * n + path)
    assert work["accum"] == n * int(w.max())
    assert work["draws"] == n * int(w.max()) + int(
        (t_max - w_lo)[pairs // n].sum())
    assert work["retire"] == int((t_end - w)[rows].sum())


def test_launch_checks_its_plan_before_building():
    packed = ck.Packed(fp=torch.zeros(ck.F.NUM + 5),
                       ip=torch.zeros((2, ck.NUM_IPARAMS), dtype=torch.int32),
                       n_streams=1)
    with pytest.raises(ValueError, match="does not tile"):
        ck._launch_rows("mcrt_probe", packed, SLICE, 100,
                        ck.tile_plan(3, 100, SLICE, "probe"))


# ---------------------------------------------------------------------------
# the bound: SASS priced by pipe
# ---------------------------------------------------------------------------
def _listing(kernels):
    """A cuobjdump -sass listing of kernels given as (name, [instructions]);
    each ends in EXIT and its trap loop, then a slow-path subroutine."""
    lines = ["\tcode for sm_90a"]
    for name, instrs in kernels:
        lines.append(f"\t\tFunction : {name}")
        addr = 0
        for ins in instrs + ["EXIT"]:
            lines.append(f"        /*{addr:04x}*/                   {ins} ;"
                         "   /* 0x000fe20000000800 */")
            lines.append("                                          /* 0x000fc00000000000 */")
            addr += 16
        lines.append(".L_x_9:")
        lines.append(f"        /*{addr:04x}*/                   BRA `(.L_x_9);")
        lines.append(".L_x_10:")
        lines.append(f"        /*{addr + 16:04x}*/                   FFMA R1, R2, R3, R4 ;")
        lines.append(f"        /*{addr + 32:04x}*/                   RET.REL.NODEC R4 `({name}) ;")
    return "\n".join(lines)


@pytest.mark.parametrize("opcode,pipe", [
    ("FFMA", "fp32"), ("FADD.FTZ", "fp32"), ("HFMA2.MMA", "fp32"),
    ("DFMA", "fp64"), ("DADD", "fp64"), ("DMUL", "fp64"),
    ("DSETP.GEU.AND", "fp64"), ("MUFU.RCP64H", "xu"), ("F2F.F64.F32", "xu"),
    ("IMAD.HI.U32", "imad"), ("IMAD.WIDE", "imad"), ("MUFU.EX2", "xu"),
    ("I2F.U32", "xu"), ("F2I.TRUNC", "xu"), ("LOP3.LUT", "alu"),
    ("FSETP.GT.AND", "alu"), ("FMNMX", "alu"), ("SEL", "alu"),
    ("I2FP.F32.U32", "alu"), ("SHFL.BFLY", "shfl"), ("LDG.E", None),
    ("STS", None), ("LDC", None), ("ULDC.64", None), ("BRA", None),
    ("EXIT", None), ("S2R", None), ("BAR.SYNC", None), ("NOP", None),
])
def test_sass_opcodes_go_to_their_pipes(opcode, pipe):
    assert bound.pipe_of(opcode) == pipe


def test_sass_pipes_count_the_main_body_only():
    sass = _listing([
        ("count_a", ["LDG.E R2, desc[UR4][R2.64]", "IMAD.HI.U32 R3, R2, 0x3, RZ",
                     "@!P0 FFMA R4, R3, R2, R1", "MUFU.LG2 R5, R4",
                     "LOP3.LUT R6, R5, R3, RZ, 0x96, !PT", "STG.E desc[UR4][R2.64], R6"]),
        ("count_b", ["FADD R1, R2, R3", "FMUL R1, R1, R1"]),
    ])
    pipes = bound.sass_pipes(sass)
    assert pipes["count_a"] == {"fp32": 1, "fp64": 0, "imad": 1, "alu": 1,
                                "xu": 1, "shfl": 0}
    assert pipes["count_b"] == {"fp32": 2, "fp64": 0, "imad": 0, "alu": 0,
                                "xu": 0, "shfl": 0}


def test_loads_take_the_busiest_pipe_and_share_the_fma_pipe():
    out = bound.loads({"fp32": 64, "imad": 64, "alu": 32, "xu": 16, "shfl": 0})
    assert out["fma"] == pytest.approx((64 + 64) / 128)
    assert out["imad"] == pytest.approx(1.0)
    assert out["xu"] == pytest.approx(1.0)
    assert out["issue"] == pytest.approx(176 / 128)


def test_part_loads_charge_yearly_code_once_in_twelve_months():
    body = {name: ["FFMA R1, R2, R3, R4"] * 24 for name in bound.PARTS}
    body["count_retire"] = ["FFMA R1, R2, R3, R4"] * 48  # the yearly branches
    parts = bound.part_loads(_listing(list(body.items())))
    assert parts["retire"]["fp32"] == pytest.approx((24 + 24 / 12) / 128)
    assert parts["accum"]["fp32"] == pytest.approx(24 / 128)
    with pytest.raises(ValueError, match="missing"):
        bound.part_loads(_listing([("count_draw_probe", ["FADD R1, R2, R3"])]))


def test_bound_shares_the_draw_and_charges_the_body_per_row():
    """A probe of 16 rows pays the draw once per path-month; the full
    kernel's one row pays it every month; bytes bind only a tiny launch."""
    one = {"fp32": 0.0, "imad": 0.0, "alu": 0.0, "xu": 0.0, "shfl": 0.0,
           "fma": 0.0, "issue": 0.0}
    parts = {k: dict(one) for k in ("draw_probe", "draw_grid", "growth",
                                    "accum", "retire", "retire_track")}
    parts["draw_probe"]["issue"] = 3.0
    parts["retire"]["issue"] = 1.0
    parts["retire_track"]["issue"] = 1.5
    n, K, months = 1_000, 16, 600
    work = {"draws": n * months, "accum": 0, "retire": K * n * months}
    ms, by = bound.bound_ms("probe", work, parts, 8 * K * n, 100, 1e9)
    assert by == "operations"
    assert ms == pytest.approx((n * months * 3.0 + K * n * months) / 1e11 * 1e3)
    full = bound.full_work(n, 0, months)
    ms_full, _ = bound.bound_ms("full", full, parts, 0, 100, 1e9)
    assert ms_full == pytest.approx(n * months * 4.5 / 1e11 * 1e3)
    ms_bytes, by = bound.bound_ms("probe", {"draws": 1, "accum": 0, "retire": 1},
                                  parts, 3_350_000, 100, 1e9)
    assert by == "bytes" and ms_bytes == pytest.approx(1e-3)


def test_count_unit_is_built_beside_the_library():
    unit = _build.statics_unit(SLICE, "op_count.cu")
    assert unit.endswith('#include "op_count.cu"\n')
    assert unit.replace("op_count.cu", "month_loop.cu") == _build.statics_unit(SLICE)
    assert _build.count_path(SLICE).suffix == ".cubin"
    assert _build.count_path(SLICE).parent == _build.library_path(SLICE).parent
    assert "op_count.cu" in _build.SOURCES
