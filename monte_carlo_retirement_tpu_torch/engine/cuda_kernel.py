"""The port's kernels: wrappers, plain versions and their parameter block.

Counterpart of the JAX package's ``engine/pallas_kernel.py``. Every
kernel is a form of one month loop (``csrc/month_loop.cu``):

  * :func:`probe` replaces ``pallas_probe`` (``pallas_kernel.py:1325``):
    candidate working-month counts x paths, shocks shared across
    candidates -> per-path alive flags and final balances plus the exact
    success count per candidate;
  * :func:`grid` replaces ``_scenario_grid_call`` (``pallas_kernel.py:1567``):
    the same body with one parameter row per scenario (:func:`pack_grid`),
    shocks shared across the whole grid;
  * :func:`simulate` replaces ``pallas_simulate`` (``pallas_kernel.py:1247``):
    the grid kernel launched with one row -> per-path success and final
    balance;
  * :func:`simulate_full` replaces ``pallas_simulate_full``
    (``pallas_kernel.py:1405``): the tracked loop -> seven per-path vectors
    and the yearly trajectory, price-level and withdrawal-rate series;
  * :func:`scan_rows` and :func:`scan_full` replace the compiled form of
    JAX's threefry scan, ``simulate_paths`` (``monte_carlo_retirement_tpu/
    engine/kernel.py:124``, a ``lax.scan`` that XLA fuses into one device
    loop): the probe's or the batch's rows, and the tracked run, on the
    scan's own draws (:func:`scan_keys`), in float32 or float64;
  * :func:`simulate_jvp` replaces the compiled form of JAX's forward-mode
    AD through that loop, ``jit(jacfwd(metric))``
    (``monte_carlo_retirement_tpu/engine/sensitivity.py:476-495``): one
    row's per-path final balance and its tangents along directions of the
    parameter block, on either draw source, in float32 or float64.

The probe and grid kernels draw each path-month once for all the rows of
a block and share it through shared memory; :func:`tile_plan` decides
their launch (rows and paths per block, months per draw tile) and
:func:`tile_work` counts the work behind their bound (``engine/bound.py``).
Without a glide path the probe's rows share their working years too: a
first kernel runs each path's accumulation once, to the launch's largest
W, and hands each row its carry at its own W (:func:`probe_plan`); each
launch counts those path-months against what per-row accumulation would
run (``BODY_STEPS["accum"]``).
A warp of them stops its retirement months once it finds its 32 paths
all ruined (it looks at the end of each retirement year and of each
tile), and a block its month loop once its warps are all done; each
launch counts the retirement months its warps ran (``ProbeOut.steps``,
``BODY_STEPS``), and so does each plain version; under longevity the
probe also counts those run once every path of the warp was decided
(``ProbeOut.decided``).

Beside each wrapper is its plain PyTorch version (:func:`probe_plain`,
:func:`grid_plain`, :func:`simulate_plain`, :func:`simulate_full_plain`,
:func:`scan_rows_plain`, :func:`scan_full_plain`, :func:`simulate_jvp_plain`:
thin calls into ``engine/kernel.py``, the last under ``torch.func.jvp``). A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches its kernel or
raises. ``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` plain
calls, so a run can show which path it took; the counts stay exact when
the server's engine threads launch at once.

Compile-time structure is ``Statics`` (same fields and derivation as
``pallas_kernel.Statics``): the tax system and annual mark-to-market bill
of each asset, the kind of each income stream (CPI-indexed or
fixed-nominal, capped or not), antithetic pairing, glide path, spending
guardrails, market crashes and longevity. Every Statics that the JAX
package accepts runs here; the kernels are built once per Statics on first
use (``_build.py``), with every disabled feature compiled out.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import MONTHS_PER_YEAR
from ..models.retirement import SimParams, prune_streams
from ..ops import threefry
from ..ops.shocks import JUMP_FOLD_OFFSET, MORT_FOLD_OFFSET
from ..utils import profiling
from ._build import statics_tag

# Kernel launches / plain-version calls since the last reset, changed only
# under _COUNT_LOCK (a dict increment is a read-modify-write). "scan" counts
# both scan kernels (rows and full). "ad" counts the JVP kernel's launches
# (one per TK tangents) and the calls of its plain version, the AD passes
# of engine/sensitivity.sensitivity_ad on either stream.
LAUNCHES: Dict[str, int] = {"probe": 0, "grid": 0, "simulate": 0, "full": 0,
                            "scan": 0, "ad": 0}
PLAIN_CALLS: Dict[str, int] = {"probe": 0, "grid": 0, "simulate": 0, "full": 0,
                               "scan": 0, "ad": 0}
# Retirement months the tiled month loop ran, in warp-months (one warp of
# 32 paths of one row for one month), against all it had: [run, in range]
# per kernel, since the last reset. A warp stops once its paths are all
# ruined, so run / in range is the share of the body's work left. Added
# where the program copies a launch's counts to the host (record_steps):
# the steps travel in that copy. "decided": of the probe launches under
# longevity, the months their warps ran once every path was decided
# (ruined, or solvent past its owner's death: ``ProbeOut.decided``),
# against all they had in range. "accum": of the probe launches, the
# accumulation path-months run (once per path to a launch's largest W
# without a glide path), against what per-row accumulation would run
# (:func:`accum_counts`), added at the launch.
BODY_STEPS: Dict[str, list] = {"probe": [0, 0], "grid": [0, 0], "scan": [0, 0],
                               "decided": [0, 0], "accum": [0, 0]}
_COUNT_LOCK = threading.Lock()

# Rows of a probe or grid launch: groups of rows ride gridDim.y.
MAX_ROWS = 65535

# The tiled launches of probe_kernel and grid_kernel (csrc/month_loop.cu):
# a block holds C rows x 32 paths, one warp per row, and draws M months at a
# time into a shared-memory tile that its rows share.
WARP = 32  # paths per block; 32 divides a 4096-path key block
ROWS_PER_BLOCK = 16  # most rows sharing one draw tile (512 threads)
MONTHS_PER_ROW = 16  # months per draw tile for each row of the block ...
MAX_TILE_MONTHS = 64  # ... up to this many

def reset_counts() -> None:
    with _COUNT_LOCK:
        for d in (LAUNCHES, PLAIN_CALLS):
            for key in d:
                d[key] = 0
        for key in BODY_STEPS:
            BODY_STEPS[key] = [0, 0]


def _count(counts: Dict[str, int], key: str) -> None:
    with _COUNT_LOCK:
        counts[key] += 1


def body_steps_all(rows: int, n_paths: int, retirement_years: int) -> int:
    """The retirement body steps a tiled launch of ``rows`` x ``n_paths``
    has in range: every warp of every row, every retirement month."""
    return int(rows) * -(-int(n_paths) // WARP) * MONTHS_PER_YEAR * int(retirement_years)


def record_steps(kind: str, run: int, in_range: int,
                 decided: Optional[int] = None) -> Dict[str, int]:
    """Add launches' body steps to ``BODY_STEPS[kind]`` (and ``decided``,
    where the launches counted it, to ``BODY_STEPS["decided"]``); returns
    them as the attributes of the span of their copy to the host."""
    attrs = {"steps_run": int(run), "steps_all": int(in_range)}
    if decided is not None:
        attrs["steps_decided"] = int(decided)
    with _COUNT_LOCK:
        BODY_STEPS[kind][0] += attrs["steps_run"]
        BODY_STEPS[kind][1] += attrs["steps_all"]
        if decided is not None:
            BODY_STEPS["decided"][0] += attrs["steps_decided"]
            BODY_STEPS["decided"][1] += attrs["steps_all"]
    return attrs


class F:
    """fparams layout (float, = pallas_kernel.py:97-108)."""

    (
        MU1_M, S1_M, MUI_M, SI_M, MUP_M, SP_M,
        RHO, RHO_C,
        ALLOC1, INIT_BAL, CONTRIB0, LOG1P_GROWTH, EXPENSES,
        R_REAL1, R_ANN1,
        R_REAL2, R_ANN2,
        ALLOC1_F,
        GR_UP, GR_LO, GR_ADJ, GR_FLOOR, GR_CAP,
        JP, JMU, JSIG, JBETA, JC1, JC2,
        MORT_G0, MORT_B12, MORT_CAP,
        NUM,
    ) = range(33)


# iparams row layout (int32): working months, last month, stream seed and
# the global path-block offset of the dispatch's first path.
I_W, I_T_END, I_SEED, I_BLOCK_OFF, NUM_IPARAMS = range(5)


class Statics(NamedTuple):
    """Compile-time structure of a scenario (``pallas_kernel.Statics``)."""

    use_real1: bool
    use_real2: bool
    bill1: bool
    bill2: bool
    stream_indexed: Tuple[bool, ...]
    stream_capped: Tuple[bool, ...]
    antithetic: bool = False
    glide: bool = False
    guardrails: bool = False
    jumps: bool = False
    mortality: bool = False


def statics_from_config(config) -> Statics:
    """Kernel Statics from a validated Config; streams pruned by the same
    helper that builds the SimParams stream tensors."""
    streams = prune_streams(config)
    use1 = bool(config.inv1_use_realized_gains_tax_system)
    use2 = bool(config.inv2_use_realized_gains_tax_system)
    return Statics(
        use_real1=use1,
        use_real2=use2,
        bill1=(not use1) and config.inv1_annual_tax_on_gains_rate > 0.0,
        bill2=(not use2) and config.inv2_annual_tax_on_gains_rate > 0.0,
        stream_indexed=tuple(bool(s.inflation_indexed) for s in streams),
        stream_capped=tuple(s.duration_years is not None for s in streams),
        antithetic=bool(getattr(config, "antithetic", False)),
        glide=getattr(config, "allocation_inv1_final_pct", None) is not None,
        guardrails=getattr(config, "spending_guardrails", None) is not None,
        jumps=getattr(config, "market_crashes", None) is not None,
        mortality=getattr(config, "longevity", None) is not None,
    )


def _statics_attrs(packed, statics, *args, **kwargs) -> Dict[str, str]:
    return {"statics": statics_tag(statics)}


@dataclasses.dataclass
class Packed:
    """The kernels' argument block.

    ``fp``: the scenario parameters, then the stream table rows [amount,
    months_from_t0, duration (capped at 3e7), indexed, tax], each of length
    S — one block of (F.NUM + 5*S,) floats shared by every candidate
    (:func:`pack_params`), or (K, F.NUM + 5*S), one row per scenario
    (:func:`pack_grid`). ``ip``: (K, 4) int32 rows [W, t_end, seed,
    block_offset], one per candidate or scenario. Both live on the device
    they run on. ``months``: the rows' W as the host packed them, where it
    did (:func:`row_months`).
    """

    fp: torch.Tensor
    ip: torch.Tensor
    n_streams: int
    months: Optional[Tuple[int, ...]] = None

    @property
    def device(self) -> torch.device:
        return self.fp.device


def _fparams(params: SimParams, dtype) -> torch.Tensor:
    """``pallas_kernel._pack_params``' float block plus ``_stream_inputs``,
    every derived value computed in ``dtype`` like the JAX packing, on the
    parameters' own device. Leaves may carry a leading scenario axis: the
    block is then (K, F.NUM + 5*S). Differentiable: leaves that carry a
    forward-mode tangent (``engine/sensitivity.sensitivity_ad``) keep it."""
    p = lambda t: t.to(dtype=dtype)
    sq = math.sqrt(MONTHS_PER_YEAR)
    vals = [
        p(params.mu1) / MONTHS_PER_YEAR,
        p(params.sigma1) / sq,
        p(params.mu_inf) / MONTHS_PER_YEAR,
        p(params.sigma_inf) / sq,
        p(params.mu_prem) / MONTHS_PER_YEAR,
        p(params.sigma_prem) / sq,
        p(params.rho),
        torch.sqrt(torch.clamp(1.0 - p(params.rho) ** 2, min=0.0)),
        p(params.alloc1),
        p(params.initial_balance),
        p(params.monthly_contribution),
        torch.log1p(p(params.contribution_growth)),
        p(params.monthly_expenses),
        p(params.real_tax1),
        p(params.ann_tax1),
        p(params.real_tax2),
        p(params.ann_tax2),
        p(params.alloc1_final),
        p(params.gr_upper),
        p(params.gr_lower),
        p(params.gr_adjust),
        p(params.gr_floor),
        p(params.gr_cap),
        p(params.jump_p),
        p(params.jump_mu),
        p(params.jump_sigma),
        p(params.jump_beta),
        p(params.jump_comp1),
        p(params.jump_comp2),
        p(params.mort_g0),
        p(params.mort_b12),
        p(params.mort_cap),
    ]
    streams = [
        p(params.stream_amount),
        p(params.stream_months_from_t0),
        torch.clamp(p(params.stream_duration_months), max=3.0e7),
        p(params.stream_indexed),
        p(params.stream_tax),
    ]
    return torch.cat([torch.stack(vals, dim=-1)] + streams, dim=-1)


def _iparams(working_months, retirement_years: int, seed: int,
             block_offset: int, device) -> torch.Tensor:
    w = torch.as_tensor(working_months, dtype=torch.int64).reshape(-1)
    t_end = w + MONTHS_PER_YEAR * int(retirement_years)
    ip = torch.stack(
        [
            w,
            t_end,
            torch.full_like(w, int(seed)),
            torch.full_like(w, int(block_offset)),
        ],
        dim=1,
    )
    return ip.to(device=device, dtype=torch.int32).contiguous()


def pack_params(
    params: SimParams,
    seed: int,
    working_months,
    retirement_years: int,
    block_offset: int = 0,
    dtype=torch.float32,
    device=None,
) -> Packed:
    """``pallas_kernel._pack_params`` plus ``_stream_inputs``: one parameter
    block shared by the candidate months ``working_months``."""
    device = params.initial_balance.device if device is None else device
    require_device(device)
    fp = _fparams(params, dtype).to(device)
    months = torch.as_tensor(working_months, dtype=torch.int64).reshape(-1)
    return Packed(fp=fp.contiguous(),
                  ip=_iparams(months, retirement_years, seed, block_offset,
                              device),
                  n_streams=params.n_streams,
                  months=tuple(int(v) for v in months.tolist()))


def pack_grid(
    params_batch: SimParams,
    seed: int,
    working_months,
    retirement_years: int,
    block_offset: int = 0,
    dtype=torch.float32,
    device=None,
) -> Packed:
    """The scenario grid's block: ``fp`` (K, F.NUM + 5*S), one row per
    scenario of the stacked ``params_batch`` (``models.retirement.
    stack_params``), and ``ip`` (K, 4) with each scenario's months. The
    rows are packed where the batch lives and moved to ``device`` in one
    copy."""
    device = params_batch.initial_balance.device if device is None else device
    require_device(device)
    if params_batch.initial_balance.ndim != 1:
        raise ValueError(
            "pack_grid takes a stacked batch (leaves with a leading scenario "
            f"axis), got leaves of shape {tuple(params_batch.initial_balance.shape)}"
        )
    k = int(params_batch.initial_balance.shape[0])
    ip = _iparams(working_months, retirement_years, seed, block_offset, device)
    if ip.shape[0] != k:
        raise ValueError(
            f"scenario grid of {k} rows needs one months row per scenario; "
            f"got {ip.shape[0]} months rows"
        )
    fp = _fparams(params_batch, dtype).to(device)
    return Packed(fp=fp.contiguous(), ip=ip, n_streams=params_batch.n_streams)


def check_grid_statics(params_batch: SimParams, statics: Statics) -> None:
    """Raise unless every row of a stacked batch matches the compile-time
    ``statics`` (``pallas_kernel._check_grid_statics``): the grid kernel
    branches on the shared flags only, so a mismatched row would silently
    simulate under another row's tax system or stream structure."""
    a = lambda name: getattr(params_batch, name).detach().cpu().numpy()
    u1, u2 = a("use_real1") > 0.5, a("use_real2") > 0.5
    a1, a2 = a("ann_tax1") > 0.0, a("ann_tax2") > 0.0
    s_idx = a("stream_indexed") > 0.5
    s_cap = np.isfinite(a("stream_duration_months"))
    glide_rows = a("alloc1_final") != a("alloc1")
    gr_rows = a("gr_adjust") > 0.0
    jump_rows = a("jump_p") > 0.0
    mort_rows = a("mort_b12") > 0.0
    want_idx = np.asarray(statics.stream_indexed, dtype=bool)
    want_cap = np.asarray(statics.stream_capped, dtype=bool)
    ok = (
        bool((u1 == statics.use_real1).all())
        and bool((u2 == statics.use_real2).all())
        and bool(((~u1 & a1) == statics.bill1).all())
        and bool(((~u2 & a2) == statics.bill2).all())
        and (statics.glide or not bool(glide_rows.any()))
        and (statics.guardrails or not bool(gr_rows.any()))
        and (statics.jumps or not bool(jump_rows.any()))
        and (statics.mortality or not bool(mort_rows.any()))
    )
    if ok and want_idx.size:
        ok = (
            s_idx.shape[-1] == want_idx.size
            and bool((s_idx.reshape(-1, want_idx.size) == want_idx).all())
            and bool((s_cap.reshape(-1, want_cap.size) == want_cap).all())
        )
    if not ok:
        raise ValueError(
            "scenario batch mixes tax-system/annual-bill/stream structure "
            "that conflicts with the compile-time Statics; all rows of one "
            "grid launch must share them (see "
            "engine.scenario_batch.grid_statics; run_scenario_batch "
            "groups a mixed batch by Statics)."
        )


# ---------------------------------------------------------------------------
# device routing
# ---------------------------------------------------------------------------
def require_device(device) -> None:
    """Raise unless ``device`` is the CPU or a CUDA device that exists."""
    device = torch.device(device)
    if device.type == "cpu":
        return
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False: no CUDA card here (pass device='cpu' for the plain "
            "PyTorch path)"
        )


def _runs_plain(packed: Packed, statics: Statics, what: str,
                dtypes=(torch.float32,)) -> bool:
    """True for CPU tensors; for CUDA tensors checks the card and the
    kernel's input contract (the pointers it is handed), then False."""
    require_device(packed.device)
    if packed.device.type == "cpu":
        return True
    fp, ip, S = packed.fp, packed.ip, packed.n_streams
    if fp.dtype not in dtypes or ip.dtype != torch.int32:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(
            f"the {what} kernel takes {names} params and int32 iparams, got "
            f"{fp.dtype} / {ip.dtype}"
        )
    width = F.NUM + 5 * S
    rows = ip.shape[0] if ip.ndim == 2 else -1
    fp_ok = fp.shape == ((rows, width) if fp.ndim == 2 else (width,))
    if (fp.device != ip.device or not fp.is_contiguous()
            or not ip.is_contiguous() or not fp_ok
            or ip.ndim != 2 or ip.shape[1] != NUM_IPARAMS
            or not 1 <= rows <= MAX_ROWS
            or len(statics.stream_indexed) != S
            or len(statics.stream_capped) != S):
        raise ValueError(
            f"malformed parameter block for the {what} kernel: fp "
            f"{tuple(fp.shape)} on {fp.device}, ip {tuple(ip.shape)} on "
            f"{ip.device}, {S} streams, statics for "
            f"{len(statics.stream_indexed)}"
        )
    return False


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class ProbeOut(NamedTuple):
    counts: torch.Tensor  # (K,) int64 — surviving paths per candidate/row
    success: torch.Tensor  # (K, n) float 0/1 alive flags
    final_balance: torch.Tensor  # (K, n)
    # (K,) int64 — retirement months run per row, in warp-months (row 1 of
    # the kernel's buffer whose row 0 is ``counts``); None where not counted
    steps: Optional[torch.Tensor] = None
    # (K,) int64 — of those, the months run once every path of the warp was
    # decided (row 2; the probe under longevity only, else None)
    decided: Optional[torch.Tensor] = None


class SimulateOut(NamedTuple):
    success: torch.Tensor  # (n,) float 0/1 alive flags
    final_balance: torch.Tensor  # (n,)


class TilePlan(NamedTuple):
    """One tiled launch of ``probe_kernel``, ``grid_kernel`` or
    ``scan_rows_kernel``: ``rows`` x ``n_paths`` in blocks of
    ``rows_per_block`` rows x 32 paths, drawing ``months_per_chunk`` months
    of ``fields`` values of ``elem_bytes`` each per path-month into the
    block's tile at a time."""

    rows: int
    n_paths: int
    rows_per_block: int
    months_per_chunk: int
    fields: int
    elem_bytes: int = 4
    # The probe without a glide path (:func:`probe_plan`): accum_kernel runs
    # every path's accumulation once and the rows start from its carry.
    accum_once: bool = False

    @property
    def threads(self) -> int:
        return self.rows_per_block * WARP

    @property
    def grid(self) -> Tuple[int, int]:
        """(blocks over paths, blocks over rows)."""
        return (-(-self.n_paths // WARP), -(-self.rows // self.rows_per_block))

    @property
    def smem_bytes(self) -> int:
        """The draw tile [M][fields][32] values and the block's largest
        t_end (an int)."""
        return self.elem_bytes * self.months_per_chunk * self.fields * WARP + 4

    def cell(self, bx, by, tid):
        """(row, path) of thread ``tid`` of block (bx, by), as the kernel
        maps it (ints or numpy arrays); a row >= ``rows`` or a path >=
        ``n_paths`` is padding."""
        warp, lane = divmod(tid, WARP)
        return by * self.rows_per_block + warp, bx * WARP + lane


def tile_plan(rows: int, n_paths: int, statics: Statics, kind: str,
              elem_bytes: int = 4) -> TilePlan:
    """The launch of ``rows`` x ``n_paths`` rows of a ``kind`` ("probe" or
    "grid") kernel: the rows split into the fewest groups of at most
    ``ROWS_PER_BLOCK``, as even as they go, one block of C rows x 32 paths
    each, drawing ``MONTHS_PER_ROW`` x C months (at most
    ``MAX_TILE_MONTHS``) per tile, so a block of few rows, of which an SM
    holds many, keeps a small tile. A path-month of the tile is the
    probe's three growth factors (its rows share one parameter block), or
    the grid's three normals plus, with crashes, the crash uniform and
    normal. The scan's rows take the probe's form with one shared block
    and the grid's with one block per row, in values of ``elem_bytes``
    (8 in float64)."""
    rows, n_paths = int(rows), int(n_paths)
    if rows < 1 or n_paths < 1:
        raise ValueError(f"a tiled launch needs rows and paths, got {rows} x {n_paths}")
    if kind not in ("probe", "grid"):
        raise ValueError(f"tile kind is 'probe' or 'grid', got {kind!r}")
    per_block = -(-rows // -(-rows // ROWS_PER_BLOCK))
    return TilePlan(rows, n_paths, per_block,
                    min(MAX_TILE_MONTHS, MONTHS_PER_ROW * per_block),
                    5 if kind == "grid" and statics.jumps else 3,
                    int(elem_bytes))


def probe_plan(rows: int, n_paths: int, statics: Statics) -> TilePlan:
    """The launch of :func:`probe`: :func:`tile_plan`'s "probe" tiling;
    without a glide path (``accum_once``) ``accum_kernel`` runs each
    path's working years once, to the rows' largest W, and each row starts
    from its carry at its own W. A glide path moves each row's target with
    its own W, so there every row accumulates its own months."""
    return tile_plan(rows, n_paths, statics, "probe")._replace(
        accum_once=not statics.glide)


def carry_fields(statics: Statics) -> int:
    """Values per path of the carry ``accum_kernel`` hands a probe row
    (``csrc/month_loop.cu`` kCarryFields): b1, c1, b2, c2 and the price
    level; with annual bills also both period gains and the failed-bill
    flag."""
    return 8 if statics.bill1 or statics.bill2 else 5


def tile_work(plan: TilePlan, working_months, t_end,
              acc_cap: Optional[int] = None) -> Dict[str, int]:
    """The least work of one tiled launch whose paths live, counted as the
    kernel does it: ``draws`` charges each path-month once per block, over
    the block's real paths, up to the largest t_end of its rows; ``accum``
    and ``retire`` charge each row's body once per (row, path, month) up to
    the row's own W (or the scan's ``acc_cap``, where lower) and t_end. A
    warp whose paths are all ruined runs less (``ProbeOut.steps``). With
    ``plan.accum_once`` the accumulation runs once per path, to the rows'
    largest W, drawing those months itself, and each block draws from its
    rows' smallest W + 1 on."""
    t = [int(v) for v in t_end]
    w_ret = [int(v) for v in working_months]
    w = w_ret if acc_cap is None else [min(v, int(acc_cap)) for v in w_ret]
    if len(w) != plan.rows or len(t) != plan.rows:
        raise ValueError("one W and one t_end per row")
    C, n = plan.rows_per_block, plan.n_paths
    groups = [slice(g * C, (g + 1) * C) for g in range(plan.grid[1])]
    if plan.accum_once:
        accum = n * max(max(w), 0)
        draws = accum + sum(n * (max(t[g]) - max(min(w_ret[g]), 0))
                            for g in groups)
    else:
        accum = n * sum(max(v, 0) for v in w)
        draws = sum(n * max(t[g]) for g in groups)
    return {
        "draws": draws,
        "accum": accum,
        "retire": n * sum(te - wi for wi, te in zip(w_ret, t)),
    }


def row_months(packed: Packed) -> Tuple[int, ...]:
    """The rows' W: as :func:`pack_params` kept them on the host, else
    read from the block's ``ip`` (a copy from the card there)."""
    if packed.months is not None:
        return packed.months
    return tuple(int(v) for v in packed.ip[:, I_W].tolist())


def accum_counts(plan: TilePlan, working_months) -> Dict[str, int]:
    """A probe launch's accumulation path-months: ``accum_run``, what it
    runs (``plan.accum_once``: n x the largest W; else n x the sum of the
    rows' W), and ``accum_rows``, what per-row accumulation would run (n x
    the sum of the rows' W)."""
    w = [max(int(v), 0) for v in working_months]
    rows = plan.n_paths * sum(w)
    return {"accum_run": plan.n_paths * max(w) if plan.accum_once else rows,
            "accum_rows": rows}


def _launch_rows(entry: str, packed: Packed, statics: Statics,
                 n_paths: int, plan: TilePlan) -> ProbeOut:
    """One launch of ``probe_kernel`` (``mcrt_probe``; with
    ``plan.accum_once`` after ``accum_kernel``, on a carry buffer of (K,
    :func:`carry_fields`, n) floats) or ``grid_kernel`` (``mcrt_grid``): K
    rows x ``n_paths`` paths as ``plan`` tiles them."""
    from . import _build

    K, n = packed.ip.shape[0], int(n_paths)
    if (plan.rows, plan.n_paths) != (K, n):
        raise ValueError(f"{plan} does not tile {K} rows x {n} paths")
    probe = entry == "mcrt_probe"
    if probe and plan.accum_once == statics.glide:
        raise ValueError(f"{plan} does not fit the probe kernel of these "
                         "Statics: it accumulates " + (
                             "per row" if statics.glide else "once per path"))
    lib = _build.load(statics)
    dev = packed.device
    success = torch.empty((K, n), dtype=torch.float32, device=dev)
    final = torch.empty((K, n), dtype=torch.float32, device=dev)
    # The probe under longevity writes its decided months after the steps.
    decided = probe and statics.mortality
    tally = torch.zeros((3 if decided else 2, K), dtype=torch.int32, device=dev)
    shared = ()
    if probe:
        fields = carry_fields(statics) if plan.accum_once else 0
        w_max = max(max(row_months(packed)), 0) if plan.accum_once else 0
        carry = (torch.empty((K, fields, n), dtype=torch.float32, device=dev)
                 if w_max else None)
        shared = (fields, w_max, None if carry is None else carry.data_ptr())
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            packed.fp.data_ptr(), packed.ip.data_ptr(), K, n,
            packed.n_streams, plan.rows_per_block, plan.months_per_chunk,
            plan.fields, plan.smem_bytes, *shared,
            success.data_ptr(), final.data_ptr(), tally[0].data_ptr(),
            tally[1].data_ptr(), _stream_ptr(dev),
        )
    _build.check(lib, rc, f"{entry} launch")
    return _rows_out(tally, success, final)


def _rows_out(tally: torch.Tensor, success: torch.Tensor,
              final: torch.Tensor) -> ProbeOut:
    """A tiled launch's outputs: survivors, body steps and (a third row)
    decided steps, rows of its (2 or 3, K) int32 tally, as int64."""
    tally = tally.to(torch.int64)
    return ProbeOut(tally[0], success, final, tally[1],
                    tally[2] if len(tally) > 2 else None)


def _plain_out(out: Dict[str, torch.Tensor]) -> ProbeOut:
    counts = (out["success"] > 0.5).sum(dim=1)
    return ProbeOut(counts, out["success"], out["final_balance"], out["steps"],
                    out.get("decided"))


def _plain_rows(packed: Packed, statics: Statics, retirement_years: int,
                n_paths: int, shocks: Optional[torch.Tensor],
                decided: bool = False) -> ProbeOut:
    """The plain loop's rows; ``decided``: count the decided months too,
    as the probe kernel does under longevity."""
    from . import kernel

    return _plain_out(kernel.simulate(packed, statics, retirement_years,
                                      n_paths, shocks=shocks, decided=decided))


# ---------------------------------------------------------------------------
# probe: candidate-parallel success for the search
# ---------------------------------------------------------------------------
def probe(packed: Packed, statics: Statics, retirement_years: int,
          n_paths: int) -> ProbeOut:
    """Per-candidate survivors over exactly ``n_paths`` paths (kernel on a
    CUDA tensor, plain version on a CPU tensor). A span ``kernel.probe``;
    a kernel launch adds its :func:`accum_counts` to its attributes and to
    ``BODY_STEPS["accum"]``."""
    with profiling.span("kernel.probe", statics=statics_tag(statics)) as span:
        if packed.fp.ndim != 1:
            raise ValueError("probe takes one shared parameter block (pack_params)")
        if _runs_plain(packed, statics, "probe"):
            return probe_plain(packed, statics, retirement_years, n_paths)
        plan = probe_plan(packed.ip.shape[0], n_paths, statics)
        out = _launch_rows("mcrt_probe", packed, statics, n_paths, plan)
        _count(LAUNCHES, "probe")
        accum = accum_counts(plan, row_months(packed))
        with _COUNT_LOCK:
            BODY_STEPS["accum"][0] += accum["accum_run"]
            BODY_STEPS["accum"][1] += accum["accum_rows"]
        span.set(**accum)
        return out


def probe_plain(packed: Packed, statics: Statics, retirement_years: int,
                n_paths: int, shocks: Optional[torch.Tensor] = None) -> ProbeOut:
    """Plain PyTorch version of :func:`probe` (optionally on injected
    shocks, (T, P, n) in the plane layout of ``kernel.shock_planes``)."""
    _count(PLAIN_CALLS, "probe")
    return _plain_rows(packed, statics, retirement_years, n_paths, shocks,
                       decided=True)


# ---------------------------------------------------------------------------
# scenario grid: one parameter row per scenario, shocks shared by the grid
# ---------------------------------------------------------------------------
@profiling.traced("kernel.grid", _statics_attrs)
def grid(packed: Packed, statics: Statics, retirement_years: int,
         n_paths: int) -> ProbeOut:
    """Per-scenario survivors, alive flags and final balances (K, n) over
    exactly ``n_paths`` paths for a :func:`pack_grid` block (kernel on a
    CUDA tensor, plain version on a CPU tensor)."""
    if packed.fp.ndim != 2:
        raise ValueError("grid takes one parameter row per scenario (pack_grid)")
    if _runs_plain(packed, statics, "grid"):
        return grid_plain(packed, statics, retirement_years, n_paths)
    plan = tile_plan(packed.ip.shape[0], n_paths, statics, "grid")
    out = _launch_rows("mcrt_grid", packed, statics, n_paths, plan)
    _count(LAUNCHES, "grid")
    return out


def grid_plain(packed: Packed, statics: Statics, retirement_years: int,
               n_paths: int, shocks: Optional[torch.Tensor] = None) -> ProbeOut:
    """Plain PyTorch version of :func:`grid`: one vectorised loop over the
    K rows (optionally on injected shocks, (T, P, n))."""
    _count(PLAIN_CALLS, "grid")
    return _plain_rows(packed, statics, retirement_years, n_paths, shocks)


def _one_row(packed: Packed) -> Packed:
    """The block as a one-row grid block (same memory, fp (1, F.NUM + 5S))."""
    if packed.ip.shape[0] != 1:
        raise ValueError("simulate takes one working_months value")
    return Packed(fp=packed.fp.reshape(1, -1), ip=packed.ip,
                  n_streams=packed.n_streams)


def simulate(packed: Packed, statics: Statics, retirement_years: int,
             n_paths: int) -> SimulateOut:
    """One working-months value -> per-path success flags and final
    balances (n,), as ``pallas_simulate`` returns them: the grid kernel
    launched with one row."""
    row = _one_row(packed)
    if _runs_plain(packed, statics, "simulate"):
        return simulate_plain(packed, statics, retirement_years, n_paths)
    plan = tile_plan(1, n_paths, statics, "grid")
    out = _launch_rows("mcrt_grid", row, statics, n_paths, plan)
    _count(LAUNCHES, "simulate")
    return SimulateOut(out.success[0], out.final_balance[0])


def simulate_plain(packed: Packed, statics: Statics, retirement_years: int,
                   n_paths: int, shocks: Optional[torch.Tensor] = None
                   ) -> SimulateOut:
    """Plain PyTorch version of :func:`simulate`."""
    _count(PLAIN_CALLS, "simulate")
    out = _plain_rows(_one_row(packed), statics, retirement_years, n_paths,
                      shocks)
    return SimulateOut(out.success[0], out.final_balance[0])


# ---------------------------------------------------------------------------
# full statistics: tracked per-path vectors and yearly series
# ---------------------------------------------------------------------------
VECTOR_FIELDS = (
    "success", "final_balance", "start_balance", "years_to_ruin",
    "first_year_gross", "first_year_real_gross", "inflation_at_retirement",
)


@profiling.traced("kernel.full", _statics_attrs)
def simulate_full(packed: Packed, statics: Statics, retirement_years: int,
                  n_paths: int, traj_len: int) -> Dict[str, torch.Tensor]:
    """Per-path vectors (n,) and series ``trajectory``/``price_levels``
    (n, traj_len), ``withdrawal_rates`` (n, R) — the JAX public layout, as
    transposed views of the kernel's (L, n) / (R, n) buffers."""
    if packed.ip.shape[0] != 1:
        raise ValueError("simulate_full takes one working_months value")
    if _runs_plain(packed, statics, "full"):
        return simulate_full_plain(
            packed, statics, retirement_years, n_paths, traj_len
        )
    from . import _build

    lib = _build.load(statics)
    dev = packed.device
    n, R, L = int(n_paths), int(retirement_years), int(traj_len)
    vecs = torch.empty((len(VECTOR_FIELDS), n), dtype=torch.float32, device=dev)
    traj = torch.empty((L, n), dtype=torch.float32, device=dev)
    price = torch.empty((L, n), dtype=torch.float32, device=dev)
    wr = torch.empty((R, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mcrt_full(
            packed.fp.data_ptr(), packed.ip.data_ptr(), n, R, L,
            packed.n_streams, vecs.data_ptr(), traj.data_ptr(), price.data_ptr(),
            wr.data_ptr(), _stream_ptr(dev),
        )
    _build.check(lib, rc, "full_kernel launch")
    _count(LAUNCHES, "full")
    out = dict(zip(VECTOR_FIELDS, vecs.unbind(0)))
    out.update(trajectory=traj.t(), price_levels=price.t(),
               withdrawal_rates=wr.t())
    return out


def simulate_full_plain(packed: Packed, statics: Statics,
                        retirement_years: int, n_paths: int, traj_len: int,
                        shocks: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`simulate_full`."""
    from . import kernel

    _count(PLAIN_CALLS, "full")
    return kernel.simulate(packed, statics, retirement_years, n_paths,
                           traj_len=traj_len, shocks=shocks)


# ---------------------------------------------------------------------------
# the scan: JAX's threefry scan (simulate_paths) as one kernel
# ---------------------------------------------------------------------------
SCAN_DTYPES = (torch.float32, torch.float64)


@functools.lru_cache(maxsize=64)
def scan_keys(stream_key, t_max: int, jumps: bool = False,
              mortality: bool = False) -> torch.Tensor:
    """The scan kernels' key table (``csrc/threefry.cuh``): (t_max + 1, 6)
    int32 holding uint32 words, row m = [``fold_in(key, m)``, the two halves
    of ``split(fold_in(key, JUMP_FOLD_OFFSET + m))`` (with ``jumps``)], row
    0 = [``fold_in(key, MORT_FOLD_OFFSET)`` (with ``mortality``), 0 ...];
    on the host, cached per key (a tuple of two ints)."""
    m = torch.arange(int(t_max) + 1, dtype=torch.int64)
    table = torch.zeros((len(m), 6), dtype=torch.int64)
    table[:, 0], table[:, 1] = threefry.threefry2x32(stream_key, 0, m)
    if jumps:
        folded = threefry.threefry2x32(stream_key, 0, JUMP_FOLD_OFFSET + m)
        table[:, 2], table[:, 3] = threefry.threefry2x32(folded, 0, 0)
        table[:, 4], table[:, 5] = threefry.threefry2x32(folded, 0, 1)
    table[0] = 0  # month 0 is never drawn: its row holds the longevity key
    if mortality:
        table[0, :2] = torch.tensor(threefry.fold_in(stream_key, MORT_FOLD_OFFSET))
    return table.to(torch.int32)  # the uint32 bits


def _scan_lib(packed: Packed, statics: Statics):
    from . import _build

    real = "float" if packed.fp.dtype == torch.float32 else "double"
    return _build.load(_build.Unit(statics, real, "threefry"))


def _scan_launch_keys(packed: Packed, statics: Statics, stream_key):
    """The key table on the card, covering the rows' last month."""
    t_max = int(packed.ip[:, I_T_END].max())
    return scan_keys(stream_key, t_max, statics.jumps,
                     statics.mortality).to(packed.device)


def scan_rows(packed: Packed, statics: Statics, retirement_years: int,
              n_paths: int, stream_key, *, t_scan: int,
              row_offset: int = 0) -> ProbeOut:
    """The JAX scan's rows (``simulate_paths`` in probe mode, vmapped over
    working months): survivors, alive flags and final balances (K, n) of
    the global paths ``row_offset ..`` on ``stream_key``'s threefry draws,
    accumulating while m <= min(W, t_scan - 12 R). ``packed.fp`` is one
    block shared by the rows (the probe) or one row each (a batch), in
    float32 or float64. Kernel on a CUDA tensor, plain chain on a CPU one."""
    if _runs_plain(packed, statics, "scan", SCAN_DTYPES):
        return scan_rows_plain(packed, statics, retirement_years, n_paths,
                               stream_key, t_scan=t_scan,
                               row_offset=row_offset)
    from . import _build

    lib = _scan_lib(packed, statics)
    fp, dev = packed.fp, packed.device
    K, n = packed.ip.shape[0], int(n_paths)
    shared = fp.ndim == 1
    plan = tile_plan(K, n, statics, "probe" if shared else "grid",
                     fp.element_size())
    keys = _scan_launch_keys(packed, statics, stream_key)
    success = torch.empty((K, n), dtype=fp.dtype, device=dev)
    final = torch.empty((K, n), dtype=fp.dtype, device=dev)
    tally = torch.zeros((2, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mcrt_scan_rows(
            fp.data_ptr(), packed.ip.data_ptr(), keys.data_ptr(), K, n,
            packed.n_streams, int(shared), plan.rows_per_block,
            plan.months_per_chunk, plan.fields, plan.smem_bytes,
            plan.elem_bytes, int(t_scan) - MONTHS_PER_YEAR * int(retirement_years),
            int(row_offset), success.data_ptr(), final.data_ptr(),
            tally[0].data_ptr(), tally[1].data_ptr(), _stream_ptr(dev),
        )
    _build.check(lib, rc, "scan_rows_kernel launch")
    _count(LAUNCHES, "scan")
    return _rows_out(tally, success, final)


def scan_rows_plain(packed: Packed, statics: Statics, retirement_years: int,
                    n_paths: int, stream_key, *, t_scan: int,
                    row_offset: int = 0) -> ProbeOut:
    """Plain PyTorch version of :func:`scan_rows`: the chain of torch ops
    (``kernel.scan_chain``), one month at a time."""
    from . import kernel

    _count(PLAIN_CALLS, "scan")
    return _plain_out(kernel.scan_chain(packed, statics, retirement_years,
                                        n_paths, stream_key, t_scan=t_scan,
                                        row_offset=row_offset))


def scan_full(packed: Packed, statics: Statics, retirement_years: int,
              n_paths: int, traj_len: int, stream_key, *, t_scan: int,
              row_offset: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX scan's tracked run (``simulate_paths(traj_len > 0)``) of one
    row: the fields of :func:`simulate_full`, in the block's dtype. Kernel
    on a CUDA tensor, plain chain on a CPU one."""
    if packed.ip.shape[0] != 1:
        raise ValueError("scan_full takes one working_months value")
    if _runs_plain(packed, statics, "scan", SCAN_DTYPES):
        return scan_full_plain(packed, statics, retirement_years, n_paths,
                               traj_len, stream_key, t_scan=t_scan,
                               row_offset=row_offset)
    from . import _build

    lib = _scan_lib(packed, statics)
    fp, dev = packed.fp, packed.device
    n, R, L = int(n_paths), int(retirement_years), int(traj_len)
    keys = _scan_launch_keys(packed, statics, stream_key)
    vecs = torch.empty((len(VECTOR_FIELDS), n), dtype=fp.dtype, device=dev)
    traj = torch.empty((L, n), dtype=fp.dtype, device=dev)
    price = torch.empty((L, n), dtype=fp.dtype, device=dev)
    wr = torch.empty((R, n), dtype=fp.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mcrt_scan_full(
            fp.reshape(-1).data_ptr(), packed.ip.data_ptr(), keys.data_ptr(),
            n, R, L, packed.n_streams, fp.element_size(),
            int(t_scan) - MONTHS_PER_YEAR * R, int(row_offset),
            vecs.data_ptr(), traj.data_ptr(), price.data_ptr(),
            wr.data_ptr(), _stream_ptr(dev),
        )
    _build.check(lib, rc, "scan_full_kernel launch")
    _count(LAUNCHES, "scan")
    out = dict(zip(VECTOR_FIELDS, vecs.unbind(0)))
    out.update(trajectory=traj.t(), price_levels=price.t(),
               withdrawal_rates=wr.t())
    return out


def scan_full_plain(packed: Packed, statics: Statics, retirement_years: int,
                    n_paths: int, traj_len: int, stream_key, *, t_scan: int,
                    row_offset: int = 0) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`scan_full`."""
    from . import kernel

    _count(PLAIN_CALLS, "scan")
    return kernel.scan_chain(packed, statics, retirement_years, n_paths,
                             stream_key, t_scan=t_scan, row_offset=row_offset,
                             traj_len=traj_len)


# ---------------------------------------------------------------------------
# forward-mode AD: the month loop's JVP (sensitivity_ad)
# ---------------------------------------------------------------------------
# Tangents one jvp_kernel launch carries, in either scalar type: a K above
# it runs as ceil(K / TK) launches, the last zero-padded. Under
# config.json's Statics the float64 kernel spills at TK = 8 and not at 4
# (chip_smoke.py phase 1 builds both and prints their registers and
# spills; PERF.md §6).
JVP_TK = 4


class JvpOut(NamedTuple):
    success: torch.Tensor  # (n,) float 0/1 alive flags
    final_balance: torch.Tensor  # (n,)
    tangents: torch.Tensor  # (K, n): d final_balance along fp_dot's rows


def _jvp_route(stream_key, t_scan):
    if (stream_key is None) != (t_scan is None):
        raise ValueError("the scan's draws take stream_key and t_scan together")
    return "philox" if stream_key is None else "threefry"


def simulate_jvp(packed: Packed, fp_dot: torch.Tensor, statics: Statics,
                 retirement_years: int, n_paths: int, *, stream_key=None,
                 t_scan: Optional[int] = None, row_offset: int = 0) -> JvpOut:
    """One row's month loop and its forward-mode derivative: per-path
    success and final balance (n,), and the final balance's tangents (K, n)
    along the K rows of ``fp_dot`` (K, F.NUM + 5*S), directions of the
    parameter block ``packed.fp``. The draws are the grid kernel's Philox
    stream (``packed``'s seed and block offset), or with ``stream_key`` and
    ``t_scan`` the scan's threefry stream for the global paths
    ``row_offset ..`` (``kernel.scan_chain``). float32 or float64.

    On a CUDA tensor it launches ``jvp_kernel`` (one launch per
    ``JVP_TK`` directions) or raises; on a CPU tensor it runs
    :func:`simulate_jvp_plain`. The tangents are passed as such, never
    formed as ``fp + h * fp_dot``: a slot may hold +inf."""
    route = _jvp_route(stream_key, t_scan)
    require_device(packed.device)
    if packed.ip.shape[0] != 1:
        raise ValueError("simulate_jvp takes one working_months value")
    width = F.NUM + 5 * packed.n_streams
    if fp_dot.ndim != 2 or fp_dot.shape[1] != width or fp_dot.shape[0] < 1:
        raise ValueError(f"fp_dot of shape {tuple(fp_dot.shape)}: need (K >= 1, "
                         f"{width}) tangent directions")
    if fp_dot.dtype != packed.fp.dtype or fp_dot.device != packed.device:
        raise TypeError(f"fp_dot is {fp_dot.dtype} on {fp_dot.device}, the "
                        f"block {packed.fp.dtype} on {packed.device}")
    if _runs_plain(packed, statics, "jvp", SCAN_DTYPES):
        return simulate_jvp_plain(packed, fp_dot, statics, retirement_years,
                                  n_paths, stream_key=stream_key,
                                  t_scan=t_scan, row_offset=row_offset)
    from . import _build

    fp, dev = packed.fp.reshape(-1), packed.device
    real = "float" if fp.dtype == torch.float32 else "double"
    tk = JVP_TK
    lib = _build.load(_build.Unit(statics, real, route, tk))
    n, R, K = int(n_paths), int(retirement_years), int(fp_dot.shape[0])
    launches = -(-K // tk)
    dirs = torch.zeros((launches * tk, width), dtype=fp.dtype, device=dev)
    dirs[:K] = fp_dot
    keys, acc_cap = None, 0
    if route == "threefry":
        keys = _scan_launch_keys(packed, statics, stream_key)
        acc_cap = int(t_scan) - MONTHS_PER_YEAR * R
    success = torch.empty(n, dtype=fp.dtype, device=dev)
    final = torch.empty(n, dtype=fp.dtype, device=dev)
    tangents = torch.empty((launches * tk, n), dtype=fp.dtype, device=dev)
    for j in range(launches):
        with torch.cuda.device(dev):
            rc = lib.mcrt_jvp(
                fp.data_ptr(), dirs[j * tk].data_ptr(), packed.ip.data_ptr(),
                None if keys is None else keys.data_ptr(), n, width,
                packed.n_streams, tk, fp.element_size(), acc_cap,
                int(row_offset), success.data_ptr(), final.data_ptr(),
                tangents[j * tk].data_ptr(), _stream_ptr(dev),
            )
        _build.check(lib, rc, "jvp_kernel launch")
        _count(LAUNCHES, "ad")
    return JvpOut(success, final, tangents[:K])


def simulate_jvp_plain(packed: Packed, fp_dot: torch.Tensor, statics: Statics,
                       retirement_years: int, n_paths: int, *,
                       stream_key=None, t_scan: Optional[int] = None,
                       row_offset: int = 0) -> JvpOut:
    """Plain PyTorch version of :func:`simulate_jvp`: ``torch.func.jvp`` of
    the plain loop (``kernel.simulate``, or ``kernel.scan_chain`` on the
    scan's draws) with respect to ``packed.fp``, vectorised over the rows of
    ``fp_dot`` (``torch.func.vmap``), as ``torch.func.jacfwd`` runs it."""
    from . import kernel

    route = _jvp_route(stream_key, t_scan)
    _count(PLAIN_CALLS, "ad")
    R, n = int(retirement_years), int(n_paths)

    def loop(fp):
        block = Packed(fp=fp, ip=packed.ip, n_streams=packed.n_streams)
        if route == "philox":
            out = kernel.simulate(block, statics, R, n)
        else:
            out = kernel.scan_chain(block, statics, R, n, stream_key,
                                    t_scan=t_scan, row_offset=row_offset)
        return out["final_balance"][0], out["success"][0]

    def push(direction):
        return torch.func.jvp(loop, (packed.fp,), (direction.reshape(packed.fp.shape),),
                              has_aux=True)

    final, tangents, success = torch.func.vmap(push, out_dims=(None, 0, None))(
        fp_dot)
    return JvpOut(success, final, tangents)


# ---------------------------------------------------------------------------
# the device stream itself (checks only: holds it bit-equal to ops/shocks)
# ---------------------------------------------------------------------------
def device_draws(seed: torch.Tensor, block: torch.Tensor,
                 month: torch.Tensor, lane: torch.Tensor):
    """The draws of ``engine/csrc/philox.cuh`` computed on the card for
    per-element (seed, block, month, lane), all (n,) CUDA tensors: words
    (6, n) int64 — the month draw's four, the crash normal's, the
    longevity draw's — and values (6, n) float32 — z_eq, z_ind, z_prem, the
    crash uniform (word 3) and normal, the longevity uniform."""
    from . import _build

    dev = lane.device
    require_device(dev)
    if dev.type != "cuda" or not all(
        t.device == dev and t.shape == lane.shape and t.ndim == 1
        for t in (seed, block, month)
    ):
        raise ValueError("device_draws takes four (n,) tensors on one CUDA device")
    lib = _build.load()
    inp = torch.stack([seed, block, month, lane]).to(torch.int64)
    inp = (inp & 0xFFFFFFFF).to(torch.int32).contiguous()  # uint32 bits
    n = int(inp.shape[1])
    words = torch.empty((6, n), dtype=torch.int32, device=dev)
    vals = torch.empty((6, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mcrt_normals(inp.data_ptr(), n, words.data_ptr(),
                              vals.data_ptr(), _stream_ptr(dev))
    _build.check(lib, rc, "normals_kernel launch")
    return words.to(torch.int64) & 0xFFFFFFFF, vals


def device_threefry(key0: torch.Tensor, key1: torch.Tensor, hi: torch.Tensor,
                    lo: torch.Tensor):
    """The draws of ``engine/csrc/threefry.cuh`` computed on the card for
    per-element keys (key0, key1) and flat-index words (hi, lo), all (n,)
    CUDA tensors of uint32 values: words (2, n) int64 (y0, y1), float32
    (2, n) and float64 (2, n) (the uniform, the normal)."""
    from . import _build

    dev = lo.device
    require_device(dev)
    if dev.type != "cuda" or not all(
        t.device == dev and t.shape == lo.shape and t.ndim == 1
        for t in (key0, key1, hi)
    ):
        raise ValueError("device_threefry takes four (n,) tensors on one CUDA device")
    lib = _build.load()
    inp = torch.stack([key0, key1, hi, lo]).to(torch.int64)
    inp = (inp & 0xFFFFFFFF).to(torch.int32).contiguous()  # uint32 bits
    n = int(inp.shape[1])
    words = torch.empty((2, n), dtype=torch.int32, device=dev)
    f32 = torch.empty((2, n), dtype=torch.float32, device=dev)
    f64 = torch.empty((2, n), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mcrt_threefry(inp.data_ptr(), n, words.data_ptr(),
                               f32.data_ptr(), f64.data_ptr(), _stream_ptr(dev))
    _build.check(lib, rc, "threefry_kernel launch")
    return words.to(torch.int64) & 0xFFFFFFFF, f32, f64
