"""The plain month loop: the port's reference for the CUDA kernels.

Paths form the vector axis and months a Python loop with the phases of the
JAX Pallas body (``pallas_kernel.py:348-1173``): accumulation months 1..W
(with the glide target and the annual mark-to-market bills at year
boundaries), the retirement snapshot (a bill that failed before retirement
kills the path), then retirement months W+1..W+12R with the guardrails'
spending multiplier, the income streams (CPI-indexed or fixed-nominal,
capped or not), longevity, ruin checks A and B, the capacity-limited
withdrawal, the monthly rebalance, the annual bills and the terminal
settle, the year-end records and their death-padding rules, the first-year
capture and the alive-months counter that becomes years-to-ruin (NaN for
survivors). Every branch follows the compile-time ``Statics``: a feature
that is off runs no code and reads none of its parameters.

Shocks come either injected, ``(T, P, n)`` with month m reading row m-1 in
the Pallas plane layout (planes 0-2 the normals; with crashes 3-4 the crash
uniform and normal; with longevity plane 5 of month 0 the longevity
uniform; antithetic pairing does not apply to injected shocks), from the
Philox stream of ``ops/shocks.py``, or from the JAX scan's threefry stream
(``ScanDraws``: the scan engine, ``simulate_paths`` at the end of this
module). Candidates (rows of the packed iparams)
share one month's draws and differ in their working months and, in a
scenario grid, in their parameter rows (each parameter is a column that
broadcasts over the paths, so one vectorised loop runs K scenarios): a
candidate takes the accumulation step while m <= W and the retirement step
while W < m <= W + 12R, and its snapshot right after its own month W. The
loop runs in float64 on the CPU (the tests and the CPU engine) and in
float32 on the card, where it is the yardstick of the kernels; as the
scan (:func:`scan_chain`) it runs in either precision on either device:
the CPU's scan and the yardstick of the scan kernels on the card. Under
``torch.func.jvp`` either form is the plain version of the JVP kernel
(``cuda_kernel.simulate_jvp_plain``): the CPU's AD pass and the kernel's
yardstick on the card.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..constants import MONTHS_PER_YEAR, SMALL_EPSILON
from ..ops.shocks import (
    gompertz_remaining_months,
    month_draws,
    monthly_jump_draws,
    monthly_normals,
    mortality_uniform,
    pair_blocks,
    path_keys,
    threefry_mortality_uniform,
)
from ..ops.tax import (
    annual_tax,
    fail_rtol,
    monthly_rebalance,
    profile,
    rebalance_lite,
    withdraw_pro_rata,
)
from .cuda_kernel import (
    WARP,
    F,
    Packed,
    Statics,
    _fparams,
    _iparams,
    require_device,
    scan_full,
    tile_plan,
)
from .cuda_kernel import scan_rows as scan_rows_kernel

EPS = SMALL_EPSILON
Y = MONTHS_PER_YEAR


def shock_planes(statics) -> int:
    """Planes an injected-shocks tensor needs under ``statics``."""
    return 6 if statics.mortality else 5 if statics.jumps else 3


def drawn_shocks(statics, seed: int, n_paths: int, months: int,
                 block_offset: int = 0, device="cpu") -> torch.Tensor:
    """The Philox stream's own draws of months 1..``months`` as injected
    shocks (T, shock_planes, n), float32: what the loop draws month by
    month for this seed and these paths, drawn in one pass, with the
    antithetic pairing already applied (the loop applies none to injected
    shocks), so a run on them equals the run that draws itself."""
    gblock, lane = path_keys(int(n_paths), block_offset, device)
    sign = None
    if statics.antithetic:
        gblock, sign = pair_blocks(gblock)
    m = torch.arange(1, int(months) + 1, dtype=torch.int64, device=device)[:, None]
    planes = list(month_draws(seed, gblock, m, lane, jumps=statics.jumps, sign=sign))
    if statics.mortality:
        zeros = torch.zeros_like(planes[0])
        planes += [zeros, zeros] if not statics.jumps else []
        u = zeros.clone()
        u[0] = mortality_uniform(seed, gblock, lane, sign=sign)
        planes.append(u)
    return torch.stack(planes, dim=1)


def simulate(
    packed,
    statics,
    retirement_years: int,
    n_paths: int,
    traj_len: int = 0,
    shocks: Optional[torch.Tensor] = None,
    draws: Optional["ScanDraws"] = None,
    acc_months: Optional[int] = None,
    carry: bool = False,
    decided: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the month loop for every candidate row of ``packed``.

    ``packed.fp`` is one parameter block shared by the candidates (the
    probe) or one row per candidate (the scenario grid). Returns
    ``success`` and ``final_balance`` of shape (K, n) and ``steps`` (K,),
    the retirement months the tiled kernels run for each row, in
    warp-months: a warp of 32 consecutive paths runs its retirement months
    until it finds none of its paths alive where it looks, at the end of
    each retirement year and of each chunk of months the launch draws at
    once (``tile_plan``). With ``decided``, under longevity, also
    ``decided`` (K,): of those months, the ones a warp runs after the
    first place it looks finds every path decided, ruined or past its
    owner's death (the probe kernel's count). With ``carry`` also the
    loop's last state, a dict of (K, n) tensors by field (its carry).
    With ``traj_len > 0`` (one candidate only) it returns the tracked per-path vectors (n,) and
    the series ``trajectory``/``price_levels`` (n, traj_len) and
    ``withdrawal_rates`` (n, R) instead.

    The draws come from ``shocks`` (injected), from ``draws`` (the scan
    engine's threefry stream, month by month) or else from the Philox
    stream of ``packed``'s seed. ``acc_months`` caps the accumulation
    phase at that many months (the scan's ``t_scan - 12 R``): a row whose
    W exceeds it accumulates no further and still retires after month W.
    """
    R = int(retirement_years)
    n = int(n_paths)
    track = traj_len > 0
    decided = decided and statics.mortality and not track
    dtype = packed.fp.dtype
    dev = packed.fp.device
    ip = packed.ip.tolist()
    K = len(ip)
    if track and K != 1:
        raise ValueError("the tracked loop takes one candidate")
    seed, boff = ip[0][2], ip[0][3]
    if any(r[2] != seed or r[3] != boff for r in ip):
        raise ValueError("candidates must share their seed and block offset")
    w_list = [r[0] for r in ip]
    t_end_list = [r[1] for r in ip]
    S = packed.n_streams
    if len(statics.stream_indexed) != S or len(statics.stream_capped) != S:
        raise ValueError(f"statics for {len(statics.stream_indexed)} streams, "
                         f"parameters for {S}")
    bills = statics.bill1 or statics.bill2
    # Every parameter is a (1, 1) or (K, 1) column that broadcasts against
    # the (K, n) state.
    fp = packed.fp.reshape(-1, F.NUM + 5 * S)
    if fp.shape[0] not in (1, K):
        raise ValueError(
            f"{fp.shape[0]} parameter rows for {K} candidate rows"
        )

    def col(i):
        return fp[:, i:i + 1]

    rtol = fail_rtol(dtype)
    use1, use2 = statics.use_real1, statics.use_real2
    r1, r2 = col(F.R_REAL1), col(F.R_REAL2)
    alloc1 = col(F.ALLOC1)
    init_bal, expenses = col(F.INIT_BAL), col(F.EXPENSES)
    contrib0, log1p_growth = col(F.CONTRIB0), col(F.LOG1P_GROWTH)
    mu1, s1, mui, si = col(F.MU1_M), col(F.S1_M), col(F.MUI_M), col(F.SI_M)
    mup, sp, rho, rho_c = col(F.MUP_M), col(F.SP_M), col(F.RHO), col(F.RHO_C)
    s_amount = [col(F.NUM + s) for s in range(S)]
    s_from_t0 = [col(F.NUM + S + s) for s in range(S)]
    s_duration = [col(F.NUM + 2 * S + s) for s in range(S)]
    stream_net = [1.0 - col(F.NUM + 4 * S + s) for s in range(S)]
    w_t = torch.tensor(w_list, dtype=torch.int64, device=dev)[:, None]
    t_end_t = torch.tensor(t_end_list, dtype=torch.int64, device=dev)[:, None]
    w_f = w_t.to(dtype)
    stream_start = [
        torch.clamp(
            torch.ceil(torch.clamp(s_from_t0[s] - w_f, min=0.0) - EPS), min=0.0
        )
        for s in range(S)
    ]

    def tax(b1, c1, b2, c2, g1a, g2a, a1):
        return annual_tax(b1, c1, b2, c2, g1a, g2a, a1, use1, r1,
                          statics.bill1, col(F.R_ANN1), use2, r2,
                          statics.bill2, col(F.R_ANN2), rtol)

    # Glide: month-m target a0 + (af - a0) * m / W; retirement holds af.
    if statics.glide:
        alloc_ret = col(F.ALLOC1_F)
        glide_scale = (alloc_ret - alloc1) / torch.clamp(w_f, min=1.0)
    else:
        alloc_ret = alloc1
    if statics.guardrails:
        gr_up, gr_lo, gr_adj = col(F.GR_UP), col(F.GR_LO), col(F.GR_ADJ)
        gr_floor, gr_cap = col(F.GR_FLOOR), col(F.GR_CAP)
    if statics.jumps:
        jp, jmu, jsig = col(F.JP), col(F.JMU), col(F.JSIG)
        jbeta, jc1, jc2 = col(F.JBETA), col(F.JC1), col(F.JC2)

    sign = None
    if shocks is not None:
        if shocks.ndim != 3 or shocks.shape[1] < shock_planes(statics):
            raise ValueError(
                f"injected shocks of shape {tuple(shocks.shape)}: these "
                f"Statics need (T, {shock_planes(statics)}, n)"
            )
    else:
        gblock, lane = path_keys(n, boff, dev)
        if statics.antithetic:
            gblock, sign = pair_blocks(gblock)

    def draw(m):
        if draws is not None:
            z = draws(m)
        elif shocks is not None:
            z = shocks[m - 1].to(dtype)
        else:
            z = month_draws(seed, gblock, m, lane, jumps=statics.jumps,
                            sign=sign).to(dtype)
        z_inf = rho * z[0] + rho_c * z[1]
        if statics.jumps:
            # Compensated crash jump folded into the exponents.
            jl = torch.where(z[3] < jp, jmu + jsig * z[4], 0.0)
            g1 = torch.exp(mu1 + s1 * z[0] + (jl - jc1))
            gi = torch.exp(mui + si * z_inf)
            gp = torch.exp(mup + sp * z[2] + (jbeta * jl - jc2))
        else:
            g1 = torch.exp(mu1 + s1 * z[0])
            gi = torch.exp(mui + si * z_inf)
            gp = torch.exp(mup + sp * z[2])
        return g1, gi, gi * gp

    if statics.mortality:
        # One uniform per path -> remaining months at each row's own W.
        if draws is not None:
            u_mort = draws.mortality()
        elif shocks is not None:
            u_mort = shocks[0, 5].to(dtype)
        else:
            u_mort = mortality_uniform(seed, gblock, lane, sign=sign).to(dtype)
        d_mort = gompertz_remaining_months(
            u_mort, col(F.MORT_G0), col(F.MORT_B12), col(F.MORT_CAP), w_f
        )

    shape = (K, n)
    zeros = torch.zeros(shape, dtype=dtype, device=dev)
    b1 = (init_bal * alloc1).expand(shape).contiguous()
    b2 = init_bal - b1
    st = {
        "b1": b1, "c1": b1.clone(), "b2": b2, "c2": b2.clone(),
        "infl": torch.ones(shape, dtype=dtype, device=dev),
        "alive": torch.ones(shape, dtype=dtype, device=dev),
    }
    if bills:
        st.update(g1a=zeros, g2a=zeros, preret=zeros)  # period gains, pre-ret fail
    fixed_streams = [s for s in range(S) if not statics.stream_indexed[s]]
    for s in fixed_streams:
        st[f"fixed{s}"] = zeros - 1.0  # frozen nominal amount, -1 = not yet
    if statics.guardrails:
        st["smult"] = zeros + 1.0  # spending multiplier, year 0 = the plan
    if track:
        L = int(traj_len)
        st.update(ytr=zeros, yg=zeros, yr=zeros, fyg=zeros, fyr=zeros)
        traj = torch.zeros((L, n), dtype=dtype, device=dev)
        traj[0] = init_bal[0, 0]
        price = torch.ones((L, n), dtype=dtype, device=dev)
        wr = torch.full((R, n), math.nan, dtype=dtype, device=dev)
        w = w_list[0]
        full_wy, partial_wy = w // Y, int(w % Y != 0)
        snap = {}

    def accum_month(m, s, g):
        g1, gi, g2 = g
        out = dict(s)
        if bills:
            out["g1a"] = s["g1a"] + s["b1"] * (g1 - 1.0)
            out["g2a"] = s["g2a"] + s["b2"] * (g2 - 1.0)
        b1, b2 = s["b1"] * g1, s["b2"] * g2
        infl = s["infl"] * gi
        years = (m - 1) // Y
        contrib = contrib0 * torch.exp(log1p_growth * years)
        al = alloc1 + glide_scale * m if statics.glide else alloc1
        ca1 = contrib * al
        ca2 = contrib - ca1
        b1, c1 = b1 + ca1, s["c1"] + ca1
        b2, c2 = b2 + ca2, s["c2"] + ca2
        b1, c1, b2, c2 = monthly_rebalance(
            b1, c1, b2, c2, al, use1, r1, use2, r2
        )
        if bills and m % Y == 0:
            b1, c1, b2, c2, failed = tax(b1, c1, b2, c2, out["g1a"],
                                         out["g2a"], al)
            out["g1a"], out["g2a"] = out["g1a"] * 0.0, out["g2a"] * 0.0
            out["preret"] = torch.where(failed, 1.0, s["preret"])
        if track and m % Y == 0:
            slot = min(m // Y, L - 1)
            traj[slot] = (b1 + b2)[0]
            price[slot] = infl[0]
        out.update(b1=b1, c1=c1, b2=b2, c2=c2, infl=infl)
        return out

    def snapshot(s, rows):
        """A bill that failed before retirement kills the path at its own
        W (``rows``: the candidates whose accumulation just ended)."""
        if not bills:
            return s
        killed = rows & (s["preret"] > 0.5)
        return dict(s, alive=torch.where(killed, 0.0, s["alive"]))

    def ret_month(m, s, g):
        b1, c1, b2, c2 = s["b1"], s["c1"], s["b2"], s["c2"]
        infl, alive_f = s["infl"], s["alive"]
        out = dict(s)
        alive = alive_f > 0.5
        alive0_f = alive_f
        ret_idx = m - w_t - 1
        ret_idx_f = ret_idx.to(dtype)
        if track:
            k = m - w
            yg, yr = s["yg"], s["yr"]
            if k % Y == 1:
                yg, yr = torch.zeros_like(yg), torch.zeros_like(yr)

        # --- income waterfall & net spending need
        price0 = infl
        expenses_eff = expenses
        if statics.guardrails:
            # Year-start check (years 1+) of the planned WR against the
            # balance entering the month.
            smult = s["smult"]
            planned = 12.0 * expenses * smult * price0
            wr_now = planned / torch.clamp(b1 + b2, min=EPS)
            s_new = torch.where(wr_now > gr_up, smult * (1.0 - gr_adj), smult)
            s_new = torch.where(wr_now < gr_lo, smult * (1.0 + gr_adj), s_new)
            s_new = torch.minimum(torch.maximum(s_new, gr_floor), gr_cap)
            at_year_start = (ret_idx % Y == 0) & (ret_idx > 0)
            smult = torch.where(at_year_start & alive, s_new, smult)
            out["smult"] = smult
            expenses_eff = expenses * smult
        need = expenses_eff * price0
        if S:
            net_income = None
            for i in range(S):
                active = ret_idx_f >= stream_start[i]
                if statics.stream_capped[i]:
                    active = active & (ret_idx_f < stream_start[i] + s_duration[i])
                if statics.stream_indexed[i]:
                    nominal = s_amount[i] * price0
                else:
                    slot = s[f"fixed{i}"]
                    nominal = torch.where(
                        active & (ret_idx_f == stream_start[i]) & (slot < 0),
                        s_amount[i] * price0, slot,
                    )
                    out[f"fixed{i}"] = nominal
                inc = torch.where(active, nominal * stream_net[i], 0.0)
                net_income = inc if net_income is None else net_income + inc
            need = torch.clamp(need - net_income, min=0.0)
        if statics.mortality:
            # Spending ends with the owner; the estate keeps evolving.
            living = ret_idx_f < d_mort
            need = torch.where(living, need, 0.0)

        # --- ruin check A, then growth (dead/ruined paths freeze)
        dies_a = alive & (b1 + b2 <= EPS) & (need > EPS)
        g1, gi, g2 = g
        gmask = alive & ~dies_a
        if bills:
            out["g1a"] = s["g1a"] + torch.where(gmask, b1 * (g1 - 1.0), 0.0)
            out["g2a"] = s["g2a"] + torch.where(gmask, b2 * (g2 - 1.0), 0.0)
        b1 = torch.where(gmask, b1 * g1, b1)
        b2 = torch.where(gmask, b2 * g2, b2)
        infl = torch.where(gmask, infl * gi, infl)

        # --- ruin check B, then the capacity-limited withdrawal
        total1 = b1 + b2
        dies_b = gmask & (total1 <= EPS) & (need > EPS)
        wmask = gmask & ~dies_b
        prof1 = profile(b1, c1, use1, r1)
        prof2 = profile(b2, c2, use2, r2)
        ftol = EPS + rtol * (need + total1)
        b1, c1, b2, c2, gw, nw = withdraw_pro_rata(
            b1, c1, b2, c2, need, prof1, prof2, wmask
        )
        fail_net = wmask & (need > EPS) & (nw < need - ftol)
        if track:
            yg = yg + gw
            yr = yr + gw / torch.clamp(price0, min=EPS)

        # --- monthly rebalance (the proportional sale left the profiles valid)
        b1, c1, b2, c2 = rebalance_lite(
            b1, c1, b2, c2, prof1[0], prof2[0], alloc_ret, extra_noop=~wmask
        )

        # --- annual taxes at absolute year boundaries and the terminal
        # settle of a partial last year; a settle failure is no ruin for
        # the records
        dies_pre = dies_a | dies_b | fail_net
        dies = dies_regular = dies_pre
        if bills:
            is_boundary = m % Y == 0
            is_settle = (m == t_end_t) & (w_t % Y != 0)
            if is_boundary or bool(is_settle.any()):
                tb1, tc1, tb2, tc2, failed = tax(b1, c1, b2, c2, out["g1a"],
                                                 out["g2a"], alloc_ret)
                if is_boundary:
                    mask = wmask & ~fail_net
                else:
                    mask = is_settle & alive & ~dies_pre
                b1 = torch.where(mask, tb1, b1)
                c1 = torch.where(mask, tc1, c1)
                b2 = torch.where(mask, tb2, b2)
                c2 = torch.where(mask, tc2, c2)
                if is_boundary:
                    out["g1a"] = torch.where(mask, 0.0, out["g1a"])
                    out["g2a"] = torch.where(mask, 0.0, out["g2a"])
                tfail = mask & failed
                dies = dies_pre | tfail
                dies_regular = dies & ~(is_settle & tfail)
        alive_f = torch.where(dies, 0.0, alive_f)
        out.update(b1=b1, c1=c1, b2=b2, c2=c2, infl=infl, alive=alive_f)
        if not track:
            return out

        ytr = s["ytr"] + alive0_f
        fyg, fyr = s["fyg"], s["fyr"]
        if k <= Y:  # first retirement year: capture at death or year end
            cap_fy = (alive0_f > 0.5) & (dies_regular | (k % Y == 0))
            fyg = torch.where(cap_fy, yg, fyg)
            fyr = torch.where(cap_fy, yr * snap["infl_ret"], fyr)
        if k % Y == 0:
            slot = min(full_wy + partial_wy + (k + Y - 1) // Y, L - 1)
            yslot = min(max(k // Y - 1, 0), R - 1)
            total2 = b1 + b2
            died_this_year = (ytr > (k // Y - 1) * Y + 0.5) & (ytr < k + 0.5)
            alive_now = alive_f > 0.5
            wmask_rec = alive_now | died_this_year
            value_rec = torch.where(
                wmask_rec,
                torch.where(alive_now, total2, torch.clamp(total2, min=0.0)),
                0.0,
            )
            start = snap["start"]
            wr_mask = (alive0_f > 0.5) & ~dies_regular
            if statics.mortality:
                wr_mask = wr_mask & living  # fully-lived years only
            wr_value = torch.where(
                start > EPS,
                yr * snap["infl_ret"] / torch.clamp(start, min=EPS) * 100.0,
                0.0,
            )
            traj[slot] = torch.where(wmask_rec, value_rec, traj[slot])[0]
            price[slot] = infl[0]
            wr[yslot] = torch.where(wr_mask, wr_value, wr[yslot])[0]
        return dict(out, ytr=ytr, yg=yg, yr=yr, fyg=fyg, fyr=fyr)

    acc_end = [w if acc_months is None else min(w, int(acc_months))
               for w in w_list]
    if track:
        for m in range(1, acc_end[0] + 1):
            st = accum_month(m, st, draw(m))
        # retirement snapshot (straight-line, once, right after month W)
        st = snapshot(st, torch.ones_like(w_t, dtype=torch.bool))
        snap["start"] = st["b1"] + st["b2"]
        snap["infl_ret"] = st["infl"]
        if partial_wy:
            slot = min(full_wy + 1, L - 1)
            traj[slot] = snap["start"][0]
            price[slot] = snap["infl_ret"][0]
        for m in range(w + 1, t_end_list[0] + 1):
            st = ret_month(m, st, draw(m))
    else:
        w_min, w_max = min(w_list), max(w_list)
        acc_max = max(acc_end)
        acc_t = torch.tensor(acc_end, dtype=torch.int64, device=dev)[:, None]
        warps = -(-n // WARP)
        chunk = tile_plan(K, n, statics, "probe").months_per_chunk
        stopped = torch.zeros((K, warps), dtype=torch.bool, device=dev)
        steps = torch.zeros(K, dtype=torch.int64, device=dev)
        by_warp = lambda flags: torch.nn.functional.pad(
            flags, (0, warps * WARP - n)).reshape(K, warps, WARP).any(dim=2)
        if decided:
            settled = torch.zeros((K, warps), dtype=torch.bool, device=dev)
            steps_decided = torch.zeros(K, dtype=torch.int64, device=dev)
        for m in range(1, max(t_end_list) + 1):
            g = draw(m)
            acc_st = accum_month(m, st, g) if m <= acc_max else None
            ret_st = None
            if m > w_min:
                # A warp looks at its paths after a retirement month that
                # ends a retirement year or a chunk, and stops if none lives.
                v = m - 1
                looks = (v > w_t) & (((v - w_t) % Y == 0) | (v % chunk == 0))
                if bool(looks.any()):
                    live = by_warp(st["alive"] > 0.5)
                    stopped = stopped | (looks & ~live)
                    if decided:
                        # Undecided: alive, and its owner lives in month m.
                        undecided = by_warp((st["alive"] > 0.5)
                                            & ((v - w_t).to(dtype) < d_mort))
                        settled = settled | (looks & ~undecided)
                runs = ~stopped & (m > w_t) & (m <= t_end_t)
                steps = steps + runs.sum(dim=1)
                if decided:
                    steps_decided = steps_decided + (runs & settled).sum(dim=1)
                ret_st = ret_month(m, st, g)
            if ret_st is None and m <= min(acc_end):
                st = acc_st
            elif acc_st is None and w_max < m <= min(t_end_list):
                st = ret_st
            else:
                # Masked: some rows accumulate, retire, or wait (past the
                # scan's accumulation cap, before their W) or have ended.
                in_acc = m <= acc_t
                in_ret = (m > w_t) & (m <= t_end_t)
                new = {}
                for key, old in st.items():
                    v = old
                    if ret_st is not None:
                        v = torch.where(in_ret, ret_st[key], v)
                    if acc_st is not None:
                        v = torch.where(in_acc, acc_st[key], v)
                    new[key] = v
                st = new
            if m <= w_max:
                st = snapshot(st, w_t == m)

    out = {
        "success": st["alive"],
        "final_balance": torch.clamp(st["b1"] + st["b2"], min=0.0),
    }
    if not track:
        out["steps"] = steps
        if decided:
            out["decided"] = steps_decided
        if carry:
            out["carry"] = st
    if track:
        ytr = torch.where(st["alive"] > 0.5, math.nan, st["ytr"] / Y)
        out = {
            "success": st["alive"][0],
            "final_balance": out["final_balance"][0],
            "start_balance": snap["start"][0],
            "years_to_ruin": ytr[0],
            "first_year_gross": st["fyg"][0],
            "first_year_real_gross": st["fyr"][0],
            "inflation_at_retirement": snap["infl_ret"][0],
            "trajectory": traj.t(),
            "price_levels": price.t(),
            "withdrawal_rates": wr.t(),
        }
    return out


# ---------------------------------------------------------------------------
# The scan engine: the JAX package's ``engine/kernel.py::simulate_paths``
# ---------------------------------------------------------------------------
class PathOutputs(NamedTuple):
    """Per-path results of one batched simulation run (the JAX
    ``PathOutputs``). In probe mode (``traj_len == 0``) only ``success``
    and ``final_balance`` are set; the other fields are None."""

    success: torch.Tensor  # (n,) bool: every month of spending was funded
    final_balance: torch.Tensor  # (n,)
    start_balance: Optional[torch.Tensor]  # (n,) balance at retirement
    years_to_ruin: Optional[torch.Tensor]  # (n,) NaN when successful
    first_year_gross: Optional[torch.Tensor]  # (n,) nominal, year 0
    first_year_real_gross: Optional[torch.Tensor]  # (n,) retirement-date $
    inflation_at_retirement: Optional[torch.Tensor]  # (n,)
    trajectory: Optional[torch.Tensor]  # (n, L) yearly samples
    price_levels: Optional[torch.Tensor]  # (n, L)
    withdrawal_rates: Optional[torch.Tensor]  # (n, R) real % of start


class ScanDraws:
    """The scan engine's threefry draws of one stream key for the paths
    ``row_offset .. row_offset + n_paths``, one month at a time, in the
    plane layout of injected shocks: (z_eq, z_ind, z_prem) and with
    ``jumps`` the crash (u, z_j), antithetic pairing applied
    (``ops/shocks.monthly_normals``, ``monthly_jump_draws``,
    ``threefry_mortality_uniform``)."""

    def __init__(self, stream_key, n_paths: int, dtype, *,
                 antithetic: bool = False, jumps: bool = False,
                 row_offset: int = 0, device="cpu"):
        self.key = stream_key
        self.kw = dict(n_paths=int(n_paths), dtype=dtype,
                       antithetic=antithetic, row_offset=int(row_offset),
                       device=device)
        self.jumps = jumps

    def __call__(self, month: int) -> torch.Tensor:
        z = monthly_normals(self.key, month, **self.kw)
        if not self.jumps:
            return z
        u, z_j = monthly_jump_draws(self.key, month, **self.kw)
        return torch.cat([z, u[None], z_j[None]])

    def mortality(self) -> torch.Tensor:
        return threefry_mortality_uniform(self.key, **self.kw)


def _flag(t: torch.Tensor, what: str) -> bool:
    """One structural flag of every row of a (possibly stacked) leaf."""
    v = t.detach().cpu().reshape(-1)
    if v.numel() and bool((v != v[0]).any()):
        raise ValueError(f"the rows of a scan batch mix {what}")
    return bool(v[0]) if v.numel() else False


def scan_statics(params, antithetic: bool = False, jumps: bool = False,
                 mortality: bool = False) -> Statics:
    """The loop's ``Statics`` for parameters the JAX scan takes as data:
    tax systems and stream kinds from the leaves, the glide path and the
    guardrails wherever a row leaves their no-op sentinels (the scan runs
    them with the sentinels as exact no-ops; the loop skips them), the
    sampling, crash and longevity rules as given (compile-time in JAX
    too). Rows of a batch must share tax systems and stream kinds."""
    use1 = _flag(params.use_real1, "tax systems")
    use2 = _flag(params.use_real2, "tax systems")
    s = params.n_streams
    idx = params.stream_indexed.detach().cpu().reshape(-1, s) if s else None
    cap = (torch.isfinite(params.stream_duration_months.detach().cpu())
           .reshape(-1, s) if s else None)
    if s and (bool((idx != idx[0]).any()) or bool((cap != cap[0]).any())):
        raise ValueError("the rows of a scan batch mix stream kinds")
    any_ = lambda t: bool(t.detach().cpu().any())
    return Statics(
        use_real1=use1,
        use_real2=use2,
        bill1=(not use1) and any_(params.ann_tax1 > 0.0),
        bill2=(not use2) and any_(params.ann_tax2 > 0.0),
        stream_indexed=tuple(bool(v) for v in idx[0]) if s else (),
        stream_capped=tuple(bool(v) for v in cap[0]) if s else (),
        antithetic=bool(antithetic),
        glide=any_(params.alloc1_final != params.alloc1),
        guardrails=any_((params.gr_adjust != 0.0) | (params.gr_lower != 0.0)
                        | ~torch.isinf(params.gr_upper)
                        | (params.gr_floor != 1.0) | (params.gr_cap != 1.0)),
        jumps=bool(jumps),
        mortality=bool(mortality),
    )


def scan_chain(packed: Packed, statics: Statics, retirement_years: int,
               n_paths: int, stream_key, *, t_scan: int, row_offset: int = 0,
               traj_len: int = 0) -> Dict[str, torch.Tensor]:
    """The scan as a chain of torch ops: the loop above on ``ScanDraws`` of
    ``stream_key`` for the global paths ``row_offset ..``, in ``packed``'s
    dtype, accumulating while m <= min(W, t_scan - 12 R). The plain version
    of the scan kernels (``cuda_kernel.scan_rows_plain``/``scan_full_plain``)
    and, under ``torch.func.jvp``, of the JVP kernel on the scan's draws
    (``cuda_kernel.simulate_jvp_plain``)."""
    draws = ScanDraws(stream_key, n_paths, packed.fp.dtype,
                      antithetic=statics.antithetic, jumps=statics.jumps,
                      row_offset=row_offset, device=packed.device)
    return simulate(packed, statics, retirement_years, n_paths,
                    traj_len=traj_len, draws=draws,
                    acc_months=int(t_scan) - MONTHS_PER_YEAR * int(retirement_years))


def scan_block(params, months, retirement_years, dtype, antithetic=False,
               jumps=False, mortality=False, device=None, statics=None):
    """The scan kernels' argument block (``Packed``: ``params`` as one
    shared block or one row each, months as iparams rows, on ``device``)
    and the loop's structure (``statics``, default :func:`scan_statics`)."""
    device = torch.device(params.initial_balance.device if device is None
                          else device)
    require_device(device)
    months = [int(m) for m in months]
    if any(m < 0 for m in months):
        raise ValueError(f"working months must be >= 0: {months}")
    R = int(retirement_years)
    if statics is None:
        statics = scan_statics(params, antithetic, jumps, mortality)
    packed = Packed(fp=_fparams(params, dtype).to(device).contiguous(),
                    ip=_iparams(months, R, 0, 0, device),
                    n_streams=params.n_streams)
    return packed, statics


def scan_rows(params, months: Sequence[int], stream_key, *, n_paths: int,
              t_scan: int, retirement_years: int, dtype,
              antithetic: bool = False, jumps: bool = False,
              mortality: bool = False, row_offset: int = 0, device=None,
              traj_len: int = 0,
              statics: Optional[Statics] = None) -> Dict[str, torch.Tensor]:
    """The scan of every working-months row of ``months`` on one key's
    shared draws: ``params`` shared by the rows (the vmapped probe,
    ``runner.py::_probe_impl``) or one row each (a stacked batch,
    ``scenario_batch.py::_batch_impl``). Returns success (0/1) and final
    balance (K, n) and the retirement months run per row (``steps``, in
    warp-months), or the tracked fields for ``traj_len > 0`` (one row).
    On the card it launches the scan kernel (``cuda_kernel.scan_rows`` /
    ``scan_full``) or raises; on the CPU it runs their plain chain.

    ``statics`` (default: :func:`scan_statics` of ``params``) is the loop's
    structure when the caller fixes it; its ``antithetic``, ``jumps`` and
    ``mortality`` then select the draws."""
    packed, statics = scan_block(params, months, retirement_years, dtype,
                                  antithetic, jumps, mortality, device, statics)
    R = int(retirement_years)
    if traj_len > 0:
        return scan_full(packed, statics, R, n_paths, traj_len, stream_key,
                         t_scan=t_scan, row_offset=row_offset)
    out = scan_rows_kernel(packed, statics, R, n_paths, stream_key,
                           t_scan=t_scan, row_offset=row_offset)
    return {"success": out.success, "final_balance": out.final_balance,
            "steps": out.steps}


def simulate_paths(params, working_months, stream_key, *, n_paths: int,
                   t_scan: int, retirement_years: int, traj_len: int, dtype,
                   antithetic: bool = False, jumps: bool = False,
                   mortality: bool = False, row_offset: int = 0,
                   device=None, statics: Optional[Statics] = None
                   ) -> PathOutputs:
    """Simulate ``n_paths`` lifetimes at ``working_months`` on the scan
    engine's threefry stream ``stream_key`` (the JAX ``simulate_paths``,
    ``engine/kernel.py:124-213``, same arguments and results).

    The months run through the scan kernel on the card, through the plain
    loop's body one month's draws at a time on the CPU (``ScanDraws``):
    accumulation while m <= min(W, t_scan - 12 R), the retirement
    snapshot, then the 12 R retirement months. ``traj_len
    == 0`` is probe mode (success and final balance only); ``antithetic``,
    ``jumps`` and ``mortality`` select the paired sampling, the crash draws
    and the longevity draw. ``row_offset`` simulates the global paths
    ``row_offset ..`` of a larger batch (a shard); ``device`` defaults to
    the parameters' device; ``statics`` fixes the loop's structure (see
    :func:`scan_rows`).
    """
    out = scan_rows(params, [int(working_months)], stream_key,
                    n_paths=n_paths, t_scan=t_scan,
                    retirement_years=retirement_years, dtype=dtype,
                    antithetic=antithetic, jumps=jumps, mortality=mortality,
                    row_offset=row_offset, device=device, traj_len=traj_len,
                    statics=statics)
    if traj_len <= 0:
        return PathOutputs(out["success"][0] > 0.5, out["final_balance"][0],
                           *([None] * 8))
    return PathOutputs(
        success=out["success"] > 0.5,
        final_balance=out["final_balance"],
        start_balance=out["start_balance"],
        years_to_ruin=out["years_to_ruin"],
        first_year_gross=out["first_year_gross"],
        first_year_real_gross=out["first_year_real_gross"],
        inflation_at_retirement=out["inflation_at_retirement"],
        trajectory=out["trajectory"],
        price_levels=out["price_levels"],
        withdrawal_rates=out["withdrawal_rates"],
    )
