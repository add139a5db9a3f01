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
uniform; antithetic pairing does not apply to injected shocks), or from the
Philox stream of ``ops/shocks.py``. Candidates (rows of the packed iparams)
share one month's draws and differ in their working months and, in a
scenario grid, in their parameter rows (each parameter is a column that
broadcasts over the paths, so one vectorised loop runs K scenarios): a
candidate takes the accumulation step while m <= W and the retirement step
while W < m <= W + 12R, and its snapshot right after its own month W. The
loop runs in float64 on the CPU (the tests and the CPU engine) and in
float32 on the card, where it is the yardstick of the kernels.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..constants import MONTHS_PER_YEAR, SMALL_EPSILON
from ..ops.shocks import (
    gompertz_remaining_months,
    month_draws,
    mortality_uniform,
    pair_blocks,
    path_keys,
)
from ..ops.tax import (
    annual_tax,
    fail_rtol,
    monthly_rebalance,
    profile,
    rebalance_lite,
    withdraw_pro_rata,
)
from .cuda_kernel import F

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
) -> Dict[str, torch.Tensor]:
    """Run the month loop for every candidate row of ``packed``.

    ``packed.fp`` is one parameter block shared by the candidates (the
    probe) or one row per candidate (the scenario grid). Returns
    ``success`` and ``final_balance`` of shape (K, n); with
    ``traj_len > 0`` (one candidate only) also the tracked per-path vectors
    (n,) and the series ``trajectory``/``price_levels`` (n, traj_len) and
    ``withdrawal_rates`` (n, R).
    """
    R = int(retirement_years)
    n = int(n_paths)
    track = traj_len > 0
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
        if shocks is not None:
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
        if shocks is not None:
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

    if track:
        for m in range(1, w + 1):
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
        for m in range(1, max(t_end_list) + 1):
            g = draw(m)
            acc_st = accum_month(m, st, g) if m <= w_max else None
            ret_st = ret_month(m, st, g) if m > w_min else None
            if ret_st is None:
                st = acc_st
            elif acc_st is None and m <= min(t_end_list):
                st = ret_st
            else:
                in_acc = m <= w_t
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
