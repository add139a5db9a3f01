"""The plain month loop: the port's reference for both CUDA kernels.

Paths form the vector axis and months a Python loop with the phases of the
JAX Pallas body (``pallas_kernel.py:348-1173``): accumulation months 1..W,
the retirement snapshot, then retirement months W+1..W+12R with ruin
checks A and B, the capacity-limited withdrawal, the monthly rebalance, the
year-end records and their death-padding rules, the first-year capture and
the alive-months counter that becomes years-to-ruin (NaN for survivors).

Shocks come either injected, ``(T, 3, n)`` with month m reading row m-1, or
from the Philox stream of ``ops/shocks.py``. Candidates (rows of the packed
iparams) share one month's draws and differ in their working months and,
in a scenario grid, in their parameter rows (each parameter is a column
that broadcasts over the paths, so one vectorised loop runs K scenarios):
a candidate takes the accumulation step while m <= W and the retirement
step while W < m <= W + 12R. The loop runs in float64 on the CPU (the
tests and the CPU engine) and in float32 on the card, where it is the
yardstick of the kernels. Only the compile-time ``Statics`` of the slice
are implemented; ``cuda_kernel.check_slice`` rejects the others first.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..constants import MONTHS_PER_YEAR, SMALL_EPSILON
from ..ops.shocks import month_normals, path_keys
from ..ops.tax import (
    fail_rtol,
    monthly_rebalance,
    profile,
    rebalance_lite,
    withdraw_pro_rata,
)
from .cuda_kernel import F

EPS = SMALL_EPSILON
Y = MONTHS_PER_YEAR


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

    if shocks is None:
        gblock, lane = path_keys(n, boff, dev)

    def draw(m):
        if shocks is not None:
            z = shocks[m - 1].to(dtype)
        else:
            z = month_normals(seed, gblock, m, lane).to(dtype)
        z_inf = rho * z[0] + rho_c * z[1]
        g1 = torch.exp(mu1 + s1 * z[0])
        gi = torch.exp(mui + si * z_inf)
        gp = torch.exp(mup + sp * z[2])
        return g1, gi, gi * gp

    shape = (K, n)
    b1 = (init_bal * alloc1).expand(shape).contiguous()
    b2 = init_bal - b1
    st = {
        "b1": b1, "c1": b1.clone(), "b2": b2, "c2": b2.clone(),
        "infl": torch.ones(shape, dtype=dtype, device=dev),
        "alive": torch.ones(shape, dtype=dtype, device=dev),
    }
    if track:
        L = int(traj_len)
        zeros = torch.zeros(shape, dtype=dtype, device=dev)
        st.update(ytr=zeros, yg=zeros, yr=zeros, fyg=zeros, fyr=zeros)
        traj = torch.zeros((L, n), dtype=dtype, device=dev)
        traj[0] = init_bal[0, 0]
        price = torch.ones((L, n), dtype=dtype, device=dev)
        wr = torch.full((R, n), math.nan, dtype=dtype, device=dev)
        w = w_list[0]
        full_wy, partial_wy = w // Y, int(w % Y != 0)
        snap = {}

    def accum_month(m, s):
        g1, gi, g2 = draw(m)
        b1, b2 = s["b1"] * g1, s["b2"] * g2
        infl = s["infl"] * gi
        years = (m - 1) // Y
        contrib = contrib0 * torch.exp(log1p_growth * years)
        ca1 = contrib * alloc1
        ca2 = contrib - ca1
        b1, c1 = b1 + ca1, s["c1"] + ca1
        b2, c2 = b2 + ca2, s["c2"] + ca2
        b1, c1, b2, c2 = monthly_rebalance(
            b1, c1, b2, c2, alloc1, use1, r1, use2, r2
        )
        if track and m % Y == 0:
            slot = min(m // Y, L - 1)
            traj[slot] = (b1 + b2)[0]
            price[slot] = infl[0]
        return dict(s, b1=b1, c1=c1, b2=b2, c2=c2, infl=infl)

    def ret_month(m, s):
        b1, c1, b2, c2 = s["b1"], s["c1"], s["b2"], s["c2"]
        infl, alive_f = s["infl"], s["alive"]
        alive = alive_f > 0.5
        alive0_f = alive_f
        ret_idx_f = (m - w_t - 1).to(dtype)
        if track:
            k = m - w
            yg, yr = s["yg"], s["yr"]
            if k % Y == 1:
                yg, yr = torch.zeros_like(yg), torch.zeros_like(yr)

        # --- income waterfall & net spending need
        price0 = infl
        need = expenses * price0
        if S:
            net_income = None
            for i in range(S):
                inc = torch.where(
                    ret_idx_f >= stream_start[i],
                    s_amount[i] * price0 * stream_net[i],
                    0.0,
                )
                net_income = inc if net_income is None else net_income + inc
            need = torch.clamp(need - net_income, min=0.0)

        # --- ruin check A, then growth (dead/ruined paths freeze)
        dies_a = alive & (b1 + b2 <= EPS) & (need > EPS)
        g1, gi, g2 = draw(m)
        gmask = alive & ~dies_a
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
            b1, c1, b2, c2, prof1[0], prof2[0], alloc1, extra_noop=~wmask
        )
        dies = dies_a | dies_b | fail_net
        alive_f = torch.where(dies, 0.0, alive_f)
        out = dict(s, b1=b1, c1=c1, b2=b2, c2=c2, infl=infl, alive=alive_f)
        if not track:
            return out

        ytr = s["ytr"] + alive0_f
        fyg, fyr = s["fyg"], s["fyr"]
        if k <= Y:  # first retirement year: capture at death or year end
            cap_fy = (alive0_f > 0.5) & (dies | (k % Y == 0))
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
            wr_mask = (alive0_f > 0.5) & ~dies
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
            st = accum_month(m, st)
        # retirement snapshot (straight-line, once, right after month W)
        snap["start"] = st["b1"] + st["b2"]
        snap["infl_ret"] = st["infl"]
        if partial_wy:
            slot = min(full_wy + 1, L - 1)
            traj[slot] = snap["start"][0]
            price[slot] = snap["infl_ret"][0]
        for m in range(w + 1, t_end_list[0] + 1):
            st = ret_month(m, st)
    else:
        w_min, w_max = min(w_list), max(w_list)
        for m in range(1, max(t_end_list) + 1):
            acc_st = accum_month(m, st) if m <= w_max else None
            ret_st = ret_month(m, st) if m > w_min else None
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
