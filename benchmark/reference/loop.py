"""The month loop, frozen for the benchmark: plain PyTorch, no kernel.

It is the reference of every household the served path takes: two assets
under the realized-gains (average-cost) tax or none, an inflation process
correlated with equity, contributions that grow yearly, income streams
(CPI-indexed or fixed-nominal, capped or not), and the port's six
extensions: annual gain bills, a glide path, guardrails, crashes,
longevity and antithetic sampling. A configuration turns each on by its
own keys; one with none on runs none of their branches.

Accumulation months 1..W grow both assets, add the month's contribution at
the target allocation and rebalance with the sale's tax. Retirement months
W+1..W+12R: the spending need net of the streams, ruin checks before and
after growth, a withdrawal pro rata by net (after-tax) capacity, a
rebalance, and the year-end records of the tracked run. Rows of one call
share every month's draws and differ in their working months and, for a
scenario grid, in their parameters. Nothing here is taken from the program:
the parameters are worked out again from the configuration.

The extensions, by the schema's documentation of each rule:

- Annual gain bills: an asset outside the realized-gains system owes its
  annual rate on the positive market gains of each calendar year, settled
  at absolute months 12, 24, ... (and at the last month of a retirement
  that ends inside a year) from both assets pro rata by net capacity, then
  a rebalance. A bill left unpaid before retirement ruins the path at its
  retirement date; in retirement, that month (the last settle ruins it
  without moving the year's records).
- Glide path: asset 1's target moves linearly from ``allocation_inv1_pct``
  at month 0 to ``allocation_inv1_final_pct`` at month W, then holds; the
  month-0 portfolio is split at ``allocation_inv1_pct``.
- Guardrails: a spending multiplier s per path, 1 in the first retirement
  year. At retirement months 12, 24, ... (counted from 0), before that
  month's income, the planned rate 12 * expenses * s * price level over the
  balance entering the month cuts s by the step above the upper rail and
  raises it below the lower one; s then clamps to [floor, cap].
- Crashes: per path-month a uniform u and a normal z_j; where u < p (the
  yearly frequency / 12) the log jump J = log(1 - drop) + vol * z_j, else
  0. Asset 1's gross return is multiplied by exp(J - c1), asset 2's by
  exp(beta * J - c2), with the exact compensator c_a = log(1 - p + p *
  exp(a * mu_J + (a * sigma_J)^2 / 2)); inflation is untouched.
- Longevity: one uniform u per path, shared by every candidate month W.
  The remaining lifetime at retirement, in months, is the Gompertz inverse
  t = 12 b ln(1 - ln(u) exp((mode - x)/b)) at the retirement age x (taken
  in its overflow-safe two-branch form), capped at the maximum age. A
  retirement month with index i (0 the first) spends and draws income only
  while i < t; afterwards the estate stays invested (growth, rebalances and
  bills go on). Ruin needs a need, so it happens only while the owner
  lives, and a year's withdrawal rate is recorded only for a fully lived
  year (NaN after death).
- Antithetic sampling: global path blocks 2k and 2k + 1 share the draws of
  key block k; the odd block negates every normal and reflects every
  uniform, u -> 1 - u, the lifetime's too.

The arithmetic follows the served path's order of operations, so that in
float64 it equals the port's plain version bit for bit; the rules
themselves are checked apart from that order by properties of each
(``benchmark/tests/test_bench_extensions.py``).

The draws follow the port's documented layout: key (seed, key block),
counter (month, lane, 0, 0) gives words 0-2 for the three normals and word
3 for the crash uniform (planes 0-2 and 3); counter (month, lane, 1, 0)
gives the crash normal from its word 0 (plane 4); key (seed ^ 668265261,
key block), counter (0, lane, 2, 0) gives the lifetime uniform from its
word 0 (plane 5 of month 0 in an injected-shocks tensor; no month draw
uses month 0). A uniform takes 23 bits: (bits >> 9) * 2^-23, in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from . import philox

EPS = 1e-6
Y = 12
DRAW_MONTHS = 16  # months of draws made at once (one pass of the Philox rounds)
LIFETIME_SALT = 668265261
CRASH_COUNTER, LIFETIME_COUNTER = 1, 2
INV_2_23 = 1.0 / float(1 << 23)
# The schema's defaults of each rule's optional fields.
DEFAULTS = {
    "spending_guardrails": {"adjustment_pct": 10.0, "floor_pct": 50.0, "cap_pct": 200.0},
    "market_crashes": {"size_volatility": 0.0, "inv2_beta": 0.0},
    "longevity": {"dispersion_years": 10.0, "max_age": 120.0},
}


def fail_rtol(dtype) -> float:
    """Relative slack of a funding-failure comparison: the stated float32
    arithmetic carries hundreds of ulps of rounding in a balance."""
    return 0.0 if dtype == torch.float64 else 2e-5


def _log_params(mean: float, vol: float):
    if vol == 0:
        return math.log(1.0 + mean), 0.0
    gross = 1.0 + mean
    sigma = math.sqrt(math.log(1.0 + vol * vol / (gross * gross)))
    return math.log(gross) - 0.5 * sigma * sigma, sigma


def _streams(cfg: dict) -> List[dict]:
    return [s for s in cfg.get("other_income_streams") or []
            if s["monthly_amount_today"] > 1e-6 and s.get("duration_years") != 0]


class Structure(NamedTuple):
    """What a configuration turns on: the loop's branches."""

    use1: bool
    use2: bool
    bill1: bool
    bill2: bool
    kinds: tuple  # per income stream (indexed, capped)
    antithetic: bool
    glide: bool
    guardrails: bool
    jumps: bool
    mortality: bool


def structure(cfg: dict) -> Structure:
    """The loop's structure of a configuration; rows of one call share it."""
    use1 = bool(cfg.get("inv1_use_realized_gains_tax_system", False))
    use2 = bool(cfg.get("inv2_use_realized_gains_tax_system", True))
    return Structure(
        use1=use1, use2=use2,
        bill1=not use1 and cfg["inv1_annual_tax_on_gains_rate"] > 0,
        bill2=not use2 and cfg["inv2_annual_tax_on_gains_rate"] > 0,
        kinds=tuple((bool(s["inflation_indexed"]), s.get("duration_years") is not None)
                    for s in _streams(cfg)),
        antithetic=bool(cfg.get("antithetic", False)),
        glide=cfg.get("allocation_inv1_final_pct") is not None,
        guardrails=cfg.get("spending_guardrails") is not None,
        jumps=cfg.get("market_crashes") is not None,
        mortality=cfg.get("longevity") is not None,
    )


def _rule(cfg: dict, key: str) -> dict:
    return {**DEFAULTS[key], **(cfg.get(key) or {})}


def _host(cfg: dict) -> Dict[str, float]:
    """Every parameter of ``cfg`` in float64."""
    mu1, s1 = _log_params(cfg["inv1_returns_mean"], cfg["inv1_returns_volatility"])
    mui, si = _log_params(cfg["inflation_rate_mean"], cfg["inflation_rate_volatility"])
    mup, sp = _log_params(cfg["inv2_premium_over_inflation_mean"],
                          cfg["inv2_premium_over_inflation_volatility"])
    mu1 += math.log1p(-cfg.get("inv1_expense_ratio_annual", 0.0))
    mup += math.log1p(-cfg.get("inv2_expense_ratio_annual", 0.0))
    out = dict(
        mu1=mu1, s1=s1, mui=mui, si=si, mup=mup, sp=sp,
        rho=cfg.get("equity_inflation_correlation", 0.0),
        alloc1=cfg["allocation_inv1_pct"], init=cfg["initial_balance"],
        contrib=cfg["monthly_contribution"],
        growth=cfg.get("contribution_growth_rate_annual", 0.0),
        expenses=cfg["monthly_expenses"],
        r1=cfg.get("inv1_realized_gains_tax_rate", 0.0),
        r2=cfg.get("inv2_realized_gains_tax_rate", 0.0),
    )
    for i, s in enumerate(_streams(cfg)):
        out[f"amount{i}"] = s["monthly_amount_today"]
        out[f"from_t0_{i}"] = (float(s["start_at_age"]) - float(cfg["current_age"])) * Y
        dur = s.get("duration_years")
        out[f"duration{i}"] = math.inf if dur is None else float(dur) * Y
        out[f"tax{i}"] = s["tax_rate"]
    final = cfg.get("allocation_inv1_final_pct")
    out.update(ann1=cfg["inv1_annual_tax_on_gains_rate"],
               ann2=cfg["inv2_annual_tax_on_gains_rate"],
               alloc_f=out["alloc1"] if final is None else final)
    if cfg.get("spending_guardrails") is not None:
        g = _rule(cfg, "spending_guardrails")
        out.update(gr_up=g["upper_wr_pct"] / 100.0, gr_lo=g["lower_wr_pct"] / 100.0,
                   gr_adj=g["adjustment_pct"] / 100.0, gr_floor=g["floor_pct"] / 100.0,
                   gr_cap=g["cap_pct"] / 100.0)
    if cfg.get("market_crashes") is not None:
        c = _rule(cfg, "market_crashes")
        p = c["frequency_per_year"] / Y
        mu = math.log(1.0 - c["mean_drop_pct"] / 100.0)
        sig, beta = c["size_volatility"], c["inv2_beta"]
        out.update(jp=p, jmu=mu, jsig=sig, jbeta=beta,
                   jc1=math.log((1.0 - p) + p * math.exp(mu + 0.5 * sig * sig)),
                   jc2=math.log((1.0 - p) + p * math.exp(beta * mu + 0.5 * (beta * sig) ** 2)))
    if cfg.get("longevity") is not None:
        lg = _rule(cfg, "longevity")
        age = cfg["current_age"]
        out.update(mort_g0=(lg["mode_age"] - age) / lg["dispersion_years"],
                   mort_b12=Y * lg["dispersion_years"],
                   mort_cap=max(0.0, (lg["max_age"] - age) * Y))
    return out


def parameters(configs: Sequence[dict], dtype, device) -> Dict[str, torch.Tensor]:
    """Every parameter as a (K, 1) column, one row per configuration (or
    one row shared by every candidate month), derived in ``dtype`` from
    the host's float64 values."""
    if len({structure(c) for c in configs}) != 1:
        raise ValueError("the rows of one call must share their structure")
    hosts = [_host(c) for c in configs]

    def col(name):
        v = torch.tensor([[h[name]] for h in hosts], dtype=torch.float64)
        return v.to(device=device, dtype=dtype)

    p = {
        "mu1": col("mu1") / Y, "s1": col("s1") / math.sqrt(Y),
        "mui": col("mui") / Y, "si": col("si") / math.sqrt(Y),
        "mup": col("mup") / Y, "sp": col("sp") / math.sqrt(Y),
        "rho": col("rho"), "alloc1": col("alloc1"), "init": col("init"),
        "contrib": col("contrib"), "log1p_growth": torch.log1p(col("growth")),
        "expenses": col("expenses"), "r1": col("r1"), "r2": col("r2"),
    }
    p["rho_c"] = torch.sqrt(torch.clamp(1.0 - p["rho"] ** 2, min=0.0))
    for i in range(len(structure(configs[0]).kinds)):
        p[f"amount{i}"] = col(f"amount{i}")
        p[f"from_t0_{i}"] = col(f"from_t0_{i}")
        p[f"duration{i}"] = torch.clamp(col(f"duration{i}"), max=3.0e7)
        p[f"net{i}"] = 1.0 - col(f"tax{i}")
    for name in ("ann1", "ann2", "alloc_f", "gr_up", "gr_lo", "gr_adj", "gr_floor",
                 "gr_cap", "jp", "jmu", "jsig", "jbeta", "jc1", "jc2", "mort_g0",
                 "mort_b12", "mort_cap"):
        if name in hosts[0]:
            p[name] = col(name)
    return p


# --- the tax algebra -------------------------------------------------------
def profile(b, c, use, rate):
    """(tax per gross dollar sold, net per gross dollar, net capacity)."""
    live = b > EPS
    if not use:
        return torch.zeros_like(b), torch.ones_like(b), torch.where(live, b, 0.0)
    gf = torch.clamp(b - c, min=0.0) / torch.where(live, b, 1.0)
    eff = gf * rate
    nf = 1.0 - eff
    return eff, nf, torch.where(live, b * nf, 0.0)


def rebalance(b1, c1, b2, c2, eff1, eff2, a1, extra_noop=None):
    """Sell the over-weight asset so the post-tax weights are exact; the
    buyer's basis grows by the net purchase."""
    total = b1 + b2
    drift1 = b1 - total * a1
    adrift = drift1.abs()
    sell1 = drift1 > 0
    noop = (total <= EPS) | (adrift <= EPS)
    if extra_noop is not None:
        noop = noop | extra_noop
    bal_s = torch.where(sell1, b1, b2)
    basis_s = torch.where(sell1, c1, c2)
    eff_s = torch.where(sell1, eff1, eff2)
    alloc_s = torch.where(sell1, a1, 1.0 - a1)
    gross = torch.minimum(bal_s, adrift / torch.clamp(1.0 - alloc_s * eff_s, min=EPS))
    frac = gross / torch.where(bal_s > EPS, bal_s, 1.0)
    net_p = gross * (1.0 - eff_s)
    new_sb = bal_s - gross
    new_sc = basis_s - basis_s * frac
    bal_b = torch.where(sell1, b2, b1) + net_p
    basis_b = torch.where(sell1, c2, c1) + net_p
    ob1 = torch.where(sell1, new_sb, bal_b)
    oc1 = torch.where(sell1, new_sc, basis_b)
    ob2 = torch.where(sell1, bal_b, new_sb)
    oc2 = torch.where(sell1, basis_b, new_sc)
    z1, z2 = ob1 <= EPS, ob2 <= EPS
    ob1, oc1 = torch.where(z1, 0.0, ob1), torch.where(z1, 0.0, oc1)
    ob2, oc2 = torch.where(z2, 0.0, ob2), torch.where(z2, 0.0, oc2)
    return (torch.where(noop, b1, ob1), torch.where(noop, c1, oc1),
            torch.where(noop, b2, ob2), torch.where(noop, c2, oc2))


def withdraw(b1, c1, b2, c2, need, prof1, prof2, wmask):
    """Withdraw net ``need`` pro rata by net capacity (one sale fraction,
    1 when the need exceeds the capacity). Returns the balances, bases,
    gross sold and net delivered."""
    _, nf1, nc1 = prof1
    _, nf2, nc2 = prof2
    tnc = nc1 + nc2
    frac = torch.clamp(torch.where(need >= tnc, 1.0, need / torch.clamp(tnc, min=EPS)),
                       max=1.0) * torch.where(wmask, 1.0, 0.0).to(b1.dtype)
    keep = 1.0 - frac
    ok1, ok2 = nc1 > 0, nc2 > 0
    g1 = torch.where(ok1, b1 * frac, 0.0)
    g2 = torch.where(ok2, b2 * frac, 0.0)
    net = g1 * nf1 + g2 * nf2
    c1 = torch.where(ok1, c1 * keep, c1)
    c2 = torch.where(ok2, c2 * keep, c2)
    b1, b2 = b1 - g1, b2 - g2
    e1, e2 = b1 <= EPS, b2 <= EPS
    return (torch.where(e1, 0.0, b1), torch.where(e1, 0.0, c1),
            torch.where(e2, 0.0, b2), torch.where(e2, 0.0, c2), g1 + g2, net)


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """A 32-bit word as a uniform on [0, 1 - 2^-23], float32 (exact)."""
    return (bits >> 9).to(torch.float32) * INV_2_23


def remaining_months(u, g0, b12, cap, w_f):
    """The Gompertz remaining lifetime in months at retirement after W
    months, at most ``cap`` months after today: with g = g0 - W / b12 (the
    modal age less the retirement age, in dispersions), b12 ln(1 - ln(u)
    e^g), written g + ln(e^-g - ln u) where g > 0 so that e^g cannot
    overflow."""
    g = g0 - w_f / b12
    log_u = torch.log(u)
    low = torch.log1p(-log_u * torch.exp(g))
    high = g + torch.log(torch.exp(-g) - log_u)
    t = b12 * torch.where(g > 0, high, low)
    return torch.minimum(t, torch.clamp(cap - w_f, min=0.0))


# --- the loop ----------------------------------------------------------------
class Loop:
    """The month loop of rows sharing one structure: ``configs`` (one
    shared by every row, or one per row) at the working months
    ``months``, on ``n`` paths of the Philox stream ``seed`` that start at
    the global 4096-path block ``block_offset``."""

    def __init__(self, configs: Sequence[dict], months: Sequence[int], seed: int,
                 n: int, dtype=torch.float32, device="cpu", block_offset: int = 0):
        self.rules = structure(configs[0])
        self.R = int(configs[0]["retirement_years"])
        if any(int(c["retirement_years"]) != self.R for c in configs):
            raise ValueError("rows must share retirement_years")
        self.dtype, self.device = dtype, torch.device(device)
        self.p = p = parameters(configs, dtype, self.device)
        self.months = [int(m) for m in months]
        self.w = torch.tensor(self.months, device=self.device)[:, None]
        self.w_f = self.w.to(dtype)
        self.t_end = self.w + Y * self.R
        self.seed, self.n = int(seed), int(n)
        block, self.lane = philox.path_index(n, self.device)
        block = block + int(block_offset)
        self.odd = None
        if self.rules.antithetic:
            self.odd, block = (block & 1).bool(), block >> 1
        self.block = block
        self.rtol = fail_rtol(dtype)
        self._drawn = None
        self.start = [torch.clamp(torch.ceil(torch.clamp(
            p[f"from_t0_{i}"] - self.w_f, min=0.0) - EPS), min=0.0)
            for i in range(len(self.rules.kinds))]
        self.alloc_ret = p["alloc_f"] if self.rules.glide else p["alloc1"]
        if self.rules.glide:
            self.glide_step = (p["alloc_f"] - p["alloc1"]) / torch.clamp(self.w_f, min=1.0)
        if self.rules.mortality:
            w = philox.words(self.seed ^ LIFETIME_SALT, self.block, 0, self.lane,
                             counter=LIFETIME_COUNTER)[0]
            u = self._pair(uniform(w), reflect=True).to(dtype)
            self.lifetime = remaining_months(u, p["mort_g0"], p["mort_b12"],
                                             p["mort_cap"], self.w_f)

    def _pair(self, x: torch.Tensor, reflect: bool) -> torch.Tensor:
        """The antithetic pairing of a draw: the odd block's normal
        negated, its uniform reflected."""
        if self.odd is None:
            return x
        return torch.where(self.odd, 1.0 - x if reflect else -x, x)

    def planes(self, m: int) -> torch.Tensor:
        """Month m's (3, n) normals, or (5, n) with the crash uniform and
        normal, float32, drawn ``DRAW_MONTHS`` months at a time."""
        first = (m - 1) // DRAW_MONTHS * DRAW_MONTHS + 1
        if self._drawn is None or self._drawn[0] != first:
            months = torch.arange(first, first + DRAW_MONTHS, device=self.device)[:, None]
            w0, w1, w2, w3 = philox.words(self.seed, self.block, months, self.lane)
            z = [self._pair(philox.to_normal(w), reflect=False) for w in (w0, w1, w2)]
            if self.rules.jumps:
                zj = philox.words(self.seed, self.block, months, self.lane,
                                  counter=CRASH_COUNTER)[0]
                z += [self._pair(uniform(w3), reflect=True),
                      self._pair(philox.to_normal(zj), reflect=False)]
            self._drawn = (first, torch.stack(z))
        return self._drawn[1][:, m - first]

    def draw(self, m: int):
        """The month's gross factors (equity, inflation, asset 2), the
        crash's compensated jump folded into the exponents."""
        p = self.p
        z = self.planes(m).to(self.dtype)
        z_inf = p["rho"] * z[0] + p["rho_c"] * z[1]
        gi = torch.exp(p["mui"] + p["si"] * z_inf)
        if self.rules.jumps:
            jump = torch.where(z[3] < p["jp"], p["jmu"] + p["jsig"] * z[4], 0.0)
            g1 = torch.exp(p["mu1"] + p["s1"] * z[0] + (jump - p["jc1"]))
            gp = torch.exp(p["mup"] + p["sp"] * z[2] + (p["jbeta"] * jump - p["jc2"]))
        else:
            g1 = torch.exp(p["mu1"] + p["s1"] * z[0])
            gp = torch.exp(p["mup"] + p["sp"] * z[2])
        return g1, gi, gi * gp

    def initial(self, rows: int) -> dict:
        p = self.p
        shape = (rows, self.n)
        b1 = (p["init"] * p["alloc1"]).expand(shape).contiguous()
        b2 = p["init"] - b1
        full = lambda v: torch.full(shape, v, dtype=self.dtype, device=self.device)
        st = dict(b1=b1, c1=b1.clone(), b2=b2, c2=b2.clone(), infl=full(1.0),
                  alive=full(1.0))
        if self.rules.bill1 or self.rules.bill2:
            st.update(g1a=full(0.0), g2a=full(0.0), preret=full(0.0))
        for i, (indexed, _) in enumerate(self.rules.kinds):
            if not indexed:
                st[f"fixed{i}"] = full(-1.0)
        if self.rules.guardrails:
            st["smult"] = full(1.0)
        return st

    def _bill(self, b1, c1, b2, c2, g1a, g2a, a1):
        """Settle one year's gain bills: (b1, c1, b2, c2, unpaid)."""
        p, rules = self.p, self.rules
        dues = [torch.clamp(gain, min=0.0) * p[rate] for billed, gain, rate in
                ((rules.bill1, g1a, "ann1"), (rules.bill2, g2a, "ann2")) if billed]
        due = dues[0] if len(dues) == 1 else dues[0] + dues[1]
        prof1 = profile(b1, c1, rules.use1, p["r1"])
        prof2 = profile(b2, c2, rules.use2, p["r2"])
        tnc = prof1[2] + prof2[2]
        payment = torch.minimum(due, tnc)
        tol = EPS + self.rtol * (due + tnc)
        b1, c1, b2, c2, _, _ = withdraw(b1, c1, b2, c2, due, prof1, prof2,
                                        (tnc > EPS) & (payment > 0))
        unpaid = payment < due - tol
        eff1 = profile(b1, c1, rules.use1, p["r1"])[0]
        eff2 = profile(b2, c2, rules.use2, p["r2"])[0]
        b1, c1, b2, c2 = rebalance(b1, c1, b2, c2, eff1, eff2, a1)
        return b1, c1, b2, c2, unpaid

    def accumulate(self, m: int, s: dict, g) -> dict:
        p, rules = self.p, self.rules
        g1, gi, g2 = g
        out = dict(s)
        bills = rules.bill1 or rules.bill2
        if bills:
            out["g1a"] = s["g1a"] + s["b1"] * (g1 - 1.0)
            out["g2a"] = s["g2a"] + s["b2"] * (g2 - 1.0)
        b1, b2, infl = s["b1"] * g1, s["b2"] * g2, s["infl"] * gi
        contrib = p["contrib"] * torch.exp(p["log1p_growth"] * ((m - 1) // Y))
        a1 = p["alloc1"] + self.glide_step * m if rules.glide else p["alloc1"]
        ca1 = contrib * a1
        ca2 = contrib - ca1
        b1, c1 = b1 + ca1, s["c1"] + ca1
        b2, c2 = b2 + ca2, s["c2"] + ca2
        eff1 = profile(b1, c1, rules.use1, p["r1"])[0]
        eff2 = profile(b2, c2, rules.use2, p["r2"])[0]
        b1, c1, b2, c2 = rebalance(b1, c1, b2, c2, eff1, eff2, a1)
        if bills and m % Y == 0:
            b1, c1, b2, c2, unpaid = self._bill(b1, c1, b2, c2, out["g1a"], out["g2a"], a1)
            out["g1a"], out["g2a"] = out["g1a"] * 0.0, out["g2a"] * 0.0
            out["preret"] = torch.where(unpaid, 1.0, s["preret"])
        out.update(b1=b1, c1=c1, b2=b2, c2=c2, infl=infl)
        return out

    def retired(self, s: dict, rows: torch.Tensor) -> dict:
        """The retirement date of ``rows``: a bill left unpaid before it
        ruins the path."""
        if not (self.rules.bill1 or self.rules.bill2):
            return s
        return dict(s, alive=torch.where(rows & (s["preret"] > 0.5), 0.0, s["alive"]))

    def retire(self, m: int, s: dict, g, track: dict = None) -> dict:
        """One retirement month; ``track`` (one row) also keeps the
        year's withdrawals and the records."""
        p, rules = self.p, self.rules
        b1, c1, b2, c2, infl = s["b1"], s["c1"], s["b2"], s["c2"], s["infl"]
        alive_f = s["alive"]
        alive = alive_f > 0.5
        out = dict(s)
        ret_idx_f = (m - self.w - 1).to(self.dtype)
        price0 = infl
        expenses = p["expenses"]
        if rules.guardrails:
            smult = s["smult"]
            year_start = [(m - w - 1) % Y == 0 and m - w - 1 > 0 for w in self.months]
            if any(year_start):
                rate = 12.0 * p["expenses"] * smult * price0 / torch.clamp(b1 + b2, min=EPS)
                new = torch.where(rate > p["gr_up"], smult * (1.0 - p["gr_adj"]), smult)
                new = torch.where(rate < p["gr_lo"], smult * (1.0 + p["gr_adj"]), new)
                new = torch.minimum(torch.maximum(new, p["gr_floor"]), p["gr_cap"])
                at = torch.tensor(year_start, device=self.device)[:, None]
                smult = torch.where(at & alive, new, smult)
            out["smult"] = smult
            expenses = expenses * smult
        need = expenses * price0
        income = None
        for i, (indexed, capped) in enumerate(rules.kinds):
            active = ret_idx_f >= self.start[i]
            if capped:
                active = active & (ret_idx_f < self.start[i] + p[f"duration{i}"])
            if indexed:
                nominal = p[f"amount{i}"] * price0
            else:
                slot = s[f"fixed{i}"]
                nominal = torch.where(active & (ret_idx_f == self.start[i]) & (slot < 0),
                                      p[f"amount{i}"] * price0, slot)
                out[f"fixed{i}"] = nominal
            inc = torch.where(active, nominal * p[f"net{i}"], 0.0)
            income = inc if income is None else income + inc
        if income is not None:
            need = torch.clamp(need - income, min=0.0)
        living = None
        if rules.mortality:
            living = ret_idx_f < self.lifetime
            need = torch.where(living, need, 0.0)
        dies_a = alive & (b1 + b2 <= EPS) & (need > EPS)
        g1, gi, g2 = g
        gmask = alive & ~dies_a
        bills = rules.bill1 or rules.bill2
        if bills:
            out["g1a"] = s["g1a"] + torch.where(gmask, b1 * (g1 - 1.0), 0.0)
            out["g2a"] = s["g2a"] + torch.where(gmask, b2 * (g2 - 1.0), 0.0)
        b1 = torch.where(gmask, b1 * g1, b1)
        b2 = torch.where(gmask, b2 * g2, b2)
        infl = torch.where(gmask, infl * gi, infl)
        total = b1 + b2
        dies_b = gmask & (total <= EPS) & (need > EPS)
        wmask = gmask & ~dies_b
        prof1 = profile(b1, c1, rules.use1, p["r1"])
        prof2 = profile(b2, c2, rules.use2, p["r2"])
        ftol = EPS + self.rtol * (need + total)
        b1, c1, b2, c2, gross, net = withdraw(b1, c1, b2, c2, need, prof1, prof2, wmask)
        fail = wmask & (need > EPS) & (net < need - ftol)
        b1, c1, b2, c2 = rebalance(b1, c1, b2, c2, prof1[0], prof2[0], self.alloc_ret,
                                   extra_noop=~wmask)
        dies = dies_a | dies_b | fail
        recorded = dies  # the ruin that the year's records see
        if bills:
            year_end = m % Y == 0
            settles = [m == w + Y * self.R and w % Y != 0 for w in self.months]
            if year_end or any(settles):
                tb1, tc1, tb2, tc2, unpaid = self._bill(b1, c1, b2, c2, out["g1a"],
                                                        out["g2a"], self.alloc_ret)
                if year_end:
                    mask = wmask & ~fail
                else:
                    settle = torch.tensor(settles, device=self.device)[:, None]
                    mask = settle & alive & ~dies
                b1, c1 = torch.where(mask, tb1, b1), torch.where(mask, tc1, c1)
                b2, c2 = torch.where(mask, tb2, b2), torch.where(mask, tc2, c2)
                dies = dies | (mask & unpaid)
                if year_end:
                    out["g1a"] = torch.where(mask, 0.0, out["g1a"])
                    out["g2a"] = torch.where(mask, 0.0, out["g2a"])
                    recorded = dies
        out.update(b1=b1, c1=c1, b2=b2, c2=c2, infl=infl,
                   alive=torch.where(dies, 0.0, alive_f))
        if track is not None:
            self._record(m, out, alive_f, recorded, gross, price0, living, track)
        return out

    def _record(self, m, out, alive0_f, dies, gross, price0, living, t):
        """The tracked run's year records (one row)."""
        k = m - self.months[0]
        if k % Y == 1:
            t["yg"], t["yr"] = torch.zeros_like(t["yg"]), torch.zeros_like(t["yr"])
        t["yg"] = t["yg"] + gross
        t["yr"] = t["yr"] + gross / torch.clamp(price0, min=EPS)
        t["ytr"] = t["ytr"] + alive0_f
        was_alive = alive0_f > 0.5
        if k <= Y:
            cap = was_alive & (dies | (k % Y == 0))
            t["fyg"] = torch.where(cap, t["yg"], t["fyg"])
            t["fyr"] = torch.where(cap, t["yr"] * t["infl_ret"], t["fyr"])
        if k % Y == 0:
            L = t["traj"].shape[0]
            slot = min(t["full_wy"] + t["partial_wy"] + (k + Y - 1) // Y, L - 1)
            yslot = min(max(k // Y - 1, 0), self.R - 1)
            total = out["b1"] + out["b2"]
            ytr = t["ytr"]
            died = (ytr > (k // Y - 1) * Y + 0.5) & (ytr < k + 0.5)
            alive_now = out["alive"] > 0.5
            rec = alive_now | died
            value = torch.where(rec, torch.where(alive_now, total,
                                                 torch.clamp(total, min=0.0)), 0.0)
            start = t["start"]
            wr_value = torch.where(start > EPS, t["yr"] * t["infl_ret"]
                                   / torch.clamp(start, min=EPS) * 100.0, 0.0)
            lived = was_alive & ~dies
            if living is not None:
                lived = lived & living
            t["traj"][slot] = torch.where(rec, value, t["traj"][slot])[0]
            t["price"][slot] = out["infl"][0]
            t["wr"][yslot] = torch.where(lived, wr_value, t["wr"][yslot])[0]

    def rows(self) -> Dict[str, torch.Tensor]:
        """Every row: ``success`` (0/1) and ``final_balance``, (K, n)."""
        K = len(self.months)
        st = self.initial(K)
        w_min, w_max = min(self.months), max(self.months)
        t_end = [m + Y * self.R for m in self.months]
        for m in range(1, max(t_end) + 1):
            g = self.draw(m)
            acc = self.accumulate(m, st, g) if m <= w_max else None
            ret = self.retire(m, st, g) if m > w_min else None
            if ret is None:
                st = acc
            elif acc is None and m <= min(t_end):
                st = ret
            else:
                in_acc = m <= self.w
                in_ret = (m > self.w) & (m <= self.t_end)
                new = {}
                for key, old in st.items():
                    v = old
                    if ret is not None:
                        v = torch.where(in_ret, ret[key], v)
                    if acc is not None:
                        v = torch.where(in_acc, acc[key], v)
                    new[key] = v
                st = new
            if m <= w_max:
                st = self.retired(st, self.w == m)
        return {"success": st["alive"],
                "final_balance": torch.clamp(st["b1"] + st["b2"], min=0.0)}

    def tracked(self) -> Dict[str, torch.Tensor]:
        """One row's per-path vectors (n,) and its yearly series as (L, n)
        and (R, n), L = 1 + ceil(W / 12) + R."""
        if len(self.months) != 1:
            raise ValueError("the tracked loop takes one row")
        w = self.months[0]
        full_wy, partial_wy = w // Y, int(w % Y != 0)
        L = 1 + full_wy + partial_wy + self.R
        z = lambda: torch.zeros((1, self.n), dtype=self.dtype, device=self.device)
        traj = torch.zeros((L, self.n), dtype=self.dtype, device=self.device)
        traj[0] = self.p["init"][0, 0]
        price = torch.ones((L, self.n), dtype=self.dtype, device=self.device)
        wr = torch.full((self.R, self.n), math.nan, dtype=self.dtype, device=self.device)
        st = self.initial(1)
        for m in range(1, w + 1):
            st = self.accumulate(m, st, self.draw(m))
            if m % Y == 0:
                traj[min(m // Y, L - 1)] = (st["b1"] + st["b2"])[0]
                price[min(m // Y, L - 1)] = st["infl"][0]
        st = self.retired(st, torch.ones((1, 1), dtype=torch.bool, device=self.device))
        t = dict(yg=z(), yr=z(), fyg=z(), fyr=z(), ytr=z(), traj=traj, price=price,
                 wr=wr, full_wy=full_wy, partial_wy=partial_wy,
                 start=st["b1"] + st["b2"], infl_ret=st["infl"])
        if partial_wy:
            traj[min(full_wy + 1, L - 1)] = t["start"][0]
            price[min(full_wy + 1, L - 1)] = t["infl_ret"][0]
        for m in range(w + 1, w + Y * self.R + 1):
            st = self.retire(m, st, self.draw(m), track=t)
        alive = st["alive"][0]
        return {
            "success": alive,
            "final_balance": torch.clamp(st["b1"] + st["b2"], min=0.0)[0],
            "start_balance": t["start"][0],
            "years_to_ruin": torch.where(alive > 0.5, math.nan, t["ytr"][0] / Y),
            "first_year_gross": t["fyg"][0],
            "first_year_real_gross": t["fyr"][0],
            "inflation_at_retirement": t["infl_ret"][0],
            "trajectory": traj, "price_levels": price, "withdrawal_rates": wr,
        }


def success_pct(cfg_rows: Sequence[dict], months: Sequence[int], seed: int, n: int,
                dtype=torch.float32, device="cpu", block_paths: int = 1 << 20
                ) -> np.ndarray:
    """Success percentage of every row, computed in blocks of whole
    4096-path key blocks so that it fits beside nothing else."""
    counts = np.zeros(len(months), dtype=np.int64)
    for start in range(0, n, block_paths):
        size = min(block_paths, n - start)
        run = Loop(cfg_rows, months, seed, size, dtype, device,
                   block_offset=start // philox.BLOCK_PATHS)
        counts += (run.rows()["success"] > 0.5).sum(dim=1).cpu().numpy()
    return counts / n * 100.0
