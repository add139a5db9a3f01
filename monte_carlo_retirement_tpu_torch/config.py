"""Configuration schema for retirement Monte Carlo scenarios.

The JSON schema is wire-compatible with the reference project's config files
(reference: backend/config.py:12-126): the same ``config.json`` documents load
unchanged. Validation bounds, aliases, derived fields and soft warnings match
the reference so that host layers (CLI/server/frontend) interoperate.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field, field_validator, ValidationInfo

log = logging.getLogger("mcrt.config")


class ConfigurationError(Exception):
    """A configuration file could not be read or parsed."""


class OtherIncomeStreamConfig(BaseModel):
    """One additional retirement income stream (pension, rent, annuity...).

    Payment timing: the stream is *eligible* from ``start_at_age`` but only
    pays during retirement, i.e. payments begin at
    ``max(retirement_age, start_at_age)`` (reference: backend/config.py:23-32).
    """

    name: str = Field(..., description="Display name for this income stream.")
    monthly_amount_today: float = Field(
        ..., ge=0, description="Monthly amount in T=0 (today's) real dollars."
    )
    start_at_age: float = Field(
        ..., ge=0, le=120, description="Age at which the stream becomes eligible."
    )
    duration_years: Optional[int] = Field(
        None,
        ge=0,
        description="Years of payments once started; None means indefinitely.",
    )
    inflation_indexed: bool = Field(
        True,
        description=(
            "True: tracks the price level from T=0. False: nominal amount is "
            "frozen at its value on the first payment date."
        ),
    )
    tax_rate: float = Field(..., ge=0.0, le=1.0, description="Tax on this income.")


class SpendingGuardrailsConfig(BaseModel):
    """Dynamic spending rule (extension — the reference's retirement
    spending is a fixed real amount): at the start of each retirement year
    after the first, the planned-spending multiplier adjusts when the
    planned withdrawal rate crosses a guardrail, Guyton-Klinger style.

    Precise semantics (both kernels + the test oracle implement this):
      * a per-path multiplier ``s`` starts at 1.0 (year 0 spends the plan,
        so first-year statistics are unchanged);
      * at retirement month indices 12, 24, ... (before that month's
        income/withdrawal), WR = 12 * monthly_expenses * s * price_level /
        balance-entering-the-month;
      * WR above ``upper_wr_pct`` cuts s by ``adjustment_pct`` percent; WR
        below ``lower_wr_pct`` raises it by the same; s then clamps to
        [floor_pct, cap_pct] of the original plan.
    """

    upper_wr_pct: float = Field(
        ..., gt=0.0, le=100.0,
        description="Cut spending when the planned WR exceeds this percent.",
    )
    lower_wr_pct: float = Field(
        ..., ge=0.0,
        description="Raise spending when the planned WR falls below this.",
    )
    adjustment_pct: float = Field(
        10.0, gt=0.0, le=50.0, description="Step size per trigger, percent."
    )
    floor_pct: float = Field(
        50.0, ge=0.0, le=100.0,
        description="Spending floor as a percent of the original plan.",
    )
    cap_pct: float = Field(
        200.0, ge=100.0,
        description="Spending cap as a percent of the original plan.",
    )

    @field_validator("lower_wr_pct")
    @classmethod
    def _bands_ordered(cls, v: float, info: ValidationInfo) -> float:
        upper = info.data.get("upper_wr_pct")
        if upper is not None and v >= upper:
            raise ValueError(
                f"lower_wr_pct ({v}) must be below upper_wr_pct ({upper})"
            )
        return v


class MarketCrashConfig(BaseModel):
    """Jump-diffusion crash risk (extension — the reference's returns are
    pure lognormal): in any month, with probability ``frequency_per_year/12``
    a market crash multiplies asset 1's gross return by a lognormal jump
    factor exp(J), J ~ Normal(log(1 - mean_drop_pct/100), size_volatility).
    Asset 2 takes ``inv2_beta`` of the same log jump. The monthly drift is
    compensated so E[annual gross] still equals 1 + configured mean — crashes
    reshape the return distribution (fat left tail, sequence-of-returns
    risk) without changing its mean, keeping the config's mean fields honest.

    Precise semantics (both kernels + the test oracle implement this):
      * per (path, month) draw one uniform u and one standard normal z from
        a stream independent of the base shocks (the base draws are
        bit-identical with the rule on or off);
      * J = log(1 - mean_drop_pct/100) + size_volatility * z when
        u < frequency_per_year/12, else 0;
      * gross1 *= exp(J - c1), gross2 *= exp(inv2_beta * J - c2) where
        c_a = log(1 - p + p * exp(a*mu_J + (a*sigma_J)^2 / 2)) is the exact
        compensator (a=1 for asset 1, a=inv2_beta for asset 2); inflation
        is untouched.
    """

    frequency_per_year: float = Field(
        ..., ge=0.0, le=12.0,
        description=(
            "Expected crashes per year; the monthly Bernoulli probability "
            "is this / 12 (so 12 means a crash every month)."
        ),
    )
    mean_drop_pct: float = Field(
        ..., gt=0.0, lt=100.0,
        description="Median crash size as a percent drop (20 => x0.80).",
    )
    size_volatility: float = Field(
        0.0, ge=0.0, le=2.0,
        description=(
            "Dispersion of the log jump size (0 = every crash is exactly "
            "the median drop)."
        ),
    )
    inv2_beta: float = Field(
        0.0, ge=0.0, le=1.0,
        description=(
            "Fraction of the log jump applied to asset 2 (0 = crashes hit "
            "asset 1 only; 1 = both assets crash identically)."
        ),
    )


class LongevityConfig(BaseModel):
    """Stochastic lifespan (extension — the reference funds a fixed
    ``retirement_years`` horizon): each path draws a remaining lifetime at
    the retirement date from a Gompertz law conditioned on having survived
    to that age, and success becomes "the money outlasted the owner".

    Precise semantics (both kernels + the test oracle implement this):
      * per path draw ONE uniform u from a stream disjoint from the base
        shocks (the base draws are bit-identical with the rule on or off);
      * remaining lifetime in months at retirement age ``x_ret``:
        ``t = 12*b * ln(1 - ln(u) * exp((mode_age - x_ret)/b))`` — the exact
        Gompertz inverse-survival with dispersion ``b`` — capped at
        ``(max_age - x_ret) * 12``; small u = long life, so antithetic
        pairing (u -> 1-u) anti-correlates lifespans;
      * the path spends normally through retirement months ``k <= t`` and
        then stops: expenses and income streams end with the owner, while
        the estate stays invested (growth, rebalancing and annual taxes
        continue) so the final balance is the bequest at the plan horizon;
      * ruin can only happen while the owner is alive — a path that would
        have run out of money after death counts as a success — and
        withdrawal-rate observations exist only for fully-lived years
        (later years are NaN, like the reference's post-ruin years).

    The same uniform is reused across working-month candidates (CRN), so a
    candidate that retires later samples the SAME longevity percentile
    conditioned on the later age — search curves stay smooth.
    """

    mode_age: float = Field(
        ..., gt=0.0, le=120.0,
        description=(
            "Gompertz modal age at death (the most likely age to die; "
            "~86-90 for current annuitant tables)."
        ),
    )
    dispersion_years: float = Field(
        10.0, ge=1.0, le=30.0,
        description=(
            "Gompertz dispersion b in years (~9-11 for human mortality; "
            "larger = more lifespan uncertainty)."
        ),
    )
    max_age: float = Field(
        120.0, gt=0.0, le=130.0,
        description="Hard cap: lifetimes truncate at this age.",
    )

    @field_validator("max_age")
    @classmethod
    def _cap_above_mode(cls, v: float, info: ValidationInfo) -> float:
        mode = info.data.get("mode_age")
        if mode is not None and v <= mode:
            raise ValueError(
                f"max_age ({v}) must exceed mode_age ({mode})"
            )
        return v


class Config(BaseModel):
    """Scenario configuration (same JSON schema as the reference config.json)."""

    Nickname: str = Field(
        "DefaultScenario", alias="scenario", description="Scenario nickname."
    )

    # Household economics
    initial_balance: float = Field(..., ge=0)
    monthly_contribution: float = Field(..., ge=0)
    contribution_growth_rate_annual: float = Field(0.0, ge=0)
    monthly_expenses: float = Field(
        ..., ge=0, description="Monthly spending in T=0 real dollars."
    )
    current_age: float = Field(..., ge=0, le=120)
    retirement_years: int = Field(..., gt=0)

    # Asset 1 ("equity-like"): arithmetic annual mean/vol, with either an
    # annual mark-to-market gains tax or a realized-gains tax on sales.
    allocation_inv1_pct: float = Field(..., ge=0.0, le=1.0)
    # Glide path (extension — the reference holds allocation fixed): when
    # set, the rebalance/contribution target for asset 1 moves LINEARLY in
    # time from allocation_inv1_pct at T=0 to this value at retirement
    # (month `working_months`), then holds through retirement. None (the
    # default) keeps the reference's constant-allocation behavior bit for
    # bit. The T=0 portfolio is always split at allocation_inv1_pct.
    allocation_inv1_final_pct: Optional[float] = Field(None, ge=0.0, le=1.0)
    inv1_returns_mean: float = Field(..., gt=-1.0)
    inv1_returns_volatility: float = Field(..., ge=0.0)
    # Annual expense ratio (extension — the reference's returns carry no
    # fees): a continuous drag deducted inside the fund, i.e. every monthly
    # gross factor is multiplied by (1 - ratio)^(1/12), making the realized
    # arithmetic mean (1 + mean)(1 - ratio) - 1. Folded into the lognormal
    # drift host-side, so the kernels are untouched and 0.0 (the default)
    # is bit-identical to the reference's fee-free model.
    inv1_expense_ratio_annual: float = Field(0.0, ge=0.0, lt=1.0)
    inv1_annual_tax_on_gains_rate: float = Field(..., ge=0.0, le=1.0)
    inv1_realized_gains_tax_rate: float = Field(0.0, ge=0.0, le=1.0)
    inv1_use_realized_gains_tax_system: bool = Field(False)

    # Asset 2 ("inflation-linked"): returns are inflation times a premium.
    inv2_premium_over_inflation_mean: float = Field(..., gt=-1.0)
    inv2_premium_over_inflation_volatility: float = Field(..., ge=0.0)
    # Annual expense ratio on asset 2 (see inv1_expense_ratio_annual);
    # applied to the whole asset return (inflation x premium x (1-ratio)
    # per year), folded into the premium drift.
    inv2_expense_ratio_annual: float = Field(0.0, ge=0.0, lt=1.0)
    inv2_annual_tax_on_gains_rate: float = Field(..., ge=0.0, le=1.0)
    inv2_realized_gains_tax_rate: float = Field(0.0, ge=0.0, le=1.0)
    inv2_use_realized_gains_tax_system: bool = Field(True)

    # Inflation process and its coupling to equity shocks.
    inflation_rate_mean: float = Field(..., gt=-1.0)
    inflation_rate_volatility: float = Field(..., ge=0.0)
    equity_inflation_correlation: float = Field(
        0.0,
        ge=-1.0,
        le=1.0,
        description="Correlation of equity log-returns with inflation log-rates.",
    )

    # Simulation controls
    num_simulations_main: int = Field(..., gt=0)
    num_simulations_search: int = Field(..., gt=0)
    target_probability: float = Field(..., ge=0.0, le=100.0)
    starting_working_months_search: int = Field(..., ge=0)
    seed: Optional[int] = Field(None, ge=0)
    # Variance reduction (extension — the reference has no analog): pair each
    # shock sequence with its negation. Unbiased for every reported statistic;
    # cuts the Monte Carlo error of means/percentiles at the same path count
    # (measured reduction documented in docs/CONFIG.md). Off by default so
    # default results match the reference's iid sampling model exactly.
    antithetic: bool = Field(False)
    # Dynamic spending rule (extension): None keeps the reference's fixed
    # real spending bit for bit; see SpendingGuardrailsConfig.
    spending_guardrails: Optional[SpendingGuardrailsConfig] = Field(None)
    # Jump-diffusion crash risk (extension): None keeps the reference's
    # pure-lognormal returns bit for bit; see MarketCrashConfig.
    market_crashes: Optional[MarketCrashConfig] = Field(None)
    # Stochastic lifespan (extension): None keeps the reference's fixed
    # retirement horizon bit for bit; see LongevityConfig.
    longevity: Optional[LongevityConfig] = Field(None)
    # Retained for config-file compatibility; the TPU engine parallelises over
    # devices instead of processes (reference used a multiprocessing.Pool).
    num_processes: Optional[int] = Field(1, ge=1)

    other_income_streams: List[OtherIncomeStreamConfig] = Field(default_factory=list)

    model_config = {"validate_by_name": True, "validate_assignment": True}

    @field_validator("inflation_rate_volatility")
    @classmethod
    def _warn_high_inflation_vol(cls, v: float, info: ValidationInfo) -> float:
        if v > 0.05:
            log.warning(
                "Scenario '%s' sets inflation volatility to %.1f%% — above the "
                "5%% sanity threshold; double-check the input is a fraction, "
                "not a percent.",
                info.data.get("Nickname", "N/A"),
                v * 100,
            )
        return v

    @field_validator("inv1_returns_volatility")
    @classmethod
    def _warn_low_equity_vol(cls, v: float, info: ValidationInfo) -> float:
        if v < 0.05:
            log.warning(
                "Scenario '%s' sets inv1 (equity) volatility to %.1f%% — below "
                "the 5%% sanity threshold (broad equity indices run near 15%%); "
                "ruin-risk estimates may look rosier than reality.",
                info.data.get("Nickname", "N/A"),
                v * 100,
            )
        return v

    @property
    def allocation_inv2_pct(self) -> float:
        return 1.0 - self.allocation_inv1_pct


def load_config_from_json(file_path: str) -> Dict[str, Any]:
    """Read a scenario JSON file into a plain dict (validate via ``Config``)."""
    if not os.path.exists(file_path):
        raise ConfigurationError(f"Configuration file not found at: {file_path}")
    try:
        with open(file_path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except json.JSONDecodeError as exc:
        raise ConfigurationError(f"Error parsing JSON file '{file_path}': {exc}") from exc
    except Exception as exc:  # pragma: no cover - unexpected IO failures
        raise ConfigurationError(
            f"Unexpected error reading config file '{file_path}': {exc}"
        ) from exc
