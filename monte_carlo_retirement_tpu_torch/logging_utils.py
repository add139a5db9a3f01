"""Logging and run-report helpers (stdlib logging).

Plays the role of the reference's ``backend/utils.py`` (seed derivation,
config echo, result report) but is structured differently: instead of
keyword-sniffing field names at log time, each config field is registered
with an explicit display format, and the report is grouped by theme with
aligned columns. Unknown/extra fields still print via a generic fallback.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import logging
import sys
from logging.handlers import RotatingFileHandler
from typing import Optional

import numpy as np

from .config import Config
from .constants import MONTHS_PER_YEAR

LOG_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s:%(funcName)s:%(lineno)d - %(message)s"
DATE_FORMAT = "%Y-%m-%d %H:%M:%S"
MAX_LOG_BYTES = 10 * 1024 * 1024  # rotate file sinks at 10 MB

log = logging.getLogger("mcrt")


def configure_logging(
    level: int = logging.INFO, logfile: Optional[str] = None
) -> None:
    """Configure the 'mcrt' logger with a stderr sink and an optional
    size-rotated file sink (10 MB per file, 3 backups)."""
    logger = logging.getLogger("mcrt")
    logger.setLevel(level)
    for handler in logger.handlers:
        handler.close()  # release old file descriptors before dropping
    logger.handlers.clear()
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(logging.Formatter(LOG_FORMAT, DATE_FORMAT))
    logger.addHandler(stream)
    if logfile:
        fileh = RotatingFileHandler(
            logfile, maxBytes=MAX_LOG_BYTES, backupCount=3
        )
        fileh.setFormatter(logging.Formatter(LOG_FORMAT, DATE_FORMAT))
        logger.addHandler(fileh)


def generate_seed_from_timestamp() -> int:
    """Deterministic-given-time seed: SHA-256 of the current UTC ISO timestamp."""
    ts = _dt.datetime.now(_dt.timezone.utc).isoformat()
    return int.from_bytes(hashlib.sha256(ts.encode()).digest()[:8], "big") % (2**32 - 1)


# ---------------------------------------------------------------------------
# Config report: explicit per-field display registry, grouped by theme.
# ---------------------------------------------------------------------------

def _usd(v) -> str:
    return f"${v:,.2f}"


def _pct(v) -> str:
    return f"{v * 100:.2f}%"


def _raw(v) -> str:
    return str(v)


def _pct_opt(v) -> str:
    return "None (off)" if v is None else _pct(v)


# (section, field, formatter). Fields absent from this registry fall back to
# a generic str() line so schema additions never go unreported.
_FIELD_DISPLAY = (
    ("balances & cash flow", "initial_balance", _usd),
    ("balances & cash flow", "monthly_contribution", _usd),
    ("balances & cash flow", "contribution_growth_rate_annual", _pct),
    ("balances & cash flow", "monthly_expenses", _usd),
    ("timeline", "current_age", _raw),
    ("timeline", "retirement_years", _raw),
    ("portfolio & taxes", "allocation_inv1_pct", _pct),
    ("portfolio & taxes", "allocation_inv1_final_pct", _pct_opt),
    ("portfolio & taxes", "inv1_returns_mean", _pct),
    ("portfolio & taxes", "inv1_returns_volatility", _pct),
    ("portfolio & taxes", "inv1_annual_tax_on_gains_rate", _pct),
    ("portfolio & taxes", "inv1_realized_gains_tax_rate", _pct),
    ("portfolio & taxes", "inv1_use_realized_gains_tax_system", _raw),
    ("portfolio & taxes", "inv2_premium_over_inflation_mean", _pct),
    ("portfolio & taxes", "inv2_premium_over_inflation_volatility", _pct),
    ("portfolio & taxes", "inv2_annual_tax_on_gains_rate", _pct),
    ("portfolio & taxes", "inv2_realized_gains_tax_rate", _pct),
    ("portfolio & taxes", "inv2_use_realized_gains_tax_system", _raw),
    ("inflation", "inflation_rate_mean", _pct),
    ("inflation", "inflation_rate_volatility", _pct),
    ("inflation", "equity_inflation_correlation", _raw),
    ("simulation", "num_simulations_main", _raw),
    ("simulation", "num_simulations_search", _raw),
    ("simulation", "target_probability", lambda v: f"{v:.2f}%"),
    ("simulation", "starting_working_months_search", _raw),
    ("simulation", "seed", _raw),
    ("simulation", "antithetic", _raw),
    ("simulation", "num_processes", _raw),
)

_REGISTERED = {f for _, f, _fmt in _FIELD_DISPLAY}
_SKIP_GENERIC = {"Nickname", "other_income_streams"}


def _describe_stream(s) -> str:
    horizon = "open-ended" if s.duration_years is None else f"{s.duration_years}y"
    cola = "CPI-linked" if s.inflation_indexed else "fixed nominal from start"
    return (
        f"{s.name}: ${s.monthly_amount_today:,.0f}/mo today-$, "
        f"from age {s.start_at_age:g}, horizon {horizon}, {cola}, "
        f"taxed {s.tax_rate * 100:.0f}%"
    )


def log_input_parameters(config: Config) -> None:
    """Echo the effective configuration, grouped by theme with aligned keys."""
    log.info("=== scenario %r: effective configuration ===", config.Nickname)
    dumped = config.model_dump(by_alias=False)
    width = max(len(f) for _, f, _fmt in _FIELD_DISPLAY)
    section = None
    for sec, field, fmt in _FIELD_DISPLAY:
        if field not in dumped:
            continue
        if sec != section:
            section = sec
            log.info("[%s]", sec)
        log.info("  %-*s = %s", width, field, fmt(dumped[field]))
    extras = [
        k for k in dumped if k not in _REGISTERED and k not in _SKIP_GENERIC
    ]
    if extras:
        log.info("[other]")
        for k in extras:
            log.info("  %-*s = %s", width, k, dumped[k])
    log.info("[income streams]")
    if not config.other_income_streams:
        log.info("  (none)")
    for s in config.other_income_streams:
        log.info("  %s", _describe_stream(s))
    log.info(
        "  %-*s = %s (derived: 1 - allocation_inv1_pct)",
        width,
        "allocation_inv2_pct",
        _pct(config.allocation_inv2_pct),
    )
    log.info("=== end configuration ===")


def log_simulation_results(
    config: Config,
    required_w_months: int,
    final_success_prob_pct: float,
    median_start_ret_bal: float,
    median_final_bal_successful: float,
    swr: float,
    final_balances: np.ndarray,
) -> None:
    """Report headline metrics and the final-balance percentile ladder."""
    log.info("=== Final Simulation Results: scenario %r ===", config.Nickname)
    log.info(
        "working months required   : %d  (%.1f years)",
        required_w_months,
        required_w_months / MONTHS_PER_YEAR,
    )
    log.info(
        "success probability       : %.2f%%  (target %.2f%%)",
        final_success_prob_pct,
        config.target_probability,
    )
    log.info("median balance @ retire   : %s  (all paths)", _usd(median_start_ret_bal))
    log.info(
        "median final balance      : %s  (successful paths)",
        _usd(median_final_bal_successful),
    )
    log.info("first-year withdrawal rate: %.2f%%  (median real gross / start)", swr)
    bal = np.asarray(final_balances, dtype=float)
    ladder = ", ".join(
        f"p{p}={max(0.0, float(np.percentile(bal, p))):,.0f}"
        for p in (1, 5, 10, 25, 50, 75, 90, 95, 99)
    )
    log.info("final balance ladder ($)  : %s", ladder)
