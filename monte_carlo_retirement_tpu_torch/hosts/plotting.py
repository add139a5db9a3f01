"""CLI plot output: final-balance histogram + trajectory fan chart (PNG).

Covers the reference's two matplotlib figures
(reference: backend/plotting.py:25-193, 196-474): a histogram of successful
final balances annotated with inputs/results, and a percentile fan chart of
portfolio trajectories with retirement / income-stream markers.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
from matplotlib.ticker import FuncFormatter

from ..config import Config
from ..engine.simulator import success_mask
from ..constants import (
    MONTHS_PER_YEAR,
    SMALL_EPSILON,
    TEXT_INPUT_COLOR,
    TEXT_OUTPUT_COLOR,
)
from ..timing import (
    stream_payment_start_age,
    stream_payment_start_month_index,
    trajectory_time_points,
)

log = logging.getLogger("mcrt.plotting")

_MILLIONS = FuncFormatter(lambda x, _pos: f"${x:,.1f}M")


def _input_text(config: Config) -> str:
    lines = [
        "Inputs",
        f"Start balance: ${config.initial_balance:,.0f}",
        f"Contribution: ${config.monthly_contribution:,.0f}/mo "
        f"(+{config.contribution_growth_rate_annual * 100:.0f}%/yr)",
        f"Expenses: ${config.monthly_expenses:,.0f}/mo",
        f"Age: {config.current_age:g}, retirement {config.retirement_years} yrs",
        f"Inv1 {config.allocation_inv1_pct * 100:.0f}%: "
        f"{config.inv1_returns_mean * 100:.1f}% ± "
        f"{config.inv1_returns_volatility * 100:.1f}%",
        f"Inv2 premium: {config.inv2_premium_over_inflation_mean * 100:.1f}% ± "
        f"{config.inv2_premium_over_inflation_volatility * 100:.1f}%",
        f"Inflation: {config.inflation_rate_mean * 100:.1f}% ± "
        f"{config.inflation_rate_volatility * 100:.1f}%",
        f"Sims: {config.num_simulations_main} "
        f"(search {config.num_simulations_search})",
    ]
    for stream in config.other_income_streams:
        if stream.monthly_amount_today > SMALL_EPSILON:
            lines.append(
                f"{stream.name}: ${stream.monthly_amount_today:,.0f}/mo "
                f"from age {stream.start_at_age:g}"
            )
    return "\n".join(lines)


def _results_text(summary: Dict[str, Any]) -> str:
    months = summary.get("required_working_months", 0)
    return "\n".join(
        [
            "Results",
            f"Working period: {months} mo ({months / MONTHS_PER_YEAR:.1f} yrs)",
            f"Success: {summary.get('final_success_probability', 0.0):.1f}%",
            "Median @ retirement: "
            f"${summary.get('median_start_retirement_balance', 0.0):,.0f}",
            f"Median final: ${summary.get('median_final_balance', 0.0):,.0f}",
            f"SWR: {summary.get('SWR', float('nan')):.2f}%",
        ]
    )


def _save_figure(fig, filename: str, dpi: int, label: str) -> None:
    """Write a figure, creating the target directory and degrading
    gracefully on IO errors (log-and-continue, like the reference
    backend/plotting.py) — a full disk or bad path must not abort the CLI
    before it writes its remaining artifacts. Always closes the figure."""
    try:
        directory = os.path.dirname(filename)
        if directory:
            os.makedirs(directory, exist_ok=True)
        fig.savefig(filename, dpi=dpi)
        log.info("Saved %s plot: %s", label, filename)
    except OSError as exc:
        log.error("Could not save %s plot to %s: %s", label, filename, exc)
    finally:
        plt.close(fig)


def plot_simulation_results(
    results_df: pd.DataFrame,
    input_config: Config,
    analysis_summary: Dict[str, Any],
    filename: str,
) -> None:
    """Histogram of successful-path final balances with input/result boxes."""
    fig, ax = plt.subplots(figsize=(12, 7.5))

    cohort = results_df[success_mask(results_df)]
    rate = (len(cohort) / len(results_df) * 100.0) if len(results_df) else 0.0
    balances_m = cohort["Final Balance"].to_numpy(dtype=float) / 1e6

    if balances_m.size:
        ax.hist(
            balances_m,
            bins=100,
            edgecolor="black",
            alpha=0.7,
            label=f"Successful Outcomes ({rate:.1f}%)",
        )
        median_m = float(np.median(balances_m))
        ax.axvline(
            median_m,
            color="red",
            linestyle="--",
            linewidth=1.5,
            label=f"Median ${median_m:,.2f}M",
        )
    else:
        ax.text(
            0.5,
            0.5,
            "No successful outcomes",
            transform=ax.transAxes,
            ha="center",
            fontsize=14,
        )
    ax.axvline(0.0, color="black", linewidth=1.0)

    ax.text(
        0.02,
        0.98,
        _input_text(input_config),
        transform=ax.transAxes,
        va="top",
        fontsize=8,
        color=TEXT_INPUT_COLOR,
        bbox=dict(boxstyle="round", facecolor="white", alpha=0.8),
    )
    ax.text(
        0.35,
        0.98,
        _results_text(analysis_summary),
        transform=ax.transAxes,
        va="top",
        fontsize=8,
        color=TEXT_OUTPUT_COLOR,
        bbox=dict(boxstyle="round", facecolor="white", alpha=0.8),
    )

    ax.set_title(
        f"Final Balance Distribution — {input_config.Nickname} "
        f"({input_config.retirement_years}-yr retirement)"
    )
    ax.set_xlabel("Final balance ($M, nominal)")
    ax.set_ylabel("Simulations")
    ax.legend(loc="upper right")
    fig.tight_layout()
    _save_figure(fig, filename, dpi=150, label="histogram")


def plot_portfolio_trajectories(
    trajectory_percentiles_df: Optional[pd.DataFrame],
    sample_trajectories: Optional[List[List[float]]],
    working_months: int,
    input_config: Config,
    filename: str,
    dpi_setting: int = 300,
) -> None:
    """Percentile fan chart with retirement and income-stream markers."""
    if trajectory_percentiles_df is None or trajectory_percentiles_df.empty:
        log.warning("No trajectory percentile data for '%s'; skipping.", filename)
        return

    years = np.asarray(
        trajectory_time_points(working_months, input_config.retirement_years),
        dtype=float,
    )
    if len(years) != len(trajectory_percentiles_df):
        log.error(
            "Trajectory time-point count mismatch (%d != %d); skipping plot.",
            len(years),
            len(trajectory_percentiles_df),
        )
        return

    fig, ax = plt.subplots(figsize=(12, 7))

    for path in sample_trajectories or []:
        if len(path) == len(years):
            ax.plot(
                years,
                np.asarray(path, dtype=float) / 1e6,
                color="grey",
                alpha=0.25,
                linewidth=0.6,
                zorder=1,
            )

    cols = trajectory_percentiles_df.columns
    pct = lambda q: trajectory_percentiles_df[q].to_numpy(dtype=float) / 1e6
    if 0.05 in cols and 0.95 in cols:
        ax.fill_between(
            years, pct(0.05), pct(0.95), alpha=0.15, color="C0", label="P5–P95"
        )
    if 0.25 in cols and 0.75 in cols:
        ax.fill_between(
            years, pct(0.25), pct(0.75), alpha=0.30, color="C0", label="P25–P75"
        )
    if 0.50 in cols:
        ax.plot(years, pct(0.50), color="C0", linewidth=2.0, label="Median")

    retirement_year = working_months / MONTHS_PER_YEAR
    ax.axvline(
        retirement_year,
        color="red",
        linestyle="--",
        linewidth=1.2,
        label=f"Retirement ({retirement_year:.1f} yrs)",
    )
    for stream in input_config.other_income_streams or []:
        if stream.monthly_amount_today <= SMALL_EPSILON or stream.duration_years == 0:
            continue
        start_month = stream_payment_start_month_index(
            input_config.current_age, working_months, stream.start_at_age
        )
        start_year = retirement_year + start_month / MONTHS_PER_YEAR
        start_age = stream_payment_start_age(
            input_config.current_age, working_months, stream.start_at_age
        )
        ax.axvline(start_year, color="green", linestyle=":", linewidth=1.0)
        ax.annotate(
            f"{stream.name} (age {start_age:g})",
            xy=(start_year, ax.get_ylim()[1]),
            xytext=(3, -12),
            textcoords="offset points",
            fontsize=7,
            color="green",
            rotation=90,
            va="top",
        )

    ax.yaxis.set_major_formatter(_MILLIONS)
    ax.set_xlim(0.0, float(years[-1]) if len(years) else 1.0)
    ax.set_ylim(bottom=0.0)
    ax.set_title(f"Portfolio Trajectories — {input_config.Nickname}")
    ax.set_xlabel("Years from today")
    ax.set_ylabel("Portfolio balance (nominal)")
    ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    _save_figure(fig, filename, dpi=dpi_setting, label="trajectory")
