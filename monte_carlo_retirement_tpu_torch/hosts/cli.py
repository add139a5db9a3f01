"""CLI driver of the port: config -> search -> final run -> logs + PNG plots.

The main flow of the JAX package's ``hosts/cli.py`` (lines 390-543): load a
scenario JSON, estimate the required working months on the search stream,
run the final batch on the independent final stream, log the headline
results and percentiles, and write
``ret_proj_<scenario>_<timestamp>_{HIST,TRAJ}.png``.

Flags:
  --override N         skip the search and use N working months directly.
  --device {cuda,cpu}  where to run (default cuda: the CUDA kernels; an
                       absent card is an error, never a silent CPU run).
                       cpu runs the plain PyTorch versions in float64.

  python -m monte_carlo_retirement_tpu_torch.hosts.cli config.json
"""

from __future__ import annotations

import argparse
import datetime as _dt
import logging
import sys

from ..config import Config, ConfigurationError, load_config_from_json
from ..constants import MONTHS_PER_YEAR
from ..engine.simulator import (
    RetirementMonteCarloSimulator,
    median_first_year_withdrawal_rate,
    success_mask,
)
from ..logging_utils import (
    configure_logging,
    log_input_parameters,
    log_simulation_results,
)
from .plotting import plot_portfolio_trajectories, plot_simulation_results

log = logging.getLogger("mcrt.cli")


def _parse_args(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="mcrt-torch", description="PyTorch/CUDA retirement Monte Carlo CLI"
    )
    parser.add_argument("config", nargs="?", default="config.json",
                        help="scenario JSON path (default: config.json)")
    parser.add_argument("--override", type=int, default=None,
                        help="working months; skips the search phase")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    if args.override is not None and args.override < 0:
        parser.error("--override must be a nonnegative month count")
    return args


def main(argv=None) -> None:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    timestamp = _dt.datetime.now().strftime("%Y%m%d_%H%M%S")
    log_filename = f"ret_proj_log_{timestamp}.log"
    configure_logging(logfile=log_filename)
    log.info("Logging initialized. Log file: %s", log_filename)

    log.info("Loading configuration from: %s", args.config)
    try:
        config = Config(**load_config_from_json(args.config))
        log.info(
            "Configuration for scenario '%s' loaded and validated successfully.",
            config.Nickname,
        )
    except ConfigurationError as exc:
        log.error("Configuration file error: %s", exc)
        return
    except Exception as exc:
        log.error("Configuration validation error: %s", exc, exc_info=True)
        return

    log_input_parameters(config)
    simulator = RetirementMonteCarloSimulator(config, device=args.device)

    if args.override is not None:
        required = args.override
        log.info("Using working-months override: %d (search skipped)", required)
    else:
        log.info(
            "--- Estimating Required Working Months for '%s' ---", config.Nickname
        )
        required, achieved, _curve = simulator.find_minimum_working_months(
            verbose=True
        )
        if required == -1:
            log.error(
                "Target probability of %.2f%% could not be met for '%s'. "
                "Highest probability achieved: %.2f%%. Skipping final simulation.",
                config.target_probability,
                config.Nickname,
                achieved,
            )
            return
        log.info(
            "--- Search Complete. Required: %d m (%.1f yrs) with prob %.2f%%. ---",
            required,
            required / MONTHS_PER_YEAR,
            achieved,
        )

    log.info(
        "--- Running Final Detailed Simulation (%d sims, %d working months) ---",
        config.num_simulations_main,
        required,
    )
    simulator.use_final_seeds()
    results = simulator.run_monte_carlo_simulations(
        required, config.num_simulations_main
    )
    summary_df, traj_pct_df, samples = results[0], results[1], results[2]
    if summary_df.empty:
        log.error("Final simulation yielded no results.")
        return

    successes = success_mask(summary_df)
    success_prob = float(successes.mean() * 100.0)
    successful = summary_df.loc[successes, "Final Balance"]
    median_final = float(successful.median()) if not successful.empty else 0.0
    median_start = float(summary_df["Start Balance"].median())
    swr = median_first_year_withdrawal_rate(summary_df)

    log_simulation_results(
        config,
        required,
        success_prob,
        median_start,
        median_final,
        swr,
        summary_df["Final Balance"].to_numpy(),
    )

    safe_name = "".join(
        c if c.isalnum() or c in ("_", "-") else "_" for c in config.Nickname
    )
    base = f"ret_proj_{safe_name}_{timestamp}"
    plot_simulation_results(
        summary_df,
        config,
        {
            "required_working_months": required,
            "final_success_probability": success_prob,
            "median_start_retirement_balance": median_start,
            "median_final_balance": median_final,
            "SWR": swr,
        },
        f"{base}_HIST.png",
    )
    plot_portfolio_trajectories(
        traj_pct_df, samples, required, config, f"{base}_TRAJ.png"
    )
    log.info("--- Main execution finished for '%s'. Log: %s ---",
             config.Nickname, log_filename)


if __name__ == "__main__":
    main()
