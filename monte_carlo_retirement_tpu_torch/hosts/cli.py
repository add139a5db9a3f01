"""CLI driver of the port: config -> search -> final run -> logs + PNG plots.

The main flow of the JAX package's ``hosts/cli.py`` (lines 390-543): load a
scenario JSON, estimate the required working months on the search stream,
run the final batch on the independent final stream, log the headline
results and percentiles, and write
``ret_proj_<scenario>_<timestamp>_{HIST,TRAJ}.png`` (and, with --json-out,
the /api/simulate response payload of that batch).

Flags:
  --override N         skip the search and use N working months directly.
  --device {cuda,cpu}  where every mode runs (default cuda: the CUDA kernels;
                       an absent card is an error, never a silent CPU run).
                       cpu runs the plain PyTorch versions in float64.

The analysis modes of the JAX CLI (its lines 107-387), one at a time:
  --grid PATH          scenario-grid mode: PATH is a JSON grid request (the
                       /api/grid body without the base "config" key, which
                       comes from the positional scenario file): {"variants":
                       [{"name", "overrides"}...], "working_months": N | [N...],
                       "num_paths"?, "chunk_size"?}. Prints a per-variant table.
  --sensitivity [P]    sensitivity mode: finite differences of each requested
                       config field (comma-separated; bare flag = the default
                       tornado set) over a common-random-numbers scenario grid
                       at the searched (or --override) month count.
  --optimize SPEC      optimize mode: SPEC is PARAM[:LO:HI], or two such specs
                       comma-separated for a joint 2-D product grid; maximizes
                       success probability (or --opt-objective) by batched
                       grid refinement at the searched (or --override) month
                       count. --opt-points/--opt-rounds size the refinement.
  --json-out PATH      write the response payload here: the main run's
                       SimulationResponse, or the analysis mode's
                       (GridResponse, SensitivityResponse,
                       Optimize(Joint)Response).

  python -m monte_carlo_retirement_tpu_torch.hosts.cli config.json
  python -m monte_carlo_retirement_tpu_torch.hosts.cli config.json --grid req.json
  python -m monte_carlo_retirement_tpu_torch.hosts.cli config.json --override 231 --sensitivity
  python -m monte_carlo_retirement_tpu_torch.hosts.cli config.json --override 231 \\
      --optimize allocation_inv1_pct:0.3:0.9
"""

from __future__ import annotations

import argparse
import datetime as _dt
import json
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
    parser.add_argument("--json-out", default=None,
                        help="write the response payload JSON here (the "
                             "main run's /api/simulate payload, or the "
                             "analysis mode's)")
    parser.add_argument("--grid", default=None, metavar="PATH",
                        help="scenario-grid request JSON; runs the grid "
                             "instead of search+final")
    parser.add_argument("--sensitivity", nargs="?", const="default",
                        default=None, metavar="PARAMS",
                        help="sensitivity mode: comma-separated config "
                             "fields to probe (bare flag = the default "
                             "tornado set); uses --override months or runs "
                             "the search first, prints the derivative "
                             "table, honors --json-out")
    parser.add_argument("--optimize", default=None,
                        metavar="PARAM[:LO:HI][,PARAM2[:LO:HI]]",
                        help="optimize mode: maximize success probability "
                             "over one config field, or two jointly via a "
                             "product grid (optional LO:HI search "
                             "intervals, required for unbounded fields); "
                             "uses --override months or runs the search "
                             "first, prints the refinement result, honors "
                             "--json-out")
    parser.add_argument("--opt-points", default=None, type=int,
                        metavar="K",
                        help="optimize mode: grid points per axis per "
                             "refinement round (default 17 single-field, "
                             "13 per axis jointly)")
    parser.add_argument("--opt-rounds", default=None, type=int,
                        metavar="R",
                        help="optimize mode: refinement rounds, each one "
                             "batched dispatch (default 3)")
    parser.add_argument("--opt-objective", default=None, metavar="NAME",
                        help="optimize mode: metric to maximize (default "
                             "success_probability; also "
                             "median/mean/p5/p25_final_balance)")
    args = parser.parse_args(argv)
    if args.override is not None and args.override < 0:
        parser.error("--override must be a nonnegative month count")
    modes = [m for m, v in (("--grid", args.grid),
                            ("--sensitivity", args.sensitivity),
                            ("--optimize", args.optimize)) if v is not None]
    if len(modes) > 1:
        parser.error(f"{' and '.join(modes)} are mutually exclusive")
    if args.optimize is None:
        for flag, value in (("--opt-points", args.opt_points),
                            ("--opt-rounds", args.opt_rounds),
                            ("--opt-objective", args.opt_objective)):
            if value is not None:
                parser.error(f"{flag} requires --optimize")
    return args


def _run_grid_mode(args, config_raw: dict) -> None:
    """Scenario-grid CLI: one batched sweep, a table, optional JSON out."""
    from .grid import GridRequest, GridResponse, prepare_grid, run_prepared_grid

    try:
        with open(args.grid, encoding="utf-8") as fh:
            grid_raw = json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        log.error("Could not read grid request %s: %s", args.grid, exc)
        return
    try:
        request = GridRequest(**{"config": config_raw, **grid_raw})
        prepared = prepare_grid(request)
    except Exception as exc:
        log.error("Invalid grid request: %s", exc)
        return

    def progress(event: dict) -> None:
        log.info("grid progress: %d/%d variants (%.1fs)",
                 event["done"], event["total"], event["elapsed_s"])

    try:
        result = run_prepared_grid(
            prepared, request.chunk_size, progress_callback=progress,
            device=args.device,
        )
    except ValueError as exc:
        log.error("Grid cannot run: %s", exc)
        return
    payload = GridResponse.model_validate(result).model_dump(mode="json")

    name_w = max(len(r["name"]) for r in payload["rows"]) + 2
    log.info("--- Scenario grid: %d variants x %s paths ---",
             payload["total_scenarios"], f"{payload['num_paths']:,}")
    header = (f"{'variant':<{name_w}} {'months':>6} {'success':>9} "
              f"{'±σ':>6} {'p5':>14} {'median':>14} {'p95':>14} {'mean':>14}")
    log.info(header)
    for r in payload["rows"]:
        p = r["final_balance_percentiles"]
        log.info(
            f"{r['name']:<{name_w}} {r['working_months']:>6} "
            f"{r['success_probability']:>8.2f}% {r['success_sigma']:>6.2f} "
            f"{p['p5']:>14,.0f} {p['p50']:>14,.0f} {p['p95']:>14,.0f} "
            f"{r['mean_final_balance']:>14,.0f}"
        )
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, allow_nan=False)
        log.info("Grid payload written to %s", args.json_out)


def _analysis_months(args, config: Config, mode: str):
    """Working months for an analysis mode: the --override value, or the
    searched minimum. Returns None (after logging) when the target is
    unreachable and no override was given."""
    if args.override is not None:
        log.info("%s at override: %d working months",
                 mode.capitalize(), args.override)
        return args.override
    log.info("--- Estimating Required Working Months for '%s' ---",
             config.Nickname)
    simulator = RetirementMonteCarloSimulator(config, device=args.device)
    months, achieved, _ = simulator.find_minimum_working_months(verbose=True)
    if months == -1:
        log.error(
            "Target probability of %.2f%% could not be met for '%s' "
            "(best: %.2f%%); running the %s at the search ceiling "
            "instead requires --override.",
            config.target_probability, config.Nickname, achieved, mode,
        )
        return None
    log.info("Search complete: %d months (%.2f%%)", months, achieved)
    return months


def _run_sensitivity_mode(args, config_raw: dict, config: Config) -> None:
    """Sensitivity CLI: derivative table for the requested parameters at the
    searched (or overridden) working-month count."""
    from .sensitivity import (
        SensitivityRequest,
        SensitivityResponse,
        prepare_sensitivity,
        run_sensitivity_request,
    )

    months = _analysis_months(args, config, "sensitivity analysis")
    if months is None:
        return

    params = None
    if args.sensitivity != "default":
        params = [p.strip() for p in args.sensitivity.split(",") if p.strip()]
    try:
        request = SensitivityRequest(
            config=config_raw, working_months=months, params=params
        )
        prepared = prepare_sensitivity(request)
    except Exception as exc:
        log.error("Invalid sensitivity request: %s", exc)
        return
    try:
        payload = run_sensitivity_request(request, prepared,
                                          device=args.device)
    except ValueError as exc:
        log.error("Sensitivity analysis cannot run: %s", exc)
        return
    payload = SensitivityResponse.model_validate(payload).model_dump(
        mode="json", exclude_none=True
    )

    rows = payload["rows"]
    name_w = max(len(r["param"]) for r in rows) + 2
    log.info(
        "--- Sensitivity: %d parameters x %s paths at %d months "
        "(base success %.2f%% ± %.2f) ---",
        len(rows), f"{payload['num_paths']:,}", months,
        rows[0]["success_base"], rows[0]["success_sigma"],
    )
    header = (f"{'parameter':<{name_w}} {'value':>14} {'Δ/step':>9} "
              f"{'d succ/unit':>13} {'d mean$/unit':>13} "
              f"{'d p5$/unit':>13} {'step':>11}")
    log.info(header)
    for r in rows:
        log.info(
            f"{r['param']:<{name_w}} {r['base_value']:>14,.4g} "
            f"{r['success_per_step']:>+8.3f}% {r['d_success']:>13.4g} "
            f"{r['d_mean_final']:>13.4g} {r['d_p5_final']:>13.4g} "
            f"{r['practical_step']:>11.4g}"
        )
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, allow_nan=False)
        log.info("Sensitivity payload written to %s", args.json_out)


def _run_optimize_mode(args, config_raw: dict, config: Config) -> None:
    """Optimize CLI: maximize success probability over one config field —
    or two jointly (comma-separated specs, a product grid per round) — at
    the searched (or overridden) working-month count."""
    from .optimize import (
        OptimizeRequest,
        prepare_optimize,
        request_target,
        response_model,
        run_optimize_request,
    )

    months = _analysis_months(args, config, "optimization")
    if months is None:
        return

    spec = args.optimize
    entries = []
    for part in spec.split(","):
        fields = part.split(":")
        entry = {"name": fields[0]}
        if len(fields) == 3:
            try:
                entry["lo"], entry["hi"] = float(fields[1]), float(fields[2])
            except ValueError:
                log.error(
                    "Invalid optimize bounds in %r (want PARAM[:LO:HI])",
                    part,
                )
                return
        elif len(fields) != 1:
            log.error("Invalid --optimize spec %r (want PARAM[:LO:HI])",
                      part)
            return
        entries.append(entry)
    body = {"config": config_raw, "working_months": months}
    if len(entries) == 1:  # single-field form (scalar response shape)
        body["param"] = entries[0]["name"]
        body["lo"] = entries[0].get("lo")
        body["hi"] = entries[0].get("hi")
    else:
        body["params"] = entries
    if args.opt_points is not None:
        body["points"] = args.opt_points
    if args.opt_rounds is not None:
        body["rounds"] = args.opt_rounds
    if args.opt_objective is not None:
        body["objective"] = args.opt_objective
    try:
        request = OptimizeRequest(**body)
        prepared = prepare_optimize(request)
    except Exception as exc:
        log.error("Invalid optimize request: %s", exc)
        return

    def progress(event: dict) -> None:
        if event.get("type") != "optimize_round":
            return
        if "best_value" in event:
            log.info(
                "optimize round %d/%d: best %s=%.6g (objective %.4g) in "
                "[%.6g, %.6g]",
                event["round"], event["rounds"], request.param,
                event["best_value"], event["best_objective"],
                event["interval"][0], event["interval"][1],
            )
        else:
            log.info(
                "optimize round %d/%d: best %s=%s (objective %.4g) in %s",
                event["round"], event["rounds"], request_target(request),
                [round(v, 6) for v in event["best_values"]],
                event["best_objective"],
                [[round(b, 6) for b in iv] for iv in event["intervals"]],
            )

    try:
        payload = run_optimize_request(
            request, prepared, progress_callback=progress, device=args.device
        )
    except ValueError as exc:
        log.error("Optimization cannot run: %s", exc)
        return
    payload = response_model(request).model_validate(payload).model_dump(
        mode="json"
    )

    best = payload["best"]
    log.info(
        "--- Optimize: %s over '%s' at %d months x %s paths ---",
        payload["objective"], request_target(request), months,
        f"{payload['num_paths']:,}",
    )
    if "params" in payload:
        log.info(
            "best %s = %s (base %s): success %.2f%% ± %.2f, median final "
            "%s, mean final %s (%d evaluations, refined intervals %s)",
            " x ".join(payload["params"]),
            [round(v, 6) for v in best["values"]],
            [round(v, 6) for v in payload["base_values"]],
            best["success_probability"], payload["success_sigma"],
            f"{best['median_final_balance']:,.0f}",
            f"{best['mean_final_balance']:,.0f}",
            payload["evaluations"],
            [[round(b, 6) for b in iv] for iv in payload["intervals"]],
        )
        k = payload["points_per_axis"]
        log.info(
            "round-1 surface (%d x %d, rows = %s ascending): %s",
            k, k, payload["params"][0],
            " ".join(
                f"{p['values'][0]:.3g},{p['values'][1]:.3g}:"
                f"{p['success_probability']:.1f}%"
                for p in payload["surface"][:: max(1, k + 1)]
            ),  # the grid diagonal keeps the log line bounded
        )
    else:
        log.info(
            "best %s = %.6g (base %.6g): success %.2f%% ± %.2f, median final "
            "%s, mean final %s (%d evaluations, refined interval "
            "[%.6g, %.6g])",
            payload["param"], best["value"], payload["base_value"],
            best["success_probability"], payload["success_sigma"],
            f"{best['median_final_balance']:,.0f}",
            f"{best['mean_final_balance']:,.0f}",
            payload["evaluations"], payload["interval"][0],
            payload["interval"][1],
        )
        log.info("round-1 sweep: %s",
                 " ".join(f"{p['value']:.3g}:{p['success_probability']:.1f}%"
                          for p in payload["curve"]))
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, allow_nan=False)
        log.info("Optimize payload written to %s", args.json_out)


def main(argv=None) -> None:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    timestamp = _dt.datetime.now().strftime("%Y%m%d_%H%M%S")
    log_filename = f"ret_proj_log_{timestamp}.log"
    configure_logging(logfile=log_filename)
    log.info("Logging initialized. Log file: %s", log_filename)

    log.info("Loading configuration from: %s", args.config)
    try:
        config_raw = load_config_from_json(args.config)
        config = Config(**config_raw)
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

    if args.grid is not None:
        _run_grid_mode(args, config_raw)
        return

    if args.sensitivity is not None:
        _run_sensitivity_mode(args, config_raw, config)
        return

    if args.optimize is not None:
        _run_optimize_mode(args, config_raw, config)
        return

    log_input_parameters(config)
    simulator = RetirementMonteCarloSimulator(config, device=args.device)

    search_curve = []
    if args.override is not None:
        required = args.override
        log.info("Using working-months override: %d (search skipped)", required)
    else:
        log.info(
            "--- Estimating Required Working Months for '%s' ---", config.Nickname
        )
        required, achieved, search_curve = simulator.find_minimum_working_months(
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

    if args.json_out:
        from .payload import build_result

        class _Precomputed:
            """Serve the final batch already in hand to build_result: the
            deterministic final stream would reproduce it bit for bit, so
            running it again would only add cost. The cached batch is valid
            only for the arguments it was computed with; a mismatch fails
            loudly instead of embedding stale results."""

            @staticmethod
            def run_monte_carlo_simulations(working_months, num_simulations):
                if (
                    working_months != required
                    or num_simulations != config.num_simulations_main
                ):
                    raise AssertionError(
                        "precomputed batch mismatch: cached "
                        f"({required}, {config.num_simulations_main}), "
                        f"requested ({working_months}, {num_simulations})"
                    )
                return results

        payload = build_result(config, _Precomputed(), required,
                               search_curve=search_curve)
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, allow_nan=False)
        log.info("Result payload written to %s", args.json_out)
    log.info("--- Main execution finished for '%s'. Log: %s ---",
             config.Nickname, log_filename)


if __name__ == "__main__":
    main()
