"""Reference-compatible simulator facade over the port's Engine.

Same surface as the JAX package's ``engine/simulator.py``: seed-stream
switching, the pandas 7-tuple of ``run_monte_carlo_simulations``, the
device-reduced ``run_result_reduced`` the server's capped responses use,
``_success_probability`` and ``find_minimum_working_months`` (the search
driver, probing 16 candidates per launch on the search stream).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import pandas as pd

from ..config import Config
from ..constants import (
    MAX_SEARCH_YEARS,
    MONTHS_PER_YEAR,
    SMALL_EPSILON,
    TRAJECTORY_PERCENTILES,
    WITHDRAWAL_RATE_PERCENTILES,
)
from ..search.driver import find_minimum_working_months as _search
from ..utils import profiling
from .runner import Engine, RunResult

log = logging.getLogger("mcrt.simulator")


def success_mask(summary_df: pd.DataFrame) -> pd.Series:
    """Per-path success flags; without a Success column a path succeeds iff
    its final balance exceeds epsilon."""
    if "Success" in summary_df.columns:
        return summary_df["Success"].astype(bool)
    return summary_df["Final Balance"] > SMALL_EPSILON


def median_first_year_withdrawal_rate(summary_df: pd.DataFrame) -> float:
    """Median per-path first-year real gross withdrawal / start balance (%),
    withdrawals deflated to retirement-date dollars."""
    if summary_df.empty:
        return float("nan")
    start = summary_df["Start Balance"]
    col = (
        "First Year Real Gross Withdrawal"
        if "First Year Real Gross Withdrawal" in summary_df.columns
        else "First Year Gross Withdrawal"
    )
    withdraw = summary_df[col]
    valid = start > SMALL_EPSILON
    if not valid.any():
        return float("nan")
    return float(((withdraw[valid] / start[valid]) * 100.0).median())


class RetirementMonteCarloSimulator:
    """Drop-in facade over the port's engine, with reference semantics."""

    def __init__(
        self,
        params_model: Config,
        main_seed_override: Optional[int] = None,
        dtype=None,
        device="cuda",
    ):
        self.params_model = params_model.model_copy(deep=True)
        self.engine = Engine(
            self.params_model, main_seed_override=main_seed_override,
            dtype=dtype, device=device,
        )
        self.main_seed = self.engine.main_seed
        self._stream_name = "final"

    # -- seed streams --------------------------------------------------
    def use_search_seeds(self) -> None:
        """Switch batches to the independent search seed stream."""
        self._stream_name = "search"

    def use_final_seeds(self) -> None:
        """Switch batches to the independent final-run seed stream."""
        self._stream_name = "final"

    # -- batch run ------------------------------------------------------
    def run_monte_carlo_simulations(
        self, working_months: int, num_simulations: int
    ) -> Tuple[
        pd.DataFrame,
        Optional[pd.DataFrame],
        Optional[List[List[float]]],
        Optional[pd.DataFrame],
        Optional[pd.DataFrame],
        Optional[List[List[float]]],
        Optional[List[int]],
    ]:
        """Run a batch and return the reference 7-tuple:

        (summary_df, trajectory percentile df, sample paths,
         withdrawal-rate percentile df, real trajectory percentile df,
         real sample paths, per-year withdrawal-rate observation counts).
        """
        return self._package(self.run_result(working_months, num_simulations))

    def run_result(self, working_months: int, num_simulations: int) -> RunResult:
        """The framework-native result object (arrays, no pandas)."""
        return self.engine.run(
            working_months, num_simulations, stream=self._stream_name
        )

    def run_result_reduced(
        self, working_months: int, num_simulations: int
    ) -> RunResult:
        """Device-reduced result: the per-path arrays stay on the device;
        the host gets the percentile tables and the dashboard's pre-binned
        aggregates (``RunResult.bins``)."""
        return self.engine.run(
            working_months, num_simulations, stream=self._stream_name,
            reduced=True,
        )

    @staticmethod
    def _package(res: RunResult):
        summary_df = pd.DataFrame(
            {
                "Start Balance": res.start_balance,
                "Final Balance": res.final_balance,
                "Success": res.success.astype(bool),
                "YearsToRuin": res.years_to_ruin,
                "First Year Gross Withdrawal": res.first_year_gross,
                "First Year Real Gross Withdrawal": res.first_year_real_gross,
                "Inflation At Retirement": res.inflation_at_retirement,
            }
        )
        traj_df = pd.DataFrame(
            res.trajectory_percentiles.T, columns=list(TRAJECTORY_PERCENTILES)
        )
        real_df = pd.DataFrame(
            res.real_trajectory_percentiles.T, columns=list(TRAJECTORY_PERCENTILES)
        )
        wr_df = pd.DataFrame(
            res.wr_percentiles.T, columns=list(WITHDRAWAL_RATE_PERCENTILES)
        )
        samples = [list(map(float, row)) for row in res.sample_trajectories]
        samples_real = [
            list(map(float, row)) for row in res.sample_real_trajectories
        ]
        counts = [int(v) for v in res.wr_observation_counts]
        return summary_df, traj_df, samples, wr_df, real_df, samples_real, counts

    # -- single path (testing/inspection) -------------------------------
    def _run_single_simulation_path(
        self, working_months: int, path_seed: int = 0
    ) -> Dict:
        """One path as a reference-style dict. ``path_seed`` selects the path
        row within the active stream (shock rows are independent)."""
        del path_seed  # rows are interchangeable; kept for signature parity
        return self.engine.run_path(working_months, stream=self._stream_name)

    # -- metrics ---------------------------------------------------------
    def _success_probability(self, summary_df: pd.DataFrame) -> float:
        """Share of paths that funded all retirement spending (percent)."""
        if summary_df.empty:
            return 0.0
        return float(success_mask(summary_df).mean() * 100.0)

    # -- search -----------------------------------------------------------
    def _probe_batch(self, months: Sequence[int], sim_count: int) -> List[float]:
        """Batched success probabilities on the search stream."""
        horizon = (
            self.params_model.starting_working_months_search
            + MAX_SEARCH_YEARS * MONTHS_PER_YEAR
        )
        return self.engine.probe(
            list(months), sim_count, stream="search", horizon_months=horizon
        )

    @profiling.traced("plan.search")
    def find_minimum_working_months(
        self,
        verbose: bool = True,
        progress_callback: Optional[Callable[[dict], None]] = None,
    ) -> Tuple[int, float, List[Dict[str, float]]]:
        """Minimum working months achieving the target success probability
        (search seed stream, common random numbers across candidates).
        Returns (months, probability, search_curve); months == -1 when the
        target cannot be met."""
        self.use_search_seeds()
        p = self.params_model
        sim_count = p.num_simulations_search
        return _search(
            lambda months: self._probe_batch(months, sim_count),
            starting_working_months=p.starting_working_months_search,
            target_probability_pct=p.target_probability,
            sim_count=sim_count,
            scenario_name=p.Nickname,
            verbose=verbose,
            progress_callback=progress_callback,
        )
