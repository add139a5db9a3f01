"""HTTP API request/response schemas (a copy of the JAX package's
``hosts/schemas.py``: importing that module would import jax).

The same wire format as the JAX server, so the dashboard frontend and any
existing API client work unchanged against the port's server;
``tests/test_torch_params.py`` keeps the copy equal to the original.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field


class SimulationSummary(BaseModel):
    required_working_months: int
    required_working_years: float
    working_period_is_estimate: bool = True
    retirement_age: Optional[float] = None
    success_probability: float
    success_probability_sigma: Optional[float] = Field(
        None,
        description=(
            "One-sigma Monte Carlo error of success_probability (percent): "
            "sqrt(p(1-p)/n)*100 over the final run's path count. Additive "
            "extension (the reference omits it; clients may ignore it). "
            "Under antithetic sampling the paired estimator's true error is "
            "smaller, so this binomial value stays a safe upper bound."
        ),
    )
    target_probability: float
    median_start_balance: float
    median_final_balance_successful: float
    swr: Optional[float] = Field(
        None,
        description=(
            "Sustainable withdrawal rate, in percent: the cohort-median "
            "gross withdrawal taken during retirement year 0 (deflated to "
            "retirement-date dollars) over the portfolio value on the "
            "retirement date."
        ),
    )
    final_balance_percentiles: Dict[str, float]


class TrajectoryData(BaseModel):
    years: List[float]
    percentiles: Dict[str, List[float]]
    sample_paths: List[List[float]]


class WithdrawalRateData(BaseModel):
    """Per-retirement-year withdrawal-rate table for the dashboard's band
    chart. Each year's rate is that year's portfolio withdrawals, deflated to
    retirement-date purchasing power, divided by the retirement-date balance
    (the denominator classic 4%-rule studies use). Years a path did not fund
    in full contribute NaN/None and are excluded from the percentile rows;
    ``observation_counts`` says how many paths remain per year."""

    years: List[float]
    percentiles: Dict[str, List[Optional[float]]]
    observation_counts: List[int]
    total_paths: int


class SearchCurvePoint(BaseModel):
    working_months: int
    working_years: float
    probability: float


class SearchCurveData(BaseModel):
    points: List[SearchCurvePoint]
    target_probability: float
    selected_working_months: int


class RuinHistogramData(BaseModel):
    """How far into retirement the failing paths got before running dry.

    ``years_to_ruin`` holds one fractional-year value per failed path —
    measured from the retirement date to the first month an expense could
    not be met. Above the raw-path payload cap the per-path list is replaced
    by ``year_counts`` (integer-year bins, trailing zeros trimmed) so a
    million-path run serves a bounded response.
    """

    years_to_ruin: List[float]
    failure_count: int
    total_paths: int
    year_counts: Optional[List[int]] = None


class HistogramBins(BaseModel):
    """Server-side 60-bin histogram of successful final balances, computed
    with the same semantics the dashboard uses client-side (equal-width bins
    from min to max, last bin clamped, median = sorted[floor(n/2)])."""

    bin_edges: List[float]
    counts: List[int]
    median: float
    success_count: int
    total_paths: int


class HistogramData(BaseModel):
    final_balances: List[float]
    start_balances: List[float]
    success_flags: List[bool]
    binned: Optional[HistogramBins] = None


class ReferenceLineData(BaseModel):
    name: str
    year: float


class SimulationResponse(BaseModel):
    scenario: str
    summary: SimulationSummary
    trajectory: Optional[TrajectoryData] = None
    trajectory_real: Optional[TrajectoryData] = None
    withdrawal_rate: Optional[WithdrawalRateData] = None
    search_curve: Optional[SearchCurveData] = None
    ruin_histogram: Optional[RuinHistogramData] = None
    histogram: HistogramData
    reference_lines: List[ReferenceLineData] = []


class SimulationRequest(BaseModel):
    config: Dict[str, Any] = Field(
        ...,
        description=(
            "Scenario definition as a JSON object — the same shape a "
            "scenario file on disk uses (see docs/CONFIG.md for every field)."
        ),
    )
    working_months_override: Optional[int] = Field(
        None,
        ge=0,
        description=(
            "When set, bypass the minimum-working-months search entirely and "
            "simulate the final cohort at exactly this many months."
        ),
    )
    include_raw_paths: Optional[bool] = Field(
        None,
        description=(
            "Histogram wire format: true forces raw per-path arrays (the "
            "reference's format) regardless of the MCRT_MAX_RAW_PATHS cap; "
            "false forces the bounded pre-binned form; unset (default) lets "
            "the cap decide. Clients built against the reference server "
            "should send true when running above the cap."
        ),
    )
