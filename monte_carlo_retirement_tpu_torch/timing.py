"""Pure age/date/grid helpers shared by the engine, hosts and plots.

These are host-side (Python float) functions; the engine re-derives the same
quantities with jnp ops inside the kernel where they must be traced.
Behavioral contract matches the reference helpers
(reference: backend/simulation.py:32-123).
"""

from __future__ import annotations

import math
from typing import List

from .constants import MONTHS_PER_YEAR, SMALL_EPSILON


def retirement_age(current_age: float, working_months: int) -> float:
    """Age on the retirement date, given age at T=0 and months worked."""
    return current_age + working_months / MONTHS_PER_YEAR


def stream_payment_start_age(
    current_age: float, working_months: int, start_at_age: float
) -> float:
    """Age at which an income stream actually begins paying.

    Eligible from ``start_at_age`` but payments only occur in retirement.
    """
    return max(retirement_age(current_age, working_months), float(start_at_age))


def stream_payment_start_month_index(
    current_age: float, working_months: int, start_at_age: float
) -> int:
    """First retirement-month index (0-based) whose payment date is at/after
    the stream's eligibility age. Fractional ages round up to the next monthly
    payment date (with a small epsilon guard against float noise)."""
    ret_start = retirement_age(current_age, working_months)
    eligible = stream_payment_start_age(current_age, working_months, start_at_age)
    months = math.ceil((eligible - ret_start) * MONTHS_PER_YEAR - SMALL_EPSILON)
    return max(0, int(months))


def age_at_retirement_year(
    current_age: float, working_months: int, year_num: int
) -> float:
    """Age at the start of retirement year ``year_num`` (0 = first year)."""
    return retirement_age(current_age, working_months) + year_num


def years_from_t0_to_age(current_age: float, target_age: float) -> float:
    """Years from T=0 until ``target_age`` (0 if already reached)."""
    return max(0.0, float(target_age) - float(current_age))


def num_working_years(working_months: int) -> int:
    """Number of (possibly partial) accumulation years: ceil(months / 12)."""
    if working_months <= 0:
        return 0
    return (working_months + MONTHS_PER_YEAR - 1) // MONTHS_PER_YEAR


def trajectory_time_points(working_months: int, retirement_years: int) -> List[float]:
    """X-axis (in years from T=0) of the yearly trajectory samples.

    Full working years are sampled at integer years; a partial final working
    year adds a sample exactly at the retirement date; retirement samples then
    fall at one-year intervals from that date. Length is
    ``1 + num_working_years(working_months) + retirement_years``.
    """
    full_years, extra_months = divmod(working_months, MONTHS_PER_YEAR)
    points: List[float] = [0.0]
    points.extend(float(y) for y in range(1, full_years + 1))
    retirement_time = working_months / MONTHS_PER_YEAR
    if extra_months:
        points.append(retirement_time)
    points.extend(retirement_time + y for y in range(1, retirement_years + 1))
    return points


def expected_trajectory_length(working_months: int, retirement_years: int) -> int:
    """Number of yearly trajectory samples for a path of this shape."""
    return 1 + num_working_years(working_months) + retirement_years
