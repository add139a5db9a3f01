"""PyTorch/CUDA port of the retirement Monte Carlo framework.

The JAX package ``monte_carlo_retirement_tpu`` is the reference; this package
runs the same main path — config -> working-months search -> one
full-statistics run -> percentile reductions -> report — on an NVIDIA H100
through hand-written CUDA kernels (``engine/csrc/month_loop.cu``), with
plain PyTorch versions beside them for the CPU.

It imports ``torch`` and never ``jax``: the pure-Python modules it shares
with the JAX package (config, constants, timing, logging, the search driver,
the plots) are copies, because importing anything from the JAX package runs
its ``__init__``, which imports ``jax.numpy``.

Public surface, the JAX package's names (the torch-backed ones lazy, so
importing the package stays light):
  * Config / load_config_from_json — scenario schema (copied)
  * Engine — probe / run on a chosen torch device
  * RetirementMonteCarloSimulator — reference-compatible facade
  * find_minimum_working_months — batched search driver
  * SimParams, the timing helpers and the constants
"""

from .config import Config, ConfigurationError, OtherIncomeStreamConfig, load_config_from_json
from .constants import MONTHS_PER_YEAR, SMALL_EPSILON
from .timing import (
    age_at_retirement_year,
    expected_trajectory_length,
    num_working_years,
    retirement_age,
    stream_payment_start_age,
    stream_payment_start_month_index,
    trajectory_time_points,
    years_from_t0_to_age,
)

__version__ = "0.1.0"

__all__ = [
    "Config",
    "ConfigurationError",
    "OtherIncomeStreamConfig",
    "load_config_from_json",
    "MONTHS_PER_YEAR",
    "SMALL_EPSILON",
    "SimParams",
    "arithmetic_to_log_params",
    "retirement_age",
    "stream_payment_start_age",
    "stream_payment_start_month_index",
    "age_at_retirement_year",
    "years_from_t0_to_age",
    "num_working_years",
    "expected_trajectory_length",
    "trajectory_time_points",
]

# Lazy names and the module that defines each.
_LAZY = {
    "SimParams": ".models.retirement",
    "arithmetic_to_log_params": ".models.retirement",
    "Engine": ".engine.runner",
    "RetirementMonteCarloSimulator": ".engine.simulator",
    "median_first_year_withdrawal_rate": ".engine.simulator",
    "find_minimum_working_months": ".search.driver",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
