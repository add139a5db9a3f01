"""Tensor ops of the port: the counter-based shock stream, the tax algebra,
exact quantiles and the run summary."""

from .shocks import monthly_gross_factors, monthly_shocks
from .tax import (
    apply_annual_gain_taxes,
    net_liquidation_value,
    rebalance,
    withdraw_net_target,
)

__all__ = [
    "withdraw_net_target",
    "net_liquidation_value",
    "rebalance",
    "apply_annual_gain_taxes",
    "monthly_shocks",
    "monthly_gross_factors",
]
