"""Shared numeric constants for the TPU-native retirement Monte Carlo framework.

Parity notes: values mirror the reference engine's constants
(reference: backend/constants.py:1-7) so that epsilon semantics and
period lengths are directly comparable.
"""

MONTHS_PER_YEAR: int = 12

# "Effectively zero" threshold for balances / targets, in dollars.
SMALL_EPSILON: float = 1e-6

# Percentile grids used by the summary reductions.
TRAJECTORY_PERCENTILES: tuple = (0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95)
WITHDRAWAL_RATE_PERCENTILES: tuple = (0.05, 0.25, 0.50, 0.75, 0.95)
FINAL_BALANCE_PERCENTILES: tuple = (0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99)

# Number of individual sample paths surfaced alongside percentile bands.
NUM_SAMPLE_PATHS: int = 5

# Search: the bracket phase never probes beyond start + 70 years
# (reference: backend/simulation.py:1161).
MAX_SEARCH_YEARS: int = 70

# Plot colors (CLI PNG output).
TEXT_INPUT_COLOR = "#1f77b4"
TEXT_OUTPUT_COLOR = "#ff7f0e"
