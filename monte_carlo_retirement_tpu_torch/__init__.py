"""PyTorch/CUDA port of the retirement Monte Carlo framework.

The JAX package ``monte_carlo_retirement_tpu`` is the reference; this package
runs the same main path — config -> working-months search -> one
full-statistics run -> percentile reductions -> report — on an NVIDIA H100
through two hand-written CUDA kernels (``engine/csrc/month_loop.cu``), with
plain PyTorch versions of both beside them for the CPU.

It imports ``torch`` and never ``jax``: the pure-Python modules it shares
with the JAX package (config, constants, timing, logging, the search driver,
the plots) are copies, because importing anything from the JAX package runs
its ``__init__``, which imports ``jax.numpy``.

Public surface (lazy, so importing the package stays light):
  * Config / load_config_from_json — scenario schema (copied)
  * Engine — probe / run on a chosen torch device
  * RetirementMonteCarloSimulator — reference-compatible facade
"""

from .config import Config, ConfigurationError, load_config_from_json

__version__ = "0.1.0"

__all__ = ["Config", "ConfigurationError", "load_config_from_json"]


def __getattr__(name):
    if name == "Engine":
        from .engine.runner import Engine

        return Engine
    if name == "RetirementMonteCarloSimulator":
        from .engine.simulator import RetirementMonteCarloSimulator

        return RetirementMonteCarloSimulator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
