from .retirement import SimParams, arithmetic_to_log_params, prune_streams

__all__ = ["SimParams", "arithmetic_to_log_params", "prune_streams"]
