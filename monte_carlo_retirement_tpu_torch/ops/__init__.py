"""Tensor ops of the port: the counter-based shock stream, the tax algebra,
exact quantiles and the run summary."""
