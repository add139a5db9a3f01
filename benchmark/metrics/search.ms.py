"""Working-months search per plan, ms: the span of
``RetirementMonteCarloSimulator.find_minimum_working_months`` (ladder and
verification probes, their host syncs). Mean over the window's searches."""

from benchmark.layers import dur_ms, mean


def read(ctx):
    return mean([dur_ms(s) for s in ctx["trace"].named("search")])
