"""The final full-statistics run per plan, ms: the ``Engine.run`` span
(full kernel, reductions on the card, one copy to the host). Mean over
the window's runs."""

from benchmark.layers import dur_ms, mean


def read(ctx):
    return mean([dur_ms(s) for s in ctx["trace"].named("engine.run")])
