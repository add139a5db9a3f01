"""Host gap of the grid engine per analysis, ms: the ``run_scenario_grid``
span less the time in it in which the card was busy (the union of device
operations), over the analyses that lie wholly in the profile."""

from benchmark.layers import dur_ms, mean


def read(ctx):
    tr = ctx["trace"]
    grids = [s for s in tr.named("grid.run_scenario_grid") if tr.profiled(s)]
    return mean([dur_ms(s) - 1e3 * tr.busy_s(s["t0"], s["t1"]) for s in grids])
