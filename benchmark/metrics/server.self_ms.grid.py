"""Serving host self time per analysis, ms: the ``POST /api/grid`` handler's
span (parse, validating every variant, engine-pool wait, assembly,
response validation, JSON) less the ``run_scenario_grid`` span of the same
request (matched by the engine seed). Mean over the window's analyses."""

from benchmark.layers import dur_ms, mean


def read(ctx):
    tr = ctx["trace"]
    engine = tr.by_seed("grid.run_prepared_grid")
    out = []
    for h in tr.named("server.grid"):
        run = engine.get(h["attrs"].get("seed"))
        if run is None:
            continue
        inner = sum(dur_ms(s) for s in tr.descendants(run, "grid.run_scenario_grid"))
        out.append(dur_ms(h) - inner)
    return mean(out)
