"""Serving host self time per plan answer, ms: the ``POST /api/simulate``
handler's span (parse, engine-pool wait, response validation, JSON) less
the search and ``build_result`` spans of the same request (matched by the
request's engine seed). Mean over the window's answers."""

from benchmark.layers import dur_ms, mean


def read(ctx):
    tr = ctx["trace"]
    engine = tr.by_seed("server.run_simulation")
    out = []
    for h in tr.named("server.simulate"):
        run = engine.get(h["attrs"].get("seed"))
        if run is None:
            continue
        inner = sum(dur_ms(s) for s in tr.descendants(run, "search")
                    + tr.descendants(run, "payload.build_result"))
        out.append(dur_ms(h) - inner)
    return mean(out)
