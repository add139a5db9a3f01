"""Payload assembly self time per plan, ms: the ``hosts/payload.build_result``
span less its ``Engine.run`` span (rounding, tables to lists, bins to
dicts). Mean over the window's answers."""

from benchmark.layers import dur_ms, mean


def read(ctx):
    tr = ctx["trace"]
    out = [dur_ms(b) - sum(dur_ms(s) for s in tr.descendants(b, "engine.run"))
           for b in tr.named("payload.build_result")]
    return mean(out)
