"""Card time of the final run's reductions per run, ms: every profiled
kernel that is not a month-loop kernel and that a thread launched inside
its ``Engine.run`` span (sorts, percentiles, bins: ``ops/stats.py``,
``ops/quantiles.py``), over the runs that lie wholly in the profile."""


def read(ctx):
    tr = ctx["trace"]
    runs = [s for s in tr.named("engine.run") if tr.profiled(s)]
    if not runs:
        return None
    total = 0.0
    for op in tr.ops:
        if op.cat == "kernel" and not op.month_loop:
            span = tr.owner(op, runs)
            if span is not None:
                total += (op.t1 - op.t0) / 1e6
    return total / len(runs)
