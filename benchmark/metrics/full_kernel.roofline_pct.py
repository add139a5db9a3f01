"""``full_kernel``'s share of its roofline, %: the floor of each profiled
launch (``roofline.full_work``: its month, paths, survivors and series)
over the launch's device time, summed over launches."""


def read(ctx):
    return ctx["trace"].roofline_pct("full_kernel", "launch.full")
