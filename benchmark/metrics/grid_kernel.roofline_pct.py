"""``grid_kernel``'s share of its roofline, %: the floor of each profiled
launch (``roofline.rows_work``: its rows, paths and survivors) over the
launch's device time, summed over launches."""


def read(ctx):
    return ctx["trace"].roofline_pct("grid_kernel", "launch.grid")
