"""``probe_kernel``'s share of its roofline, %: the floor of each profiled
launch (``roofline.rows_work``: its rows, paths and survivors, the
configuration's frozen essential operations) over the launch's device
time, summed over launches."""


def read(ctx):
    return ctx["trace"].roofline_pct("probe_kernel", "launch.probe")
