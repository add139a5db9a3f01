"""Idle share of the card over the profiled part of the window, %:
1 - busy / window, busy the union of device operations."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.window or not tr.window[1]:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
