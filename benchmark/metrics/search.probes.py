"""Probe launches per search: the program's ``cuda_kernel.LAUNCHES["probe"]``
counter over the window (reset at its start, read once every request has
ended) divided by the searches of the window."""


def read(ctx):
    searches = len(ctx["trace"].named("search"))
    if not searches:
        return None
    return ctx["launches"]["probe"] / searches
