"""Percent of the traced window in which the card ran no kernel, copy or
memset: 1 - (the union of their intervals) / the window, from the
torch.profiler trace taken in the process that launches the kernels."""

from benchmark import layerstats as _c


def read(ctx):
    return _c.idle_share(ctx)
