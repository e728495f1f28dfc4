"""compiled_metrics' share of its roofline: the least time of the window's
calls (benchmark/roofline.py, from the shapes the recorder took) over the
device time of its prepare and count kernels in the window's trace."""

from benchmark import roofline


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return roofline.share(ctx["calls"], tr["kernel_us"], ("compiled_metrics",))
