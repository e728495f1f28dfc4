"""95th percentile of query_range latency on the clients' clock, over all
requests answered in the window."""

from benchmark import layerstats as _c


def read(ctx):
    return _c.p95_ms(ctx["records"])
