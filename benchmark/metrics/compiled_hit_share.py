"""The compiled tier's shape-cache hits over hits and misses, from
/api/query-insights' `compiled` counters, as a delta over the window."""

from benchmark import layerstats as _c


def read(ctx):
    hits = _c.delta(ctx, "compiled", "hits")
    misses = _c.delta(ctx, "compiled", "misses")
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)
