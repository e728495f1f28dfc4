"""Compactor time a million spans: the benchmark's spans around each
TempoDB.compact_once of the window's completed units."""


def read(ctx):
    spans = [s for s in ctx["spans"] if s[0] == "compact_once"]
    n = sum(s[2] for s in spans)
    return sum(s[1] for s in spans) * 1e3 / (n / 1e6) if n else None
