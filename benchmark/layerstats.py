"""Helpers that the per-layer metric readers in benchmark/metrics/ share."""

from __future__ import annotations

import statistics


def p95_ms(records: list) -> float | None:
    """95th percentile, in ms, of the latencies of the window's answered
    requests (Python's statistics.quantiles, exclusive method)."""
    ms = [(r["t1"] - r["t0"]) * 1e3 for r in records if r["status"] == 200]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[-1]


def idle_share(ctx: dict) -> float | None:
    """Percent of the traced window in which no kernel, copy or memset ran
    on the card; None without a trace that saw the card."""
    tr = ctx.get("trace")
    if not tr or not tr.get("n_device") or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["window_s"])


def delta(ctx: dict, group: str, key: str) -> float:
    return float(ctx["after"][group].get(key, 0) or 0) - float(ctx["before"][group].get(key, 0) or 0)
