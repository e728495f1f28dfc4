"""TSDB-lite metric registry.

Reference: modules/generator/registry (registry.go:56 ManagedRegistry,
counter.go, histogram.go, hash.go — counters/histograms keyed by label
hash, staleness removal, active-series limiting, periodic collect into
a Prometheus appender).

Port of tempo_tpu/modules/generator/registry.py, host code.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class Sample:
    name: str
    labels: tuple  # ((k, v), ...)
    value: float
    timestamp_ms: int = 0
    exemplar: "Exemplar | None" = None


@dataclass
class Exemplar:
    """One trace-ID exemplar attached to a series (reference:
    registry histogram exemplars — the (trace_id, value, ts) triple a
    Grafana heatmap uses to jump from a bucket to the trace). The same
    struct travels in query_range responses (metrics_engine), so both
    metric surfaces speak one exemplar shape."""

    trace_id: str  # hex
    value: float
    timestamp_ms: int = 0

    def to_dict(self) -> dict:
        return {"traceID": self.trace_id, "value": self.value,
                "timestamp": self.timestamp_ms}


class ManagedRegistry:
    def __init__(self, tenant: str, max_active_series: int = 0,
                 stale_after_s: float = 900.0):
        self.tenant = tenant
        self.max_active_series = max_active_series
        self.stale_after_s = stale_after_s
        self.lock = threading.Lock()
        # series key -> [value, last_update]
        self.counters: dict[tuple, list] = {}
        # histogram key -> {"buckets": [counts], "sum": float, "count": int, "last": t}
        self.histograms: dict[tuple, dict] = {}
        self.bucket_bounds: dict[str, list] = {}
        self.series_dropped = 0

    def _can_add(self, n_current: int) -> bool:
        if not self.max_active_series:
            return True
        return n_current < self.max_active_series

    def inc_counter(self, name: str, labels: tuple, delta: float, now: float | None = None) -> None:
        now = now or time.time()
        key = (name, labels)
        with self.lock:
            cur = self.counters.get(key)
            if cur is None:
                if not self._can_add(len(self.counters) + len(self.histograms)):
                    self.series_dropped += 1
                    return
                cur = [0.0, now]
                self.counters[key] = cur
            cur[0] += delta
            cur[1] = now

    def observe_histogram(self, name: str, labels: tuple, bounds: list,
                          bucket_counts, total_sum: float, total_count: int,
                          now: float | None = None,
                          exemplar: Exemplar | None = None) -> None:
        """Batch-observe: pre-aggregated bucket counts from a vectorized
        pass (the processors hand whole batches, not single points).
        An optional trace-ID exemplar rides along; the latest one per
        series is kept (the Prometheus client convention)."""
        now = now or time.time()
        key = (name, labels)
        with self.lock:
            self.bucket_bounds[name] = list(bounds)
            h = self.histograms.get(key)
            if h is None:
                if not self._can_add(len(self.counters) + len(self.histograms)):
                    self.series_dropped += 1
                    return
                h = {"buckets": [0] * (len(bounds) + 1), "sum": 0.0, "count": 0,
                     "last": now, "exemplar": None}
                self.histograms[key] = h
            for i, c in enumerate(bucket_counts):
                h["buckets"][i] += int(c)
            h["sum"] += float(total_sum)
            h["count"] += int(total_count)
            h["last"] = now
            if exemplar is not None:
                h["exemplar"] = exemplar

    # ------------------------------------------------------------------
    def remove_stale(self, now: float | None = None) -> int:
        now = now or time.time()
        removed = 0
        with self.lock:
            for d, last_getter in ((self.counters, lambda v: v[1]), (self.histograms, lambda v: v["last"])):
                for k in [k for k, v in d.items() if now - last_getter(v) > self.stale_after_s]:
                    del d[k]
                    removed += 1
        return removed

    def active_series(self) -> int:
        with self.lock:
            return len(self.counters) + len(self.histograms)

    def collect(self, now_ms: int | None = None) -> list:
        now_ms = now_ms or int(time.time() * 1000)
        out: list[Sample] = []
        with self.lock:
            for (name, labels), (val, _) in self.counters.items():
                out.append(Sample(name, labels, val, now_ms))
            for (name, labels), h in self.histograms.items():
                bounds = self.bucket_bounds.get(name, [])
                cum = 0
                for i, b in enumerate(bounds):
                    cum += h["buckets"][i]
                    out.append(Sample(f"{name}_bucket", labels + (("le", str(b)),), cum, now_ms))
                cum += h["buckets"][-1]
                # exemplar rides the +Inf bucket (contains every value),
                # the OpenMetrics exposition convention
                out.append(Sample(f"{name}_bucket", labels + (("le", "+Inf"),), cum,
                                  now_ms, exemplar=h.get("exemplar")))
                out.append(Sample(f"{name}_sum", labels, h["sum"], now_ms))
                out.append(Sample(f"{name}_count", labels, h["count"], now_ms))
        return out

    def prometheus_text(self) -> str:
        lines = []
        for s in self.collect():
            labels = list(s.labels) + [("tenant", self.tenant)]
            lbl = ",".join(f'{k}="{v}"' for k, v in labels)
            line = f"{s.name}{{{lbl}}} {s.value}"
            if s.exemplar is not None:
                # OpenMetrics exemplar suffix: `# {labels} value timestamp`
                ex = s.exemplar
                line += (f' # {{trace_id="{ex.trace_id}"}} {ex.value}'
                         f" {ex.timestamp_ms / 1000:.3f}")
            lines.append(line)
        return "\n".join(lines) + ("\n" if lines else "")
