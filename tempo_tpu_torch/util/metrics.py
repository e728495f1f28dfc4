"""Port of tempo_tpu/util/metrics.py, copied as is (host code).

In-process metrics with Prometheus text exposition.

The reference instruments everything with promauto counters/gauges/
histograms under tempo_* / tempodb_* namespaces (SURVEY.md section 5.5;
e.g. compaction counters tempodb/compactor.go:32-62, flush histograms
modules/ingester/flush.go:37-60). prometheus_client is not in the
image, so this is a small thread-safe registry emitting exposition
format v0.0.4 for the /metrics endpoint.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n"))
        for k, v in labels
    )
    return "{%s}" % inner


def _label_key(labels: dict | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


class _DropLabelsMixin:
    """Remove label sets matching every given pair — the cardinality-
    eviction seam: per-tenant series of churned/idle tenants are dropped
    from the exposition (counters restart from 0 if the tenant returns;
    rate() tolerates resets, unbounded label growth has no remedy)."""

    def drop_labels(self, **match) -> int:
        pairs = set(match.items())
        with self._lock:
            victims = [k for k in self._values if pairs.issubset(set(k))]
            for k in victims:
                del self._values[k]
        return len(victims)

    def total(self, **match) -> float:
        """Sum across label sets (optionally only those containing every
        given pair) — 'the untagged total' of a labelled family."""
        pairs = set(match.items())
        with self._lock:
            return float(sum(
                v for k, v in self._values.items() if pairs.issubset(set(k))
            ))

    def series(self) -> list:
        """[(label dict, value)] snapshot — the per-series breakdown
        status endpoints render (e.g. /status/device's per-kernel
        transfer rollup) without re-parsing the exposition."""
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]


class Counter(_DropLabelsMixin):
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] += amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            items = [((), 0.0)]
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(labels)} {_fmt_value(v)}")
        return out


class Gauge(_DropLabelsMixin):
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            key = _label_key(labels)
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(labels)} {_fmt_value(v)}")
        return out


DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300)


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._totals.get(_label_key(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sums.get(_label_key(labels), 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            keys = sorted(self._counts)
            for key in keys:
                # observe() increments every bucket with value <= ub, so
                # counts are already cumulative as exposition requires
                counts = self._counts[key]
                for i, ub in enumerate(self.buckets):
                    lbl = _fmt_labels(key + (("le", _fmt_value(ub)),))
                    out.append(f"{self.name}_bucket{lbl} {counts[i]}")
                lbl_inf = _fmt_labels(key + (("le", "+Inf"),))
                out.append(f"{self.name}_bucket{lbl_inf} {self._totals[key]}")
                out.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(self._sums[key])}")
                out.append(f"{self.name}_count{_fmt_labels(key)} {self._totals[key]}")
        return out


class Registry:
    """Named metric registry; one global default mirrors promauto's."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._collectors: list = []
        self._lock = threading.Lock()

    def register_collector(self, fn) -> None:
        """fn() runs before every exposition to refresh gauges whose
        truth lives elsewhere (the shared column cache, process state) —
        promauto's GaugeFunc analog. Collectors must be idempotent and
        cheap; a raising collector is dropped from the exposition, not
        fatal (a broken gauge must not take /metrics down)."""
        with self._lock:
            self._collectors.append(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 - see register_collector
                import logging

                logging.getLogger(__name__).warning(
                    "metrics collector failed", exc_info=True)

    def _get_or_make(self, cls, name, help_, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def get(self, name: str):
        """Registered metric by name, or None — NEVER creates (the SLO
        engine reads families other modules own; a lookup must not
        register an empty-help family that wins the name)."""
        with self._lock:
            return self._metrics.get(name)

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "", buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help_, buckets=buckets)

    def expose(self) -> str:
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: list[str] = []
        for _, m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot_totals(self) -> dict:
        """name -> total across label sets, for counters and gauges
        (feeds the usage-stats report; reference: pkg/usagestats
        stats.go typed registry snapshot)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict[str, float] = {}
        for m in metrics:
            values = getattr(m, "_values", None)
            if values is None:
                continue
            with m._lock:
                out[m.name] = float(sum(values.values()))
        return out


REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
expose = REGISTRY.expose
snapshot_totals = REGISTRY.snapshot_totals
register_collector = REGISTRY.register_collector
