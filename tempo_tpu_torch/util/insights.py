"""Port of tempo_tpu/util/insights.py, copied as is (host code).

Query-insights log: one structured record per interesting query.

An SLO burn (util/slo.py) says "queries are failing/slow"; this log
says WHICH queries — the reference answers that with Loki-side log
mining over the frontend's per-query log lines; here the frontend
records a bounded in-memory ring of per-query records (tenant,
normalized query, status, shard counts, stage waterfall, usage cost
vector, traceparent) served at /api/query-insights, and ALSO emits the
slow/error subset as JSON log lines (the grep-able slow-query log).

Capture policy: errors, partial responses, and queries slower than the
slow threshold are ALWAYS captured; healthy fast queries are sampled
1-in-N — so the ring tells the truth about the tail without costing
memory proportional to traffic. Queries are normalized (literals
stripped) before storing, so records group by shape and the ring never
stores request-derived unbounded strings beyond the query skeleton.

The diagnosis loop this closes (runbook: "Reading query insights"):
burn-rate alert -> /api/query-insights (which tenant/query shape is
slow, which stage dominates its waterfall) -> the record's traceparent
-> the `_self_` trace of that exact request.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import threading
import time
from collections import deque

from tempo_tpu_torch.util import metrics, stagetimings, usage

log = logging.getLogger(__name__)
slow_log = logging.getLogger("tempo_tpu_torch.slowquery")

insights_total = metrics.counter(
    "tempo_tpu_query_insights_total",
    "Query-insight records captured, by workload kind and capture "
    "reason (error | partial | slow | sampled)",
)

# The literal-stripping normalizer lives in util/queryshape so the
# compiled-tier cache key and these records agree by construction;
# re-exported here because callers and tests address it as
# insights.normalize_query / insights.normalize_search.
from tempo_tpu_torch.util.queryshape import (  # noqa: F401  (re-export)
    _NUM_RE,
    _STR_RE,
    normalize_query,
    normalize_search,
)


_active: contextvars.ContextVar = contextvars.ContextVar(
    "tempo_query_insight", default=None
)


def note(**fields) -> None:
    """Attach fields to the active draft record (no-op outside an
    observe() scope) — the seam _run_jobs uses to report shard counts
    and the query's traceparent without parameter threading."""
    rec = _active.get()
    if rec is not None:
        rec.update({k: v for k, v in fields.items() if v is not None})


class InsightLog:
    """Process-wide bounded ring of insight records."""

    def __init__(self, capacity: int = 512, sample_every: int = 10,
                 slow_threshold_s: float = 2.0):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.sample_every = sample_every
        self.slow_threshold_s = slow_threshold_s
        self._seq = 0

    def configure(self, capacity: int | None = None,
                  sample_every: int | None = None,
                  slow_threshold_s: float | None = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(1, capacity))
            if sample_every is not None:
                self.sample_every = max(1, sample_every)
            if slow_threshold_s is not None:
                self.slow_threshold_s = slow_threshold_s

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def observe(self, tenant: str, kind: str, query: str):
        """Wrap one frontend query; yields the draft record dict. On
        exit the record gets its duration, status, stage waterfall and
        cost vector, then the capture policy decides whether it lands
        in the ring (and the slow-query log)."""
        rec = {
            "tenant": tenant,
            "kind": kind,
            "query": query,
            "ts": time.time(),
        }
        token = _active.set(rec)
        t0 = time.perf_counter()
        try:
            yield rec
        except BaseException as e:
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            _active.reset(token)
            rec["durationSeconds"] = round(time.perf_counter() - t0, 6)
            rec.setdefault("status", "ok")
            st = stagetimings.active()
            if st is not None:
                wire = st.to_wire()
                rec["stageSeconds"] = wire["stageSeconds"]
                rec["deviceDispatches"] = wire["deviceDispatches"]
            uv = usage.active()
            if uv is not None:
                rec["usage"] = uv.to_wire()
            self._capture(rec)

    def _capture(self, rec: dict) -> None:
        slow = rec["durationSeconds"] >= self.slow_threshold_s
        if rec["status"] == "error":
            reason = "error"
        elif rec["status"] == "partial":
            reason = "partial"
        elif slow:
            reason = "slow"
        else:
            with self._lock:
                self._seq += 1
                if self._seq % self.sample_every:
                    return
            reason = "sampled"
        rec["captureReason"] = reason
        insights_total.inc(kind=rec["kind"], reason=reason)
        with self._lock:
            self._ring.append(rec)
        if reason in ("error", "slow"):
            # the grep-able slow-query log line (JSON, one per record)
            slow_log.warning("query-insight %s", json.dumps(rec, sort_keys=True))

    # ------------------------------------------------------------------
    def snapshot(self, tenant: str | None = None, limit: int = 50,
                 since_unix: float | None = None,
                 reasons: tuple | None = None) -> list[dict]:
        """Newest-first records, optionally one tenant's only, optionally
        restricted to records captured at/after `since_unix` and/or to a
        set of captureReason values — the RCA evidence-snapshot seam, so
        an incident bundles only the affected window's interesting
        records instead of the whole ring."""
        with self._lock:
            records = list(self._ring)
        records.reverse()
        if tenant is not None:
            records = [r for r in records if r.get("tenant") == tenant]
        if since_unix is not None:
            records = [r for r in records if r.get("ts", 0.0) >= since_unix]
        if reasons is not None:
            records = [r for r in records if r.get("captureReason") in reasons]
        return records[: max(1, limit)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0


LOG = InsightLog()
