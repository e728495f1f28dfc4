"""Port of tempo_tpu/util/usage.py, copied as is (host code).

Per-tenant cost attribution: who is this byte/dispatch FOR?

PR 9's waterfall (util/stagetimings.py) answers "where did this query's
TIME go"; this plane answers "what does tenant X COST us" — the billing
/capacity substrate the reference keeps in modules/overrides' per-tenant
usage tracking plus the distributor's tenant-labelled ingest counters.

Mechanism (deliberately the stagetimings seam):

- A contextvar-scoped CostVector accumulates named charges. Deep code
  (block readers, codecs, caches, device dispatch) calls
  `usage.charge(field, n)` with no tenant threading — the active vector
  belongs to whatever request/job the thread is working for (db/pool
  and ReadAhead propagate it into their worker threads).
- Workers run each query job under `collect()` and ship the vector back
  on the job result as "usage"; the frontend merges shard vectors in
  `_run_jobs` exactly like stage wires, then SETTLES the merged vector
  under (tenant, workload-kind) — so in microservice mode the frontend
  process owns query-cost attribution (the reference frontend likewise
  owns inspectedBytes), while ingest cost settles at the distributor
  and compaction cost at the compactor.
- Settling folds the vector into the process-wide UsageAccountant
  (the /api/usage rollup) and the per-tenant Prometheus counters
  (tempo_tpu_usage_*_total{tenant,kind}).

Cardinality is bounded the same way PR 8 bounded the distributor's
per-tenant limiters: tenants idle past a TTL are evicted from the
accountant AND their label sets dropped from the counters, so a
tenant-ID fuzzing client cannot grow /metrics forever.

Exactness contract (tests/test_usage_plane.py): charges happen at the
SAME statements that feed the untagged counters and response stats, so
per-tenant vectors sum to the untagged totals — attribution splits the
measurement, it never re-measures.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

from tempo_tpu_torch.util import metrics

# every cost field with its exposition family (LITERAL names — grep and
# the operations lint must find them) + help. Units ride the name
# (bytes/seconds/count) per the Prometheus naming convention.
_FIELD_FAMILIES = {
    "ingested_bytes": (
        "tempo_tpu_usage_ingested_bytes_total",
        "Span payload bytes accepted at the distributor"),
    "ingested_spans": (
        "tempo_tpu_usage_ingested_spans_total",
        "Spans accepted at the distributor"),
    "flushed_bytes": (
        "tempo_tpu_usage_flushed_bytes_total",
        "Block bytes written to the backend by ingester flush"),
    "inspected_bytes": (
        "tempo_tpu_usage_inspected_bytes_total",
        "Bytes read from backend storage or ingester live segments on "
        "behalf of work"),
    "decoded_bytes": (
        "tempo_tpu_usage_decoded_bytes_total",
        "Bytes materialized into row space by decode work"),
    "pages_fetched": (
        "tempo_tpu_usage_pages_fetched_total",
        "Column pages fetched from backend storage"),
    "ranged_reads": (
        "tempo_tpu_usage_ranged_reads_total",
        "Backend read round trips issued (ranged page reads plus "
        "whole-object index/dictionary/bloom fetches)"),
    "cache_hits": (
        "tempo_tpu_usage_cache_hits_total",
        "Column/backend cache hits"),
    "cache_misses": (
        "tempo_tpu_usage_cache_misses_total",
        "Column/backend cache misses"),
    "device_seconds": (
        "tempo_tpu_usage_device_seconds_total",
        "Wall-clock seconds of host-level device dispatches"),
    "device_dispatches": (
        "tempo_tpu_usage_device_dispatches_total",
        "Host-level device dispatches issued"),
    "transfer_bytes": (
        "tempo_tpu_usage_transfer_bytes_total",
        "Bytes moved across the host<->device boundary (h2d + d2h) by "
        "device dispatches"),
    "result_cache_hits": (
        "tempo_tpu_usage_result_cache_hits_total",
        "Shard-partial result-cache hits (cached partial served, block "
        "fetch skipped)"),
    "result_cache_misses": (
        "tempo_tpu_usage_result_cache_misses_total",
        "Shard-partial result-cache misses (block recomputed cold)"),
    "result_cache_negative": (
        "tempo_tpu_usage_result_cache_negative_total",
        "Negative-cache vetoes served (block provably empty for the "
        "query; fetch skipped entirely)"),
    "result_cache_stores": (
        "tempo_tpu_usage_result_cache_stores_total",
        "Shard partials written into the result cache"),
    "result_cache_bytes_saved": (
        "tempo_tpu_usage_result_cache_bytes_saved_total",
        "Backend bytes NOT read because a cached or negative entry "
        "answered for the block"),
}
FIELDS = {field: help_ for field, (_, help_) in _FIELD_FAMILIES.items()}

# workload kinds a vector can settle under (bounded: the `kind` label
# must never carry request-derived strings)
KINDS = ("ingest", "find", "search", "query_range", "traceql", "graph",
         "compaction", "analytics", "standing")

_counters = {
    field: metrics.counter(family, help_ + ", by tenant and workload kind")
    for field, (family, help_) in _FIELD_FAMILIES.items()
}


class CostVector:
    """Thread-safe named-charge accumulator (pool/prefetch threads of
    one request all record into the same instance)."""

    __slots__ = ("values", "_lock")

    def __init__(self):
        self.values: dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, field: str, amount: float) -> None:
        if amount <= 0:
            return
        with self._lock:
            self.values[field] = self.values.get(field, 0.0) + amount

    def merge_wire(self, wire: dict | None) -> None:
        """Fold a worker's cost wire (to_wire form) into this vector."""
        if not wire:
            return
        for field, v in wire.items():
            if field in FIELDS:
                self.add(str(field), float(v))

    def to_wire(self) -> dict:
        with self._lock:
            return {k: round(v, 9) for k, v in self.values.items()}

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.values)


_active: contextvars.ContextVar = contextvars.ContextVar(
    "tempo_cost_vector", default=None
)


def active() -> CostVector | None:
    return _active.get()


def charge(field: str, amount: float = 1.0) -> None:
    """Record a cost against the active vector (no-op outside any
    attribution scope — direct library use stays free of bookkeeping)."""
    vec = _active.get()
    if vec is not None:
        vec.add(field, amount)


def account_bytes(counter, field: str, tenant: str, nbytes: int,
                  round_trip: bool = False) -> None:
    """THE attribution-exactness invariant, in one place: the untagged
    tenant-labelled counter and the active cost vector move at the same
    statement, and every tenant-labelled inc touches the accountant so
    idle-tenant series eviction works in processes that never settle.
    round_trip=True also counts one backend read round trip."""
    counter.inc(nbytes, tenant=tenant)
    ACCOUNTANT.touch(tenant)
    charge(field, nbytes)
    if round_trip:
        charge("ranged_reads")


def run_with(vec: CostVector | None, fn, *args, **kwargs):
    """Run fn with `vec` active — the prefetch-thread hook (ReadAhead
    loads bytes for a request from a thread that never saw its context;
    only the cost vector is propagated, NOT stage timings: overlapped IO
    must not double-count wall-clock buckets)."""
    if vec is None:
        return fn(*args, **kwargs)
    token = _active.set(vec)
    try:
        return fn(*args, **kwargs)
    finally:
        _active.reset(token)


@contextlib.contextmanager
def collect(vec: CostVector | None = None):
    """Activate `vec` (or a fresh vector) for this context; yields it.
    Collection only — the caller decides where (whether) it settles."""
    vec = vec or CostVector()
    token = _active.set(vec)
    try:
        yield vec
    finally:
        _active.reset(token)


@contextlib.contextmanager
def attribute(tenant: str, kind: str):
    """Collect AND settle: everything charged inside (including worker
    wires merged in) lands under (tenant, kind) in the accountant and
    the per-tenant counters — settled in finally, because work that
    errored was still paid for."""
    vec = CostVector()
    token = _active.set(vec)
    try:
        yield vec
    finally:
        _active.reset(token)
        ACCOUNTANT.record(tenant, kind, vec.snapshot())


def record(tenant: str, kind: str, **fields) -> None:
    """Direct settle for sites with no scope to ride (distributor push,
    ingester flush): usage.record(tenant, "ingest", ingested_bytes=n)."""
    ACCOUNTANT.record(tenant, kind, fields)


# extra tenant-labelled metric families whose series evict with the
# accountant's idle-tenant GC (the tempodb read counters live in
# querier/compactor processes where record() may never run, so touch()
# is their activity signal)
_tenant_families: list = []


def register_tenant_family(metric) -> None:
    """Enroll a tenant-labelled Counter/Gauge for idle-tenant series
    eviction (drop_labels(tenant=...) on accountant GC)."""
    _tenant_families.append(metric)


class UsageAccountant:
    """Process-wide (tenant, kind) -> CostVector rollup behind
    /api/usage. Idle tenants are evicted (rows AND counter label sets)
    so churned tenant IDs stay bounded — same seam as the distributor's
    limiter GC."""

    # MATCHES Distributor.TENANT_IDLE_TTL_S: the distributor's eviction
    # pokes this accountant, and a longer TTL here would leave
    # /status/usage reporting tenants whose counter series were already
    # dropped — the two views must agree per tenant at all times
    TENANT_IDLE_TTL_S = 600.0
    _EVICT_PERIOD_S = 60.0

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: dict[tuple[str, str], dict] = {}
        self._last_used: dict[str, float] = {}
        self._last_evict = time.monotonic()

    def touch(self, tenant: str) -> None:
        """Mark tenant activity WITHOUT a row — the block readers call
        this beside their tenant-labelled counter incs so a querier
        process (whose accountant may never see a record()) still evicts
        idle tenants' series."""
        now = time.monotonic()
        with self._lock:
            self._last_used[tenant] = now
        self._maybe_evict(now)

    def record(self, tenant: str, kind: str, fields: dict) -> None:
        fields = {k: v for k, v in fields.items() if k in FIELDS and v > 0}
        if not fields:
            return
        if kind not in KINDS:
            raise ValueError(f"unknown usage kind {kind!r} (have {KINDS})")
        now = time.monotonic()
        with self._lock:
            row = self._rows.setdefault((tenant, kind), {})
            for k, v in fields.items():
                row[k] = row.get(k, 0.0) + v
            self._last_used[tenant] = now
        for k, v in fields.items():
            _counters[k].inc(v, tenant=tenant, kind=kind)
        self._maybe_evict(now)

    def _maybe_evict(self, now: float) -> None:
        with self._lock:
            if now - self._last_evict < self._EVICT_PERIOD_S:
                return
            self._last_evict = now
        self.evict_idle_tenants()

    def evict_idle_tenants(self, older_than_s: float | None = None) -> int:
        ttl = self.TENANT_IDLE_TTL_S if older_than_s is None else older_than_s
        now = time.monotonic()
        with self._lock:
            idle = [t for t, at in self._last_used.items() if now - at > ttl]
            for t in idle:
                del self._last_used[t]
                for key in [k for k in self._rows if k[0] == t]:
                    del self._rows[key]
        for t in idle:
            for c in _counters.values():
                c.drop_labels(tenant=t)
            for m in _tenant_families:
                m.drop_labels(tenant=t)
        return len(idle)

    def snapshot(self, tenant: str | None = None) -> dict:
        """{tenant: {kind: {field: value}}} — one tenant or all."""
        with self._lock:
            rows = {k: dict(v) for k, v in self._rows.items()
                    if tenant is None or k[0] == tenant}
        out: dict = {}
        for (t, kind), fields in sorted(rows.items()):
            out.setdefault(t, {})[kind] = {
                k: round(v, 9) for k, v in sorted(fields.items())
            }
        return out

    def totals(self, tenant: str) -> dict:
        """Field totals across kinds for one tenant."""
        out: dict = {}
        for fields in self.snapshot(tenant).get(tenant, {}).values():
            for k, v in fields.items():
                out[k] = round(out.get(k, 0.0) + v, 9)
        return out

    def reset(self) -> None:
        """Test hook: clear rows (counters keep their monotonic values)."""
        with self._lock:
            self._rows.clear()
            self._last_used.clear()


ACCOUNTANT = UsageAccountant()


def usage_report(tenant: str | None = None) -> dict:
    """The /api/usage / /status/usage document: per-kind vectors plus a
    cross-kind total per tenant."""
    snap = ACCOUNTANT.snapshot(tenant)
    return {
        "tenants": {
            t: {"kinds": kinds, "total": ACCOUNTANT.totals(t)}
            for t, kinds in snap.items()
        },
        "fields": sorted(FIELDS),
    }
