"""Deterministic synthetic trace generation.

Role of the reference's pkg/util/test/req.go (MakeTrace,
MakeTraceWithSpanCount — random spans with random attrs, used by nearly
every storage test) and pkg/util/trace_info.go (deterministic,
seed-reconstructible traces for the vulture/e2e consistency checker).

Two paths:
- `make_trace(s)` / `make_traces` — object-form, for API/e2e tests;
  fully determined by (seed), so a checker can regenerate the expected
  trace from its seed and compare (vulture semantics).
- `make_batch` — direct columnar generation at benchmark scale (millions
  of spans without object overhead).
- `make_graph_batch` — columnar traces whose spans form parent chains
  with client/server hops across services (the service graphs and the
  critical path need them).
"""

from __future__ import annotations

import numpy as np

from tempo_tpu_torch.model.columnar import (
    ATTR_COLUMNS,
    SCOPE_SPAN,
    VT_INT,
    VT_STR,
    Dictionary,
    SpanBatch,
    _empty_cols,
)
from tempo_tpu_torch.model.trace import (
    KIND_CLIENT,
    KIND_SERVER,
    STATUS_ERROR,
    STATUS_UNSET,
    Span,
    Trace,
)

SERVICES = ["frontend", "cart", "checkout", "currency", "shipping", "payment", "email", "ads"]
OP_NAMES = ["GET /api/products", "POST /api/cart", "oteldemo.Checkout/Place", "db.query", "cache.get", "render"]
ATTR_KEYS = ["k8s.pod.name", "region", "customer.id", "retry.count", "db.statement"]
HTTP_METHODS = ["GET", "POST", "PUT", "DELETE"]


def make_trace_id(rng: np.random.Generator) -> bytes:
    return rng.bytes(16)


def make_trace(
    seed: int,
    n_spans: int | None = None,
    base_time_ns: int = 1_700_000_000 * 10**9,
    trace_id: bytes | None = None,
) -> Trace:
    """One deterministic trace: a span tree across 1-3 services."""
    rng = np.random.default_rng(seed)
    if trace_id is None:
        trace_id = make_trace_id(rng)
    if n_spans is None:
        n_spans = int(rng.integers(2, 30))
    n_services = int(rng.integers(1, min(4, n_spans + 1)))
    svc_names = list(rng.choice(SERVICES, size=n_services, replace=False))
    trace = Trace(trace_id=trace_id)
    span_ids = [rng.bytes(8) for _ in range(n_spans)]
    start0 = base_time_ns + int(rng.integers(0, 10**9))
    per_service: dict[str, list] = {s: [] for s in svc_names}
    for i in range(n_spans):
        svc = svc_names[int(rng.integers(0, n_services))]
        parent = span_ids[int(rng.integers(0, i))] if i else b"\x00" * 8
        attrs = {
            "http.method": str(rng.choice(HTTP_METHODS)),
            "http.url": f"http://{svc}/{int(rng.integers(0, 50))}",
            "http.status_code": int(rng.choice([200, 200, 200, 404, 500])),
            str(rng.choice(ATTR_KEYS)): str(int(rng.integers(0, 1000))),
            "level": int(rng.integers(0, 5)),
        }
        span = Span(
            trace_id=trace_id,
            span_id=span_ids[i],
            parent_span_id=parent,
            name=str(rng.choice(OP_NAMES)),
            start_unix_nano=start0 + int(rng.integers(0, 10**8)),
            duration_nano=int(rng.integers(10**5, 10**9)),
            kind=KIND_SERVER if i == 0 else KIND_CLIENT,
            status_code=STATUS_ERROR if attrs["http.status_code"] >= 500 else STATUS_UNSET,
            attributes=attrs,
        )
        per_service[svc].append(span)
    for svc in svc_names:
        if per_service[svc]:
            resource = {"service.name": svc, "cluster": "test", "ip": "10.0.0.1"}
            trace.batches.append((resource, per_service[svc]))
    return trace


def make_traces(n: int, seed: int = 0, spans_per_trace: int | None = None, **kw) -> list[Trace]:
    return [make_trace(seed * 1_000_003 + i, n_spans=spans_per_trace, **kw) for i in range(n)]


def make_batch(
    n_traces: int,
    spans_per_trace: int,
    seed: int = 0,
    base_time_ns: int = 1_700_000_000 * 10**9,
    n_attrs_per_span: int = 2,
) -> SpanBatch:
    """Benchmark-scale columnar generation (no object trees)."""
    rng = np.random.default_rng(seed)
    n = n_traces * spans_per_trace
    d = Dictionary()
    svc_codes = np.array([d.add(s) for s in SERVICES], dtype=np.uint32)
    name_codes = np.array([d.add(s) for s in OP_NAMES], dtype=np.uint32)
    method_codes = np.array([d.add(s) for s in HTTP_METHODS], dtype=np.uint32)
    url_codes = np.array([d.add(f"http://svc/{i}") for i in range(64)], dtype=np.uint32)
    key_codes = np.array([d.add(s) for s in ATTR_KEYS], dtype=np.uint32)
    val_codes = np.array([d.add(f"v{i}") for i in range(256)], dtype=np.uint32)

    tid = rng.integers(0, 2**32, size=(n_traces, 4), dtype=np.uint32)
    cols = {
        "trace_id": np.repeat(tid, spans_per_trace, axis=0),
        "span_id": rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32),
        "parent_span_id": rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32),
        "start_unix_nano": (base_time_ns + rng.integers(0, 10**9, size=n)).astype(np.uint64),
        "duration_nano": rng.integers(10**5, 10**9, size=n).astype(np.uint64),
        "kind": rng.integers(1, 6, size=n).astype(np.uint8),
        "status_code": rng.choice([0, 0, 0, 2], size=n).astype(np.uint8),
        "name": rng.choice(name_codes, size=n).astype(np.uint32),
        "service": np.repeat(rng.choice(svc_codes, size=n_traces), spans_per_trace).astype(np.uint32),
        "http_status": rng.choice([200, 200, 404, 500], size=n).astype(np.uint16),
        "http_method": rng.choice(method_codes, size=n).astype(np.uint32),
        "http_url": rng.choice(url_codes, size=n).astype(np.uint32),
    }
    m = n * n_attrs_per_span
    attrs = {
        "attr_span": np.repeat(np.arange(n, dtype=np.uint32), n_attrs_per_span),
        "attr_scope": np.full(m, SCOPE_SPAN, dtype=np.uint8),
        "attr_key": rng.choice(key_codes, size=m).astype(np.uint32),
        "attr_vtype": rng.choice([VT_STR, VT_INT], size=m).astype(np.uint8),
        "attr_str": rng.choice(val_codes, size=m).astype(np.uint32),
        "attr_num": rng.integers(0, 1000, size=m).astype(np.float64),
    }
    attrs["attr_str"] = np.where(attrs["attr_vtype"] == VT_STR, attrs["attr_str"], 0).astype(np.uint32)
    batch = SpanBatch(cols=cols, attrs=attrs, dictionary=d)
    return batch.sorted_by_trace()


def make_graph_batch(
    n_traces: int,
    spans_per_trace: int,
    seed: int = 0,
    base_time_ns: int = 1_700_000_000 * 10**9,
    error_rate: float = 0.1,
) -> SpanBatch:
    """Columnar traces with REAL parent chains and cross-service
    client/server hops (make_batch's parents are random ids, so it pairs
    no service-graph edges). Each trace is one call chain: span i's
    parent is span i-1; even hops are SERVER spans entering service
    i//2, odd hops the CLIENT call out of it — exactly the pairing rule
    the service-graphs processor and the stored-block aggregation share.
    Durations nest (children strictly inside parents), so critical-path
    self times are all positive and hand-checkable."""
    rng = np.random.default_rng(seed)
    k = spans_per_trace
    n = n_traces * k
    d = Dictionary()
    svc_codes = np.array([d.add(s) for s in SERVICES], dtype=np.uint32)
    name_codes = np.array([d.add(s) for s in OP_NAMES], dtype=np.uint32)
    tid = rng.integers(0, 2**32, size=(n_traces, 4), dtype=np.uint32)
    hop = np.tile(np.arange(k, dtype=np.int64), n_traces)
    # per-trace random service rotation so many distinct edges exist
    rot = np.repeat(rng.integers(0, len(SERVICES), size=n_traces), k)
    svc_idx = (hop // 2 + rot) % len(svc_codes)
    sid = rng.integers(1, 2**32, size=(n, 2), dtype=np.uint32)
    parent = np.zeros((n, 2), np.uint32)
    not_root = hop > 0
    parent[not_root] = sid[np.flatnonzero(not_root) - 1]
    # nested timing: each child starts 1ms into its parent and runs
    # (k - hop) * 10ms, so self time is 10ms-ish everywhere
    start = (base_time_ns + np.repeat(rng.integers(0, 10**9, size=n_traces), k)
             + hop * 1_000_000).astype(np.uint64)
    duration = ((k - hop) * 10_000_000 + rng.integers(0, 10**6, size=n)).astype(np.uint64)
    failed = rng.random(n) < error_rate
    cols = {
        "trace_id": np.repeat(tid, k, axis=0),
        "span_id": sid,
        "parent_span_id": parent,
        "start_unix_nano": start,
        "duration_nano": duration,
        "kind": np.where(hop % 2 == 0, KIND_SERVER, KIND_CLIENT).astype(np.uint8),
        "status_code": np.where(failed, 2, 0).astype(np.uint8),
        "name": rng.choice(name_codes, size=n).astype(np.uint32),
        "service": svc_codes[svc_idx],
        "http_status": np.where(failed, 500, 200).astype(np.uint16),
        "http_method": np.zeros(n, np.uint32),
        "http_url": np.zeros(n, np.uint32),
    }
    batch = SpanBatch(cols=cols, attrs=_empty_cols(ATTR_COLUMNS), dictionary=d)
    return batch.sorted_by_trace()
