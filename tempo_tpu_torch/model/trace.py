"""Object-form trace model for protocol boundaries.

OTLP semantics (span kinds, status codes, resource vs span attributes)
without depending on OTLP protos; conversion to/from `SpanBatch` happens
only at the edges (receiver, JSON response). Port of
tempo_tpu/model/trace.py: the constants, the Span and Trace
dataclasses, combine_traces, and the object <-> columnar conversion
(traces_to_batch, batch_to_traces) that find-by-ID answers with.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tempo_tpu_torch.model.columnar import (
    SCOPE_SPAN,
    VT_BOOL,
    VT_INT,
    VT_STR,
    Dictionary,
    SpanBatch,
)


# OTLP span kinds
KIND_UNSPECIFIED = 0
KIND_INTERNAL = 1
KIND_SERVER = 2
KIND_CLIENT = 3
KIND_PRODUCER = 4
KIND_CONSUMER = 5

# OTLP status codes
STATUS_UNSET = 0
STATUS_OK = 1
STATUS_ERROR = 2

WELL_KNOWN_SPAN_ATTRS = ("http.method", "http.url", "http.status_code")


@dataclass
class Span:
    trace_id: bytes  # 16 bytes
    span_id: bytes  # 8 bytes
    name: str = ""
    parent_span_id: bytes = b"\x00" * 8
    start_unix_nano: int = 0
    duration_nano: int = 0
    kind: int = KIND_UNSPECIFIED
    status_code: int = STATUS_UNSET
    attributes: dict = field(default_factory=dict)

    @property
    def end_unix_nano(self) -> int:
        return self.start_unix_nano + self.duration_nano


@dataclass
class Trace:
    """A trace: spans grouped by resource (service)."""

    trace_id: bytes
    # list of (resource_attrs, spans); resource_attrs must include "service.name"
    batches: list = field(default_factory=list)

    def span_count(self) -> int:
        return sum(len(s) for _, s in self.batches)

    def all_spans(self):
        for _, spans in self.batches:
            yield from spans

    def start_end_seconds(self) -> tuple[int, int]:
        starts = [s.start_unix_nano for s in self.all_spans()]
        ends = [s.end_unix_nano for s in self.all_spans()]
        if not starts:
            return 0, 0
        return min(starts) // 10**9, max(ends) // 10**9 + 1


def combine_traces(parts: list[Trace]) -> Trace | None:
    """Merge partial traces for one ID, deduping spans by span_id.

    API fan-in combiner (reference: querier's trace.NewCombiner usage,
    modules/querier/querier.go:203-243) — partials come from RF>1
    ingesters and multiple blocks.
    """
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    out = Trace(trace_id=parts[0].trace_id)
    seen: set[bytes] = set()
    by_service: dict[tuple, list] = {}
    res_for_key: dict[tuple, dict] = {}
    for p in parts:
        for resource, spans in p.batches:
            key = tuple(sorted((k, str(v)) for k, v in resource.items()))
            res_for_key.setdefault(key, resource)
            bucket = by_service.setdefault(key, [])
            for s in spans:
                if s.span_id in seen:
                    continue
                seen.add(s.span_id)
                bucket.append(s)
    for key, spans in by_service.items():
        if spans:
            out.batches.append((res_for_key[key], sorted(spans, key=lambda s: s.start_unix_nano)))
    return out if out.batches else None


# ---------------------------------------------------------------------------
# object <-> columnar conversion
# ---------------------------------------------------------------------------


def traces_to_batch(traces: list[Trace], dictionary: Dictionary | None = None) -> SpanBatch:
    """Flatten object traces into a SpanBatch (resource values replicated
    per span row, well-known attrs promoted to dedicated columns). Field
    extraction runs through BatchBuilder: per-span work is list appends,
    and all dictionary hashing happens once per unique string at build."""
    from tempo_tpu_torch.model.batchbuild import BatchBuilder

    b = BatchBuilder(dictionary)
    for t in traces:
        for resource, spans in t.batches:
            b.begin_resource(resource)
            for s in spans:
                b.add_span(s.trace_id, s.span_id, s.parent_span_id, s.name,
                           s.kind, s.start_unix_nano, s.duration_nano,
                           s.status_code, s.attributes)
    return b.build()


def batch_to_traces(batch: SpanBatch) -> list[Trace]:
    """Rebuild object traces (grouped by trace then service) from a batch."""
    d = batch.dictionary
    out: dict[bytes, Trace] = {}
    groups: dict[tuple, tuple[dict, list]] = {}
    # gather attrs per span
    attrs_by_span: dict[int, list] = {}
    res_by_span: dict[int, list] = {}
    for i in range(batch.num_attrs):
        span = int(batch.attrs["attr_span"][i])
        key = d[int(batch.attrs["attr_key"][i])]
        vt = int(batch.attrs["attr_vtype"][i])
        if vt == VT_STR:
            val = d[int(batch.attrs["attr_str"][i])]
        elif vt == VT_INT:
            val = int(batch.attrs["attr_num"][i])
        elif vt == VT_BOOL:
            val = bool(batch.attrs["attr_num"][i])
        else:
            val = float(batch.attrs["attr_num"][i])
        scope = int(batch.attrs["attr_scope"][i])
        (attrs_by_span if scope == SCOPE_SPAN else res_by_span).setdefault(span, []).append((key, val))

    c = batch.cols
    for row in range(batch.num_spans):
        tid = c["trace_id"][row].astype(">u4").tobytes()
        service = d[int(c["service"][row])]
        attrs = dict(attrs_by_span.get(row, []))
        if c["http_status"][row]:
            attrs["http.status_code"] = int(c["http_status"][row])
        if c["http_method"][row]:
            attrs["http.method"] = d[int(c["http_method"][row])]
        if c["http_url"][row]:
            attrs["http.url"] = d[int(c["http_url"][row])]
        span = Span(
            trace_id=tid,
            span_id=c["span_id"][row].astype(">u4").tobytes(),
            parent_span_id=c["parent_span_id"][row].astype(">u4").tobytes(),
            name=d[int(c["name"][row])],
            start_unix_nano=int(c["start_unix_nano"][row]),
            duration_nano=int(c["duration_nano"][row]),
            kind=int(c["kind"][row]),
            status_code=int(c["status_code"][row]),
            attributes=attrs,
        )
        trace = out.setdefault(tid, Trace(trace_id=tid))
        resource = {"service.name": service, **dict(res_by_span.get(row, []))}
        rkey = (tid, tuple(sorted((k, str(v)) for k, v in resource.items())))
        if rkey not in groups:
            groups[rkey] = (resource, [])
            trace.batches.append(groups[rkey])
        groups[rkey][1].append(span)
    return list(out.values())
