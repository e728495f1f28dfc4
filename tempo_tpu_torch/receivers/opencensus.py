"""Port of tempo_tpu/receivers/opencensus.py, copied as is (host code).

OpenCensus trace receiver codec.

Reference: the receiver shim hosts the OC agent receiver beside OTLP and
Jaeger (modules/distributor/receiver/shim.go:110-133, the
"opencensus" factory). The wire format is the OC agent proto
(opencensus/proto/agent/trace/v1/trace_service.proto
ExportTraceServiceRequest: node=1, spans=2 rep, resource=3;
opencensus/proto/trace/v1/trace.proto Span: trace_id=1, span_id=2,
parent_span_id=3, name=4 TruncatableString{value=1}, start_time=5,
end_time=6 Timestamp{seconds=1,nanos=2}, attributes=7
{attribute_map=1 map<string, AttributeValue{string=1|int=2|bool=3|
double=4}>}, status=11 {code=1}, kind=14, resource=16), decoded with
the hand-rolled wire codec like every other protocol here.
"""

from __future__ import annotations

from tempo_tpu_torch.model.trace import (
    KIND_CLIENT,
    KIND_SERVER,
    KIND_UNSPECIFIED,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_UNSET,
    Span,
    Trace,
)
from tempo_tpu_torch.receivers import protowire

# OC SpanKind: 0 unspecified, 1 SERVER, 2 CLIENT
_KIND = {0: KIND_UNSPECIFIED, 1: KIND_SERVER, 2: KIND_CLIENT}


def _decode_ts(buf: bytes) -> int:
    sec = nanos = 0
    for field, _wt, val in protowire.iter_fields(buf):
        if field == 1:
            sec = val
        elif field == 2:
            nanos = val
    return sec * 10**9 + nanos


def _decode_truncatable(buf: bytes) -> str:
    for field, _wt, val in protowire.iter_fields(buf):
        if field == 1:
            return val.decode("utf-8", "replace")
    return ""


def _decode_attr_value(buf: bytes):
    for field, _wt, val in protowire.iter_fields(buf):
        if field == 1:  # string_value (TruncatableString)
            return _decode_truncatable(val)
        if field == 2:  # int_value
            return protowire.signed64(val)
        if field == 3:  # bool_value
            return bool(val)
        if field == 4:  # double_value (fixed64)
            return protowire.fixed64_to_double(val)
    return None


def _decode_attributes(buf: bytes) -> dict:
    out = {}
    for field, _wt, val in protowire.iter_fields(buf):
        if field == 1:  # attribute_map entry {key=1, value=2}
            k, v = "", None
            for f2, _w2, v2 in protowire.iter_fields(val):
                if f2 == 1:
                    k = v2.decode("utf-8", "replace")
                elif f2 == 2:
                    v = _decode_attr_value(v2)
            if k and v is not None:
                out[k] = v
    return out


def _decode_span(buf: bytes) -> tuple[Span, dict]:
    """-> (Span, per-span resource labels from Span.resource=16)."""
    tid = sid = psid = b""
    name = ""
    start = end = 0
    kind = 0
    status = STATUS_UNSET
    attrs: dict = {}
    span_res: dict = {}
    for field, _wt, val in protowire.iter_fields(buf):
        if field == 1:
            tid = val
        elif field == 2:
            sid = val
        elif field == 3:
            psid = val
        elif field == 4:
            name = _decode_truncatable(val)
        elif field == 5:
            start = _decode_ts(val)
        elif field == 6:
            end = _decode_ts(val)
        elif field == 7:
            attrs = _decode_attributes(val)
        elif field == 11:  # Status{code=1}
            code = 0
            for f2, _w2, v2 in protowire.iter_fields(val):
                if f2 == 1:
                    code = protowire.signed64(v2) if _w2 == 0 else 0
            status = STATUS_OK if code == 0 else STATUS_ERROR
        elif field == 14:
            kind = val
        elif field == 16:  # per-span Resource override
            span_res = _decode_resource(val)
    span = Span(
        trace_id=tid.rjust(16, b"\x00"),
        span_id=sid.rjust(8, b"\x00"),
        parent_span_id=psid.rjust(8, b"\x00") if psid else b"\x00" * 8,
        name=name,
        start_unix_nano=start,
        duration_nano=max(0, end - start),
        status_code=status,
        kind=_KIND.get(kind, KIND_UNSPECIFIED),
        attributes=attrs,
    )
    return span, span_res


def _decode_resource(buf: bytes) -> dict:
    """Resource{type=1, labels=2 map<string,string>} -> attrs dict."""
    out = {}
    for field, _wt, val in protowire.iter_fields(buf):
        if field == 2:
            k = v = ""
            for f2, _w2, v2 in protowire.iter_fields(val):
                if f2 == 1:
                    k = v2.decode("utf-8", "replace")
                elif f2 == 2:
                    v = v2.decode("utf-8", "replace")
            if k:
                out[k] = v
    return out


def _decode_node_service(buf: bytes) -> str:
    """Node{service_info=3{name=1}} -> service name."""
    for field, _wt, val in protowire.iter_fields(buf):
        if field == 3:
            for f2, _w2, v2 in protowire.iter_fields(val):
                if f2 == 1:
                    return v2.decode("utf-8", "replace")
    return ""


def decode_export_request(buf: bytes) -> list[Trace]:
    """ExportTraceServiceRequest -> Traces grouped by trace id."""
    service = ""
    resource: dict = {}
    spans: list[tuple[Span, dict]] = []
    for field, _wt, val in protowire.iter_fields(buf):
        if field == 1:
            service = _decode_node_service(val)
        elif field == 2:
            spans.append(_decode_span(val))
        elif field == 3:
            resource = _decode_resource(val)

    base_res = dict(resource)
    if service and "service.name" not in base_res:
        base_res["service.name"] = service
    base_res.setdefault("service.name", "")

    by_tid: dict[bytes, dict] = {}
    for span, span_res in spans:
        res = {**base_res, **span_res} if span_res else base_res
        key = tuple(sorted(res.items()))
        groups = by_tid.setdefault(span.trace_id, {})
        groups.setdefault(key, (dict(res), []))[1].append(span)
    out = []
    for tid, groups in by_tid.items():
        out.append(Trace(trace_id=tid, batches=list(groups.values())))
    return out
