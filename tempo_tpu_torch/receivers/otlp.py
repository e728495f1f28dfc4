"""Port of tempo_tpu/receivers/otlp.py, copied as is (host code).

OTLP trace codec: protobuf wire format and OTLP/JSON.

Decodes ExportTraceServiceRequest / TracesData into model.Trace objects
and re-encodes them (the encoder backs the generic forwarder and the
Jaeger bridge round-trip). Schema follows the public OTLP spec
(opentelemetry/proto/trace/v1/trace.proto); the reference hosts the
collector's OTLP receiver in-process
(modules/distributor/receiver/shim.go:110-133).

Field numbers used:
  TracesData.resource_spans=1
  ResourceSpans: resource=1 scope_spans=2 (legacy instrumentation_library_spans=1000 ignored)
  Resource.attributes=1
  ScopeSpans: scope=1 spans=2
  Span: trace_id=1 span_id=2 trace_state=3 parent_span_id=4 name=5 kind=6
        start_time_unix_nano=7 end_time_unix_nano=8 attributes=9
        events=11 links=13 status=15
  Status: message=2 code=3
  KeyValue: key=1 value=2
  AnyValue: string=1 bool=2 int=3 double=4 array=5 kvlist=6 bytes=7
"""

from __future__ import annotations

import base64
import binascii

from tempo_tpu_torch.model.trace import Span, Trace
from tempo_tpu_torch.receivers import protowire as w


# ---------------------------------------------------------------------------
# decode: protobuf
# ---------------------------------------------------------------------------


def _decode_anyvalue(buf: bytes):
    for field, wt, val in w.iter_fields(buf):
        if field == 1:
            return val.decode("utf-8", "replace")
        if field == 2:
            return bool(val)
        if field == 3:
            return w.signed64(val)
        if field == 4:
            return w.fixed64_to_double(val)
        if field == 5:  # ArrayValue{repeated AnyValue values=1}
            return [_decode_anyvalue(v) for f, _, v in w.iter_fields(val) if f == 1]
        if field == 6:  # KeyValueList{repeated KeyValue values=1}
            return {
                k: v2
                for f, _, v in w.iter_fields(val)
                if f == 1
                for k, v2 in [_decode_keyvalue(v)]
            }
        if field == 7:
            return base64.b64encode(val).decode()
    return None


def _decode_keyvalue(buf: bytes):
    key, value = "", None
    for field, wt, val in w.iter_fields(buf):
        if field == 1:
            key = val.decode("utf-8", "replace")
        elif field == 2:
            value = _decode_anyvalue(val)
    return key, value


def _decode_attrs(bufs: list) -> dict:
    out = {}
    for b in bufs:
        k, v = _decode_keyvalue(b)
        if k:
            out[k] = v
    return out


def _decode_span(buf: bytes) -> Span:
    s = Span(trace_id=b"\x00" * 16, span_id=b"\x00" * 8)
    start = end = 0
    attr_bufs = []
    for field, wt, val in w.iter_fields(buf):
        if field == 1:
            s.trace_id = bytes(val).rjust(16, b"\x00")[-16:]
        elif field == 2:
            s.span_id = bytes(val).rjust(8, b"\x00")[-8:]
        elif field == 4:
            s.parent_span_id = bytes(val).rjust(8, b"\x00")[-8:]
        elif field == 5:
            s.name = val.decode("utf-8", "replace")
        elif field == 6:
            s.kind = int(val)
        elif field == 7:
            start = int(val)
        elif field == 8:
            end = int(val)
        elif field == 9:
            attr_bufs.append(val)
        elif field == 15:
            for f2, _, v2 in w.iter_fields(val):
                if f2 == 3:
                    s.status_code = int(v2)
    s.start_unix_nano = start
    s.duration_nano = max(0, end - start)
    s.attributes = _decode_attrs(attr_bufs)
    return s


def decode_traces_request(buf: bytes) -> list[Trace]:
    """Decode ExportTraceServiceRequest/TracesData bytes into Traces
    (spans for one trace may appear across many ResourceSpans; grouping
    into per-ID Trace objects happens here)."""
    per_trace: dict[bytes, Trace] = {}
    for field, wt, rs in w.iter_fields(buf):
        if field != 1:
            continue
        resource_attrs: dict = {}
        span_bufs: list = []
        for f2, _, val in w.iter_fields(rs):
            if f2 == 1:  # Resource
                for f3, _, v3 in w.iter_fields(val):
                    if f3 == 1:
                        k, v = _decode_keyvalue(v3)
                        if k:
                            resource_attrs[k] = v
            elif f2 == 2:  # ScopeSpans
                for f3, _, v3 in w.iter_fields(val):
                    if f3 == 2:
                        span_bufs.append(v3)
        if "service.name" not in resource_attrs:
            resource_attrs["service.name"] = ""
        by_trace_spans: dict[bytes, list] = {}
        for sb in span_bufs:
            span = _decode_span(sb)
            by_trace_spans.setdefault(span.trace_id, []).append(span)
        for tid, spans in by_trace_spans.items():
            t = per_trace.setdefault(tid, Trace(trace_id=tid))
            t.batches.append((dict(resource_attrs), spans))
    return list(per_trace.values())


# ---------------------------------------------------------------------------
# decode: protobuf, columnar single pass
# ---------------------------------------------------------------------------


def _decode_span_into(b, buf: bytes) -> None:
    """One wire-format Span straight into a BatchBuilder row — the
    columnar twin of _decode_span, with no Span object in between."""
    tid, sid, pid = b"\x00" * 16, b"\x00" * 8, b"\x00" * 8
    name = ""
    kind = status = 0
    start = end = 0
    attr_bufs: list = []
    for field, wt, val in w.iter_fields(buf):
        if field == 1:
            tid = bytes(val)
        elif field == 2:
            sid = bytes(val)
        elif field == 4:
            pid = bytes(val)
        elif field == 5:
            name = val.decode("utf-8", "replace")
        elif field == 6:
            kind = int(val)
        elif field == 7:
            start = int(val)
        elif field == 8:
            end = int(val)
        elif field == 9:
            attr_bufs.append(val)
        elif field == 15:
            for f2, _, v2 in w.iter_fields(val):
                if f2 == 3:
                    status = int(v2)
    b.add_span(tid, sid, pid, name, kind, start, max(0, end - start),
               status, _decode_attrs(attr_bufs) if attr_bufs else None)


def decode_traces_request_columnar(buf: bytes, dictionary=None):
    """Decode ExportTraceServiceRequest/TracesData bytes directly into a
    SpanBatch: one pass over the wire, no Span/Trace objects and no
    per-trace regrouping (trace identity IS the trace_id column; the
    ingester regroups by ID columns anyway). Spans land in wire order."""
    from tempo_tpu_torch.model.batchbuild import BatchBuilder

    b = BatchBuilder(dictionary)
    for field, wt, rs in w.iter_fields(buf):
        if field != 1:
            continue
        resource_attrs: dict = {}
        span_bufs: list = []
        for f2, _, val in w.iter_fields(rs):
            if f2 == 1:  # Resource
                for f3, _, v3 in w.iter_fields(val):
                    if f3 == 1:
                        k, v = _decode_keyvalue(v3)
                        if k:
                            resource_attrs[k] = v
            elif f2 == 2:  # ScopeSpans
                for f3, _, v3 in w.iter_fields(val):
                    if f3 == 2:
                        span_bufs.append(v3)
        if "service.name" not in resource_attrs:
            resource_attrs["service.name"] = ""
        b.begin_resource(resource_attrs)
        for sb in span_bufs:
            _decode_span_into(b, sb)
    return b.build()


def decode_traces_json_columnar(doc: dict, dictionary=None):
    """OTLP/JSON TracesData directly into a SpanBatch (columnar twin of
    decode_traces_json; spans land in document order)."""
    from tempo_tpu_torch.model.batchbuild import BatchBuilder

    b = BatchBuilder(dictionary)
    for rs in doc.get("resourceSpans", doc.get("resource_spans", [])) or []:
        resource_attrs = _json_attrs((rs.get("resource") or {}).get("attributes", []))
        if "service.name" not in resource_attrs:
            resource_attrs["service.name"] = ""
        b.begin_resource(resource_attrs)
        scope_spans = rs.get("scopeSpans") or rs.get("scope_spans") or rs.get("instrumentationLibrarySpans") or []
        for ss in scope_spans:
            for js in ss.get("spans", []) or []:
                kind = js.get("kind", 0)
                if isinstance(kind, str):
                    kind = _KIND_NAMES.get(kind, 0)
                code = (js.get("status") or {}).get("code", 0)
                if isinstance(code, str):
                    code = _STATUS_NAMES.get(code, 0)
                start = int(js.get("startTimeUnixNano", 0))
                end = int(js.get("endTimeUnixNano", 0))
                b.add_span(
                    _id_from_json(js.get("traceId", ""), 16),
                    _id_from_json(js.get("spanId", ""), 8),
                    _id_from_json(js.get("parentSpanId", ""), 8),
                    js.get("name", ""), int(kind), start,
                    max(0, end - start), int(code),
                    _json_attrs(js.get("attributes", [])),
                )
    return b.build()


# ---------------------------------------------------------------------------
# encode: protobuf
# ---------------------------------------------------------------------------


def _encode_anyvalue(value) -> bytes:
    out = bytearray()
    if isinstance(value, bool):
        w.put_varint_field(out, 2, int(value))
    elif isinstance(value, int):
        w.put_varint_field(out, 3, value)
    elif isinstance(value, float):
        w.put_double_field(out, 4, value)
    elif isinstance(value, (list, tuple)):
        arr = bytearray()
        for v in value:
            w.put_bytes_field(arr, 1, _encode_anyvalue(v))
        w.put_bytes_field(out, 5, bytes(arr))
    elif isinstance(value, dict):
        kvl = bytearray()
        for k, v in value.items():
            w.put_bytes_field(kvl, 1, _encode_keyvalue(k, v))
        w.put_bytes_field(out, 6, bytes(kvl))
    else:
        w.put_str_field(out, 1, str(value))
    return bytes(out)


def _encode_keyvalue(key: str, value) -> bytes:
    out = bytearray()
    w.put_str_field(out, 1, key)
    w.put_bytes_field(out, 2, _encode_anyvalue(value))
    return bytes(out)


def _encode_span(s: Span) -> bytes:
    out = bytearray()
    w.put_bytes_field(out, 1, s.trace_id)
    w.put_bytes_field(out, 2, s.span_id)
    if s.parent_span_id and s.parent_span_id != b"\x00" * 8:
        w.put_bytes_field(out, 4, s.parent_span_id)
    w.put_str_field(out, 5, s.name)
    if s.kind:
        w.put_varint_field(out, 6, s.kind)
    w.put_fixed64_field(out, 7, s.start_unix_nano)
    w.put_fixed64_field(out, 8, s.end_unix_nano)
    for k, v in s.attributes.items():
        w.put_bytes_field(out, 9, _encode_keyvalue(k, v))
    if s.status_code:
        st = bytearray()
        w.put_varint_field(st, 3, s.status_code)
        w.put_bytes_field(out, 15, bytes(st))
    return bytes(out)


def encode_traces_request(traces: list[Trace]) -> bytes:
    """Encode Traces as an ExportTraceServiceRequest (one ResourceSpans
    per (trace, resource) batch)."""
    out = bytearray()
    for t in traces:
        for resource, spans in t.batches:
            rs = bytearray()
            res = bytearray()
            for k, v in resource.items():
                w.put_bytes_field(res, 1, _encode_keyvalue(k, v))
            w.put_bytes_field(rs, 1, bytes(res))
            ss = bytearray()
            for s in spans:
                w.put_bytes_field(ss, 2, _encode_span(s))
            w.put_bytes_field(rs, 2, bytes(ss))
            w.put_bytes_field(out, 1, bytes(rs))
    return bytes(out)


# ---------------------------------------------------------------------------
# OTLP/JSON
# ---------------------------------------------------------------------------


def _id_from_json(s: str, size: int) -> bytes:
    """OTLP/JSON encodes ids as hex; proto3-JSON tooling emits base64.
    Accept both."""
    if not s:
        return b"\x00" * size
    try:
        raw = binascii.unhexlify(s) if len(s) == size * 2 else base64.b64decode(s)
    except (binascii.Error, ValueError):
        try:
            raw = base64.b64decode(s)
        except (binascii.Error, ValueError):
            raw = b""
    return raw.rjust(size, b"\x00")[-size:]


def _json_anyvalue(v: dict):
    if "stringValue" in v:
        return str(v["stringValue"])
    if "boolValue" in v:
        return bool(v["boolValue"])
    if "intValue" in v:
        return int(v["intValue"])
    if "doubleValue" in v:
        return float(v["doubleValue"])
    if "arrayValue" in v:
        return [_json_anyvalue(x) for x in v["arrayValue"].get("values", [])]
    if "kvlistValue" in v:
        return {kv["key"]: _json_anyvalue(kv.get("value", {})) for kv in v["kvlistValue"].get("values", [])}
    if "bytesValue" in v:
        return str(v["bytesValue"])
    return None


def _json_attrs(lst: list) -> dict:
    return {kv["key"]: _json_anyvalue(kv.get("value", {})) for kv in lst or [] if "key" in kv}


_KIND_NAMES = {
    "SPAN_KIND_UNSPECIFIED": 0,
    "SPAN_KIND_INTERNAL": 1,
    "SPAN_KIND_SERVER": 2,
    "SPAN_KIND_CLIENT": 3,
    "SPAN_KIND_PRODUCER": 4,
    "SPAN_KIND_CONSUMER": 5,
}
_STATUS_NAMES = {"STATUS_CODE_UNSET": 0, "STATUS_CODE_OK": 1, "STATUS_CODE_ERROR": 2}


def _json_value(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, (list, tuple)):
        return {"arrayValue": {"values": [_json_value(x) for x in v]}}
    if isinstance(v, dict):
        return {"kvlistValue": {"values": [{"key": k, "value": _json_value(x)} for k, x in v.items()]}}
    return {"stringValue": str(v)}


def _json_attr_list(attrs: dict) -> list:
    return [{"key": k, "value": _json_value(v)} for k, v in attrs.items()]


def encode_traces_json(traces: list[Trace]) -> dict:
    """OTLP/JSON TracesData (hex ids per the OTLP/JSON encoding spec) —
    the GET /api/traces/{id} JSON response body."""
    resource_spans = []
    for t in traces:
        for resource, spans in t.batches:
            js_spans = []
            for s in spans:
                js = {
                    "traceId": s.trace_id.hex(),
                    "spanId": s.span_id.hex(),
                    "name": s.name,
                    "startTimeUnixNano": str(s.start_unix_nano),
                    "endTimeUnixNano": str(s.end_unix_nano),
                }
                if s.parent_span_id and s.parent_span_id != b"\x00" * 8:
                    js["parentSpanId"] = s.parent_span_id.hex()
                if s.kind:
                    js["kind"] = s.kind
                if s.attributes:
                    js["attributes"] = _json_attr_list(s.attributes)
                if s.status_code:
                    js["status"] = {"code": s.status_code}
                js_spans.append(js)
            resource_spans.append(
                {
                    "resource": {"attributes": _json_attr_list(resource)},
                    "scopeSpans": [{"spans": js_spans}],
                }
            )
    return {"resourceSpans": resource_spans}


def decode_traces_json(doc: dict) -> list[Trace]:
    per_trace: dict[bytes, Trace] = {}
    for rs in doc.get("resourceSpans", doc.get("resource_spans", [])) or []:
        resource_attrs = _json_attrs((rs.get("resource") or {}).get("attributes", []))
        if "service.name" not in resource_attrs:
            resource_attrs["service.name"] = ""
        scope_spans = rs.get("scopeSpans") or rs.get("scope_spans") or rs.get("instrumentationLibrarySpans") or []
        by_trace: dict[bytes, list] = {}
        for ss in scope_spans:
            for js in ss.get("spans", []) or []:
                kind = js.get("kind", 0)
                if isinstance(kind, str):
                    kind = _KIND_NAMES.get(kind, 0)
                code = (js.get("status") or {}).get("code", 0)
                if isinstance(code, str):
                    code = _STATUS_NAMES.get(code, 0)
                start = int(js.get("startTimeUnixNano", 0))
                end = int(js.get("endTimeUnixNano", 0))
                span = Span(
                    trace_id=_id_from_json(js.get("traceId", ""), 16),
                    span_id=_id_from_json(js.get("spanId", ""), 8),
                    parent_span_id=_id_from_json(js.get("parentSpanId", ""), 8),
                    name=js.get("name", ""),
                    start_unix_nano=start,
                    duration_nano=max(0, end - start),
                    kind=int(kind),
                    status_code=int(code),
                    attributes=_json_attrs(js.get("attributes", [])),
                )
                by_trace.setdefault(span.trace_id, []).append(span)
        for tid, spans in by_trace.items():
            t = per_trace.setdefault(tid, Trace(trace_id=tid))
            t.batches.append((dict(resource_attrs), spans))
    return list(per_trace.values())
