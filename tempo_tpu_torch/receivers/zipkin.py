"""Port of tempo_tpu/receivers/zipkin.py, copied as is (host code).

Zipkin JSON v2 receiver codec.

Translates Zipkin v2 span lists (the POST /api/v2/spans payload) into
model Traces, following the same semantic mapping the collector's
zipkinreceiver does for the reference
(modules/distributor/receiver/shim.go:129 hosts it): localEndpoint →
service.name, kind CLIENT/SERVER/PRODUCER/CONSUMER → OTLP kinds,
timestamps/durations are microseconds, tags become string attributes.
"""

from __future__ import annotations

import binascii

from tempo_tpu_torch.model.trace import (
    KIND_CLIENT,
    KIND_CONSUMER,
    KIND_PRODUCER,
    KIND_SERVER,
    STATUS_ERROR,
    Span,
    Trace,
)

_KINDS = {
    "CLIENT": KIND_CLIENT,
    "SERVER": KIND_SERVER,
    "PRODUCER": KIND_PRODUCER,
    "CONSUMER": KIND_CONSUMER,
}


def _id_bytes(s: str, size: int) -> bytes:
    s = (s or "").strip()
    if len(s) % 2:
        s = "0" + s
    try:
        raw = binascii.unhexlify(s)
    except (binascii.Error, ValueError):
        raw = b""
    return raw.rjust(size, b"\x00")[-size:]


def decode_spans_thrift(body: bytes) -> list[Trace]:
    """Zipkin v1 thrift payload (POST /api/v1/spans,
    application/x-thrift): a thrift-binary LIST of zipkincore Span
    structs. Field ids per zipkincore.thrift: 1 trace_id (i64),
    3 name, 4 id, 5 parent_id, 6 annotations (cs/cr/ss/sr carry the
    kind + host service), 8 binary_annotations (string tags),
    10 timestamp (us), 11 duration (us), 12 trace_id_high.

    Reference role: the collector's zipkin receiver accepts the same
    legacy thrift form beside JSON v2
    (modules/distributor/receiver/shim.go:129)."""
    from tempo_tpu_torch.receivers import jaeger as th

    r = th._Reader(body)
    n = r.list_header(th.T_STRUCT)
    raw_spans = []
    for _ in range(n):
        tid_lo = tid_hi = sid = pid = 0
        name = ""
        ts_us = dur_us = 0
        service = ""
        kind = 0
        tags: dict = {}
        for fid, ft in r.fields():
            if fid == 1 and ft == th.T_I64:
                tid_lo = r.i64()
            elif fid == 3 and ft == th.T_STRING:
                name = r.binary().decode("utf-8", "replace")
            elif fid == 4 and ft == th.T_I64:
                sid = r.i64()
            elif fid == 5 and ft == th.T_I64:
                pid = r.i64()
            elif fid == 6 and ft == th.T_LIST:
                # annotations: value string cs/cr (client) or ss/sr
                # (server); host endpoint carries the service name
                cnt = r.list_header(th.T_STRUCT)
                for _ in range(cnt):
                    a_val, a_svc = "", ""
                    for afid, aft in r.fields():
                        if afid == 2 and aft == th.T_STRING:
                            a_val = r.binary().decode("utf-8", "replace")
                        elif afid == 3 and aft == th.T_STRUCT:
                            a_svc = _thrift_endpoint_service(r, th)
                        else:
                            r.skip(aft)
                    if a_val in ("cs", "cr"):
                        kind = KIND_CLIENT
                    elif a_val in ("ss", "sr"):
                        kind = KIND_SERVER
                    if a_svc:
                        service = a_svc
            elif fid == 8 and ft == th.T_LIST:
                cnt = r.list_header(th.T_STRUCT)
                for _ in range(cnt):
                    b_key, b_val, b_type, b_svc = "", b"", 6, ""
                    for bfid, bft in r.fields():
                        if bfid == 1 and bft == th.T_STRING:
                            b_key = r.binary().decode("utf-8", "replace")
                        elif bfid == 2 and bft == th.T_STRING:
                            b_val = r.binary()
                        elif bfid == 3 and bft == th.T_I32:
                            b_type = r.i32()
                        elif bfid == 4 and bft == th.T_STRUCT:
                            b_svc = _thrift_endpoint_service(r, th)
                        else:
                            r.skip(bft)
                    if b_key:
                        tags[b_key] = b_val.decode("utf-8", "replace") if b_type == 6 else b_val.hex()
                    # sa/ca describe the REMOTE endpoint — never the
                    # reporting service (zipkincore semantics)
                    if b_svc and not service and b_key not in ("sa", "ca"):
                        service = b_svc
            elif fid == 10 and ft == th.T_I64:
                ts_us = r.i64()
            elif fid == 11 and ft == th.T_I64:
                dur_us = r.i64()
            elif fid == 12 and ft == th.T_I64:
                tid_hi = r.i64()
            else:
                r.skip(ft)
        raw_spans.append((tid_hi, tid_lo, sid, pid, name, ts_us, dur_us, kind, service, tags))

    def gen():
        for tid_hi, tid_lo, sid, pid, name, ts_us, dur_us, kind, service, tags in raw_spans:
            tid = (tid_hi & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big") + (
                tid_lo & 0xFFFFFFFFFFFFFFFF
            ).to_bytes(8, "big")
            yield tid, service, Span(
                trace_id=tid,
                span_id=(sid & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"),
                parent_span_id=(pid & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"),
                name=name,
                start_unix_nano=ts_us * 1000,
                duration_nano=dur_us * 1000,
                kind=kind,
                status_code=STATUS_ERROR if "error" in tags else 0,
                attributes=tags,
            )

    return _bucket_by_trace(gen())


def _thrift_endpoint_service(r, th) -> str:
    """Endpoint{1 ipv4 i32, 2 port i16, 3 service_name} -> service."""
    svc = ""
    for fid, ft in r.fields():
        if fid == 3 and ft == th.T_STRING:
            svc = r.binary().decode("utf-8", "replace")
        else:
            r.skip(ft)
    return svc


def decode_spans_json(spans: list) -> list[Trace]:
    def gen():
        for z in spans or []:
            tid = _id_bytes(z.get("traceId", ""), 16)
            service = ((z.get("localEndpoint") or {}).get("serviceName")) or ""
            tags = {k: str(v) for k, v in (z.get("tags") or {}).items()}
            yield tid, service, Span(
                trace_id=tid,
                span_id=_id_bytes(z.get("id", ""), 8),
                parent_span_id=_id_bytes(z.get("parentId", ""), 8),
                name=z.get("name", ""),
                start_unix_nano=int(z.get("timestamp", 0)) * 1000,
                duration_nano=int(z.get("duration", 0)) * 1000,
                kind=_KINDS.get(z.get("kind", ""), 0),
                status_code=STATUS_ERROR if "error" in tags else 0,
                attributes=tags,
            )

    return _bucket_by_trace(gen())


def _bucket_by_trace(items) -> list[Trace]:
    """(trace_id, service, Span) stream -> Traces with per-service
    resource batches — shared by both zipkin carriers so the bucketing
    cannot drift between them."""
    per_trace: dict[bytes, dict[str, tuple[dict, list]]] = {}
    for tid, service, span in items:
        buckets = per_trace.setdefault(tid, {})
        if service not in buckets:
            buckets[service] = ({"service.name": service}, [])
        buckets[service][1].append(span)
    out = []
    for tid, buckets in per_trace.items():
        t = Trace(trace_id=tid)
        t.batches = list(buckets.values())
        out.append(t)
    return out
