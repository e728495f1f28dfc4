"""Port of tempo_tpu/receivers/grpc_server.py (host code). grpcio is
imported only when a TraceGrpcServer is built: the decoders below serve
without it.

gRPC ingest receivers: OTLP TraceService/Export + Jaeger PostSpans.

Reference: modules/distributor/receiver/shim.go:110-133 — the receiver
shim hosts OTLP gRPC (port 4317, the default protocol of every OTel
SDK/collector) and Jaeger gRPC beside the HTTP receivers. The transport
here is grpcio (the Python analog of the google.golang.org/grpc package
the reference vendors); message payloads are decoded with this repo's
hand-rolled proto wire codec — no generated stubs:

- OTLP ExportTraceServiceRequest bodies are byte-identical to the OTLP
  HTTP protobuf payload, so they reuse receivers/otlp.py's decoder.
- Jaeger api_v2 PostSpansRequest (model.proto Batch/Span/KeyValue) is
  decoded below via receivers/protowire.py.

Tenancy: the X-Scope-OrgID metadata key, like the reference's gRPC auth
middleware. Rate-limit pushes map to RESOURCE_EXHAUSTED (the gRPC analog
of the HTTP 429 translation in api/server.py).
"""

from __future__ import annotations

import logging
from concurrent import futures

from tempo_tpu_torch.model.trace import KIND_CLIENT, KIND_SERVER, Span, Trace
from tempo_tpu_torch.receivers import otlp, protowire

log = logging.getLogger(__name__)

OTLP_EXPORT_METHOD = "/opentelemetry.proto.collector.trace.v1.TraceService/Export"
JAEGER_POST_SPANS_METHOD = "/jaeger.api_v2.CollectorService/PostSpans"
OPENCENSUS_EXPORT_METHOD = "/opencensus.proto.agent.trace.v1.TraceService/Export"
DEFAULT_GRPC_PORT = 4317  # reference: the OTLP collector default

_ORG_ID_KEYS = ("x-scope-orgid",)

RETRY_INFO_TYPE_URL = "type.googleapis.com/google.rpc.RetryInfo"
GRPC_RESOURCE_EXHAUSTED = 8  # google.rpc.Code.RESOURCE_EXHAUSTED


def encode_retry_status(code: int, message: str, retry_after_s: float) -> bytes:
    """google.rpc.Status{code, message, details=[RetryInfo{retry_delay}]}
    hand-rolled with this repo's proto wire codec — the standard payload
    gRPC clients read from the grpc-status-details-bin trailer to pace
    their retries (the reference's RESOURCE_EXHAUSTED pushes carry the
    same detail via dskit)."""
    seconds = int(retry_after_s)
    nanos = int((retry_after_s - seconds) * 1e9)
    duration = bytearray()
    if seconds:
        protowire.put_varint_field(duration, 1, seconds)
    if nanos:
        protowire.put_varint_field(duration, 2, nanos)
    retry_info = bytearray()
    protowire.put_bytes_field(retry_info, 1, bytes(duration))
    any_msg = bytearray()
    protowire.put_str_field(any_msg, 1, RETRY_INFO_TYPE_URL)
    protowire.put_bytes_field(any_msg, 2, bytes(retry_info))
    status = bytearray()
    protowire.put_varint_field(status, 1, code)
    protowire.put_str_field(status, 2, message)
    protowire.put_bytes_field(status, 3, bytes(any_msg))
    return bytes(status)


def decode_retry_info_delay(status_bytes: bytes) -> float | None:
    """Inverse of encode_retry_status for tests/clients: the RetryInfo
    retry_delay in seconds, or None when the Status has no such detail."""
    for field, _, val in protowire.iter_fields(status_bytes):
        if field != 3:
            continue
        type_url, value = "", b""
        for f2, _, v2 in protowire.iter_fields(val):
            if f2 == 1:
                type_url = v2.decode("utf-8", "replace")
            elif f2 == 2:
                value = v2
        if type_url != RETRY_INFO_TYPE_URL:
            continue
        for f2, _, v2 in protowire.iter_fields(value):
            if f2 == 1:
                seconds = nanos = 0
                for f3, _, v3 in protowire.iter_fields(v2):
                    if f3 == 1:
                        seconds = v3
                    elif f3 == 2:
                        nanos = v3
                return seconds + nanos / 1e9
    return None


# ---------------------------------------------------------------------------
# Jaeger api_v2 proto decoding (model.proto)
# ---------------------------------------------------------------------------


def _decode_jaeger_kv(buf: bytes):
    key, vtype = "", 0
    vstr, vbool, vint, vfloat, vbin = "", False, 0, 0.0, b""
    for field, wt, val in protowire.iter_fields(buf):
        if field == 1:
            key = val.decode("utf-8", "replace")
        elif field == 2:
            vtype = val
        elif field == 3:
            vstr = val.decode("utf-8", "replace")
        elif field == 4:
            vbool = bool(val)
        elif field == 5:
            vint = protowire.signed64(val)
        elif field == 6:
            vfloat = protowire.fixed64_to_double(val)
        elif field == 7:
            vbin = val
    value = {0: vstr, 1: vbool, 2: vint, 3: vfloat, 4: vbin.hex()}.get(vtype, vstr)
    return key, value


def _decode_ts(buf: bytes) -> int:
    """google.protobuf.Timestamp/Duration -> nanoseconds."""
    seconds = nanos = 0
    for field, wt, val in protowire.iter_fields(buf):
        if field == 1:
            seconds = protowire.signed64(val)
        elif field == 2:
            nanos = protowire.signed64(val)
    return seconds * 10**9 + nanos


def _decode_jaeger_span(buf: bytes) -> Span:
    trace_id = b"\x00" * 16
    span_id = b"\x00" * 8
    parent = b"\x00" * 8
    name = ""
    start_ns = dur_ns = 0
    attrs: dict = {}
    for field, wt, val in protowire.iter_fields(buf):
        if field == 1:
            trace_id = bytes(val).rjust(16, b"\x00")
        elif field == 2:
            span_id = bytes(val).rjust(8, b"\x00")
        elif field == 3:
            name = val.decode("utf-8", "replace")
        elif field == 4:  # SpanRef; CHILD_OF (ref_type 0) carries the parent
            ref_span, ref_type = b"", 0
            for f2, _, v2 in protowire.iter_fields(val):
                if f2 == 2:
                    ref_span = bytes(v2)
                elif f2 == 3:
                    ref_type = v2
            if ref_type == 0 and ref_span:
                parent = ref_span.rjust(8, b"\x00")
        elif field == 6:
            start_ns = _decode_ts(val)
        elif field == 7:
            dur_ns = _decode_ts(val)
        elif field == 8:
            k, v = _decode_jaeger_kv(val)
            attrs[k] = v
    kind = KIND_SERVER if attrs.get("span.kind") == "server" else KIND_CLIENT
    status = 2 if attrs.get("error") is True else 0
    return Span(
        trace_id=trace_id,
        span_id=span_id,
        parent_span_id=parent,
        name=name,
        start_unix_nano=start_ns,
        duration_nano=dur_ns,
        kind=kind,
        status_code=status,
        attributes=attrs,
    )


def decode_post_spans_request(buf: bytes) -> list[Trace]:
    """jaeger.api_v2.PostSpansRequest{batch: Batch} -> traces."""
    resource = {"service.name": ""}
    spans: list[Span] = []
    for field, wt, val in protowire.iter_fields(buf):
        if field != 1:  # batch
            continue
        for f2, _, v2 in protowire.iter_fields(val):
            if f2 == 1:  # process
                for f3, _, v3 in protowire.iter_fields(v2):
                    if f3 == 1:
                        resource["service.name"] = v3.decode("utf-8", "replace")
                    elif f3 == 2:
                        k, v = _decode_jaeger_kv(v3)
                        resource[k] = v
            elif f2 == 2:  # span
                spans.append(_decode_jaeger_span(v2))
    by_trace: dict[bytes, Trace] = {}
    for s in spans:
        t = by_trace.setdefault(s.trace_id, Trace(trace_id=s.trace_id))
        if not t.batches:
            t.batches.append((dict(resource), []))
        t.batches[0][1].append(s)
    return list(by_trace.values())


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class TraceGrpcServer:
    """OTLP + Jaeger gRPC ingest endpoint feeding push(traces, org_id)."""

    def __init__(self, push, host: str = "0.0.0.0", port: int = DEFAULT_GRPC_PORT,
                 max_workers: int = 8):
        try:
            import grpc
        except ImportError as e:  # grpcio is optional: the decoders above serve without it
            raise RuntimeError("grpcio unavailable; use the OTLP HTTP receiver") from e
        self._grpc = grpc
        self._push = push
        self.requests = 0
        self.spans = 0

        outer = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == OTLP_EXPORT_METHOD:
                    return grpc.unary_unary_rpc_method_handler(outer._export_otlp)
                if details.method == JAEGER_POST_SPANS_METHOD:
                    return grpc.unary_unary_rpc_method_handler(outer._post_spans)
                if details.method == OPENCENSUS_EXPORT_METHOD:
                    # OC agent Export is a bidirectional stream
                    return grpc.stream_stream_rpc_method_handler(outer._export_oc)
                return None

        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers,
                                       thread_name_prefix="grpc-ingest"),
            handlers=(_Handler(),),
        )
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise OSError(f"could not bind gRPC receiver to {host}:{port}")

    # -- handlers ------------------------------------------------------
    def _org_id(self, context):
        for k, v in context.invocation_metadata():
            if k.lower() in _ORG_ID_KEYS:
                return v
        return None

    def _ingest(self, traces, context):
        from tempo_tpu_torch.modules.distributor import RateLimited
        from tempo_tpu_torch.util import tracing
        from tempo_tpu_torch.util.resource import ResourceExhausted

        # trace-context extraction from gRPC metadata (reference: the
        # receiver shim's otelgrpc interceptor): the same W3C
        # traceparent key OTel gRPC clients send
        tp = None
        for k, v in context.invocation_metadata():
            if k.lower() == tracing.TRACEPARENT_HEADER:
                tp = v
                break
        n_spans = sum(t.span_count() for t in traces)
        try:
            with tracing.remote_context(tp):
                with tracing.span("grpc/export", spans=n_spans):
                    self._push(traces, org_id=self._org_id(context))
        except (RateLimited, ResourceExhausted) as e:
            # the gRPC analog of the HTTP 429 + Retry-After translation:
            # RESOURCE_EXHAUSTED with a RetryInfo detail in the standard
            # grpc-status-details-bin trailer (plus a plain-text
            # retry-delay-ms for clients without Status decoding)
            delay = max(0.001, getattr(e, "retry_after_s", 1.0))
            context.set_trailing_metadata((
                ("retry-delay-ms", str(int(delay * 1000))),
                ("grpc-status-details-bin",
                 encode_retry_status(GRPC_RESOURCE_EXHAUSTED, str(e), delay)),
            ))
            context.abort(self._grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except ValueError as e:
            # never-admissible request (e.g. one batch over the whole
            # inflight budget): the caller's error, not a server fault
            context.abort(self._grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except Exception as e:
            log.exception("grpc ingest failed")
            context.abort(self._grpc.StatusCode.INTERNAL, str(e))
        self.requests += 1
        self.spans += n_spans

    def _export_otlp(self, request: bytes, context) -> bytes:
        try:
            traces = otlp.decode_traces_request(request)
        except Exception as e:
            context.abort(self._grpc.StatusCode.INVALID_ARGUMENT, f"bad OTLP payload: {e}")
        self._ingest(traces, context)
        return b""  # ExportTraceServiceResponse{} (no partial_success)

    def _export_oc(self, request_iterator, context):
        """OpenCensus agent stream: each message is an
        ExportTraceServiceRequest; respond with one empty
        ExportTraceServiceResponse per message (reference: the shim's
        "opencensus" receiver factory, shim.go:110-133)."""
        from tempo_tpu_torch.receivers import opencensus

        for request in request_iterator:
            try:
                traces = opencensus.decode_export_request(request)
            except Exception as e:
                context.abort(self._grpc.StatusCode.INVALID_ARGUMENT, f"bad OC payload: {e}")
            if traces:
                self._ingest(traces, context)
            yield b""

    def _post_spans(self, request: bytes, context) -> bytes:
        try:
            traces = decode_post_spans_request(request)
        except Exception as e:
            context.abort(self._grpc.StatusCode.INVALID_ARGUMENT, f"bad Jaeger payload: {e}")
        self._ingest(traces, context)
        return b""  # PostSpansResponse{}

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "TraceGrpcServer":
        self.server.start()
        return self

    def stop(self, grace: float = 0.5) -> None:
        self.server.stop(grace)
