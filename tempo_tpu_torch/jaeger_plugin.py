"""Port of tempo_tpu/jaeger_plugin.py, copied as is (host code).

Jaeger gRPC storage-plugin server — the protocol a stock Jaeger
query service speaks to a `grpc-plugin` storage backend.

Reference: cmd/tempo-query/tempo/plugin.go:45 implements the plugin's
Backend over Tempo HTTP; here the same seams (find-by-id, search, tag
values via JaegerQueryBridge/App) serve the actual gRPC services
(jaeger/storage_v1 grpc_storage.proto):

  jaeger.storage.v1.SpanReaderPlugin
      GetTrace(GetTraceRequest)        -> stream SpansResponseChunk
      GetServices(GetServicesRequest)  -> GetServicesResponse
      GetOperations(GetOperationsRequest) -> GetOperationsResponse
      FindTraces(FindTracesRequest)    -> stream SpansResponseChunk
      FindTraceIDs(FindTraceIDsRequest)-> FindTraceIDsResponse
  jaeger.storage.v1.DependenciesReaderPlugin.GetDependencies
  jaeger.storage.v1.PluginCapabilities.Capabilities

Messages are hand-rolled protobuf over receivers/protowire (like every
other wire codec in this repo); spans go out in the jaeger.api_v2 model
(model.proto): Span{trace_id, span_id, operation_name, references,
start_time Timestamp, duration Duration, tags KeyValue, process}.
"""

from __future__ import annotations

import logging
from concurrent import futures

from tempo_tpu_torch.model.trace import (
    KIND_CLIENT,
    KIND_CONSUMER,
    KIND_PRODUCER,
    KIND_SERVER,
    STATUS_ERROR,
    Trace,
)
from tempo_tpu_torch.receivers.protowire import (
    iter_fields,
    put_bytes_field,
    put_double_field,
    put_str_field,
    put_varint_field,
    read_varint,
    signed64,
)

log = logging.getLogger(__name__)

SVC = "jaeger.storage.v1"
GET_TRACE = f"/{SVC}.SpanReaderPlugin/GetTrace"
GET_SERVICES = f"/{SVC}.SpanReaderPlugin/GetServices"
GET_OPERATIONS = f"/{SVC}.SpanReaderPlugin/GetOperations"
FIND_TRACES = f"/{SVC}.SpanReaderPlugin/FindTraces"
FIND_TRACE_IDS = f"/{SVC}.SpanReaderPlugin/FindTraceIDs"
GET_DEPENDENCIES = f"/{SVC}.DependenciesReaderPlugin/GetDependencies"
CAPABILITIES = f"/{SVC}.PluginCapabilities/Capabilities"

_KIND_NAMES = {
    KIND_SERVER: "server",
    KIND_CLIENT: "client",
    KIND_PRODUCER: "producer",
    KIND_CONSUMER: "consumer",
}


# ---------------------------------------------------------------------------
# api_v2 model encoding
# ---------------------------------------------------------------------------


def _ts(out: bytearray, field: int, nanos: int) -> None:
    """google.protobuf.Timestamp/Duration submessage {1: s, 2: ns}."""
    msg = bytearray()
    s, ns = divmod(int(nanos), 1_000_000_000)
    if s:
        put_varint_field(msg, 1, s)
    if ns:
        put_varint_field(msg, 2, ns)
    put_bytes_field(out, field, bytes(msg))


def _kv(key: str, value) -> bytes:
    """jaeger.api_v2.KeyValue (STRING=0 BOOL=1 INT64=2 FLOAT64=3)."""
    msg = bytearray()
    put_str_field(msg, 1, key)
    if isinstance(value, bool):
        put_varint_field(msg, 2, 1)
        put_varint_field(msg, 4, 1 if value else 0)
    elif isinstance(value, int):
        put_varint_field(msg, 2, 2)
        put_varint_field(msg, 5, value & (2**64 - 1))
    elif isinstance(value, float):
        put_varint_field(msg, 2, 3)
        put_double_field(msg, 6, value)
    else:
        put_str_field(msg, 3, str(value))
    return bytes(msg)


def encode_api_v2_spans(trace: Trace) -> list[bytes]:
    """One model Trace -> encoded jaeger.api_v2.Span messages."""
    out: list[bytes] = []
    for resource, spans in trace.batches:
        proc = bytearray()
        put_str_field(proc, 1, str(resource.get("service.name", "")))
        for k, v in sorted(resource.items()):
            if k != "service.name":
                put_bytes_field(proc, 2, _kv(k, v))
        proc_bytes = bytes(proc)
        for s in spans:
            msg = bytearray()
            put_bytes_field(msg, 1, trace.trace_id)
            put_bytes_field(msg, 2, s.span_id)
            put_str_field(msg, 3, s.name)
            if s.parent_span_id and s.parent_span_id != b"\x00" * 8:
                ref = bytearray()
                put_bytes_field(ref, 1, trace.trace_id)
                put_bytes_field(ref, 2, s.parent_span_id)
                # ref_type CHILD_OF = 0 (default, omitted)
                put_bytes_field(msg, 4, bytes(ref))
            _ts(msg, 6, s.start_unix_nano)
            _ts(msg, 7, s.duration_nano)
            for k, v in sorted(s.attributes.items()):
                put_bytes_field(msg, 8, _kv(k, v))
            kind = _KIND_NAMES.get(s.kind)
            if kind:
                put_bytes_field(msg, 8, _kv("span.kind", kind))
            if s.status_code == STATUS_ERROR:
                put_bytes_field(msg, 8, _kv("error", True))
            put_bytes_field(msg, 10, proc_bytes)
            out.append(bytes(msg))
    return out


def _chunk(spans: list[bytes]) -> bytes:
    """SpansResponseChunk{1: repeated Span}."""
    msg = bytearray()
    for sp in spans:
        put_bytes_field(msg, 1, sp)
    return bytes(msg)


# ---------------------------------------------------------------------------
# request decoding
# ---------------------------------------------------------------------------


def _decode_submsg_ts(buf: bytes) -> int:
    """Timestamp/Duration -> nanos."""
    s = ns = 0
    for field, wt, val in iter_fields(buf):
        if field == 1 and wt == 0:
            s = signed64(val)
        elif field == 2 and wt == 0:
            ns = signed64(val)
    return s * 1_000_000_000 + ns


def decode_trace_query(buf: bytes) -> dict:
    """TraceQueryParameters -> the JaegerQueryBridge params dict."""
    params: dict = {}
    tags: dict = {}
    for field, wt, val in iter_fields(buf):
        if field == 1 and wt == 2:
            params["service"] = val.decode("utf-8", "replace")
        elif field == 2 and wt == 2:
            params["operation"] = val.decode("utf-8", "replace")
        elif field == 3 and wt == 2:
            k = v = ""
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1 and w2 == 2:
                    k = v2.decode("utf-8", "replace")
                elif f2 == 2 and w2 == 2:
                    v = v2.decode("utf-8", "replace")
            if k:
                tags[k] = v
        elif field == 4 and wt == 2:
            params["start"] = str(_decode_submsg_ts(val) // 1000)
        elif field == 5 and wt == 2:
            params["end"] = str(_decode_submsg_ts(val) // 1000)
        elif field == 6 and wt == 2:
            params["minDuration"] = f"{_decode_submsg_ts(val)}ns"
        elif field == 7 and wt == 2:
            params["maxDuration"] = f"{_decode_submsg_ts(val)}ns"
        elif field == 8 and wt == 0:
            params["limit"] = str(signed64(val))
    if tags:
        import json

        params["tags"] = json.dumps(tags)
    return params


def _first_bytes_field(buf: bytes, want: int) -> bytes:
    for field, wt, val in iter_fields(buf):
        if field == want and wt == 2:
            return val
    return b""


# ---------------------------------------------------------------------------
# the gRPC server
# ---------------------------------------------------------------------------


class JaegerStoragePluginServer:
    """Serves the storage-plugin services over grpcio generic handlers
    (same pattern as receivers/grpc_server.py), backed by a
    JaegerQueryBridge. A stock Jaeger query deployment configured with
    SPAN_STORAGE_TYPE=grpc-plugin points straight at this port."""

    def __init__(self, bridge, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 4):
        import grpc

        self._grpc = grpc
        self.bridge = bridge
        self.requests = 0
        outer = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, details):
                m = details.method
                if m == GET_TRACE:
                    return grpc.unary_stream_rpc_method_handler(outer._get_trace)
                if m == GET_SERVICES:
                    return grpc.unary_unary_rpc_method_handler(outer._get_services)
                if m == GET_OPERATIONS:
                    return grpc.unary_unary_rpc_method_handler(outer._get_operations)
                if m == FIND_TRACES:
                    return grpc.unary_stream_rpc_method_handler(outer._find_traces)
                if m == FIND_TRACE_IDS:
                    return grpc.unary_unary_rpc_method_handler(outer._find_trace_ids)
                if m == GET_DEPENDENCIES:
                    return grpc.unary_unary_rpc_method_handler(outer._get_dependencies)
                if m == CAPABILITIES:
                    return grpc.unary_unary_rpc_method_handler(outer._capabilities)
                return None

        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers,
                                       thread_name_prefix="jaeger-plugin"),
            handlers=(_Handler(),),
        )
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise OSError(f"could not bind jaeger plugin to {host}:{port}")

    # -- handlers ------------------------------------------------------
    def _trace_for(self, tid: bytes) -> Trace | None:
        tid_hex = tid.hex().rjust(32, "0")
        app = self.bridge.app
        return app.find_trace(bytes.fromhex(tid_hex), org_id=self.bridge.tenant)

    def _get_trace(self, request: bytes, context):
        self.requests += 1
        tid = _first_bytes_field(request, 1)
        trace = self._trace_for(tid) if tid else None
        if trace is None:
            context.abort(self._grpc.StatusCode.NOT_FOUND, "trace not found")
            return
        yield _chunk(encode_api_v2_spans(trace))

    def _get_services(self, request: bytes, context) -> bytes:
        self.requests += 1
        msg = bytearray()
        for s in self.bridge.get_services():
            put_str_field(msg, 1, s)
        return bytes(msg)

    def _get_operations(self, request: bytes, context) -> bytes:
        self.requests += 1
        service = _first_bytes_field(request, 1).decode("utf-8", "replace")
        msg = bytearray()
        for name in self.bridge.get_operations(service):
            put_str_field(msg, 1, name)  # deprecated operationNames
            op = bytearray()
            put_str_field(op, 1, name)
            put_bytes_field(msg, 2, bytes(op))  # Operation{name}
        return bytes(msg)

    def _find(self, request: bytes):
        q = _first_bytes_field(request, 1)
        params = decode_trace_query(q) if q else {}
        return self.bridge.find_traces_model(params)

    def _find_traces(self, request: bytes, context):
        self.requests += 1
        for trace in self._find(request):
            yield _chunk(encode_api_v2_spans(trace))

    def _find_trace_ids(self, request: bytes, context) -> bytes:
        self.requests += 1
        msg = bytearray()
        for trace in self._find(request):
            put_bytes_field(msg, 1, trace.trace_id)
        return bytes(msg)

    def _get_dependencies(self, request: bytes, context) -> bytes:
        self.requests += 1
        return b""  # GetDependenciesResponse{} — no dependency store

    def _capabilities(self, request: bytes, context) -> bytes:
        self.requests += 1
        return b""  # reader-only: all archive/streaming flags false

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "JaegerStoragePluginServer":
        self.server.start()
        return self

    def stop(self, grace: float = 0.5) -> None:
        self.server.stop(grace)


def read_varint_prefixed(buf: bytes):  # pragma: no cover - debugging aid
    pos = 0
    while pos < len(buf):
        n, pos = read_varint(buf, pos)
        yield buf[pos : pos + n]
        pos += n
