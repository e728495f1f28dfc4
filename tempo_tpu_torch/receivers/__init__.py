"""Multi-protocol span receivers — port of tempo_tpu/receivers/__init__.py.

Each protocol has a pure codec (otlp, zipkin, jaeger, opencensus) and
this shim maps an HTTP request (path + content type + body) to decoded
Traces for Distributor.push_traces. OTLP also has a columnar fast path
straight into a SpanBatch; Zipkin and Jaeger thrift take the object
path. The gRPC, Jaeger agent UDP and Kafka transports are
grpc_server, udp and kafka.
"""

from __future__ import annotations

import gzip
import json
import zlib

from tempo_tpu_torch.model.trace import Trace
from tempo_tpu_torch.receivers import jaeger, otlp, zipkin
from tempo_tpu_torch.util import metrics

# paths, mirroring the default receiver endpoints
OTLP_HTTP_PATH = "/v1/traces"
ZIPKIN_PATH = "/api/v2/spans"
ZIPKIN_V1_PATH = "/api/v1/spans"  # legacy thrift carrier
JAEGER_THRIFT_PATH = "/api/traces"

spans_decoded_total = metrics.counter(
    "tempo_tpu_ingest_spans_decoded_total",
    "Spans decoded at the receiver boundary, by decode path "
    "(columnar = straight to SpanBatch, object = via Trace objects)",
)


class UnsupportedPayload(ValueError):
    pass


def decompress_body(body: bytes, content_encoding: str) -> bytes:
    enc = (content_encoding or "").lower()
    if enc in ("", "identity"):
        return body
    if enc == "gzip":
        return gzip.decompress(body)
    if enc == "deflate":
        return zlib.decompress(body)
    raise UnsupportedPayload(f"unsupported content-encoding {content_encoding!r}")


def decode_http_columnar(path: str, content_type: str, body: bytes):
    """Columnar fast path: decode an ingest HTTP request straight into a
    SpanBatch, or return None when the protocol only has an object codec
    (zipkin/jaeger) — the caller then runs decode_http unchanged."""
    ct = (content_type or "").split(";")[0].strip().lower()
    if path != OTLP_HTTP_PATH:
        return None
    if ct == "application/json":
        batch = otlp.decode_traces_json_columnar(json.loads(body or b"{}"))
    else:
        batch = otlp.decode_traces_request_columnar(body)
    if batch.num_spans:
        spans_decoded_total.inc(batch.num_spans, path="columnar")
    return batch


def decode_http(path: str, content_type: str, body: bytes) -> list[Trace]:
    """Decode an ingest HTTP request into Traces, selecting the codec by
    path + content type."""
    traces = _decode_http_object(path, content_type, body)
    n = sum(t.span_count() for t in traces)
    if n:
        spans_decoded_total.inc(n, path="object")
    return traces


def _decode_http_object(path: str, content_type: str, body: bytes) -> list[Trace]:
    ct = (content_type or "").split(";")[0].strip().lower()
    if path == OTLP_HTTP_PATH:
        if ct == "application/json":
            return otlp.decode_traces_json(json.loads(body or b"{}"))
        return otlp.decode_traces_request(body)
    if path == ZIPKIN_PATH:
        if ct in ("application/x-thrift", "application/vnd.apache.thrift.binary"):
            return zipkin.decode_spans_thrift(body)
        return zipkin.decode_spans_json(json.loads(body or b"[]"))
    if path == ZIPKIN_V1_PATH:
        if ct in ("application/x-thrift", "application/vnd.apache.thrift.binary"):
            return zipkin.decode_spans_thrift(body)
        raise UnsupportedPayload("zipkin v1 supports only the thrift carrier here")
    if path == JAEGER_THRIFT_PATH:
        return jaeger.decode_batch(body)
    raise UnsupportedPayload(f"no receiver for path {path!r}")


__all__ = [
    "OTLP_HTTP_PATH",
    "ZIPKIN_PATH",
    "ZIPKIN_V1_PATH",
    "JAEGER_THRIFT_PATH",
    "UnsupportedPayload",
    "decode_http",
    "decode_http_columnar",
    "decompress_body",
    "jaeger",
    "otlp",
    "zipkin",
]
