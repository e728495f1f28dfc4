"""The port's gRPC receiver against the JAX package's, over grpcio.

Both packages' App (the port on the CPU, multitenancy on) sit behind
their own TraceGrpcServer on an ephemeral port, and take the same OTLP
Export, Jaeger PostSpans and OpenCensus Export (a stream) payloads, the
tenant in the X-Scope-OrgID metadata. Each export lands and is found in
both Apps alike (span for span, through the OTLP JSON form); a payload
that does not decode is INVALID_ARGUMENT, an unknown method
UNIMPLEMENTED, a missing tenant INTERNAL and a rate-limited push
RESOURCE_EXHAUSTED with the reference's retry trailers, in both.
Tolerance is exact. grpcio is optional: without it these tests skip.
"""

import json

import pytest

grpc = pytest.importorskip("grpc")

import chip_smoke  # noqa: E402
from tempo_tpu.app import App as JApp, AppConfig as JAppConfig  # noqa: E402
from tempo_tpu.db import DBConfig as JDBConfig  # noqa: E402
from tempo_tpu.modules.distributor import RateLimited as JRateLimited  # noqa: E402
from tempo_tpu.receivers import grpc_server as jgrpc  # noqa: E402
from tempo_tpu_torch.app import App, AppConfig  # noqa: E402
from tempo_tpu_torch.db import DBConfig  # noqa: E402
from tempo_tpu_torch.model import synth  # noqa: E402
from tempo_tpu_torch.model.trace import batch_to_traces  # noqa: E402
from tempo_tpu_torch.modules.distributor import RateLimited  # noqa: E402
from tempo_tpu_torch.receivers import grpc_server, otlp  # noqa: E402

T0 = 1_700_000_000


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """((JAX App, its server, a channel), (the port's ...))."""
    root = tmp_path_factory.mktemp("grpc")
    out = []
    for name, app_cls, cfg_cls, db_cls, srv_cls, kw in (
            ("jax", JApp, JAppConfig, JDBConfig, jgrpc.TraceGrpcServer, {}),
            ("port", App, AppConfig, DBConfig, grpc_server.TraceGrpcServer, {"device": "cpu"})):
        app = app_cls(cfg_cls(multitenancy_enabled=True, db=db_cls(
            backend="local", backend_path=str(root / name / "b"),
            wal_path=str(root / name / "w"))), **kw)
        srv = srv_cls(app.push_traces, host="127.0.0.1", port=0).start()
        out.append((app, srv, grpc.insecure_channel(f"127.0.0.1:{srv.port}")))
    yield out
    for app, srv, chan in out:
        chan.close()
        srv.stop()
        app.shutdown()


def _traces(seed):
    return batch_to_traces(synth.make_graph_batch(6, 4, seed=seed, base_time_ns=T0 * 10**9))


def _norm(trace) -> list:
    """A found trace's spans in the OTLP JSON form, sorted."""
    doc = otlp.encode_traces_json([trace])
    return sorted(json.dumps([rs["resource"], sp], sort_keys=True)
                  for rs in doc["resourceSpans"] for ss in rs["scopeSpans"] for sp in ss["spans"])


def _send(chan, carrier, traces, metadata=()):
    if carrier == "otlp":
        return [chan.unary_unary(grpc_server.OTLP_EXPORT_METHOD)(
            otlp.encode_traces_request(traces), metadata=metadata)]
    groups = chip_smoke._resource_groups(traces)
    if carrier == "jaeger":
        return [chan.unary_unary(grpc_server.JAEGER_POST_SPANS_METHOD)(
            chip_smoke.jaeger_post_spans(res, spans), metadata=metadata) for res, spans in groups]
    return list(chan.stream_stream(grpc_server.OPENCENSUS_EXPORT_METHOD)(
        iter([chip_smoke.opencensus_export(res, spans) for res, spans in groups]),
        metadata=metadata))


@pytest.mark.parametrize("carrier,seed", [("otlp", 1), ("jaeger", 2), ("opencensus", 3)])
def test_export_lands_and_is_queryable(pair, carrier, seed):
    traces = _traces(seed)
    found = []
    for app, srv, chan in pair:
        before = (srv.requests, srv.spans)
        replies = _send(chan, carrier, traces, (("x-scope-orgid", "acme"),))
        assert all(r == b"" for r in replies) and replies
        assert srv.spans - before[1] == sum(t.span_count() for t in traces)
        got = [app.find_trace(t.trace_id, org_id="acme") for t in traces]
        assert all(g is not None and g.span_count() == t.span_count()
                   for g, t in zip(got, traces))
        found.append(([_norm(g) for g in got], srv.requests - before[0]))
    assert found[0] == found[1]


def test_org_id_metadata_routes_tenant(pair):
    traces = _traces(4)
    for app, _, chan in pair:
        _send(chan, "otlp", traces, (("x-scope-orgid", "tenant-b"),))
        tid = traces[0].trace_id
        assert app.find_trace(tid, org_id="tenant-b") is not None
        assert app.find_trace(tid, org_id="acme") is None


@pytest.mark.parametrize("carrier", ["otlp", "jaeger", "opencensus"])
def test_bad_payload_invalid_argument(pair, carrier):
    codes = []
    for _, _, chan in pair:
        with pytest.raises(grpc.RpcError) as ei:
            if carrier == "otlp":
                chan.unary_unary(grpc_server.OTLP_EXPORT_METHOD)(b"\xff\xff\xff not proto")
            elif carrier == "jaeger":
                chan.unary_unary(grpc_server.JAEGER_POST_SPANS_METHOD)(b"\x0a\x05ab")
            else:
                list(chan.stream_stream(grpc_server.OPENCENSUS_EXPORT_METHOD)(
                    iter([b"\x12\x09\xff"])))
        codes.append(ei.value.code())
    assert codes == [grpc.StatusCode.INVALID_ARGUMENT] * 2


def test_unknown_method_and_missing_tenant(pair):
    for _, _, chan in pair:
        with pytest.raises(grpc.RpcError) as ei:
            chan.unary_unary("/no.such.Service/Method")(b"")
        assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
        # multitenancy on: an export without X-Scope-OrgID is refused
        with pytest.raises(grpc.RpcError) as ei:
            _send(chan, "otlp", _traces(5))
        assert ei.value.code() == grpc.StatusCode.INTERNAL


def test_rate_limited_resource_exhausted():
    answers = []
    for srv_cls, exc in ((jgrpc.TraceGrpcServer, JRateLimited),
                         (grpc_server.TraceGrpcServer, RateLimited)):
        def push(traces, org_id=None, exc=exc):
            raise exc("tenant over its ingestion rate", retry_after_s=2.5)

        srv = srv_cls(push, host="127.0.0.1", port=0).start()
        chan = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
        try:
            with pytest.raises(grpc.RpcError) as ei:
                _send(chan, "otlp", _traces(6))
            trailers = dict(ei.value.trailing_metadata())
            answers.append((ei.value.code(), ei.value.details(), trailers["retry-delay-ms"],
                            grpc_server.decode_retry_info_delay(
                                trailers["grpc-status-details-bin"])))
        finally:
            chan.close()
            srv.stop()
    assert answers[0] == answers[1] == (grpc.StatusCode.RESOURCE_EXHAUSTED,
                                        "tenant over its ingestion rate", "2500", 2.5)
