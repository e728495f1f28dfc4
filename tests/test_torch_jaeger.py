"""The port's Jaeger query bridge (HTTP) and gRPC storage plugin against
the JAX package's.

The same traces (from a seed) are pushed into a port App on the CPU and
a JAX-package App; the bridge's calls, the HTTP server's bodies and the
plugin's gRPC responses (raw protobuf bytes) must be equal, and the
conversion of one trace to Jaeger JSON field for field."""

import json

import pytest

from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu.jaeger_query import (
    JaegerQueryBridge as JBridge,
    JaegerQueryServer as JServer,
    trace_to_jaeger as jtrace_to_jaeger,
)
from tempo_tpu.model import synth as jsynth
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.backend.httpclient import PooledHTTPClient
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.jaeger_query import JaegerQueryBridge, JaegerQueryServer, trace_to_jaeger
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.receivers.protowire import iter_fields, put_bytes_field, put_str_field


@pytest.fixture
def apps(tmp_path):
    """(port App, reference App), both fed the same 12 traces."""
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=str(tmp_path / "p" / "blocks"),
                                    wal_path=str(tmp_path / "p" / "wal")),
                        generator_enabled=False), device="cpu")
    japp = JApp(JAppConfig(db=JDBConfig(backend="local",
                                        backend_path=str(tmp_path / "j" / "blocks"),
                                        wal_path=str(tmp_path / "j" / "wal"),
                                        compaction_device_shards=1),
                           generator_enabled=False))
    traces = synth.make_traces(12, seed=6)
    app.push_traces(traces)
    japp.push_traces(jsynth.make_traces(12, seed=6))
    yield app, japp, traces
    app.shutdown()
    japp.shutdown()


@pytest.mark.parametrize("seed,n_spans", [(3, 8), (4, 6), (5, 30)])
def test_trace_to_jaeger_equal(seed, n_spans):
    t = synth.make_trace(seed=seed, n_spans=n_spans)
    doc = trace_to_jaeger(t)
    assert doc == jtrace_to_jaeger(jsynth.make_trace(seed=seed, n_spans=n_spans))
    assert len(doc["spans"]) == n_spans and doc["traceID"] == t.trace_id.hex()
    roots = [s for s in doc["spans"] if not s["references"]]
    assert len(roots) == 1 and all(s["processID"] in doc["processes"] for s in doc["spans"])


def test_bridge_calls_equal(apps):
    app, japp, traces = apps
    b, jb = JaegerQueryBridge(app), JBridge(japp)
    assert b.get_services() == jb.get_services()
    assert {r["service.name"] for t in traces for r, _ in t.batches} <= set(b.get_services())
    assert b.get_operations("any") == jb.get_operations("any")
    for t in traces[::3]:
        doc = b.get_trace(t.trace_id.hex())
        assert doc == jb.get_trace(t.trace_id.hex())
        assert len(doc["spans"]) == t.span_count()
    assert b.get_trace("deadbeef" * 4) is None is jb.get_trace("deadbeef" * 4)
    svc = traces[3].batches[0][0]["service.name"]
    for params in ({"service": svc, "limit": "50"}, {"service": svc, "limit": "2"},
                   {"tags": json.dumps({"http.method": "GET"}), "limit": "5"},
                   {"minDuration": "1ms", "limit": "20"}):
        hits = b.find_traces(params)
        assert hits == jb.find_traces(params)
    assert traces[3].trace_id.hex() in {h["traceID"] for h in b.find_traces({"service": svc})}


def test_http_bodies_equal(apps):
    app, japp, traces = apps
    svc = traces[1].batches[0][0]["service.name"]
    paths = ["/api/services", f"/api/services/{svc}/operations",
             f"/api/traces/{traces[0].trace_id.hex()}",
             f"/api/traces?service={svc}&limit=50",
             "/api/traces/ffffffffffffffffffffffffffffffff", "/api/nothing",
             "/api/traces?limit=x"]
    answers = []
    for server in (JaegerQueryServer(JaegerQueryBridge(app)), JServer(JBridge(japp))):
        server.start()
        try:
            c = PooledHTTPClient(server.url, max_retries=0)
            answers.append([(lambda r: (r[0], json.loads(r[1])))(
                c.request("GET", p, ok=(200, 400, 404, 500))) for p in paths])
        finally:
            server.stop()
    assert answers[0] == answers[1]
    assert [s for s, _ in answers[0]][:5] == [200, 200, 200, 200, 404]


def _call(channel, method, request, stream=False):
    ident = lambda b: b  # noqa: E731 — raw bytes on the wire
    if stream:
        return list(channel.unary_stream(method, request_serializer=ident,
                                         response_deserializer=ident)(request, timeout=30))
    return channel.unary_unary(method, request_serializer=ident,
                               response_deserializer=ident)(request, timeout=30)


def test_grpc_plugin_bytes_equal(apps):
    """Every plugin method answers the same protobuf bytes in both
    packages: GetServices, GetOperations, GetTrace (and NOT_FOUND),
    FindTraces, FindTraceIDs, GetDependencies, Capabilities."""
    grpc = pytest.importorskip("grpc")
    from tempo_tpu.jaeger_plugin import JaegerStoragePluginServer as JPlugin
    from tempo_tpu_torch import jaeger_plugin as jp

    app, japp, traces = apps
    t0 = traces[0]
    get = bytearray()
    put_bytes_field(get, 1, t0.trace_id)
    missing = bytearray()
    put_bytes_field(missing, 1, b"\xde\xad" * 8)
    q = bytearray()
    put_str_field(q, 1, t0.batches[0][0]["service.name"])
    find = bytearray()
    put_bytes_field(find, 1, bytes(q))
    answers = []
    for srv in (jp.JaegerStoragePluginServer(JaegerQueryBridge(app)), JPlugin(JBridge(japp))):
        srv.start()
        ch = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
        try:
            got = [_call(ch, jp.GET_SERVICES, b""), _call(ch, jp.GET_OPERATIONS, b""),
                   _call(ch, jp.GET_TRACE, bytes(get), stream=True),
                   _call(ch, jp.FIND_TRACES, bytes(find), stream=True),
                   _call(ch, jp.FIND_TRACE_IDS, bytes(find)),
                   _call(ch, jp.GET_DEPENDENCIES, b""), _call(ch, jp.CAPABILITIES, b"")]
            with pytest.raises(grpc.RpcError) as e:
                _call(ch, jp.GET_TRACE, bytes(missing), stream=True)
            got.append(e.value.code())
            got.append(srv.requests)
            answers.append(got)
        finally:
            ch.close()
            srv.stop()
    assert answers[0] == answers[1]
    services, _, chunks, found, ids, deps, caps, code, n = answers[0]
    spans = [c for chunk in chunks for f, w, c in iter_fields(chunk) if f == 1 and w == 2]
    assert len(spans) == t0.span_count()
    assert t0.trace_id in [c for f, w, c in iter_fields(ids) if f == 1 and w == 2]
    assert code == grpc.StatusCode.NOT_FOUND and deps == caps == b"" and n == 8
