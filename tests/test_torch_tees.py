"""The port's ingest tees against the JAX package's: the forwarders, the
anonymous usage report and the self-tracing export.

Forwarders: both packages' App (the port on the CPU) forward the same
pushes of an opted-in tenant to loopback sinks, which must receive the
same OTLP bytes under the same headers, and nothing of a tenant that has
not opted in; a forwarder between two of the port's Apps over HTTP
delivers every trace whole. Usage report: the cluster seed is made once
and read back (by either package) under SEED_KEY, at the root of the
store; a report has the reference's keys, and a send reaches the sink.
Self-tracing: with `self_tracing` on, both Apps answer a `_self_` search
with traces of the same structure (span names and parent links; never
their bytes, which hold clocks and random IDs), and both honour
`sample_ratio` and `max_spans_per_s`. Tolerance is exact.
"""

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tempo_tpu import usagestats as jusage
from tempo_tpu.backend.local import LocalBackend as JLocalBackend
from tempo_tpu.modules.forwarder import ForwarderConfig as JForwarderConfig
from tempo_tpu.usagestats import UsageStatsConfig as JUsageStatsConfig
from tempo_tpu.util.tracing import SelfTracingConfig as JSelfTracingConfig
from tempo_tpu_torch import usagestats
from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.modules import forwarder
from tempo_tpu_torch.modules.forwarder import ForwarderConfig, ForwarderManager
from tempo_tpu_torch.modules.overrides import Limits, Overrides
from tempo_tpu_torch.usagestats import UsageStatsConfig
from tempo_tpu_torch.util.tracing import SELF_TENANT, SelfTracingConfig

from test_torch_app import PB, AppPair, otlp, qs, traces_of


class Sink:
    """A loopback HTTP sink recording every POST: (path, tenant, body)."""

    def __init__(self):
        sink = self
        self.posts: list = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                sink.posts.append((self.path, self.headers.get("X-Scope-OrgID"), body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def wait(self, n: int, timeout_s: float = 30.0) -> list:
        deadline = time.monotonic() + timeout_s
        while len(self.posts) < n:
            assert time.monotonic() < deadline, f"{len(self.posts)} of {n} posts"
            time.sleep(0.01)
        return self.posts

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def sinks():
    made = []

    def make():
        made.append(Sink())
        return made[-1]

    yield make
    for s in made:
        s.close()


def _overrides(path, tenants):
    path.write_text("overrides:\n" + "".join(
        f"  {t}:\n    forwarders: [{', '.join(names)}]\n" for t, names in tenants.items()))
    return str(path)


def test_forwarded_bytes_equal(tmp_path, sinks):
    """Pushes of tenants a (opted in to both forwarders), b (to one) and
    c (none) through both Apps: the sinks get the same OTLP bytes of a
    and b alike, none of c's."""
    jsinks, tsinks = (sinks(), sinks()), (sinks(), sinks())
    path = _overrides(tmp_path / "overrides.yaml", {"a": ["one", "two"], "b": ["two"]})
    pair = AppPair(
        tmp_path, multitenancy_enabled=True, overrides_path=path,
        jax_kw={"forwarders": [JForwarderConfig(name=n, endpoint=s.url)
                               for n, s in zip(("one", "two"), jsinks)]},
        port_kw={"forwarders": [ForwarderConfig(name=n, endpoint=s.url)
                                for n, s in zip(("one", "two"), tsinks)]})
    try:
        assert not pair.tapp.can_push_spans() and not pair.japp.can_push_spans()
        for i, org in enumerate("abcab"):
            body = otlp.encode_traces_request(traces_of(6, 3, seed=i))
            status, _ = pair.same("POST", "/v1/traces", body, dict(PB, **{"X-Scope-OrgID": org}))
            assert status == 200
        for j, t in zip(jsinks, tsinks):
            want = 2 if j is jsinks[0] else 4
            jp, tp = j.wait(want), t.wait(want)
            order = lambda p: (p[1], p[2])  # noqa: E731 — workers post in any order
            assert sorted(tp, key=order) == sorted(jp, key=order)
            assert {org for _, org, _ in tp} == ({"a"} if j is jsinks[0] else {"a", "b"})
            assert all(path == "/v1/traces" for path, _, _ in tp)
        time.sleep(0.2)
        assert len(tsinks[0].posts) == 2 and len(tsinks[1].posts) == 4  # c never forwarded
    finally:
        pair.close()


def test_forwarder_between_two_apps(tmp_path):
    """App A forwards tenant f's pushes to App B's /v1/traces: B finds
    every trace whole, as A does; tenant g stays on A."""
    b = App(AppConfig(multitenancy_enabled=True, db=DBConfig(
        backend="local", backend_path=str(tmp_path / "b" / "blocks"),
        wal_path=str(tmp_path / "b" / "wal"))), device="cpu")
    b_srv = TempoServer(b).start()
    a = App(AppConfig(multitenancy_enabled=True, db=DBConfig(
        backend="local", backend_path=str(tmp_path / "a" / "blocks"),
        wal_path=str(tmp_path / "a" / "wal")),
        forwarders=[ForwarderConfig(name="to-b", endpoint=b_srv.url)],
        overrides_path=_overrides(tmp_path / "o.yaml", {"f": ["to-b"]})), device="cpu")
    try:
        sent = {"f": traces_of(8, 4, seed=31), "g": traces_of(8, 4, seed=32)}
        for org, traces in sent.items():
            a.push_traces(traces, org_id=org)
        deadline = time.monotonic() + 30
        for t in sent["f"]:
            while (got := b.find_trace(t.trace_id, org_id="f")) is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            mine = a.find_trace(t.trace_id, org_id="f")
            assert got.span_count() == mine.span_count() == t.span_count()
            assert otlp.encode_traces_request([got]) == otlp.encode_traces_request([mine])
        assert all(b.find_trace(t.trace_id, org_id="g") is None for t in sent["g"])
    finally:
        a.shutdown()
        b_srv.stop()
        b.shutdown()


def test_forwarder_queue_drops_and_unknown_names():
    """A full queue drops and counts; a tenant naming an unknown
    forwarder is skipped; a failed send is counted and the worker goes
    on."""
    release = threading.Event()
    sent = []

    def send(tenant, traces):
        release.wait(10)
        if tenant == "boom":
            raise OSError("refused")
        sent.append((tenant, len(traces)))

    ov = Overrides(Limits())
    ov._per_tenant = {"t": Limits(forwarders=("q", "nope")), "boom": Limits(forwarders=("q",))}
    mgr = ForwarderManager([ForwarderConfig(name="q", queue_size=1)], ov, send_fn=send)
    drops0 = forwarder.forwarder_drops.value(name="q")
    fails0 = forwarder.forwarder_failures.value(name="q")
    try:
        mgr.send("boom", [1])
        time.sleep(0.1)  # the worker takes it and blocks in send
        mgr.send("t", [1, 2])  # queued
        mgr.send("t", [3])  # the queue is full: dropped
        assert forwarder.forwarder_drops.value(name="q") == drops0 + 1
        release.set()
        mgr.forwarders["q"].drain()
        deadline = time.monotonic() + 10
        while not sent:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert sent == [("t", 2)]
        assert forwarder.forwarder_failures.value(name="q") == fails0 + 1
    finally:
        release.set()
        mgr.stop()


# ---------------------------------------------------------------------------
# usage report
# ---------------------------------------------------------------------------


def test_cluster_seed_idempotent_and_shared(tmp_path):
    port, jax = LocalBackend(str(tmp_path / "p")), JLocalBackend(str(tmp_path / "p"))
    seed = usagestats.get_or_create_cluster_seed(port)
    assert usagestats.SEED_KEY == jusage.SEED_KEY == "tempo_cluster_seed.json"
    assert sorted(seed) == ["UID", "created_at"]
    assert (tmp_path / "p" / usagestats.SEED_KEY).is_file()  # at the root, beside tenants
    assert usagestats.get_or_create_cluster_seed(port) == seed
    assert jusage.get_or_create_cluster_seed(jax) == seed
    other = JLocalBackend(str(tmp_path / "j"))
    made = jusage.get_or_create_cluster_seed(other)
    assert usagestats.get_or_create_cluster_seed(LocalBackend(str(tmp_path / "j"))) == made


def test_report_keys_and_send_equal(tmp_path, sinks):
    reports = []
    for mod, backend, cfg_cls in ((jusage, JLocalBackend, JUsageStatsConfig),
                                  (usagestats, LocalBackend, UsageStatsConfig)):
        sink = sinks()
        rep = mod.Reporter(cfg_cls(enabled=True, endpoint=sink.url),
                           backend(str(tmp_path / mod.__name__)))
        rep.set_stat("feature_x", 3)
        rep.register_provider(lambda: {"storage_blocks": 7})
        rep.register_provider(lambda: 1 / 0)  # skipped, never fatal
        doc = rep.build_report(now=1234.5)
        assert rep.send_report() and sink.wait(1)
        (path, _, body), = sink.posts
        sent = json.loads(body)
        assert path == "/usage-stats" and sorted(sent) == sorted(doc)
        reports.append((sorted(doc), doc["interval"], doc["target"], doc["os"],
                        doc["timestamp"], doc["metrics"]["feature_x"],
                        doc["metrics"]["storage_blocks"]))
        assert not mod.Reporter(cfg_cls(enabled=False, endpoint=sink.url),
                                backend(str(tmp_path / "off"))).send_report()
    assert reports[0] == reports[1]


def test_usage_stats_route_equal(tmp_path):
    pair = AppPair(tmp_path, jax_kw={"usage_stats": JUsageStatsConfig(enabled=True)},
                   port_kw={"usage_stats": UsageStatsConfig(enabled=True)})
    try:
        (js, _, jb), (ts, _, tb) = pair.both("GET", "/status/usage-stats")
        jdoc, tdoc = json.loads(jb), json.loads(tb)
        assert js == ts == 200 and sorted(jdoc) == sorted(tdoc)
        assert tdoc["enabled"] is True and tdoc["target"] == jdoc["target"] == "all"
        seed = json.loads((tmp_path / "port" / "blocks" / usagestats.SEED_KEY).read_text())
        assert tdoc["clusterID"] == seed["UID"]
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# self-tracing
# ---------------------------------------------------------------------------


def _self_structure(pair, url_index: int) -> collections.Counter:
    """(parent span name, span name) of every span of the `_self_` traces
    holding a distributor/push span, on one server."""
    h = {"X-Scope-OrgID": SELF_TENANT}
    from test_torch_app import _request

    url = pair.servers[url_index].url
    status, _, body = _request(url, "GET", "/api/search"
                               + qs(tags="name=distributor/push", limit=1000), headers=h)
    assert status == 200
    edges = collections.Counter()
    for hit in json.loads(body)["traces"]:
        status, _, raw = _request(url, "GET", f"/api/traces/{hit['traceID']}",
                                  headers=dict(h, Accept="application/protobuf"))
        assert status == 200
        spans = [s for t in otlp.decode_traces_request(raw) for s in t.all_spans()]
        names = {s.span_id: s.name for s in spans}
        edges.update((names.get(s.parent_span_id, ""), s.name) for s in spans)
    return edges


def test_self_tracing_structure_equal(tmp_path):
    pair = AppPair(tmp_path, jax_kw={"self_tracing": JSelfTracingConfig(enabled=True)},
                   port_kw={"self_tracing": SelfTracingConfig(enabled=True)})
    try:
        for i in range(3):
            body = otlp.encode_traces_request(traces_of(8, 3, seed=40 + i))
            assert pair.same("POST", "/v1/traces", body, PB)[0] == 200
        edges = []
        for i in (0, 1):
            # a request's self-trace is exported when its root span ends,
            # which may be after the response reached this client
            deadline = time.monotonic() + 30
            while (e := _self_structure(pair, i))[("http/POST /v1/traces",
                                                   "distributor/push")] < 3:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            edges.append(e)
        assert edges[0] == edges[1]
        assert edges[1][("http/POST /v1/traces", "distributor/push")] == 3
    finally:
        pair.close()


@pytest.mark.parametrize("knobs", [{"sample_ratio": 0.0},
                                   {"max_spans_per_s": 1.0, "burst_spans": 2.0}])
def test_self_tracing_sampling_and_rate_bound(tmp_path, knobs):
    """sample_ratio 0 exports nothing; a bound of 2 spans of burst and 1
    a second exports at most one request's trace, in both packages."""
    pair = AppPair(tmp_path, jax_kw={"self_tracing": JSelfTracingConfig(enabled=True, **knobs)},
                   port_kw={"self_tracing": SelfTracingConfig(enabled=True, **knobs)})
    try:
        exporters = (pair.japp._self_exporter, pair.tapp._self_exporter)

        def read(exp):  # the counters are process-wide: compare deltas
            return (exp.exported_total.value(), exp.dropped_total.value(reason="sampled"),
                    exp.dropped_total.value(reason="rate_limited"))

        before = [read(exp) for exp in exporters]
        for i in range(4):
            body = otlp.encode_traces_request(traces_of(4, 3, seed=50 + i))
            assert pair.same("POST", "/v1/traces", body, PB)[0] == 200
        counts = [tuple(a - b > 0 for a, b in zip(read(exp), b0))
                  for exp, b0 in zip(exporters, before)]
        assert counts[0] == counts[1]
        assert counts[1] == ((False, True, False) if "sample_ratio" in knobs
                             else (False, False, True))
    finally:
        pair.close()
