"""Microservices mode of the port against the JAX package's, over HTTP.

Reference pattern: tests/test_microservices.py (itself the upstream e2e
TestMicroservicesWithKVStores): 3 ingesters at replication factor 2, a
distributor, a query-frontend and a querier, each a real App behind its
own TempoServer on an ephemeral port, the ring shared through a FileKV;
one ingester is killed and reads go on through the replicas.

Here the same cluster is built from each package (the port's Apps on
device="cpu") over its own directory, both take the same OTLP bodies,
and every answer is compared: trace by ID (spans as a set), tag search
(field by field, wall clock aside), query_range (matrices), before and
after ingester-1 dies. The wire is compared byte for byte: every segment
the distributor POSTs to /rpc/v1/ingester/push and every
/rpc/v1/ingester/live payload. A mixed cluster (the JAX package's
distributor and frontend, the port's ingesters and querier) answers as
the JAX cluster does. Every job kind's execute_job result of the port
survives json.dumps/json.loads unchanged, as RemoteWorker ships it.

Both packages' storage engines are pinned to one device
(compaction_device_shards=1) with ReadAhead prefetch off, one query
worker and no hedged jobs, so every answer reads the same bytes on every
run; gzip's header clock is pinned (a segment's dictionary is gzipped),
and the ingesters cut nothing on their own (idle period and flush check
an hour), so a read sees the same live traces whenever it runs. The
frontend's long-poll is cut to 0.5 s so that teardown does not wait out
a 10-s pull.
"""

import gzip
import json
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import pytest

from tempo_tpu.api.server import TempoServer as JTempoServer
from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.app import RoleUnavailable as JRoleUnavailable
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.modules.frontend import FrontendConfig as JFrontendConfig
from tempo_tpu.modules.ingester import IngesterConfig as JIngesterConfig
from tempo_tpu.util import pipeline as jpipeline
from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.app import App, AppConfig, RoleUnavailable
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.trace import batch_to_traces
from tempo_tpu_torch.modules import worker as tworker
from tempo_tpu_torch.modules.frontend import FrontendConfig
from tempo_tpu_torch.modules.ingester import IngesterConfig
from tempo_tpu_torch.receivers import otlp
from tempo_tpu_torch.util import pipeline

from test_torch_app import norm_query, norm_trace_pb, qs
from test_torch_search import chain_parents

TENANT = "single-tenant"
# live data: query_range reads the ingesters only for a window that
# reaches into the last hour, so the spans are stamped minutes before now
NOW_MIN = int(time.time()) // 60 * 60
T_DATA = NOW_MIN - 20 * 60
PB = {"Content-Type": "application/x-protobuf"}
SEARCHES = [
    {"tags": "service.name=cart", "limit": 100},
    {"tags": "service.name=cart name=cache.get", "limit": 100},
    {"tags": "http.status_code=500", "limit": 100},
    {"tags": "region=v7"},
    {"tags": "service.name=nope"},
]
QUERY_RANGES = [
    "{ } | rate() by (resource.service.name)",
    "{ status = error } | count_over_time() by (name)",
    "{ } | quantile_over_time(duration, 0.5, 0.99) by (resource.service.name)",
]

PKGS = {
    "jax": dict(App=JApp, AppConfig=JAppConfig, DBConfig=JDBConfig,
                FrontendConfig=JFrontendConfig, IngesterConfig=JIngesterConfig,
                Server=JTempoServer, app_kw={}),
    "port": dict(App=App, AppConfig=AppConfig, DBConfig=DBConfig,
                 FrontendConfig=FrontendConfig, IngesterConfig=IngesterConfig,
                 Server=TempoServer, app_kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    # a segment ends in its gzipped dictionary, whose header holds the
    # second gzip wrote it (tests/test_torch_db.py): both packages' pushes
    # may straddle a second, so the clock is pinned
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000))
    monkeypatch.setattr(jpipeline, "overlap_enabled", lambda: False)
    monkeypatch.setattr(pipeline, "overlap_enabled", lambda: False)
    for cache in (jcolcache.shared_cache(), colcache.shared_cache()):
        if cache is not None:
            cache.clear()


def _request(url, method, path, body=None, headers=None):
    req = urllib.request.Request(url + path, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _role_cfg(pkg, root, target, instance_id="", frontend_address=""):
    p = PKGS[pkg]
    db_kw = dict(backend="local", backend_path=f"{root}/blocks", wal_path=f"{root}/wal",
                 blocklist_poll_s=3600.0, compaction_device_shards=1, analytics_scan_s=0)
    return p["AppConfig"](
        target=target,
        db=p["DBConfig"](**db_kw),
        frontend=p["FrontendConfig"](hedge_after_s=0),
        ingester=p["IngesterConfig"](max_trace_idle_s=3600.0, flush_check_period_s=3600.0),
        replication_factor=2,
        generator_enabled=False,
        instance_id=instance_id,
        ring_kv_path=f"{root}/ring.json",
        frontend_address=frontend_address,
        query_workers=1,
    )


class Cluster:
    """Role Apps of one or both packages behind their own servers, the
    ring in one FileKV; every /rpc/v1 request an ingester serves is
    recorded with its answer."""

    def __init__(self, root):
        self.root = str(root)
        self.nodes = {}  # name -> (app, server)
        self.rpc_log = {}  # ingester name -> [(method, path, tenant, body, answer)]

    def start(self, pkg, target, name, **kw):
        p = PKGS[pkg]
        app = p["App"](_role_cfg(pkg, self.root, target, instance_id=name, **kw), **p["app_kw"])
        srv = p["Server"](app).start()
        if target == "ingester":
            # advertise the real port: re-register with the address now known
            app.ring.register(name, addr=srv.url)
            log = self.rpc_log.setdefault(name, [])
            inner = app.rpc.handle

            def handle(method, path, tenant, body, inner=inner, log=log):
                out = inner(method, path, tenant, body)
                log.append((method, path, tenant, bytes(body), out))
                return out
            app.rpc.handle = handle
        if target == "query-frontend":
            app.rpc.pull_timeout_s = 0.5
        app.start_loops()
        self.nodes[name] = (app, srv)
        return app, srv

    def url(self, name):
        return self.nodes[name][1].url

    def kill(self, name):
        app, srv = self.nodes.pop(name)
        srv.stop()
        app.shutdown()

    def stop_all(self):
        # the frontend before its querier: the querier's long-poll then
        # ends at once instead of at its join timeout
        order = sorted(self.nodes, key=lambda n: (not n.startswith("frontend"), n))
        for name in order:
            self.kill(name)

    def pushes(self):
        return {n: [rec[3] for rec in log if rec[1] == "/rpc/v1/ingester/push"]
                for n, log in sorted(self.rpc_log.items())}


def build(root, roles):
    """roles: package of the ingesters, distributor, frontend, querier."""
    c = Cluster(root)
    try:
        for i in range(3):
            c.start(roles["ingester"], "ingester", f"ingester-{i}")
        c.start(roles["distributor"], "distributor", "distributor-0")
        fe_app, fe_srv = c.start(roles["query-frontend"], "query-frontend", "frontend-0")
        c.start(roles["querier"], "querier", "querier-0", frontend_address=fe_srv.url)
    except BaseException:
        c.stop_all()
        raise
    return c


@pytest.fixture
def clusters(tmp_path):
    made = []

    def make(name, roles):
        c = build(tmp_path / name, roles)
        made.append(c)
        return c

    yield make
    for c in made:
        c.stop_all()


def bodies(seed=31, n_pushes=3):
    """OTLP protobuf bodies and their trace IDs: traces of 4 chained spans
    over make_batch's services, a minute apart."""
    out, ids = [], []
    for i in range(n_pushes):
        b = synth.make_batch(16, 4, seed=seed * 10 + i,
                             base_time_ns=(T_DATA + 60 * i) * 10**9)
        traces = batch_to_traces(chain_parents(b))
        out.append(otlp.encode_traces_request(traces))
        ids += [t.trace_id.hex() for t in traces]
    return out, ids


def push(c, payloads):
    for body in payloads:
        status, _ = _request(c.url("distributor-0"), "POST", "/v1/traces", body, PB)
        assert status == 200


def answers(c, ids):
    """Every read through the frontend: {request: normalized answer};
    each present ID is found."""
    fe = c.url("frontend-0")
    out = {}
    for tid in ids + ["0123456789abcdef0123456789abcdef"]:
        path = f"/api/traces/{tid}"
        status, body = _request(fe, "GET", path, headers={"Accept": "application/protobuf"})
        out[path] = (status, norm_trace_pb(body))
        assert status == (404 if tid.startswith("0123") else 200), path
    for s in SEARCHES:
        path = "/api/search" + qs(**s)
        status, body = _request(fe, "GET", path)
        out[path] = (status, norm_query(body))
    for q in QUERY_RANGES:
        path = "/api/metrics/query_range" + qs(q=q, start=T_DATA - 60,
                                               end=T_DATA + 600, step=60)
        status, body = _request(fe, "GET", path)
        out[path] = (status, norm_query(body))
    return out


def live_payloads(c):
    return {n: _request(c.url(n), "GET", "/rpc/v1/ingester/live")
            for n in sorted(c.nodes) if n.startswith("ingester-")}


def test_port_cluster_equals_jax_cluster(clusters):
    """The same traces into a JAX cluster and a port cluster: equal
    answers and byte-equal RPC payloads, before and after ingester-1
    dies at RF 2."""
    payloads, ids = bodies()
    j = clusters("jax", dict.fromkeys(("ingester", "distributor", "query-frontend",
                                       "querier"), "jax"))
    t = clusters("port", dict.fromkeys(("ingester", "distributor", "query-frontend",
                                        "querier"), "port"))
    push(j, payloads)
    push(t, payloads)
    # each ingester took the same segments, byte for byte, from each
    # distributor (both rings route by the same tokens)
    jp, tp = j.pushes(), t.pushes()
    assert jp == tp
    assert sum(len(v) for v in tp.values()) >= 2 * len(payloads)  # RF 2
    jl, tl = live_payloads(j), live_payloads(t)
    assert jl == tl and all(s == 200 and b for s, b in tl.values())

    # a find through the JAX package's server takes ~0.45 s (its responses
    # wait out delayed ACKs), so the packages compare over every 4th ID
    some = ids[::4]
    ja, ta = answers(j, some), answers(t, some)
    assert ja == ta
    assert any(ta[k][1]["data"]["result"] for k in ta if "query_range" in k)

    for c in (j, t):
        c.kill("ingester-1")
    ja, ta = answers(j, some), answers(t, some)
    assert ja == ta
    assert live_payloads(j) == live_payloads(t)
    # every trace still whole on the port's cluster after the kill
    traces = {}
    for body in payloads:
        traces.update({tr.trace_id.hex(): tr for tr in otlp.decode_traces_request(body)})
    for tid in ids:
        status, body = _request(t.url("frontend-0"), "GET", f"/api/traces/{tid}",
                                headers={"Accept": "application/protobuf"})
        assert status == 200, "spans lost after ingester death"
        assert otlp.decode_traces_request(body)[0].span_count() == traces[tid].span_count()


def test_mixed_cluster_answers_as_the_jax_cluster(clusters):
    """A JAX distributor and frontend with the port's ingesters and
    querier: the wire is one protocol, so the answers equal an all-JAX
    cluster's, and the JAX distributor sends the port's ingesters the
    segments it sends the JAX ones."""
    payloads, ids = bodies(seed=37, n_pushes=2)
    j = clusters("jax", dict.fromkeys(("ingester", "distributor", "query-frontend",
                                       "querier"), "jax"))
    m = clusters("mixed", {"ingester": "port", "distributor": "jax",
                           "query-frontend": "jax", "querier": "port"})
    push(j, payloads)
    push(m, payloads)
    assert j.pushes() == m.pushes()
    assert live_payloads(j) == live_payloads(m)
    ja, ma = answers(j, ids[::4]), answers(m, ids[::4])
    assert ja == ma


def test_role_guards_match(tmp_path):
    """An ingester role refuses what it does not serve, with the
    reference's exception and message."""
    msgs = []
    for pkg, exc in (("jax", JRoleUnavailable), ("port", RoleUnavailable)):
        p = PKGS[pkg]
        app = p["App"](_role_cfg(pkg, str(tmp_path / pkg), "ingester",
                                 instance_id="ingester-x"), **p["app_kw"])
        try:
            got = []
            for call in (lambda: app.find_trace(b"\x00" * 16), lambda: app.push_traces([]),
                         lambda: app.search_tags(), lambda: app.graph_dependencies()):
                with pytest.raises(exc) as e:
                    call()
                got.append(str(e.value))
            msgs.append(got)
            got.append(app.service_states())
        finally:
            app.shutdown()
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("target", ["distributor", "ingester", "querier", "query-frontend",
                                    "compactor", "metrics-generator"])
def test_role_requires_ring_kv(tmp_path, target):
    msgs = []
    for pkg in ("jax", "port"):
        cfg = _role_cfg(pkg, str(tmp_path / pkg), target)
        cfg.ring_kv_path = ""
        p = PKGS[pkg]
        if target in ("compactor", "query-frontend"):
            # neither joins a ring: each builds without a KV
            app = p["App"](cfg, **p["app_kw"])
            assert app.ring is None and (app.compactor or app.frontend) is not None
            app.shutdown()
            continue
        with pytest.raises(ValueError, match="ring_kv_path") as e:
            p["App"](cfg, **p["app_kw"])
        msgs.append(str(e.value))
    assert msgs[:1] == msgs[1:]


def test_role_http_statuses_match(tmp_path):
    """Routes a role does not serve answer the reference's status on
    both packages: 404 for an API of another role, 200 for the KV."""
    c = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        app = p["App"](_role_cfg(pkg, str(tmp_path / pkg), "ingester",
                                 instance_id="ingester-0"), **p["app_kw"])
        c[pkg] = (app, p["Server"](app).start())
    try:
        for method, path in (("GET", "/api/traces/0123456789abcdef0123456789abcdef"),
                             ("GET", "/api/search?tags=a%3Db"), ("POST", "/v1/traces"),
                             ("POST", "/rpc/v1/worker/pull"), ("POST", "/rpc/v1/generator/push"),
                             ("GET", "/rpc/v1/nope"), ("GET", "/kv/v1/ring"),
                             ("GET", "/memberlist"), ("GET", "/status/storage"),
                             ("DELETE", "/kv/v1/ring"), ("GET", "/api/query-insights")):
            got = [_request(c[pkg][1].url, method, path, b"" if method == "POST" else None)
                   for pkg in ("jax", "port")]
            assert got[0][0] == got[1][0], (method, path, got)
    finally:
        for app, srv in c.values():
            srv.stop()
            app.shutdown()


KINDS = ("find", "search_recent", "search_blocks", "traceql", "metrics_recent",
         "metrics_blocks", "graph_recent", "graph_blocks")


@pytest.mark.parametrize("result_cache", ["0", "force"])
def test_every_job_result_survives_json(tmp_path, monkeypatch, result_cache):
    """RemoteWorker ships execute_job's dict as JSON: every kind's result
    (live data and blocks; with the result cache off, and on with its
    second pass served from decoded entries) comes back equal."""
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", result_cache)
    seen = {}
    inner = tworker.execute_job

    def recording(querier, tenant, desc):
        out = inner(querier, tenant, desc)
        seen.setdefault(desc["kind"], []).append(out)
        return out
    monkeypatch.setattr(tworker, "execute_job", recording)
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=str(tmp_path / "blocks"),
                                    wal_path=str(tmp_path / "wal"), analytics_scan_s=0),
                        frontend=FrontendConfig(hedge_after_s=0), query_workers=1),
              device="cpu")
    srv = TempoServer(app).start()
    try:
        b = synth.make_graph_batch(64, 6, seed=3, base_time_ns=T_DATA * 10**9)
        body = otlp.encode_traces_request(batch_to_traces(b))
        assert _request(srv.url, "POST", "/v1/traces", body, PB)[0] == 200
        tid = batch_to_traces(b)[0].trace_id.hex()
        reads = [f"/api/traces/{tid}", "/api/search" + qs(tags="service.name=frontend"),
                 "/api/search" + qs(q='{ resource.service.name = "frontend" }'),
                 "/api/graph/dependencies" + qs(start=T_DATA - 60, end=T_DATA + 600),
                 "/api/graph/critical-path" + qs(start=T_DATA - 60, end=T_DATA + 600)]
        reads += ["/api/metrics/query_range" + qs(q=q, start=T_DATA - 60, end=T_DATA + 600,
                                                  step=60, exemplars=2)
                  for q in QUERY_RANGES]
        for _ in range(2):  # live, then from the flushed block (twice: cache hits)
            for path in reads:
                assert _request(srv.url, "GET", path)[0] == 200, path
            assert _request(srv.url, "POST", "/flush")[0] == 204
            app.db.poll_now()
        for path in reads:
            assert _request(srv.url, "GET", path)[0] == 200, path
    finally:
        srv.stop()
        app.shutdown()
    assert set(KINDS) <= set(seen), sorted(seen)
    for kind, results in seen.items():
        for r in results:
            assert json.loads(json.dumps(r)) == r, kind


def test_vulture_sidecar_probes_a_port_cluster(clusters, tmp_path):
    """`target=vulture` builds the HTTP sidecar: it writes probes to the
    distributor and reads them back through the frontend of a port
    cluster with no error, as a JAX sidecar does against a JAX cluster."""
    from tempo_tpu.vulture import VultureConfig as JVultureConfig
    from tempo_tpu_torch.vulture import VultureConfig

    verdicts = {}
    for pkg, vcfg in (("port", VultureConfig), ("jax", JVultureConfig)):
        c = clusters(pkg, dict.fromkeys(("ingester", "distributor", "query-frontend",
                                         "querier"), pkg))
        cfg = _role_cfg(pkg, str(tmp_path / f"v-{pkg}"), "vulture")
        cfg.vulture = vcfg(target=c.url("distributor-0"), query_target=c.url("frontend-0"))
        p = PKGS[pkg]
        app = p["App"](cfg, **p["app_kw"])
        try:
            v = app.vulture
            assert type(v.client).__name__ == "HTTPClient"
            now = int(time.time())
            infos = [v.write_once(now - 30 + i) for i in range(3)]
            got = [v.check_by_id(now, tier="fresh", info=info) for info in infos]
            got += [v.check_search(now, tier="fresh", info=info) for info in infos]
            got.append(v.check_traceql(now, tier="fresh", info=infos[-1]))
            verdicts[pkg] = (got, dict(v.error_counts))
        finally:
            app.shutdown()
    assert verdicts["port"] == verdicts["jax"] == ([True] * 7, {})
