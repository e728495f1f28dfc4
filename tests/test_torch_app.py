"""The port's single binary against the JAX package's, over HTTP.

Both packages' App(target=all) run behind their own TempoServer on an
ephemeral port, over their own local backend, and receive the same OTLP
payloads (protobuf, JSON, gzip). Every served route is asked the same
questions on both and the answers are compared field for field: before
and after /flush (the flushed blocks byte for byte), after a compaction,
with multitenancy on and off, and with replication factor 2 over two
in-process ingesters; then the refusals (429 on the rate limit,
TraceTooLarge and MaxLiveTraces, 400 on bad TraceQL), and the Zipkin and
Jaeger thrift routes (202, the same finds and blocks). The port runs
with device="cpu".

Both Apps run the metrics-generator and the standing-query engine (the
defaults), the JAX App with its storage engine pinned to one device (compaction_device_shards=1: the JAX tests run on
an 8-device CPU mesh, and the port's CPU App sees one device; the mesh
arms are held in tests/test_torch_mesh.py), and
both with their periodic storage analytics scan off (/status/storage
then scans on demand, in both). ReadAhead prefetch, hedged requests and
all but one query worker are off in both, so every answer reads the
same bytes on every run. The compiled query tier is on in both (the
default), each with a fresh shape cache per test, so hit/miss verdicts
and the cache's counts compare one for one.

Fields left out of the comparison, all wall-clock: `elapsedMs` and
`stageSeconds` of search and query_range responses, `heartbeat_age_s`
of the ring pages, and the Retry-After header of a rate-limited push
(the token bucket's refill time). Spans of one trace are compared as a
set: find combines a trace's parts in the order the storage engine's
block jobs finish. Tolerance is exact: every count and matrix value is
an integer sum.
"""

import gzip
import json
import os
import sys
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from tempo_tpu.api.server import TempoServer as JTempoServer
from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.compiled import cache as jcompiled_cache
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu.encoding.common import BlockConfig as JBlockConfig
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.modules.frontend import FrontendConfig as JFrontendConfig
from tempo_tpu.modules.ingester import IngesterConfig as JIngesterConfig
from tempo_tpu.modules.overrides import Limits as JLimits
from tempo_tpu.util import pipeline as jpipeline
from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.compiled import cache as compiled_cache
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.encoding.common import BlockConfig
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.trace import batch_to_traces
from tempo_tpu_torch.modules.frontend import FrontendConfig
from tempo_tpu_torch.modules.ingester import IngesterConfig
from tempo_tpu_torch.modules.overrides import Limits
from tempo_tpu_torch.receivers import otlp
from tempo_tpu_torch.util import pipeline

import chip_smoke
from test_torch_blocks import block_objects
from test_torch_search import chain_parents

T0 = 1_700_000_000
BLOCK = {"row_group_spans": 256}


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    monkeypatch.setattr(jpipeline, "overlap_enabled", lambda: False)
    monkeypatch.setattr(pipeline, "overlap_enabled", lambda: False)
    for cache in (jcolcache.shared_cache(), colcache.shared_cache()):
        if cache is not None:
            cache.clear()
    monkeypatch.setattr(jcompiled_cache, "_shared", jcompiled_cache.ShapeCache())
    monkeypatch.setattr(compiled_cache, "_shared", compiled_cache.ShapeCache())


def _request(url, method, path, body=None, headers=None):
    """(status, headers, body) of one HTTP request."""
    req = urllib.request.Request(url + path, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class AppPair:
    """The JAX package's App and the port's, each behind a TempoServer
    on an ephemeral port over its own local backend."""

    def __init__(self, root, limits=None, device="cpu", jax_kw=None, port_kw=None, **kw):
        # one query worker and no hedged duplicates: jobs of one query
        # then read the column cache in queue order, so the inspected and
        # decoded bytes of every answer are the same on every run
        kw.setdefault("query_workers", 1)
        self.roots = (str(root / "jax"), str(root / "port"))
        jdb = JDBConfig(backend="local", backend_path=self.roots[0] + "/blocks",
                        wal_path=self.roots[0] + "/wal", block=JBlockConfig(**BLOCK),
                        compaction_device_shards=1, analytics_scan_s=0)
        tdb = DBConfig(backend="local", backend_path=self.roots[1] + "/blocks",
                       wal_path=self.roots[1] + "/wal", block=BlockConfig(**BLOCK),
                       compaction_device_shards=1, analytics_scan_s=0)
        self.japp = JApp(JAppConfig(
            db=jdb, ingester=JIngesterConfig(), limits=JLimits(**(limits or {})),
            frontend=JFrontendConfig(hedge_after_s=0),
            **kw, **(jax_kw or {})))
        self.tapp = None
        self.servers = []
        try:
            self.tapp = App(AppConfig(db=tdb, ingester=IngesterConfig(),
                                      frontend=FrontendConfig(hedge_after_s=0),
                                      limits=Limits(**(limits or {})), **kw,
                                      **(port_kw or {})),
                            device=device)
            self.servers = [JTempoServer(self.japp).start(), TempoServer(self.tapp).start()]
        except BaseException:
            self.close()
            raise

    def close(self):
        for s in self.servers:
            s.stop()
        for app in (self.japp, self.tapp):
            if app is not None:
                app.shutdown()

    def both(self, method, path, body=None, headers=None):
        """The same request to both servers: ((status, headers, body) of
        the JAX package, of the port)."""
        return tuple(_request(s.url, method, path, body, headers) for s in self.servers)

    def same(self, method, path, body=None, headers=None, norm=lambda b: b):
        """Ask both; assert equal status and equal normalized body."""
        (js, _, jb), (ts, _, tb) = self.both(method, path, body, headers)
        assert (js, norm(jb)) == (ts, norm(tb)), (method, path)
        return ts, tb

    def same_config(self, path, norm=lambda doc: doc):
        """A /status/config page on both, each package's own directories
        (under its root) replaced by "<root>"."""
        (js, _, jb), (ts, _, tb) = self.both("GET", path)
        docs = [json.loads(b.replace(r.encode(), b"<root>")) for b, r in zip((jb, tb), self.roots)]
        assert (js, norm(docs[0])) == (ts, norm(docs[1])), path
        return docs[1]

    def blocks(self, tenant):
        """Comparable objects of every stored block of `tenant`, per
        package, in an order that does not depend on block IDs."""
        out = []
        for root in self.roots:
            d = os.path.join(root, "blocks", tenant)
            ids = [b for b in os.listdir(d) if os.path.exists(os.path.join(d, b, "meta.json"))] \
                if os.path.isdir(d) else []
            objs = [block_objects(root + "/blocks", tenant, b) for b in ids]
            out.append(sorted(objs, key=lambda o: o["meta.json"]))
        return out


@pytest.fixture
def make_pair(tmp_path):
    pairs = []

    def make(**kw):
        p = AppPair(tmp_path / f"p{len(pairs)}", **kw)
        pairs.append(p)
        return p

    yield make
    for p in pairs:
        p.close()


@pytest.fixture(scope="module")
def idle_pair(tmp_path_factory):
    """One pair for the stateless refusal tests."""
    p = AppPair(tmp_path_factory.mktemp("idle"))
    yield p
    p.close()


# ---------------------------------------------------------------------------
# payloads and normalizers
# ---------------------------------------------------------------------------


def traces_of(n, spans, seed, minute=0):
    b = synth.make_batch(n, spans, seed=seed, base_time_ns=(T0 + 60 * minute) * 10**9)
    return batch_to_traces(chain_parents(b))


PB = {"Content-Type": "application/x-protobuf"}
JSON_CT = {"Content-Type": "application/json"}


def push_all(pair, org=None, seed=0, minute=0):
    """One protobuf, one JSON and one gzip OTLP request; returns the
    pushed trace IDs."""
    h = {"X-Scope-OrgID": org} if org else {}
    pushed = []
    for i, (enc, ct, gz) in enumerate((("pb", PB, False), ("json", JSON_CT, False),
                                       ("pb", PB, True))):
        traces = traces_of(12, 4, seed=seed * 10 + i, minute=minute + i)
        body = (otlp.encode_traces_request(traces) if enc == "pb"
                else json.dumps(otlp.encode_traces_json(traces)).encode())
        hdr = dict(h, **ct)
        if gz:
            body = gzip.compress(body)
            hdr["Content-Encoding"] = "gzip"
        status, _ = pair.same("POST", "/v1/traces", body, hdr)
        assert status == 200
        pushed += [t.trace_id.hex() for t in traces]
    return pushed


def norm_trace_json(raw: bytes):
    """OTLP JSON trace -> sorted span records (resource, scope, span)."""
    try:
        doc = json.loads(raw)
    except ValueError:
        return raw
    out = []
    for rs in doc.get("resourceSpans", []):
        res = json.dumps(rs.get("resource", {}), sort_keys=True)
        for ss in rs.get("scopeSpans", []):
            scope = json.dumps(ss.get("scope", {}), sort_keys=True)
            for sp in ss.get("spans", []):
                out.append((res, scope, json.dumps(sp, sort_keys=True)))
    return sorted(out)


def norm_trace_pb(raw: bytes):
    if not raw or raw.startswith(b"trace not found"):
        return raw
    return norm_trace_json(json.dumps(otlp.encode_traces_json(
        otlp.decode_traces_request(raw))).encode())


WALL_CLOCK = ("elapsedMs", "stageSeconds")
UNCOMPARED = ()  # the cuda test adds deviceDispatches (the JAX side runs on the CPU)


def norm_query(raw: bytes):
    """Search / query_range JSON without its wall-clock fields."""
    try:
        doc = json.loads(raw)
    except ValueError:
        return raw
    for k in WALL_CLOCK + UNCOMPARED:
        (doc.get("metrics") or {}).pop(k, None)
    return doc


def norm_ring(raw: bytes):
    doc = json.loads(raw)
    for inst in doc.get("instances", []):
        inst.pop("heartbeat_age_s")
    return doc


def qs(**kw):
    return "?" + urllib.parse.urlencode(kw)


SEARCHES = [
    {"tags": "service.name=cart"},
    {"tags": "service.name=cart name=cache.get"},
    {"tags": "http.status_code=500", "limit": 5},
    {"tags": "region=v7"},
    {"tags": "service.name=cart", "minDuration": "500ms"},
    {"tags": "service.name=cart", "maxDuration": "100ms", "limit": 3},
    {"tags": "service.name=nope"},
    {"tags": "service.name=cart", "start": T0 + 60, "end": T0 + 200},
    {"q": '{ resource.service.name = "cart" }'},
    {"q": '{ span.http.status_code = 500 } | count() > 1', "limit": 50},
    {"q": '{ resource.service.name = "cart" } >> { span.http.status_code = 500 }'},
    {"q": '{ duration > 500ms }', "start": T0, "end": T0 + 400, "limit": 4},
]
QUERY_RANGES = [
    "{ } | rate() by (resource.service.name)",
    "{ status = error } | count_over_time() by (name)",
    "{ } | quantile_over_time(duration, 0.5, 0.99) by (resource.service.name)",
]


def check_routes(pair, ids, org=None, flushed=True):
    """Every served query and admin route, asked of both apps. Before a
    flush the metrics matrices are empty on both: query_range reads live
    data only for a window that reaches into the last hour."""
    h = {"X-Scope-OrgID": org} if org else {}
    for tid in ids[:6] + ids[-6:] + ["0123456789abcdef0123456789abcdef"]:
        pair.same("GET", f"/api/traces/{tid}", headers=h, norm=norm_trace_json)
        pair.same("GET", f"/api/traces/{tid}", headers=dict(h, Accept="application/protobuf"),
                  norm=norm_trace_pb)
    for s in SEARCHES:
        status, _ = pair.same("GET", "/api/search" + qs(**s), headers=h, norm=norm_query)
        assert status == 200
    status, body = pair.same("GET", "/api/search/tags", headers=h, norm=json.loads)
    assert status == 200 and json.loads(body)["tagNames"]
    for tag in ("service.name", "name", "http.method", "region", "nope"):
        pair.same("GET", f"/api/search/tag/{tag}/values", headers=h, norm=json.loads)
    for q in QUERY_RANGES:
        status, body = pair.same(
            "GET", "/api/metrics/query_range" + qs(q=q, start=T0 - 60, end=T0 + 600, step=60),
            headers=h, norm=norm_query)
        assert status == 200 and bool(json.loads(body)["data"]["result"]) == flushed
    for path in ("/ready", "/api/echo", "/status/buildinfo", "/status/services",
                 "/status/runtime_config"):
        pair.same("GET", path)
    assert pair.same_config("/status/config")["db"]["wal_path"] == "<root>/wal"
    for path in ("/ingester/ring", "/distributor/ring", "/compactor/ring",
                 "/metrics-generator/ring"):
        pair.same("GET", path, norm=norm_ring)


# ---------------------------------------------------------------------------
# the flows
# ---------------------------------------------------------------------------


SCENARIOS = {
    "single": {},
    "multitenant": {"multitenancy_enabled": True},
    "rf2": {"replication_factor": 2, "n_ingesters": 2},
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_push_flush_compact_over_http(make_pair, scenario):
    kw = SCENARIOS[scenario]
    pair = make_pair(**kw)
    # tenant names of no other test file: the reference charges
    # process-wide usage counters per tenant
    orgs = ["org-a", "org-b"] if kw.get("multitenancy_enabled") else [None]
    tenants = orgs if orgs != [None] else ["single-tenant"]
    pushed = {org: push_all(pair, org, seed=k) for k, org in enumerate(orgs)}
    for org in orgs:  # live data: served by the ingesters
        check_routes(pair, pushed[org], org, flushed=False)

    assert pair.same("POST", "/flush")[0] == 204
    for t in tenants:
        jb, tb = pair.blocks(t)
        assert len(tb) == int(kw.get("replication_factor", 1)) and jb == tb
    for org in orgs:
        check_routes(pair, pushed[org], org)

    # a second flushed block per ingester, then one compaction cycle
    more = {org: push_all(pair, org, seed=10 + k, minute=3) for k, org in enumerate(orgs)}
    assert pair.same("POST", "/flush")[0] == 204
    for t in tenants:
        jobs = [app.compactor.driver.compact_tenant(t) for app in (pair.japp, pair.tapp)]
        assert jobs[0] == jobs[1] >= 1
    for t in tenants:
        jb, tb = pair.blocks(t)
        assert jb == tb and any(json.loads(o["meta.json"])["compaction_level"] > 0 for o in tb)
    for org in orgs:
        check_routes(pair, pushed[org] + more[org], org)


def test_multitenancy_needs_org_id(make_pair):
    pair = make_pair(multitenancy_enabled=True)
    status, _ = pair.same("POST", "/v1/traces",
                          otlp.encode_traces_request(traces_of(2, 2, seed=1)), PB)
    assert status == 401
    assert pair.same("GET", "/api/search/tags")[0] == 401


def test_status_pages(make_pair):
    pair = make_pair()
    # the port lists only the routes it serves, in the reference's order
    (_, _, jb), (_, _, tb) = pair.both("GET", "/status/endpoints")
    served = json.loads(tb)["endpoints"]
    assert served == json.loads(jb)["endpoints"] and len(served) == 46
    assert _request(pair.servers[1].url, "GET", "/status")[2] == tb
    # the port's defaults are the reference's, so its diff is too
    for mode in ("defaults", "diff"):
        pair.same_config(f"/status/config?mode={mode}")
    assert pair.same("GET", "/status/config?mode=bogus")[0] == 400
    # /metrics: the deterministic counters move by the same amounts
    before = [_counters(b) for _, _, b in pair.both("GET", "/metrics")]
    push_all(pair, seed=3)
    pair.same("POST", "/flush")
    after = [_counters(b) for _, _, b in pair.both("GET", "/metrics")]
    # series whose delta is zero on a side are left out: the JAX metrics
    # registry is process-global, so it may carry zero-delta series of
    # tenants that earlier tests in the same process pushed
    deltas = [{k: d for k in a if k.startswith(COUNTED) and (d := a[k] - b.get(k, 0.0))}
              for a, b in zip(after, before)]
    assert deltas[0] == deltas[1] and deltas[1]


COUNTED = ("tempo_distributor_spans_received_total", "tempo_distributor_bytes_received_total",
           "tempo_ingest_spans_decoded_total", "tempo_ingester_blocks_flushed_total",
           "tempo_tpu_usage_ingested_spans_total", "tempo_tpu_usage_ingested_bytes_total")


def _counters(raw: bytes) -> dict:
    out = {}
    for line in raw.decode().splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_rate_limit_429(make_pair):
    pair = make_pair(limits={"ingestion_rate_limit_bytes": 1000, "ingestion_burst_size_bytes": 4000})
    body = otlp.encode_traces_request(traces_of(64, 4, seed=2))
    (js, jh, jb), (ts, th, tb) = pair.both("POST", "/v1/traces", body, PB)
    assert (js, jb) == (ts, tb) and ts == 429
    assert "Retry-After" in jh and "Retry-After" in th  # the refill time: wall clock


@pytest.mark.parametrize("limits,n_traces,spans", [
    ({"max_spans_per_trace": 3}, 4, 4),       # TraceTooLarge
    ({"max_traces_per_user": 3}, 6, 2),       # MaxLiveTraces
], ids=["TraceTooLarge", "MaxLiveTraces"])
def test_ingester_limits(make_pair, limits, n_traces, spans):
    """The ingester refuses the traces over its limit. Over HTTP both
    packages answer 500: the distributor folds an ingester's refusal into
    its quorum error (an IOError), so the server's 429 mapping of
    TraceTooLarge / MaxLiveTraces is not reached on this path."""
    pair = make_pair(limits=limits)
    body = otlp.encode_traces_request(traces_of(n_traces, spans, seed=4))
    status, body = pair.same("POST", "/v1/traces", body, PB)
    assert status == 500 and body == b"internal error\n"
    # the traces within the limit were taken: both serve the same ones
    pair.same("POST", "/flush")
    jb, tb = pair.blocks("single-tenant")
    assert jb == tb


@pytest.mark.parametrize("path", [
    "/api/search" + qs(q="{ resource.service.name = }"),
    "/api/search" + qs(q="{ } | rate("),
    "/api/metrics/query_range" + qs(q="{ } | nope()", start=T0, end=T0 + 60, step=60),
    "/api/search" + qs(tags="service.name=cart", minDuration="xyz"),
    "/api/traces/not-hex",
])
def test_bad_requests_400(idle_pair, path):
    status, _ = idle_pair.same("GET", path)
    assert status == 400


@pytest.mark.parametrize("method,path", [
    ("POST", "/api/v2/spans"),
    ("POST", "/api/traces"),
    ("POST", "/api/v1/spans"),
])
def test_zipkin_and_jaeger_routes_accepted(make_pair, method, path):
    """The Zipkin (v2 JSON, v1 thrift) and Jaeger thrift routes, 404 until
    the port served them: the same bodies (chip_smoke's carrier encoders;
    a Jaeger Batch a service) answer 202 on both servers, every trace is
    found alike, the flushed blocks are byte for byte the JAX App's, and
    every query route answers alike over them."""
    pair = make_pair()
    traces = traces_of(12, 4, seed=21) + batch_to_traces(
        synth.make_graph_batch(12, 6, seed=22, base_time_ns=(T0 + 60) * 10**9))
    if path == "/api/v2/spans":
        bodies = [(chip_smoke.zipkin_v2_json(traces), "application/json")]
    elif path == "/api/v1/spans":
        bodies = [(chip_smoke.zipkin_v1_thrift(traces), "application/x-thrift")]
    else:
        bodies = [(chip_smoke.jaeger_thrift_batch(res, spans), "application/x-thrift")
                  for res, spans in chip_smoke._resource_groups(traces)]
    for body, ct in bodies:
        status, _ = pair.same(method, path, body, {"Content-Type": ct})
        assert status == 202
    ids = [t.trace_id.hex() for t in traces]
    check_routes(pair, ids, flushed=False)
    assert pair.same("POST", "/flush")[0] == 204
    jb, tb = pair.blocks("single-tenant")
    assert jb == tb and tb
    check_routes(pair, ids)


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/memberlist", 200),
    ("POST", "/rpc/v1/ingester/push", 500),
    ("POST", "/rpc/v1/worker/pull", 204),
    ("GET", "/kv/v1/ring", 200),
])
def test_microservices_routes_served(idle_pair, method, path, status, monkeypatch):
    """The routes of microservices mode (the ring KV, /memberlist, the
    inter-role RPC), 404 until the port served them, answer as the
    reference's on target=all: an empty push is a segment that does not
    parse (500), an idle worker pull times out (204)."""
    for app in (idle_pair.japp, idle_pair.tapp):
        monkeypatch.setattr(app.rpc, "pull_timeout_s", 0.2)
    (js, _, jb), (ts, _, tb) = idle_pair.both(method, path, b"" if method == "POST" else None)
    assert js == ts == status
    if status == 200:
        assert json.loads(jb) == json.loads(tb)


def test_malformed_otlp_400(idle_pair):
    pair = idle_pair
    assert pair.same("POST", "/v1/traces", b"\xff\xff\xff", PB)[0] == 400
    assert pair.same("POST", "/v1/traces", b"{not json", JSON_CT)[0] == 400
    assert pair.same("GET", "/flush")[0] == 405
    assert pair.same("GET", "/nope")[0] == 404


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_app_needs_cuda_unless_cpu_is_asked(tmp_path):
    cfg = AppConfig(db=DBConfig(backend="local", backend_path=str(tmp_path / "b"),
                                wal_path=str(tmp_path / "w")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        App(cfg)


@pytest.mark.cuda
def test_app_on_cuda_matches_jax(make_pair, monkeypatch):
    """The single-tenant flow with the port's App on the card: the same
    answers as the JAX package's on the CPU, blocks byte for byte. Only
    the dispatch count differs: query_range folds through seg_bincount."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(sys.modules[__name__], "UNCOMPARED", ("deviceDispatches",))
    pair = make_pair(device="cuda")
    assert pair.tapp.device.type == "cuda" and pair.tapp.device.index is not None
    pushed = push_all(pair)
    assert pair.same("POST", "/flush")[0] == 204
    jb, tb = pair.blocks("single-tenant")
    assert len(tb) == 1 and jb == tb
    check_routes(pair, pushed)
    _, _, body = _request(pair.servers[1].url, "GET", "/api/metrics/query_range"
                          + qs(q=QUERY_RANGES[0], start=T0 - 60, end=T0 + 600, step=60))
    assert json.loads(body)["metrics"]["deviceDispatches"] > 0


# ---------------------------------------------------------------------------
# the compiled query tier
# ---------------------------------------------------------------------------


SIMPLE_COUNT = [
    '{ resource.service.name = "cart" } | rate()',                     # rle set
    '{ name = "db.query" } | count_over_time()',                        # dct set
    '{ resource.service.name != "cart" && duration > 100ms } | rate()',  # inverted, dbp range
    '{ span.http.method !~ "G.*" } | count_over_time()',                 # inverted dct
]
# wall-clock fields of an insights record (and of its cost vector)
INSIGHT_CLOCK = ("ts", "durationSeconds", "stageSeconds")


def _norm_insights(raw: bytes):
    doc = json.loads(raw)
    for rec in doc["insights"]:
        for k in INSIGHT_CLOCK:
            rec.pop(k, None)
        rec.get("usage", {}).pop("device_seconds", None)
    return doc


def test_simple_count_query_range_through_the_compiled_tier(make_pair, monkeypatch):
    """Simple-count query_range over flushed blocks: both Apps answer the
    same matrices through their compiled tiers, the insights records
    read miss then hit alike, and /api/query-insights answers field for
    field (its clock fields left out)."""
    from tempo_tpu.util import insights as jinsights
    from tempo_tpu_torch.util import insights

    pair = make_pair()
    for log in (jinsights.LOG, insights.LOG):  # after App start, which configures them
        log.clear()
        monkeypatch.setattr(log, "sample_every", 1)
        # capture by policy, not by wall clock: the JAX package's first
        # query of a shape compiles its program (over a second on an idle
        # host), so under load it would cross the 2 s slow threshold and
        # read captureReason "slow" where the port's reads "sampled"
        monkeypatch.setattr(log, "slow_threshold_s", float("inf"))
    push_all(pair, seed=6)
    assert pair.same("POST", "/flush")[0] == 204
    push_all(pair, seed=7, minute=3)
    assert pair.same("POST", "/flush")[0] == 204
    shapes = []
    for q in SIMPLE_COUNT:
        for _ in range(2):
            status, body = pair.same(
                "GET", "/api/metrics/query_range" + qs(q=q, start=T0 - 60, end=T0 + 600, step=60),
                norm=norm_query)
            assert status == 200 and json.loads(body)["data"]["result"]
            _, raw = pair.same("GET", "/api/query-insights?limit=1", norm=_norm_insights)
            shapes.append(json.loads(raw)["insights"][0]["compiledShape"])
    assert shapes == ["miss", "hit"] * len(SIMPLE_COUNT)
    _, raw = pair.same("GET", "/api/query-insights", norm=_norm_insights)
    doc = json.loads(raw)
    assert doc["compiled"]["misses"] >= len(SIMPLE_COUNT) and doc["compiled"]["programs"] >= 1
    assert pair.same("GET", "/api/query-insights?limit=x")[0] == 400
