"""The port's shard-partial result cache against the JAX package's.

The cache's contract is "cheaper, never different", and its keys and
framed entries are shared with the reference, so a port replica and a
JAX replica behind one memcached share entries. Held here, on the CPU:

- keys, fingerprints and framed entries (`RC1` + crc32 + canonical JSON)
  byte-equal to the JAX package's; every single bit flip and every
  truncation of an entry rejected by both;
- for search, query_range (count, rate, quantile, by()) and the graph
  jobs (dependencies, critical path): the cold (TEMPO_TPU_RESULT_CACHE=0),
  miss, hit and after-push answers equal to the JAX package's on the
  same blocks, and to the port's cache-off answers; a hit pass inspects
  nothing, the after-push pass recomputes only the new block;
- negative vetoes agree with an unpruned cold scan;
- the standing rebuild's row log replays the cold rebuild at two
  different windows, and Apps that register the same standing queries
  read the same answers with the cache off, missing and hitting;
- an entry written by one package through a shared fake memcached is
  served by the other and gives the same answer;
- a damaged entry (TEMPO_TPU_FAULTS corrupt/short) recomputes, counted;
- the counters and the cost vector move as the reference's do, and the
  frontend's verdict on the insights record is the reference's.

Both packages read the same environment switch, so one monkeypatch
turns both caches on or off. Tolerance is exact: every count is an
integer sum.
"""

from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np
import pytest

from tempo_tpu import resultcache as jrc
from tempo_tpu.encoding.common import SearchRequest as JRequest
from tempo_tpu.metrics_engine import compile_metrics_plan as jplan, merge_wire as jmerge, \
    new_wire as jnew_wire
from tempo_tpu.modules.frontend import Frontend as JFrontend
from tempo_tpu.modules.querier import Querier as JQuerier
from tempo_tpu.standing import engine as jengine
from tempo_tpu.util import insights as jinsights
from tempo_tpu.util import queryshape as jqs
from tempo_tpu.util import usage as jusage
from tempo_tpu_torch import resultcache as trc
from tempo_tpu_torch.cache.client import MemcachedCache, MockCache
from tempo_tpu_torch.encoding.common import SearchRequest
from tempo_tpu_torch.metrics_engine import compile_metrics_plan, merge_wire, new_wire
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model import trace as tr
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.modules.frontend import Frontend
from tempo_tpu_torch.modules.querier import Querier
from tempo_tpu_torch.standing import engine as tengine
from tempo_tpu_torch.util import insights, queryshape, usage

from test_torch_cache import _FakeMemcached
from test_torch_db import DBPair, _clear_caches
from test_torch_search import chain_parents
from test_torch_standing import Pair as StandingPair

BASE_S = 1_700_000_000
TENANT = "t"

METRIC_QUERIES = [
    "{ } | count_over_time()",
    "{ resource.service.name = `cart` } | rate()",
    "{ } | quantile_over_time(duration, 0.5, 0.9)",
    "{ } | rate() by (resource.service.name)",
    "{ duration > 100us } | count_over_time() by (name)",
]
SEARCHES = [
    {"tags": {"service": "cart"}},
    {"tags": {"name": "db.query"}},
    {"tags": {"service.name": "cart"}, "min_duration_ns": 1_000_000},
    {"query": '{ resource.service.name = "cart" }'},
]


def _batch(seed, minute=0, n=40, spans=4):
    b = synth.make_batch(n, spans, seed=seed, base_time_ns=(BASE_S + 60 * minute) * 10**9)
    return chain_parents(b).sorted_by_trace()


@pytest.fixture
def dbs(tmp_path):
    pair = DBPair(tmp_path)
    for i in range(3):
        pair.write(TENANT, _batch(700 + i, minute=i))
    _clear_caches()
    yield pair
    for db in (pair.j, pair.t):
        db.shutdown()


def _ids(pair):
    jids, tids = pair.ids(TENANT)
    assert jids == tids
    return tids


def _search_doc(resp) -> dict:
    d = resp.to_dict()
    return {k: v for k, v in d.items() if k != "metrics"} | {"metrics": {
        k: v for k, v in (d.get("metrics") or {}).items() if k != "elapsedMs"}}


def _traces(resp) -> list:
    return [t.to_dict() for t in resp.traces]


def _rc_counts(mod, kind) -> tuple:
    return tuple(c.value(kind=kind) for c in (mod.rc_hits, mod.rc_misses, mod.rc_negative,
                                              mod.rc_stores, mod.rc_corrupt, mod.rc_bytes_saved))


def _delta(after, before) -> tuple:
    return tuple(a - b for a, b in zip(after, before))


def _passes(pair, monkeypatch, run, kind):
    """cold (cache off), miss, hit, then a fourth block pushed and the
    pass again (miss on the new block, hits on the old): each pass on
    both packages, their answers and counter deltas returned per pass."""
    out = {}
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "0")
    out["cold"] = run()
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "force")
    for name in ("miss", "hit"):
        before = (_rc_counts(jrc, kind), _rc_counts(trc, kind))
        out[name] = run()
        after = (_rc_counts(jrc, kind), _rc_counts(trc, kind))
        out[name + "_counts"] = (_delta(after[0], before[0]), _delta(after[1], before[1]))
    pair.write(TENANT, _batch(790, minute=1))
    before = (_rc_counts(jrc, kind), _rc_counts(trc, kind))
    out["push"] = run()
    after = (_rc_counts(jrc, kind), _rc_counts(trc, kind))
    out["push_counts"] = (_delta(after[0], before[0]), _delta(after[1], before[1]))
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "0")
    out["push_cold"] = run()
    return out


# ---------------------------------------------------------------------------
# keys, fingerprints and frames
# ---------------------------------------------------------------------------


def test_fingerprints_keys_and_frames_byte_equal():
    for q in METRIC_QUERIES + ['{ span.http.status_code = 500 && name =~ "GET.*" }']:
        parts = (queryshape.metrics_shape(q), queryshape.query_literals(q),
                 BASE_S, BASE_S + 60, 10, 64, 0)
        jparts = (jqs.metrics_shape(q), jqs.query_literals(q), BASE_S, BASE_S + 60, 10, 64, 0)
        assert parts == jparts
        assert trc.fingerprint(*parts) == jrc.fingerprint(*jparts)
        assert trc.fingerprint("graph|" + queryshape.normalize_query(q), "deps", "service") == \
            jrc.fingerprint("graph|" + jqs.normalize_query(q), "deps", "service")
    for kw in SEARCHES:
        req, jreq = SearchRequest(limit=20, **kw), JRequest(limit=20, **kw)
        assert queryshape.search_shape(req) == jqs.search_shape(jreq)
    fp = trc.fingerprint("standing|{ } | rate()", 60, 64)
    for kind in trc.RC_KINDS:
        for sub in ("all", "0-4"):
            assert trc.ResultCache.key("t", "b-1", kind, fp, sub) == \
                jrc.ResultCache.key("t", "b-1", kind, fp, sub)
    assert (trc.FORMAT_VERSION, trc._MAGIC, trc.RC_KINDS) == \
        (jrc.FORMAT_VERSION, jrc._MAGIC, jrc.RC_KINDS)
    docs = [{"w": {"series": [{"key": "a", "bins": [[0, 3], [5, 7]]}], "stats": {}}, "sb": 123},
            {"neg": 1, "sb": 0}, {"w": {"traces": [], "ü": "ß"}, "sb": 9},
            {"w": [1.5, None, True, "x"], "sb": 1 << 40}]
    for doc in docs:
        assert trc.encode_entry(doc) == jrc.encode_entry(doc)
        assert trc.decode_entry(trc.encode_entry(doc)) == doc


def test_every_bit_flip_and_truncation_rejected():
    raw = trc.encode_entry({"w": {"series": [{"key": "cart", "bins": [[3, 11]]}]}, "sb": 77})
    for pos in range(len(raw)):
        for bit in range(8):
            bad = raw[:pos] + bytes([raw[pos] ^ (1 << bit)]) + raw[pos + 1:]
            assert trc.decode_entry(bad) is None is jrc.decode_entry(bad), (pos, bit)
    for cut in range(len(raw)):
        assert trc.decode_entry(raw[:cut]) is None is jrc.decode_entry(raw[:cut]), cut
    for junk in (None, b"", b"not a frame", b"RC1" + b"\0" * 4 + b"[1,2]"):
        assert trc.decode_entry(junk) is None


@pytest.mark.parametrize("env,cfg,want", [("", True, True), ("", False, False), ("0", True, False),
                                          ("off", True, True), ("no", True, False),
                                          ("force", False, True), ("on", False, True),
                                          ("1", False, True)])
def test_kill_switch_states_equal(env, cfg, want, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", env)
    t = trc.ResultCache(trc.ResultCacheConfig(enabled=cfg))
    j = jrc.ResultCache(jrc.ResultCacheConfig(enabled=cfg))
    assert trc._env_state() == jrc._env_state()
    assert t.enabled() == j.enabled()
    # "off" is not one of the reference's off words: it follows config
    assert t.enabled() == (want if env != "off" else cfg)


def test_accounting_equal():
    """get/put/put_negative move the six counters and the cost vector as
    the reference's do, the negative switch included."""
    snaps = []
    for mod, use in ((jrc, jusage), (trc, usage)):
        rc = mod.ResultCache(mod.ResultCacheConfig(enabled=True))
        fp = mod.fingerprint("q")
        before = _rc_counts(mod, "search")
        with use.collect() as vec:
            assert rc.get("acct", "b1", "search", fp) is None
            rc.put("acct", "b1", "search", fp, {"traces": []}, bytes_saved=100)
            assert rc.get("acct", "b1", "search", fp)["w"] == {"traces": []}
            rc.put_negative("acct", "b2", "search", fp, bytes_saved=40)
            assert rc.get("acct", "b2", "search", fp)["neg"] == 1
            rc.cfg.negative = False
            assert rc.get("acct", "b2", "search", fp) is None
            rc.put_negative("acct", "b3", "search", fp)
            k = rc.key("acct", "b1", "search", fp)
            raw = rc._local.fetch([k])[1][0]
            rc._local.store([k], [raw[:-2] + bytes([raw[-2] ^ 4]) + raw[-1:]])
            assert rc.get("acct", "b1", "search", fp) is None
        snaps.append((vec.snapshot(), _delta(_rc_counts(mod, "search"), before)))
    assert snaps[1] == snaps[0]
    assert snaps[1][1] == (1, 3, 1, 2, 1, 140)


def test_remote_tier_promotes_only_sound_entries():
    remote = MockCache()
    a = trc.ResultCache(trc.ResultCacheConfig(enabled=True), remote=remote)
    b = trc.ResultCache(trc.ResultCacheConfig(enabled=True), remote=remote)
    fp = trc.fingerprint("q")
    a.put("t", "b1", "graph", fp, {"edges": []}, bytes_saved=9)
    assert b.get("t", "b1", "graph", fp)["w"] == {"edges": []}
    assert b._local.fetch([b.key("t", "b1", "graph", fp)])[0]
    k = b.key("t", "b2", "graph", fp)
    remote.store([k], [b"RC1garbage-that-fails-crc"])
    assert b.get("t", "b2", "graph", fp) is None
    assert not b._local.fetch([k])[0]


@pytest.mark.parametrize("spec", ["corrupt=1.0,seed=7", "short=1.0,seed=11", "corrupt=0.5,seed=3"])
def test_chaos_seam_damages_as_the_reference(spec, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_FAULTS", spec)
    rng = np.random.default_rng(5)
    t = trc.ResultCache(trc.ResultCacheConfig(enabled=True))
    j = jrc.ResultCache(jrc.ResultCacheConfig(enabled=True))
    for _ in range(40):
        raw = trc.encode_entry({"w": rng.integers(0, 1000, 8).tolist(), "sb": 1})
        assert t._chaos(raw) == j._chaos(raw)


# ---------------------------------------------------------------------------
# the querier's arms, cold / miss / hit / after push, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("kw", SEARCHES, ids=lambda kw: json.dumps(kw, sort_keys=True))
def test_search_cold_miss_hit_push(dbs, monkeypatch, kw, n_shards):
    jq, tq = JQuerier(dbs.j), Querier(dbs.t)

    def run():
        ids = _ids(dbs)
        res = []
        for q, req in ((jq, JRequest(limit=1000, **kw)), (tq, SearchRequest(limit=1000, **kw))):
            resp = None
            for s in range(n_shards):
                sub = q.search_block_batch(TENANT, ids[s::n_shards], req)
                if resp is None:
                    resp = sub
                else:
                    resp.merge(sub, limit=req.limit)
            res.append(resp)
        assert _search_doc(res[1]) == _search_doc(res[0])
        return res[1]

    out = _passes(dbs, monkeypatch, run, "search")
    assert out["cold"].traces
    assert _traces(out["cold"]) == _traces(out["miss"]) == _traces(out["hit"])
    assert _traces(out["push"]) == _traces(out["push_cold"])
    assert out["hit"].inspected_bytes == out["hit"].inspected_blocks == 0
    for k in ("miss_counts", "hit_counts", "push_counts"):
        assert out[k][1] == out[k][0], k
    assert out["hit_counts"][1][0] == 3 and out["push_counts"][1][:2] == (3, 1)


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("q", METRIC_QUERIES)
def test_query_range_cold_miss_hit_push(dbs, monkeypatch, q, n_shards):
    jq, tq = JQuerier(dbs.j), Querier(dbs.t)
    window = (BASE_S, BASE_S + 300, 10)

    def run():
        ids = _ids(dbs)
        res = []
        for qr, plan, merge, new in ((jq, jplan(q, *window), jmerge, jnew_wire),
                                      (tq, compile_metrics_plan(q, *window), merge_wire, new_wire)):
            merged = new()
            for s in range(n_shards):
                merge(merged, qr.query_range_blocks(TENANT, ids[s::n_shards], q, *window), plan)
            res.append(merged)
        assert res[1] == res[0]
        return res[1]

    out = _passes(dbs, monkeypatch, run, "metrics")
    assert out["cold"]["series"]
    assert out["cold"]["series"] == out["miss"]["series"] == out["hit"]["series"]
    assert out["cold"]["exemplars"] == out["hit"]["exemplars"]
    assert out["push"]["series"] == out["push_cold"]["series"]
    assert out["hit"]["stats"].get("inspectedBytes", 0) == 0
    for k in ("miss_counts", "hit_counts", "push_counts"):
        assert out[k][1] == out[k][0], k
    assert out["hit_counts"][1][0] == 3 and out["push_counts"][1][:2] == (3, 1)


@pytest.mark.parametrize("want,by", [("deps", "service"), ("cp", "service"), ("cp", "name")])
def test_graph_cold_miss_hit_push(dbs, monkeypatch, want, by):
    jq, tq = JQuerier(dbs.j), Querier(dbs.t)

    def content(w):
        return json.dumps({k: v for k, v in w.items() if k != "stats"}, sort_keys=True)

    def run():
        ids = _ids(dbs)
        res = [q.graph_blocks(TENANT, ids, "", BASE_S, BASE_S + 3600, want, by=by)
               for q in (jq, tq)]
        assert json.dumps(res[1], sort_keys=True) == json.dumps(res[0], sort_keys=True)
        return res[1]

    out = _passes(dbs, monkeypatch, run, "graph")
    assert content(out["cold"]) == content(out["miss"]) == content(out["hit"])
    assert content(out["push"]) == content(out["push_cold"])
    assert out["hit"]["stats"]["inspectedBytes"] == 0
    for k in ("miss_counts", "hit_counts", "push_counts"):
        assert out[k][1] == out[k][0], k
    assert out["hit_counts"][1][0] == 3 and out["push_counts"][1][:2] == (3, 1)


def test_series_overflow_recomputes_cold(dbs, monkeypatch):
    """A per-block table that dropped series cannot merge exactly: the
    cached tier falls through to the cold path in both packages."""
    q = "{ } | rate() by (name)"
    jq, tq = JQuerier(dbs.j), Querier(dbs.t)
    ids = _ids(dbs)
    outs = []
    for env in ("force", "0"):
        monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", env)
        j = jq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10, max_series=2)
        t = tq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10, max_series=2)
        assert j["series"] == t["series"]
        outs.append(t["series"])
    assert outs[0] == outs[1]


def test_negative_vetoes_agree_with_an_unpruned_cold_scan(dbs, monkeypatch):
    jq, tq = JQuerier(dbs.j), Querier(dbs.t)
    ids = _ids(dbs)
    tags = {"service": "no-such-svc"}
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("TEMPO_TPU_ZONEMAPS", "0")
    unpruned = tq.search_block_batch(TENANT, ids, SearchRequest(tags=tags, limit=100))
    assert not unpruned.traces and unpruned.inspected_blocks == len(ids)
    monkeypatch.delenv("TEMPO_TPU_ZONEMAPS")
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "force")
    n0 = (jrc.rc_negative.value(kind="search"), trc.rc_negative.value(kind="search"))
    for _ in range(2):
        j = jq.search_block_batch(TENANT, ids, JRequest(tags=tags, limit=100))
        t = tq.search_block_batch(TENANT, ids, SearchRequest(tags=tags, limit=100))
        assert _search_doc(t) == _search_doc(j) and not t.traces
    assert t.inspected_blocks == t.inspected_bytes == 0
    assert jrc.rc_negative.value(kind="search") - n0[0] == \
        trc.rc_negative.value(kind="search") - n0[1] == len(ids)
    # metrics: a veto only where nothing was inspected
    q = "{ resource.service.name = `no-such-svc` } | rate()"
    m0 = (jrc.rc_negative.value(kind="metrics"), trc.rc_negative.value(kind="metrics"))
    for _ in range(2):
        j = jq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
        t = tq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
        assert j == t and t["series"] == []
    assert jrc.rc_negative.value(kind="metrics") - m0[0] == \
        trc.rc_negative.value(kind="metrics") - m0[1] == len(ids)


@pytest.mark.parametrize("spec", ["corrupt=1.0,seed=7", "short=1.0,seed=11"])
def test_damaged_entries_recompute(dbs, monkeypatch, spec):
    jq, tq = JQuerier(dbs.j), Querier(dbs.t)
    ids = _ids(dbs)
    q = "{ } | rate() by (resource.service.name)"
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "0")
    cold = tq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "force")
    for qr in (jq, tq):
        qr.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
    # armed after the DBs were built: only the result cache's fetch
    # seam injects, the backends stay clean
    monkeypatch.setenv("TEMPO_TPU_FAULTS", spec)
    c0 = (jrc.rc_corrupt.value(kind="metrics"), trc.rc_corrupt.value(kind="metrics"))
    j = jq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
    t = tq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
    assert t == j and t["series"] == cold["series"]
    assert t["stats"]["inspectedBytes"] > 0
    assert jrc.rc_corrupt.value(kind="metrics") - c0[0] == \
        trc.rc_corrupt.value(kind="metrics") - c0[1] == len(ids)


# ---------------------------------------------------------------------------
# one memcached shared by a JAX replica and a port replica
# ---------------------------------------------------------------------------


def test_entries_shared_across_packages_through_memcached(tmp_path, monkeypatch):
    srv = _FakeMemcached()
    pair = DBPair(tmp_path, cache="memcached", cache_options={"addresses": [srv.addr]})
    try:
        for i in range(2):
            pair.write(TENANT, _batch(720 + i, minute=i))
        ids = _ids(pair)
        jq, tq = JQuerier(pair.j), Querier(pair.t)
        q = "{ } | rate() by (resource.service.name)"
        monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "0")
        cold = tq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
        monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "force")
        # the JAX replica computes and stores; the port's hits all
        h0 = trc.rc_hits.value(kind="metrics")
        j = jq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
        t = tq.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)
        assert trc.rc_hits.value(kind="metrics") - h0 == len(ids)
        assert t["series"] == j["series"] == cold["series"]
        assert t["stats"].get("inspectedBytes", 0) == 0
        # the port computes and stores a search; the JAX replica's hits
        h0 = jrc.rc_hits.value(kind="search")
        t = tq.search_block_batch(TENANT, ids, SearchRequest(tags={"service": "cart"}, limit=100))
        j = jq.search_block_batch(TENANT, ids, JRequest(tags={"service": "cart"}, limit=100))
        assert jrc.rc_hits.value(kind="search") - h0 == len(ids)
        assert _traces(t) == _traces(j) and t.traces
        assert any(k.startswith("rc1|qs1|t|") for k in srv.data)
    finally:
        for db in (pair.j, pair.t):
            db.shutdown()
        srv.close()


def test_wedged_memcached_degrades_to_a_miss():
    """A server that accepts and never answers costs at most two socket
    timeouts and reads as a miss; the querier is never wedged."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    conns = []

    def hang():
        try:
            while True:
                conns.append(srv.accept()[0])
        except OSError:
            pass

    threading.Thread(target=hang, daemon=True).start()
    try:
        mc = MemcachedCache(["127.0.0.1:%d" % srv.getsockname()[1]], timeout_s=0.15)
        rc = trc.ResultCache(trc.ResultCacheConfig(enabled=True), remote=mc)
        t0 = time.monotonic()
        assert rc.get("t", "b", "search", trc.fingerprint("q")) is None
        assert time.monotonic() - t0 < 1.5
        rc.put("t", "b", "search", trc.fingerprint("q"), {"traces": []})  # must not raise
        mc.stop()
    finally:
        srv.close()
        for c in conns:
            c.close()


# ---------------------------------------------------------------------------
# the standing rebuild's row log
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("query", ["{ } | rate() by (resource.service.name)",
                                   "{ } | histogram_over_time(duration)",
                                   "{ status = error } | count_over_time() by (name)"])
def test_standing_row_log_replays_at_any_window(tmp_path, monkeypatch, query):
    """One row log serves rebuilds at every window: a miss at one window
    lo, a hit at another, each equal to the cold rebuild at its window
    and to the JAX package's."""
    pair = DBPair(tmp_path)
    try:
        base = BASE_S
        # each block spans three minutes, so a window lo inside a block
        # drops some of its step-partial rows and keeps others
        for i in range(4):
            pair.write(TENANT, SpanBatch.concat(
                [_batch(740 + 10 * i + k, minute=3 * i + k, n=12) for k in range(3)]
            ).sorted_by_trace())
        engines = (jengine.StandingEngine(), tengine.StandingEngine(device="cpu"))
        engines[0].attach(db=pair.j)
        engines[1].attach(db=pair.t)
        qs = (jengine.StandingQuery("q1", TENANT, query, 60, 3600, None, 64),
              tengine.StandingQuery("q1", TENANT, query, 60, 3600, None, 64))
        assert tengine.rc_fingerprint(qs[1]) == jengine.rc_fingerprint(qs[0])
        metas = list(pair.t.blocklist.metas(TENANT))

        def rebuild(w_lo):
            out = []
            for eng, q, db in zip(engines, qs, (pair.j, pair.t)):
                counts = {}
                series = type(q.series)(q.max_series)
                n, ok = eng._rebuild_blocks(q, list(db.blocklist.metas(TENANT)), w_lo,
                                            counts, series)
                out.append((n, ok, counts, dict(series.slots)))
            assert out[1] == out[0]
            return out[1]

        windows = (base + 250, base + 100, base + 430, base - 60)
        monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "0")
        cold = [rebuild(w) for w in windows]
        assert all(c[2] for c in cold) and len({json.dumps(sorted(c[2].items())) for c in cold}) >= 3
        monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "force")
        stored: set = set()
        for w, want in zip(windows, cold):
            c0 = _rc_counts(trc, "standing")
            assert rebuild(w) == want
            eligible = {m.block_id for m in metas if m.end_time >= w}
            got = _delta(_rc_counts(trc, "standing"), c0)
            assert (got[0], got[3]) == (len(eligible & stored), len(eligible - stored))
            stored |= eligible
        assert stored == {m.block_id for m in metas}
    finally:
        for db in (pair.j, pair.t):
            db.shutdown()


def test_standing_reads_equal_with_the_cache_off_missing_and_hitting(tmp_path, monkeypatch):
    pair = StandingPair(tmp_path, generator_enabled=False)
    try:
        base = (int(time.time()) // 60) * 60 - 600
        pair.push(12, 5, 4, base)
        pair.cut()
        pair.flush()
        body = {"q": "{ } | rate() by (resource.service.name)", "step": 60, "window": 3600}
        reads = []
        for env in ("0", "force", "force"):
            monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", env)
            ids = pair.register(body)
            reads.append(pair.read(ids, base - 60, base + 120))
            for app, qid in zip(pair.apps, ids):
                app.standing_delete(qid)
        assert reads[0] and reads[0] == reads[1] == reads[2]
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# the frontend's verdict on the insights record
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fields", [
    {"result_cache_hits": 3}, {"result_cache_misses": 1, "result_cache_stores": 1},
    {"result_cache_misses": 1}, {"result_cache_hits": 2, "result_cache_misses": 1,
                                 "result_cache_stores": 1},
    {"result_cache_negative": 4}, {"result_cache_hits": 1, "result_cache_negative": 2},
    {"inspected_bytes": 10}], ids=lambda f: ",".join(sorted(f)))
def test_insights_verdict_equal(fields):
    recs = []
    for front, ins, use in ((JFrontend, jinsights, jusage), (Frontend, insights, usage)):
        with ins.LOG.observe("t", "search", "{}") as rec:
            with use.collect():
                front._merge_stage_wires([{"usage": fields}])
            recs.append(rec.get("resultCache"))
    assert recs[1] == recs[0]

