"""The port's storage engine (TempoDB) against the JAX package's.

Each test runs one of tests/test_db.py's engine flows on both packages
side by side: the same seeded batches are written by the JAX package's
TempoDB and by the port's TempoDB(device="cpu") under the same block
IDs, and every answer is compared exactly — found traces, search
responses field by field, TraceQL results on both the vectorized branch
and the object engine, tag sets, blocklists, and the bytes of blocks
written by write_batch, write_wal_block and compact_once. The one
`cuda` test runs the flow with device="cuda" against device="cpu".
Where bytes carry gzip's header clock (a WAL segment's dictionary), the
test pins that clock for both packages."""

import gzip
import json
import os
import struct
import time
import types
import uuid

import numpy as np
import pytest
import torch

from tempo_tpu.backend import MockBackend as JMock
from tempo_tpu.db import DBConfig as JDBConfig, TempoDB as JTempoDB
from tempo_tpu.db.compaction import (
    CompactionConfig as JCompactionConfig,
    TimeWindowBlockSelector as JSelector,
)
from tempo_tpu.db.pool import JobPool as JJobPool
from tempo_tpu.encoding.common import BlockConfig as JBlockConfig, SearchRequest as JRequest
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.traceql import ast_nodes as JA
from tempo_tpu.util import pipeline as jpipeline
from tempo_tpu_torch import encoding
from tempo_tpu_torch.backend import MockBackend, make_raw_backend
from tempo_tpu_torch.backend.base import BlockMeta, DataName
from tempo_tpu_torch.db import DBConfig, TempoDB
from tempo_tpu_torch.db.compaction import CompactionConfig, TimeWindowBlockSelector
from tempo_tpu_torch.db.pool import JobPool
from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage
from tempo_tpu_torch.encoding.vtpu.format import MAGIC
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model import trace as tr
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.traceql import ast_nodes as A
from tempo_tpu_torch.util import pipeline

from test_torch_blocks import block_objects, to_jax
from test_torch_search import chain_parents

T0 = 1_700_000_000
BLOCK = {"row_group_spans": 256}


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    monkeypatch.setattr(jpipeline, "overlap_enabled", lambda: False)
    monkeypatch.setattr(pipeline, "overlap_enabled", lambda: False)


def _clear_caches():
    for cache in (jcolcache.shared_cache(), colcache.shared_cache()):
        if cache is not None:
            cache.clear()


class DBPair:
    """The JAX package's TempoDB and the port's over two local dirs."""

    def __init__(self, root, block=None, compaction=None, **kw):
        block = dict(BLOCK, **(block or {}))
        compaction = compaction or {}
        self.jroot, self.troot = str(root / "jax"), str(root / "port")
        # one device on both sides: the JAX package's tests run on an
        # 8-device CPU mesh, the port's CPU DB sees one device (the mesh
        # arms: tests/test_torch_mesh.py)
        self.kw = dict(kw, block=block, compaction=compaction)
        self.kw.setdefault("compaction_device_shards", 1)
        self.j = self.open_jax()
        self.t = self.open_port()

    def open_jax(self):
        kw = dict(self.kw)
        return JTempoDB(JDBConfig(backend="local", backend_path=self.jroot + "/blocks",
                                  wal_path=self.jroot + "/wal",
                                  block=JBlockConfig(**kw.pop("block")),
                                  compaction=JCompactionConfig(**kw.pop("compaction")), **kw))

    def open_port(self, device="cpu"):
        kw = dict(self.kw)
        return TempoDB(DBConfig(backend="local", backend_path=self.troot + "/blocks",
                                wal_path=self.troot + "/wal",
                                block=BlockConfig(**kw.pop("block")),
                                compaction=CompactionConfig(**kw.pop("compaction")), **kw),
                       device=device)

    def write(self, tenant, batch: SpanBatch):
        bid = str(uuid.uuid4())
        jm = self.j.write_batch(tenant, to_jax(batch), block_id=bid)
        tm = self.t.write_batch(tenant, batch, block_id=bid)
        assert jm.to_json() == tm.to_json()
        return tm

    def write_traces(self, tenant, traces):
        return self.write(tenant, tr.traces_to_batch(traces).sorted_by_trace())

    def objects(self, tenant, block_id):
        return (block_objects(self.jroot + "/blocks", tenant, block_id),
                block_objects(self.troot + "/blocks", tenant, block_id))

    def ids(self, tenant):
        return ([m.block_id for m in self.j.blocklist.metas(tenant)],
                [m.block_id for m in self.t.blocklist.metas(tenant)])


def _same_ids(pair, tenant):
    j, t = pair.ids(tenant)
    assert sorted(j) == sorted(t)
    return t


def _trace(t):
    """A trace in a form that does not depend on the order in which the
    pool's block jobs finished (combine_traces keeps part order)."""
    if t is None:
        return None
    return t.trace_id, sorted(repr((sorted(r.items()), s)) for r, spans in t.batches
                              for s in spans)


def _batch(seed, n_traces=120, spans=5, minute=0):
    b = synth.make_batch(n_traces, spans, seed=seed, base_time_ns=(T0 + 60 * minute) * 10**9)
    return chain_parents(b)


def _split_overlapping(seed=1):
    """Two batches that share every 4th trace (the replication-factor
    copies that straddle blocks before compaction)."""
    a = _batch(seed, minute=0)
    _, seg = a.trace_boundaries()
    b = SpanBatch.concat([_batch(seed + 50, minute=1),
                          a.select(np.flatnonzero(seg % 4 == 0))]).sorted_by_trace()
    return a, b


# ---------------------------------------------------------------- find


def test_find_across_blocks_and_missing(tmp_path):
    pair = DBPair(tmp_path)
    t1, t2 = synth.make_traces(10, seed=1), synth.make_traces(10, seed=2)
    pair.write_traces("tenant", t1)
    pair.write_traces("tenant", t2)
    for t in (t1[3], t2[7]):
        got = pair.t.find("tenant", t.trace_id)
        assert got.span_count() == t.span_count()
        assert _trace(got) == _trace(pair.j.find("tenant", t.trace_id))
    assert pair.t.find("tenant", b"\x99" * 16) is None is pair.j.find("tenant", b"\x99" * 16)


def test_find_combines_partial_traces(tmp_path):
    pair = DBPair(tmp_path)
    t = synth.make_trace(seed=3, n_spans=10)
    spans = list(t.all_spans())
    resource = t.batches[0][0]
    pair.write_traces("tenant", [tr.Trace(trace_id=t.trace_id, batches=[(resource, spans[:6])])])
    pair.write_traces("tenant", [tr.Trace(trace_id=t.trace_id, batches=[(resource, spans[4:])])])
    got = pair.t.find("tenant", t.trace_id)
    assert got.span_count() == 10
    assert _trace(got) == _trace(pair.j.find("tenant", t.trace_id))


def test_tenant_isolation_and_shard_range_pruning(tmp_path):
    pair = DBPair(tmp_path)
    traces = synth.make_traces(10, seed=6)
    pair.write_traces("a", traces)
    tid = traces[0].trace_id
    assert pair.t.find("b", tid) is None is pair.j.find("b", tid)
    hex_id = tid.hex()
    below = format(int(hex_id, 16) - 1, "032x")
    for db in (pair.j, pair.t):
        assert db.find("a", tid, block_start="0" * 32, block_end=below) is None
        assert db.find("a", tid, block_start=hex_id, block_end="f" * 32) is not None
    # time filtering: a window after the block excludes it
    assert pair.t.find("a", tid, time_start=4_000_000_000) is None


# -------------------------------------------------------------- search

DB_SEARCHES = [
    dict(tags={"service": "cart"}, limit=0),
    dict(tags={"service": "frontend", "name": "db.query"}, limit=0),
    dict(tags={"http.status_code": "500"}, limit=0),
    dict(tags={"region": "v7"}, limit=0),
    dict(min_duration_ns=9 * 10**8, limit=0),
    dict(start_seconds=T0 + 30, end_seconds=T0 + 70, limit=0),
    dict(tags={"service": "no-such-service"}, limit=0),
]


@pytest.mark.parametrize("i", range(len(DB_SEARCHES)))
def test_search_across_blocks_matches_jax(tmp_path, i):
    pair = DBPair(tmp_path)
    a, b = _split_overlapping()
    pair.write("tenant", a)
    pair.write("tenant", b)
    _clear_caches()
    for phase in ("cold", "warm"):
        j = pair.j.search("tenant", JRequest(**DB_SEARCHES[i]))
        t = pair.t.search("tenant", SearchRequest(**DB_SEARCHES[i]))
        assert t.to_dict() == j.to_dict(), phase
    # a search_multi of the request is one search
    assert pair.t.search_multi("tenant", [SearchRequest(**DB_SEARCHES[i])] * 2)[1].to_dict() == \
        t.to_dict()


def test_concurrent_searches_share_the_column_cache_safely(tmp_path):
    """More threads than cores search one DB at once (the shared column
    cache and the per-block tag memo under contention, with a short
    switch interval): every answer equals the single-threaded one."""
    import sys
    import threading

    pair = DBPair(tmp_path)
    a, b = _split_overlapping(seed=95)
    pair.write("tenant", a)
    pair.write("tenant", b)
    reqs = [SearchRequest(**kw) for kw in DB_SEARCHES]
    want = [[h.to_dict() for h in pair.t.search("tenant", r).traces] for r in reqs]
    tags = pair.t.search_tag_values("tenant", "region")
    errors, done = [], []

    def worker(k):
        try:
            for i in range(len(reqs)):
                j = (i + k) % len(reqs)
                if k % 3 == 0:
                    colcache.shared_cache().clear()
                got = [h.to_dict() for h in pair.t.search("tenant", reqs[j]).traces]
                assert got == want[j], j
                assert pair.t.search_tag_values("tenant", "region") == tags
            done.append(k)
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n = min(len(os.sched_getaffinity(0)), 16) + 2
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:1]
    assert not any(t.is_alive() for t in threads) and len(done) == len(threads)


def test_search_early_stop(tmp_path):
    pair = DBPair(tmp_path, pool_workers=1)
    for k in range(4):
        pair.write("tenant", _batch(10 + k, minute=k))
    full = {h.trace_id_hex for h in pair.t.search(
        "tenant", SearchRequest(tags={"service": "cart"}, limit=0)).traces}
    for db, req in ((pair.j, JRequest), (pair.t, SearchRequest)):
        resp = db.search("tenant", req(tags={"service": "cart"}, limit=5))
        assert len(resp.traces) == 5 and {h.trace_id_hex for h in resp.traces} <= full


@pytest.mark.parametrize("start,count", [(0, 0), (1, 2)])
def test_search_block_matches_jax(tmp_path, start, count):
    pair = DBPair(tmp_path)
    meta = pair.write("tenant", _batch(3))
    kw = dict(tags={"name": "db.query"}, limit=0)
    _clear_caches()
    j = pair.j.search_block("tenant", meta.block_id, JRequest(**kw), start, count)
    t = pair.t.search_block("tenant", meta.block_id, SearchRequest(**kw), start, count)
    assert t.to_dict() == j.to_dict() and t.traces


def test_search_tags_and_values_match_jax(tmp_path):
    pair = DBPair(tmp_path)
    a, b = _split_overlapping()
    pair.write("tenant", a)
    pair.write("tenant", b)
    names = pair.t.search_tags("tenant")
    assert names == pair.j.search_tags("tenant") and "region" in names
    for tag in ("service.name", "http.status_code", "region", "no-such-tag"):
        assert pair.t.search_tag_values("tenant", tag) == pair.j.search_tag_values("tenant", tag)
    # the per-block memo answers a second call alike
    assert pair.t.search_tag_values("tenant", "region") == pair.j.search_tag_values("tenant",
                                                                                    "region")


def test_fetch_candidates_across_blocks_matches_jax(tmp_path):
    pair = DBPair(tmp_path)
    a, b = _split_overlapping()
    pair.write("tenant", a)
    pair.write("tenant", b)
    conds = [("intrinsic", "duration", ">", 99 * 10**7)]
    jstats, tstats = {}, {}
    _clear_caches()
    j = pair.j.fetch_candidates("tenant", JA.FetchSpec([JA.Condition(*c) for c in conds]),
                                stats=jstats)
    t = pair.t.fetch_candidates("tenant", A.FetchSpec([A.Condition(*c) for c in conds]),
                                stats=tstats)
    assert sorted(map(_trace, t)) == sorted(map(_trace, j)) and t
    assert tstats == jstats


# ------------------------------------------------------------- TraceQL

VECTOR_QUERIES = [
    '{ resource.service.name = "cart" && duration > 100ms }',
    '{ span.http.status_code = 500 } | count() > 1',
    '{ } | by(resource.service.name)',
    '{ name = "db.query" } | avg(duration) > 500ms',
    '{ duration > 900ms } > { }',
]


@pytest.mark.parametrize("query", VECTOR_QUERIES)
@pytest.mark.parametrize("limit", [0, 20])
def test_traceql_vectorized_branch_matches_jax(tmp_path, query, limit):
    pair = DBPair(tmp_path)
    pair.write("tenant", _batch(21))
    pair.write("tenant", _batch(22, minute=1))
    jstats, tstats = {}, {}
    _clear_caches()
    j = pair.j.traceql_search("tenant", query, limit=limit, stats=jstats)
    t = pair.t.traceql_search("tenant", query, limit=limit, stats=tstats)
    assert [r.to_dict() for r in t] == [r.to_dict() for r in j] and t
    assert tstats == jstats
    assert "prunedRowGroups" not in tstats  # the vectorized branch ran


STRUCTURAL = '{ duration > 950ms } >> { duration < 60ms }'


def test_traceql_object_engine_on_straddling_traces_matches_jax(tmp_path):
    """A structural query over traces that straddle two blocks takes the
    object engine; after compaction the same query takes the vectorized
    branch and returns the same traces."""
    pair = DBPair(tmp_path)
    a, b = _split_overlapping(seed=5)
    pair.write("tenant", a)
    pair.write("tenant", b)
    jstats, tstats = {}, {}
    _clear_caches()
    j = pair.j.traceql_search("tenant", STRUCTURAL, limit=0, stats=jstats)
    t = pair.t.traceql_search("tenant", STRUCTURAL, limit=0, stats=tstats)
    assert [r.to_dict() for r in t] == [r.to_dict() for r in j] and t
    assert tstats == jstats and "prunedRowGroups" in tstats  # the object engine ran
    assert pair.j.compact_once("tenant") == pair.t.compact_once("tenant") == 1
    after = {}
    v = pair.t.traceql_search("tenant", STRUCTURAL, limit=0, stats=after)
    assert "prunedRowGroups" not in after
    assert sorted(r.trace_id_hex for r in v) == sorted(r.trace_id_hex for r in t)


def test_traceql_object_engine_on_unsupported_shape_matches_jax(tmp_path):
    """Attribute values of mixed types under one key make the vectorized
    branch bail out (Unsupported): the object engine answers."""
    pair = DBPair(tmp_path)
    pair.write("tenant", _batch(31))
    q = '{ span.region = "v7" || span.retry.count = "v9" }'
    jstats, tstats = {}, {}
    j = pair.j.traceql_search("tenant", q, limit=0, stats=jstats)
    t = pair.t.traceql_search("tenant", q, limit=0, stats=tstats)
    assert [r.to_dict() for r in t] == [r.to_dict() for r in j] and t
    assert tstats == jstats and "prunedRowGroups" in tstats


# ------------------------------------------------- maintenance and WAL


def test_poll_discovers_blocks_and_tenant_index(tmp_path):
    pair = DBPair(tmp_path, build_tenant_index=True)
    pair.write_traces("t1", synth.make_traces(3, seed=9))
    pair.write_traces("t2", synth.make_traces(3, seed=10))
    pair.t.poll_now()  # the builder writes index.json.gz
    fresh = pair.open_port()
    assert fresh.blocklist.tenants() == []
    fresh.poll_now()
    assert sorted(fresh.blocklist.tenants()) == ["t1", "t2"]
    reader = TempoDB(DBConfig(backend="local", backend_path=pair.troot + "/blocks"),
                     device="cpu")
    reader.poll_now()  # not a builder: reads the index
    assert len(reader.blocklist.metas("t1")) == 1
    pair.j.poll_now()
    assert sorted(pair.j.blocklist.tenants()) == sorted(fresh.blocklist.tenants())


def test_compact_two_blocks_matches_jax(tmp_path):
    pair = DBPair(tmp_path)
    a, b = _split_overlapping(seed=12)
    pair.write("tenant", a)
    pair.write("tenant", b)
    assert pair.j.compact_once("tenant") == pair.t.compact_once("tenant") == 1
    (jm,), (tm,) = pair.j.blocklist.metas("tenant"), pair.t.blocklist.metas("tenant")
    assert tm.compaction_level == 1 and tm.total_objects == jm.total_objects
    jo = block_objects(pair.jroot + "/blocks", "tenant", jm.block_id)
    to = block_objects(pair.troot + "/blocks", "tenant", tm.block_id)
    assert [k for k in jo if jo[k] != to.get(k)] == [] and sorted(jo) == sorted(to)
    assert len(pair.t.blocklist.compacted_metas("tenant")) == 2
    assert pair.t.compactor_driver.metrics.jobs == 1
    firsts, _ = a.trace_boundaries()
    tid = a.cols["trace_id"][firsts[0]].astype(">u4").tobytes()
    assert _trace(pair.t.find("tenant", tid)) == _trace(pair.j.find("tenant", tid))


def test_compaction_sweep_many_blocks(tmp_path):
    pair = DBPair(tmp_path)
    for i in range(6):
        pair.write_traces("tenant", synth.make_traces(4, seed=100 + i))
    for db in (pair.j, pair.t):
        for _ in range(10):
            if db.compact_once("tenant") == 0:
                break
    jm, tm = pair.j.blocklist.metas("tenant"), pair.t.blocklist.metas("tenant")
    assert len(tm) == len(jm) < 6
    assert sum(m.total_objects for m in tm) == sum(m.total_objects for m in jm) == 24


def test_selector_groups_match_jax():
    from tempo_tpu.backend.base import BlockMeta as JBlockMeta

    now = int(time.time())
    spec = [(now, 10, 100), (now, 10, 100), (now - 7200, 5, 10), (now - 7200, 20, 10),
            (now - 7300, 1, 1), (now, 9, 100), (now, 4, 1)]
    for cfg in (dict(window_s=3600, max_input_blocks=4), dict(window_s=3600, max_objects=15),
                dict(window_s=600, max_bytes=150)):
        jm = [JBlockMeta(tenant_id="t", block_id=f"b{i}", end_time=e, total_objects=o,
                         size_bytes=s, min_id=format(i, "032x")) for i, (e, o, s) in enumerate(spec)]
        tm = [BlockMeta(tenant_id="t", block_id=f"b{i}", end_time=e, total_objects=o,
                        size_bytes=s, min_id=format(i, "032x")) for i, (e, o, s) in enumerate(spec)]
        jsel, tsel = JSelector(jm, JCompactionConfig(**cfg)), TimeWindowBlockSelector(
            tm, CompactionConfig(**cfg))
        while True:
            (jg, jh), (tg, th) = jsel.blocks_to_compact(), tsel.blocks_to_compact()
            assert [m.block_id for m in tg] == [m.block_id for m in jg] and th == jh
            if not tg:
                break


def test_two_phase_retention_matches_jax(tmp_path):
    pair = DBPair(tmp_path)
    pair.write_traces("tenant", synth.make_traces(3, seed=15, base_time_ns=10**9 * 1000))
    pair.write_traces("tenant", synth.make_traces(3, seed=16,
                                                  base_time_ns=int(time.time()) * 10**9))
    for db in (pair.j, pair.t):
        db.retain_once()  # phase 1: the ancient block is marked compacted
    assert len(_same_ids(pair, "tenant")) == 1
    assert len(pair.t.blocklist.compacted_metas("tenant")) == 1
    later = time.time() + pair.t.compaction_cfg.compacted_retention_s + 1
    for db in (pair.j, pair.t):
        db.retain_once(now=later)  # phase 2: its objects are cleared
        db.poll_now()
    assert pair.t.blocklist.compacted_metas("tenant") == []
    assert len(_same_ids(pair, "tenant")) == 1


def test_sweep_orphans_after_grace(tmp_path):
    pair = DBPair(tmp_path)
    meta = pair.write_traces("tenant", synth.make_traces(3, seed=17))
    for root in (pair.jroot, pair.troot):
        os.remove(os.path.join(root, "blocks", "tenant", meta.block_id, "meta.json"))
    for db in (pair.j, pair.t):
        assert db.sweep_orphans(grace_s=60, now=1000.0) == []  # first sighting
        assert db.sweep_orphans(grace_s=60, now=1100.0) == [("tenant", meta.block_id)]
    assert not os.path.exists(os.path.join(pair.troot, "blocks", "tenant", meta.block_id))


def test_transient_error_aborts_poll():
    db = TempoDB(DBConfig(backend="mock"), raw_backend=(raw := MockBackend()), device="cpu")
    db.write_batch("tenant", _batch(41))
    db.poll_now()
    assert len(db.blocklist.metas("tenant")) == 1
    raw.fail_every = 1
    with pytest.raises(OSError):
        db.poll_now()
    assert len(db.blocklist.metas("tenant")) == 1  # the previous list is kept
    jdb = JTempoDB(JDBConfig(backend="mock"), raw_backend=(jraw := JMock()))
    jdb.write_batch("tenant", to_jax(_batch(41)))
    jraw.fail_every = 1
    with pytest.raises(OSError):
        jdb.poll_now()


def _gzip_clock(monkeypatch, t: int) -> None:
    """Pin the time that gzip writes into each header (both packages gzip
    a WAL segment's dictionary with mtime = now)."""
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: t))


def test_wal_segments_differ_in_the_gzip_clock_alone(tmp_path, monkeypatch):
    """Why the segment comparison below pins gzip's clock: a segment ends
    in its gzipped dictionary, whose header holds the second it was
    written, so the same batch appended a second later differs in that
    header's mtime and nowhere else."""
    pair = DBPair(tmp_path)
    batch = _batch(60, n_traces=40)
    segs = []
    for db, b, t in ((pair.j, to_jax(batch), 1_700_000_000), (pair.t, batch, 1_700_000_001),
                     (pair.t, batch, 1_700_000_000)):
        _gzip_clock(monkeypatch, t)
        blk = db.wal.new_block("tenant")
        blk.append(b)
        (name,) = os.listdir(blk.path)
        with open(os.path.join(blk.path, name), "rb") as f:
            segs.append(f.read())
    jax_seg, later, same = segs
    assert same == jax_seg and len(later) == len(jax_seg)
    hlen = struct.unpack("<I", jax_seg[len(MAGIC):len(MAGIC) + 4])[0]
    dict_len = json.loads(jax_seg[len(MAGIC) + 4:len(MAGIC) + 4 + hlen])["dict_len"]
    mtime = len(jax_seg) - dict_len + 4  # gzip: magic, method, flags, then mtime (u32 LE)
    assert [i for i in range(len(later)) if later[i] != jax_seg[i]] == [mtime]
    assert struct.unpack("<I", later[mtime:mtime + 4])[0] == 1_700_000_001


def test_wal_append_replay_and_write_wal_block_match_jax(tmp_path, monkeypatch):
    # the segments' bytes hold gzip's clock: appends on either side of a
    # second's edge would differ there (the test above)
    _gzip_clock(monkeypatch, 1_700_000_000)
    pair = DBPair(tmp_path)
    parts = [_batch(60 + k, n_traces=40, minute=k) for k in range(3)]
    jblk, tblk = pair.j.wal.new_block("tenant"), pair.t.wal.new_block("tenant")
    for p in parts:
        jblk.append(to_jax(p))
        tblk.append(p)
    segs = sorted(os.listdir(tblk.path))
    assert len(segs) == 3 == tblk.num_segments()
    for name in segs:  # format.serialize_batch, byte for byte
        with open(os.path.join(tblk.path, name), "rb") as f, \
                open(os.path.join(jblk.path, name), "rb") as g:
            assert f.read() == g.read()
    # a restart replays the segments; a junk dir is skipped
    os.makedirs(os.path.join(pair.troot, "wal", "not-a-wal-block"))
    (found,) = pair.open_port().wal.rescan_blocks()
    assert (found.block_id, found.tenant, found.num_segments()) == (tblk.block_id, "tenant", 3)
    bid = str(uuid.uuid4())
    jm = pair.j.write_wal_block("tenant", jblk, block_id=bid)
    tm = pair.t.write_wal_block("tenant", found, block_id=bid)
    assert tm.total_spans == sum(p.num_spans for p in parts)
    ja, ta = pair.objects("tenant", bid)
    assert [k for k in ja if ja[k] != ta.get(k)] == [] and sorted(ja) == sorted(ta)


def test_wal_replay_skips_a_corrupt_segment(tmp_path):
    pair = DBPair(tmp_path)
    blk = pair.t.wal.new_block("tenant")
    for k in range(3):
        blk.append(_batch(70 + k, n_traces=20))
    with open(os.path.join(blk.path, "00000001.seg"), "r+b") as f:
        f.seek(40)
        f.write(b"\xde\xad\xbe\xef" * 8)
    keyed = [i for i, _ in blk.iter_batches_keyed()]
    assert keyed == [0, 2]
    assert blk.all_spans().num_spans == 2 * 20 * 5
    blk.append(_batch(73, n_traces=20))  # appends continue after the last segment
    assert sorted(os.listdir(blk.path))[-1] == "00000003.seg"


def test_quarantine_after_corrupt_pages_matches_jax(tmp_path):
    pair = DBPair(tmp_path, quarantine_threshold=3)
    bad = pair.write("tenant", _batch(81))
    pair.write("tenant", _batch(82, minute=1))
    for root in (pair.jroot, pair.troot):
        path = os.path.join(root, "blocks", "tenant", bad.block_id, DataName)
        with open(path, "r+b") as f:
            f.seek(100)
            f.write(b"\xff" * 64)
    req = dict(tags={"service": "cart"}, limit=0)
    for db, mk in ((pair.j, JRequest), (pair.t, SearchRequest)):
        _clear_caches()
        with pytest.raises(Exception) as err:
            db.search("tenant", mk(**req))
        assert type(err.value).__name__ == "CorruptPage"
        _clear_caches()
        with pytest.raises(Exception):
            db.search("tenant", mk(**req))
    assert set(pair.t.blocklist.quarantined("tenant")) == {bad.block_id} == \
        set(pair.j.blocklist.quarantined("tenant"))
    # quarantined: queries and the selector skip it
    _clear_caches()
    j = pair.j.search("tenant", JRequest(**req))
    t = pair.t.search("tenant", SearchRequest(**req))
    assert t.inspected_blocks == 1 and t.to_dict() == j.to_dict()
    assert pair.t.compact_once("tenant") == 0


def test_compaction_attributes_corruption_to_the_bad_input(tmp_path):
    pair = DBPair(tmp_path, quarantine_threshold=2)
    bad = pair.write("tenant", _batch(83))
    good = pair.write("tenant", _batch(84))
    path = os.path.join(pair.troot, "blocks", "tenant", bad.block_id, DataName)
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\xff" * 64)
    assert pair.t.compact_once("tenant") == 0
    assert pair.t.compactor_driver.metrics.errors == 1
    assert set(pair.t.blocklist.quarantined("tenant")) == {bad.block_id}
    assert [m.block_id for m in pair.t.blocklist.metas("tenant")] == [good.block_id]


def test_polling_thread_and_shutdown(tmp_path):
    db = TempoDB(DBConfig(backend="local", backend_path=str(tmp_path / "b"),
                          blocklist_poll_s=0.05), device="cpu")
    other = TempoDB(DBConfig(backend="local", backend_path=str(tmp_path / "b")), device="cpu")
    other.write_batch("tenant", _batch(90))
    db.enable_polling()
    deadline = time.time() + 10
    while not db.blocklist.metas("tenant") and time.time() < deadline:
        time.sleep(0.02)
    db.shutdown()
    assert len(db.blocklist.metas("tenant")) == 1 and db._poll_thread is None


def test_job_pool_early_exit_and_errors():
    for pool in (JobPool(4), JJobPool(4)):
        results, errors = pool.run_jobs([lambda i=i: i for i in range(10)],
                                        stop_when=lambda r: True)
        assert not errors and len(results) >= 1

        def bad():
            raise RuntimeError("boom")

        results, errors = pool.run_jobs([bad, lambda: 42])
        assert results == [42] and len(errors) == 1


def test_retry_taxonomy_and_loop_match_jax():
    from tempo_tpu.backend import faults as jfaults
    from tempo_tpu.backend.base import NotFound as JNotFound
    from tempo_tpu.encoding.vtpu.codec import CorruptPage as JCorruptPage
    from tempo_tpu.util import deadline as jdeadline, resource as jresource
    from tempo_tpu_torch.backend import faults
    from tempo_tpu_torch.backend.base import NotFound
    from tempo_tpu_torch.util import deadline, resource

    pairs = [(IOError("x"), IOError("x")), (ConnectionError(), ConnectionError()),
             (TimeoutError(), TimeoutError()), (ValueError(), ValueError()),
             (KeyError(), KeyError()), (PermissionError(), PermissionError()),
             (RuntimeError(), RuntimeError()), (JNotFound(), NotFound()),
             (JCorruptPage("c"), CorruptPage("c")),
             (jdeadline.DeadlineExceeded(), deadline.DeadlineExceeded()),
             (jresource.ResourceExhausted("shed", 1.0), resource.ResourceExhausted("shed", 1.0))]
    for je, te in pairs:
        assert faults.retryable_error(te) == jfaults.retryable_error(je), type(te).__name__
    for mod, transient, terminal in ((faults, IOError, NotFound), (jfaults, IOError, JNotFound)):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise transient("reset")
            return "ok"

        assert mod.with_retries(flaky, backoff_s=0.001) == "ok" and len(calls) == 3
        calls.clear()

        def missing():
            calls.append(1)
            raise terminal("gone")

        with pytest.raises(terminal):
            mod.with_retries(missing, backoff_s=0.001)
        assert len(calls) == 1


# ------------------------------------------------------- what is refused


def test_unported_paths_raise(tmp_path, monkeypatch):
    """Nothing refuses now: vrow1, the cloud backends (a cloud backend
    without its bucket or container raises the reference's ValueError)
    and the mesh are ported — compaction_device_shards=2 meshes two of
    the local devices, and on one device there is no mesh, as in the
    reference (want = min(n, available))."""
    from tempo_tpu.backend import make_raw_backend as jmake_raw_backend

    assert encoding.from_version("vrow1").version == "vrow1"
    with pytest.raises(ValueError):
        encoding.from_version("v9")
    assert encoding.from_version(encoding.DEFAULT_ENCODING).version == "vtpu1"
    for kind in ("s3", "gcs", "azure"):
        with pytest.raises(ValueError) as e:
            make_raw_backend(kind)
        with pytest.raises(ValueError) as je:
            jmake_raw_backend(kind)
        assert str(e.value) == str(je.value)
    cached = TempoDB(DBConfig(backend="mock", cache="memory"), device="cpu")
    assert type(cached.backend.raw).__name__ == "CachedBackend"
    cached.shutdown()
    db = TempoDB(DBConfig(backend="mock", compaction_device_shards=2), device="cpu")
    for method in (db.compaction_mesh, db.mesh_searcher, db.mesh_metrics_evaluator):
        assert method() is None
    one = TempoDB(DBConfig(backend="mock"), device="cpu")
    assert one.compaction_mesh() is None and one.compaction_options().mesh is None
    from tempo_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "local_devices", lambda device: [torch.device("cpu")] * 8)
    two = TempoDB(DBConfig(backend="mock", compaction_device_shards=2), device="cpu")
    assert two.compaction_mesh().shape == {"window": 1, "range": 2}
    assert two.mesh_searcher().mesh is two.compaction_options().mesh
    assert two.mesh_metrics_evaluator().r == 2
    for d in (db, one, two):
        d.shutdown()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_tempodb_needs_cuda_unless_cpu_is_asked():
    with pytest.raises(RuntimeError):
        TempoDB(DBConfig(backend="mock"))
    assert TempoDB(DBConfig(backend="mock"), device="cpu").device == torch.device("cpu")


def test_block_failure_is_corrupt_page_weighted(tmp_path):
    db = TempoDB(DBConfig(backend="mock", quarantine_threshold=2), device="cpu")
    record = db.block_failure_recorder("t")
    record("b1", IOError("reset"))
    assert db.blocklist.quarantined("t") == {}
    record("b2", CorruptPage("crc"))  # weight 2: one checksum failure suffices
    assert set(db.blocklist.quarantined("t")) == {"b2"}


@pytest.mark.cuda
def test_db_flow_on_cuda_matches_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pair = DBPair(tmp_path)
    cuda = TempoDB(DBConfig(backend="local", backend_path=str(tmp_path / "cuda"),
                            block=BlockConfig(**BLOCK)))
    assert cuda.device.type == "cuda" and cuda.device.index is not None
    a, b = _split_overlapping(seed=91)
    for batch in (a, b):
        bid = str(uuid.uuid4())
        cuda.write_batch("tenant", batch, block_id=bid)
        pair.t.write_batch("tenant", batch, block_id=bid)
        assert block_objects(str(tmp_path / "cuda"), "tenant", bid) == \
            block_objects(pair.troot + "/blocks", "tenant", bid)
    req = SearchRequest(tags={"service": "cart"}, limit=0)
    _clear_caches()  # the blocks share IDs, so the column cache is shared too
    on_cuda = cuda.search("tenant", req).to_dict()
    _clear_caches()
    assert on_cuda == pair.t.search("tenant", req).to_dict()
    assert cuda.compact_once("tenant") == pair.t.compact_once("tenant") == 1
    (cm,), (tm,) = cuda.blocklist.metas("tenant"), pair.t.blocklist.metas("tenant")
    assert block_objects(str(tmp_path / "cuda"), "tenant", cm.block_id) == \
        block_objects(pair.troot + "/blocks", "tenant", tm.block_id)
    assert [r.to_dict() for r in cuda.traceql_search("tenant", STRUCTURAL, limit=0)] == \
        [r.to_dict() for r in pair.t.traceql_search("tenant", STRUCTURAL, limit=0)]
