"""The DB and querier mesh arms of the port against the JAX package's,
both at the default compaction_device_shards=0: the JAX TempoDB meshes
its 8 virtual CPU devices, and the port's TempoDB(device="cpu") meshes
the 8 CPU devices its seam (parallel/mesh.local_devices, monkeypatched)
reports — as a host with several cards meshes them by default.

Search over blocks (one request, and search_multi's batched scan),
compact_once (output blocks byte for byte), and the querier's
search_block_batch, search_block_batch_multi, search_multi,
query_range_blocks and query_range_blocks_multi, answers compared
exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from tempo_tpu.encoding.common import SearchRequest as JRequest
from tempo_tpu.modules.querier import Querier as JQuerier
from tempo_tpu.util import devicetiming as jdt
from tempo_tpu_torch.encoding.common import SearchRequest
from tempo_tpu_torch.modules.querier import Querier
from tempo_tpu_torch.parallel import mesh as pmesh
from tempo_tpu_torch.util import devicetiming as tdt
from tempo_tpu_torch.util import metrics as tmetrics

from test_torch_blocks import block_objects
from test_torch_db import T0, DBPair, _clear_caches, _split_overlapping
from test_torch_search import clustered_batch

CPU = torch.device("cpu")


@pytest.fixture
def pair(tmp_path, monkeypatch):
    monkeypatch.setattr(pmesh, "local_devices", lambda device: [CPU] * 8)
    p = DBPair(tmp_path, compaction_device_shards=0)
    try:
        yield p
    finally:
        p.j.shutdown()
        p.t.shutdown()


def _same_response(j, t, what=""):
    assert t.to_dict() == j.to_dict(), what
    assert [dataclasses.astuple(h) for h in t.traces] == \
        [dataclasses.astuple(h) for h in j.traces], what


def _three_blocks(pair):
    return [pair.write("tenant", clustered_batch(seed)) for seed in (7, 8, 9)]


def test_default_db_meshes_every_local_device(pair):
    jm, tm = pair.j.compaction_mesh(), pair.t.compaction_mesh()
    assert (tm.shape["window"], tm.shape["range"]) == (jm.shape["window"], jm.shape["range"]) \
        == (1, 8)
    assert pair.t.compaction_options().mesh is tm
    assert pair.t.mesh_searcher().mesh is tm and pair.t.mesh_metrics_evaluator().mesh is tm


SEARCHES = [
    dict(tags={"service": "alpha"}, limit=0),
    dict(tags={"service": "beta"}, limit=20),
    dict(tags={"name": "op-c", "service": "gamma"}, limit=0),
    dict(tags={"http.url": "http://svc/7"}, limit=0),
    dict(min_duration_ns=10**8, limit=20),
]


def test_db_search_routes_over_the_mesh(pair):
    _three_blocks(pair)
    d0 = tdt.dispatch_total.total(kernel="mesh_rle_scan") + \
        tdt.dispatch_total.total(kernel="mesh_scan")
    for kw in SEARCHES:
        _clear_caches()
        _same_response(pair.j.search("tenant", JRequest(**kw)),
                       pair.t.search("tenant", SearchRequest(**kw)), kw)
    assert tdt.dispatch_total.total(kernel="mesh_rle_scan") + \
        tdt.dispatch_total.total(kernel="mesh_scan") > d0


def test_db_search_multi_is_one_batched_scan(pair):
    _three_blocks(pair)
    # all-rle units (the batched scan launches); then a batch whose
    # non-rle column sends its units to the host scan
    for reqs, batched in ((SEARCHES[:3], True), (SEARCHES[2:], False)):
        _clear_caches()
        b0 = tdt.dispatch_total.total(kernel="batched_rle_scan")
        jb0 = jdt.dispatch_total.total(kernel="batched_rle_scan")
        jout = pair.j.search_multi("tenant", [JRequest(**kw) for kw in reqs])
        tout = pair.t.search_multi("tenant", [SearchRequest(**kw) for kw in reqs])
        assert len(tout) == len(reqs)
        for j, t in zip(jout, tout):
            _same_response(j, t)
        launched = tdt.dispatch_total.total(kernel="batched_rle_scan") - b0
        assert launched == jdt.dispatch_total.total(kernel="batched_rle_scan") - jb0
        assert (launched > 0) == batched
    assert "tempo_tpu_batched_query_lanes_total" in tmetrics.expose()


def test_compact_once_over_the_mesh_matches_jax(pair):
    a, b = _split_overlapping(seed=12)
    pair.write("tenant", a)
    pair.write("tenant", b)
    assert pair.j.compact_once("tenant") == pair.t.compact_once("tenant") == 1
    (jm,), (tm,) = pair.j.blocklist.metas("tenant"), pair.t.blocklist.metas("tenant")
    jo = block_objects(pair.jroot + "/blocks", "tenant", jm.block_id)
    to = block_objects(pair.troot + "/blocks", "tenant", tm.block_id)
    assert sorted(jo) == sorted(to) and [k for k in jo if jo[k] != to[k]] == []
    assert tdt.STATS.h2d.get("mesh_compaction", 0) > 0


def test_querier_search_arms_match_jax(pair):
    metas = _three_blocks(pair)
    ids = [m.block_id for m in metas]
    jq, tq = JQuerier(pair.j), Querier(pair.t)
    for kw in SEARCHES:
        _clear_caches()
        _same_response(jq.search_block_batch("tenant", ids, JRequest(**kw)),
                       tq.search_block_batch("tenant", ids, SearchRequest(**kw)), kw)
    _clear_caches()
    jout = jq.search_block_batch_multi("tenant", ids, [JRequest(**kw) for kw in SEARCHES])
    tout = tq.search_block_batch_multi("tenant", ids, [SearchRequest(**kw) for kw in SEARCHES])
    assert len(tout) == len(SEARCHES)
    for j, t in zip(jout, tout):
        _same_response(j, t)
    _clear_caches()
    jout = jq.search_multi("tenant", [JRequest(**kw) for kw in SEARCHES[:3]])
    tout = tq.search_multi("tenant", [SearchRequest(**kw) for kw in SEARCHES[:3]])
    for j, t in zip(jout, tout):
        _same_response(j, t)
    assert tq.search_multi("tenant", []) == [] == tq.search_block_batch_multi("tenant", ids, [])


QUERIES = [
    "{ } | quantile_over_time(duration, 0.5, 0.9) by (resource.service.name)",
    "{ status = error } | count_over_time() by (name)",
    "{ } | rate() by (resource.service.name)",  # the step-partial rule claims it
    "{ } | rate()",  # the compiled tier claims it
]


def test_querier_query_range_arms_match_jax(pair):
    metas = _three_blocks(pair)
    ids = [m.block_id for m in metas]
    jq, tq = JQuerier(pair.j), Querier(pair.t)
    b0 = tdt.dispatch_total.total(kernel="mesh_bincount")
    jb0 = jdt.dispatch_total.total(kernel="mesh_bincount")
    for q in QUERIES:
        j = jq.query_range_blocks("tenant", ids, q, T0, T0 + 600, 60)
        t = tq.query_range_blocks("tenant", ids, q, T0, T0 + 600, 60)
        assert t == j, q
    assert tdt.dispatch_total.total(kernel="mesh_bincount") - b0 == \
        jdt.dispatch_total.total(kernel="mesh_bincount") - jb0 > 0
    j = jq.query_range_blocks_multi("tenant", ids, QUERIES, T0, T0 + 600, 60)
    t = tq.query_range_blocks_multi("tenant", ids, QUERIES, T0, T0 + 600, 60)
    assert t == j
