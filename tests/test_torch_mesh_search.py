"""The port's mesh search on a mesh of CPU devices against the JAX
package's MeshSearcher on its 8-device CPU mesh, exactly.

The sharded scan programs output for output (the NO_MATCH sentinel
never matches, padding and truncated runs as jnp.repeat gives them),
pack_predicates and stack_shards, then MeshSearcher.search_blocks and
search_blocks_multi over three blocks written byte-equal by both
packages: responses field by field and the searchers' per-job stats,
on (1, 4), (2, 2) and (1, 8) meshes, shipped and resident, and under
concurrent callers serialised by dispatch_lock."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tempo_tpu.encoding.common import SearchRequest as JRequest
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
from tempo_tpu.ops import bloom as jbloom
from tempo_tpu.parallel import search as jsearch
from tempo_tpu.util import devicetiming as jdt
from tempo_tpu.util import pipeline as jpipeline
from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.ops import bloom
from tempo_tpu_torch.parallel import mesh as tmesh
from tempo_tpu_torch.parallel import search as tsearch
from tempo_tpu_torch.util import devicetiming as tdt
from tempo_tpu_torch.util import pipeline

from test_torch_blocks import Pair
from test_torch_search import CFG, clustered_batch

CPU = torch.device("cpu")
NO_MATCH = 0xFFFFFFFF
BUCKET = BlockConfig(**CFG).bucket_for


def jax_mesh(w: int, r: int):
    return jax.sharding.Mesh(np.asarray(jax.devices()[: w * r]).reshape(w, r),
                             ("window", "range"))


def port_mesh(w: int, r: int) -> tmesh.Mesh:
    return tmesh.Mesh(np.array([[CPU] * r] * w, dtype=object))


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    monkeypatch.setattr(jpipeline, "overlap_enabled", lambda: False)
    monkeypatch.setattr(pipeline, "overlap_enabled", lambda: False)


def _clear_caches():
    for cache in (jcolcache.shared_cache(), colcache.shared_cache()):
        if cache is not None:
            cache.clear()


# ---------------------------------------------------------------------------
# the scan programs
# ---------------------------------------------------------------------------


def _runs(rng, w, r, c, rp, n):
    """Run payloads with padding runs (NO_MATCH, length 0), runs whose
    total falls short of n and runs that overrun it."""
    values = rng.integers(0, 6, (w, r, c, rp)).astype(np.uint32)
    lengths = rng.integers(0, 9, (w, r, c, rp)).astype(np.int32)
    values[..., rp - 2:] = NO_MATCH
    lengths[..., rp - 2:] = 0
    lengths[0, 0, 0, 0] = n + 5  # overruns n
    values[..., 1] = NO_MATCH  # a value that equals the sentinel
    return values, lengths


def _codes(rng, shape, k):
    codes = np.full(shape + (k,), NO_MATCH, np.uint32)
    codes[..., : k // 2] = rng.integers(0, 6, shape + (k // 2,))
    return codes


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8)])
def test_rle_scans_match_jax(shape):
    w, r = shape
    rng = np.random.default_rng(w * 10 + r)
    C, RP, K, n, Q = 2, 16, 8, 64, 3
    values, lengths = _runs(rng, w, r, C, RP, n)
    codes = _codes(rng, (w, r, C), K)
    valid = rng.random((w, r, n)) < 0.9
    jm, pm = jax_mesh(w, r), port_mesh(w, r)
    jmask, jhits = jsearch.make_sharded_rle_scan(jm, C, K, n)(
        jnp.asarray(values), jnp.asarray(lengths), jnp.asarray(codes), jnp.asarray(valid))
    tmask, thits = tsearch.make_sharded_rle_scan(pm, C, K, n)(values, lengths, codes, valid)
    assert np.array_equal(np.asarray(jmask), tmask)
    assert np.array_equal(np.asarray(jhits).reshape(-1), thits.reshape(-1))
    bcodes = _codes(rng, (w, r, Q, C), K)
    live = rng.random((w, r, Q, C)) < 0.7
    jmask, jhits = jsearch.make_sharded_batched_rle_scan(jm, C, K, Q, n)(
        jnp.asarray(values), jnp.asarray(lengths), jnp.asarray(bcodes), jnp.asarray(live),
        jnp.asarray(valid))
    tmask, thits = tsearch.make_sharded_batched_rle_scan(pm, C, K, Q, n)(
        values, lengths, bcodes, live, valid)
    assert np.array_equal(np.asarray(jmask), tmask)
    assert np.array_equal(np.asarray(jhits).reshape(w, Q), thits)


@pytest.mark.parametrize("per_shard", [False, True])
def test_tag_scans_match_jax_with_the_sentinel(per_shard):
    w, r = 2, 2
    rng = np.random.default_rng(3)
    C, K, n = 3, 8, 128
    cols = rng.integers(0, 6, (w, r, C, n)).astype(np.uint32)
    cols[:, :, :, ::11] = NO_MATCH  # a column value equal to the padding code
    valid = rng.random((w, r, n)) < 0.9
    jm, pm = jax_mesh(w, r), port_mesh(w, r)
    if per_shard:
        codes = _codes(rng, (w, r, C), K)
        jf = jsearch.make_sharded_tag_scan_per_shard(jm, C, K)
        tf = tsearch.make_sharded_tag_scan_per_shard(pm, C, K)
    else:
        codes = _codes(rng, (C,), K)
        jf = jsearch.make_sharded_tag_scan(jm, C, K)
        tf = tsearch.make_sharded_tag_scan(pm, C, K)
    jmask, jhits = jf(jnp.asarray(cols), jnp.asarray(codes), jnp.asarray(valid))
    tmask, thits = tf(cols, codes, valid)
    assert np.array_equal(np.asarray(jmask), tmask)
    assert np.array_equal(np.asarray(jhits).reshape(-1), thits.reshape(-1))
    assert not tmask[..., ::11].any()  # the sentinel never matches


def test_bloom_test_matches_jax():
    rng = np.random.default_rng(4)
    p = jbloom.plan(200, 0.01)
    ids = rng.integers(0, 2**32, (4, 60, 4), dtype=np.uint64).astype(np.uint32)
    words = np.stack([np.asarray(jbloom.build(jnp.asarray(i), p)) for i in ids])
    q = np.concatenate([ids[:, :5].reshape(-1, 4),
                        rng.integers(0, 2**32, (7, 4), dtype=np.uint64).astype(np.uint32)])
    want = jsearch.make_sharded_bloom_test(jax_mesh(2, 2), p)(
        jnp.asarray(words.reshape(2, 2, *words.shape[1:])), jnp.asarray(q))
    tp = bloom.BloomPlan(p.n_shards, p.bits_per_shard, p.k)
    got = tsearch.make_sharded_bloom_test(port_mesh(2, 2), tp)(
        words.reshape(2, 2, *words.shape[1:]), q)
    assert np.array_equal(np.asarray(want), got)


def test_pack_predicates_and_stack_shards_match_jax():
    sets = [np.array([3, 1], np.uint32), np.array([], np.uint32), np.array([9], np.uint32)]
    assert np.array_equal(jsearch.pack_predicates(sets, 4), tsearch.pack_predicates(sets, 4))
    with pytest.raises(ValueError):
        tsearch.pack_predicates([np.arange(5, dtype=np.uint32)], 4)
    arrays = [np.arange(5, dtype=np.uint32).reshape(1, 5), np.ones((1, 3), np.uint32)]
    for a, b in zip(jsearch.stack_shards(arrays, 2, 2, 8), tsearch.stack_shards(arrays, 2, 2, 8)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# MeshSearcher over blocks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    pair = Pair(tmp_path_factory.mktemp("mesh-search"))
    metas = [pair.write(clustered_batch(seed), f"m{seed}", CFG) for seed in (7, 8, 9)]
    return pair, metas


def _blocks(corpus):
    pair, metas = corpus
    jblocks = [JBlock(jm, pair.jb) for jm, _ in metas]
    tblocks = [VtpuBackendBlock(tm, pair.tb) for _, tm in metas]
    return jblocks, tblocks


SEARCHES = {
    "service": dict(tags={"service": "alpha"}),
    "name": dict(tags={"name": "op-c"}),
    "multi-tag": dict(tags={"service": "beta", "name": "op-c"}),
    "http.url": dict(tags={"http.url": "http://svc/7"}),
    "attr and service": dict(tags={"zone-key-b": "v3", "service": "gamma"}),
    "duration band": dict(tags={"service": "alpha"}, min_duration_ns=5 * 10**3,
                          max_duration_ns=5 * 10**4),
    "no tags, min duration": dict(min_duration_ns=10**8),
    "impossible": dict(tags={"service": "no-such-service"}),
}


def _same_response(j, t, what):
    assert t.to_dict() == j.to_dict(), what
    assert [dataclasses.astuple(h) for h in t.traces] == \
        [dataclasses.astuple(h) for h in j.traces], what


def _same_stats(js, ts):
    assert set(js) == set(ts)
    for k in js:
        if k == "per_shard_rows":
            assert list(js[k]) == list(ts[k])
        else:
            assert js[k] == ts[k], k


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8)])
@pytest.mark.parametrize("limit", [0, 20])
@pytest.mark.parametrize("name", list(SEARCHES))
def test_search_blocks_matches_jax(corpus, shape, limit, name):
    jblocks, tblocks = _blocks(corpus)
    js = jsearch.MeshSearcher(jax_mesh(*shape), BUCKET)
    ts = tsearch.MeshSearcher(port_mesh(*shape), BUCKET)
    kw = dict(SEARCHES[name], limit=limit)
    _clear_caches()
    j = js.search_blocks(iter(jblocks), JRequest(**kw))
    t = ts.search_blocks(iter(tblocks), SearchRequest(**kw))
    _same_response(j, t, name)
    _same_stats(js.last_stats, ts.last_stats)


def test_both_scan_roads_run(corpus):
    """The corpus takes the run road (rle predicate pages) and the
    expanded-column road (a non-rle page in the unit)."""
    jblocks, tblocks = _blocks(corpus)
    ts = tsearch.MeshSearcher(port_mesh(1, 4), BUCKET)
    r0 = tdt.dispatch_total.total(kernel="mesh_rle_scan")
    s0 = tdt.dispatch_total.total(kernel="mesh_scan")
    ts.search_blocks(iter(tblocks), SearchRequest(tags={"service": "alpha"}))
    assert ts.last_stats["units_runspace"] > 0
    ts.search_blocks(iter(tblocks), SearchRequest(tags={"http.url": "http://svc/7"}))
    assert tdt.dispatch_total.total(kernel="mesh_rle_scan") > r0
    assert tdt.dispatch_total.total(kernel="mesh_scan") > s0


MULTI = [
    dict(tags={"service": "alpha"}),
    dict(tags={"service": "beta"}, limit=20),
    dict(tags={"name": "op-c"}),
    dict(tags={"service": "gamma", "name": "op-d"}),
    dict(tags={"service": "delta"}, min_duration_ns=10**7),
    dict(tags={"zone-key-a": "v1", "service": "alpha"}),
    dict(tags={"http.url": "http://svc/7"}),
    dict(tags={"service": "no-such-service"}),
    dict(tags={"name": "op-a"}, limit=5),
    dict(tags={"service": "alpha"}, start_seconds=1_700_000_020),
]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("q", [1, 2, 8, 10])
def test_search_blocks_multi_matches_jax(corpus, shape, q):
    jblocks, tblocks = _blocks(corpus)
    js = jsearch.MeshSearcher(jax_mesh(*shape), BUCKET)
    ts = tsearch.MeshSearcher(port_mesh(*shape), BUCKET)
    _clear_caches()
    jl0 = jsearch.batched_lanes_total.total()
    tl0 = tsearch.batched_lanes_total.total()
    jout = js.search_blocks_multi(iter(jblocks), [JRequest(**kw) for kw in MULTI[:q]])
    tout = ts.search_blocks_multi(iter(tblocks), [SearchRequest(**kw) for kw in MULTI[:q]])
    assert len(tout) == q
    for i, (j, t) in enumerate(zip(jout, tout)):
        _same_response(j, t, f"request {i}")
    _same_stats(js.last_stats, ts.last_stats)
    assert tsearch.batched_lanes_total.total() - tl0 == jsearch.batched_lanes_total.total() - jl0


@pytest.fixture
def tiers():
    """Private device tiers installed in both packages, admission forced
    open; the port's on the CPU."""
    jt = jcolcache.DeviceTier(32 << 20, refresh_s=3600.0)
    tt = colcache.DeviceTier(32 << 20, refresh_s=3600.0, device="cpu")
    jt.should_admit = tt.should_admit = lambda page_keys: True
    jold, told = jcolcache._shared_device, colcache._shared_device
    jcolcache._arm_device_metrics()
    colcache._arm_device_metrics()
    jcolcache._shared_device, colcache._shared_device = jt, tt
    try:
        yield jt, tt
    finally:
        jcolcache._shared_device, colcache._shared_device = jold, told


@pytest.mark.parametrize("multi", [False, True])
def test_resident_stacks_match_jax(corpus, tiers, multi):
    jt, tt = tiers
    jblocks, tblocks = _blocks(corpus)
    js = jsearch.MeshSearcher(jax_mesh(1, 4), BUCKET)
    ts = tsearch.MeshSearcher(port_mesh(1, 4), BUCKET)
    kws = MULTI[:4] if multi else [MULTI[0]]
    kernel = "batched_rle_scan" if multi else "mesh_rle_scan"
    for rnd in ("admit", "resident"):
        _clear_caches()
        a0, ta0 = jdt.avoided_total(), tdt.avoided_total()
        if multi:
            jout = js.search_blocks_multi(iter(jblocks), [JRequest(**kw) for kw in kws])
            tout = ts.search_blocks_multi(iter(tblocks), [SearchRequest(**kw) for kw in kws])
        else:
            jout = [js.search_blocks(iter(jblocks), JRequest(**kws[0]))]
            tout = [ts.search_blocks(iter(tblocks), SearchRequest(**kws[0]))]
        for j, t in zip(jout, tout):
            _same_response(j, t, rnd)
        _same_stats(js.last_stats, ts.last_stats)
        assert tdt.avoided_total() - ta0 == jdt.avoided_total() - a0
    assert tt.hits == jt.hits > 0
    assert tt.stats()["bytes"] == jt.stats()["bytes"]  # the tier counts a stack's bytes alike
    stacks = [k for k in tt._lru if k[0] == "mesh_stack"]
    assert stacks and all(len(tt._lru[k].arrays) == 2 * 4 for k in stacks)
    assert tdt.STATS.avoided.get(kernel, 0) > 0


def test_concurrent_searches_under_dispatch_lock(corpus):
    """Eight threads search through one port searcher at once: every
    answer equals the sequential one (the mesh dispatches serialise on
    dispatch_lock)."""
    _, tblocks = _blocks(corpus)
    ts = tsearch.MeshSearcher(port_mesh(2, 2), BUCKET)
    reqs = [SearchRequest(**dict(MULTI[i % 7], limit=0)) for i in range(8)]
    want = [ts.search_blocks(iter(tblocks), r).to_dict()["traces"] for r in reqs]
    got = [None] * len(reqs)
    errors = []

    def run(i):
        try:
            got[i] = ts.search_blocks(iter(tblocks), reqs[i]).to_dict()["traces"]
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: interleavings a lost update would show
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(th.is_alive() for th in threads)
    assert got == want  # the hits; the blocks' byte counters are shared
