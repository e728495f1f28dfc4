"""The port's block search read path against the JAX package's.

One clustered corpus (services, names, durations and an attribute key
cluster by trace order, so small row groups carry distinct zone-map
stats; the first half of the traces has real parent links, so some row
groups carry the root_first stat and the rest do not) is written by both
packages, byte for byte. The port then reads the JAX-written block and
its own, and every answer is compared with the JAX package's on the same
block in the same column-cache state: search responses field by field
(hits and the inspected/decoded/pruned/coalesced counters), candidate
traces of fetch_candidates, the column views of iter_eval_views, tag
names and values, and the spans collected by trace ID. Tolerance is
zero: every result is an int, a string or an array compared exactly.

The background prefetch of the next row group is switched off in both
packages, so a search that stops at its limit reads the same bytes in
every run."""

import dataclasses

import numpy as np
import pytest

from tempo_tpu.backend import LocalBackend as JLocal, TypedBackend as JTyped
from tempo_tpu.backend.base import BlockMeta as JMeta, ColumnIndexName as JIndexName
from tempo_tpu.encoding.common import SearchRequest as JRequest
from tempo_tpu.encoding.vtpu import colcache as jcolcache, format as jfmt
from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
from tempo_tpu.ops import scan as jscan
from tempo_tpu.traceql import ast_nodes as JA
from tempo_tpu.traceql.parser import parse as jparse
from tempo_tpu.util import pipeline as jpipeline
from tempo_tpu_torch.backend import LocalBackend, TypedBackend
from tempo_tpu_torch.backend.base import BlockMeta, ColumnIndexName
from tempo_tpu_torch.encoding.common import SearchRequest
from tempo_tpu_torch.encoding.vtpu import colcache, format as fmt
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.ops import scan
from tempo_tpu_torch.traceql import ast_nodes as A
from tempo_tpu_torch.traceql.parser import parse
from tempo_tpu_torch.util import pipeline

from test_torch_blocks import Pair, assert_same_objects

T0 = 1_700_000_000
CFG = {"row_group_spans": 128}


def chain_parents(batch: SpanBatch, upto_trace: int | None = None) -> SpanBatch:
    """Each trace's rows become a parent chain: for the traces before
    `upto_trace` (all when None) row 0 is the root and row k the child of
    row k-1; for later traces the chain runs backwards, so the root is
    the trace's last row (a row group holding such a trace has no
    root_first stat)."""
    cols = {k: v.copy() for k, v in batch.cols.items()}
    firsts, seg = batch.trace_boundaries()
    n = batch.num_spans
    row = np.arange(n)
    lasts = np.append(firsts[1:], n) - 1
    forward = seg < (len(firsts) if upto_trace is None else upto_trace)
    sid = cols["span_id"]
    fwd = np.where((row == firsts[seg])[:, None], 0, sid[np.maximum(row - 1, 0)])
    bwd = np.where((row == lasts[seg])[:, None], 0, sid[np.minimum(row + 1, n - 1)])
    cols["parent_span_id"] = np.where(forward[:, None], fwd, bwd).astype(np.uint32)
    return SpanBatch(cols=cols, attrs=batch.attrs, dictionary=batch.dictionary)


def clustered_batch(seed: int, n_traces: int = 240, spans: int = 4) -> SpanBatch:
    """make_batch with services, names, durations, start times and one
    attribute key clustered by trace order (uniform data puts every code
    in every row group, and zone maps would never prune)."""
    rng = np.random.default_rng(seed)
    b = synth.make_batch(n_traces, spans, seed=seed, base_time_ns=T0 * 10**9)
    d = b.dictionary
    n = b.num_spans
    svc = [d.add(s) for s in ("alpha", "beta", "gamma", "delta")]
    names = [d.add(s) for s in ("op-a", "op-b", "op-c", "op-d")]
    keys = [d.add(s) for s in ("zone-key-a", "zone-key-b")]
    third = n // 3
    cols = dict(b.cols)
    service = cols["service"].copy()
    service[:third] = svc[0]
    service[third:2 * third] = svc[1]
    service[2 * third:] = rng.choice(svc[2:], size=n - 2 * third)
    name = cols["name"].copy()
    name[:third] = rng.choice(names[:2], size=third)
    name[third:] = rng.choice(names[2:], size=n - third)
    dur = cols["duration_nano"].copy()
    dur[:third] = rng.integers(10**3, 10**5, size=third).astype(np.uint64)
    dur[third:] = rng.integers(10**7, 10**9, size=n - third).astype(np.uint64)
    # start times rise with row order: a time window prunes row groups
    cols["start_unix_nano"] = (T0 * 10**9 + np.arange(n, dtype=np.uint64) * 10**8
                               + rng.integers(0, 10**7, n).astype(np.uint64))
    cols.update(service=service, name=name, duration_nano=dur)
    attrs = dict(b.attrs)
    akey = attrs["attr_key"].copy()
    owner = attrs["attr_span"]
    akey[owner < third] = keys[0]
    akey[owner >= third] = keys[1]
    attrs["attr_key"] = akey
    out = SpanBatch(cols=cols, attrs=attrs, dictionary=d)
    return chain_parents(out, upto_trace=n_traces // 2)


def _clear_caches():
    for cache in (jcolcache.shared_cache(), colcache.shared_cache()):
        if cache is not None:
            cache.clear()


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    monkeypatch.setattr(jpipeline, "overlap_enabled", lambda: False)
    monkeypatch.setattr(pipeline, "overlap_enabled", lambda: False)


@pytest.fixture
def corpus(tmp_path):
    """(pair, jax meta, port meta, batch): one block written by each
    package, byte-equal."""
    pair = Pair(tmp_path)
    batch = clustered_batch(7)
    jmeta, tmeta = pair.write(batch, "s", CFG)
    return pair, jmeta, tmeta, batch


def blocks(corpus):
    """(JAX package over its block, port over the JAX-written block, port
    over its own block)."""
    pair, jmeta, tmeta, _ = corpus
    port_on_jax = VtpuBackendBlock(BlockMeta.from_json(jmeta.to_json()),
                                   TypedBackend(LocalBackend(pair.jroot)))
    return JBlock(jmeta, pair.jb), port_on_jax, VtpuBackendBlock(tmeta, pair.tb)


def test_corpus_blocks_are_byte_equal(corpus):
    pair, jmeta, tmeta, _ = corpus
    assert_same_objects(*pair.objects(jmeta, tmeta))
    rgs = VtpuBackendBlock(tmeta, pair.tb).index().row_groups
    roots = [bool(rg.stats.get("root_first")) for rg in rgs]
    assert len(rgs) > 6 and any(roots) and not all(roots)


SEARCHES = {
    "service": dict(tags={"service": "alpha"}, limit=0),
    "service.name": dict(tags={"service.name": "delta"}, limit=0),
    "synth-wide service": dict(tags={"service": "cart"}, limit=0),
    "name": dict(tags={"name": "op-c"}, limit=0),
    "multi-tag": dict(tags={"service": "beta", "name": "op-c", "http.method": "GET"}, limit=0),
    "http.status_code": dict(tags={"http.status_code": "500"}, limit=0),
    "http.url": dict(tags={"http.url": "http://svc/7"}, limit=0),
    "attr string": dict(tags={"zone-key-a": "v1"}, limit=0),
    "attr and service": dict(tags={"zone-key-b": "v3", "service": "gamma"}, limit=0),
    "impossible value": dict(tags={"service": "no-such-service"}, limit=0),
    "impossible attr key": dict(tags={"no-such-key": "v1"}, limit=0),
    "non-numeric status": dict(tags={"http.status_code": "abc"}, limit=0),
    "min duration": dict(min_duration_ns=10**8, limit=0),
    "max duration": dict(max_duration_ns=10**4, limit=0),
    "duration band": dict(tags={"service": "alpha"}, min_duration_ns=5 * 10**3,
                          max_duration_ns=5 * 10**4, limit=0),
    "time window": dict(start_seconds=T0 + 20, end_seconds=T0 + 45, limit=0),
    "window and tag": dict(tags={"name": "op-d"}, start_seconds=T0 + 60, limit=0),
    "limit 1": dict(tags={"service": "alpha"}, limit=1),
    "limit 20": dict(tags={"service": "beta"}, limit=20),
    "limit 20 duration": dict(min_duration_ns=10**7, limit=20),
}


def _pair_requests(kw):
    return JRequest(**kw), SearchRequest(**kw)


def _same_response(j, t, what):
    assert t.to_dict() == j.to_dict(), what
    assert [dataclasses.astuple(h) for h in t.traces] == \
        [dataclasses.astuple(h) for h in j.traces], what


@pytest.mark.parametrize("name", list(SEARCHES))
def test_search_matches_jax_cold_and_warm(corpus, name):
    jblk, tblk_j, tblk_t = blocks(corpus)
    jreq, treq = _pair_requests(SEARCHES[name])
    _clear_caches()
    cold = [jblk.search(jreq), tblk_j.search(treq)]
    warm = [jblk.search(jreq), tblk_j.search(treq)]
    _same_response(cold[0], cold[1], f"{name} cold")
    _same_response(warm[0], warm[1], f"{name} warm")
    _clear_caches()
    _same_response(cold[0], tblk_t.search(treq), f"{name} cold, the port's own block")
    if name.startswith("impossible"):
        # the dictionary alone answers: no index and no page is read
        assert cold[1].traces == [] and cold[1].decoded_bytes == 0
        assert cold[1].inspected_traces == 0


def test_cache_changes_the_counters_as_in_jax(corpus):
    jblk, tblk, _ = blocks(corpus)
    jreq, treq = _pair_requests(SEARCHES["multi-tag"])
    _clear_caches()
    jc, tc = jblk.search(jreq), tblk.search(treq)
    jw, tw = jblk.search(jreq), tblk.search(treq)
    assert tw.inspected_bytes < tc.inspected_bytes and tw.decoded_bytes < tc.decoded_bytes
    assert (tc.inspected_bytes, tw.inspected_bytes, tc.decoded_bytes, tw.decoded_bytes) == \
        (jc.inspected_bytes, jw.inspected_bytes, jc.decoded_bytes, jw.decoded_bytes)
    assert colcache.shared_cache().stats()["hits"] > 0


@pytest.mark.parametrize("zonemaps", ["1", "0"])
@pytest.mark.parametrize("runspace", ["1", "0"])
@pytest.mark.parametrize("name", ["service", "attr and service", "duration band",
                                  "window and tag", "limit 20"])
def test_search_switches_match_jax(corpus, monkeypatch, zonemaps, runspace, name):
    monkeypatch.setenv("TEMPO_TPU_ZONEMAPS", zonemaps)
    monkeypatch.setenv("TEMPO_TPU_RUNSPACE", runspace)
    jblk, tblk, _ = blocks(corpus)
    jreq, treq = _pair_requests(SEARCHES[name])
    _clear_caches()
    j, t = jblk.search(jreq), tblk.search(treq)
    _same_response(j, t, name)
    if zonemaps == "0":
        assert t.pruned_row_groups == 0


def test_zone_maps_prune_and_runspace_answers_alike(corpus, monkeypatch):
    _, tblk, _ = blocks(corpus)
    req = SearchRequest(**SEARCHES["service"])
    _clear_caches()
    pruned = tblk.search(req)
    assert pruned.pruned_row_groups > 0
    monkeypatch.setenv("TEMPO_TPU_RUNSPACE", "0")
    monkeypatch.setenv("TEMPO_TPU_ZONEMAPS", "0")
    _clear_caches()
    plain = tblk.search(req)
    assert [h.to_dict() for h in plain.traces] == [h.to_dict() for h in pruned.traces]
    assert plain.inspected_bytes > pruned.inspected_bytes


@pytest.mark.parametrize("start,count", [(0, 2), (3, 4), (5, 0), (40, 3)])
def test_search_row_group_subrange_matches_jax(corpus, start, count):
    jblk, tblk, _ = blocks(corpus)
    jreq, treq = _pair_requests(dict(tags={"name": "op-c"}, limit=0))
    _clear_caches()
    _same_response(jblk.search(jreq, start_row_group=start, row_groups=count),
                   tblk.search(treq, start_row_group=start, row_groups=count),
                   f"row groups {start}+{count}")


def test_search_without_root_first_stats_matches_jax(corpus):
    """Strip the stats of every row group from both stored indexes (a
    block written before stats existed): root resolution then scans the
    parent IDs, and nothing prunes."""
    pair, jmeta, tmeta, _ = corpus
    jidx = jfmt.BlockIndex.from_bytes(pair.jb.read_named("t", jmeta.block_id, JIndexName))
    tidx = fmt.BlockIndex.from_bytes(pair.tb.read_named("t", tmeta.block_id, ColumnIndexName))
    for idx in (jidx, tidx):
        for rg in idx.row_groups:
            rg.stats = {}
    pair.jb.write_named(jmeta, JIndexName, jidx.to_bytes())
    pair.tb.write_named(tmeta, ColumnIndexName, tidx.to_bytes())
    jblk, _, tblk = blocks(corpus)
    for name in ("service", "limit 20", "window and tag"):
        jreq, treq = _pair_requests(SEARCHES[name])
        _clear_caches()
        j, t = jblk.search(jreq), tblk.search(treq)
        _same_response(j, t, name)
        assert t.pruned_row_groups == 0


FETCHES = {
    "and": ([("any", "service.name", "=", "alpha"), ("intrinsic", "duration", ">", 10**4)], True),
    "or": ([("any", "service.name", "=", "delta"), ("intrinsic", "name", "=~", "op-[ab]")], False),
    "regex": ([("any", "service.name", "=~", "al.*")], True),
    "negated": ([("intrinsic", "name", "!~", "op-.*")], True),
    "attr string": ([("span", "zone-key-a", "=", "v1")], True),
    "attr int": ([("span", "zone-key-b", ">", 900)], True),
    "status code": ([("span", "http.status_code", "=", 500), ("any", "service.name", "=", "beta")],
                    True),
    "impossible": ([("any", "service.name", "=", "no-such-service"),
                    ("intrinsic", "duration", ">", 10**4)], True),
    "impossible or": ([("any", "service.name", "=", "no-such-service"),
                       ("intrinsic", "name", "=", "op-a")], False),
    "unsupported and": ([("intrinsic", "childCount", ">", 1), ("any", "service.name", "=", "beta")],
                        True),
    "unsupported or": ([("intrinsic", "childCount", ">", 1), ("any", "service.name", "=", "beta")],
                       False),
    "fetch all": ([], True),
}


def _traces(ts):
    return [(t.trace_id, repr(t.batches)) for t in ts]


def _counters(blk):
    return (blk.bytes_read, blk.decoded_bytes, blk.pruned_row_groups, blk.coalesced_reads)


@pytest.mark.parametrize("name", list(FETCHES))
def test_fetch_candidates_matches_jax(corpus, name):
    conds, all_conditions = FETCHES[name]
    jspec = JA.FetchSpec([JA.Condition(*c) for c in conds], all_conditions=all_conditions)
    tspec = A.FetchSpec([A.Condition(*c) for c in conds], all_conditions=all_conditions)
    jblk, tblk, _ = blocks(corpus)
    _clear_caches()
    j = jblk.fetch_candidates(jspec, T0 + 10, T0 + 90)
    t = tblk.fetch_candidates(tspec, T0 + 10, T0 + 90)
    assert _traces(t) == _traces(j)
    assert _counters(tblk) == _counters(jblk)
    if name.startswith("impossible") and all_conditions:
        assert t == []
    jblk, tblk, _ = blocks(corpus)
    assert _traces(tblk.fetch_candidates(tspec, max_traces=5)) == \
        _traces(jblk.fetch_candidates(jspec, max_traces=5))


@pytest.mark.parametrize("query", [
    '{ resource.service.name = "alpha" && duration > 10us }',
    '{ span.zone-key-a = "v1" }',
    '{ } | by(resource.service.name)',
])
def test_iter_eval_views_matches_jax(corpus, query):
    jblk, tblk, _ = blocks(corpus)
    _clear_caches()
    jviews = list(jblk.iter_eval_views(jparse(query), T0 + 20, T0 + 70))
    tviews = list(tblk.iter_eval_views(parse(query), T0 + 20, T0 + 70))
    assert len(tviews) == len(jviews) > 0
    for (jv, jd), (tv, td) in zip(jviews, tviews):
        assert tv.num_spans == jv.num_spans
        assert sorted(tv.cols) == sorted(jv.cols) and sorted(tv.attrs) == sorted(jv.attrs)
        for k in jv.cols:
            np.testing.assert_array_equal(tv.cols[k], jv.cols[k], err_msg=k)
        for k in jv.attrs:
            np.testing.assert_array_equal(tv.attrs[k], jv.attrs[k], err_msg=k)
        assert td.entries == jd.entries
    assert _counters(tblk) == _counters(jblk)


def test_tag_names_and_values_match_jax(corpus):
    jblk, tblk, _ = blocks(corpus)
    _clear_caches()
    names = tblk.tag_names()
    assert names == jblk.tag_names() and {"zone-key-a", "service.name", "http.url"} <= names
    for tag in sorted(names) + ["no-such-tag"]:
        assert tblk.tag_values(tag) == jblk.tag_values(tag), tag
    assert _counters(tblk) == _counters(jblk)


def test_collect_spans_for_ids_matches_jax(corpus):
    *_, batch = corpus
    firsts, _ = batch.trace_boundaries()
    ids = {fmt.id_to_hex(batch.cols["trace_id"][i]) for i in firsts[::9]}
    ids |= {"0" * 31 + "1", "f" * 32}  # outside the block's ID range
    jblk, tblk, _ = blocks(corpus)
    _clear_caches()
    got = tblk.collect_spans_for_ids(ids)
    assert len(got) == len(firsts[::9])
    assert _traces(got) == _traces(jblk.collect_spans_for_ids(ids))
    assert tblk.collect_spans_for_ids({"f" * 32}) == []


def test_hits_for_mask_matches_jax(corpus):
    jblk, tblk, _ = blocks(corpus)
    rng = np.random.default_rng(3)
    for i, (jrg, trg) in enumerate(zip(jblk.index().row_groups, tblk.index().row_groups)):
        mask = rng.random(trg.n_spans) < 0.1
        for limit in (0, 2):
            jreq, treq = _pair_requests(dict(start_seconds=T0 + 5 if i % 2 else 0, limit=limit))
            j = jblk.hits_for_mask(jrg, mask, jreq, limit)
            t = tblk.hits_for_mask(trg, mask, treq, limit)
            assert [h.to_dict() for h in t] == [h.to_dict() for h in j]


def test_encoded_column_accessors_match_jax(corpus):
    """range_mask, rows_equal_mask and gather on every page of one row
    group, whatever its codec."""
    jblk, tblk, _ = blocks(corpus)
    rng = np.random.default_rng(4)
    jrg, trg = jblk.index().row_groups[2], tblk.index().row_groups[2]
    seen = set()
    for name in sorted(trg.pages):
        jenc, tenc = jblk.encoded_column(jrg, name), tblk.encoded_column(trg, name)
        assert (jenc is None) == (tenc is None), name
        if tenc is None:
            continue
        seen.add(tenc.codec)
        rows = np.sort(rng.choice(trg.n_spans, 17, replace=False))
        np.testing.assert_array_equal(tenc.gather(rows), jenc.gather(rows), err_msg=name)
        if tenc.pm.shape and len(tenc.pm.shape) > 1:
            zero = np.zeros(tenc.pm.shape[1:], np.uint32)
            a, b = tenc.rows_equal_mask(zero), jenc.rows_equal_mask(zero)
        else:
            hi = min(400, int(np.iinfo(np.dtype(tenc.pm.dtype)).max))
            a, b = tenc.range_mask(5, hi), jenc.range_mask(5, hi)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert _counters(tblk) == _counters(jblk)
    assert {"rle", "dct"} <= seen, seen


def test_scan_helpers_match_jax():
    rng = np.random.default_rng(5)
    values = rng.integers(0, 50, 300).astype(np.uint32)
    np.testing.assert_array_equal(scan.between_runs(values, 7, 31),
                                  jscan.between_runs(values, 7, 31))
    for size in (0, 1, 3, 4, 5, 16, 17):
        codes = rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
        np.testing.assert_array_equal(scan.pad_codes_u32(codes), jscan.pad_codes_u32(codes))
    entries = ["", "alpha", "beta", "gamma", "al"]
    for pred in (lambda e: e.startswith("al"), lambda e: "zz" in e):
        np.testing.assert_array_equal(scan.dict_codes_matching(entries, pred),
                                      jscan.dict_codes_matching(entries, pred))
    assert scan.NO_MATCH_CODE == jscan.NO_MATCH_CODE


def test_search_request_and_zone_prunes_have_callers(corpus, monkeypatch):
    """zone_prunes is what search() consults per row group: counting its
    verdicts gives the response's pruned_row_groups."""
    from tempo_tpu_torch.encoding.vtpu import block as tblock

    calls = []
    real = tblock.zone_prunes

    def spy(rg, preds, req):
        calls.append(real(rg, preds, req))
        return calls[-1]

    monkeypatch.setattr(tblock, "zone_prunes", spy)
    _, tblk, _ = blocks(corpus)
    _clear_caches()
    resp = tblk.search(SearchRequest(**SEARCHES["service"]))
    assert sum(calls) == resp.pruned_row_groups > 0


def test_port_reads_its_own_block_with_jax_the_same(corpus):
    """The JAX package reads the port-written block and answers as over
    its own."""
    pair, jmeta, tmeta, _ = corpus
    jax_on_port = JBlock(JMeta.from_json(tmeta.to_json()), JTyped(JLocal(pair.troot)))
    jblk, _, _ = blocks(corpus)
    jreq, _ = _pair_requests(SEARCHES["attr and service"])
    _clear_caches()
    a = jax_on_port.search(jreq)
    _clear_caches()
    assert a.to_dict() == jblk.search(jreq).to_dict()
