"""The port's vrow1 encoding against the JAX package's.

The same traces (made with numpy from a seed) go through both packages'
vrow1 writers, compactors and readers. With gzip's clock pinned (each
record's segment gzips the batch dictionary with mtime = now), every
stored object is byte-equal: data.bin, the bloom shards, index.json and
meta.json. The port cuts each trace's record from the sorted batch by
slices (format.trace_records); every record equals the reference's
select-based trace_record. Finds, searches, the TraceQL refusal and
TempoDB's cycle under `block.version: vrow1` answer alike."""

import gzip
import types

import numpy as np
import pytest
import torch

from tempo_tpu import encoding as jregistry
from tempo_tpu.backend.base import TypedBackend as JTyped
from tempo_tpu.backend.mock import MockBackend as JMock
from tempo_tpu.db import DBConfig as JDBConfig, TempoDB as JTempoDB
from tempo_tpu.encoding.common import BlockConfig as JConfig, SearchRequest as JReq
from tempo_tpu.encoding.vrow import format as jfmt
from tempo_tpu.encoding.vrow.block import (
    TraceQLUnsupported as JTraceQLUnsupported,
    VrowBackendBlock as JBlock,
    write_block as jwrite,
)
from tempo_tpu.model import synth as jsynth, trace as jtr
from tempo_tpu_torch import encoding as registry
from tempo_tpu_torch.backend.base import TypedBackend
from tempo_tpu_torch.backend.mock import MockBackend
from tempo_tpu_torch.db import DBConfig, TempoDB
from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest
from tempo_tpu_torch.encoding.vrow import format as fmt
from tempo_tpu_torch.encoding.vrow.block import TraceQLUnsupported, VrowBackendBlock, write_block
from tempo_tpu_torch.model import synth, trace as tr
from tempo_tpu_torch.model.columnar import SpanBatch

BID = "00000000-0000-0000-0000-0000000000b1"


@pytest.fixture(autouse=True)
def gzip_clock(monkeypatch):
    """Pin the time gzip writes into each header."""
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000))


def pair(n_traces: int, seed: int):
    """The same traces as (port batch, reference batch), trace-sorted."""
    return (tr.traces_to_batch(synth.make_traces(n_traces, seed=seed)).sorted_by_trace(),
            jtr.traces_to_batch(jsynth.make_traces(n_traces, seed=seed)).sorted_by_trace())


def objects(be, tenant: str, block_id: str) -> dict:
    return {n: be.read_named(tenant, block_id, n)
            for n in be.raw.list_objects((tenant, block_id))}


def write_both(batches_p, batches_j, **kw):
    be, jbe = TypedBackend(MockBackend()), JTyped(JMock())
    m = write_block(batches_p, "t", be, BlockConfig(version="vrow1"), block_id=BID,
                    device="cpu", **kw)
    jm = jwrite(batches_j, "t", jbe, JConfig(version="vrow1"), block_id=BID, **kw)
    return be, m, jbe, jm


# ---------------------------------------------------------------- format
def test_page_roundtrip_and_bytes():
    recs = [fmt.encode_record(bytes(range(16)), b"payload-%d" % i) for i in range(10)]
    page = fmt.encode_page(recs)
    assert page == jfmt.encode_page([jfmt.encode_record(bytes(range(16)), b"payload-%d" % i)
                                     for i in range(10)])
    out = list(fmt.iter_records(fmt.decode_page(page)))
    assert len(out) == 10 and out[3][1] == b"payload-3"


@pytest.mark.parametrize("damage", ["body", "short", "truncated"])
def test_corrupt_page_detected(damage):
    page = bytearray(fmt.encode_page([fmt.encode_record(b"\x00" * 16, b"x")]))
    if damage == "body":
        page[-1] ^= 0xFF
    elif damage == "short":
        page = page[:8]
    else:
        page = page[:-2]
    for mod in (fmt, jfmt):
        with pytest.raises(mod.CorruptPage):
            mod.decode_page(bytes(page))


def test_find_pages_binary_search():
    def idx(mod):
        return mod.PageIndex([
            mod.PageEntry(min_id="0" * 32, max_id="3" + "f" * 31),
            mod.PageEntry(min_id="4" + "0" * 31, max_id="7" + "f" * 31),
            mod.PageEntry(min_id="8" + "0" * 31, max_id="f" * 32),
        ])
    for probe in ("5" + "0" * 31, "0" * 32, "f" * 32, "8" + "0" * 31):
        assert idx(fmt).find_pages(probe) == idx(jfmt).find_pages(probe)
    assert idx(fmt).to_bytes() == idx(jfmt).to_bytes()


@pytest.mark.parametrize("case", ["traces", "graph", "no attrs", "attrs unordered"])
def test_trace_records_equal_select(case):
    """Each record cut by slices equals the reference's select-based
    record of the same trace."""
    if case == "traces":
        p, j = pair(40, seed=5)
    else:
        p = synth.make_graph_batch(64, 8, seed=3).sorted_by_trace()
        if case == "no attrs":
            p = SpanBatch(cols=p.cols, dictionary=p.dictionary)
        elif case == "attrs unordered":
            p, _ = pair(30, seed=6)
            rev = np.arange(p.num_attrs)[::-1]
            p = SpanBatch(cols=p.cols, attrs={k: v[rev] for k, v in p.attrs.items()},
                          dictionary=p.dictionary)
        from tempo_tpu.model.columnar import Dictionary as JDict, SpanBatch as JSpanBatch

        j = JSpanBatch(cols={k: v.copy() for k, v in p.cols.items()},
                       attrs={k: v.copy() for k, v in p.attrs.items()},
                       dictionary=JDict(list(p.dictionary.entries)))
    firsts, _ = p.trace_boundaries()
    bounds = [int(x) for x in firsts] + [p.num_spans]
    got = list(fmt.trace_records(p, bounds))
    assert len(got) == len(bounds) - 1
    for i, (tid, rec) in enumerate(got):
        assert (tid, rec) == jfmt.trace_record(j, bounds[i], bounds[i + 1])


# ----------------------------------------------------------------- block
@pytest.mark.parametrize("n_traces,seed,page", [(30, 1, 256 * 1024), (50, 2, 2048), (7, 3, 64)])
def test_block_byte_equal(n_traces, seed, page):
    p, j = pair(n_traces, seed)
    be, m, jbe, jm = write_both([p], [j], page_target_bytes=page)
    assert objects(be, "t", BID) == objects(jbe, "t", BID)
    assert m.total_objects == jm.total_objects == n_traces
    if page < 4096:
        assert m.total_records > 1  # really several pages


def test_find_and_search_equal():
    p, j = pair(40, seed=9)
    be, m, jbe, jm = write_both([p], [j], page_target_bytes=4096)
    blk, jblk = VrowBackendBlock(m, be), JBlock(jm, jbe)
    traces = synth.make_traces(40, seed=9)
    for t in traces[::4] + [None]:
        tid = b"\x01" * 16 if t is None else t.trace_id
        got, want = blk.find_trace_by_id(tid), jblk.find_trace_by_id(tid)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.span_count() == want.span_count() == t.span_count()
    for t in traces[:3]:
        svc = t.batches[0][0]["service.name"]
        for limit in (100, 2):
            r = blk.search(SearchRequest(tags={"service": svc}, limit=limit))
            jr = jblk.search(JReq(tags={"service": svc}, limit=limit))
            assert r.to_dict() == jr.to_dict()
    with pytest.raises(TraceQLUnsupported):
        blk.fetch_candidates(None)
    with pytest.raises(JTraceQLUnsupported):
        jblk.fetch_candidates(None)
    assert issubclass(TraceQLUnsupported, NotImplementedError)


@pytest.mark.parametrize("case", ["duplicates", "partial traces"])
def test_compaction_byte_equal(case):
    """Two blocks merged by the k-way bookmark merge: duplicate traces
    once, a trace split over both blocks combined."""
    be, jbe = TypedBackend(MockBackend()), JTyped(JMock())
    if case == "duplicates":
        ps = [tr.traces_to_batch(synth.make_traces(20, seed=9)).sorted_by_trace()] * 2
        js = [jtr.traces_to_batch(jsynth.make_traces(20, seed=9)).sorted_by_trace()] * 2
    else:
        def halves(mod_synth, mod_tr):
            t = mod_synth.make_trace(seed=4, n_spans=12)
            spans, res = list(t.all_spans()), t.batches[0][0]
            return [mod_tr.traces_to_batch([mod_tr.Trace(trace_id=t.trace_id,
                                                         batches=[(res, part)])]).sorted_by_trace()
                    for part in (spans[:7], spans[7:])]
        ps, js = halves(synth, tr), halves(jsynth, jtr)
    metas, jmetas = [], []
    for i, (p, j) in enumerate(zip(ps, js)):
        bid = f"00000000-0000-0000-0000-00000000000{i}"
        metas.append(write_block([p], "t", be, BlockConfig(version="vrow1"), block_id=bid,
                                 device="cpu"))
        jmetas.append(jwrite([j], "t", jbe, JConfig(version="vrow1"), block_id=bid))
    (out,) = registry.from_version("vrow1").new_compactor(device="cpu").compact(metas, "t", be)
    (jout,) = jregistry.from_version("vrow1").new_compactor().compact(jmetas, "t", jbe)
    a, b = objects(be, "t", out.block_id), objects(jbe, "t", jout.block_id)
    a.pop("meta.json"), b.pop("meta.json")
    assert a == b
    for k in ("total_objects", "total_spans", "size_bytes", "min_id", "max_id",
              "compaction_level", "est_distinct_traces", "bloom_shards"):
        assert getattr(out, k) == getattr(jout, k), k
    got = VrowBackendBlock(out, be).find_trace_by_id(
        (synth.make_traces(20, seed=9)[11] if case == "duplicates"
         else synth.make_trace(seed=4, n_spans=12)).trace_id)
    assert got is not None and got.span_count() == (
        synth.make_traces(20, seed=9)[11].span_count() if case == "duplicates" else 12)


def test_registry_has_vrow():
    enc = registry.from_version("vrow1")
    assert enc.version == "vrow1" == jregistry.from_version("vrow1").version
    assert sorted(e.version for e in registry.all_encodings()) == \
        sorted(e.version for e in jregistry.all_encodings())


def test_db_cycle_via_config_knob(tmp_path):
    """storage.trace.block.version: vrow1 swaps the data plane in both
    packages: the same blocks, finds, compaction and search."""
    dbs = {}
    for name, mk, cfg_cls, blk_cls, kw in (
            ("port", TempoDB, DBConfig, BlockConfig, {"device": "cpu"}),
            ("ref", JTempoDB, JDBConfig, JConfig, {})):
        extra = {} if name == "port" else {"compaction_device_shards": 1}
        dbs[name] = mk(cfg_cls(backend="local", backend_path=str(tmp_path / name / "blocks"),
                               wal_path=str(tmp_path / name / "wal"),
                               block=blk_cls(version="vrow1"), **extra), **kw)
    p_traces, j_traces = synth.make_traces(20, seed=13), jsynth.make_traces(20, seed=13)
    for i, (lo, hi) in enumerate(((0, 10), (10, 20))):
        bid = f"00000000-0000-0000-0000-00000000000{i}"
        dbs["port"].write_batch("acme", tr.traces_to_batch(p_traces[lo:hi]).sorted_by_trace(),
                                block_id=bid)
        dbs["ref"].write_batch("acme", jtr.traces_to_batch(j_traces[lo:hi]).sorted_by_trace(),
                               block_id=bid)
        assert objects(dbs["port"].backend, "acme", bid) == objects(dbs["ref"].backend, "acme", bid)
    for db in dbs.values():
        db.poll_now()
        assert all(m.version == "vrow1" for m in db.blocklist.metas("acme"))
    for t in p_traces[::3]:
        a, b = dbs["port"].find("acme", t.trace_id), dbs["ref"].find("acme", t.trace_id)
        assert a.span_count() == b.span_count() == t.span_count()
    for db in dbs.values():
        assert db.compact_once("acme")
        db.poll_now()
        assert len(db.blocklist.metas("acme")) == 1
    (m,), (jm,) = dbs["port"].blocklist.metas("acme"), dbs["ref"].blocklist.metas("acme")
    a, b = objects(dbs["port"].backend, "acme", m.block_id), objects(dbs["ref"].backend, "acme",
                                                                      jm.block_id)
    a.pop("meta.json"), b.pop("meta.json")
    assert a == b
    svc = p_traces[7].batches[0][0]["service.name"]
    r = dbs["port"].search("acme", SearchRequest(tags={"service": svc}, limit=100))
    jr = dbs["ref"].search("acme", JReq(tags={"service": svc}, limit=100))
    assert p_traces[7].trace_id.hex() in {t.trace_id_hex for t in r.traces}
    assert [t.to_dict() for t in r.traces] == [t.to_dict() for t in jr.traces]


def test_mixed_version_blocks_coexist(tmp_path):
    """vtpu1 and vrow1 blocks in one tenant: the reader opens each by
    its meta's version."""
    db = TempoDB(DBConfig(backend="local", backend_path=str(tmp_path / "blocks"),
                          wal_path=str(tmp_path / "wal")), device="cpu")
    t_new, t_old = synth.make_traces(5, seed=20), synth.make_traces(5, seed=21)
    db.write_batch("acme", tr.traces_to_batch(t_new).sorted_by_trace())
    registry.from_version("vrow1").create_block(
        [tr.traces_to_batch(t_old).sorted_by_trace()], "acme", db.backend,
        BlockConfig(version="vrow1"), device="cpu")
    db.poll_now()
    assert {m.version for m in db.blocklist.metas("acme")} == {"vtpu1", "vrow1"}
    assert db.find("acme", t_new[0].trace_id) is not None
    assert db.find("acme", t_old[0].trace_id) is not None


def test_writer_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    p, _ = pair(3, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        write_block([p], "t", TypedBackend(MockBackend()), BlockConfig(version="vrow1"))


@pytest.mark.cuda
def test_card_write_equals_cpu_and_launches_hll_update():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tempo_tpu_torch.ops import sketch

    p = synth.make_graph_batch(512, 8, seed=2).sorted_by_trace()
    out = {}
    for dev in ("cuda", "cpu"):
        be = TypedBackend(MockBackend())
        before = sketch.hll_update.launches
        write_block([p], "t", be, BlockConfig(version="vrow1"), block_id=BID, device=dev)
        out[dev] = (objects(be, "t", BID), sketch.hll_update.launches - before)
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] == 1 and out["cpu"][1] == 0
