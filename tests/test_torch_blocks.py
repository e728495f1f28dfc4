"""The port's vtpu1 block writer and reader against the JAX package's.

The same span batches (made with numpy from a seed) are written by the
JAX package's write_block and by the port's write_block(device="cpu")
into two local backends; every object must match byte for byte:
data.bin and the bloom shards as stored, index.json and dict.bin after
gunzip (their gzip header carries the clock), meta.json as JSON. Each
package then reads the other's blocks, find_trace_by_id answers alike,
and the stored HLL estimate of the sketch step equals the JAX one. The
batch segment, the trace-object conversions and zone-map pruning are
held against the JAX package too."""

import gzip
import json
import os
import uuid

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.backend import LocalBackend as JLocal, TypedBackend as JTyped
from tempo_tpu.encoding.common import BlockConfig as JConfig
from tempo_tpu.encoding.vtpu import create as jcreate
from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
from tempo_tpu.model.columnar import Dictionary as JDictionary, SpanBatch as JSpanBatch
from tempo_tpu.ops import bloom as jbloom, sketch as jsketch
from tempo_tpu_torch.backend import LocalBackend, TypedBackend
from tempo_tpu_torch.encoding.common import BlockConfig
from tempo_tpu_torch.encoding.vtpu import create
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.encoding.vtpu.codec import LIGHTWEIGHT_CODECS
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.ops import bloom, sketch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def to_jax(batch: SpanBatch) -> JSpanBatch:
    """The same arrays as a JAX-package SpanBatch."""
    return JSpanBatch(cols={k: v.copy() for k, v in batch.cols.items()},
                      attrs={k: v.copy() for k, v in batch.attrs.items()},
                      dictionary=JDictionary(list(batch.dictionary.entries)))


def block_objects(root: str, tenant: str, block_id: str) -> dict:
    """name -> comparable bytes of one stored block: index and dictionary
    gunzipped, meta.json without its block id."""
    d = os.path.join(root, tenant, block_id)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            raw = f.read()
        if name in ("index.json", "dict.bin"):
            raw = gzip.decompress(raw)
        elif name == "meta.json":
            meta = json.loads(raw)
            meta.pop("block_id")
            raw = json.dumps(meta, sort_keys=True).encode()
        out[name] = raw
    return out


def assert_same_objects(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    assert [k for k in a if a[k] != b[k]] == []


class Pair:
    """A JAX-package backend and a port backend side by side."""

    def __init__(self, tmp_path):
        self.jroot = str(tmp_path / "jax")
        self.troot = str(tmp_path / "port")
        self.jb = JTyped(JLocal(self.jroot))
        self.tb = TypedBackend(LocalBackend(self.troot))

    def write(self, batch, name, cfg_kw, tenant="t"):
        # a fresh id: the JAX package's reader caches decoded columns
        # process-wide by block id
        block_id = f"{name}-{uuid.uuid4()}"
        jmeta = jcreate.write_block([to_jax(batch)], tenant, self.jb, JConfig(**cfg_kw),
                                    block_id=block_id)
        tmeta = create.write_block([batch], tenant, self.tb, BlockConfig(**cfg_kw),
                                   block_id=block_id, device="cpu")
        return jmeta, tmeta

    def objects(self, jmeta, tmeta, tenant="t"):
        return (block_objects(self.jroot, tenant, jmeta.block_id),
                block_objects(self.troot, tenant, tmeta.block_id))


@pytest.mark.parametrize("rules", ["default", "none"])
@pytest.mark.parametrize("codec", ["none", "zlib", "auto"])
def test_write_block_matches_jax(tmp_path, rules, codec):
    cfg_kw = {"codec": codec, "row_group_spans": 512}
    if rules == "none":
        cfg_kw["step_partial_rules"] = ()
    pair = Pair(tmp_path)
    batch = synth.make_batch(400, 6, seed=3)
    jmeta, tmeta = pair.write(batch, "b1", cfg_kw)
    a, b = pair.objects(jmeta, tmeta)
    assert_same_objects(a, b)
    blk = VtpuBackendBlock(tmeta, pair.tb)
    rgs = blk.index().row_groups
    assert len(rgs) > 1
    codecs = {pm.codec for rg in rgs for pm in rg.pages.values()}
    assert codecs & set(LIGHTWEIGHT_CODECS), codecs
    assert any(rg.partials for rg in rgs) == (rules == "default")
    assert tmeta.est_distinct_traces == jmeta.est_distinct_traces > 0


@pytest.mark.parametrize("n_traces,spans", [(1, 1), (3, 5), (700, 3)])
def test_write_block_small_and_ragged_matches_jax(tmp_path, n_traces, spans):
    pair = Pair(tmp_path)
    batch = synth.make_batch(n_traces, spans, seed=n_traces)
    jmeta, tmeta = pair.write(batch, "b", {"row_group_spans": 256})
    assert_same_objects(*pair.objects(jmeta, tmeta))


def _all_rows(blk):
    parts = list(blk.iter_trace_batches())
    cols = {k: np.concatenate([p.cols[k] for p in parts]) for k in parts[0].cols}
    return cols, [p.num_attrs for p in parts]


def test_each_package_reads_the_others_blocks(tmp_path):
    pair = Pair(tmp_path)
    batch = synth.make_batch(300, 4, seed=5)
    jmeta, tmeta = pair.write(batch, "b", {"row_group_spans": 256})
    from tempo_tpu.backend.base import BlockMeta as JMeta
    from tempo_tpu_torch.backend.base import BlockMeta

    # the port reads the JAX-written block, the JAX package the port's
    port_reads = VtpuBackendBlock(BlockMeta.from_json(jmeta.to_json()), TypedBackend(
        LocalBackend(pair.jroot)))
    jax_reads = JBlock(JMeta.from_json(tmeta.to_json()), JTyped(JLocal(pair.troot)))
    for blk in (port_reads, jax_reads):
        cols, n_attrs = _all_rows(blk)
        for k, v in batch.cols.items():
            np.testing.assert_array_equal(cols[k], v, err_msg=k)
        assert sum(n_attrs) == batch.num_attrs
        assert blk.dictionary().entries == batch.dictionary.entries


def _trace_repr(t):
    return None if t is None else (t.trace_id, repr(t.batches))


def test_find_trace_by_id_hits_misses_and_scrub(tmp_path):
    pair = Pair(tmp_path)
    batch = synth.make_batch(500, 4, seed=9)
    jmeta, tmeta = pair.write(batch, "b", {"row_group_spans": 512})
    jblk, tblk = JBlock(jmeta, pair.jb), VtpuBackendBlock(tmeta, pair.tb)
    firsts, _ = batch.trace_boundaries()
    present = [batch.cols["trace_id"][i].astype(">u4").tobytes() for i in firsts[::7]]
    rng = np.random.default_rng(1)
    absent = [rng.integers(0, 2**32, 4, np.uint32).astype(">u4").tobytes() for _ in range(60)]
    absent.append(b"\x00" * 16)  # below the block's min_id
    absent.append(b"\xff" * 16)  # above its max_id
    for tid in present:
        got = tblk.find_trace_by_id(tid)
        assert got is not None and got.trace_id == tid
        assert _trace_repr(got) == _trace_repr(jblk.find_trace_by_id(tid))
        assert got.span_count() == 4
    for tid in absent:
        assert tblk.find_trace_by_id(tid) is None
        assert jblk.find_trace_by_id(tid) is None
    n_pages = sum(len(rg.pages) for rg in tblk.index().row_groups)
    assert tblk.scrub() == jblk.scrub() == n_pages


def test_device_sketch_accumulator_matches_one_shot_sketch_step():
    cfg = BlockConfig()
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 2**32, (20_000, 4), np.uint32)
    acc = create.DeviceSketchAccumulator(cfg, len(ids), device="cpu")
    acc._FLUSH_IDS = 3000  # several flushes into the same buffers
    for lo in range(0, len(ids), 1700):
        acc.update_ids(ids[lo:lo + 1700])
    acc.update_ids(ids[:500])  # repeated IDs change nothing
    got = acc.finish()
    assert acc.launches > 1 and acc.d2h_bytes == (got["bloom_words"].size + 1) * 4
    words, est = create._sketch_step(torch.from_numpy(ids.astype(np.int64)), got["bloom_plan"],
                                     sketch.HLLPlan(cfg.hll_precision))
    np.testing.assert_array_equal(got["bloom_words"], words.numpy().astype(np.uint32))
    assert got["est_distinct"] == int(float(np.float32(est.item())))
    # every ID tests positive in its own shard, as the read path tests it
    p = got["bloom_plan"]
    shard = bloom.shard_for_ids(ids, p)
    for s in np.unique(shard)[:4]:
        sel = ids[shard == s]
        assert bloom.np_test_one_shard(got["bloom_words"][s], sel, p).all()


def _jax_stored(ids: np.ndarray, cfg: BlockConfig):
    pad = cfg.bucket_for(len(ids))
    plan = jbloom.plan(pad, cfg.bloom_fp, cfg.bloom_shard_size_bytes)
    ids_p, valid = jcreate._pad_ids(ids, pad)
    packed = np.asarray(jcreate._sketch_step(plan, jsketch.HLLPlan(cfg.hll_precision))(
        jnp.asarray(ids_p), jnp.asarray(valid)))
    return jcreate._unpack_sketch(packed, plan)


def _port_stored(ids: np.ndarray, cfg: BlockConfig):
    plan = bloom.plan(cfg.bucket_for(len(ids)), cfg.bloom_fp, cfg.bloom_shard_size_bytes)
    packed = create._pack_sketch(*create._sketch_step(
        create._ids_to_device(ids, torch.device("cpu")), plan, sketch.HLLPlan(cfg.hll_precision)))
    return create._unpack_sketch(packed.numpy().view(np.uint32), plan)


@pytest.mark.parametrize("seed", range(8))
def test_stored_hll_estimate_matches_jax(seed):
    """The int a block stores in meta.json, from 1 trace to 2**20: the
    port sums exactly and rounds once, so it is the same on every device;
    it must equal the JAX package's over these inputs."""
    cfg = BlockConfig()
    rng = np.random.default_rng(seed)
    sizes = [1, 2, 37, 1000, 5000, 9000, 11_000, 60_000]
    if seed == 0:
        sizes.append(1 << 20)
    for n in sizes:
        ids = rng.integers(0, 2**32, (n, 4), np.uint32)
        jw, jest = _jax_stored(ids, cfg)
        tw, test = _port_stored(ids, cfg)
        assert test == jest, (seed, n, test, jest)
        np.testing.assert_array_equal(tw, jw)


def test_write_block_without_device_needs_cuda(tmp_path):
    be = TypedBackend(LocalBackend(str(tmp_path)))
    batch = synth.make_batch(10, 2)
    if torch.cuda.is_available():
        assert create.write_block([batch], "t", be, BlockConfig()).total_objects == 10
        assert create.DeviceSketchAccumulator(BlockConfig(), 10).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create.write_block([batch], "t", be, BlockConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create.DeviceSketchAccumulator(BlockConfig(), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("n_traces", [1, 700, 5000])
def test_write_block_on_the_card_matches_cpu(tmp_path, cuda_device, n_traces):
    """The bloom and HLL built on the card give the same stored block."""
    batch = synth.make_batch(n_traces, 5, seed=21)
    cfg = BlockConfig(row_group_spans=1024)
    objects = []
    for dev in ("cuda", "cpu"):
        be = TypedBackend(LocalBackend(str(tmp_path / dev)))
        create.write_block([batch], "t", be, cfg, block_id="blk", device=dev)
        objects.append(block_objects(str(tmp_path / dev), "t", "blk"))
    assert_same_objects(*objects)


@pytest.mark.cuda
def test_device_sketch_accumulator_on_the_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 2**32, (30_000, 4), np.uint32)
    got = []
    for dev in ("cuda", "cpu"):
        acc = create.DeviceSketchAccumulator(BlockConfig(), len(ids), device=dev)
        for lo in range(0, len(ids), 2500):
            acc.update_ids(ids[lo:lo + 2500])
        got.append(acc.finish())
    np.testing.assert_array_equal(got[0]["bloom_words"], got[1]["bloom_words"])
    assert got[0]["est_distinct"] == got[1]["est_distinct"]


@pytest.mark.parametrize("codec", ["none", "zlib", "auto"])
def test_serialized_batch_segment_matches_jax(codec):
    """The standalone batch segment: the same bytes as the JAX package's
    (the dictionary after gunzip), and each package decodes the other's."""
    from tempo_tpu.encoding.vtpu import format as jfmt
    from tempo_tpu_torch.encoding.vtpu import format as fmt

    batch = synth.make_batch(120, 5, seed=11)
    ours, theirs = fmt.serialize_batch(batch, codec), jfmt.serialize_batch(to_jax(batch), codec)
    hlen = int.from_bytes(ours[len(fmt.MAGIC):len(fmt.MAGIC) + 4], "little")
    dict_len = json.loads(ours[len(fmt.MAGIC) + 4:len(fmt.MAGIC) + 4 + hlen])["dict_len"]
    assert len(ours) == len(theirs)
    assert ours[:-dict_len] == theirs[:-dict_len]
    assert gzip.decompress(ours[-dict_len:]) == gzip.decompress(theirs[-dict_len:])
    for got in (fmt.deserialize_batch(theirs), jfmt.deserialize_batch(ours)):
        for k, v in batch.cols.items():
            np.testing.assert_array_equal(got.cols[k], v, err_msg=k)
        for k, v in batch.attrs.items():
            np.testing.assert_array_equal(got.attrs[k], v, err_msg=k)
        assert got.dictionary.entries == batch.dictionary.entries


def test_trace_objects_round_trip_like_jax():
    """batch_to_traces, combine_traces and traces_to_batch give what the
    JAX package's give on the same spans."""
    from tempo_tpu.model import trace as jtrace
    from tempo_tpu_torch.model import trace

    batch = synth.make_batch(60, 4, seed=12)
    ours, theirs = trace.batch_to_traces(batch), jtrace.batch_to_traces(to_jax(batch))
    assert [_trace_repr(t) for t in ours] == [_trace_repr(t) for t in theirs]
    # two overlapping partials of every trace: the combiner dedupes by span id
    for t, jt in zip(ours, theirs):
        halves = [trace.Trace(t.trace_id, [(r, s[:3]) for r, s in t.batches]),
                  trace.Trace(t.trace_id, [(r, s[1:]) for r, s in t.batches])]
        jhalves = [jtrace.Trace(jt.trace_id, [(r, s[:3]) for r, s in jt.batches]),
                   jtrace.Trace(jt.trace_id, [(r, s[1:]) for r, s in jt.batches])]
        got = trace.combine_traces(halves + [None])
        assert _trace_repr(got) == _trace_repr(jtrace.combine_traces(jhalves + [None]))
        assert got.span_count() == t.span_count()
    assert trace.combine_traces([None]) is None
    rebuilt, jrebuilt = trace.traces_to_batch(ours), jtrace.traces_to_batch(theirs)
    assert rebuilt.dictionary.entries == jrebuilt.dictionary.entries
    for group in ("cols", "attrs"):
        for k, v in getattr(jrebuilt, group).items():
            np.testing.assert_array_equal(getattr(rebuilt, group)[k], v, err_msg=k)
    assert [_trace_repr(t) for t in trace.batch_to_traces(rebuilt)] == \
        [_trace_repr(t) for t in ours]


def test_zone_prunes_matches_jax(tmp_path):
    """Row-group pruning by zone maps for tag predicates and duration
    bounds, over every row group of a block each package wrote."""
    from tempo_tpu.encoding.common import SearchRequest as JRequest
    from tempo_tpu.encoding.vtpu.block import zone_prunes as jzone_prunes
    from tempo_tpu_torch.encoding.common import SearchRequest
    from tempo_tpu_torch.encoding.vtpu.block import zone_prunes

    pair = Pair(tmp_path)
    batch = synth.make_batch(400, 6, seed=13)
    jmeta, tmeta = pair.write(batch, "b", {"row_group_spans": 256})
    jrgs = JBlock(jmeta, pair.jb).index().row_groups
    trgs = VtpuBackendBlock(tmeta, pair.tb).index().row_groups
    assert len(trgs) == len(jrgs) > 2
    d = batch.dictionary
    c = batch.cols
    names = np.unique(c["name"])
    keys = np.unique(batch.attrs["attr_key"])
    dur = np.sort(c["duration_nano"])
    absent = np.array([len(d.entries) + 5], np.uint32)
    cases = [
        ({"span_eq": [("name", names[:1])], "attr": []}, {}),
        ({"span_eq": [("service", np.unique(c["service"])[-1:]), ("name", names[-2:])],
          "attr": []}, {}),
        ({"span_eq": [("name", absent)], "attr": []}, {}),
        ({"span_eq": [("http_status", np.array([404], np.uint32))], "attr": []}, {}),
        ({"span_eq": [], "attr": [(int(keys[0]), np.array([1], np.uint32))]}, {}),
        ({"span_eq": [], "attr": [(int(absent[0]), np.array([1], np.uint32))]}, {}),
        ({"span_eq": [], "attr": []}, {"min_duration_ns": int(dur[-len(dur) // 50])}),
        ({"span_eq": [], "attr": []}, {"max_duration_ns": int(dur[len(dur) // 50])}),
        ({"span_eq": [("name", names)], "attr": []},
         {"min_duration_ns": int(dur[len(dur) // 2]), "max_duration_ns": int(dur[-1])}),
    ]
    verdicts = []
    for preds, req in cases:
        got = [zone_prunes(rg, preds, SearchRequest(**req)) for rg in trgs]
        assert got == [jzone_prunes(rg, preds, JRequest(**req)) for rg in jrgs], (preds, req)
        verdicts += got
    assert any(verdicts) and not all(verdicts)
