"""The port's sharded compaction on a mesh of CPU devices against the
JAX package's on its 8-device CPU mesh, exactly.

The sharded step and the payload step output for output, bloom.psum_merge
against the JAX psum under shard_map, and VtpuCompactor with a mesh on
both payload planes at 1, 2, 4 and 8 shards: blocks byte-identical to
the JAX package's mesh block and to the port's one-device block, over
the inputs of dryrun_multichip and of tests/test_compactor_streaming.py
(the sharded-engine pair and two rounds of the merge-path fuzz)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tempo_tpu.encoding.common import BlockConfig as JConfig, CompactionOptions as JOptions
from tempo_tpu.encoding.vtpu.compactor import VtpuCompactor as JCompactor
from tempo_tpu.ops import bloom as jbloom
from tempo_tpu.parallel import compaction as jcomp
from tempo_tpu.parallel import mesh as jmesh
from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model import trace as tr
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.ops import bloom
from tempo_tpu_torch.parallel import compaction as tcomp
from tempo_tpu_torch.parallel import mesh as tmesh

from test_torch_blocks import Pair, assert_same_objects, block_objects

CPU = torch.device("cpu")


def jax_mesh(w: int, r: int):
    return jax.sharding.Mesh(np.asarray(jax.devices()[: w * r]).reshape(w, r),
                             ("window", "range"))


def port_mesh(w: int, r: int) -> tmesh.Mesh:
    return tmesh.Mesh(np.array([[CPU] * r] * w, dtype=object))


def _bucket(c: int) -> int:
    return max(1024, 1 << (max(c, 1) - 1).bit_length())


def _rows(seed: int, n: int = 4096):
    rng = np.random.default_rng(seed)
    tids = rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    sids = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    tids[n // 2:] = tids[: n - n // 2]  # duplicated traces ...
    sids[n // 2: n // 2 + n // 8] = sids[: n // 8]  # ... and duplicated spans
    return tids, sids


def _i64(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shapes_match_jax(n):
    assert tmesh.mesh_shape_for(n) == jmesh.mesh_shape_for(n)
    devs = [CPU] * 8
    gm = tmesh.get_mesh(n, devices=devs)
    jm = jmesh.get_mesh(n)
    assert (gm.shape["window"], gm.shape["range"]) == (jm.shape["window"], jm.shape["range"])
    cm = tmesh.compaction_mesh(n, devices=devs)
    jc = jmesh.compaction_mesh(n)
    assert (cm.shape["window"], cm.shape["range"]) == (jc.shape["window"], jc.shape["range"])


def test_mesh_refuses_more_devices_than_given():
    with pytest.raises(ValueError):
        tmesh.get_mesh(3, devices=[CPU, CPU])
    with pytest.raises(ValueError):
        tmesh.compaction_mesh(9, devices=[CPU] * 8)


def test_local_devices_seam():
    assert tmesh.local_devices("cpu") == [CPU]


@pytest.mark.parametrize("op", ["sum", "max", "or", "sum32"])
def test_reductions_over_range_and_both_axes(op):
    rng = np.random.default_rng(5)
    m = port_mesh(2, 4)
    parts = [torch.from_numpy(rng.integers(0, 2**32, 16, dtype=np.int64)) for _ in range(8)]
    per_w = tmesh.reduce_range(m, parts, op)
    f = {"sum": np.add, "sum32": np.add, "max": np.maximum, "or": np.bitwise_or}[op]
    arr = np.stack([p.numpy() for p in parts]).reshape(2, 4, 16)
    want = f.reduce(arr, axis=1)
    if op == "sum32":
        want &= 0xFFFFFFFF
    assert [list(x.numpy()) for x in per_w] == [list(x) for x in want]
    allw = f.reduce(arr.reshape(8, 16), axis=0)
    if op == "sum32":
        allw &= 0xFFFFFFFF
    assert list(tmesh.reduce_all(m, parts, op).numpy()) == list(allw)


# ---------------------------------------------------------------------------
# psum_merge and the sharded steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [2, 8])
def test_psum_merge_matches_jax(r):
    rng = np.random.default_rng(r)
    words = rng.integers(0, 2**32, (r, 3, 40), dtype=np.uint64).astype(np.uint32)
    words[:, :, ::3] = 0
    mesh = jax_mesh(1, r)
    f = jax.jit(jmesh.shard_map_compat(
        lambda w: jbloom.psum_merge(w[0, 0], "range")[None, None],
        mesh=mesh, in_specs=(P("window", "range"),), out_specs=P("window", "range")))
    want = np.asarray(f(jnp.asarray(words.reshape(1, r, 3, 40))))[0, 0]
    got = bloom.psum_merge([torch.from_numpy(w.astype(np.int64)) for w in words])
    assert np.array_equal(_i64(want), got.numpy())


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (2, 4), (1, 8)])
def test_sharded_step_matches_jax(shape):
    w, r = shape
    tids, sids = _rows(10 + w * r)
    t, s, v, _ = tcomp.partition_by_id_range(tids, sids, w * r, bucket=_bucket)
    jt, js, jv, _ = jcomp.partition_by_id_range(tids, sids, w * r, bucket=_bucket)
    assert np.array_equal(t, jt) and np.array_equal(s, js) and np.array_equal(v, jv)
    cap = t.shape[1]
    jplans, plans = jcomp.default_plans(1 << 12), tcomp.default_plans(1 << 12)
    jm = jax_mesh(w, r)
    jsh, jacc = jcomp.make_sharded_compactor(jm, jplans)(
        jnp.asarray(t.reshape(w, r, cap, 4)), jnp.asarray(s.reshape(w, r, cap, 2)),
        jnp.asarray(v.reshape(w, r, cap)), *jcomp.init_sketch_accumulators(jm, jplans))
    pm = port_mesh(w, r)
    tsh, tacc = tcomp.make_sharded_compactor(pm, plans)(
        t.reshape(w, r, cap, 4), s.reshape(w, r, cap, 2), v.reshape(w, r, cap),
        *tcomp.init_sketch_accumulators(pm, plans))
    for k in ("perm", "keep", "n_rows", "n_traces"):
        want = _i64(jsh[k]).reshape(w * r, -1)
        got = np.stack([_i64(x.numpy()).reshape(-1) for x in tsh[k]])
        assert np.array_equal(want, got), k
    for k in ("bloom", "hll", "cm", "total_rows", "total_traces"):
        got = np.stack([x.numpy() for x in tacc[k]]).astype(np.int64)
        assert np.array_equal(_i64(jacc[k]).reshape(got.shape), got), k


def _payload_inputs(seed: int, w: int, r: int):
    """One tile's shard inputs with payload lanes: duplicated spans, some
    with a differing duration or attr count (the combine path)."""
    rng = np.random.default_rng(seed)
    tids, sids = _rows(seed, 2048)
    n = tids.shape[0]
    lanes = rng.integers(0, 50, (n, tcomp.PAYLOAD_IN_LANES)).astype(np.uint32)
    lanes[n // 2: n // 2 + n // 8] = lanes[: n // 8]
    lanes[n // 2: n // 2 + n // 8: 3, 5] += 7  # duration lo differs
    lanes[n // 2 + 1: n // 2 + n // 8: 5, 11] += 1  # n_attrs differs
    lanes[:, 14] = np.arange(n, dtype=np.uint32)
    t, s, v, ridx = tcomp.partition_by_id_range(tids, sids, w * r, bucket=_bucket)
    lsh = lanes[np.maximum(ridx, 0)]
    lsh[ridx < 0] = 0
    cap = t.shape[1]
    return (t.reshape(w, r, cap, 4), s.reshape(w, r, cap, 2), v.reshape(w, r, cap),
            lsh.reshape(w, r, cap, tcomp.PAYLOAD_IN_LANES)), cap


@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (2, 2), (1, 8)])
def test_payload_step_matches_jax(shape):
    w, r = shape
    jplans, plans = jcomp.default_plans(1 << 12), tcomp.default_plans(1 << 12)
    jm, pm = jax_mesh(w, r), port_mesh(w, r)
    kept_cap, t_max = 8192, 4
    jstep = jcomp.make_payload_compactor(jm, jplans)
    tstep = tcomp.make_payload_compactor(pm, plans)
    jbufs = jcomp.init_payload_buffers(jm, kept_cap, kept_cap, t_max)
    jaccs = jcomp.init_sketch_accumulators(jm, jplans)
    tbufs = tcomp.init_payload_buffers(pm, kept_cap, kept_cap, t_max)
    taccs = tcomp.init_sketch_accumulators(pm, plans)
    ub_k = np.zeros(w * r, np.int64)
    for tile in range(2):  # two tiles: the cursors and logs advance
        args, cap = _payload_inputs(30 + tile, w, r)
        jbufs, jaccs = jstep(*(jnp.asarray(a) for a in args), *jbufs, *jaccs)
        tbufs, taccs = tstep(*args, tbufs, taccs, (ub_k, ub_k, tile))
        ub_k = ub_k + args[2].reshape(w * r, -1).sum(axis=1)
    want = np.asarray(jcomp.pack_payload_flush(*jbufs))
    got = tcomp.pack_payload_flush(pm, tbufs)
    assert want.dtype == got.dtype == np.uint32
    assert np.array_equal(want, got)
    for jx, tx in zip(jaccs, taccs):
        assert np.array_equal(_i64(jx), np.stack([x.numpy() for x in tx]))


def test_payload_step_refuses_a_tile_that_does_not_fit():
    pm = port_mesh(1, 2)
    plans = tcomp.default_plans(1 << 12)
    args, cap = _payload_inputs(3, 1, 2)
    step = tcomp.make_payload_compactor(pm, plans)
    accs = tcomp.init_sketch_accumulators(pm, plans)
    bufs = tcomp.init_payload_buffers(pm, cap + 10, cap + 10, 2)
    with pytest.raises(RuntimeError, match="does not fit"):
        step(*args, bufs, accs, (np.array([11, 0]), np.zeros(2, np.int64), 0))
    with pytest.raises(RuntimeError, match="does not fit"):
        step(*args, bufs, accs, (np.zeros(2, np.int64), np.zeros(2, np.int64), 2))
    # nothing was written
    assert all(int(b.abs().sum()) == 0 for group in bufs for b in group)


# ---------------------------------------------------------------------------
# VtpuCompactor with a mesh: blocks byte for byte
# ---------------------------------------------------------------------------


def _batch(traces) -> SpanBatch:
    return tr.traces_to_batch(traces).sorted_by_trace()


def _dryrun_blocks():
    """dryrun_multichip's pair (__graft_entry__.py:63-68): 40 + 40
    traces of 4 spans, 10 of B's repeating A's."""
    a = synth.make_traces(40, seed=1, spans_per_trace=4)
    b = synth.make_traces(40, seed=2, spans_per_trace=4)[:30] + a[:10]
    return _batch(a), _batch(b)


def _streaming_blocks():
    """test_compactor_streaming.py's sharded-engine pair (:173-180): 60 +
    60 traces, 20 of B's repeating A's."""
    a = synth.make_traces(60, seed=11)
    b = synth.make_traces(60, seed=12)[:40] + a[:20]
    return _batch(a), _batch(b)


def _fuzz_blocks(round_i: int):
    """test_compactor_streaming.py's merge-path fuzz job (:310-341, its
    seed 77, rounds 0-1): 2-4 blocks of fresh traces and RF copies of a
    shared base, some with a longer duration and an extra attribute (the
    combine path)."""
    rng = np.random.default_rng(77)
    for _ in range(round_i + 1):
        n_blocks = int(rng.integers(2, 5))
        base = synth.make_traces(int(rng.integers(30, 120)), seed=int(rng.integers(1 << 30)),
                                 spans_per_trace=int(rng.integers(1, 6)))
        out = []
        for _b in range(n_blocks):
            fresh = synth.make_traces(int(rng.integers(10, 80)), seed=int(rng.integers(1 << 30)),
                                      spans_per_trace=int(rng.integers(1, 6)))
            k = int(rng.integers(0, len(base) // 2 + 1))
            dups = []
            for t in base[:k]:
                if rng.random() < 0.4:
                    dups.append(tr.Trace(trace_id=t.trace_id, batches=[
                        (res, [tr.Span(trace_id=sp.trace_id, span_id=sp.span_id, name=sp.name,
                                       parent_span_id=sp.parent_span_id,
                                       start_unix_nano=sp.start_unix_nano,
                                       duration_nano=sp.duration_nano + int(rng.integers(1, 1000)),
                                       status_code=sp.status_code, kind=sp.kind,
                                       attributes={**sp.attributes,
                                                   "rf_extra": int(rng.integers(9))})
                               for sp in spans])
                        for res, spans in t.batches]))
                else:
                    dups.append(t)
            out.append(_batch(dups + fresh))
    return out


INPUTS = {
    "dryrun": (_dryrun_blocks, {"row_group_spans": 64}),
    "streaming": (_streaming_blocks, {"row_group_spans": 128}),
    "fuzz0": (lambda: _fuzz_blocks(0), {"row_group_spans": 128}),
    "fuzz1": (lambda: _fuzz_blocks(1), {"row_group_spans": 128}),
}


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("plane", ["host", "device"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_mesh_compaction_blocks_byte_identical(tmp_path, inputs, plane, shards):
    make, cfg_kw = INPUTS[inputs]
    pair = Pair(tmp_path)
    metas = [pair.write(b, f"b{i}", cfg_kw) for i, b in enumerate(make())]
    jm = jmesh.compaction_mesh(shards)
    pm = tmesh.compaction_mesh(shards, devices=[CPU] * 8)
    jc = JCompactor(JOptions(block_config=JConfig(**cfg_kw), mesh=jm, payload_plane=plane))
    tc = VtpuCompactor(CompactionOptions(block_config=BlockConfig(**cfg_kw), mesh=pm,
                                         payload_plane=plane))
    (jout,) = jc.compact([m[0] for m in metas], "t", pair.jb)
    (tout,) = tc.compact([m[1] for m in metas], "t", pair.tb)
    assert_same_objects(*pair.objects(jout, tout))
    assert tc.spans_combined == jc.spans_combined
    if inputs == "dryrun":
        assert tout.total_objects == 70  # duplicates collapsed
    elif inputs == "streaming":
        assert tout.total_objects == 100
    # and the port's one-device block
    one = VtpuCompactor(CompactionOptions(block_config=BlockConfig(**cfg_kw)), device="cpu")
    (tone,) = one.compact([m[1] for m in metas], "t", pair.tb)
    assert_same_objects(block_objects(pair.troot, "t", tout.block_id),
                        block_objects(pair.troot, "t", tone.block_id))
    assert one.spans_combined == tc.spans_combined
    for k in ("tiles", "dispatches", "collectives", "h2d_bytes"):
        assert tc.payload_stats[k] == jc.payload_stats[k], k
    if plane == "device":
        for k in ("d2h_flushes", "kept_rows", "dropped_rows"):
            assert tc.payload_stats[k] == jc.payload_stats[k], k
        assert tc.payload_stats["kept_rows"] == tout.total_spans
        assert list(tc.payload_stats["per_shard_kept"]) == list(jc.payload_stats["per_shard_kept"])
    else:
        assert list(tc.payload_stats["per_shard_rows"]) == list(jc.payload_stats["per_shard_rows"])


@pytest.mark.parametrize("plane", ["host", "device"])
def test_mesh_compaction_two_windows(tmp_path, plane):
    """A (2, 2) mesh: per-window accumulators merge on the host at finish."""
    cfg_kw = {"row_group_spans": 128}
    pair = Pair(tmp_path)
    metas = [pair.write(b, name, cfg_kw) for b, name in zip(_streaming_blocks(), "ab")]
    jc = JCompactor(JOptions(block_config=JConfig(**cfg_kw), mesh=jmesh.get_mesh(4),
                             payload_plane=plane))
    tc = VtpuCompactor(CompactionOptions(block_config=BlockConfig(**cfg_kw),
                                         mesh=tmesh.get_mesh(4, devices=[CPU] * 4),
                                         payload_plane=plane))
    (jout,) = jc.compact([m[0] for m in metas], "t", pair.jb)
    (tout,) = tc.compact([m[1] for m in metas], "t", pair.tb)
    assert_same_objects(*pair.objects(jout, tout))


def test_device_plane_needs_a_mesh():
    with pytest.raises(ValueError):
        VtpuCompactor(CompactionOptions(payload_plane="device"), device="cpu")
