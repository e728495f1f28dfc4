"""The port's device ops (tempo_tpu_torch.ops) against the JAX package's.

The same numpy inputs, made from a seed, go through both packages on the
CPU; every comparison is bit-exact except hll_estimate, whose float32
sum runs in another order (rtol 1e-6; the int a block stores must be
equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import bloom as jbloom
from tempo_tpu.ops import hashing as jhash
from tempo_tpu.ops import merge as jmerge
from tempo_tpu.ops import sketch as jsketch
from tempo_tpu_torch import convert
from tempo_tpu_torch.ops import bloom, hashing, merge, sketch


def T(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor, unsigned ints widened to int64."""
    a = np.asarray(a)
    if a.dtype.kind == "u":
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(jax_out, torch_out) -> None:
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def _limbs(n, seed, width=4):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (n, width), np.uint32)
    x[:4] = [[0] * width, [0xFFFFFFFF] * width, [0, 0xFFFFFFFF] * (width // 2),
             [0xFFFFFFFF, 0] * (width // 2)]
    return x


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2, 4])
def test_fnv1a_32(width):
    x = _limbs(257, width, width=max(width, 2))[:, :width]
    eq(jhash.fnv1a_32(jnp.asarray(x)), hashing.fnv1a_32(T(x)))


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF, 2**40 + 3])
def test_fmix32(seed):
    h = np.random.default_rng(3).integers(0, 2**32, 512, np.uint32)
    h[:3] = [0, 1, 0xFFFFFFFF]
    eq(jhash.fmix32(jnp.asarray(h), seed), hashing.fmix32(T(h), seed))


def test_fmix32_matches_numpy_mirror_on_edges():
    h = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    np.testing.assert_array_equal(jhash.np_fmix32(h, 7), hashing.fmix32(T(h), 7).numpy())


@pytest.mark.parametrize("n,seed", [(1, 0), (4, 0x5BD1E995), (7, 11)])
def test_hash_streams(n, seed):
    x = _limbs(300, n)
    eq(jhash.hash_streams(jnp.asarray(x), n, seed), hashing.hash_streams(T(x), n, seed))


@pytest.mark.parametrize("tenant", ["single-tenant", "acme", "ünï", ""])
@pytest.mark.parametrize("seed", [0, 3])
def test_ring_tokens_equal(tenant, seed):
    """The ring tokens that place traces on ingesters (distributor) and
    find their replicas (querier)."""
    limbs = np.random.default_rng(seed).integers(0, 2**32, (64, 4), dtype=np.uint32)
    got = hashing.np_token_for_ids(tenant, limbs)
    np.testing.assert_array_equal(got, jhash.np_token_for_ids(tenant, limbs))
    for row, tok in zip(limbs[:8], got[:8]):
        tid = hashing.limbs_to_trace_id(row)
        assert tid == jhash.limbs_to_trace_id(row)
        assert hashing.token_for(tenant, tid) == jhash.token_for(tenant, tid) == int(tok)


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def _merge_inputs(kind, n=512, seed=0):
    rng = np.random.default_rng(seed)
    tids = rng.integers(0, 2**32, (n, 4), np.uint32)
    sids = rng.integers(0, 2**32, (n, 2), np.uint32)
    valid = rng.random(n) > 0.1
    if kind == "dups":
        tids[: n // 4] = tids[n // 4 : n // 2]
        sids[: n // 4] = sids[n // 4 : n // 2]
        tids[n // 2 : n // 2 + 16] = tids[0]  # several spans of one trace
    elif kind == "all_invalid":
        valid[:] = False
    elif kind == "all_duplicate":
        tids[:] = tids[0]
        sids[:] = sids[0]
        valid[:] = True
    elif kind == "n1":
        tids, sids, valid = tids[:1], sids[:1], valid[:1] | True
    elif kind == "ties_high_bit":
        # keys differing only in limbs with the top bit set, and equal keys
        # across valid/invalid rows: the stable order must match lexsort
        tids[:] = [0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0]
        sids[:, 0] = rng.choice([0, 0x80000000, 0xFFFFFFFF], n)
        sids[:, 1] = rng.choice([1, 0x80000001], n)
    return tids, sids, valid


@pytest.mark.parametrize("kind", ["random", "dups", "all_invalid", "all_duplicate", "n1",
                                  "ties_high_bit"])
@pytest.mark.parametrize("with_valid", [True, False])
def test_merge_spans(kind, with_valid):
    tids, sids, valid = _merge_inputs(kind)
    jv = jnp.asarray(valid) if with_valid else None
    tv = T(valid) if with_valid else None
    want = jmerge.merge_spans(jnp.asarray(tids), jnp.asarray(sids), jv)
    got = merge.merge_spans(T(tids), T(sids), tv)
    assert set(got) == set(want)
    for k in want:
        eq(want[k], got[k])
    assert got["perm"].dtype == torch.int32
    assert got["trace_seg"].dtype == torch.int32


def test_merge_spans_matches_numpy_mirror():
    tids, sids, valid = _merge_inputs("dups", n=777, seed=5)
    want = jmerge.np_merge_spans(tids, sids, valid)
    got = merge.merge_spans(T(tids), T(sids), T(valid))
    for k in ("perm", "keep", "trace_seg"):
        np.testing.assert_array_equal(want[k], got[k].numpy())
    assert want["n_rows"] == int(got["n_rows"]) and want["n_traces"] == int(got["n_traces"])


# ---------------------------------------------------------------------------
# bloom
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_items,fp,shard_bytes", [(1000, 0.01, 100 * 1024),
                                                    (5000, 0.05, 256),
                                                    (300, 0.001, 64)])
def test_bloom_build_and_test(n_items, fp, shard_bytes):
    jp = jbloom.plan(n_items, fp, shard_bytes)
    p = convert.bloom_plan(jp)
    assert p == bloom.plan(n_items, fp, shard_bytes)
    ids = _limbs(n_items, n_items)
    valid = np.random.default_rng(1).random(n_items) > 0.2
    jw = jbloom.build(jnp.asarray(ids), jp, valid=jnp.asarray(valid))
    tw = bloom.build(T(ids), p, valid=T(valid))
    eq(jw, tw)
    eq(jbloom.build(jnp.asarray(ids), jp), bloom.build(T(ids), p))
    probe = np.concatenate([ids, _limbs(n_items, n_items + 1)])
    eq(jbloom.test(jw, jnp.asarray(probe), jp), bloom.test(tw, T(probe), p))
    assert bool(bloom.test(tw, T(ids[valid]), p).all())  # no false negatives
    shards = jbloom.shard_for_ids(probe, jp)
    for s in np.unique(shards)[:3]:
        rows = probe[shards == s]
        eq(jbloom.test_one_shard(jw[int(s)], jnp.asarray(rows), jp),
           bloom.test_one_shard(tw[int(s)], T(rows), p))


def test_bloom_shard_bytes_roundtrip():
    p = bloom.plan(2000, 0.01, 512)
    tw = bloom.build(T(_limbs(2000, 9)), p)
    raw = bloom.shard_to_bytes(convert.u32_to_numpy(tw[0]))
    assert raw == jbloom.shard_to_bytes(convert.u32_to_numpy(tw[0]))
    np.testing.assert_array_equal(bloom.shard_from_bytes(raw), jbloom.shard_from_bytes(raw))


# ---------------------------------------------------------------------------
# sketches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", [4, 12, 14])
def test_hll_update_and_estimate(precision):
    jp = jsketch.HLLPlan(precision)
    p = convert.hll_plan(jp)
    ids = _limbs(3000, precision)
    valid = np.random.default_rng(2).random(3000) > 0.3
    jr = jsketch.hll_update(jsketch.hll_init(jp), jnp.asarray(ids), jp, valid=jnp.asarray(valid))
    tr = sketch.hll_update(sketch.hll_init(p, "cpu"), T(ids), p, valid=T(valid))
    eq(jr, tr)
    eq(jsketch.hll_update(jsketch.hll_init(jp), jnp.asarray(ids), jp),
       sketch.hll_update(sketch.hll_init(p, "cpu"), T(ids), p))
    je = float(jsketch.hll_estimate(jr, jp))
    te = sketch.hll_estimate(tr, p)
    assert te.dtype == torch.float32
    np.testing.assert_allclose(float(te), je, rtol=1e-6)
    assert int(float(te)) == int(je)  # the int a block stores (create.py)


def test_clz32_edges():
    x = np.array([0, 1, 2, 3, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    want = [32 - int(v).bit_length() for v in x]
    assert sketch._clz32(T(x)).tolist() == want


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cm_update(weighted, masked):
    jp = jsketch.CMPlan(4, 1 << 10)
    p = convert.cm_plan(jp)
    rng = np.random.default_rng(4)
    ids = _limbs(2000, 4)
    ids[1000:] = ids[:1000]
    w = rng.integers(0, 2**32, 2000, np.uint32) if weighted else None
    valid = rng.random(2000) > 0.25 if masked else None
    jc = jsketch.cm_update(jsketch.cm_init(jp), jnp.asarray(ids), jp,
                           weights=None if w is None else jnp.asarray(w),
                           valid=None if valid is None else jnp.asarray(valid))
    tc = sketch.cm_update(sketch.cm_init(p, "cpu"), T(ids), p,
                          weights=None if w is None else T(w),
                          valid=None if valid is None else T(valid))
    eq(jc, tc)
    eq(jsketch.cm_query(jc, jnp.asarray(ids), jp), sketch.cm_query(tc, T(ids), p))
    eq(jsketch.cm_merge(jc, jc), sketch.cm_merge(tc, tc))


def test_histogram_quantile():
    jp = jsketch.HistogramPlan()
    p = convert.histogram_plan(jp)
    v = np.random.default_rng(5).integers(1, 10**10, 5000).astype(np.float64)
    np.testing.assert_array_equal(jp.np_bucket_of(v), p.np_bucket_of(v))
    counts = np.bincount(p.np_bucket_of(v), minlength=p.n_buckets)
    np.testing.assert_array_equal(jsketch.np_hist_quantile(counts, [0.5, 0.99], jp),
                                  sketch.np_hist_quantile(counts, [0.5, 0.99], p))
