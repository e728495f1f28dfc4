"""Sketch state carried from the JAX package into the port.

JAX builds a bloom filter, HLL registers and count-min counts on batch
A; convert.py carries them into the port, which folds in batch B; the
result must equal JAX folding A then B."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.metrics_engine import HostAccumulator as JHost
from tempo_tpu.metrics_engine import compile_metrics_plan as j_compile
from tempo_tpu.metrics_engine import eval_batch as j_eval_batch
from tempo_tpu.model import synth as jsynth
from tempo_tpu.ops import bloom as jbloom
from tempo_tpu.ops import sketch as jsketch
from tempo_tpu_torch import convert
from tempo_tpu_torch.ops import bloom, sketch


def _batches(n=1500):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**32, (n, 4), np.uint32)
    b = rng.integers(0, 2**32, (n, 4), np.uint32)
    b[: n // 3] = a[: n // 3]  # overlap between the batches
    return a, b


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


def test_hll_carried_across():
    a, b = _batches()
    jp = jsketch.HLLPlan(12)
    ja = jsketch.hll_update(jsketch.hll_init(jp), jnp.asarray(a), jp)
    want = jsketch.hll_update(ja, jnp.asarray(b), jp)
    regs = convert.u32_to_torch(np.asarray(ja), "cpu")
    got = sketch.hll_update(regs, _t(b), convert.hll_plan(jp))
    np.testing.assert_array_equal(np.asarray(want), convert.u32_to_numpy(got))


@pytest.mark.parametrize("via_bytes", [False, True])
def test_bloom_carried_across(via_bytes):
    a, b = _batches()
    jp = jbloom.plan(3000, 0.01, 1024)
    ja = np.asarray(jbloom.build(jnp.asarray(a), jp))
    want = np.asarray(jbloom.merge(jnp.asarray(ja), jbloom.build(jnp.asarray(b), jp)))
    if via_bytes:
        # the block's on-disk form: one little-endian object per shard
        ja = np.stack([jbloom.shard_from_bytes(jbloom.shard_to_bytes(s)) for s in ja])
    p = convert.bloom_plan(jp)
    got = bloom.merge(convert.u32_to_torch(ja, "cpu"), bloom.build(_t(b), p))
    np.testing.assert_array_equal(want, convert.u32_to_numpy(got))


def test_cm_carried_across():
    a, b = _batches()
    jp = jsketch.CMPlan(4, 1 << 10)
    w = np.random.default_rng(2).integers(0, 2**32, len(b), np.uint32)
    ja = jsketch.cm_update(jsketch.cm_init(jp), jnp.asarray(a), jp)
    want = jsketch.cm_update(ja, jnp.asarray(b), jp, weights=jnp.asarray(w))
    got = sketch.cm_update(convert.u32_to_torch(np.asarray(ja), "cpu"), _t(b),
                           convert.cm_plan(jp), weights=_t(w))
    np.testing.assert_array_equal(np.asarray(want), convert.u32_to_numpy(got))


def test_metrics_counts_carried_across():
    q = "{ } | quantile_over_time(duration, 0.5)"
    jplan = j_compile(q, 1_700_000_000, 1_700_000_300, 60)
    acc = JHost(jplan)
    batch = jsynth.make_batch(100, 4, seed=1)
    acc.add(j_eval_batch(jplan, batch, batch.dictionary, acc.series))
    t = convert.counts_to_torch(acc.merged_counts(), "cpu")
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(convert.counts_to_numpy(t), acc.merged_counts())
    assert convert.histogram_plan(jplan.hist) == sketch.HistogramPlan(
        **convert.plan_fields(jplan.hist))


def test_plans_round_trip_to_jax_classes():
    p = bloom.plan(5000, 0.02)
    assert jbloom.BloomPlan(**convert.plan_fields(p)) == jbloom.plan(5000, 0.02)
    assert jsketch.CMPlan(**convert.plan_fields(sketch.CMPlan(2, 64))) == jsketch.CMPlan(2, 64)


def test_u32_state_is_checked():
    with pytest.raises(TypeError):
        convert.u32_to_torch(np.zeros(3, np.int64), "cpu")
    with pytest.raises(ValueError):
        convert.u32_to_numpy(torch.tensor([-1]))
