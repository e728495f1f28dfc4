"""The port's mesh metrics on a mesh of CPU devices against the JAX
package's on its 8-device CPU mesh: make_sharded_bincount output for
output, and MeshMetricsEvaluator's counts, series table, stats and wire
bit-equal at 1, 2, 4 and 8 shards and to the host accumulator (as
tests/test_traceql_metrics.py holds the JAX evaluator)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tempo_tpu import metrics_engine as JM
from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
from tempo_tpu.parallel import metrics as jmetrics
from tempo_tpu_torch import metrics_engine as TM
from tempo_tpu_torch.encoding.common import BlockConfig
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.parallel import mesh as tmesh
from tempo_tpu_torch.parallel import metrics as tmetrics
from tempo_tpu_torch.util import devicetiming as tdt

from test_torch_blocks import Pair

CPU = torch.device("cpu")
BASE_S = 1_700_000_000
CFG = {"row_group_spans": 2048}
QUERIES = (
    "{} | rate() by (resource.service.name)",
    "{ span.http.status_code >= 500 } | rate() by (resource.service.name)",
    "{} | quantile_over_time(duration, 0.5, 0.9)",
    "{ status = error } | count_over_time() by (name)",
)


def jax_mesh(w: int, r: int):
    return jax.sharding.Mesh(np.asarray(jax.devices()[: w * r]).reshape(w, r),
                             ("window", "range"))


def port_mesh(w: int, r: int) -> tmesh.Mesh:
    return tmesh.Mesh(np.array([[CPU] * r] * w, dtype=object))


@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (2, 2), (1, 8)])
def test_sharded_bincount_matches_jax(shape):
    w, r = shape
    rng = np.random.default_rng(w + 7 * r)
    n_slots, n = 300, 512
    slots = rng.integers(-1, n_slots + 3, (w, r, n)).astype(np.int32)  # -1 and past the end drop
    weights = rng.integers(0, 50, (w, r, n)).astype(np.int32)
    want = np.asarray(jmetrics.make_sharded_bincount(jax_mesh(w, r), n_slots)(
        jnp.asarray(slots), jnp.asarray(weights)))
    got = tmetrics.make_sharded_bincount(port_mesh(w, r), n_slots)(slots, weights)
    assert got.dtype == np.int64
    assert np.array_equal(want.astype(np.int64), got)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    pair = Pair(tmp_path_factory.mktemp("mesh-metrics"))
    metas = [pair.write(synth.make_batch(600, 8, seed=40 + i,
                                         base_time_ns=(BASE_S + 5) * 10**9), f"q{i}", CFG)
             for i in range(3)]
    return pair, metas


def _plans(q):
    return (JM.compile_metrics_plan(q, BASE_S, BASE_S + 60, 10),
            TM.compile_metrics_plan(q, BASE_S, BASE_S + 60, 10))


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_mesh_evaluator_bit_identical_at_any_shard_count(store, q, n_shards):
    pair, metas = store
    jplan, tplan = _plans(q)
    jacc, tacc = JM.HostAccumulator(jplan), TM.HostAccumulator(tplan)
    bucket = BlockConfig(**CFG).bucket_for
    jev = jmetrics.MeshMetricsEvaluator(jax_mesh(1, n_shards), bucket)
    tev = tmetrics.MeshMetricsEvaluator(port_mesh(1, n_shards), bucket)
    d0 = tdt.dispatch_total.total(kernel="mesh_bincount")
    jev.evaluate_blocks((JBlock(jm, pair.jb) for jm, _ in metas), jplan, jacc)
    tev.evaluate_blocks((VtpuBackendBlock(tm, pair.tb) for _, tm in metas), tplan, tacc)
    assert tacc.counts.dtype == np.int64
    assert np.array_equal(jacc.counts, tacc.counts)
    assert tacc.series.slots == jacc.series.slots
    assert tacc.to_wire() == jacc.to_wire()
    assert tev.last_stats == jev.last_stats
    assert tdt.dispatch_total.total(kernel="mesh_bincount") - d0 == tev.last_stats["dispatches"]
    # and the host accumulator over the same blocks
    ref = TM.HostAccumulator(tplan)
    for _, tm in metas:
        TM.evaluate_block(tplan, VtpuBackendBlock(tm, pair.tb), ref)
    assert np.array_equal(ref.counts, tacc.counts)


def test_mesh_evaluator_two_windows(store):
    pair, metas = store
    jplan, tplan = _plans(QUERIES[0])
    jacc, tacc = JM.HostAccumulator(jplan), TM.HostAccumulator(tplan)
    bucket = BlockConfig(**CFG).bucket_for
    jmetrics.MeshMetricsEvaluator(jax_mesh(2, 2), bucket).evaluate_blocks(
        (JBlock(jm, pair.jb) for jm, _ in metas), jplan, jacc)
    tmetrics.MeshMetricsEvaluator(port_mesh(2, 2), bucket).evaluate_blocks(
        (VtpuBackendBlock(tm, pair.tb) for _, tm in metas), tplan, tacc)
    assert np.array_equal(jacc.counts, tacc.counts)
    assert tacc.to_wire() == jacc.to_wire()
