"""The whole slice: TraceQL metrics query_range in the port against the
JAX package.

The same make_batch seeds go through JAX (compile_metrics_plan ->
eval_batch -> DeviceAccumulator -> to_wire -> merge_wire ->
finalize_matrix) and through the port on the CPU; the resulting matrices
must be equal as dicts."""

import numpy as np
import pytest

from tempo_tpu import metrics_engine as JM
from tempo_tpu.model import synth as jsynth
from tempo_tpu_torch import metrics_engine as TM
from tempo_tpu_torch.model import synth as tsynth
from tempo_tpu_torch.util.devicetiming import STATS

BASE_S = 1_700_000_000

QUERIES = [
    "{ } | rate()",
    "{ } | rate() by (resource.service.name)",
    "{ status = error } | count_over_time() by (name)",
    "{ span.http.method = \"GET\" } | count_over_time()",
    "{ } | quantile_over_time(duration, 0.5, 0.9, 0.99) by (resource.service.name)",
    "{ duration > 100ms } | quantile_over_time(duration, 0.5)",
    "{ } | histogram_over_time(duration) by (name)",
    "{ name =~ \"db.*\" } | histogram_over_time(duration)",
    "{ } | rate() by (span.http.status_code)",
]


def _run(M, synth, make_acc, q, n_batches=5, flush_rows=1 << 20, max_series=64, exemplars=0):
    plan = M.compile_metrics_plan(q, BASE_S, BASE_S + 300, 60, max_series=max_series,
                                  exemplars=exemplars)
    acc = make_acc(M, plan, flush_rows)
    for i in range(n_batches):
        # the last batch falls past the window's end: its spans drop
        b = synth.make_batch(150, 6, seed=i, base_time_ns=(BASE_S + 60 * i + 30) * 10**9)
        acc.add(M.eval_batch(plan, b, b.dictionary, acc.series), b)
    merged = M.new_wire()
    M.merge_wire(merged, acc.to_wire(), plan)
    return M.finalize_matrix(plan, merged)


def _jax_device(M, plan, flush_rows):
    return M.DeviceAccumulator(plan, flush_rows=flush_rows)


def _port_device(M, plan, flush_rows):
    return M.DeviceAccumulator(plan, flush_rows=flush_rows, device="cpu")


@pytest.mark.parametrize("q", QUERIES)
def test_query_range_matches_jax(q):
    want = _run(JM, jsynth, _jax_device, q)
    assert want["result"], "query matched nothing; the comparison would be empty"
    assert _run(TM, tsynth, _port_device, q) == want
    # make_accumulator on the CPU takes the host fold: same answer
    assert _run(TM, tsynth, lambda M, p, f: M.make_accumulator(p, device="cpu"), q) == want


def test_query_range_with_frequent_flushes_and_series_cap():
    q = "{ } | rate() by (name)"
    want = _run(JM, jsynth, _jax_device, q, flush_rows=500, max_series=3)
    assert want["stats"]["seriesDropped"] > 0
    assert _run(TM, tsynth, _port_device, q, flush_rows=500, max_series=3) == want


def test_query_range_exemplars_match():
    q = "{ } | rate() by (resource.service.name)"
    want = _run(JM, jsynth, _jax_device, q, exemplars=2)
    assert want["exemplars"]
    assert _run(TM, tsynth, _port_device, q, exemplars=2) == want


@pytest.mark.parametrize("q", ["{ } | rate() by (name)",
                               "{ } | quantile_over_time(duration, 0.5, 0.99)"])
def test_device_accumulator_copies_counts_to_host_once(q):
    # several flushes add into one count vector on the device; the
    # query copies it to the host once, and to_wire twice agrees
    want = _run(JM, jsynth, _jax_device, q, flush_rows=400)
    accs = []

    def port_device(M, plan, flush_rows):
        accs.append(M.DeviceAccumulator(plan, flush_rows=flush_rows, device="cpu"))
        return accs[-1]

    d2h = STATS.d2h.get("seg_bincount", 0)
    assert _run(TM, tsynth, port_device, q, flush_rows=400) == want
    acc = accs[0]
    assert acc.dispatches > 1
    assert STATS.d2h.get("seg_bincount", 0) - d2h == acc.plan.n_slots * 8
    assert acc.to_wire() == acc.to_wire()
    assert STATS.d2h.get("seg_bincount", 0) - d2h == acc.plan.n_slots * 8


def test_make_accumulator_without_device_needs_cuda():
    import torch

    plan = TM.compile_metrics_plan("{ } | rate()", BASE_S, BASE_S + 60, 60)
    if torch.cuda.is_available():
        assert isinstance(TM.make_accumulator(plan), TM.DeviceAccumulator)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_accumulator(plan)


# ---------------------------------------------------------------------------
# evaluate_block: TraceQL metrics over a stored vtpu1 block
# ---------------------------------------------------------------------------

BLOCK_QUERIES = [
    # the three queries chip_smoke.py runs on the card
    "{ } | rate() by (resource.service.name)",
    "{ status = error } | count_over_time() by (name)",
    "{ } | quantile_over_time(duration, 0.5, 0.99) by (resource.service.name)",
    # filters answered in encoded space (premask) over rle/dct pages
    "{ name = \"db.query\" } | count_over_time() by (resource.service.name)",
    "{ resource.service.name = \"cart\" || name = \"render\" } | rate()",
    # zone maps prune every row group whose durations stay below 10s
    "{ duration > 10s } | count_over_time()",
]


@pytest.fixture(scope="module")
def block_pair(tmp_path_factory):
    """One block written by each package: 12 batches a minute apart,
    whose last 150 traces run 20 s, in row groups of 1024 spans."""
    from test_torch_blocks import Pair

    from tempo_tpu_torch.model.columnar import SpanBatch

    parts = [tsynth.make_batch(200, 6, seed=40 + i, base_time_ns=(BASE_S + 60 * i + 5) * 10**9)
             for i in range(12)]
    batch = SpanBatch.concat(parts)
    batch.cols["trace_id"][-900:, 0] |= 0xFFFF0000  # the long traces sort last
    batch.cols["duration_nano"][-900:] += 20 * 10**9
    batch = batch.sorted_by_trace()
    pair = Pair(tmp_path_factory.mktemp("blocks"))
    jmeta, tmeta = pair.write(batch, "q", {"row_group_spans": 1024})
    return pair, jmeta, tmeta


def _block_matrix(M, blk, plan, acc):
    M.evaluate.evaluate_block(plan, blk, acc)
    merged = M.new_wire()
    M.merge_wire(merged, acc.to_wire(), plan)
    return M.finalize_matrix(plan, merged)


@pytest.mark.parametrize("q", BLOCK_QUERIES)
def test_evaluate_block_matches_jax(block_pair, q):
    from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock

    pair, jmeta, tmeta = block_pair
    jplan = JM.compile_metrics_plan(q, BASE_S, BASE_S + 900, 60, max_series=64)
    tplan = TM.compile_metrics_plan(q, BASE_S, BASE_S + 900, 60, max_series=64)
    want = _block_matrix(JM, JBlock(jmeta, pair.jb), jplan, JM.HostAccumulator(jplan))
    assert want["result"], "query matched nothing; the comparison would be empty"
    for acc in (TM.DeviceAccumulator(tplan, flush_rows=3000, device="cpu"),
                TM.make_accumulator(tplan, device="cpu")):
        blk = VtpuBackendBlock(tmeta, pair.tb)
        assert _block_matrix(TM, blk, tplan, acc) == want
    if "10s" in q:
        assert want["stats"]["prunedRowGroups"] > 0
        assert blk.pruned_row_groups == want["stats"]["prunedRowGroups"]


@pytest.mark.parametrize("q", BLOCK_QUERIES[3:5])
def test_block_filters_take_the_encoded_path(block_pair, q):
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock

    pair, _, tmeta = block_pair
    plan = TM.compile_metrics_plan(q, BASE_S, BASE_S + 900, 60)
    blk = VtpuBackendBlock(tmeta, pair.tb)
    d = blk.dictionary()
    premasks = [TM.evaluate.rg_eval_view(plan, blk, rg, d)[1] for rg in blk.index().row_groups]
    assert all(p is not None for p in premasks)


def test_step_partial_hybrid_matches_jax(block_pair):
    from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
    from tempo_tpu.standing import rules as jrules
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
    from tempo_tpu_torch.standing import rules

    pair, jmeta, tmeta = block_pair
    q = "{ } | rate() by (resource.service.name)"
    start = BASE_S - BASE_S % 60  # a rule serves plans on its step grid
    jplan = JM.compile_metrics_plan(q, start, start + 900, 60)
    tplan = TM.compile_metrics_plan(q, start, start + 900, 60)
    jrule = jrules.match_rule(jplan, jrules.parse_rules(jrules.DEFAULT_STEP_RULES))
    trule = rules.match_rule(tplan, rules.parse_rules(rules.DEFAULT_STEP_RULES))
    assert trule is not None and trule.name == jrule.name
    jacc, tacc = JM.HostAccumulator(jplan), TM.DeviceAccumulator(tplan, device="cpu")
    jrules.evaluate_block_hybrid(jplan, jrule, JBlock(jmeta, pair.jb), jacc)
    rules.evaluate_block_hybrid(tplan, trule, VtpuBackendBlock(tmeta, pair.tb), tacc)
    assert tacc.stats["partialRowGroups"] > 0
    assert tacc.to_wire() == jacc.to_wire()
    # and the span path gives the same counts
    span_acc = TM.HostAccumulator(tplan)
    TM.evaluate.evaluate_block(tplan, VtpuBackendBlock(tmeta, pair.tb), span_acc)
    np.testing.assert_array_equal(span_acc.merged_counts(), tacc.merged_counts())


@pytest.mark.cuda
@pytest.mark.parametrize("q", BLOCK_QUERIES)
def test_evaluate_block_on_the_card_matches_jax(block_pair, q):
    import torch

    from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pair, jmeta, tmeta = block_pair
    jplan = JM.compile_metrics_plan(q, BASE_S, BASE_S + 900, 60, max_series=64)
    tplan = TM.compile_metrics_plan(q, BASE_S, BASE_S + 900, 60, max_series=64)
    want = _block_matrix(JM, JBlock(jmeta, pair.jb), jplan, JM.HostAccumulator(jplan))
    acc = TM.make_accumulator(tplan, device="cuda")
    assert isinstance(acc, TM.DeviceAccumulator)
    assert _block_matrix(TM, VtpuBackendBlock(tmeta, pair.tb), tplan, acc) == want


def test_evaluate_block_without_device_needs_cuda(block_pair):
    import torch

    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock

    pair, _, tmeta = block_pair
    plan = TM.compile_metrics_plan("{ } | rate()", BASE_S, BASE_S + 900, 60)
    blk = VtpuBackendBlock(tmeta, pair.tb)
    if torch.cuda.is_available():
        assert isinstance(TM.evaluate_block(plan, blk), TM.DeviceAccumulator)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.evaluate_block(plan, blk)
