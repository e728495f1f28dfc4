"""The whole slice: TraceQL metrics query_range in the port against the
JAX package.

The same make_batch seeds go through JAX (compile_metrics_plan ->
eval_batch -> DeviceAccumulator -> to_wire -> merge_wire ->
finalize_matrix) and through the port on the CPU; the resulting matrices
must be equal as dicts."""

import pytest

from tempo_tpu import metrics_engine as JM
from tempo_tpu.model import synth as jsynth
from tempo_tpu_torch import metrics_engine as TM
from tempo_tpu_torch.model import synth as tsynth

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


def test_make_accumulator_without_device_needs_cuda():
    import torch

    plan = TM.compile_metrics_plan("{ } | rate()", BASE_S, BASE_S + 60, 60)
    if torch.cuda.is_available():
        assert isinstance(TM.make_accumulator(plan), TM.DeviceAccumulator)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_accumulator(plan)
