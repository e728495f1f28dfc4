"""TraceQL metrics engine — range-vector queries over span batches.

Port of tempo_tpu/metrics_engine: span filters evaluate as vectorized
column scans (traceql/vector.py), span start times bucket into step
bins, and every aggregate reduces to ONE segmented bincount over a
combined (series, time-bin[, histogram-bucket]) slot index — host numpy
on the CPU, the hand-written CUDA kernel (ops/pallas_kernels.seg_bincount)
on the card.
"""

from tempo_tpu_torch.metrics_engine.evaluate import (  # noqa: F401
    DeviceAccumulator,
    HostAccumulator,
    SeriesTable,
    eval_batch,
    evaluate_block,
    finalize_matrix,
    make_accumulator,
    merge_wire,
    new_wire,
    wire_stats_merge,
)
from tempo_tpu_torch.metrics_engine.plan import MetricsPlan, compile_metrics_plan  # noqa: F401
