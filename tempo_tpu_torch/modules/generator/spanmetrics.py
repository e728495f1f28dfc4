"""Span-metrics processor: RED metrics per (service, span_name, kind, status).

Reference: modules/generator/processor/spanmetrics (spanmetrics.go:25,
aggregateMetrics:86 — traces_spanmetrics_{calls_total,latency,size_total}
with intrinsic dimensions).

Vectorized: one np.unique group-by over the composite key columns per
batch, one searchsorted histogramming pass — no per-span python loop.

Port of tempo_tpu/modules/generator/spanmetrics.py, host code.
"""

from __future__ import annotations

import numpy as np

from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.modules.generator.registry import Exemplar

# seconds buckets matching the reference's default latency histogram
DEFAULT_BOUNDS = [0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128, 0.256, 0.512, 1.02, 2.05, 4.10]

CALLS = "traces_spanmetrics_calls_total"
LATENCY = "traces_spanmetrics_latency"
SIZE = "traces_spanmetrics_size_total"

KIND_NAMES = {0: "SPAN_KIND_UNSPECIFIED", 1: "SPAN_KIND_INTERNAL", 2: "SPAN_KIND_SERVER",
              3: "SPAN_KIND_CLIENT", 4: "SPAN_KIND_PRODUCER", 5: "SPAN_KIND_CONSUMER"}
STATUS_NAMES = {0: "STATUS_CODE_UNSET", 1: "STATUS_CODE_OK", 2: "STATUS_CODE_ERROR"}


class SpanMetricsProcessor:
    name = "span-metrics"

    def __init__(self, registry, bounds=None):
        self.registry = registry
        self.bounds = bounds or DEFAULT_BOUNDS
        self.spans_processed = 0

    def push(self, batch) -> None:
        n = batch.num_spans
        if n == 0:
            return
        self.spans_processed += n
        c = batch.cols
        d = batch.dictionary
        # composite group key: service | name | kind | status
        keys = np.stack(
            [c["service"].astype(np.uint64), c["name"].astype(np.uint64),
             c["kind"].astype(np.uint64), c["status_code"].astype(np.uint64)], axis=1
        )
        uniq, first_row, inverse = np.unique(
            keys, axis=0, return_index=True, return_inverse=True
        )
        counts = np.bincount(inverse, minlength=len(uniq))
        secs = c["duration_nano"].astype(np.float64) / 1e9
        sums = np.bincount(inverse, weights=secs, minlength=len(uniq))
        sizes = np.bincount(
            inverse, weights=np.full(n, batch.nbytes() / max(n, 1)), minlength=len(uniq)
        )
        # histogram: bucket index per span (searchsorted), then 2D bincount
        bidx = np.searchsorted(np.asarray(self.bounds), secs, side="left")
        flat = inverse * (len(self.bounds) + 1) + bidx
        bucket_counts = np.bincount(flat, minlength=len(uniq) * (len(self.bounds) + 1)).reshape(
            len(uniq), len(self.bounds) + 1
        )
        for g in range(len(uniq)):
            svc, name_c, kind, status = uniq[g]
            labels = (
                ("service", d[int(svc)]),
                ("span_name", d[int(name_c)]),
                ("span_kind", KIND_NAMES.get(int(kind), str(int(kind)))),
                ("status_code", STATUS_NAMES.get(int(status), str(int(status)))),
            )
            self.registry.inc_counter(CALLS, labels, float(counts[g]))
            self.registry.inc_counter(SIZE, labels, float(sizes[g]))
            # one representative span of the group as the trace exemplar
            r = int(first_row[g])
            ex = Exemplar(
                trace_id=fmt.id_to_hex(c["trace_id"][r]),
                value=float(secs[r]),
                timestamp_ms=int(c["start_unix_nano"][r]) // 10**6,
            )
            self.registry.observe_histogram(
                LATENCY, labels, self.bounds, bucket_counts[g], float(sums[g]),
                int(counts[g]), exemplar=ex,
            )
