"""Faults planted under the timed path, for the tests that show that each
breaks `correct`. A run of the benchmark plants none: only the tests pass
a fault, through `harness.load_cell(fault=...)`.

- `half`: every block is written with half of its traces left out;
- `alter`: the program's answer is altered where it is produced (one
  query_range bin, a compacted block's spans cut to 7 a trace);
- `unchanged`: compaction returns with its blocks as they were.
"""

from __future__ import annotations


def install(fault: str):
    """Plants the fault; returns a callable that takes it out again."""
    undo: list = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore():
        for owner, name, old in reversed(undo):
            setattr(owner, name, old)

    if not fault:
        return restore
    if fault == "half":
        import numpy as np

        from tempo_tpu_torch.db import TempoDB

        write = TempoDB.write_batch

        def half(self, tenant, batch, block_id=None):
            _, seg = batch.trace_boundaries()
            return write(self, tenant, batch.select(np.flatnonzero(seg % 2 == 0)), block_id)

        patch(TempoDB, "write_batch", half)
    elif fault == "alter":
        import dataclasses

        import tempo_tpu_torch.metrics_engine as engine
        from tempo_tpu_torch.db import TempoDB

        finalize = engine.finalize_matrix

        def altered(plan, merged):
            doc = finalize(plan, merged)
            if doc["result"]:
                t, v = doc["result"][0]["values"][0]
                doc["result"][0]["values"][0] = [t, str(float(v) + 1.0)]
            return doc

        patch(engine, "finalize_matrix", altered)
        options = TempoDB.compaction_options

        def capped(self):
            return dataclasses.replace(options(self), max_spans_per_trace=7)

        patch(TempoDB, "compaction_options", capped)
    elif fault == "unchanged":
        from tempo_tpu_torch.db import TempoDB

        patch(TempoDB, "compact_once", lambda self, tenant=None, max_jobs=0: 1)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return restore
