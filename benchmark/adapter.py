"""Hands `benchmark.spans` columns to the port as its SpanBatch.

Imported only in the process that runs the program; the reference never
imports it."""

from __future__ import annotations

from benchmark import spans


def span_batch(block: dict):
    from tempo_tpu_torch.model.columnar import Dictionary, SpanBatch

    return SpanBatch(cols=dict(block["cols"]), attrs=dict(block["attrs"]),
                     dictionary=Dictionary(list(spans.STRINGS)))
