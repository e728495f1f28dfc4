"""Trace data model: columnar SpanBatch (the canonical form) and the
object-form constants and dataclasses. Host numpy, copied from
tempo_tpu/model."""

from tempo_tpu_torch.model.columnar import Dictionary, SpanBatch  # noqa: F401
from tempo_tpu_torch.model.trace import Span, Trace  # noqa: F401
