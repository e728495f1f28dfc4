"""Object-form trace model for protocol boundaries.

OTLP semantics (span kinds, status codes, resource vs span attributes)
without depending on OTLP protos; conversion to/from `SpanBatch` happens
only at the edges (receiver, JSON response). The port
carries the constants and the two dataclasses that synthetic data and
the TraceQL AST use; object <-> columnar conversion and trace combining
arrive with the ingest and query slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field


# OTLP span kinds
KIND_UNSPECIFIED = 0
KIND_INTERNAL = 1
KIND_SERVER = 2
KIND_CLIENT = 3
KIND_PRODUCER = 4
KIND_CONSUMER = 5

# OTLP status codes
STATUS_UNSET = 0
STATUS_OK = 1
STATUS_ERROR = 2

WELL_KNOWN_SPAN_ATTRS = ("http.method", "http.url", "http.status_code")


@dataclass
class Span:
    trace_id: bytes  # 16 bytes
    span_id: bytes  # 8 bytes
    name: str = ""
    parent_span_id: bytes = b"\x00" * 8
    start_unix_nano: int = 0
    duration_nano: int = 0
    kind: int = KIND_UNSPECIFIED
    status_code: int = STATUS_UNSET
    attributes: dict = field(default_factory=dict)

    @property
    def end_unix_nano(self) -> int:
        return self.start_unix_nano + self.duration_nano


@dataclass
class Trace:
    """A trace: spans grouped by resource (service)."""

    trace_id: bytes
    # list of (resource_attrs, spans); resource_attrs must include "service.name"
    batches: list = field(default_factory=list)

    def span_count(self) -> int:
        return sum(len(s) for _, s in self.batches)

    def all_spans(self):
        for _, spans in self.batches:
            yield from spans

    def start_end_seconds(self) -> tuple[int, int]:
        starts = [s.start_unix_nano for s in self.all_spans()]
        ends = [s.end_unix_nano for s in self.all_spans()]
        if not starts:
            return 0, 0
        return min(starts) // 10**9, max(ends) // 10**9 + 1
