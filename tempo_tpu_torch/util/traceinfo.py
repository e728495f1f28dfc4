"""Port of tempo_tpu/util/traceinfo.py, copied as is (host code) over
the port's model/synth.

Deterministic trace construction for blackbox checking.

Reference: pkg/util/trace_info.go — a TraceInfo is seeded by
(timestamp, tenant) so the vulture can WRITE a trace at time T and
later RECONSTRUCT exactly what it wrote from T alone, comparing it
against what the backend returns. No state needs to survive between
the writer and the checker.
"""

from __future__ import annotations

from dataclasses import dataclass

from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.trace import Trace


def _fnv64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass(frozen=True)
class TraceInfo:
    timestamp_s: int
    tenant: str = "single-tenant"

    @property
    def seed(self) -> int:
        return _fnv64(self.tenant.encode() + self.timestamp_s.to_bytes(8, "little"))

    def trace_id(self) -> bytes:
        """Stable ID — derived from the seed, not from the generator
        stream, so it can be computed without building the trace."""
        a = self.seed
        b = _fnv64(b"id" + a.to_bytes(8, "little"))
        return a.to_bytes(8, "big") + b.to_bytes(8, "big")

    def construct_trace(self) -> Trace:
        """The exact trace the vulture wrote at timestamp_s. Every span
        carries a `vulture` attribute holding the probe timestamp so the
        TraceQL / query_range checks can select EXACTLY this probe's
        spans out of shared tenant traffic — the attribute is part of
        the deterministic construction, so writer and checker agree on
        it with no state file."""
        trace = synth.make_trace(
            seed=self.seed,
            base_time_ns=self.timestamp_s * 10**9,
            trace_id=self.trace_id(),
        )
        stamp = str(self.timestamp_s)
        for span in trace.all_spans():
            span.attributes["vulture"] = stamp
        return trace

    # -- recomputable expectations for the metrics/TraceQL checks -------
    def traceql_query(self) -> str:
        """TraceQL selecting exactly this probe's spans."""
        return '{ .vulture = "%d" }' % self.timestamp_s

    def metrics_query(self) -> str:
        """query_range pipeline counting this probe's spans per bin."""
        return self.traceql_query() + " | count_over_time()"

    def expected_series(self, start_s: int, step_s: int) -> dict[int, int]:
        """{bin_timestamp: span_count} the metrics engine must return for
        metrics_query() over a range starting at start_s with step_s —
        bins follow the engine's grid (start_s + k*step_s, span bucketed
        by integer division on its start second). Only nonzero bins are
        listed; zero bins compare as absent."""
        out: dict[int, int] = {}
        for span in self.construct_trace().all_spans():
            sec = span.start_unix_nano // 10**9
            b = (sec - start_s) // step_s
            ts = start_s + b * step_s
            out[ts] = out.get(ts, 0) + 1
        return out

    def span_count(self) -> int:
        return sum(1 for _ in self.construct_trace().all_spans())

    def ready(self, now_s: int, write_backoff_s: int, long_write_backoff_s: int) -> bool:
        """Whether this timestamp is one the vulture would have written
        (aligned to the write cadence) and old enough to be queryable
        (reference: trace_info.go ready-semantics)."""
        if self.timestamp_s % max(write_backoff_s, 1) != 0:
            return False
        return now_s - self.timestamp_s >= long_write_backoff_s
