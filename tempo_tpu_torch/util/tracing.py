"""Port of tempo_tpu/util/tracing.py, copied as is (host code).

Self-tracing — the framework traces its own request paths.

Reference: every component opens OpenTracing/OTel spans over itself
(distributor.go:289, tempodb.go:276, flush.go:298); cmd/tempo/main.go
installs a Jaeger or OTel tracer (installOpenTelemetryTracer
main.go:212) and pkg/util/spanlogger fuses spans with log lines.

Here: a contextvars-based tracer producing the SAME span model the
engine stores, so a deployment can export its own spans into its own
ingest path (the dogfooding the reference gets by pointing its Jaeger
client at itself) or into any callback.

Propagation: W3C `traceparent` (version-traceid-spanid-flags) is the
wire context. `current_traceparent()` gives the header value for an
outbound request (backend/httpclient injects it); `remote_context()`
activates an inbound header as the parent of subsequently opened spans
(api/server + receivers/grpc_server extract), so one push or one query
is one coherent trace across the distributor→ingester and
frontend→worker process boundaries.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
from dataclasses import dataclass

from tempo_tpu_torch.model.trace import KIND_INTERNAL, STATUS_ERROR, STATUS_OK, Span, Trace

_current_span: contextvars.ContextVar = contextvars.ContextVar("tempo_current_span", default=None)

TRACEPARENT_HEADER = "traceparent"

# the reserved dogfood tenant the engine exports its own traces into
# (reference: the deployment points its Jaeger client at its own
# distributor; a reserved tenant keeps self-traffic out of user data)
SELF_TENANT = "_self_"


def _rand_bytes(n: int) -> bytes:
    return os.urandom(n)


class RemoteParent:
    """Parent context recovered from an inbound `traceparent` header:
    enough identity to link spans (trace_id + span_id), no local span
    lifecycle — the actual parent span lives in another process."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: bytes, span_id: bytes):
        self.trace_id = trace_id
        self.span_id = span_id


def format_traceparent(trace_id: bytes, span_id: bytes) -> str:
    return f"00-{trace_id.hex()}-{span_id.hex()}-01"


def parse_traceparent(header: str | None) -> RemoteParent | None:
    """Strict-enough W3C parse: version-traceid-spanid-flags with the
    lengths the spec fixes; anything malformed (or the all-zero ids the
    spec forbids) is ignored, never an error — a bad header from a
    foreign client must not fail the request it rode in on."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_hex, span_hex = parts[0], parts[1], parts[2]
    if len(version) != 2 or len(trace_hex) != 32 or len(span_hex) != 16:
        return None
    try:
        trace_id = bytes.fromhex(trace_hex)
        span_id = bytes.fromhex(span_hex)
    except ValueError:
        return None
    if trace_id == b"\x00" * 16 or span_id == b"\x00" * 8:
        return None
    return RemoteParent(trace_id, span_id)


def current_traceparent() -> str | None:
    """Header value carrying the ACTIVE span context, or None when no
    span is open (propagating without a recording tracer is meaningless
    here — context is minted by spans)."""
    cur = _current_span.get()
    if cur is None:
        return None
    return format_traceparent(cur.trace_id, cur.span_id)


@contextlib.contextmanager
def remote_context(header: str | None):
    """Activate an inbound traceparent as the parent for spans opened in
    this context. No-op when the header is absent/malformed, when the
    tracer is disabled, or when a LOCAL span is already active (an
    in-process call chain outranks a stale header)."""
    rp = parse_traceparent(header) if header else None
    if rp is None or not TRACER.enabled or _current_span.get() is not None:
        yield None
        return
    token = _current_span.set(rp)
    try:
        yield rp
    finally:
        _current_span.reset(token)


# shared no-op context for the disabled tracer (reentrant + shareable;
# __enter__ yields None like a disabled span)
_NULL_CTX = contextlib.nullcontext()


class Tracer:
    """Minimal in-process tracer. Spans finish into `exporter(span_list)`
    per trace root; a None exporter disables all recording at ~zero
    cost (the default, like the reference's disabled tracer).

    max_open_age_s: spans parked in `_open_traces` waiting for their
    root are flushed (exported as a partial trace) once the trace has
    gone this long without ANY span finishing — a root abandoned by a
    crashed/killed thread must not pin its spans forever. Age is keyed
    off the LAST append, not the first: a healthy long-running root
    (a multi-minute compaction) keeps finishing children, which keeps
    its trace alive; only a trace that stopped making progress sweeps."""

    def __init__(self, service_name: str = "tempo-tpu", exporter=None,
                 max_open_age_s: float = 300.0):
        self.service_name = service_name
        self.exporter = exporter
        self.max_open_age_s = max_open_age_s
        self._lock = threading.Lock()
        self._open_traces: dict[bytes, list] = {}
        self._open_last: dict[bytes, float] = {}  # trace_id -> monotonic
        self._last_sweep = time.monotonic()
        # re-entrancy guard: exporting into our own ingest path must not
        # trace the export itself, or every export spawns another trace
        # (the reference avoids this because its jaeger client's sender
        # is outside the instrumented surface)
        self._exporting = threading.local()

    @property
    def enabled(self) -> bool:
        return self.exporter is not None and not getattr(self._exporting, "on", False)

    def current_trace_id(self) -> bytes | None:
        cur = _current_span.get()
        return cur.trace_id if cur is not None else None

    def span(self, name: str, **attrs):
        # hot paths call this unconditionally: the disabled tracer must
        # cost one attribute check + a shared null context, not a fresh
        # generator per call
        if not self.enabled:
            return _NULL_CTX
        return self._span_cm(name, attrs)

    @contextlib.contextmanager
    def _span_cm(self, name: str, attrs: dict):
        parent = _current_span.get()
        remote = isinstance(parent, RemoteParent)
        trace_id = parent.trace_id if parent is not None else _rand_bytes(16)
        s = Span(
            trace_id=trace_id,
            span_id=_rand_bytes(8),
            parent_span_id=parent.span_id if parent is not None else b"\x00" * 8,
            name=name,
            start_unix_nano=time.time_ns(),
            kind=KIND_INTERNAL,
            attributes={k: v for k, v in attrs.items()},
        )
        token = _current_span.set(s)
        try:
            yield s
            s.status_code = STATUS_OK
        except BaseException as e:
            # the span must SAY what failed before it finishes: status
            # alone is not actionable in a waterfall
            s.status_code = STATUS_ERROR
            s.attributes["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            s.duration_nano = max(time.time_ns() - s.start_unix_nano, 1)
            try:
                _current_span.reset(token)
            except ValueError:
                # a span abandoned by a dead thread finishes here when
                # its generator is GC'd from ANOTHER context; the token
                # is unresettable there, and that must not mask the span
                pass
            # a span whose parent lives in another process is the LOCAL
            # root: it must flush the local fragment (the remote side
            # flushes its own)
            self._finish(s, is_root=parent is None or remote)

    def _finish(self, span: Span, is_root: bool) -> None:
        with self._lock:
            self._open_traces.setdefault(span.trace_id, []).append(span)
            self._open_last[span.trace_id] = time.monotonic()
            done = self._open_traces.pop(span.trace_id) if is_root else None
            if is_root:
                self._open_last.pop(span.trace_id, None)
        if done:
            self._export(span.trace_id, done)
        self.maybe_sweep()

    def _export(self, trace_id: bytes, spans: list) -> None:
        trace = Trace(
            trace_id=trace_id,
            batches=[({"service.name": self.service_name}, spans)],
        )
        self._exporting.on = True
        try:
            self.exporter([trace])
        except Exception:
            logging.getLogger(__name__).exception("span export failed")
        finally:
            self._exporting.on = False

    # -- abandoned-trace hygiene ---------------------------------------
    def maybe_sweep(self, now: float | None = None) -> int:
        """Opportunistic bounded-age sweep, at most every
        max_open_age_s/4: traces whose root never finished (crashed
        thread, abandoned generator) are flushed as PARTIAL traces and
        their `_open_traces` entries released. Returns the number of
        traces flushed."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._last_sweep < self.max_open_age_s / 4:
                return 0
            self._last_sweep = now
        return self.sweep_open(now=now)

    def sweep_open(self, now: float | None = None) -> int:
        """Force the sweep (tests; maybe_sweep rate-limits it)."""
        now = time.monotonic() if now is None else now
        stale: list[tuple[bytes, list]] = []
        with self._lock:
            for tid, last in list(self._open_last.items()):
                if now - last > self.max_open_age_s:
                    stale.append((tid, self._open_traces.pop(tid)))
                    self._open_last.pop(tid, None)
        for tid, spans in stale:
            logging.getLogger(__name__).warning(
                "flushing abandoned trace %s (%d spans, root never finished)",
                tid.hex(), len(spans),
            )
            for s in spans:
                s.attributes.setdefault("abandoned", True)
            self._export(tid, spans)
        return len(stale)

    def open_trace_count(self) -> int:
        with self._lock:
            return len(self._open_traces)


# process-global tracer, disabled by default; main/app installs an exporter
TRACER = Tracer()


def install_exporter(exporter, service_name: str | None = None) -> None:
    if service_name:
        TRACER.service_name = service_name
    TRACER.exporter = exporter


def uninstall_exporter(exporter=None) -> None:
    """Remove the installed exporter. Passing the exporter uninstalls
    only if it is still the installed one — an App shutting down must
    not tear out an exporter a newer App installed after it."""
    if exporter is None or TRACER.exporter is exporter:
        TRACER.exporter = None


def span(name: str, **attrs):
    return TRACER.span(name, **attrs)


# ---------------------------------------------------------------------------
# dogfood export: the engine ingests its own spans under SELF_TENANT
# ---------------------------------------------------------------------------


@dataclass
class SelfTracingConfig:
    """`self_tracing:` config section. Off by default — the bench guard
    (bench.py) refuses to measure with it armed, and production turns it
    on explicitly like the reference turns on its Jaeger exporter."""

    enabled: bool = False
    tenant: str = SELF_TENANT
    service_name: str = "tempo-tpu"
    # microservices mode: roles WITHOUT a local distributor (querier,
    # frontend, compactor, ingester) export their spans as OTLP/HTTP to
    # this URL — any distributor-serving process — so cross-process
    # traces are whole, not distributor-only. Empty + no local
    # distributor = that role records nothing (single-binary needs no
    # endpoint: its own distributor is the sink).
    endpoint: str = ""
    # deterministic head sampling by trace id: 1.0 = every trace
    sample_ratio: float = 1.0
    # hard rate bound on exported spans (token bucket): self-traffic
    # must stay a rounding error next to user traffic
    max_spans_per_s: float = 5000.0
    burst_spans: float = 20000.0


class SelfTraceExporter:
    """Exporter closing the dogfood loop: finished traces push into the
    engine's OWN ingest path under the reserved `_self_` tenant, so
    TraceQL / query_range over `_self_` is the profiling UI.

    Three dampers keep self-observation from becoming self-load:
    - deterministic head sampling by trace id,
    - a spans/s token bucket (hard ceiling, drops are counted),
    - the resource governor: at PRESSURE or worse, exports drop — the
      observability plane must never compete with user traffic for the
      memory the governor is defending.
    (The tracer's re-entrancy guard already keeps the export itself from
    spawning spans.)
    """

    def __init__(self, push, cfg: SelfTracingConfig | None = None, governor=None):
        """push(tenant, traces): the distributor's ingest entry."""
        from tempo_tpu_torch.util import metrics
        from tempo_tpu_torch.util.resource import TokenBucket

        self.push = push
        self.cfg = cfg or SelfTracingConfig()
        self.governor = governor  # duck-typed: .level() >= 1 means pressure
        self._bucket = TokenBucket(
            rate=float(self.cfg.max_spans_per_s),
            burst=float(self.cfg.burst_spans),
        )
        self.exported_total = metrics.counter(
            "tempo_tpu_self_traces_exported_total",
            "Self-traces exported into the dogfood ingest path",
        )
        self.dropped_total = metrics.counter(
            "tempo_tpu_self_traces_dropped_total",
            "Self-traces dropped before export, by reason "
            "(sampled/rate_limited/pressure/push_failed)",
        )

    def _sampled(self, trace_id: bytes) -> bool:
        ratio = self.cfg.sample_ratio
        if ratio >= 1.0:
            return True
        if ratio <= 0.0:
            return False
        return int.from_bytes(trace_id[:8], "big") < int(ratio * (1 << 64))

    def _allow(self, n_spans: int) -> bool:
        return self._bucket.allow_n(n_spans)

    def __call__(self, traces) -> None:
        if self.governor is not None and self.governor.level() >= 1:
            self.dropped_total.inc(len(traces), reason="pressure")
            return
        keep = []
        for t in traces:
            if self._sampled(t.trace_id):
                keep.append(t)
            else:
                self.dropped_total.inc(reason="sampled")
        if not keep:
            return
        n_spans = sum(t.span_count() for t in keep)
        if not self._allow(n_spans):
            self.dropped_total.inc(len(keep), reason="rate_limited")
            return
        try:
            self.push(self.cfg.tenant, keep)
        except Exception:
            # the dogfood path must NEVER amplify an outage: a shed or
            # failed self-push is dropped, not retried
            self.dropped_total.inc(len(keep), reason="push_failed")
            logging.getLogger(__name__).debug("self-trace push dropped", exc_info=True)
            return
        self.exported_total.inc(len(keep))


class SpanLogger(logging.LoggerAdapter):
    """Log↔trace correlation: lines carry the active traceID and are
    also recorded as span attributes (reference: pkg/util/spanlogger +
    withSpan flush.go:287)."""

    def __init__(self, logger: logging.Logger, tracer: Tracer | None = None):
        super().__init__(logger, {})
        self.tracer = tracer or TRACER

    def process(self, msg, kwargs):
        cur = _current_span.get()
        if cur is not None and not isinstance(cur, RemoteParent):
            cur.attributes.setdefault("log", []).append(str(msg))
            msg = f"traceID={cur.trace_id.hex()} {msg}"
        return msg, kwargs
