"""Port of tempo_tpu/receivers/udp.py, copied as is (host code).

Jaeger agent UDP receiver (thrift_compact 6831 / thrift_binary 6832).

Reference: the jaegerreceiver hosted by the receiver shim enables all
four Jaeger variants (modules/distributor/receiver/shim.go:111); the
agent-mode UDP ports are how most legacy jaeger clients ship spans.
Each datagram is one thrift `Agent.emitBatch` message (one-way, no
response), decoded by receivers/jaeger.py's protocol-agnostic struct
readers and pushed straight into the distributor path.
"""

from __future__ import annotations

import logging
import socket
import threading

from tempo_tpu_torch.receivers import jaeger
from tempo_tpu_torch.util import metrics

log = logging.getLogger(__name__)

_batches_total = metrics.counter(
    "tempo_distributor_jaeger_udp_batches_total",
    "Jaeger agent UDP batches received")
_spans_total = metrics.counter(
    "tempo_distributor_jaeger_udp_spans_total",
    "Spans ingested via Jaeger agent UDP")
_errors_total = metrics.counter(
    "tempo_distributor_jaeger_udp_errors_total",
    "Undecodable Jaeger agent datagrams")

MAX_DATAGRAM = 65000  # jaeger clients cap packets near 65KB


class UDPAgentServer:
    """One socket+thread per enabled port; both speak emitBatch (the
    decoder auto-detects compact vs binary, so a client pointed at the
    wrong port still ingests)."""

    def __init__(self, push, host: str = "127.0.0.1",
                 compact_port: int = 6831, binary_port: int = 6832,
                 org_id: str | None = None):
        self.push = push
        self.org_id = org_id
        self.batches = 0
        self.spans = 0
        self.errors = 0
        self._socks: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        # created here, not in start(): stop() on a never-started server
        # must close the already-bound sockets instead of raising
        # AttributeError and leaking them
        self._stop = threading.Event()
        # port None disables a variant; 0 binds an ephemeral port (tests)
        self.compact_port = self.binary_port = 0
        for name, port in (("compact", compact_port), ("binary", binary_port)):
            if port is None:
                continue
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind((host, port))
            s.settimeout(0.5)
            self._socks.append(s)
            bound = s.getsockname()[1]
            if name == "compact":
                self.compact_port = bound
            else:
                self.binary_port = bound

    def start(self) -> "UDPAgentServer":
        for s in self._socks:
            t = threading.Thread(target=self._serve, args=(s,), daemon=True,
                                 name=f"jaeger-udp-{s.getsockname()[1]}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass

    def _serve(self, sock: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                buf, _addr = sock.recvfrom(MAX_DATAGRAM)
            except socket.timeout:
                continue
            except OSError:
                return
            self.handle_datagram(buf)

    def handle_datagram(self, buf: bytes) -> int:
        """Decode+push one datagram; returns spans ingested (also the
        test entry point — no socket required)."""
        try:
            traces = jaeger.decode_agent_datagram(buf)
        except (jaeger.ThriftError, ValueError, RecursionError) as e:
            # RecursionError: a ~65KB datagram of nested struct headers
            # can exhaust the recursive skip() — one bad packet must not
            # kill the listener thread
            self.errors += 1
            _errors_total.inc()
            log.warning("jaeger agent datagram rejected: %s", e)
            return 0
        n_spans = sum(t.span_count() for t in traces)
        if traces:
            self.push(traces, org_id=self.org_id)
        self.batches += 1
        self.spans += n_spans
        _batches_total.inc()
        _spans_total.inc(n_spans)
        return n_spans
