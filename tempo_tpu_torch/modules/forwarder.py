"""Port of tempo_tpu/modules/forwarder.py, copied as is (host code).

Generic per-tenant trace forwarding.

Reference: modules/distributor/forwarder (forwarder.go:15 Forwarder,
manager.go:28 Manager) — tenants can opt in (overrides `forwarders`
list) to having their raw span stream teed to external OTLP endpoints;
each (forwarder, tenant) pair gets a bounded queue + worker so a slow
remote never backpressures ingest, and overflow drops are counted.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass

from tempo_tpu_torch.util import metrics

log = logging.getLogger(__name__)

forwarder_pushes = metrics.counter(
    "tempo_distributor_forwarder_pushes_total", "Batches handed to forwarder queues"
)
forwarder_drops = metrics.counter(
    "tempo_distributor_forwarder_queue_drops_total",
    "Batches dropped because a forwarder queue was full",
)
forwarder_failures = metrics.counter(
    "tempo_distributor_forwarder_send_failures_total", "Forwarder sends that failed"
)


@dataclass
class ForwarderConfig:
    name: str = ""
    backend: str = "otlphttp"  # otlphttp | callable (tests)
    endpoint: str = ""  # e.g. http://collector:4318
    path: str = "/v1/traces"
    queue_size: int = 256
    workers: int = 1
    timeout_s: float = 10.0


class Forwarder:
    """One configured destination; per-tenant batches flow through one
    shared queue (the reference queues per tenant; a shared bounded
    queue keyed by tenant gives the same isolation knobs with tenant
    carried in the item)."""

    def __init__(self, cfg: ForwarderConfig, send_fn=None):
        self.cfg = cfg
        self._send_fn = send_fn  # tests inject; otherwise OTLP HTTP
        self._client = None
        if send_fn is None and cfg.endpoint:
            # built once here: lazy init in _send would race when
            # cfg.workers > 1 and leak the losing client's sockets
            from tempo_tpu_torch.backend.httpclient import PooledHTTPClient

            self._client = PooledHTTPClient(cfg.endpoint, cfg.timeout_s)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.queue_size)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, daemon=True, name=f"fwd-{cfg.name}-{i}")
            for i in range(max(cfg.workers, 1))
        ]
        for t in self._threads:
            t.start()

    def enqueue(self, tenant: str, traces) -> bool:
        try:
            self._q.put_nowait((tenant, traces))
            forwarder_pushes.inc(name=self.cfg.name)
            return True
        except queue.Full:
            forwarder_drops.inc(name=self.cfg.name)
            return False

    def _send(self, tenant: str, traces) -> None:
        if self._send_fn is not None:
            self._send_fn(tenant, traces)
            return
        from tempo_tpu_torch.receivers import otlp

        if self._client is None:
            raise ValueError(f"forwarder {self.cfg.name}: no endpoint configured")
        self._client.request(
            "POST",
            self.cfg.path,
            headers={
                "Content-Type": "application/x-protobuf",
                "X-Scope-OrgID": tenant,
            },
            body=otlp.encode_traces_request(traces),
            ok=(200, 202),
        )

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                tenant, traces = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._send(tenant, traces)
            except Exception:
                forwarder_failures.inc(name=self.cfg.name)
                log.exception("forwarder %s send failed", self.cfg.name)

    def drain(self, timeout_s: float = 5.0) -> None:
        """Test helper: wait for the queue to empty."""
        import time

        deadline = time.monotonic() + timeout_s
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)


class ForwarderManager:
    """Routes a tenant's stream to its overrides-selected forwarders
    (reference: manager.go ForTenant)."""

    def __init__(self, configs: list[ForwarderConfig], overrides, send_fn=None):
        self.overrides = overrides
        self.forwarders = {c.name: Forwarder(c, send_fn=send_fn) for c in configs}

    def send(self, tenant: str, traces) -> None:
        names = self.overrides.for_tenant(tenant).forwarders
        for name in names:
            f = self.forwarders.get(name)
            if f is None:
                log.warning("tenant %s references unknown forwarder %r", tenant, name)
                continue
            f.enqueue(tenant, traces)

    def stop(self) -> None:
        for f in self.forwarders.values():
            f.stop()
