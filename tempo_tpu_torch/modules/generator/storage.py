"""Port of tempo_tpu/modules/generator/storage.py (host code): the same
WriteRequest bytes, WAL records and headers as the reference.

Per-tenant Prometheus remote-write storage with a durable WAL.

Reference: modules/generator/storage/instance.go:40 — each tenant gets
a prometheus remote-write WAL + queue manager; samples collected from
the registry are appended to the WAL and shipped to the configured
remote_write endpoints with the tenant's X-Scope-OrgID header.

Wire format: WriteRequest protobuf (prompb) encoded by hand over the
protowire helpers, snappy block compression, standard remote-write
headers. Durability: pending WriteRequests are length-prefixed records
in a per-tenant WAL file; a send failure leaves them in place and a
restart replays them (the reference gets the same from the prometheus
WAL + queue-manager resharding).
"""

from __future__ import annotations

import logging
import os
import struct
import threading
from dataclasses import dataclass, field

from tempo_tpu_torch.backend.httpclient import PooledHTTPClient
from tempo_tpu_torch.receivers.protowire import (
    put_bytes_field,
    put_double_field,
    put_str_field,
    put_varint_field,
)
from tempo_tpu_torch.util import snappy
from tempo_tpu_torch.util import metrics

log = logging.getLogger(__name__)

remote_write_samples = metrics.counter(
    "tempo_metrics_generator_storage_samples_sent_total",
    "Samples shipped via remote write",
)
remote_write_failures = metrics.counter(
    "tempo_metrics_generator_storage_send_failures_total",
    "Remote-write sends that exhausted retries",
)


# -- prompb encoding ----------------------------------------------------
def encode_write_request(samples, extra_labels: tuple = ()) -> bytes:
    """samples: iterable of registry.Sample. One TimeSeries per sample
    (samples within one collect already carry distinct label sets)."""
    out = bytearray()
    for s in samples:
        ts = bytearray()
        for k, v in (("__name__", s.name), *s.labels, *extra_labels):
            lbl = bytearray()
            put_str_field(lbl, 1, k)
            put_str_field(lbl, 2, str(v))
            put_bytes_field(ts, 1, bytes(lbl))  # TimeSeries.labels
        smp = bytearray()
        put_double_field(smp, 1, float(s.value))
        put_varint_field(smp, 2, int(s.timestamp_ms))
        put_bytes_field(ts, 2, bytes(smp))  # TimeSeries.samples
        put_bytes_field(out, 1, bytes(ts))  # WriteRequest.timeseries
    return bytes(out)


@dataclass
class RemoteWriteConfig:
    endpoint: str = ""  # e.g. http://prometheus:9090/api/v1/write
    path: str = "/api/v1/write"
    headers: dict = field(default_factory=dict)
    wal_dir: str = ""
    send_interval_s: float = 15.0
    max_retries: int = 3
    timeout_s: float = 10.0
    max_wal_bytes: int = 64 << 20  # drop-oldest beyond this (backpressure cap)


class TenantRemoteWriter:
    """WAL + sender for one tenant (reference: storage/instance.go)."""

    _REC = struct.Struct("<I")

    def __init__(self, tenant: str, cfg: RemoteWriteConfig, client: PooledHTTPClient | None = None):
        self.tenant = tenant
        self.cfg = cfg
        self.client = client
        if self.client is None and cfg.endpoint:
            self.client = PooledHTTPClient(cfg.endpoint, cfg.timeout_s, cfg.max_retries)
        self._lock = threading.Lock()
        self.wal_path = None
        if cfg.wal_dir:
            os.makedirs(os.path.join(cfg.wal_dir, tenant), exist_ok=True)
            self.wal_path = os.path.join(cfg.wal_dir, tenant, "remote-write.wal")

    # -- WAL ------------------------------------------------------------
    def _wal_append(self, payload: bytes) -> None:
        if not self.wal_path:
            return
        with open(self.wal_path, "ab") as f:
            f.write(self._REC.pack(len(payload)))
            f.write(payload)

    def _wal_load(self) -> list[bytes]:
        if not self.wal_path or not os.path.exists(self.wal_path):
            return []
        out = []
        with open(self.wal_path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 4 <= len(data):
            (n,) = self._REC.unpack_from(data, pos)
            pos += 4
            if pos + n > len(data):  # torn tail record from a crash
                log.warning("remote-write WAL %s: dropping torn tail", self.wal_path)
                break
            out.append(data[pos : pos + n])
            pos += n
        return out

    def _wal_replace(self, records: list[bytes]) -> None:
        if not self.wal_path:
            return
        tmp = self.wal_path + ".tmp"
        with open(tmp, "wb") as f:
            for r in records:
                f.write(self._REC.pack(len(r)))
                f.write(r)
        os.replace(tmp, self.wal_path)

    # -- append + send ---------------------------------------------------
    def append(self, samples) -> bytes | None:
        """Encode and durably queue one batch of samples."""
        samples = list(samples)
        if not samples:
            return None
        payload = encode_write_request(samples)
        with self._lock:
            self._wal_append(payload)
            self._trim_locked()
        return payload

    def _trim_locked(self) -> None:
        if not self.wal_path or not os.path.exists(self.wal_path):
            return
        if os.path.getsize(self.wal_path) <= self.cfg.max_wal_bytes:
            return
        records = self._wal_load()
        while records and sum(len(r) + 4 for r in records) > self.cfg.max_wal_bytes:
            records.pop(0)  # drop-oldest
        self._wal_replace(records)

    def pending(self) -> int:
        with self._lock:
            return len(self._wal_load())

    def send_now(self) -> int:
        """Ship all pending WriteRequests; returns how many were sent.
        On failure the unsent tail stays in the WAL for the next cycle."""
        if self.client is None:
            return 0
        with self._lock:
            records = self._wal_load()
            if not records:
                return 0
            sent = 0
            for payload in records:
                body = snappy.compress(payload)
                headers = {
                    "Content-Type": "application/x-protobuf",
                    "Content-Encoding": "snappy",
                    "X-Prometheus-Remote-Write-Version": "0.1.0",
                    "X-Scope-OrgID": self.tenant,
                    **self.cfg.headers,
                }
                try:
                    self.client.request(
                        "POST", self.cfg.path, headers=headers, body=body, ok=(200, 204)
                    )
                except Exception as e:
                    log.warning("remote write for %s failed: %s", self.tenant, e)
                    remote_write_failures.inc()
                    break
                sent += 1
            self._wal_replace(records[sent:])
            remote_write_samples.inc(sent)
            return sent


class RemoteWriteStorage:
    """All tenants' writers + the periodic collect→append→send loop
    (reference: generator collectMetrics ticker, registry.go:180)."""

    def __init__(self, cfg: RemoteWriteConfig):
        self.cfg = cfg
        self._writers: dict[str, TenantRemoteWriter] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def writer(self, tenant: str) -> TenantRemoteWriter:
        with self._lock:
            w = self._writers.get(tenant)
            if w is None:
                w = TenantRemoteWriter(tenant, self.cfg)
                self._writers[tenant] = w
            return w

    def collect_and_send(self, generator) -> int:
        """One cycle: collect every tenant's registry into its WAL, then
        ship. Driven by the background loop or called directly in tests."""
        with generator.lock:
            tenants = list(generator.instances)
        total = 0
        for tenant in tenants:
            w = self.writer(tenant)
            w.append(generator.collect(tenant))
            total += w.send_now()
        return total

    def start_loop(self, generator) -> None:
        def run():
            while not self._stop.wait(self.cfg.send_interval_s):
                try:
                    self.collect_and_send(generator)
                except Exception:
                    log.exception("remote-write cycle failed")

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None
