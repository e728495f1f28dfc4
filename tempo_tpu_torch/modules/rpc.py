"""Port of tempo_tpu/modules/rpc.py (host code): the wire is the
reference's byte for byte, so a port role and a JAX role talk to each
other.

Inter-role RPC: ingester/generator push + query endpoints, remote
clients, and the ring-backed client pool.

Reference: pkg/tempopb/tempo.proto services Pusher/Querier/
MetricsGenerator over gRPC. Here the transport is HTTP on the role's
server under /rpc/v1/*; payloads are the columnar segment bytes the
distributor already produces (PushBytes analog), OTLP protobuf for
traces, and length-prefixed segments for live-batch transfer.

Endpoints served by a role process (api/server dispatches /rpc/ here):
  POST /rpc/v1/ingester/push            body: segment   (tenant header)
  GET  /rpc/v1/ingester/trace/{hex}     -> OTLP proto | 404
  GET  /rpc/v1/ingester/live            -> u32-len-prefixed segments
  POST /rpc/v1/generator/push           body: segment
  POST /rpc/v1/worker/pull              -> {job_id, tenant, desc} | 204
  POST /rpc/v1/worker/result/{job_id}   body: {result}|{error}
"""

from __future__ import annotations

import json
import logging
import struct

log = logging.getLogger(__name__)

_LEN = struct.Struct("<I")


class RPCBadRequest(ValueError):
    pass


class RPCHandler:
    """Server side: routes /rpc/v1/* onto the role's modules. Any of
    ingester/generator/broker/querier may be None depending on role."""

    def __init__(self, ingester=None, generator=None, broker=None,
                 pull_timeout_s: float = 10.0):
        self.ingester = ingester
        self.generator = generator
        self.broker = broker
        self.pull_timeout_s = pull_timeout_s

    def handle(self, method: str, path: str, tenant: str, body: bytes):
        """Returns (status, content_type, payload)."""
        if path == "/rpc/v1/ingester/push" and method == "POST":
            if self.ingester is None:
                return 404, "text/plain", b"no ingester in this process"
            self.ingester.push_segment(tenant, body)
            return 200, "application/json", b"{}"

        if path.startswith("/rpc/v1/ingester/trace/") and method == "GET":
            if self.ingester is None:
                return 404, "text/plain", b"no ingester in this process"
            hex_id = path.rsplit("/", 1)[-1]
            trace = self.ingester.find_trace_by_id(tenant, bytes.fromhex(hex_id.zfill(32)))
            if trace is None:
                return 404, "text/plain", b"not found"
            from tempo_tpu_torch.receivers import otlp

            return 200, "application/x-protobuf", otlp.encode_traces_request([trace])

        if path == "/rpc/v1/ingester/live" and method == "GET":
            if self.ingester is None:
                return 404, "text/plain", b"no ingester in this process"
            from tempo_tpu_torch.encoding.vtpu import format as fmt

            out = bytearray()
            for batch in self.ingester.live_batches(tenant):
                seg = fmt.serialize_batch(batch)
                out += _LEN.pack(len(seg))
                out += seg
            return 200, "application/octet-stream", bytes(out)

        if path == "/rpc/v1/generator/push" and method == "POST":
            if self.generator is None:
                return 404, "text/plain", b"no generator in this process"
            self.generator.push_segment(tenant, body)
            return 200, "application/json", b"{}"

        if path == "/rpc/v1/worker/pull" and method == "POST":
            if self.broker is None:
                return 404, "text/plain", b"no frontend broker in this process"
            item = self.broker.pull(timeout=self.pull_timeout_s)
            if item is None:
                return 204, "application/json", b""
            job_id, job_tenant, desc = item
            doc = {"job_id": job_id, "tenant": job_tenant, "desc": desc}
            return 200, "application/json", json.dumps(doc).encode()

        if path.startswith("/rpc/v1/worker/result/") and method == "POST":
            if self.broker is None:
                return 404, "text/plain", b"no frontend broker in this process"
            job_id = path.rsplit("/", 1)[-1]
            doc = json.loads(body or b"{}")
            ok = self.broker.complete(job_id, result=doc.get("result"), error=doc.get("error"))
            return (200 if ok else 404), "application/json", b"{}"

        return 404, "text/plain", b"unknown rpc"


class RemoteIngester:
    """Client half of Pusher/Querier against one ingester process."""

    def __init__(self, base_url: str, timeout_s: float = 15.0):
        from tempo_tpu_torch.backend.httpclient import PooledHTTPClient

        self.base_url = base_url
        self.client = PooledHTTPClient(base_url, timeout_s=timeout_s, max_retries=1)

    def push_segment(self, tenant: str, data: bytes) -> None:
        from tempo_tpu_torch.backend.httpclient import HTTPError
        from tempo_tpu_torch.util.resource import ResourceExhausted

        try:
            self.client.request(
                "POST",
                "/rpc/v1/ingester/push",
                headers={"X-Scope-OrgID": tenant, "Content-Type": "application/octet-stream"},
                body=data,
                ok=(200,),
            )
        except HTTPError as e:
            if e.status == 429:
                # the remote ingester shed under pressure: re-raise as the
                # typed backpressure error (with its Retry-After hint) so
                # the distributor's quorum logic treats it as overload,
                # not an outage
                raise ResourceExhausted(
                    f"ingester {self.base_url} shed push: {e}",
                    retry_after_s=e.parse_retry_after() or 1.0,
                ) from e
            raise

    def find_trace_by_id(self, tenant: str, trace_id: bytes):
        from tempo_tpu_torch.backend.httpclient import HTTPError

        try:
            _, body, _ = self.client.request(
                "GET",
                f"/rpc/v1/ingester/trace/{trace_id.hex()}",
                headers={"X-Scope-OrgID": tenant},
                ok=(200,),
            )
        except HTTPError as e:
            if e.status == 404:
                return None
            raise
        from tempo_tpu_torch.receivers import otlp

        traces = otlp.decode_traces_request(body)
        return traces[0] if traces else None

    def live_batches(self, tenant: str) -> list:
        from tempo_tpu_torch.encoding.vtpu import format as fmt

        _, body, _ = self.client.request(
            "GET", "/rpc/v1/ingester/live", headers={"X-Scope-OrgID": tenant}, ok=(200,)
        )
        out = []
        pos = 0
        while pos + _LEN.size <= len(body):
            (n,) = _LEN.unpack_from(body, pos)
            pos += _LEN.size
            out.append(fmt.deserialize_batch(body[pos : pos + n]))
            pos += n
        return out


class RemoteGenerator:
    def __init__(self, base_url: str, timeout_s: float = 15.0):
        from tempo_tpu_torch.backend.httpclient import PooledHTTPClient

        self.client = PooledHTTPClient(base_url, timeout_s=timeout_s, max_retries=1)

    def push_segment(self, tenant: str, data: bytes) -> None:
        self.client.request(
            "POST",
            "/rpc/v1/generator/push",
            headers={"X-Scope-OrgID": tenant, "Content-Type": "application/octet-stream"},
            body=data,
            ok=(200,),
        )


class RingClientPool:
    """dict-like instance_id -> remote client, resolving addresses from
    the ring (reference: the ring client pool in dskit — clients are
    created per discovered instance and cached by address).

    Ring state is snapshot-cached for a short TTL: every lookup hitting
    the KV (a file read + JSON parse for FileKV) would put O(replicas)
    disk IO on the ingest hot path, defeating the distributor's
    one-snapshot-per-push design."""

    def __init__(self, ring, client_cls=RemoteIngester, ttl_s: float = 1.0):
        import threading
        import time as _time

        self.ring = ring
        self.client_cls = client_cls
        self.ttl_s = ttl_s
        self._clients: dict[str, object] = {}
        self._addrs: dict[str, str] = {}
        self._addrs_at = 0.0
        self._lock = threading.Lock()
        self._time = _time

    def _addresses(self) -> dict[str, str]:
        now = self._time.monotonic()
        with self._lock:
            if now - self._addrs_at <= self.ttl_s:
                return self._addrs
        addrs = {i.instance_id: i.addr for i in self.ring.instances()}
        with self._lock:
            self._addrs = addrs
            self._addrs_at = now
            return self._addrs

    def get(self, instance_id: str, default=None):
        addr = self._addresses().get(instance_id)
        if not addr:
            with self._lock:
                self._clients.pop(instance_id, None)
            return default
        with self._lock:
            cached = self._clients.get(instance_id)
            if cached is None or getattr(cached, "base_url", addr) != addr:
                cached = self.client_cls(addr)
                cached.base_url = addr
                self._clients[instance_id] = cached
            return cached

    def __getitem__(self, instance_id: str):
        c = self.get(instance_id)
        if c is None:
            raise KeyError(instance_id)
        return c

    def values(self):
        return [c for c in (self.get(i) for i in self._addresses()) if c]

    def __contains__(self, instance_id: str) -> bool:
        return self.get(instance_id) is not None
