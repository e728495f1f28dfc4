"""Distributor — the ingest front door.

Reference: modules/distributor/distributor.go (PushTraces:288 rate
limiting, requestsByTraceID:483 regrouping spans by trace, DoBatch fan
-out :389-431, generator tee :442). Differences by design: span batches
are columnar end-to-end, so "regroup by trace ID" is an argsort over the
token array, and the per-ingester payload is a serialized columnar
segment (format.serialize_batch), not proto bytes.

Port of tempo_tpu/modules/distributor.py, with the metrics-generator
tee and the forwarder tee.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.model.trace import traces_to_batch
from tempo_tpu_torch.ops import hashing
from tempo_tpu_torch.util import metrics, resource, tracing, usage

log = logging.getLogger(__name__)

spans_received = metrics.counter(
    "tempo_distributor_spans_received_total", "Spans accepted by the distributor"
)
bytes_received = metrics.counter(
    "tempo_distributor_bytes_received_total", "Bytes accepted by the distributor"
)
discarded_spans = metrics.counter(
    "tempo_discarded_spans_total", "Spans discarded at ingest, by reason"
)
inflight_push_gauge = metrics.gauge(
    "tempo_distributor_inflight_push_bytes",
    "Bytes of push payloads currently being fanned out",
)


class RateLimited(Exception):
    """Maps to HTTP 429 (reference: distributor.go:340). Carries the
    token-bucket refill hint so the 429 can say WHEN to retry instead of
    inviting an immediate re-send."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class NoHealthyIngesters(Exception):
    pass


# the shared token-bucket primitive (hoisted to util/resource; the name
# stays importable from here for existing callers/tests)
TokenBucket = resource.TokenBucket


@dataclass
class DistributorMetrics:
    spans_received: dict = field(default_factory=dict)  # tenant -> count
    bytes_received: dict = field(default_factory=dict)
    traces_rate_limited: dict = field(default_factory=dict)
    push_failures: int = 0


class Distributor:
    # idle tenants' limiter + per-tenant metric state is evicted after
    # this long: a tenant-ID fuzzing client must not leak memory forever
    TENANT_IDLE_TTL_S = 600.0
    _EVICT_PERIOD_S = 60.0

    def __init__(self, ring, ingester_clients: dict, overrides,
                 generator_ring=None, generator_clients: dict | None = None,
                 forwarder_manager=None, instance_id: str = "distributor-0",
                 governor: "resource.ResourceGovernor | None" = None):
        """ingester_clients: instance_id -> object with
        push_segment(tenant, data: bytes)."""
        self.ring = ring
        self.clients = ingester_clients
        self.overrides = overrides
        self.generator_ring = generator_ring
        self.generator_clients = generator_clients or {}
        self.forwarder_manager = forwarder_manager
        self.instance_id = instance_id
        self.governor = governor or resource.governor()
        self.metrics = DistributorMetrics()
        self._limiters: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self._last_evict = time.monotonic()

    # ------------------------------------------------------------------
    def _limiter(self, tenant: str) -> TokenBucket:
        ring_size = max(1, len(self.ring.healthy_instances())) if (
            self.overrides.for_tenant(tenant).ingestion_rate_strategy == "global"
        ) else 1
        rate = self.overrides.ingestion_rate_bytes(tenant, ring_size)
        burst = self.overrides.for_tenant(tenant).ingestion_burst_size_bytes
        with self._lock:
            lim = self._limiters.get(tenant)
            if lim is None or lim.rate != rate or lim.burst != burst:
                lim = TokenBucket(rate, burst)
                self._limiters[tenant] = lim
        self._maybe_evict_idle()
        return lim

    def _maybe_evict_idle(self, now: float | None = None) -> None:
        """Opportunistic idle-tenant GC from the push path, at most once
        per _EVICT_PERIOD_S, so churned/fuzzed tenant IDs stay bounded."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._last_evict < self._EVICT_PERIOD_S:
                return
            self._last_evict = now
        evicted = self.evict_idle_tenants()
        if evicted:
            log.info("evicted %d idle tenant limiter(s)", evicted)

    def evict_idle_tenants(self, older_than_s: float | None = None) -> int:
        """Drop limiter + per-tenant metric dict entries for tenants idle
        past the TTL (reference: dskit limiter GC). Returns the count."""
        ttl = self.TENANT_IDLE_TTL_S if older_than_s is None else older_than_s
        now = time.monotonic()
        with self._lock:
            idle = [
                t for t, lim in self._limiters.items()
                if now - lim.last_used > ttl
            ]
            for t in idle:
                del self._limiters[t]
                for d in (
                    self.metrics.spans_received,
                    self.metrics.bytes_received,
                    self.metrics.traces_rate_limited,
                ):
                    d.pop(t, None)
        # tenant labels on the core cost counters are bounded by the
        # same eviction: drop the idle tenants' label sets so /metrics
        # cardinality tracks ACTIVE tenants, not every ID ever seen
        for t in idle:
            for c in (spans_received, bytes_received, discarded_spans):
                c.drop_labels(tenant=t)
        if idle:
            usage.ACCOUNTANT.evict_idle_tenants()
        return len(idle)

    # ------------------------------------------------------------------
    def push_traces(self, tenant: str, traces) -> None:
        """Object-form entry (receiver boundary)."""
        self.push_batch(tenant, traces_to_batch(traces))
        # async tee to per-tenant external forwarders (reference:
        # generatorForwarder/SendTraces + forwarder Manager, after the
        # ingester write has been accepted)
        if self.forwarder_manager is not None:
            self.forwarder_manager.send(tenant, traces)

    def push_batch(self, tenant: str, batch: SpanBatch) -> None:
        if batch.num_spans == 0:
            return
        with tracing.span("distributor/push", tenant=tenant, spans=batch.num_spans):
            self._push_batch_traced(tenant, batch)

    def _push_batch_traced(self, tenant: str, batch: SpanBatch) -> None:
        size = batch.nbytes()
        lim = self._limiter(tenant)
        # note: a batch larger than the tenant burst also lands here with
        # a (long, honest) refill hint — kept as 429 for reference parity
        # (Tempo maps every rate-limit rejection to 429) and because the
        # per-tenant burst is an operator knob, unlike the process-wide
        # inflight budget below whose overflow is terminal
        if not lim.allow_n(size):
            self.metrics.traces_rate_limited[tenant] = (
                self.metrics.traces_rate_limited.get(tenant, 0) + 1
            )
            discarded_spans.inc(batch.num_spans, reason="rate_limited", tenant=tenant)
            raise RateLimited(
                f"tenant {tenant}: ingestion rate limit exceeded",
                retry_after_s=lim.retry_after_s(size),
            )
        # instance-wide inflight-bytes gate ABOVE the per-tenant buckets
        # (reference: distributor instance limits): per-tenant buckets
        # bound steady-state rates, but N tenants' worth of simultaneous
        # in-limit pushes can still pile up unbounded fan-out memory
        gate = self.governor.pool("inflight_push")
        if gate.limit and size > gate.limit:
            # can NEVER be admitted, even on an idle process — a 429
            # with a retry hint here would livelock a well-behaved
            # client. Terminal: split the batch or raise the budget.
            discarded_spans.inc(batch.num_spans, reason="too_large", tenant=tenant)
            raise ValueError(
                f"push of {size} bytes exceeds the whole inflight budget "
                f"({gate.limit} bytes); send smaller batches"
            )
        if not gate.try_add(size):
            discarded_spans.inc(batch.num_spans, reason="overload", tenant=tenant)
            resource.shed_total.inc(component="distributor", reason="inflight_push_full")
            raise resource.ResourceExhausted(
                f"distributor: inflight push bytes over budget "
                f"({gate.used}/{gate.limit}); slow down",
                retry_after_s=self.governor.retry_after_s(),
            )
        try:
            inflight_push_gauge.set(gate.used)
            self._fan_out(tenant, batch, size)
        finally:
            gate.sub(size)
            inflight_push_gauge.set(gate.used)

    def _fan_out(self, tenant: str, batch: SpanBatch, size: int) -> None:
        self.metrics.spans_received[tenant] = (
            self.metrics.spans_received.get(tenant, 0) + batch.num_spans
        )
        self.metrics.bytes_received[tenant] = self.metrics.bytes_received.get(tenant, 0) + size
        spans_received.inc(batch.num_spans, tenant=tenant)
        bytes_received.inc(size, tenant=tenant)
        # cost plane: ingest settles HERE (the front door owns ingest
        # attribution; replicas are capacity, not tenant demand)
        usage.record(tenant, "ingest",
                     ingested_bytes=size, ingested_spans=batch.num_spans)

        with tracing.span("distributor/group_by_replica", spans=batch.num_spans):
            groups = self._group_by_replica(tenant, batch)
        if not groups:
            raise NoHealthyIngesters("no healthy ingesters in the ring")
        errs = []
        shed_errs = []
        for instance_id, sub in groups.items():
            client = self.clients.get(instance_id)
            if client is None:
                errs.append(f"no client for {instance_id}")
                continue
            try:
                # one span per replica push: the replication fan-out is
                # where a slow/dead ingester shows up (reference:
                # DoBatch's per-instance spans, distributor.go:389)
                with tracing.span("distributor/push_replica",
                                  instance=instance_id, spans=sub.num_spans):
                    client.push_segment(tenant, fmt.serialize_batch(sub))
            except resource.ResourceExhausted as e:  # ingester refused: overload
                shed_errs.append(e)
                errs.append(f"{instance_id}: {e}")
            except Exception as e:  # collect; quorum decided below
                errs.append(f"{instance_id}: {e}")
        if errs:
            self.metrics.push_failures += len(errs)
            # reference DoBatch succeeds while a quorum of replicas ack;
            # with RF copies per trace, tolerate < RF/2+1 failures
            rf = self.ring.replication_factor
            tolerated = max(0, rf - (rf // 2 + 1))
            if len(errs) > tolerated:
                # backpressure only if the SHEDS are what broke quorum:
                # the hard failures alone fitting the tolerance means the
                # push would have succeeded had nobody shed. Hard outages
                # breaking quorum on their own must stay a 5xx/IOError —
                # a 429 there would hide a replica outage from alerting.
                if shed_errs and len(errs) - len(shed_errs) <= tolerated:
                    discarded_spans.inc(batch.num_spans, reason="overload", tenant=tenant)
                    raise resource.ResourceExhausted(
                        f"push shed by ingesters: {errs}",
                        retry_after_s=max(e.retry_after_s for e in shed_errs),
                    )
                raise IOError(f"push failed: {errs}")

        self._send_to_generators(tenant, batch)

    # ------------------------------------------------------------------
    def _group_by_replica(self, tenant: str, batch: SpanBatch) -> dict[str, SpanBatch]:
        """Group span rows by destination ingester: token per trace ID,
        ring replica lookup, one sub-batch per instance (HOT LOOP 1 of
        the reference, distributor.go:483 — here it's one hash over the
        ID columns plus a stable argsort)."""
        tid = batch.cols["trace_id"]
        tokens = hashing.np_token_for_ids(tenant, tid)
        # per unique trace -> replicas, against ONE ring snapshot (the KV
        # re-read + token sort must not run per trace)
        snap = self.ring.snapshot()
        uniq, inverse = np.unique(tid, axis=0, return_inverse=True)
        uniq_tokens = tokens[np.unique(inverse, return_index=True)[1]]
        assignments: dict[str, list] = {}
        for u in range(len(uniq)):
            for rep in snap.get_replicas(int(uniq_tokens[u])):
                assignments.setdefault(rep.instance_id, []).append(u)
        out = {}
        for instance_id, trace_idxs in assignments.items():
            mask = np.isin(inverse, trace_idxs)
            out[instance_id] = batch.select(np.flatnonzero(mask))
        return out

    def _send_to_generators(self, tenant: str, batch: SpanBatch) -> None:
        if not self.generator_ring or not self.generator_clients:
            return
        size = self.overrides.for_tenant(tenant).metrics_generator_ring_size
        targets = self.generator_ring.shuffle_shard(tenant, size)
        if not targets:
            return
        # single-assignment by trace token within the shard
        tid = batch.cols["trace_id"]
        tokens = hashing.np_token_for_ids(tenant, tid)
        idx = tokens % np.uint32(len(targets))
        for i, inst in enumerate(targets):
            client = self.generator_clients.get(inst.instance_id)
            if client is None:
                continue
            rows = np.flatnonzero(idx == i)
            if len(rows) == 0:
                continue
            try:
                client.push_segment(tenant, fmt.serialize_batch(batch.select(rows)))
            except Exception:
                log.exception("generator push failed (non-fatal)")
