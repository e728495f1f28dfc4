"""Service-graphs processor: client/server span pairing -> edge metrics.

Reference: modules/generator/processor/servicegraphs (servicegraphs.go:60,
consume:140, expiring edge store store/store.go). An edge exists when a
server span's parent is a client span from another service; unpaired
halves wait in an expiring store.

Cardinality accounting uses the device sketches (ops.sketch): HLL for
distinct edge count, count-min for hot-edge estimation — the
BASELINE.json north-star metric for this processor.

Port of tempo_tpu/modules/generator/servicegraphs.py. The sketches live
as tensors on the processor's `device`: each push's paired edges go to
the card in one host-to-device copy of their keys and fold in through
ops/sketch's hll_update and cm_update (the hand kernels there, their
plain versions on the CPU).
"""

from __future__ import annotations

import time

import numpy as np
import torch

# edge semantics (pairing rule, failure classification, sketch key) are
# shared with the stored-block trace-graph engine (tempo_tpu_torch/graph) so
# live-generator edges and /api/graph/dependencies cannot drift
from tempo_tpu_torch import device as _device
from tempo_tpu_torch.graph import edge_hash_limbs, span_failed
from tempo_tpu_torch.model.trace import KIND_CLIENT, KIND_SERVER
from tempo_tpu_torch.ops import sketch

REQ_TOTAL = "traces_service_graph_request_total"
REQ_FAILED = "traces_service_graph_request_failed_total"
REQ_SECONDS = "traces_service_graph_request_server_seconds"
# spans evicted from the pairing store without ever matching, labeled by
# which half waited (store="client"|"server") and why it left
# (reason="expired"|"evicted") — so stored-vs-live graph discrepancies
# are attributable instead of a single opaque int
EXPIRED_TOTAL = "traces_service_graph_expired_spans_total"

DEFAULT_BOUNDS = [0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4, 12.8]


class ServiceGraphsProcessor:
    name = "service-graphs"

    def __init__(self, registry, wait_s: float = 10.0, max_items: int = 10_000,
                 bounds=None, device=None):
        self.registry = registry
        self.wait_s = wait_s
        self.max_items = max_items
        self.bounds = bounds or DEFAULT_BOUNDS
        # (trace_id, span_id) -> (service, ts) for client spans waiting
        self.pending_clients: dict[tuple, tuple] = {}
        # (trace_id, parent_id) -> (service, dur_s, failed, ts) for servers
        self.pending_servers: dict[tuple, tuple] = {}
        self.expired = 0
        self.edges_emitted = 0
        self.device = _device.resolve(device)
        self.hll = sketch.hll_init(sketch.HLLPlan(12), self.device)
        self.cm = sketch.cm_init(sketch.CMPlan(), self.device)
        self._edge_keys: list = []

    def push(self, batch, now: float | None = None) -> None:
        now = now or time.time()
        c = batch.cols
        d = batch.dictionary
        kinds = c["kind"]
        for row in np.flatnonzero((kinds == KIND_CLIENT) | (kinds == KIND_SERVER)):
            tid = c["trace_id"][row].tobytes()
            svc = d[int(c["service"][row])]
            if kinds[row] == KIND_CLIENT:
                key = (tid, c["span_id"][row].tobytes())
                srv = self.pending_servers.pop(key, None)
                if srv is not None:
                    self._emit(svc, srv[0], srv[1], srv[2])
                else:
                    self._put(self.pending_clients, key, (svc, now))
            else:
                key = (tid, c["parent_span_id"][row].tobytes())
                dur_s = float(c["duration_nano"][row]) / 1e9
                failed = span_failed(int(c["status_code"][row]))
                cli = self.pending_clients.pop(key, None)
                if cli is not None:
                    self._emit(cli[0], svc, dur_s, failed)
                else:
                    self._put(self.pending_servers, key, (svc, dur_s, failed, now))
        self.expire(now)
        self._flush_sketches()

    def _put(self, store, key, value):
        if len(store) >= self.max_items:
            store.pop(next(iter(store)), None)  # evict oldest-inserted
            self._count_unpaired(store, "evicted")
        store[key] = value

    def _count_unpaired(self, store, reason: str) -> None:
        self.expired += 1
        half = "client" if store is self.pending_clients else "server"
        self.registry.inc_counter(
            EXPIRED_TOTAL, (("store", half), ("reason", reason)), 1.0
        )

    def _emit(self, client_svc: str, server_svc: str, dur_s: float, failed: bool):
        if client_svc == server_svc:
            return
        labels = (("client", client_svc), ("server", server_svc))
        self.registry.inc_counter(REQ_TOTAL, labels, 1.0)
        if failed:
            self.registry.inc_counter(REQ_FAILED, labels, 1.0)
        bidx = int(np.searchsorted(np.asarray(self.bounds), dur_s, side="left"))
        counts = [0] * (len(self.bounds) + 1)
        counts[bidx] = 1
        self.registry.observe_histogram(REQ_SECONDS, labels, self.bounds, counts, dur_s, 1)
        self.edges_emitted += 1
        # sketch update batched in _flush_sketches; the key hash is the
        # shared graph-module definition (full pair, so long client names
        # don't truncate away the server half)
        self._edge_keys.append(edge_hash_limbs(client_svc, server_svc))

    def _flush_sketches(self):
        if not self._edge_keys:
            return
        # the keys leave the processor before the launches: a failed fold
        # drops this push's sketch update instead of folding it again later
        edge_keys, self._edge_keys = self._edge_keys, []
        # one host-to-device copy of the push's edge keys (uint32 bits)
        keys = torch.from_numpy(np.stack(edge_keys).view(np.int32)).to(self.device)
        self.hll = sketch.hll_update(self.hll, keys, sketch.HLLPlan(12))
        self.cm = sketch.cm_update(self.cm, keys, sketch.CMPlan())

    def expire(self, now: float) -> None:
        for store, ts_idx in ((self.pending_clients, 1), (self.pending_servers, 3)):
            dead = [k for k, v in store.items() if now - v[ts_idx] > self.wait_s]
            for k in dead:
                del store[k]
                self._count_unpaired(store, "expired")

    def distinct_edges_estimate(self) -> float:
        return float(sketch.hll_estimate(self.hll, sketch.HLLPlan(12)))
