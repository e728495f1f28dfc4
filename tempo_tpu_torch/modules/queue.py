"""Port of tempo_tpu/modules/queue.py, copied as is (host code).

Fair per-tenant request queue with pull workers.

Reference: pkg/scheduler/queue (RequestQueue queue.go:49, per-tenant
round-robin user_queues.go:25, querier shuffle-shard assignment,
frontend v1 Process pull loop). Queriers pull jobs; tenants are served
round-robin so one heavy tenant can't starve others; per-tenant depth
caps produce backpressure ("too many outstanding requests").

Drained tenants are PRUNED (the reference deletes empty user queues,
user_queues.go deleteQueue): without it, tenant churn grows `_queues`/
`_rr` without bound and every dequeue scans the dead tenants forever.
Removal keeps round-robin fairness: `_rr_idx` is a position in `_rr`,
and removing an entry before it shifts the index back so no surviving
tenant loses (or gains) a turn.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class TooManyRequests(Exception):
    """Reference: frontend v1's 'too many outstanding requests'."""


class QueueStopped(Exception):
    pass


class RequestQueue:
    def __init__(self, max_per_tenant: int = 2000):
        self.max_per_tenant = max_per_tenant
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queues: dict[str, deque] = {}
        self._rr: list[str] = []  # round-robin order of tenants with jobs
        self._rr_idx = 0  # position in _rr of the NEXT tenant to serve
        self._stopped = False
        self.enqueued = 0
        self.discarded = 0

    def enqueue(self, tenant: str, job) -> None:
        with self._cv:
            if self._stopped:
                raise QueueStopped()
            q = self._queues.get(tenant)
            if (q is not None and len(q) >= self.max_per_tenant) or self.max_per_tenant <= 0:
                self.discarded += 1
                raise TooManyRequests(f"tenant {tenant}: queue full")
            if q is None:
                # invariant: a tenant is in _rr/_queues iff it has jobs —
                # the rejection above runs first so a refused enqueue
                # never leaves an empty queue behind
                q = deque()
                self._queues[tenant] = q
                # new tenants join just BEHIND the round-robin cursor: they
                # wait at most one full rotation, and a tenant churning
                # (drain, re-enqueue) can't jump the line
                self._rr.insert(self._rr_idx, tenant)
                self._rr_idx += 1
                if self._rr_idx >= len(self._rr):
                    self._rr_idx = 0
            q.append((time.monotonic(), job))
            self.enqueued += 1
            self._cv.notify()

    def _prune_at(self, pos: int) -> None:
        """Remove the drained tenant at _rr position pos (lock held)."""
        tenant = self._rr.pop(pos)
        del self._queues[tenant]
        if pos < self._rr_idx:
            self._rr_idx -= 1
        if self._rr and self._rr_idx >= len(self._rr):
            self._rr_idx = 0

    def dequeue(self, timeout: float | None = None):
        """Next job, fair across tenants -> (tenant, job) or None on
        timeout/stop."""
        with self._cv:
            while True:
                if self._stopped:
                    return None
                if self._rr:
                    pos = self._rr_idx % len(self._rr)
                    tenant = self._rr[pos]
                    q = self._queues[tenant]
                    _, job = q.popleft()
                    if q:
                        self._rr_idx = (pos + 1) % len(self._rr)
                    else:
                        # drained: prune in place — the next tenant slides
                        # into this slot, so the rotation order holds
                        self._prune_at(pos)
                    return tenant, job
                if not self._cv.wait(timeout=timeout):
                    return None

    def lengths(self) -> dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items() if q}

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def tenant_count(self) -> int:
        """Tenants currently holding queued jobs (pruning keeps this the
        ACTIVE set, not the ever-seen set)."""
        with self._lock:
            return len(self._queues)

    def oldest_age_s(self, now: float | None = None) -> float:
        """Age of the oldest queued job in seconds (0 when empty) — the
        queue-age signal the overload dashboard/alerts watch: depth can
        look modest while age grows without bound when workers are
        wedged."""
        now = time.monotonic() if now is None else now
        with self._lock:
            oldest = None
            for q in self._queues.values():
                if q:
                    at = q[0][0]
                    if oldest is None or at < oldest:
                        oldest = at
        return max(0.0, now - oldest) if oldest is not None else 0.0

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
