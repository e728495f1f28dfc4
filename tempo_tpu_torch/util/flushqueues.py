"""Port of tempo_tpu/util/flushqueues.py, copied as is (host code).

Priority flush queues with dedupe-by-key.

Reference: pkg/flushqueues (priority_queue.go:23 PriorityQueue,
exclusivequeues.go:18 ExclusiveQueues) backing the ingester's flush
pipeline (modules/ingester/flush.go:124-360): N queues indexed by op-key
hash, each a min-heap on `at` (retry time), an op key can only be
in-flight once (`Contains` set), failed ops are requeued with backoff,
and ops that exhaust retries are dropped via a callback (the reference's
data-loss cap, flush.go:254-262).
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field

log = logging.getLogger(__name__)


@dataclass(order=True)
class FlushOp:
    at: float  # priority: not processed before this time
    seq: int = field(compare=True)  # FIFO among equal `at`
    key: str = field(compare=False, default="")
    kind: str = field(compare=False, default="flush")
    payload: object = field(compare=False, default=None)
    attempts: int = field(compare=False, default=0)


class PriorityQueue:
    """Min-heap on FlushOp.at with key dedupe (priority_queue.go:23)."""

    def __init__(self):
        self._heap: list[FlushOp] = []
        self._keys: set[str] = set()
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._closed = False

    def enqueue(self, op: FlushOp) -> bool:
        """False if an op with the same key is already queued/in-flight."""
        with self._cv:
            if self._closed or op.key in self._keys:
                return False
            op.seq = next(self._seq)
            self._keys.add(op.key)
            heapq.heappush(self._heap, op)
            self._cv.notify()
            return True

    def dequeue(self, timeout: float | None = None) -> FlushOp | None:
        """Blocks until an op is *due* (at <= now) or timeout/closed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                now = time.time()
                if self._heap and self._heap[0].at <= now:
                    return heapq.heappop(self._heap)
                if self._closed:
                    return None
                wait = None
                if self._heap:
                    wait = max(self._heap[0].at - now, 0.01)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._cv.wait(timeout=wait)

    def clear_key(self, key: str) -> None:
        """Op finished (success or dropped): allow the key again."""
        with self._cv:
            self._keys.discard(key)
            self._cv.notify()

    def requeue(self, op: FlushOp) -> None:
        """Key stays held; the op re-enters with its new `at`."""
        with self._cv:
            if self._closed:
                self._keys.discard(op.key)
                return
            op.seq = next(self._seq)
            heapq.heappush(self._heap, op)
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._heap)


class ExclusiveQueues:
    """N priority queues; an op's key pins it to one queue
    (exclusivequeues.go:18). Workers are owned by the caller."""

    def __init__(self, n_queues: int = 4):
        self.queues = [PriorityQueue() for _ in range(max(n_queues, 1))]

    def _index(self, key: str) -> int:
        h = 2166136261
        for c in key.encode():
            h = ((h ^ c) * 16777619) & 0xFFFFFFFF
        return h % len(self.queues)

    def enqueue(self, op: FlushOp) -> bool:
        return self.queues[self._index(op.key)].enqueue(op)

    def requeue(self, op: FlushOp) -> None:
        self.queues[self._index(op.key)].requeue(op)

    def clear_key(self, key: str) -> None:
        self.queues[self._index(key)].clear_key(key)

    def close(self) -> None:
        for q in self.queues:
            q.close()

    def pending(self) -> int:
        return sum(len(q) for q in self.queues)
