"""Producer/consumer overlap utilities for the hot data paths.

Port of tempo_tpu/util/pipeline.py (overlap_enabled, prefetch_iter,
ReadAhead). The reference's prefetch counters, per-request cost vector
and memory-pressure gate arrive with the slice that reads them.

SURVEY.md 7.4 names host<->device bandwidth + serial decode->kernel->
encode chains as the 10x-killer; the reference overlaps these stages
with async page prefetch (pkg/parquetquery/iters.go:246,
tempodb/encoding/v2/iterator_prefetch.go) and N flush queues. Python
equivalents work because the heavy stages release the GIL: native codec
calls are ctypes (GIL dropped for the C call), device dispatch blocks in
the device runtime, and file IO blocks in the OS.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

_SENTINEL = object()


def overlap_enabled() -> bool:
    """Whether producer/consumer threading can actually overlap work.

    On a single-core host the GIL-released C calls still cannot run
    concurrently with Python (one core), so background threads only add
    context switches."""
    try:
        # affinity-aware: a pinned/cgroup-limited process on a big node
        # still only has the cpuset it was given
        usable = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover
        usable = os.cpu_count() or 1
    return usable > 1


def prefetch_iter(iterable, depth: int = 2, join_timeout_s: float = 60.0):
    """Run `iterable` on a background thread, buffering up to `depth`
    items ahead of the consumer. Exceptions re-raise at the consumer.
    Closing the returned generator (or abandoning it) stops the producer
    thread, so a consumer that fails mid-stream never leaks a thread
    blocked on a full queue.

    BLOCKING-CLOSE CONTRACT: close() joins the producer for up to
    `join_timeout_s` (default 60s) so the caller's cleanup cannot race a
    producer still inside the source. A producer wedged in an
    uncancellable call therefore stalls close() for the full timeout —
    acceptable on the compactor (today's only caller, documented there);
    latency-sensitive callers must pass a small join_timeout_s and
    accept the leaked daemon thread instead."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # propagate into the consuming thread
            _put((_SENTINEL, e))
        else:
            _put((_SENTINEL, None))
        finally:
            # close the source ON the producer thread: the generator is
            # guaranteed not to be executing here, so this cannot race a
            # cross-thread close() (ValueError: generator already
            # executing) the way a consumer-side close would
            close = getattr(iterable, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=run, daemon=True, name="prefetch-iter")
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        # quiesce before returning control: the caller's cleanup (closing
        # block streams under the producer) is only safe once the
        # producer has actually exited. Bounded join: a producer stuck in
        # an untimed backend read must not convert a failed job into a
        # hung daemon — leak the (daemon) thread with a warning instead,
        # which is the pre-join behavior for exactly that pathology.
        t.join(timeout=join_timeout_s)
        if t.is_alive():  # pragma: no cover - needs a wedged source
            import logging

            logging.getLogger(__name__).warning(
                "prefetch producer did not quiesce within %.0fs; leaking daemon thread",
                join_timeout_s,
            )


class ReadAhead:
    """One-slot lookahead for a pull-based loader: while the consumer
    works on item i, a worker thread loads item i+1."""

    def __init__(self, load, n_items: int):
        self._load = load
        self._n = n_items
        self._next = 0
        self._future = None
        self._pool = (
            ThreadPoolExecutor(max_workers=1)
            if n_items > 1 and overlap_enabled()
            else None
        )

    def _schedule(self):
        if self._pool is not None and self._next < self._n:
            i = self._next
            self._future = self._pool.submit(self._load, i)

    def get(self, i: int):
        """Items must be requested in order 0..n-1."""
        if self._future is not None and self._next == i:
            fut, self._future = self._future, None
            self._next += 1
            self._schedule()
            return fut.result()
        # cold path (first call or out-of-order): load inline, then look ahead
        item = self._load(i)
        self._next = i + 1
        self._schedule()
        return item

    def close(self):
        self._future = None
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
