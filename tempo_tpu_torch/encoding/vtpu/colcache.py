"""Process-wide column cache, host tier (decoded arrays).

Port of the host tier of tempo_tpu/encoding/vtpu/colcache.py
(`ColumnCache`, `shared_cache`, `_register_metrics`). The device tier
(`DeviceTier`, `configure_device_tier`, `shared_device_tier`), which the
reference leaves off by default, arrives with the device-tier slice.

Reference analog: the reference caches parquet footers/column pages
across queries (vparquet/readers.go over tempodb/backend/cache). Here
the unit is a DECODED column chunk: repeated queries against a hot block
skip the ranged read AND the codec, not just the bytes.

Keys are (block_id, column name, page offset): blocks are immutable and
content lives at fixed offsets, so entries never need invalidation —
deletion just stops producing hits and the LRU ages the dead entries
out. The column name is part of the key because zero-byte pages (empty
columns) share one offset with their neighbors and would otherwise
alias across columns.
Cached arrays are marked read-only; every consumer treats SpanBatch
columns as immutable by convention, and the flag turns a future
violation into a loud error instead of silent cross-query corruption.

Sizing: TEMPO_TPU_COLCACHE_MB (default 256; 0 disables), as in the
reference. One shared instance serves every block of the process.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from tempo_tpu_torch.util import usage


class ColumnCache:
    """Bytes-bounded, thread-safe LRU of numpy arrays.

    Pressure-aware: the effective capacity shrinks with the process
    pressure level (util/resource) — half at PRESSURE, an eighth at
    CRITICAL — so cached decode results yield memory to live ingest
    instead of competing with it, and grow back automatically when the
    pressure clears. The level is consulted on put (the only growth
    path), never on get."""

    _PRESSURE_FACTORS = {0: 1.0, 1: 0.5, 2: 0.125}

    def __init__(self, max_bytes: int, governor=None):
        self.max_bytes = max_bytes
        self._governor = governor  # None = process governor, bound lazily
        self._lru: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def effective_max_bytes(self) -> int:
        gov = self._governor
        if gov is None:
            from tempo_tpu_torch.util import resource

            gov = self._governor = resource.governor()
        return int(self.max_bytes * self._PRESSURE_FACTORS.get(gov.level(), 1.0))

    def get(self, key):
        with self._lock:
            arr = self._lru.get(key)
            if arr is not None:
                self._lru.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        # cost plane: hit/miss charged to the requesting tenant's vector
        # (outside the lock — charge takes the vector's own lock)
        usage.charge("cache_hits" if arr is not None else "cache_misses")
        return arr

    def put(self, key, arr) -> None:
        try:
            arr.setflags(write=False)
        except ValueError:  # non-owned buffer already read-only
            pass
        limit = self.effective_max_bytes()
        with self._lock:
            prev = self._lru.get(key)
            if prev is not None:
                # racing loaders of the same miss: replace, don't
                # double-count (an unconditional += ratchets _bytes up
                # and shrinks effective capacity toward zero)
                self._bytes -= prev.nbytes
            self._lru[key] = arr
            self._bytes += arr.nbytes
            while self._bytes > limit and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self._bytes -= evicted.nbytes
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "tier": "host",
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bytes": self._bytes,
                "entries": len(self._lru),
                "max_bytes": self.max_bytes,
                "effective_max_bytes": self.effective_max_bytes(),
            }

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._bytes = 0


_shared: ColumnCache | None = None
_shared_lock = threading.Lock()


def shared_cache() -> ColumnCache | None:
    """The process-wide cache, or None when disabled
    (TEMPO_TPU_COLCACHE_MB=0)."""
    global _shared
    if _shared is None:
        with _shared_lock:
            if _shared is None:
                mb = int(os.environ.get("TEMPO_TPU_COLCACHE_MB", "256"))
                if mb <= 0:
                    return None
                _shared = ColumnCache(mb << 20)
                _register_metrics(_shared)
    return _shared


def _register_metrics(cache) -> None:
    """Publish cache stats on /metrics (reference: the backend cache's
    promauto gauges): a collector refreshes the gauges from stats() at
    every exposition, so read-path cache behavior is observable
    process-wide, not just per bench run. The `tier` label names the
    host tier, as the reference's family does."""
    from tempo_tpu_torch.util import metrics

    gauges = {
        name: metrics.gauge(
            f"tempo_tpu_colcache_{name}",
            f"Column cache {name} by tier (host=decoded arrays, "
            "device=resident compressed pages; colcache.stats)",
        )
        for name in ("hits", "misses", "evictions", "bytes", "entries")
    }

    def collect():
        stats = cache.stats()
        tier = stats.get("tier", "host")
        for name, value in stats.items():
            g = gauges.get(name)
            if g is not None:
                g.set(value, tier=tier)

    metrics.register_collector(collect)
