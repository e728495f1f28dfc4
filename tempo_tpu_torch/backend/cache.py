"""Caching decorator over a RawBackend. Port of tempo_tpu/backend/cache.py,
copied as is (host code).

Reference: tempodb/backend/cache/cache.go — wraps backend.RawReader/
RawWriter; bloom-filter objects are always cached, footer/index reads
optionally (CacheControl flags on common.SearchOptions / readers.go);
writes write-through so freshly-built blocks are warm.

Cache keys are `<tenant>:<block>:<name>` (whole objects) and
`:<offset>:<len>` suffixed for ranged reads — a block is immutable once
written (compaction writes NEW blocks and deletes old ones,
tempodb/compactor.go markCompacted), so cached entries never go stale;
deletes still invalidate defensively.
"""

from __future__ import annotations

from dataclasses import dataclass

from tempo_tpu_torch.backend.base import RawBackend
from tempo_tpu_torch.cache import Cache
from tempo_tpu_torch.util import usage


@dataclass
class CacheControl:
    """Which object classes are cached (reference: cache.go + readers.go
    footer/column-index/offset-index flags)."""

    cache_bloom: bool = True
    cache_index: bool = True
    cache_data_ranges: bool = False  # page-level ranged reads
    max_cacheable_bytes: int = 16 << 20


def _cacheable(name: str, ctl: CacheControl) -> bool:
    if name.startswith("bloom-"):
        return ctl.cache_bloom
    if name.startswith("index") or name.startswith("dict"):
        return ctl.cache_index
    return False


class CachedBackend(RawBackend):
    def __init__(self, inner: RawBackend, cache: Cache, ctl: CacheControl | None = None):
        self.inner = inner
        self.cache = cache
        self.ctl = ctl or CacheControl()

    def _key(self, name: str, keypath: tuple) -> str:
        return ":".join((*keypath, name))

    # -- writes: write-through ------------------------------------------
    def write(self, name: str, keypath: tuple, data: bytes) -> None:
        self.inner.write(name, keypath, data)
        if _cacheable(name, self.ctl) and len(data) <= self.ctl.max_cacheable_bytes:
            self.cache.store([self._key(name, keypath)], [data])

    def append(self, name: str, keypath: tuple, data: bytes) -> None:
        self.inner.append(name, keypath, data)

    # -- reads ----------------------------------------------------------
    def read(self, name: str, keypath: tuple) -> bytes:
        if not _cacheable(name, self.ctl):
            return self.inner.read(name, keypath)
        key = self._key(name, keypath)
        _, bufs, missed = self.cache.fetch([key])
        if not missed:
            usage.charge("cache_hits")
            return bufs[0]
        usage.charge("cache_misses")
        data = self.inner.read(name, keypath)
        if len(data) <= self.ctl.max_cacheable_bytes:
            self.cache.store([key], [data])
        return data

    def read_range(self, name: str, keypath: tuple, offset: int, length: int) -> bytes:
        if not (self.ctl.cache_data_ranges or _cacheable(name, self.ctl)):
            return self.inner.read_range(name, keypath, offset, length)
        key = f"{self._key(name, keypath)}:{offset}:{length}"
        _, bufs, missed = self.cache.fetch([key])
        if not missed:
            usage.charge("cache_hits")
            return bufs[0]
        usage.charge("cache_misses")
        data = self.inner.read_range(name, keypath, offset, length)
        if len(data) <= self.ctl.max_cacheable_bytes:
            self.cache.store([key], [data])
        return data

    # -- passthrough -----------------------------------------------------
    def list(self, keypath: tuple) -> list[str]:
        return self.inner.list(keypath)

    def list_objects(self, keypath: tuple) -> list[str]:
        lister = getattr(self.inner, "list_objects", None)
        if lister is None:
            raise NotImplementedError
        return lister(keypath)

    def delete(self, name: str, keypath: tuple) -> None:
        self.inner.delete(name, keypath)

    def flush_appends(self, keypath: tuple | None = None) -> None:
        flusher = getattr(self.inner, "flush_appends", None)
        if flusher is not None:
            flusher(keypath)
