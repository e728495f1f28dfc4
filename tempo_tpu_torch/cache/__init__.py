"""Cache clients (pkg/cache equivalent). Port of tempo_tpu/cache, copied as
is (host code).

Reference: pkg/cache (forked from Cortex) — a byte-oriented Cache
interface (`Store/Fetch/Stop`, cache.go:14), a memcached client with a
consistent-hash server selector, a redis client, a background
write-behind decorator (background.go) that queues writes so the hot
path never blocks on the cache, and an in-memory mock for tests.
"""

from tempo_tpu_torch.cache.client import (
    BackgroundCache,
    Cache,
    LRUCache,
    MemcachedCache,
    MockCache,
    RedisCache,
)

__all__ = ["Cache", "LRUCache", "MemcachedCache", "RedisCache", "BackgroundCache", "MockCache"]
