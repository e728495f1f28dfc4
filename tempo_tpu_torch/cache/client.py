"""Port of tempo_tpu/cache/client.py, copied as is (host code).

Byte-cache clients: in-memory LRU, memcached (text protocol),
write-behind decorator.

Reference: pkg/cache/cache.go:14 (Cache interface: Store(keys, bufs) /
Fetch(keys) -> found, bufs, missed / Stop), pkg/cache/memcached*.go
(client pool + consistent selector), pkg/cache/background.go
(bounded write-behind queue, drops on overflow with a counter),
pkg/cache/mock.go.
"""

from __future__ import annotations

import socket
import threading
from collections import OrderedDict, deque

from tempo_tpu_torch.util import metrics

cache_hits = metrics.counter("tempo_cache_hits_total", "Cache fetch hits")
cache_misses = metrics.counter("tempo_cache_misses_total", "Cache fetch misses")
cache_evictions = metrics.counter(
    "tempo_cache_evictions_total",
    "In-process LRU cache entries evicted by the byte-size bound",
)
cache_dropped = metrics.counter(
    "tempo_cache_background_writes_dropped_total",
    "Write-behind queue overflow drops (reference: background.go droppedWriteBack)",
)


class Cache:
    """Multi-key byte cache (reference: pkg/cache/cache.go:14)."""

    def store(self, keys: list[str], bufs: list[bytes]) -> None:
        raise NotImplementedError

    def fetch(self, keys: list[str]) -> tuple[list[str], list[bytes], list[str]]:
        """Returns (found_keys, bufs, missed_keys), preserving key order."""
        raise NotImplementedError

    def stop(self) -> None:
        pass


class LRUCache(Cache):
    """In-process LRU with byte-size bound — the fifo/lru cache the
    reference embeds for index pages."""

    def __init__(self, max_bytes: int = 64 << 20):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._data: OrderedDict[str, bytes] = OrderedDict()
        self._size = 0

    def store(self, keys, bufs) -> None:
        with self._lock:
            for k, b in zip(keys, bufs):
                old = self._data.pop(k, None)
                if old is not None:
                    self._size -= len(old)
                self._data[k] = b
                self._size += len(b)
            while self._size > self.max_bytes and self._data:
                _, evicted = self._data.popitem(last=False)
                self._size -= len(evicted)
                cache_evictions.inc()

    def fetch(self, keys):
        found, bufs, missed = [], [], []
        with self._lock:
            for k in keys:
                b = self._data.get(k)
                if b is None:
                    missed.append(k)
                    cache_misses.inc()
                else:
                    self._data.move_to_end(k)
                    found.append(k)
                    bufs.append(b)
                    cache_hits.inc()
        return found, bufs, missed


class MockCache(LRUCache):
    """Unbounded in-memory cache for tests (reference: pkg/cache/mock.go)."""

    def __init__(self):
        super().__init__(max_bytes=1 << 62)


def _server_for(addresses: list[str], key: str) -> str:
    """Shared consistent server selection: jump-less modular choice over
    fnv32 — consistent enough for a static server list (the reference
    rebuilds its ring on DNS changes). Both the memcached and redis
    clients MUST use this same function or key placement splits."""
    h = 2166136261
    for c in key.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return addresses[h % len(addresses)]


def _tally(keys: list[str], got: dict) -> tuple[list[str], list[bytes], list[str]]:
    """Order-preserving (found, bufs, missed) + hit/miss metrics."""
    found, bufs, missed = [], [], []
    for k in keys:
        if k in got:
            found.append(k)
            bufs.append(got[k])
            cache_hits.inc()
        else:
            missed.append(k)
            cache_misses.inc()
    return found, bufs, missed


class MemcachedCache(Cache):
    """Minimal memcached text-protocol client with a consistent-hash
    server selector (reference: pkg/cache/memcached_client.go uses
    bradfitz/gomemcache + cespare/xxhash ring selection).
    """

    def __init__(self, addresses: list[str], ttl_s: int = 0, timeout_s: float = 0.5):
        if not addresses:
            raise ValueError("memcached: at least one address required")
        self.addresses = addresses
        self.ttl_s = ttl_s
        self.timeout_s = timeout_s
        self._conns: dict[str, socket.socket] = {}
        self._lock = threading.Lock()

    def _server_for(self, key: str) -> str:
        return _server_for(self.addresses, key)

    def _conn(self, addr: str) -> socket.socket:
        s = self._conns.get(addr)
        if s is not None:
            # reused sockets must re-arm the deadline: create_connection's
            # timeout only covers the connect, and a wedged server would
            # otherwise hang the querier on recv forever
            s.settimeout(self.timeout_s)
            return s
        host, port = addr.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=self.timeout_s)
        s.settimeout(self.timeout_s)
        self._conns[addr] = s
        return s

    def _drop(self, addr: str) -> None:
        s = self._conns.pop(addr, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _sendline(self, s: socket.socket, line: bytes) -> None:
        s.sendall(line + b"\r\n")

    def _readline(self, f) -> bytes:
        return f.readline().rstrip(b"\r\n")

    def store(self, keys, bufs) -> None:
        with self._lock:
            for k, b in zip(keys, bufs):
                addr = self._server_for(k)
                # one reconnect per key, then give up: a dead server costs
                # at most 2 * timeout_s, never a wedged querier
                for _attempt in (0, 1):
                    try:
                        s = self._conn(addr)
                        s.sendall(
                            b"set %s 0 %d %d\r\n%s\r\n"
                            % (k.encode(), self.ttl_s, len(b), b)
                        )
                        f = s.makefile("rb")
                        self._readline(f)  # STORED
                        break
                    except OSError:
                        self._drop(addr)

    def fetch(self, keys):
        by_server: dict[str, list[str]] = {}
        for k in keys:
            by_server.setdefault(self._server_for(k), []).append(k)
        got: dict[str, bytes] = {}
        with self._lock:
            for addr, ks in by_server.items():
                # one reconnect per server, then degrade to miss
                for _attempt in (0, 1):
                    try:
                        s = self._conn(addr)
                        self._sendline(s, b"get " + " ".join(ks).encode())
                        f = s.makefile("rb")
                        while True:
                            line = self._readline(f)
                            if line == b"END" or not line:
                                break
                            # VALUE <key> <flags> <bytes>
                            parts = line.split()
                            n = int(parts[3])
                            data = f.read(n)
                            f.read(2)  # trailing \r\n
                            got[parts[1].decode()] = data
                        break
                    except OSError:
                        self._drop(addr)
        return _tally(keys, got)

    def stop(self) -> None:
        with self._lock:
            for s in self._conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._conns.clear()


class RedisCache(Cache):
    """Minimal Redis client speaking RESP2 (SET [EX ttl] / MGET) with the
    same consistent server selection as the memcached client
    (reference: tempodb/backend/cache/redis/ + pkg/cache/redis_*.go,
    which wrap go-redis; here the wire protocol is hand-rolled like the
    rest of this repo's clients).
    """

    def __init__(self, addresses: list[str], ttl_s: int = 0, timeout_s: float = 0.5):
        if not addresses:
            raise ValueError("redis: at least one address required")
        self.addresses = addresses
        self.ttl_s = ttl_s
        self.timeout_s = timeout_s
        self._conns: dict[str, tuple[socket.socket, object]] = {}
        self._lock = threading.Lock()

    # -- selection / connections (same scheme as memcached) -------------
    def _server_for(self, key: str) -> str:
        return _server_for(self.addresses, key)

    def _conn(self, addr: str):
        pair = self._conns.get(addr)
        if pair is not None:
            return pair
        host, port = addr.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=self.timeout_s)
        pair = (s, s.makefile("rb"))
        self._conns[addr] = pair
        return pair

    # -- RESP2 wire ------------------------------------------------------
    @staticmethod
    def _cmd(*parts: bytes) -> bytes:
        out = bytearray(b"*%d\r\n" % len(parts))
        for p in parts:
            out += b"$%d\r\n%s\r\n" % (len(p), p)
        return bytes(out)

    def _reply(self, f):
        """Parse one RESP reply -> bytes | int | None | list | error str."""
        line = f.readline()
        if not line:
            raise OSError("redis: connection closed")
        kind, rest = line[:1], line[1:].rstrip(b"\r\n")
        if kind == b"+":
            return rest
        if kind == b"-":
            raise OSError(f"redis error: {rest.decode(errors='replace')}")
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = f.read(n)
            f.read(2)  # \r\n
            return data
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._reply(f) for _ in range(n)]
        raise OSError(f"redis: bad reply type {kind!r}")

    # -- Cache interface --------------------------------------------------
    def store(self, keys, bufs) -> None:
        by_server: dict[str, list[tuple[str, bytes]]] = {}
        for k, b in zip(keys, bufs):
            by_server.setdefault(self._server_for(k), []).append((k, b))
        with self._lock:
            for addr, kvs in by_server.items():
                try:
                    s, f = self._conn(addr)
                    # pipeline all SETs, then read all replies
                    msg = bytearray()
                    for k, b in kvs:
                        if self.ttl_s:
                            msg += self._cmd(b"SET", k.encode(), b, b"EX", str(self.ttl_s).encode())
                        else:
                            msg += self._cmd(b"SET", k.encode(), b)
                    s.sendall(bytes(msg))
                    for _ in kvs:
                        self._reply(f)
                except OSError:
                    self._drop(addr)

    def fetch(self, keys):
        by_server: dict[str, list[str]] = {}
        for k in keys:
            by_server.setdefault(self._server_for(k), []).append(k)
        got: dict[str, bytes] = {}
        with self._lock:
            for addr, ks in by_server.items():
                try:
                    s, f = self._conn(addr)
                    s.sendall(self._cmd(b"MGET", *[k.encode() for k in ks]))
                    vals = self._reply(f)
                    if isinstance(vals, list):
                        for k, v in zip(ks, vals):
                            if v is not None:
                                got[k] = v
                except OSError:
                    self._drop(addr)
        return _tally(keys, got)

    def _drop(self, addr: str) -> None:
        pair = self._conns.pop(addr, None)
        if pair is not None:
            try:
                pair[0].close()
            except OSError:
                pass

    def stop(self) -> None:
        with self._lock:
            for addr in list(self._conns):
                self._drop(addr)


class BackgroundCache(Cache):
    """Write-behind decorator: stores are queued and written by a worker
    so the request path never blocks on the cache; queue overflow drops
    the write (reference: pkg/cache/background.go).
    """

    def __init__(self, inner: Cache, max_queued: int = 1024):
        self.inner = inner
        self.max_queued = max_queued
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stopped = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def store(self, keys, bufs) -> None:
        with self._cv:
            if len(self._q) >= self.max_queued:
                cache_dropped.inc(len(keys))
                return
            self._q.append((keys, bufs))
            self._cv.notify()

    def fetch(self, keys):
        return self.inner.fetch(keys)

    def _run(self):
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._q:
                    return
                keys, bufs = self._q.popleft()
            self.inner.store(keys, bufs)

    def flush(self, timeout_s: float = 5.0) -> None:
        """Test helper: wait for the queue to drain."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cv:
                if not self._q:
                    return
            time.sleep(0.002)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=2.0)
        self.inner.stop()
