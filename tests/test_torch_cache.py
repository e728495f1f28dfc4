"""The port's cache clients and caching backend against the JAX package's.

Both packages' memcached and redis clients talk to the same loopback
fake servers (minimal text-protocol memcached and RESP2 redis, recording
every byte they receive): the bytes each client sends must be equal, and
so must what it reads back. The CachedBackend decorator must serve the
same object names from the cache, the second read skipping the inner
backend; TempoDB wires the clients as the reference does (`cache`:
none | memory | memcached | redis, write-behind optional, only an owned
backend wrapped, the client drained and closed at shutdown).
"""

import socket
import threading

import pytest

from tempo_tpu.backend import cache as jbcache
from tempo_tpu.backend.mock import MockBackend as JMockBackend
from tempo_tpu import cache as jcache
from tempo_tpu.cache import client as jclient
from tempo_tpu_torch.backend import cache as tbcache
from tempo_tpu_torch.backend.mock import MockBackend as TMockBackend
from tempo_tpu_torch import cache as tcache
from tempo_tpu_torch.cache import client as tclient
from tempo_tpu_torch.db import DBConfig, TempoDB


class _FakeMemcached:
    """Minimal memcached text-protocol server; `received` holds every
    byte its clients sent, in order."""

    def __init__(self):
        self.data = {}
        self.received = bytearray()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn):
        f = conn.makefile("rb")
        while True:
            line = f.readline()
            if not line:
                return
            self.received += line
            parts = line.strip().split()
            if parts[0] == b"set":
                n = int(parts[4])
                val = f.read(n)
                self.received += val + f.read(2)
                self.data[parts[1].decode()] = val
                conn.sendall(b"STORED\r\n")
            elif parts[0] == b"get":
                out = b""
                for k in parts[1:]:
                    v = self.data.get(k.decode())
                    if v is not None:
                        out += b"VALUE %s 0 %d\r\n%s\r\n" % (k, len(v), v)
                conn.sendall(out + b"END\r\n")

    def close(self):
        self.sock.close()


class _FakeRedis:
    """Minimal RESP2 server: SET key val [EX ttl], MGET, pipelining;
    `received` holds every byte its clients sent, in order."""

    def __init__(self):
        self.data = {}
        self.received = bytearray()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _read_cmd(self, f):
        line = f.readline()
        if not line:
            return None
        self.received += line
        assert line[:1] == b"*", line
        n = int(line[1:].strip())
        parts = []
        for _ in range(n):
            hdr = f.readline()
            assert hdr[:1] == b"$", hdr
            size = int(hdr[1:].strip())
            parts.append(f.read(size))
            self.received += hdr + parts[-1] + f.read(2)
        return parts

    def _handle(self, conn):
        f = conn.makefile("rb")
        while True:
            cmd = self._read_cmd(f)
            if cmd is None:
                return
            op = cmd[0].upper()
            if op == b"SET":
                self.data[cmd[1]] = cmd[2]
                conn.sendall(b"+OK\r\n")
            elif op == b"MGET":
                out = bytearray(b"*%d\r\n" % (len(cmd) - 1))
                for k in cmd[1:]:
                    v = self.data.get(k)
                    if v is None:
                        out += b"$-1\r\n"
                    else:
                        out += b"$%d\r\n%s\r\n" % (len(v), v)
                conn.sendall(bytes(out))
            else:
                conn.sendall(b"-ERR unknown command\r\n")

    def close(self):
        self.sock.close()


class _Counting:
    """Inner-backend reads that reached the store, for either package."""

    def __init__(self, base):
        self.inner = base()
        self.n_reads = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def read(self, name, keypath):
        self.n_reads += 1
        return self.inner.read(name, keypath)

    def read_range(self, name, keypath, offset, length):
        self.n_reads += 1
        return self.inner.read_range(name, keypath, offset, length)


KEYS = [f"rc1|qs1|single-tenant|{i:032x}|metrics|all|{i * 7919:032x}" for i in range(24)]
VALS = [bytes([i]) * (i * 37 % 200 + 1) + b"\r\nEND\r\n\x00" for i in range(24)]


def _client(kind, mod, servers, **kw):
    cls = mod.MemcachedCache if kind == "memcached" else mod.RedisCache
    return cls([s.addr for s in servers], **kw)


def _fake(kind):
    return _FakeMemcached() if kind == "memcached" else _FakeRedis()


@pytest.mark.parametrize("kind", ["memcached", "redis"])
@pytest.mark.parametrize("ttl_s", [0, 30])
def test_clients_send_the_same_bytes(kind, ttl_s):
    """The same stores and fetches from either package's client put the
    same bytes on each server's wire and read the same values back."""
    wires, reads = [], []
    for mod in (jclient, tclient):
        servers = [_fake(kind) for _ in range(3)]
        c = _client(kind, mod, servers, ttl_s=ttl_s)
        c.store(KEYS[:16], VALS[:16])
        c.store(KEYS[16:], VALS[16:])
        reads.append((c.fetch(KEYS + ["absent-key"]), c.fetch(KEYS[5:9])))
        c.stop()
        wires.append([bytes(s.received) for s in servers])
        assert all(s.data for s in servers)  # every server got a share
        for s in servers:
            s.close()
    assert wires[1] == wires[0]
    assert reads[1] == reads[0]
    found, bufs, missed = reads[1][0]
    assert found == KEYS and bufs == VALS and missed == ["absent-key"]


@pytest.mark.parametrize("kind", ["memcached", "redis"])
def test_one_package_reads_what_the_other_stored(kind):
    srv = _fake(kind)
    jc, tc = _client(kind, jclient, [srv]), _client(kind, tclient, [srv])
    jc.store(KEYS[:8], VALS[:8])
    tc.store(KEYS[8:], VALS[8:])
    assert tc.fetch(KEYS) == jc.fetch(KEYS) == (KEYS, VALS, [])
    jc.stop()
    tc.stop()
    srv.close()


def test_server_selection_equal():
    addrs = [f"10.0.0.{i}:11211" for i in range(5)]
    for k in KEYS + ["", "a", "ü-key"]:
        assert tclient._server_for(addrs, k) == jclient._server_for(addrs, k)


@pytest.mark.parametrize("kind", ["memcached", "redis"])
def test_down_server_degrades_to_miss(kind):
    c = _client(kind, tclient, [type("S", (), {"addr": "127.0.0.1:1"})], timeout_s=0.1)
    c.store(["k"], [b"v"])  # swallowed
    assert c.fetch(["k"]) == ([], [], ["k"])
    c.stop()


def test_lru_and_background_equal():
    """The same store/fetch sequence through each package's LRU (a
    byte bound that evicts) and write-behind decorator."""
    outs = []
    for mod in (jcache, tcache):
        lru = mod.LRUCache(max_bytes=600)
        bg = mod.BackgroundCache(mod.MockCache())
        seq = []
        for i, (k, v) in enumerate(zip(KEYS, VALS)):
            lru.store([k], [v])
            bg.store([k], [v])
            if i % 3 == 0:
                seq.append(lru.fetch(KEYS[: i + 1]))
        bg.flush()
        seq.append(bg.fetch(KEYS))
        bg.stop()
        outs.append(seq)
    assert outs[1] == outs[0]
    assert outs[1][-1] == (KEYS, VALS, [])


NAMES = ["bloom-0", "bloom-3", "index", "index.json", "dict", "dictionary", "data.bin",
         "meta.json", "meta.compacted.json", "zones"]


@pytest.mark.parametrize("ctl", [{}, {"cache_bloom": False}, {"cache_index": False},
                                 {"cache_data_ranges": True}, {"max_cacheable_bytes": 8}])
def test_cached_backend_serves_the_same_names(ctl):
    """CachedBackend caches the same names (`_cacheable`), serves the
    second read from the cache (the inner backend is not read again) and
    writes through, in both packages."""
    outs = []
    for bmod, mock, cmod in ((jbcache, JMockBackend, jcache), (tbcache, TMockBackend, tcache)):
        inner = _Counting(mock)
        be = bmod.CachedBackend(inner, cmod.MockCache(), bmod.CacheControl(**ctl))
        kp = ("t", "blk")
        log = []
        for i, name in enumerate(NAMES):
            inner.inner.write(name, kp, bytes(range(i, i + 12)))
        for name in NAMES:
            log.append((bmod._cacheable(name, be.ctl),
                        be.read(name, kp), be.read(name, kp), inner.n_reads,
                        be.read_range(name, kp, 2, 5), be.read_range(name, kp, 2, 5),
                        inner.n_reads))
        be.write("bloom-9", kp, b"WARM")
        log.append((be.read("bloom-9", kp), inner.n_reads))
        outs.append(log)
    assert outs[1] == outs[0]


def test_second_bloom_read_skips_the_inner_backend():
    inner = _Counting(TMockBackend)
    inner.inner.write("bloom-0", ("t", "b"), b"BLOOMDATA")
    be = tbcache.CachedBackend(inner, tcache.MockCache())
    assert be.read("bloom-0", ("t", "b")) == b"BLOOMDATA"
    assert be.read("bloom-0", ("t", "b")) == b"BLOOMDATA"
    assert inner.n_reads == 1


@pytest.mark.parametrize("kind,background", [("memory", False), ("memory", True),
                                             ("memcached", False), ("redis", True)])
def test_tempodb_wires_the_cache(kind, background, tmp_path):
    servers = []
    opts = {}
    if kind in ("memcached", "redis"):
        servers = [_fake(kind)]
        opts = {"addresses": [servers[0].addr]}
    db = TempoDB(DBConfig(backend="local", backend_path=str(tmp_path / "blocks"),
                          cache=kind, cache_options=opts, cache_background_writes=background),
                 device="cpu")
    client = db._cache_client
    assert isinstance(db.backend.raw, tbcache.CachedBackend) and db.backend.raw.cache is client
    assert isinstance(client, tcache.BackgroundCache) == background
    assert db.result_cache._remote is client
    db.backend.raw.write("bloom-0", ("t", "b"), b"words")
    if background:
        client.flush()
    assert db.backend.raw.cache.fetch(["t:b:bloom-0"])[1] == [b"words"]
    if servers:
        assert b"t:b:bloom-0" in bytes(servers[0].received)
    db.shutdown()
    assert db._cache_client is None
    if background:
        assert not client._worker.is_alive()
    for s in servers:
        s.close()


def test_injected_backend_is_not_wrapped(tmp_path):
    """Only a backend the DB owns is wrapped; the result cache then has
    its local tier alone."""
    raw = TMockBackend()
    db = TempoDB(DBConfig(backend="mock", cache="memory"), raw_backend=raw, device="cpu")
    assert db.backend.raw is raw and db._cache_client is None
    assert db.result_cache._remote is None
    db.shutdown()


def test_unknown_cache_rejected():
    with pytest.raises(ValueError, match="unknown cache"):
        TempoDB(DBConfig(backend="mock", cache="nope"), device="cpu")
