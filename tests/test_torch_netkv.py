"""The port's ring KVs against the JAX package's.

Mirrors tests/test_netkv.py (KVService CAS revisions and watch, LocalKV,
HttpKV over a served /kv/v1 route: round trip, contention, the watch
cache, monotonic revisions, the 405, rings over the KV) and the FileKV
cases of tests/test_modules.py (two rings over one file; six spawned
processes registering at once). Each HTTP case runs with the client of
one package against the server of either, since the wire is one
protocol; the served documents are compared between the packages.
"""

import multiprocessing as mp
import threading
import time
import urllib.error
import urllib.request

import pytest

from tempo_tpu.api.server import TempoServer as JTempoServer
from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu.modules import netkv as jnetkv
from tempo_tpu.modules.ring import FileKV as JFileKV, Ring as JRing
from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.modules import netkv
from tempo_tpu_torch.modules.ring import FileKV, Ring

PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]  # (client, server)
KV = {"port": netkv, "jax": jnetkv}
RING = {"port": Ring, "jax": JRing}


# ------------------------------------------------------------ KVService
@pytest.mark.parametrize("mod", [netkv, jnetkv], ids=["port", "jax"])
def test_cas_revisions(mod):
    svc = mod.KVService()
    assert svc.read("r") == (0, {})
    assert svc.cas("r", 0, {"a": 1}) == (True, 1)
    assert svc.cas("r", 0, {"a": 2}) == (False, 1)  # stale revision
    assert svc.read("r") == (1, {"a": 1})
    svc.cas("x", 0, {"x": 1})
    assert svc.read("y") == (0, {})
    assert svc.names() == ["r", "x"]
    assert svc.summary() == {"r": {"revision": 1, "keys": ["a"]},
                             "x": {"revision": 1, "keys": ["x"]}}


def test_service_sequences_equal():
    """The same CAS sequence, stale writes included, leaves both
    services with the same revisions and data."""
    svcs = [netkv.KVService(), jnetkv.KVService()]
    out = []
    for svc in svcs:
        got = []
        for name, rev, data in (("a", 0, {"k": 1}), ("a", 0, {"k": 2}), ("a", 1, {"k": 3}),
                                ("b", 0, {}), ("a", 5, {"k": 4}), ("b", 1, {"z": [1, 2]})):
            got.append(svc.cas(name, rev, data))
        got.append((svc.read("a"), svc.read("b"), svc.summary()))
        out.append(got)
    assert out[0] == out[1]


@pytest.mark.parametrize("mod", [netkv, jnetkv], ids=["port", "jax"])
def test_watch_wakes_on_write(mod):
    svc = mod.KVService()
    svc.cas("r", 0, {"v": 0})
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "result", svc.read("r", wait_revision=1, timeout_s=5)))
    t.start()
    time.sleep(0.1)
    svc.cas("r", 1, {"v": 1})
    t.join(timeout=5)
    assert got["result"] == (2, {"v": 1})


def test_watch_timeout_returns_current():
    svc = netkv.KVService()
    t0 = time.monotonic()
    assert svc.read("r", wait_revision=0, timeout_s=0.2) == (0, {})
    assert time.monotonic() - t0 < 2


def test_local_kv_update_loop():
    svc = netkv.KVService()
    kv = netkv.LocalKV(svc, "ring")
    kv.update(lambda d: {**d, "a": 1})
    kv.update(lambda d: {**d, "b": 2})
    assert kv.get() == {"a": 1, "b": 2}


# --------------------------------------------------------------- HttpKV
@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A target=all App of each package behind its server (every role
    serves /kv/v1)."""
    root = tmp_path_factory.mktemp("kv")
    out = {}
    japp = JApp(JAppConfig(db=JDBConfig(backend="local", backend_path=str(root / "jb"),
                                        wal_path=str(root / "jw"), analytics_scan_s=0)))
    tapp = App(AppConfig(db=DBConfig(backend="local", backend_path=str(root / "tb"),
                                     wal_path=str(root / "tw"), analytics_scan_s=0)),
               device="cpu")
    out["jax"] = (japp, JTempoServer(japp).start())
    out["port"] = (tapp, TempoServer(tapp).start())
    yield out
    for app, srv in out.values():
        srv.stop()
        app.shutdown()


@pytest.mark.parametrize("client,server", PAIRS)
def test_get_update_roundtrip(servers, client, server):
    url = servers[server][1].url
    name = f"rt-{client}"
    kv = KV[client].HttpKV(url, name, watch=False)
    assert kv.get() == {}
    kv.update(lambda d: {**d, "i-0": {"tokens": [1, 2]}})
    kv2 = KV[client].HttpKV(url, name, watch=False)
    assert kv2.get() == {"i-0": {"tokens": [1, 2]}}
    kv.close(), kv2.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_contending_clients_both_land(servers, client, server):
    url = servers[server][1].url
    name = f"c-{client}"
    kvs = [KV[client].HttpKV(url, name, watch=False) for _ in range(4)]
    threads = [threading.Thread(target=lambda i=i: kvs[i].update(lambda d: {**d, f"k{i}": i}))
               for i in range(4)]
    [t.start() for t in threads]
    [t.join(timeout=20) for t in threads]
    assert set(kvs[0].update(lambda d: d)) == {"k0", "k1", "k2", "k3"}
    [kv.close() for kv in kvs]


@pytest.mark.parametrize("client,server", PAIRS)
def test_watch_refreshes_cache(servers, client, server):
    url = servers[server][1].url
    name = f"w-{client}"
    writer = KV[client].HttpKV(url, name, watch=False)
    writer.update(lambda d: {"v": 1})
    reader = KV[client].HttpKV(url, name)
    assert reader.get()["v"] == 1  # starts the watcher
    writer.update(lambda d: {"v": 2})
    deadline = time.time() + 10
    while time.time() < deadline and reader.get().get("v") != 2:
        time.sleep(0.05)
    assert reader.get()["v"] == 2, "watch did not refresh the cache"
    writer.close(), reader.close()


def test_update_never_clobbers_newer_cached_revision(servers):
    kv = netkv.HttpKV(servers["port"][1].url, "mono", watch=True)
    kv.update(lambda d: {"v": 1})
    with kv._lock:
        kv._cache = (999, {"v": "newer"})
    kv.update(lambda d: {"v": 2})  # the CAS lands at revision 2 < 999
    with kv._lock:
        assert kv._cache == (999, {"v": "newer"})
    kv.close()


def _status(url, method):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("method,path", [("DELETE", "/kv/v1/ring"), ("PUT", "/kv/v1/ring"),
                                         ("GET", "/kv/v1/"), ("GET", "/kv/v1/a/b"),
                                         ("GET", "/kv/v1/never-written")])
def test_kv_route_statuses_equal(servers, method, path):
    """405 for other methods, 404 for a bad name, the empty store at
    revision 0: the same on both servers."""
    got = [_status(servers[p][1].url + path, method) for p in ("jax", "port")]
    assert got[0][0] == got[1][0]
    if method == "GET" and got[1][0] == 200:
        assert got[0][1] == got[1][1] == b'{"revision": 0, "data": {}}'


def test_memberlist_equal(servers):
    """The /memberlist page names the same stores and revisions after the
    same writes on both servers."""
    for p in ("jax", "port"):
        kv = netkv.HttpKV(servers[p][1].url, "ml", watch=False)
        kv.update(lambda d: {"a": 1})
        kv.update(lambda d: {**d, "b": 2})
        kv.close()
    docs = [_status(servers[p][1].url + "/memberlist", "GET") for p in ("jax", "port")]
    assert docs[0][0] == docs[1][0] == 200
    import json

    j, t = (json.loads(d[1])["stores"] for d in docs)
    assert j["ml"] == t["ml"] == {"revision": 2, "keys": ["a", "b"]}


@pytest.mark.parametrize("client,server", PAIRS)
def test_rings_over_http_kv(servers, client, server):
    """Two rings (processes) sharing the served KV see each other and
    pick the same replicas."""
    url = servers[server][1].url
    name = f"ring-{client}"
    ring_a = RING[client](KV[client].HttpKV(url, name, watch=False), replication_factor=2)
    ring_b = RING[client](KV[client].HttpKV(url, name, watch=False), replication_factor=2)
    ring_a.register("node-a", addr="http://a")
    ring_b.register("node-b", addr="http://b")
    assert {i.instance_id for i in ring_a.healthy_instances()} == {"node-a", "node-b"}
    assert len(ring_b.get_replicas(12345)) == 2
    other = RING["jax" if client == "port" else "port"](
        KV[client].HttpKV(url, name, watch=False), replication_factor=2)
    assert [i.instance_id for i in other.get_replicas(12345)] == \
        [i.instance_id for i in ring_b.get_replicas(12345)]


# --------------------------------------------------------------- FileKV
@pytest.mark.parametrize("writer,reader", [(FileKV, FileKV), (FileKV, JFileKV),
                                           (JFileKV, FileKV)], ids=["port", "port-jax", "jax-port"])
def test_file_kv_shared(tmp_path, writer, reader):
    path = str(tmp_path / "ring.json")
    r1 = Ring(writer(path))
    r2 = Ring(reader(path))
    r1.register("a")
    assert [i.instance_id for i in r2.instances()] == ["a"]
    assert reader(path).get() == writer(path).get()


def test_file_kv_missing_and_torn(tmp_path):
    """A missing or half-written file reads as the empty ring, as in
    the reference."""
    path = tmp_path / "ring.json"
    assert FileKV(str(path)).get() == JFileKV(str(path)).get() == {}
    path.write_text('{"a": ')
    assert FileKV(str(path)).get() == JFileKV(str(path)).get() == {}


def _register_in_ring(path, i):  # top-level: a spawn target must be picklable
    Ring(FileKV(path)).register(f"ing-{i}")


def test_filekv_concurrent_updates_do_not_lose_registrations(tmp_path):
    path = str(tmp_path / "ring.json")
    ctx = mp.get_context("spawn")  # fork from threaded pytest can deadlock
    procs = [ctx.Process(target=_register_in_ring, args=(path, i)) for i in range(6)]
    [p.start() for p in procs]
    [p.join(timeout=120) for p in procs]
    assert all(p.exitcode == 0 for p in procs)
    assert sorted(FileKV(path).get()) == [f"ing-{i}" for i in range(6)]
    assert JFileKV(path).get() == FileKV(path).get()
