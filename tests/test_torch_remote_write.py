"""The port's remote write against the JAX package's, at the byte level.

Mirrors tests/test_remote_write.py: util/snappy (compress is
byte-equal to the reference's over random, texty and tiny inputs; the
known wire vectors; corrupt inputs raise), the prompb WriteRequest
encoder, TenantRemoteWriter's WAL (send, failure kept then retried,
restart, torn tail, cap) and RemoteWriteStorage's collect-and-send
cycle. The sink is a loopback "Prometheus" that records each POST's raw
bytes and headers and decodes them with the reference's snappy and
protowire. With the clocks pinned (the registry's and the service
graphs'), a generator of each package fed the same push ships the same
WriteRequest bytes, and so do a target=all App and a metrics-generator
role App of each package with `remote_write` set.
"""

import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu.modules.generator import Generator as JGenerator
from tempo_tpu.modules.generator import registry as jregistry
from tempo_tpu.modules.generator import servicegraphs as jservicegraphs
from tempo_tpu.modules.generator import storage as jstorage
from tempo_tpu.modules.overrides import Limits as JLimits, Overrides as JOverrides
from tempo_tpu.receivers.protowire import fixed64_to_double, iter_fields
from tempo_tpu.util import snappy as jsnappy
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.modules.generator import Generator
from tempo_tpu_torch.modules.generator import registry, servicegraphs
from tempo_tpu_torch.modules.generator import storage
from tempo_tpu_torch.modules.generator.registry import Sample
from tempo_tpu_torch.modules.overrides import Limits, Overrides
from tempo_tpu_torch.util import snappy

NOW = 1_700_000_123.0


@pytest.fixture
def pinned_clock(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: NOW)
    for mod in (registry, servicegraphs, jregistry, jservicegraphs):
        monkeypatch.setattr(mod, "time", clock)


# ---------------------------------------------------------------- snappy
def _inputs():
    rng = np.random.default_rng(0)
    yield b""
    for data in (b"a", b"abcd", b"x" * 15, b"x" * 16, b"ab" * 5000):
        yield data
    yield b"span.kind=server span.kind=client status=ok " * 200
    yield rng.integers(0, 256, 10000, np.uint8).tobytes()
    # random bytes with repeats at every offset class (copy1 < 2048, copy2
    # beyond, and runs longer than 64)
    base = rng.integers(0, 256, 3000, np.uint8).tobytes()
    yield base + base[:100] + base[1000:3000] + b"z" * 300 + base
    yield rng.integers(0, 4, 70000, np.uint8).tobytes()  # past one 64-KB window


@pytest.mark.parametrize("data", list(_inputs()), ids=lambda d: f"{len(d)}B")
def test_snappy_bytes_equal(data):
    c = snappy.compress(data)
    assert c == jsnappy.compress(data)
    assert snappy.decompress(c) == jsnappy.decompress(c) == data


def test_snappy_compresses_texty_input():
    data = b"span.kind=server span.kind=client status=ok " * 200
    assert len(snappy.compress(data)) < len(data) // 4


def test_snappy_known_wire_vectors():
    # varint(5), literal tag len 5, "hello"
    assert snappy.decompress(bytes([5, (5 - 1) << 2]) + b"hello") == b"hello"
    # literal "abcd" + copy1(offset=4, len=4): "abcdabcd"
    raw = bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([((4 - 4) << 2) | 1, 4])
    assert snappy.decompress(raw) == b"abcdabcd"


@pytest.mark.parametrize("raw", [
    bytes([10, (4 - 1) << 2]) + b"abcd",  # length mismatch
    bytes([4, ((4 - 4) << 2) | 1, 9]),  # copy before the start
    bytes([200, (60 << 2)]),  # truncated
    bytes([0x80] * 6),  # varint too long
])
def test_snappy_corrupt_inputs_raise_alike(raw):
    msgs = []
    for mod in (snappy, jsnappy):
        with pytest.raises(ValueError) as e:
            mod.decompress(raw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------- the sink
def decode_write_request(payload: bytes):
    """prompb.WriteRequest -> [(labels, value, ts_ms)]."""
    series = []
    for field, wt, val in iter_fields(payload):
        assert field == 1 and wt == 2
        labels, samples = {}, []
        for f2, _, v2 in iter_fields(val):
            if f2 == 1:
                kv = {f3: v3.decode() for f3, _, v3 in iter_fields(v2)}
                labels[kv[1]] = kv[2]
            elif f2 == 2:
                value = ts = 0
                for f3, _, v3 in iter_fields(v2):
                    if f3 == 1:
                        value = fixed64_to_double(v3)
                    elif f3 == 2:
                        ts = v3
                samples.append((value, ts))
        series += [(labels, v, t) for v, t in samples]
    return series


class _Sink(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if self.server.fail_next > 0:
            self.server.fail_next -= 1
            code = 500
        else:
            headers = {k: self.headers.get(k) for k in (
                "Content-Type", "Content-Encoding", "X-Prometheus-Remote-Write-Version",
                "X-Scope-OrgID", "X-Extra")}
            self.server.received.append((self.path, headers, body))
            code = 200
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()


@pytest.fixture
def sinks():
    made = []

    def make():
        srv = ThreadingHTTPServer(("127.0.0.1", 0), _Sink)
        srv.received, srv.fail_next = [], 0
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        made.append(srv)
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    yield make
    for srv in made:
        srv.shutdown()
        srv.server_close()


def _samples():
    return [
        Sample("traces_spanmetrics_calls_total", (("service", "api"),), 42.0, 1700000000000),
        Sample("traces_spanmetrics_calls_total", (("service", "web"),), 7.0, 1700000000000),
        Sample("traces_spanmetrics_latency_sum", (("service", "api"), ("le", "+Inf")),
               0.1 + 0.2, 1700000000001),
    ]


def test_encode_write_request_equal():
    got = storage.encode_write_request(_samples(), extra_labels=(("cluster", "c1"),))
    assert got == jstorage.encode_write_request(_samples(), extra_labels=(("cluster", "c1"),))
    assert decode_write_request(got)[2] == (
        {"__name__": "traces_spanmetrics_latency_sum", "service": "api", "le": "+Inf",
         "cluster": "c1"}, 0.1 + 0.2, 1700000000001)


# ------------------------------------------------------------ the WAL
WRITERS = {"port": (storage.TenantRemoteWriter, storage.RemoteWriteConfig),
           "jax": (jstorage.TenantRemoteWriter, jstorage.RemoteWriteConfig)}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_send_roundtrip(tmp_path, sinks, pkg):
    srv, url = sinks()
    cls, cfg_cls = WRITERS[pkg]
    w = cls("acme", cfg_cls(endpoint=url, wal_dir=str(tmp_path), headers={"X-Extra": "1"}))
    w.append(_samples())
    assert w.send_now() == 1 and w.pending() == 0
    path, headers, body = srv.received[0]
    assert path == "/api/v1/write"
    assert headers == {"Content-Type": "application/x-protobuf", "Content-Encoding": "snappy",
                       "X-Prometheus-Remote-Write-Version": "0.1.0",
                       "X-Scope-OrgID": "acme", "X-Extra": "1"}
    assert body == jsnappy.compress(jstorage.encode_write_request(_samples()))


def _wal_story(pkg, root, url, srv):
    """One writer's life: failures kept, retried, a restart, a torn
    tail, a cap. Returns what each step observed."""
    cls, cfg_cls = WRITERS[pkg]
    out = []
    cfg = cfg_cls(endpoint=url, wal_dir=str(root), max_retries=0)
    w = cls("acme", cfg)
    w.append(_samples())
    srv.fail_next = 10
    out.append((w.send_now(), w.pending()))
    w.append(_samples()[:1])
    w2 = cls("acme", cfg)  # "crash": a new writer over the same WAL
    out.append(w2.pending())
    with open(w2.wal_path, "ab") as f:
        f.write(b"\xff\xff\x00\x00garbage-without-full-length")
    out.append(w2.pending())  # the intact records kept, the torn tail dropped
    srv.fail_next = 0
    out.append((w2.send_now(), w2.pending()))
    capped = cls("cap", cfg_cls(wal_dir=str(root), max_wal_bytes=400))
    for _ in range(20):
        capped.append(_samples())
    out.append(capped.pending())
    with open(capped.wal_path, "rb") as f:
        out.append(f.read())
    return out


def test_wal_behaves_alike(tmp_path, sinks):
    got = {}
    for pkg in ("port", "jax"):
        srv, url = sinks()
        got[pkg] = (_wal_story(pkg, tmp_path / pkg, url, srv),
                    [r[2] for r in srv.received])
    assert got["port"] == got["jax"]
    story, bodies = got["port"]
    assert story[:4] == [(0, 1), 2, 2, (2, 0)]
    assert len(bodies) == 2
    assert story[4] * (4 + len(storage.encode_write_request(_samples()))) <= 400


# ------------------------------------------------- the generator's ship
def _batch():
    """Traces with client/server hops, so the service graphs pair edges."""
    return synth.make_graph_batch(64, 6, seed=5, base_time_ns=int(NOW - 60) * 10**9)


def test_generator_ships_the_same_write_request(tmp_path, sinks, pinned_clock):
    """The same push into a generator of each package, one collect-and-
    send cycle each: the sinks receive the same bytes, whose series are
    the generator's own."""
    received = {}
    for pkg, gen, mod in (("port", Generator(Overrides(Limits()), device="cpu"), storage),
                          ("jax", JGenerator(JOverrides(JLimits())), jstorage)):
        srv, url = sinks()
        gen.push_batch("acme", _batch())
        rw = mod.RemoteWriteStorage(mod.RemoteWriteConfig(endpoint=url,
                                                          wal_dir=str(tmp_path / pkg)))
        assert rw.collect_and_send(gen) >= 1
        received[pkg] = srv.received
        if pkg == "port":
            want = decode_write_request(storage.encode_write_request(gen.collect("acme")))
    assert received["port"] == received["jax"]
    (_, headers, body), = received["port"]
    assert headers["X-Scope-OrgID"] == "acme"
    series = decode_write_request(jsnappy.decompress(body))
    assert series == want
    names = {labels["__name__"] for labels, _, _ in series}
    assert "traces_spanmetrics_calls_total" in names
    assert any(n.startswith("traces_service_graph") for n in names)


@pytest.mark.parametrize("target", ["all", "metrics-generator"])
def test_app_remote_write_equal(tmp_path, sinks, pinned_clock, target):
    """A target=all App and a metrics-generator role App of each package
    with metrics_generator.remote_write set: the same push ships the
    same bytes (one cycle driven by hand; the loop's interval is long)."""
    received = {}
    for pkg in ("port", "jax"):
        srv, url = sinks()
        root = tmp_path / pkg
        root.mkdir()
        kw = dict(target=target, ring_kv_path=str(root / "ring.json"),
                  instance_id="generator-0")
        if pkg == "port":
            app = App(AppConfig(db=DBConfig(backend="local", backend_path=str(root / "b"),
                                            wal_path=str(root / "w"), analytics_scan_s=0),
                                remote_write=storage.RemoteWriteConfig(
                                    endpoint=url, wal_dir=str(root / "rw"),
                                    send_interval_s=3600), **kw), device="cpu")
        else:
            app = JApp(JAppConfig(db=JDBConfig(backend="local", backend_path=str(root / "b"),
                                               wal_path=str(root / "w"), analytics_scan_s=0),
                                  remote_write=jstorage.RemoteWriteConfig(
                                      endpoint=url, wal_dir=str(root / "rw"),
                                      send_interval_s=3600), **kw))
        try:
            assert app.remote_write_storage is not None
            app.generator.push_batch("single-tenant", _batch())
            assert app.remote_write_storage.collect_and_send(app.generator) >= 1
        finally:
            app.shutdown()
        received[pkg] = srv.received
    assert received["port"] == received["jax"] and received["port"]
