"""The port's S3, GCS and Azure backends against the JAX package's.

Both packages' backends talk to the same in-process mocks of the three
wire dialects (chip_smoke.ObjectStoreMock: SigV4 checked, XML and JSON
listings, Put Block / Put Block List; and the JAX tests' own mocks).
With the signers' clocks pinned, every request the port sends (method,
path, headers, body) must equal the reference's byte for byte, and the
objects a TempoDB stores through them must be the same bytes. Errors
surface as the reference's (HTTPError with its status, NotFound), and
make_raw_backend builds each backend from its options, behind
FaultInjectingBackend when TEMPO_TPU_FAULTS is armed."""

import datetime
import json
import types

import numpy as np
import pytest

import chip_smoke
import test_cloud_backends as jmocks
from tempo_tpu.backend import azure as jazure, s3 as js3
from tempo_tpu.backend import make_raw_backend as jmake_raw_backend
from tempo_tpu.backend.base import NotFound as JNotFound
from tempo_tpu.backend.httpclient import HTTPError as JHTTPError
from tempo_tpu.db import DBConfig as JDBConfig, TempoDB as JTempoDB
from tempo_tpu.model.columnar import Dictionary as JDictionary, SpanBatch as JSpanBatch
from tempo_tpu_torch.backend import FaultInjectingBackend, make_raw_backend
from tempo_tpu_torch.backend import azure, gcs, s3
from tempo_tpu_torch.backend.base import NotFound
from tempo_tpu_torch.backend.httpclient import HTTPError
from tempo_tpu_torch.config import check_config, parse_config
from tempo_tpu_torch.db import DBConfig, TempoDB
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.columnar import SpanBatch

DIALECTS = ("s3", "gcs", "azure")
NOW = datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return NOW


@pytest.fixture
def pinned_clock(monkeypatch):
    """The SigV4 and SharedKey signers date each request: pin both
    packages' clocks to one instant."""
    clock = types.SimpleNamespace(datetime=_FixedClock, timezone=datetime.timezone)
    for mod in (s3, azure, js3, jazure):
        monkeypatch.setattr(mod, "datetime", clock)


@pytest.fixture(params=DIALECTS)
def mock(request):
    m = chip_smoke.ObjectStoreMock(request.param)
    yield m
    m.stop()


def backends(mock):
    """(port, reference) raw backends for one mock, built as each
    package's factory builds them."""
    opts = chip_smoke.store_options(mock)
    return make_raw_backend(mock.dialect, dict(opts)), jmake_raw_backend(mock.dialect, dict(opts))


def roundtrip(raw, not_found) -> list:
    """Every verb of the raw contract; returns what was read."""
    out = []
    raw.write("meta.json", ("t1", "blk-a"), b'{"v":1}')
    raw.write("meta.json", ("t1", "blk-b"), b'{"v":2}')
    raw.write("meta.json", ("t2", "blk-c"), b'{"v":3}')
    out.append(raw.read("meta.json", ("t1", "blk-a")))
    out.append(raw.read_range("meta.json", ("t1", "blk-a"), 1, 3))
    out.append(raw.list(()))
    out.append(raw.list(("t1",)))
    out.append(raw.list_objects(("t1", "blk-a")))
    raw.append("data.bin", ("t1", "blk-d"), b"part1-")
    raw.append("data.bin", ("t1", "blk-d"), b"part2")
    raw.write("meta.json", ("t1", "blk-d"), b"{}")
    out.append(raw.read("data.bin", ("t1", "blk-d")))
    raw.delete("meta.json", ("t1", "blk-b"))
    with pytest.raises(not_found):
        raw.read("meta.json", ("t1", "blk-b"))
    with pytest.raises(not_found):
        raw.delete("meta.json", ("t1", "blk-b"))
    return out


def test_requests_byte_equal(mock, pinned_clock):
    """The same calls send the same requests: method, path, every header
    (the signatures included) and body."""
    port, ref = backends(mock)
    got_port = roundtrip(port, NotFound)
    sent_port, objects_port = list(mock.requests), dict(mock.objects)
    mock.reset()
    got_ref = roundtrip(ref, JNotFound)
    assert got_port == got_ref
    assert got_port[0] == b'{"v":1}' and got_port[1] == b'"v"'
    assert got_port[2] == ["t1", "t2"] and got_port[3] == ["blk-a", "blk-b"]
    assert got_port[5] == b"part1-part2"
    assert objects_port == mock.objects
    assert len(sent_port) == len(mock.requests) > 10
    for a, b in zip(sent_port, mock.requests):
        assert a == b


@pytest.mark.parametrize("dialect", DIALECTS)
def test_raw_roundtrip_against_reference_mocks(dialect):
    """The reference tests' own mocks (tests/test_cloud_backends.py) take
    the port's backends through every verb."""
    handler = {"s3": jmocks._S3Handler, "gcs": jmocks._GCSHandler,
               "azure": jmocks._AzureHandler}[dialect]
    store = jmocks._Store()
    srv, url = jmocks._serve(handler, store)
    try:
        if dialect == "s3":
            be = s3.S3Backend(s3.S3Config(bucket="tempo", endpoint=url,
                                          access_key="test-access", secret_key="test-secret"))
        elif dialect == "gcs":
            be = gcs.GCSBackend(gcs.GCSConfig(bucket_name="tempo", endpoint=url, token="tok"))
        else:
            be = azure.AzureBackend(azure.AzureConfig(
                storage_account_name="devstoreaccount1", storage_account_key="a2V5",
                container_name="tempo", endpoint=url + "/devstoreaccount1"))
        got = roundtrip(be, NotFound)
        assert got[5] == b"part1-part2"
        assert "t1/blk-d/data.bin" in store.objects and "t1/blk-b/meta.json" not in store.objects
    finally:
        srv.shutdown()


def test_azure_append_streams_blocks():
    mock = chip_smoke.ObjectStoreMock("azure")
    try:
        be, _ = backends(mock)
        be.append("data.bin", ("t", "b"), b"x" * 10)
        with pytest.raises(NotFound):
            be.read("data.bin", ("t", "b"))
        assert mock.staged  # Put Block reached the server, uncommitted
        be.write("meta.json", ("t", "b"), b"{}")
        assert be.read("data.bin", ("t", "b")) == b"x" * 10
        puts = [r[1].partition("?")[2] for r in mock.requests if r[0] == "PUT"]
        assert puts[0] == "comp=block&blockid=YmxrLTAwMDAwMDAw" and "comp=blocklist" in puts
    finally:
        mock.stop()


@pytest.mark.parametrize("what", ["bad credentials", "server error", "absent key"])
def test_failures_surface_as_the_reference(what):
    """A refused request raises HTTPError with the store's status (after
    the retries where the status is retriable), an absent key NotFound,
    in both packages alike."""
    mock = chip_smoke.ObjectStoreMock("s3")
    try:
        opts = chip_smoke.store_options(mock)
        if what == "bad credentials":
            opts["secret_key"] = "wrong"
        errors = []
        for mod, factory, nf, he in ((s3, make_raw_backend, NotFound, HTTPError),
                                     (js3, jmake_raw_backend, JNotFound, JHTTPError)):
            be = factory("s3", dict(opts, max_retries=1))
            if what == "server error":
                mock.dialect = "broken"
                mock._broken = lambda *a: (503, b"slow down", "text/plain")
            try:
                if what == "absent key":
                    be.read("meta.json", ("t", "nope"))
                else:
                    be.write("meta.json", ("t", "b"), b"{}")
            except nf:
                errors.append(("NotFound", None))
            except he as e:
                errors.append(("HTTPError", e.status))
            mock.dialect = "s3"
        assert errors[0] == errors[1]
        assert errors[0] == {"bad credentials": ("HTTPError", 403),
                             "server error": ("HTTPError", 503),
                             "absent key": ("NotFound", None)}[what]
    finally:
        mock.stop()


def _batches(seed: int, n: int):
    """Two trace-sorted batches of make_batch traces; the second repeats
    every 4th trace of the first."""
    a = synth.make_batch(n, 4, seed=seed).sorted_by_trace()
    firsts, seg = a.trace_boundaries()
    dup = np.isin(seg, np.arange(0, len(firsts), 4))
    b = SpanBatch.concat([synth.make_batch(n, 4, seed=seed + 1),
                                a.select(np.flatnonzero(dup))]).sorted_by_trace()
    return a, b


def _to_jax(batch) -> JSpanBatch:
    return JSpanBatch(cols={k: v.copy() for k, v in batch.cols.items()},
                      attrs={k: v.copy() for k, v in batch.attrs.items()},
                      dictionary=JDictionary(list(batch.dictionary.entries)))


def _normalized(objects: dict) -> dict:
    """key -> comparable bytes: gzip clocks and block ids out."""
    import gzip

    out = {}
    for key, raw in objects.items():
        name = key.rsplit("/", 1)[-1]
        if name in ("index.json", "dict.bin") and raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        out[key] = raw
    return out


@pytest.mark.parametrize("dialect", DIALECTS)
def test_engine_cycle_objects_equal(dialect, tmp_path, pinned_clock):
    """TempoDB over each store: write two blocks, find, search, compact.
    The stored objects (the compacted block by its content) and every
    answer equal the reference's over a second mock of the same
    dialect."""
    from tempo_tpu.encoding.common import SearchRequest as JReq
    from tempo_tpu_torch.encoding.common import SearchRequest

    a, b = _batches(11, 64)
    mp, mj = chip_smoke.ObjectStoreMock(dialect), chip_smoke.ObjectStoreMock(dialect)
    try:
        db = TempoDB(DBConfig(backend=dialect, backend_options=chip_smoke.store_options(mp),
                              wal_path=str(tmp_path / "wal")), device="cpu")
        jdb = JTempoDB(JDBConfig(backend=dialect, backend_options=chip_smoke.store_options(mj),
                                 wal_path=str(tmp_path / "jwal"), compaction_device_shards=1))
        for i, batch in enumerate((a, b)):
            db.write_batch("t", batch, block_id=f"00000000-0000-0000-0000-00000000000{i}")
            jdb.write_batch("t", _to_jax(batch), block_id=f"00000000-0000-0000-0000-00000000000{i}")
        assert _normalized(mp.objects) == _normalized(mj.objects)
        tids = a.cols["trace_id"][a.trace_boundaries()[0]]
        for tid in list(tids[:6]) + [np.array([1, 2, 3, 4], np.uint32)]:
            raw_id = tid.astype(">u4").tobytes()
            t, jt = db.find("t", raw_id), jdb.find("t", raw_id)
            assert (t is None) == (jt is None)
            if t is not None:
                assert t.span_count() == jt.span_count()
        svc = a.dictionary.entries[int(a.cols["service"][0])]
        r = db.search("t", SearchRequest(tags={"service": svc}, limit=20))
        jr = jdb.search("t", JReq(tags={"service": svc}, limit=20))
        assert [x.trace_id_hex for x in r.traces] == [x.trace_id_hex for x in jr.traces]
        db.poll_now()
        jdb.poll_now()
        assert db.compact_once("t") and jdb.compact_once("t")
        db.poll_now()
        jdb.poll_now()
        (m,), (jm,) = db.blocklist.metas("t"), jdb.blocklist.metas("t")
        assert m.total_spans == jm.total_spans and m.total_objects == jm.total_objects

        def compacted(objects, block_id):
            return {k.rsplit("/", 1)[-1]: v for k, v in _normalized(objects).items()
                    if f"/{block_id}/" in k and not k.endswith("meta.json")}

        assert compacted(mp.objects, m.block_id) == compacted(mj.objects, jm.block_id)
    finally:
        mp.stop()
        mj.stop()


@pytest.mark.parametrize("dialect", DIALECTS)
def test_make_raw_backend_builds_each_store(dialect, monkeypatch):
    """backend_options reach the backend's config; TEMPO_TPU_FAULTS wraps
    it in FaultInjectingBackend as it wraps local."""
    mock = chip_smoke.ObjectStoreMock(dialect)
    try:
        be = make_raw_backend(dialect, chip_smoke.store_options(mock))
        assert type(be).__name__ == type(jmake_raw_backend(
            dialect, chip_smoke.store_options(mock))).__name__
        be.write("meta.json", ("t", "b"), b"{}")
        assert be.list(("t",)) == ["b"]
        monkeypatch.setenv("TEMPO_TPU_FAULTS", "read=1.0,seed=7")
        wrapped = make_raw_backend(dialect, chip_smoke.store_options(mock))
        assert isinstance(wrapped, FaultInjectingBackend)
        assert type(wrapped.inner).__name__ == type(be).__name__
    finally:
        mock.stop()


def test_cloud_without_cache_warns_as_the_reference():
    from tempo_tpu.config import check_config as jcheck, parse_config as jparse

    text = ("storage:\n  trace:\n    backend: s3\n    backend_options:\n"
            "      bucket: tempo\n      endpoint: http://127.0.0.1:9\n")
    assert check_config(parse_config(text)) == jcheck(jparse(text))
    assert any("without a cache" in w for w in check_config(parse_config(text)))
    cfg = parse_config(text)
    assert cfg.app.db.backend_options == {"bucket": "tempo", "endpoint": "http://127.0.0.1:9"}
    assert json.dumps(cfg.app.db.backend_options) == json.dumps(jparse(text).app.db.backend_options)
