"""The port's serverless search handler and the querier's external
endpoints against the JAX package's.

Both packages write the same block (the same traces from a seed, the
same block id) into backends of their own; the port's SearchBlockHandler
and ServerlessServer answer every request field for field as the
reference's do, over a local backend and over the S3 mock
(chip_smoke.ObjectStoreMock), and a Querier with `external_endpoints`
delegates each block job to the endpoint and returns what a direct
search returns."""

import json
import urllib.parse

import pytest

import chip_smoke
from tempo_tpu.api.params import BadRequest as JBadRequest
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.util import pipeline as jpipeline
from tempo_tpu.db import DBConfig as JDBConfig, TempoDB as JTempoDB
from tempo_tpu.encoding.common import BlockConfig as JConfig, SearchRequest as JReq
from tempo_tpu.model import synth as jsynth, trace as jtr
from tempo_tpu.serverless import SearchBlockHandler as JHandler, ServerlessServer as JServer
from tempo_tpu_torch.api.params import BadRequest, SearchBlockRequest, build_search_block_params
from tempo_tpu_torch.backend.httpclient import PooledHTTPClient
from tempo_tpu_torch.db import DBConfig, TempoDB
from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest
from tempo_tpu_torch.model import synth, trace as tr
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.modules.querier import Querier
from tempo_tpu_torch.util import pipeline
from tempo_tpu_torch.serverless import SearchBlockHandler, ServerlessServer, response_to_dict

BID = "00000000-0000-0000-0000-0000000000c1"


@pytest.fixture(autouse=True)
def _no_prefetch(monkeypatch):
    """Same bytes read every run: no ReadAhead prefetch in either package
    (a limited search would read ahead a varying amount)."""
    monkeypatch.setattr(jpipeline, "overlap_enabled", lambda: False)
    monkeypatch.setattr(pipeline, "overlap_enabled", lambda: False)


def cold():
    """Empty both packages' shared column caches."""
    for cache in (jcolcache.shared_cache(), colcache.shared_cache()):
        if cache is not None:
            cache.clear()


def both(h, jh, qs, tenant="acme"):
    """(port response, reference response) of one request, each cold."""
    cold()
    got = h.handle(qs, tenant)
    cold()
    return got, jh.handle(qs, tenant)


@pytest.fixture
def blocks(tmp_path):
    """(port db, reference db, traces): one block of 40 traces in small
    row groups, written by each package under the same id."""
    db = TempoDB(DBConfig(backend="local", backend_path=str(tmp_path / "p" / "blocks"),
                          wal_path=str(tmp_path / "p" / "wal"),
                          block=BlockConfig(row_group_spans=64)), device="cpu")
    jdb = JTempoDB(JDBConfig(backend="local", backend_path=str(tmp_path / "j" / "blocks"),
                             wal_path=str(tmp_path / "j" / "wal"),
                             block=JConfig(row_group_spans=64), compaction_device_shards=1))
    traces = synth.make_traces(40, seed=21)
    db.write_batch("acme", tr.traces_to_batch(traces).sorted_by_trace(), block_id=BID)
    jdb.write_batch("acme", jtr.traces_to_batch(jsynth.make_traces(40, seed=21)).sorted_by_trace(),
                    block_id=BID)
    db.poll_now()
    jdb.poll_now()
    return db, jdb, traces


def _service_of(trace):
    return trace.batches[0][0]["service.name"]


def handlers(tmp_path):
    return (SearchBlockHandler("local", {"path": str(tmp_path / "p" / "blocks")}),
            JHandler("local", {"path": str(tmp_path / "j" / "blocks")}))


def test_search_one_block(tmp_path, blocks):
    _, _, traces = blocks
    h, jh = handlers(tmp_path)
    for want in traces[::8]:
        qs = {"blockID": [BID], "tags": [f"service={_service_of(want)}"], "limit": ["100"]}
        got, want_resp = both(h, jh, qs)
        assert want.trace_id.hex() in {t.trace_id_hex for t in got.traces}
        assert response_to_dict(got) == want_resp.to_dict()


def test_row_group_subrange_partitions_block(tmp_path, blocks):
    db, _, _ = blocks
    h, jh = handlers(tmp_path)
    meta = db.blocklist.metas("acme")[0]
    n_rgs = len(db.encoding_for(meta.version).open_block(meta, db.backend).index().row_groups)
    assert n_rgs > 1
    whole = h.handle({"blockID": [BID], "limit": ["100"]}, "acme")
    parts = []
    for rg in range(n_rgs):
        qs = {"blockID": [BID], "startRowGroup": [str(rg)], "rowGroups": ["1"], "limit": ["100"]}
        resp, jresp = both(h, jh, qs)
        assert resp.to_dict() == jresp.to_dict()
        parts.extend(t.trace_id_hex for t in resp.traces)
    assert sorted(parts) == sorted(t.trace_id_hex for t in whole.traces)


@pytest.mark.parametrize("qs,tenant", [({}, "acme"), ({"blockID": ["x"]}, ""),
                                       ({"blockID": [BID], "version": ["other-enc"]}, "acme")])
def test_bad_requests(tmp_path, blocks, qs, tenant):
    h, jh = handlers(tmp_path)
    with pytest.raises(BadRequest) as e:
        h.handle(qs, tenant)
    with pytest.raises(JBadRequest) as je:
        jh.handle(qs, tenant)
    assert str(e.value) == str(je.value)


def test_server_roundtrip(tmp_path, blocks):
    """The same HTTP answers from both servers, the error codes too."""
    _, _, traces = blocks
    h, jh = handlers(tmp_path)
    srv, jsrv = ServerlessServer(h).start(), JServer(jh).start()
    try:
        sbr = SearchBlockRequest(search=SearchRequest(tags={"service": _service_of(traces[0])},
                                                      limit=100), block_id=BID)
        qs = urllib.parse.urlencode(build_search_block_params(sbr))
        bodies = []
        for s in (srv, jsrv):
            cold()
            c = PooledHTTPClient(s.url)
            status, body, _ = c.request("GET", f"/?{qs}", headers={"X-Scope-OrgID": "acme"})
            assert status == 200
            bad, bad_body, _ = c.request("GET", "/?limit=0", headers={"X-Scope-OrgID": "acme"},
                                         ok=(400,))
            bodies.append((json.loads(body), bad, json.loads(bad_body)))
        assert bodies[0] == bodies[1]
        assert traces[0].trace_id.hex() in {t["traceID"] for t in bodies[0][0]["traces"]}
        assert bodies[0][1] == 400
    finally:
        srv.stop()
        jsrv.stop()


@pytest.mark.parametrize("store", ["local", "s3"])
def test_querier_delegates_to_external_endpoint(tmp_path, blocks, store):
    """search_block_job and search_block_batch through the endpoint equal
    the direct search; over S3 the handler reads the block from the
    mock through make_raw_backend."""
    db, _, traces = blocks
    mock = None
    if store == "s3":
        mock = chip_smoke.ObjectStoreMock("s3", log=False)
        opts = chip_smoke.store_options(mock)
        s3db = TempoDB(DBConfig(backend="s3", backend_options=opts,
                                wal_path=str(tmp_path / "s3wal"),
                                block=BlockConfig(row_group_spans=64)), device="cpu")
        s3db.write_batch("acme", tr.traces_to_batch(traces).sorted_by_trace(), block_id=BID)
        handler = SearchBlockHandler("s3", opts)
    else:
        handler = handlers(tmp_path)[0]
    srv = ServerlessServer(handler).start()
    try:
        direct = Querier(db)
        q = Querier(db, external_endpoints=[srv.url + "/"])
        for t in traces[:4]:
            req = SearchRequest(tags={"service": _service_of(t)}, limit=100)
            cold()
            resp = q.search_block_job("acme", BID, req)
            assert t.trace_id.hex() in {x.trace_id_hex for x in resp.traces}
            assert resp.inspected_blocks == 1
            cold()
            assert resp.to_dict() == direct.search_block_job("acme", BID, req).to_dict()
            cold()
            batch = q.search_block_batch("acme", [BID], req).to_dict()
            cold()
            assert batch == direct.search_block_batch("acme", [BID], req).to_dict()
        assert q._ext_rr == 8
    finally:
        srv.stop()
        if mock is not None:
            mock.stop()
