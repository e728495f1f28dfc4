"""The port stands alone: with jax and every tempo_tpu module blocked, a
fresh interpreter imports every tempo_tpu_torch module, runs the
compaction entry and one metrics query on the CPU, writes two vtpu1
blocks, finds a trace by ID, compacts the blocks and queries the output
on the CPU, drives the storage engine (TempoDB: write, find, tag search,
tag names, TraceQL search on the vectorized branch and the object
engine, WAL replay, compaction) on the CPU, parks a batch in a CPU tier
and scans it (the ingest tail), encodes pages through the
device page-encode arm forced on the CPU, serves the single binary
(App + TempoServer: one OTLP push, /flush, the trace read back by ID and
by search, a simple-count query_range through the compiled tier,
/api/query-insights, one Zipkin and one Jaeger thrift push, /status/device's
page-heat ledger,
/status/storage, /status/profile and /status/profile/device, the
metrics-generator's series and the graph routes over a second push, and a standing
query registered, folded at the flush's cut and read against query_range
over HTTP, a query_range answered twice through the result cache over
the memory backend cache, /api/rca and /status/slo) on the CPU, and an
entry point called
without a device raises when CUDA is absent. `python -m tempo_tpu_torch` verifies
a config and serves HTTP until /shutdown with the same imports blocked, and
serves the gRPC, Jaeger agent UDP and Kafka receivers its config turns on."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = textwrap.dedent(r"""
    import importlib, importlib.abc, pkgutil, sys

    sys.modules["jax"] = None  # any `import jax` now raises ImportError

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "tempo_tpu" or name.startswith("tempo_tpu."):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
""")

SCRIPT = BLOCK + textwrap.dedent(r"""

    import torch
    import tempo_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(tempo_tpu_torch.__path__, "tempo_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert len(names) >= 64, names
    for name in ("tempo_tpu_torch.compiled.executor", "tempo_tpu_torch.compiled.program",
                 "tempo_tpu_torch.ops.encode", "tempo_tpu_torch.parallel.search",
                 "tempo_tpu_torch.standing.engine", "tempo_tpu_torch.util.pageheat",
                 "tempo_tpu_torch.graph", "tempo_tpu_torch.graph.walks",
                 "tempo_tpu_torch.ops.graph", "tempo_tpu_torch.modules.generator",
                 "tempo_tpu_torch.modules.generator.registry",
                 "tempo_tpu_torch.modules.generator.spanmetrics",
                 "tempo_tpu_torch.modules.generator.servicegraphs",
                 "tempo_tpu_torch.ops.ingest_tail", "tempo_tpu_torch.db.analytics",
                 "tempo_tpu_torch.util.profiling", "tempo_tpu_torch.resultcache",
                 "tempo_tpu_torch.cache", "tempo_tpu_torch.cache.client",
                 "tempo_tpu_torch.backend.cache", "tempo_tpu_torch.rca",
                 "tempo_tpu_torch.rca.classify", "tempo_tpu_torch.rca.engine",
                 "tempo_tpu_torch.util.slo", "tempo_tpu_torch.util.traceinfo",
                 "tempo_tpu_torch.vulture", "tempo_tpu_torch.receivers.jaeger",
                 "tempo_tpu_torch.receivers.zipkin", "tempo_tpu_torch.receivers.udp",
                 "tempo_tpu_torch.receivers.opencensus", "tempo_tpu_torch.receivers.grpc_server",
                 "tempo_tpu_torch.receivers.kafka", "tempo_tpu_torch.modules.forwarder",
                 "tempo_tpu_torch.usagestats", "tempo_tpu_torch.backend.cloud",
                 "tempo_tpu_torch.backend.s3", "tempo_tpu_torch.backend.gcs",
                 "tempo_tpu_torch.backend.azure", "tempo_tpu_torch.encoding.vrow",
                 "tempo_tpu_torch.encoding.vrow.format", "tempo_tpu_torch.encoding.vrow.block",
                 "tempo_tpu_torch.encoding.vrow.encoding", "tempo_tpu_torch.serverless",
                 "tempo_tpu_torch.jaeger_query", "tempo_tpu_torch.jaeger_plugin",
                 "tempo_tpu_torch.cli", "tempo_tpu_torch.parallel.mesh",
                 "tempo_tpu_torch.parallel.metrics", "tempo_tpu_torch.parallel.compaction"):
        assert name in names, name
    for name, mod in sys.modules.items():
        assert mod is None or not (name == "tempo_tpu" or name.startswith("tempo_tpu.") or name == "jax"
                    or name.startswith("jax.")), name

    from tempo_tpu_torch.entry import entry
    fn, args = entry(device="cpu", n_rows=1 << 10)
    out = fn(*args)
    assert int(out["n_rows"]) > 0

    # the mesh: a (1, 4) mesh of CPU devices runs the sharded step, whose
    # totals equal the one-device step's, and the mesh bincount
    import numpy as np
    from tempo_tpu_torch.parallel import compaction as pcomp, mesh as pmesh
    from tempo_tpu_torch.parallel.metrics import make_sharded_bincount
    m4 = pmesh.compaction_mesh(4, devices=[torch.device("cpu")] * 4)
    tids = args[0].numpy().astype(np.uint32)
    sids = args[1].numpy().astype(np.uint32)
    t4, s4, v4, _ = pcomp.partition_by_id_range(tids[args[2].numpy()], sids[args[2].numpy()], 4)
    c4 = t4.shape[1]
    plans = pcomp.default_plans(1 << 10)
    sh, accs = pcomp.make_sharded_compactor(m4, plans)(
        t4.reshape(1, 4, c4, 4), s4.reshape(1, 4, c4, 2), v4.reshape(1, 4, c4),
        *pcomp.init_sketch_accumulators(m4, plans))
    assert int(accs["total_rows"][0]) == int(out["n_rows"])
    counts = make_sharded_bincount(m4, 8)(np.arange(16, dtype=np.int32).reshape(1, 4, 4) % 8,
                                          np.ones((1, 4, 4), np.int32))
    assert counts.tolist() == [[2] * 8]

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.model import synth
    plan = M.compile_metrics_plan("{ } | rate() by (resource.service.name)",
                                  1_700_000_000, 1_700_000_060, 60)
    acc = M.DeviceAccumulator(plan, device="cpu")
    b = synth.make_batch(50, 4)
    acc.add(M.eval_batch(plan, b, b.dictionary, acc.series), b)
    merged = M.new_wire()
    M.merge_wire(merged, acc.to_wire(), plan)
    assert M.finalize_matrix(plan, merged)["result"]

    import tempfile
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
    from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
    from tempo_tpu_torch.encoding.vtpu.create import write_block
    from tempo_tpu_torch.model.columnar import SpanBatch

    cfg = BlockConfig(row_group_spans=256)
    be = TypedBackend(LocalBackend(tempfile.mkdtemp()))
    b1, b2 = synth.make_batch(120, 4, seed=1), synth.make_batch(80, 4, seed=2)
    b2 = SpanBatch.concat([b2, b1.select(list(range(40)))]).sorted_by_trace()
    metas = [write_block([x], "t", be, cfg, device="cpu") for x in (b1, b2)]
    tid = b1.cols["trace_id"][0].astype(">u4").tobytes()
    assert VtpuBackendBlock(metas[0], be, cfg).find_trace_by_id(tid).trace_id == tid
    (out,) = VtpuCompactor(CompactionOptions(block_config=cfg), device="cpu").compact(metas, "t", be)
    assert out.total_objects == 200
    acc = M.evaluate_block(plan, VtpuBackendBlock(out, be, cfg), device="cpu")
    assert acc.stats["inspectedSpans"] == out.total_spans

    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import SearchRequest
    from tempo_tpu_torch.traceql import engine

    root = tempfile.mkdtemp()
    db = TempoDB(DBConfig(backend="local", backend_path=root + "/blocks", wal_path=root + "/wal",
                          block=cfg, compaction_device_shards=1), device="cpu")
    for x in (b1, b2):
        db.write_batch("t", x)
    assert db.find("t", tid).trace_id == tid
    resp = db.search("t", SearchRequest(tags={"service": "cart"}, limit=0))
    assert resp.traces and resp.inspected_blocks == 2
    assert "service.name" in db.search_tags("t") and "cart" in db.search_tag_values("t", "service.name")
    stats = {}
    assert db.traceql_search("t", '{ duration > 500ms }', limit=0, stats=stats)
    assert "prunedRowGroups" not in stats  # vectorized branch
    stats = {}
    db.traceql_search("t", '{ span.region = "v7" || span.region = "v9" }', limit=0, stats=stats)
    assert "prunedRowGroups" in stats  # mixed attribute types: the object engine
    assert engine.execute('{ name = "db.query" }', lambda spec, s, e: []) == []
    wal = db.wal.new_block("t")
    wal.append(b1)
    (replayed,) = db.wal.rescan_blocks()
    assert db.write_wal_block("t", replayed).total_spans == b1.num_spans
    assert db.compact_once("t") == 1 and len(db.blocklist.metas("t")) == 1

    from tempo_tpu_torch.encoding.vtpu.colcache import DeviceTier
    from tempo_tpu_torch.ops import ingest_tail
    tier = DeviceTier(8 << 20, ingest_tail_budget_bytes=4 << 20, device="cpu")
    b1._tail_key = ingest_tail.park_cut(tier, "t", "b:0", b1)
    assert ingest_tail.tail_search_mask(b1, SearchRequest(tags={"service.name": "cart"}),
                                        tier=tier).any()

    import os
    from tempo_tpu_torch.encoding.vtpu import codec, lightweight
    from tempo_tpu_torch.ops import encode as device_encode
    os.environ["TEMPO_TPU_DEVICE_ENCODE"] = "1"
    col = b1.cols["service"]
    for name in ("rle", "dbp", "dct"):
        assert codec.encode(col, name, "cpu")[0] == getattr(lightweight, f"{name}_encode")(col)
        assert device_encode.device_encode_pages_total.value(codec=name) >= 1
    del os.environ["TEMPO_TPU_DEVICE_ENCODE"]

    import json, urllib.parse, urllib.request
    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.receivers import otlp

    from tempo_tpu_torch import resultcache
    from tempo_tpu_torch.rca import RCAConfig
    from tempo_tpu_torch.util.slo import SLOConfig

    root = tempfile.mkdtemp()
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=root + "/blocks",
                                    wal_path=root + "/wal", cache="memory"),
                        rca=RCAConfig(enabled=True), slo=SLOConfig(enabled=True)),
              device="cpu")
    srv = TempoServer(app).start()
    try:
        def http(method, path, body=None, headers=None):
            req = urllib.request.Request(srv.url + path, data=body, method=method,
                                         headers=headers or {})
            with urllib.request.urlopen(req) as r:
                return r.status, r.read()
        traces = batch_to_traces(synth.make_batch(20, 3, seed=5))
        assert http("POST", "/v1/traces", otlp.encode_traces_request(traces),
                    {"Content-Type": "application/x-protobuf"})[0] == 200
        assert http("POST", "/flush")[0] == 204 and app.db.blocklist.metas("single-tenant")
        hexid = traces[0].trace_id.hex()
        status, body = http("GET", "/api/traces/" + hexid)
        assert status == 200 and json.loads(body)["resourceSpans"]
        svc = traces[0].batches[0][0]["service.name"]
        status, body = http("GET", "/api/search?" + urllib.parse.urlencode(
            {"tags": f"service.name={svc}", "limit": 100}))
        assert hexid in [t["traceID"] for t in json.loads(body)["traces"]]
        t_s = min(t.start_end_seconds()[0] for t in traces)
        status, body = http("GET", "/api/metrics/query_range?" + urllib.parse.urlencode(
            {"q": f'{{ resource.service.name = "{svc}" }} | rate()', "start": t_s - 60,
             "end": t_s + 600, "step": 60}))
        assert status == 200 and json.loads(body)["data"]["result"]
        status, body = http("GET", "/api/query-insights")
        assert status == 200 and json.loads(body)["compiled"]["misses"] >= 1
        os.environ["TEMPO_TPU_RESULT_CACHE"] = "force"
        cached_q = "{ } | rate() by (resource.service.name)"
        answers = []
        for _ in range(2):
            status, body = http("GET", "/api/metrics/query_range?" + urllib.parse.urlencode(
                {"q": cached_q, "start": t_s - 60, "end": t_s + 600, "step": 60}))
            assert status == 200
            answers.append(json.loads(body)["data"]["result"])
        del os.environ["TEMPO_TPU_RESULT_CACHE"]
        assert answers[0] and answers[0] == answers[1]
        assert resultcache.rc_hits.value(kind="metrics") >= 1
        status, body = http("GET", "/api/rca")
        assert status == 200 and json.loads(body) == {"enabled": True, "incidents": []}
        status, body = http("GET", "/status/slo")
        assert status == 200 and json.loads(body)["objectives"]
        status, body = http("GET", "/status/device")
        assert status == 200 and json.loads(body)["pageHeat"]["totalShips"] >= 1
        status, body = http("GET", "/status/storage?refresh=1")
        assert status == 200 and json.loads(body)["fleet"]["blocks"] >= 1
        status, body = http("GET", "/status/profile/device?seconds=0.1")
        assert status == 200 and json.loads(body)["supported"]
        status, body = http("GET", "/status/profile?seconds=0.1&fmt=collapsed")
        assert status == 200
        import time
        q = "{ } | rate() by (resource.service.name)"
        status, body = http("POST", "/api/metrics/standing",
                            json.dumps({"q": q, "step": 60, "window": 3600}).encode(),
                            {"Content-Type": "application/json"})
        assert status == 200
        qid = json.loads(body)["id"]
        base = (int(time.time()) // 60) * 60 - 600
        recent = batch_to_traces(synth.make_batch(20, 3, seed=6, base_time_ns=base * 10**9))
        assert http("POST", "/v1/traces", otlp.encode_traces_request(recent),
                    {"Content-Type": "application/x-protobuf"})[0] == 200
        assert http("POST", "/flush")[0] == 204
        window = {"start": base - 60, "end": base + 120, "step": 60}
        status, body = http("GET", f"/api/metrics/standing/{qid}?" + urllib.parse.urlencode(window))
        standing = json.loads(body)["data"]["result"]
        status2, body = http("GET", "/api/metrics/query_range?" + urllib.parse.urlencode(
            dict(window, q=q)))
        assert status == status2 == 200 and standing
        assert sorted(map(str, standing)) == sorted(map(str, json.loads(body)["data"]["result"]))
        status, body = http("GET", "/status/standing")
        assert json.loads(body)["foldSpans"] == 60
        graph_traces = batch_to_traces(synth.make_graph_batch(10, 6, seed=7))
        assert http("POST", "/v1/traces", otlp.encode_traces_request(graph_traces),
                    {"Content-Type": "application/x-protobuf"})[0] == 200
        calls = sum(s.value for s in app.generator.collect("single-tenant")
                    if s.name == "traces_spanmetrics_calls_total")
        assert calls == 60 + 60 + 60
        status, body = http("GET", "/api/graph/dependencies")
        assert status == 200 and json.loads(body)["edges"]
        status, body = http("GET", "/api/graph/critical-path?by=name")
        assert status == 200 and json.loads(body)["traces"] >= 10
        import chip_smoke
        zt = batch_to_traces(synth.make_graph_batch(4, 4, seed=11))
        jt = batch_to_traces(synth.make_graph_batch(4, 4, seed=12))
        assert http("POST", "/api/v2/spans", chip_smoke.zipkin_v2_json(zt),
                    {"Content-Type": "application/json"})[0] == 202
        for res_, spans_ in chip_smoke._resource_groups(jt):
            assert http("POST", "/api/traces", chip_smoke.jaeger_thrift_batch(res_, spans_),
                        {"Content-Type": "application/x-thrift"})[0] == 202
        for t in zt + jt:
            status, body = http("GET", "/api/traces/" + t.trace_id.hex(),
                                None, {"Accept": "application/protobuf"})
            assert status == 200 and sum(
                x.span_count() for x in otlp.decode_traces_request(body)) == t.span_count()
    finally:
        srv.stop()
        app.shutdown()

    if not torch.cuda.is_available():
        for call in (lambda: entry(), lambda: M.make_accumulator(plan), lambda: TempoDB(DBConfig()),
                     lambda: App(AppConfig(db=DBConfig(backend_path=root + "/b2"))),
                     lambda: write_block([b1], "t", be, cfg), lambda: VtpuCompactor(),
                     lambda: M.evaluate_block(plan, VtpuBackendBlock(out, be, cfg))):
            try:
                call()
            except RuntimeError:
                pass
            else:
                raise AssertionError("ran without a device and without CUDA")
    print("isolated ok", len(names))
""")


def test_port_runs_with_jax_and_tempo_tpu_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated ok" in proc.stdout


def test_no_import_of_jax_or_tempo_tpu_in_port_sources():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|tempo_tpu)(\.|\s|$)")
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tools", "profile_torch_port.py"),
             os.path.join(ROOT, "tools", "sweep_page_encode.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "tempo_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    bad = []
    for p in paths:
        with open(p) as f:
            bad += [f"{p}:{i}" for i, line in enumerate(f, 1) if pat.match(line)]
    assert not bad, bad


def _run_main(args, **kw):
    """`python -m tempo_tpu_torch <args>` with jax and tempo_tpu blocked."""
    code = BLOCK + f"import runpy\nsys.argv = ['tempo_tpu_torch'] + {args!r}\n" \
        "runpy.run_module('tempo_tpu_torch', run_name='__main__', alter_sys=True)\n"
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, **kw)


def test_main_verifies_and_serves(tmp_path):
    with socket.socket() as s:  # a free port for the listener
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = tmp_path / "tempo.yaml"
    cfg.write_text(f"server:\n  http_listen_port: {port}\n  log_level: warn\n"
                   f"storage:\n  trace:\n    backend: local\n"
                   f"    backend_path: {tmp_path}/blocks\n    wal_path: {tmp_path}/wal\n")
    out, err = _run_main(["-config.file", str(cfg), "-config.verify"]).communicate(timeout=120)
    assert out == "config ok\n", err[-2000:]

    proc = _run_main(["-config.file", str(cfg), "-device", "cpu"])
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/ready", timeout=5) as r:
                    assert r.read() == b"ready"
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
                time.sleep(0.2)
        with urllib.request.urlopen(url + "/status/services") as r:
            assert json.loads(r.read())["target"] == "all"
        req = urllib.request.Request(url + "/shutdown", data=b"", method="POST")
        with urllib.request.urlopen(req) as r:
            assert r.read() == b"shutdown job acknowledged"
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


MICROSERVICES_SCRIPT = BLOCK + textwrap.dedent(r"""
    import tempfile

    from tempo_tpu_torch.backend.httpclient import HedgeConfig, HTTPError, PooledHTTPClient, retriable
    from tempo_tpu_torch.modules import netkv, rpc, worker
    from tempo_tpu_torch.modules.generator import storage
    from tempo_tpu_torch.modules.ring import FileKV, Ring
    from tempo_tpu_torch.util import snappy
    from tempo_tpu_torch.vulture import HTTPClient

    data = b"span.kind=server " * 100
    assert snappy.decompress(snappy.compress(data)) == data
    svc = netkv.KVService()
    assert svc.cas("ring", 0, {"a": 1}) == (True, 1)
    path = tempfile.mkdtemp() + "/ring.json"
    Ring(FileKV(path)).register("ingester-0", addr="http://x")
    assert list(FileKV(path).get()) == ["ingester-0"]
    assert retriable(HTTPError(503, b"", "/x")) and HedgeConfig().hedge_up_to == 2
    assert worker.RemoteWorker and rpc.RingClientPool and storage.RemoteWriteStorage
    for name, mod in sys.modules.items():
        assert mod is None or not (name == "tempo_tpu" or name.startswith("tempo_tpu.")
                                   or name == "jax" or name.startswith("jax.")), name
    print("microservices ok")
""")


def test_microservices_modules_run_with_jax_and_tempo_tpu_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", MICROSERVICES_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "microservices ok" in proc.stdout


OFF_CLUSTER_SCRIPT = BLOCK + textwrap.dedent(r"""
    import contextlib, io, json, tempfile, urllib.request

    import chip_smoke
    from tempo_tpu_torch import cli, encoding
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest
    from tempo_tpu_torch.jaeger_query import JaegerQueryBridge
    from tempo_tpu_torch.model import synth, trace as tr
    from tempo_tpu_torch.serverless import SearchBlockHandler, ServerlessServer
    from tempo_tpu_torch.util import devicetiming, metrics

    text = metrics.expose()
    for fam in ("tempo_tpu_device_dispatch_seconds", "tempo_tpu_device_dispatches_total",
                "tempo_tpu_device_transfer_bytes_total",
                "tempo_tpu_device_transfer_bytes_avoided_total"):
        assert f"# TYPE {fam} " in text, fam
    traces = synth.make_traces(12, seed=3)
    batch = tr.traces_to_batch(traces).sorted_by_trace()
    for dialect in ("s3", "gcs", "azure"):
        mock = chip_smoke.ObjectStoreMock(dialect, log=False)
        for version in ("vtpu1", "vrow1"):
            db = TempoDB(DBConfig(backend=dialect, backend_options=chip_smoke.store_options(mock),
                                  wal_path=tempfile.mkdtemp(), block=BlockConfig(version=version)),
                         device="cpu")
            meta = db.write_batch(dialect, batch)
            assert meta.version == version
            assert db.find(dialect, traces[5].trace_id).span_count() == traces[5].span_count()
        if dialect == "s3":
            srv = ServerlessServer(SearchBlockHandler("s3", chip_smoke.store_options(mock))).start()
            url = srv.url + "/?blockID=" + meta.block_id + "&limit=100"
            req = urllib.request.Request(url, headers={"X-Scope-OrgID": "s3"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert json.loads(r.read())["traces"]
            srv.stop()
        mock.stop()
    assert encoding.from_version("vrow1").version == "vrow1"
    root = tempfile.mkdtemp()
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=root + "/blocks",
                                    wal_path=root + "/wal"), generator_enabled=False),
              device="cpu")
    app.push_traces(traces)
    assert JaegerQueryBridge(app).get_trace(traces[1].trace_id.hex())["spans"]
    app.sweep_all(immediate=True)
    app.shutdown()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["--path", root + "/blocks", "list", "blocks", "single-tenant"]) == 0
        assert cli.main(["--path", root + "/blocks", "query", "trace-id", "single-tenant",
                         traces[2].trace_id.hex()]) == 0
    assert "traces" in out.getvalue()
    for name, mod in sys.modules.items():
        assert mod is None or not (name == "tempo_tpu" or name.startswith("tempo_tpu.")
                                   or name == "jax" or name.startswith("jax.")), name
    print("off-cluster ok")
""")


def test_off_cluster_modules_run_with_jax_and_tempo_tpu_blocked():
    """The device families on /metrics from import, vtpu1 and vrow1 blocks
    through the S3, GCS and Azure backends (chip_smoke's mocks), the
    serverless handler over S3, the Jaeger bridge and the CLI, with jax
    and tempo_tpu blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", OFF_CLUSTER_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "off-cluster ok" in proc.stdout


def test_main_runs_an_ingester_role(tmp_path):
    """`python -m tempo_tpu_torch -target=ingester -device cpu` verifies
    its config and serves the role (ring KV, /rpc/v1, /memberlist) with
    jax and tempo_tpu blocked, until /shutdown."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    cfg = tmp_path / "tempo.yaml"
    cfg.write_text(f"server:\n  http_listen_port: {port}\n  log_level: warn\n"
                   f"storage:\n  trace:\n    backend: local\n"
                   f"    backend_path: {tmp_path}/blocks\n    wal_path: {tmp_path}/wal\n"
                   f"ring_kv_url: local\nadvertise_addr: {url}\ninstance_id: ingester-7\n")
    args = ["-config.file", str(cfg), "-target=ingester", "-device", "cpu"]
    out, err = _run_main(args + ["-config.verify"]).communicate(timeout=120)
    assert out == "config ok\n", err[-2000:]

    proc = _run_main(args)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/ready", timeout=5) as r:
                    assert r.read() == b"ready"
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
                time.sleep(0.2)
        with urllib.request.urlopen(url + "/status/services") as r:
            assert json.loads(r.read())["target"] == "ingester"
        with urllib.request.urlopen(url + "/kv/v1/ring") as r:
            ring = json.loads(r.read())["data"]
        assert ring["ingester-7"]["addr"] == url
        with urllib.request.urlopen(url + "/rpc/v1/ingester/live") as r:
            assert r.status == 200 and r.read() == b""
        with urllib.request.urlopen(url + "/memberlist") as r:
            assert json.loads(r.read())["stores"]["ring"]["keys"] == ["ingester-7"]
        req = urllib.request.Request(url + "/shutdown", data=b"", method="POST")
        with urllib.request.urlopen(req) as r:
            assert r.read() == b"shutdown job acknowledged"
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_main_serves_the_receivers(tmp_path):
    """`python -m tempo_tpu_torch -device cpu` with jax and tempo_tpu
    blocked starts the Jaeger agent UDP (compact and binary), Kafka (the
    scripted broker here) and, with grpcio installed, gRPC receivers its
    `server:` section turns on: a trace sent through each is found over
    HTTP, and /shutdown stops them all and exits 0."""
    import importlib.util

    sys.path.insert(0, ROOT)
    import chip_smoke
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.receivers import jaeger, otlp

    def free(kind=socket.SOCK_STREAM):
        with socket.socket(socket.AF_INET, kind) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    grpc = importlib.util.find_spec("grpc") is not None
    port, compact, binary = free(), free(socket.SOCK_DGRAM), free(socket.SOCK_DGRAM)
    grpc_port = free() if grpc else 0
    broker = chip_smoke.ScriptedBroker(topic="otlp_spans")
    url = f"http://127.0.0.1:{port}"
    cfg = tmp_path / "tempo.yaml"
    cfg.write_text(f"server:\n  http_listen_port: {port}\n  log_level: warn\n"
                   f"  grpc_listen_port: {grpc_port}\n  jaeger_agent_compact_port: {compact}\n"
                   f"  jaeger_agent_binary_port: {binary}\n"
                   f"  kafka:\n    brokers: [{broker.addr}]\n    poll_interval_s: 0.05\n"
                   f"storage:\n  trace:\n    backend: local\n"
                   f"    backend_path: {tmp_path}/blocks\n    wal_path: {tmp_path}/wal\n")
    proc = _run_main(["-config.file", str(cfg), "-device", "cpu"])
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/ready", timeout=5) as r:
                    assert r.read() == b"ready"
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
                time.sleep(0.2)
        traces = batch_to_traces(synth.make_graph_batch(4, 2, seed=13))
        # /ready answers before the receivers bind (the reference's order
        # too), and UDP drops what reaches no socket: a datagram is sent
        # again until its spans are found
        datagrams = []
        for t, (proto, udp_port) in zip(traces, (("compact", compact), ("binary", binary))):
            (res, spans), = chip_smoke._resource_groups([t])
            datagrams.append((jaeger.encode_agent_batch_compact(res["service.name"], spans)
                              if proto == "compact" else chip_smoke.jaeger_agent_binary(res, spans),
                              udp_port, t))
        broker.produce([otlp.encode_traces_request(traces[2:3])])
        wanted = [(None, 0, traces[2])]
        if grpc:
            import grpc as grpc_mod

            with grpc_mod.insecure_channel(f"127.0.0.1:{grpc_port}") as chan:
                grpc_mod.channel_ready_future(chan).result(timeout=60)
                chan.unary_unary("/opentelemetry.proto.collector.trace.v1.TraceService/Export")(
                    otlp.encode_traces_request(traces[3:]), timeout=60)
            wanted.append((None, 0, traces[3]))

        def found(t) -> bool:
            req = urllib.request.Request(url + "/api/traces/" + t.trace_id.hex(),
                                         headers={"Accept": "application/protobuf"})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    got = {x.span_id for tr in otlp.decode_traces_request(r.read())
                           for x in tr.all_spans()}
            except urllib.error.HTTPError as e:
                assert e.code == 404
                return False
            return got == {x.span_id for x in t.all_spans()}

        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            for payload, udp_port, t in datagrams + wanted:
                deadline = time.monotonic() + 60
                while not found(t):
                    assert time.monotonic() < deadline and proc.poll() is None, \
                        f"{t.trace_id.hex()} never arrived"
                    if payload is not None:
                        sock.sendto(payload, ("127.0.0.1", udp_port))
                    time.sleep(0.2)
        req = urllib.request.Request(url + "/shutdown", data=b"", method="POST")
        with urllib.request.urlopen(req) as r:
            assert r.read() == b"shutdown job acknowledged"
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        broker.close()
