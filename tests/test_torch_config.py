"""The port's config tree against the JAX package's.

The same YAML must give equal config dataclasses in both packages
(field for field, nested sections and lists included, defaults alike)
and the same check_config warnings. The metrics-generator starts on, as
in the reference, and App serves it with its remote write; so are the
storage analytics scan (600 s by default), the device tier's ingest-tail
share (by config and by TEMPO_TPU_INGEST_TAIL_MB), the result cache (by
config and by TEMPO_TPU_RESULT_CACHE), the backend cache, the incident
plane (rca, slo, vulture), the ingest tees (forwarders, usage_report,
self_tracing: App builds what the JAX App builds) and the gRPC, Jaeger
UDP and Kafka receivers (`python -m tempo_tpu_torch` starts each one
its `server:` section turns on, and a payload sent to it lands).
"""

import dataclasses
import json
import socket
import time

import pytest

import chip_smoke
from tempo_tpu import __main__ as jmain
from tempo_tpu import config as jconfig
from tempo_tpu.app import App as JApp
from tempo_tpu.receivers import jaeger as jjaeger
from tempo_tpu.receivers import otlp as jotlp
from tempo_tpu_torch import __main__ as tmain
from tempo_tpu_torch import config, usagestats
from tempo_tpu_torch.app import App
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.trace import batch_to_traces
from tempo_tpu_torch.receivers import jaeger, otlp

FULL_YAML = """
target: all
multitenancy_enabled: true
server:
  http_listen_port: 3201
  log_level: warn
storage:
  trace:
    backend: local
    backend_path: ${BLOCKS:/tmp/blocks}
    wal_path: /tmp/wal
    block:
      bloom_fp: 0.02
      row_group_spans: 4096
      step_partial_rules: [[rate_by_service, "{ } | rate() by (resource.service.name)", 60, 64]]
    compaction:
      window_s: 1800
    analytics_scan_s: 0
    result_cache:
      max_bytes: 1024
ingester:
  max_trace_idle_s: 5.0
  concurrent_flushes: 2
query_frontend:
  query_shards: 8
  hedge_after_s: 0
overrides:
  per_tenant_override_config: /etc/overrides.yaml
  defaults:
    max_traces_per_user: 500
metrics_generator:
  enabled: false
standing:
  enabled: false
  max_queries_per_tenant: 4
compiled:
  enabled: false
device_tier:
  budget_mb: 0
  max_query_batch: 4
resource:
  live_trace_bytes: 1048576
self_tracing:
  sample_ratio: 0.5
vulture:
  retention_s: 100
slo:
  eval_interval_s: 5
  objectives:
    - name: w
      sli: availability_write
rca:
  walks: 8
usage_report:
  enabled: false
replication_factor: 2
n_ingesters: 2
query_workers: 3
ring_heartbeat_timeout_s: 12.5
"""

def _doc(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_full_yaml_equal():
    env = {"BLOCKS": "/data/blocks"}
    j, t = jconfig.parse_config(FULL_YAML, env=env), config.parse_config(FULL_YAML, env=env)
    assert _doc(j) == _doc(t)
    assert t.app.db.backend_path == "/data/blocks"
    assert [type(o).__name__ for o in t.app.slo.objectives] == ["SLOObjective"]


@pytest.mark.parametrize("yaml_text", [
    "", "target: all\n", "server:\n  http_listen_port: 0\n",
    "storage:\n  trace:\n    backend: mock\n    block:\n      codec: zlib\n",
    "ingester:\n  max_block_bytes: 1000\nquery_workers: 1\n",
])
def test_defaults_equal_but_the_named_four(yaml_text):
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    assert _doc(j) == _doc(t)
    assert t.app.db.analytics_scan_s == 600.0


@pytest.mark.parametrize("bad", [
    "nope: 1\n", "storage:\n  trace:\n    nope: 1\n", "storage:\n  other: {}\n",
    "overrides:\n  defaults:\n    nope: 1\n", "distributor:\n  nope: 1\n",
    "metrics_generator:\n  nope: 1\n", "slo: 3\n", "- a\n",
])
def test_same_errors(bad):
    with pytest.raises(jconfig.ConfigError) as je:
        jconfig.parse_config(bad)
    with pytest.raises(config.ConfigError) as te:
        config.parse_config(bad)
    assert str(je.value) == str(te.value)


WARN_YAMLS = [
    "replication_factor: 3\nn_ingesters: 1\n",
    "replication_factor: 2\nn_ingesters: 1\n",
    "storage:\n  trace:\n    block:\n      bloom_fp: 0.2\n",
    "storage:\n  trace:\n    block:\n      bloom_fp: 0.06\n"
    "overrides:\n  defaults:\n    block_retention_s: 1\n",
    "overrides:\n  defaults:\n    block_retention_s: 60\n",
    "ingester:\n  complete_block_timeout_s: 1\n",
    "storage:\n  trace:\n    blocklist_poll_s: 10\ningester:\n  complete_block_timeout_s: 5\n",
    "resource:\n  hard_watermark: 0.5\n  soft_watermark: 0.6\n",
    "resource:\n  hard_watermark: 0.6\n  soft_watermark: 0.6\n",
    "ingester:\n  max_block_bytes: 2000000000\n",
    "resource:\n  wal_head_bytes: 1000\n",
    "resource:\n  inflight_query_bytes: 1000\n",
    "query_frontend:\n  query_shards: 64\nresource:\n  inflight_query_bytes: 1000000000\n",
    "storage:\n  trace:\n    block:\n      step_partial_rules: [[r, '{ } | rate()', 7200, 64]]\n",
    "storage:\n  trace:\n    block:\n      step_partial_rules:\n"
    "        [[r, '{ } | rate() by (resource.service.name)', 60, 4000]]\n",
    "replication_factor: 3\nn_ingesters: 1\nstorage:\n  trace:\n    block:\n"
    "      bloom_fp: 0.2\noverrides:\n  defaults:\n    block_retention_s: 60\n"
    "ingester:\n  complete_block_timeout_s: 1\n",
    # the compiled tier: uncapped shapes in a multitenant cluster
    "multitenancy_enabled: true\n",
    "multitenancy_enabled: true\ncompiled:\n  max_shapes: 0\n  respect_governor: false\n",
    # the standing engine: an uncapped registration count in a
    # multitenant cluster, alone and beside the compiled tier's warning
    "multitenancy_enabled: true\ncompiled:\n  max_shapes: 64\n",
    "multitenancy_enabled: true\nstanding:\n  max_queries_per_tenant: 0\n",
    # the storage analytics scan shorter than the blocklist poll
    "storage:\n  trace:\n    analytics_scan_s: 60\n",
    "storage:\n  trace:\n    analytics_scan_s: 30\n    blocklist_poll_s: 10\n"
    "ingester:\n  complete_block_timeout_s: 5\n",
    # self-tracing: a rate bound out of proportion, a ratio outside [0, 1]
    "self_tracing:\n  enabled: true\n  max_spans_per_s: 60000\n",
    "self_tracing:\n  enabled: true\n  sample_ratio: 1.5\n",
]


@pytest.mark.parametrize("yaml_text", WARN_YAMLS)
def test_check_config_warnings_equal(yaml_text):
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    jw, tw = jconfig.check_config(j), config.check_config(t)
    assert jw == tw and tw


# the device tier's warnings (config.py: the HBM headroom, an unshed
# tier, an inverted cache hierarchy, the forced device encode without a
# tier, the compiled tier over an oversubscribed budget), each case with
# the environment that trips it
TIER_WARNINGS = [
    ("device_tier:\n  budget_mb: 64\n  respect_governor: false\n", {}),
    ("device_tier:\n  budget_mb: 64\n", {"TEMPO_TPU_HBM_BYTES": "1000"}),
    ("device_tier:\n  budget_mb: 512\n", {"TEMPO_TPU_COLCACHE_MB": "64"}),
    ("", {"TEMPO_TPU_DEVICE_ENCODE": "1"}),
    # the ingest tail's share: above the tier's budget, below an eighth
    # of the live-trace pool, and both
    ("device_tier:\n  budget_mb: 64\n  ingest_tail_budget_mb: 128\n", {}),
    ("device_tier:\n  budget_mb: 512\n  ingest_tail_budget_mb: 8\n", {}),
    ("device_tier:\n  budget_mb: 4\n  ingest_tail_budget_mb: 8\n", {}),
]


@pytest.mark.parametrize("case", TIER_WARNINGS, ids=lambda c: c[0].replace("\n", " ") + str(c[1]))
def test_device_tier_warnings_equal(case, monkeypatch):
    yaml_text, env = case
    for k in ("TEMPO_TPU_HBM_BYTES", "TEMPO_TPU_COLCACHE_MB", "TEMPO_TPU_DEVICE_ENCODE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    jw, tw = jconfig.check_config(j), config.check_config(t)
    assert jw == tw and any("device_tier" in w or "DEVICE_ENCODE" in w for w in tw)


@pytest.mark.parametrize("yaml_text", ["", FULL_YAML])
def test_check_config_quiet_equal(yaml_text):
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    assert jconfig.check_config(j) == config.check_config(t)


# the ingest tees, refused until the port served them: (section, what
# App builds for it, the same in both packages)
UNPORTED = {
    "distributor:\n  forwarders:\n    - {name: m, endpoint: http://c:4318}\n":
        lambda app: (not app.can_push_spans(),
                     {n: dataclasses.asdict(f.cfg)
                      for n, f in app.forwarder_manager.forwarders.items()}),
    "usage_report:\n  enabled: true\n":
        lambda app: (app.usage_reporter.cfg.enabled, sorted(app.usage_reporter.build_report())),
    "self_tracing:\n  enabled: true\n":
        lambda app: dataclasses.asdict(app._self_exporter.cfg),
}


@pytest.mark.parametrize("yaml_text", sorted(UNPORTED))
def test_tee_sections_served(yaml_text, tmp_path):
    """Each tee section parses as in the reference, gives its
    check_config warnings and passes -config.verify in both packages, and
    the port's App builds what the JAX App builds: the forwarders (and
    the object ingest path), the usage reporter (its report's keys, the
    cluster seed under SEED_KEY), the self-trace exporter."""
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    assert _doc(j) == _doc(t) and jconfig.check_config(j) == config.check_config(t)
    built = []
    for name, parsed, app_of in (("jax", j, JApp), ("port", t, lambda c: App(c, device="cpu"))):
        parsed.app.db.backend_path = str(tmp_path / name / "blocks")
        parsed.app.db.wal_path = str(tmp_path / name / "wal")
        parsed.app.target = parsed.target
        app = app_of(parsed.app)
        try:
            built.append(UNPORTED[yaml_text](app))
        finally:
            app.shutdown()
    assert built[0] == built[1] and built[1]
    if "usage_report" in yaml_text:
        seed = json.loads((tmp_path / "port" / "blocks" / usagestats.SEED_KEY).read_text())
        assert sorted(seed) == ["UID", "created_at"]
    path = tmp_path / "tempo.yaml"
    path.write_text(yaml_text + f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n")
    for main in (jmain.main, tmain.main):
        assert main(["-config.file", str(path), "-config.verify"]) == 0


# the sections of microservices mode, refused until the port served them:
# each parses as in the reference and App builds what it names
MICROSERVICES_SECTIONS = {
    "target: querier\nring_kv_path: {root}/ring.json\n":
        lambda app: app.target == "querier" and app.querier is not None
        and app.frontend is None and app.ring is not None,
    "target: ingester\nring_kv_path: {root}/ring.json\ninstance_id: ingester-3\n":
        lambda app: list(app.ingesters) == ["ingester-3"] and app.standing is not None,
    "metrics_generator:\n  remote_write:\n    endpoint: http://p:9090\n    wal_dir: {root}/rw\n":
        lambda app: app.remote_write_storage is not None,
    "target: metrics-generator\nring_kv_path: {root}/ring.json\nmetrics_generator:\n"
    "  remote_write:\n    endpoint: http://p:9090\n    wal_dir: {root}/rw\n":
        lambda app: app.generator is not None and app.remote_write_storage is not None,
}


@pytest.mark.parametrize("yaml_text", sorted(MICROSERVICES_SECTIONS))
def test_microservices_sections_served(yaml_text, tmp_path):
    """A role target and the generator's remote write parse as in the
    reference, give its check_config warnings, build on the CPU, and
    pass -config.verify."""
    text = yaml_text.replace("{root}", str(tmp_path))
    j, t = jconfig.parse_config(text), config.parse_config(text)
    assert _doc(j) == _doc(t) and j.target == t.target
    assert jconfig.check_config(j) == config.check_config(t)
    t.app.target = t.target
    t.app.db.backend_path = str(tmp_path / "blocks")
    t.app.db.wal_path = str(tmp_path / "wal")
    app = App(t.app, device="cpu")
    try:
        assert MICROSERVICES_SECTIONS[yaml_text](app)
    finally:
        app.shutdown()
    path = tmp_path / "tempo.yaml"
    path.write_text(text + f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n")
    assert tmain.main(["-config.file", str(path), "-config.verify"]) == 0


@pytest.mark.parametrize("yaml_text", [
    "metrics_generator:\n  enabled: false\n  remote_write:\n    endpoint: http://p:9090\n",
    "target: vulture\n",
])
def test_microservices_warnings_equal(yaml_text):
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    assert jconfig.check_config(j) == config.check_config(t)


# the sections that earlier slices refused, now served by the modules
# they switch on (member of App or of its DB that each one builds)
SERVED_SECTIONS = {
    "rca:\n  enabled: true\n": lambda app: app.rca is not None,
    "slo:\n  enabled: true\n": lambda app: app.slo_engine is not None,
    "vulture:\n  enabled: true\n": lambda app: app.vulture is not None,
    "storage:\n  trace:\n    result_cache:\n      enabled: true\n":
        lambda app: app.db.result_cache.enabled(),
    "storage:\n  trace:\n    cache: memory\n":
        lambda app: type(app.db.backend.raw).__name__ == "CachedBackend",
}


@pytest.mark.parametrize("yaml_text", sorted(SERVED_SECTIONS))
def test_formerly_refused_sections_served(yaml_text, tmp_path, monkeypatch):
    """Each section parses as in the reference, gives the reference's
    check_config warnings, and App starts the module it switches on;
    -config.verify accepts the file."""
    monkeypatch.delenv("TEMPO_TPU_RESULT_CACHE", raising=False)
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    assert _doc(j) == _doc(t)
    assert jconfig.check_config(j) == config.check_config(t)
    t.app.db.backend_path = str(tmp_path / "blocks")
    t.app.db.wal_path = str(tmp_path / "wal")
    app = App(t.app, device="cpu")
    try:
        assert SERVED_SECTIONS[yaml_text](app)
    finally:
        app.shutdown()
    path = tmp_path / "tempo.yaml"
    path.write_text(yaml_text + f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n"
                    if "storage" not in yaml_text else yaml_text)
    assert tmain.main(["-config.file", str(path), "-config.verify"]) == 0


@pytest.mark.parametrize("yaml_text", [
    "rca:\n  enabled: true\nslo:\n  enabled: true\n",
    "slo:\n  enabled: true\n  objectives:\n    - {name: v, sli: vulture}\n    - {name: x, sli: nope, objective: 1.5}\n",
    "vulture:\n  enabled: true\n  aged_min_age_s: 60\n  retention_s: 30\n  write_backoff_s: 120\n",
    "storage:\n  trace:\n    backend: s3\n",
    "storage:\n  trace:\n    cache: memory\n    result_cache:\n      enabled: true\n",
])
def test_incident_and_cache_warnings_equal(yaml_text, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_ZONEMAPS", "0")
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    assert _doc(j) == _doc(t)
    jw, tw = jconfig.check_config(j), config.check_config(t)
    assert jw == tw and tw


@pytest.mark.parametrize("yaml_text,enabled", [
    ("", True), ("metrics_generator:\n  enabled: true\n", True),
    ("metrics_generator:\n  enabled: false\n", False),
])
def test_generator_section_served(yaml_text, enabled, tmp_path):
    """metrics_generator.enabled parses as in the reference (on by
    default) and App starts the generator it names, with generator-0 on
    its ring; -config.verify accepts it."""
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    assert j.app.generator_enabled == t.app.generator_enabled == enabled
    t.app.db.backend_path = str(tmp_path / "blocks")
    t.app.db.wal_path = str(tmp_path / "wal")
    app = App(t.app, device="cpu")
    try:
        assert (app.generator is not None) == enabled
        ring = [i.instance_id for i in app.generator_ring.instances()] if enabled else None
        assert ring == (["generator-0"] if enabled else None)
        assert ("generator" in app.service_states()) == enabled
    finally:
        app.shutdown()
    path = tmp_path / "tempo.yaml"
    path.write_text(yaml_text + f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n")
    assert tmain.main(["-config.file", str(path), "-config.verify"]) == 0


def _free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _norm(doc: dict) -> list:
    """An OTLP JSON document's spans with their resources, sorted; each
    span's attributes sorted by key (stored spans list the well-known
    columns after the other attributes)."""
    out = []
    for rs in doc["resourceSpans"]:
        for ss in rs["scopeSpans"]:
            for sp in ss["spans"]:
                sp = dict(sp, attributes=sorted(sp.get("attributes", []), key=lambda a: a["key"]))
                out.append(json.dumps([rs["resource"], sp], sort_keys=True))
    return sorted(out)


@pytest.mark.parametrize("server", ["grpc_listen_port: 4317", "jaeger_agent_compact_port: 6831",
                                    "kafka:\n    brokers: [k:9092]"])
def test_receiver_sections_served(server, tmp_path):
    """Each receiver section, refused until the port served it, parses as
    in the reference and passes -config.verify in both packages; on a
    free port (the scripted broker for Kafka) `start_receivers` starts
    the receiver on target all, and a trace sent to it is found in the
    App as the JAX decoder reads the payload."""
    text = f"server:\n  {server}\n"
    j, t = jconfig.parse_config(text), config.parse_config(text)
    assert _doc(j) == _doc(t) and jconfig.check_config(j) == config.check_config(t)
    path = tmp_path / "tempo.yaml"
    path.write_text(text + f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n")
    for main in (jmain.main, tmain.main):
        assert main(["-config.file", str(path), "-config.verify"]) == 0

    traces = batch_to_traces(synth.make_graph_batch(4, 4, seed=9,
                                                    base_time_ns=1_700_000_000 * 10**9))
    payload = otlp.encode_traces_request(traces)
    srv, broker, channel = t.server, None, None
    if "grpc" in server:
        grpc = pytest.importorskip("grpc")
        srv.grpc_listen_port = _free_port()
    elif "jaeger" in server:
        srv.jaeger_agent_compact_port = _free_port(socket.SOCK_DGRAM)
    else:
        broker = chip_smoke.ScriptedBroker(topic=srv.kafka.topic)
        srv.kafka.brokers = [broker.addr]
    t.app.target = t.target
    t.app.db.backend_path = str(tmp_path / "blocks")
    t.app.db.wal_path = str(tmp_path / "wal")
    app = App(t.app, device="cpu")
    started = tmain.start_receivers(t, app)
    try:
        (rx,) = started
        assert type(rx).__name__ == {"g": "TraceGrpcServer", "j": "UDPAgentServer",
                                     "k": "KafkaReceiver"}[server[0]]
        want = []
        if broker is not None:
            broker.produce([payload])
            want = jotlp.decode_traces_request(payload)
            done = lambda: rx.records == 1  # noqa: E731
        elif "grpc" in server:
            channel = grpc.insecure_channel(f"127.0.0.1:{srv.grpc_listen_port}")
            assert channel.unary_unary("/opentelemetry.proto.collector.trace.v1."
                                       "TraceService/Export")(payload, timeout=30) == b""
            want = jotlp.decode_traces_request(payload)
            done = lambda: rx.requests == 1  # noqa: E731
        else:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
                for res, spans in chip_smoke._resource_groups(traces):
                    datagram = jaeger.encode_agent_batch_compact(res["service.name"], spans)
                    n = rx.batches
                    sock.sendto(datagram, ("127.0.0.1", srv.jaeger_agent_compact_port))
                    want += jjaeger.decode_agent_datagram(datagram)
                    deadline = time.monotonic() + 30
                    while rx.batches == n:
                        assert time.monotonic() < deadline, "no datagram arrived"
                        time.sleep(0.005)
            done = lambda: rx.spans == 16  # noqa: E731
        deadline = time.monotonic() + 30
        while not done():
            assert time.monotonic() < deadline, "the receiver never pushed"
            time.sleep(0.005)
        by_id: dict = {}
        for w in want:
            by_id.setdefault(w.trace_id, []).append(w)
        for t_ in traces:
            got = app.find_trace(t_.trace_id)
            assert _norm(otlp.encode_traces_json([got])) \
                == _norm(jotlp.encode_traces_json(by_id[t_.trace_id]))
    finally:
        if channel is not None:
            channel.close()
        rx.stop()
        app.shutdown()
        if broker is not None:
            broker.close()


def test_verify_ok(tmp_path, capsys):
    path = tmp_path / "tempo.yaml"
    path.write_text(f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n")
    assert tmain.main(["-config.file", str(path), "-config.verify"]) == 0
    assert capsys.readouterr().out == "config ok\n"


@pytest.mark.parametrize("yaml_text", [
    "multitenancy_enabled: true\ncompiled:\n  max_shapes: 512\n",
    "multitenancy_enabled: true\ncompiled:\n  enabled: false\n",
    "compiled:\n  enabled: true\n  max_shapes: 64\n  respect_governor: false\n",
])
def test_compiled_section_equal(yaml_text, tmp_path):
    """The compiled section round-trips, warns only multitenant and
    uncapped, and App starts with it (the tier is served)."""
    j, t = jconfig.parse_config(yaml_text), config.parse_config(yaml_text)
    assert _doc(j)["app"]["compiled"] == _doc(t)["app"]["compiled"]
    assert jconfig.check_config(j) == config.check_config(t)
    assert not any("compiled" in w for w in config.check_config(t))
    t.app.db.backend_path = str(tmp_path / "blocks")
    t.app.db.wal_path = str(tmp_path / "wal")
    App(t.app, device="cpu").shutdown()


@pytest.mark.parametrize("value", ["on", "force"])
def test_result_cache_env_switch_served(value, tmp_path, monkeypatch):
    """TEMPO_TPU_RESULT_CACHE forces the result cache on over a config
    that leaves it off, as in the reference; -config.verify accepts it."""
    from tempo_tpu import resultcache as jrc

    monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", value)
    path = tmp_path / "tempo.yaml"
    path.write_text(f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n")
    assert tmain.main(["-config.file", str(path), "-config.verify"]) == 0
    t = config.parse_config(path.read_text())
    t.app.db.wal_path = str(tmp_path / "wal")
    assert not t.app.db.result_cache.enabled
    app = App(t.app, device="cpu")
    try:
        assert app.db.result_cache.enabled()
        assert app.db.result_cache.enabled() == jrc.ResultCache(
            jrc.ResultCacheConfig(enabled=False)).enabled()
    finally:
        app.shutdown()


@pytest.mark.parametrize("env", [("TEMPO_TPU_DEVICE_TIER_MB", "0"), ("TEMPO_TPU_INGEST_TAIL_MB", "0"),
                                 ("TEMPO_TPU_RESULT_CACHE", "off"), ("TEMPO_TPU_RESULT_CACHE", "")],
                         ids=lambda e: "=".join(e))
def test_env_switches_off_start(env, tmp_path, monkeypatch):
    monkeypatch.setenv(*env)
    path = tmp_path / "tempo.yaml"
    path.write_text(f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n")
    assert tmain.main(["-config.file", str(path), "-config.verify"]) == 0


# the sections and environment switches that earlier slices refused, now
# served: the storage analytics scan and the device tier's ingest tail
SERVED = [
    ("storage:\n  trace:\n    analytics_scan_s: 600\n", {}),
    ("device_tier:\n  budget_mb: 64\n  ingest_tail_budget_mb: 8\n", {}),
    ("", {"TEMPO_TPU_DEVICE_TIER_MB": "64", "TEMPO_TPU_INGEST_TAIL_MB": "8"}),
]


@pytest.mark.parametrize("case", SERVED, ids=lambda c: c[0].replace("\n", " ") + str(c[1]))
def test_analytics_and_ingest_tail_served(case, tmp_path, monkeypatch):
    """App starts the storage scanner on the configured period and a
    device tier with its tail share on the App's device; -config.verify
    accepts the same file."""
    from tempo_tpu_torch.encoding.vtpu import colcache

    yaml_text, env = case
    monkeypatch.setattr(colcache, "_shared_device", None)
    monkeypatch.setattr(colcache, "_tier_device", None)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t = config.parse_config(yaml_text)
    t.app.db.backend_path = str(tmp_path / "blocks")
    t.app.db.wal_path = str(tmp_path / "wal")
    app = App(t.app, device="cpu")
    try:
        assert app.storage_scanner is not None and app.storage_scanner.interval_s == 600.0
        tier = colcache.shared_device_tier()
        if "analytics" in yaml_text:
            assert tier is None
        else:
            assert tier.ingest_tail_budget_bytes == 8 << 20 and tier.device == app.device
    finally:
        app.shutdown()
    path = tmp_path / "tempo.yaml"
    path.write_text(yaml_text + f"storage:\n  trace:\n    backend_path: {tmp_path}/blocks\n"
                    if "storage" not in yaml_text else yaml_text)
    assert tmain.main(["-config.file", str(path), "-config.verify"]) == 0
