"""The port's other receivers against the JAX package's.

The same payloads go through both packages' decoders: Zipkin v2 JSON and
v1 thrift, Jaeger thrift batches, the Jaeger agent's compact and binary
UDP datagrams, OpenCensus export requests and Jaeger gRPC PostSpans
requests. Traces are made from numpy seeds with every kind, error spans,
Zipkin shared spans (a client and a server half under one span ID),
resource attributes and every attribute type; the payloads are written
by chip_smoke.py's carrier encoders (the ones phase 15 sends to the
card), the compact datagram by each package's own encoder. Every decoded
trace document must be equal, and a truncated or malformed payload must
raise the same error in both. The Jaeger agent's UDP server runs end to
end, a malformed datagram counted and not fatal. Kafka record batches
round-trip with their CRC checked, for every codec, byte for byte
against the JAX encoder; the receiver consumes through the JAX tests'
scripted broker (offset recovery, a consumer group's join, commit and
rebalance) and pushes what the JAX receiver pushes. Tolerance is exact
throughout.
"""

import dataclasses
import gzip
import json
import socket
import struct
import time
import zlib

import numpy as np
import pytest

import chip_smoke
from tempo_tpu import native as jnative
from tempo_tpu import receivers as jreceivers
from tempo_tpu.receivers import grpc_server as jgrpc
from tempo_tpu.receivers import jaeger as jjaeger
from tempo_tpu.receivers import kafka as jkafka
from tempo_tpu.receivers import opencensus as jopencensus
from tempo_tpu.receivers import otlp as jotlp
from tempo_tpu.receivers import zipkin as jzipkin
from tempo_tpu_torch import native, receivers
from tempo_tpu_torch.model.trace import Span, Trace
from tempo_tpu_torch.receivers import grpc_server, jaeger, kafka, opencensus, otlp, zipkin
from tempo_tpu_torch.receivers.udp import UDPAgentServer
from tempo_tpu_torch.util import snappy

from test_kafka_oc_receivers import FakeBroker

SEEDS = [0, 1, 7, 42]
T0 = 1_700_000_000
THRIFT = "application/x-thrift"
SERVICES = ["cart", "checkout", "ü-svc", ""]
VALUES = [True, False, -7, 2**40, 3.25, -0.0, "ü-ñ", "", [1, "a"], {"k": 1}, b"\x00\xff"]


def rich_traces(seed: int) -> list[Trace]:
    """Traces of a few services each: every span kind, error spans,
    nested parents, Zipkin shared spans (a server half that reuses its
    client's span ID in another service), extra resource attributes and
    attributes of every type."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(2, 6))):
        tid = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        batches = {}
        parent = b"\x00" * 8
        for i in range(int(rng.integers(2, 9))):
            svc = SERVICES[int(rng.integers(0, len(SERVICES)))]
            sid = rng.integers(1, 256, 8, dtype=np.uint8).tobytes()
            attrs = {f"a.{j}": VALUES[j] for j in rng.choice(len(VALUES), 3, replace=False)}
            span = Span(trace_id=tid, span_id=sid, name=f"op-{int(rng.integers(0, 5))}",
                        parent_span_id=parent,
                        start_unix_nano=(T0 + int(rng.integers(0, 3600))) * 10**9
                        + int(rng.integers(0, 10**9)),
                        duration_nano=int(rng.integers(0, 10**9)),
                        kind=int(rng.integers(0, 6)), status_code=int(rng.integers(0, 3)),
                        attributes=attrs)
            res = {"service.name": svc}
            if svc == "cart":
                res["k8s.pod"] = f"pod-{seed}"
            batches.setdefault(json.dumps(res, sort_keys=True), (res, []))[1].append(span)
            if span.kind == 3 and rng.random() < 0.5:
                # the shared server half: same span ID, the other service
                shared = dataclasses.replace(span, kind=2, attributes={"shared": True})
                other = {"service.name": "checkout" if svc != "checkout" else "cart"}
                batches.setdefault(json.dumps(other, sort_keys=True), (other, []))[1].append(shared)
            parent = sid
        out.append(Trace(trace_id=tid, batches=list(batches.values())))
    return out


def doc(traces) -> list:
    return [dataclasses.asdict(t) for t in traces]


def groups(seed):
    return chip_smoke._resource_groups(rich_traces(seed))


def test_rich_traces_hold_what_the_codecs_map():
    spans = [(res, s) for seed in SEEDS for t in rich_traces(seed) for res, ss in t.batches
             for s in ss]
    assert {s.kind for _, s in spans} == set(range(6))
    assert {s.status_code for _, s in spans} == {0, 1, 2}
    ids = [(s.trace_id, s.span_id) for _, s in spans]
    assert len(ids) > len(set(ids))  # shared spans
    assert any(len(res) > 1 for res, _ in spans)


@pytest.mark.parametrize("seed", SEEDS)
def test_zipkin_json_equal(seed):
    body = chip_smoke.zipkin_v2_json(rich_traces(seed))
    want = doc(jzipkin.decode_spans_json(json.loads(body)))
    assert doc(zipkin.decode_spans_json(json.loads(body))) == want and want
    for ct in ("application/json", ""):
        assert doc(receivers.decode_http(receivers.ZIPKIN_PATH, ct, body)) \
            == doc(jreceivers.decode_http(jreceivers.ZIPKIN_PATH, ct, body)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_zipkin_thrift_equal(seed):
    body = chip_smoke.zipkin_v1_thrift(rich_traces(seed))
    want = doc(jzipkin.decode_spans_thrift(body))
    assert doc(zipkin.decode_spans_thrift(body)) == want and want
    # both paths take the thrift carrier (v2's path by content type)
    for path in (receivers.ZIPKIN_V1_PATH, receivers.ZIPKIN_PATH):
        for ct in (THRIFT, "application/vnd.apache.thrift.binary"):
            assert doc(receivers.decode_http(path, ct, body)) \
                == doc(jreceivers.decode_http(path, ct, body)) == want
    # a client half's cs/cr annotations and a server half's sr/ss give the kind
    kinds = {s.kind for t in zipkin.decode_spans_thrift(body) for s in t.all_spans()}
    assert kinds <= {0, 2, 3} and {2, 3} <= kinds


@pytest.mark.parametrize("seed", SEEDS)
def test_jaeger_batch_equal(seed):
    for res, spans in groups(seed):
        body = chip_smoke.jaeger_thrift_batch(res, spans)
        want = doc(jjaeger.decode_batch(body))
        assert doc(jaeger.decode_batch(body)) == want and want
        assert doc(receivers.decode_http(receivers.JAEGER_THRIFT_PATH, THRIFT, body)) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("protocol", ["compact", "binary"])
def test_agent_datagrams_equal(seed, protocol):
    for i, (res, spans) in enumerate(groups(seed)):
        ptags = {k: v for k, v in res.items() if k != "service.name"}
        if protocol == "compact":
            buf = jaeger.encode_agent_batch_compact(res["service.name"], spans, ptags, seqid=i)
            assert buf == jjaeger.encode_agent_batch_compact(res["service.name"], spans, ptags,
                                                             seqid=i)
        else:
            buf = chip_smoke.jaeger_agent_binary(res, spans, seqid=i)
        want = doc(jjaeger.decode_agent_datagram(buf))
        assert doc(jaeger.decode_agent_datagram(buf)) == want and want


@pytest.mark.parametrize("seed", SEEDS)
def test_opencensus_equal(seed):
    for res, spans in groups(seed):
        body = chip_smoke.opencensus_export(res, spans)
        want = doc(jopencensus.decode_export_request(body))
        assert doc(opencensus.decode_export_request(body)) == want and want


@pytest.mark.parametrize("seed", SEEDS)
def test_post_spans_equal(seed):
    for res, spans in groups(seed):
        body = chip_smoke.jaeger_post_spans(res, spans)
        want = doc(jgrpc.decode_post_spans_request(body))
        assert doc(grpc_server.decode_post_spans_request(body)) == want and want


@pytest.mark.parametrize("delay", [0.001, 0.25, 1.0, 7.5])
def test_retry_status_equal(delay):
    body = grpc_server.encode_retry_status(grpc_server.GRPC_RESOURCE_EXHAUSTED, "slow down", delay)
    assert body == jgrpc.encode_retry_status(jgrpc.GRPC_RESOURCE_EXHAUSTED, "slow down", delay)
    assert grpc_server.decode_retry_info_delay(body) == jgrpc.decode_retry_info_delay(body)
    assert abs(grpc_server.decode_retry_info_delay(body) - delay) < 1e-6
    assert grpc_server.decode_retry_info_delay(b"") is None


def _payloads(seed):
    """(name, port decoder, JAX decoder, payload) of every carrier."""
    traces = rich_traces(seed)
    res, spans = chip_smoke._resource_groups(traces)[0]
    return [
        ("zipkin json", lambda b: zipkin.decode_spans_json(json.loads(b)),
         lambda b: jzipkin.decode_spans_json(json.loads(b)), chip_smoke.zipkin_v2_json(traces)),
        ("zipkin thrift", zipkin.decode_spans_thrift, jzipkin.decode_spans_thrift,
         chip_smoke.zipkin_v1_thrift(traces)),
        ("jaeger batch", jaeger.decode_batch, jjaeger.decode_batch,
         chip_smoke.jaeger_thrift_batch(res, spans)),
        ("agent compact", jaeger.decode_agent_datagram, jjaeger.decode_agent_datagram,
         jaeger.encode_agent_batch_compact(res["service.name"], spans)),
        ("agent binary", jaeger.decode_agent_datagram, jjaeger.decode_agent_datagram,
         chip_smoke.jaeger_agent_binary(res, spans)),
        ("opencensus", opencensus.decode_export_request, jopencensus.decode_export_request,
         chip_smoke.opencensus_export(res, spans)),
        ("post spans", grpc_server.decode_post_spans_request, jgrpc.decode_post_spans_request,
         chip_smoke.jaeger_post_spans(res, spans)),
    ]


def _outcome(decode, payload):
    try:
        return "ok", doc(decode(payload))
    except Exception as e:  # noqa: BLE001 — the error's type is the answer
        return "raises", type(e).__name__


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_truncated_payloads_equal(seed):
    """Every cut of every carrier's payload answers alike in both
    packages: the same documents, or the same error."""
    raised = set()
    for name, decode, jdecode, payload in _payloads(seed):
        for cut in sorted({1, 2, 5, len(payload) // 3, len(payload) // 2, len(payload) - 1}):
            got, want = _outcome(decode, payload[:cut]), _outcome(jdecode, payload[:cut])
            assert got == want, (name, cut)
            if got[0] == "raises":
                raised.add(name)
    # the thrift carriers and the agent's datagrams cannot decode a cut
    assert {"zipkin thrift", "jaeger batch", "agent compact", "agent binary"} <= raised


@pytest.mark.parametrize("payload,error", [
    (b"", "ThriftError"),
    (b"\x82\x81garbage", "ThriftError"),
    (struct.pack(">I", 0x80020001) + b"\x00" * 8, "ThriftError"),
    (struct.pack(">I", 0x80010004) + struct.pack(">i", 4) + b"ping" + b"\x00" * 5, "ThriftError"),
    (b"\x0c\x00\x01\x0f\x00\x02\x0b\x00\x00\x00\x01", "ThriftError"),
])
def test_malformed_datagrams_raise_equal(payload, error):
    for mod in (jaeger, jjaeger):
        with pytest.raises(mod.ThriftError):
            mod.decode_agent_datagram(payload)
    assert _outcome(jaeger.decode_agent_datagram, payload) == ("raises", error)


def test_malformed_http_payloads_raise_equal():
    for path, ct, body in [(receivers.ZIPKIN_V1_PATH, "application/json", b"[]"),
                           (receivers.ZIPKIN_PATH, THRIFT, b"\x0c\x00"),
                           (receivers.JAEGER_THRIFT_PATH, THRIFT, b"\x0c\x00\x01\x0b"),
                           ("/api/nope", "application/json", b"{}")]:
        got = _outcome(lambda b: receivers.decode_http(path, ct, b), body)
        assert got == _outcome(lambda b: jreceivers.decode_http(path, ct, b), body)
        assert got[0] == "raises"


def test_udp_server_end_to_end():
    """Compact and binary datagrams over loopback land as the JAX decoder
    reads them; a malformed one is counted, and the server takes the
    next."""
    got = []
    srv = UDPAgentServer(lambda traces, org_id=None: got.append((org_id, doc(traces))),
                         compact_port=0, binary_port=0, org_id="t").start()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sent = []
        for seed in SEEDS:
            for res, spans in groups(seed):
                sent.append((chip_smoke.jaeger_agent_binary(res, spans), srv.binary_port))
                sent.append((jaeger.encode_agent_batch_compact(res["service.name"], spans),
                             srv.compact_port))
        sent.insert(3, (b"\x82\x21garbage", srv.compact_port))
        for buf, port in sent:  # one in flight: loopback drops a burst
            n0 = srv.batches + srv.errors
            sock.sendto(buf, ("127.0.0.1", port))
            deadline = time.monotonic() + 10
            while srv.batches + srv.errors == n0:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        assert srv.errors == 1 and srv.batches == len(sent) - 1
        want = [("t", doc(jjaeger.decode_agent_datagram(b))) for b, _ in sent
                if not b.startswith(b"\x82\x21")]
        assert got == want
        assert srv.spans == sum(len(spans) for _, d in want for t in d for _, spans in t["batches"])
    finally:
        sock.close()
        srv.stop()


def test_malformed_datagram_counted_not_fatal():
    srv = UDPAgentServer(lambda *a, **k: None, compact_port=0, binary_port=None)
    try:
        assert srv.handle_datagram(b"\x82\x81garbage") == 0
        assert srv.handle_datagram(b"") == 0
        # a datagram of nested struct headers deep enough to exhaust the
        # recursive skip is counted, like a truncated one
        deep = struct.pack(">I", 0x80010004) + struct.pack(">i", 9) + b"emitBatch" \
            + b"\x00" * 4 + b"\x0c\x00\x05" * 20_000
        assert srv.handle_datagram(deep) == 0
        assert srv.errors == 3 and srv.batches == 0
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Kafka
# ---------------------------------------------------------------------------

CODECS = {"none": kafka.CODEC_NONE, "gzip": kafka.CODEC_GZIP, "snappy": kafka.CODEC_SNAPPY,
          "zstd": kafka.CODEC_ZSTD}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_record_batches_round_trip(codec):
    rng = np.random.default_rng(CODECS[codec])
    values = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() * 3
              for n in rng.integers(0, 4000, 7)]
    keys = [None if i % 3 else f"k{i}".encode() for i in range(len(values))]
    if codec == "zstd" and native.lib() is None:
        # no native library: a zstd batch raises in both, as in the reference
        for mod in (kafka, jkafka):
            with pytest.raises(ValueError):
                mod.encode_record_batch(5, values, keys, codec=CODECS[codec])
        assert jnative.lib() is None
        return
    raw = kafka.encode_record_batch(5, values, keys, ts_ms=1234, codec=CODECS[codec])
    assert raw == jkafka.encode_record_batch(5, values, keys, ts_ms=1234, codec=CODECS[codec])
    want = [(5 + i, k, v) for i, (k, v) in enumerate(zip(keys, values))]
    both = raw + kafka.encode_record_batch(12, values[:2], codec=CODECS[codec])
    assert kafka.decode_record_batches(raw) == jkafka.decode_record_batches(raw) == want
    assert kafka.decode_record_batches(both) == jkafka.decode_record_batches(both)
    # a truncated trailing batch is left for the next fetch
    assert kafka.decode_record_batches(both[:-3]) == want
    # the CRC32C covers the attributes, the header and the records
    for pos in (len(raw) - 1, 30, 61):
        bad = bytearray(raw)
        bad[pos] ^= 0x40
        for mod in (kafka, jkafka):
            with pytest.raises(ValueError, match="crc"):
                mod.decode_record_batches(bytes(bad))


def test_decompress_xerial_and_gzip_framing_equal():
    raw = b"span payload " * 500
    framed = b"\x82SNAPPY\x00" + struct.pack(">ii", 1, 1)
    for i in range(0, len(raw), 1000):
        block = snappy.compress(raw[i:i + 1000])
        framed += struct.pack(">i", len(block)) + block
    for codec, buf in ((kafka.CODEC_SNAPPY, framed), (kafka.CODEC_GZIP, gzip.compress(raw)),
                       (kafka.CODEC_GZIP, zlib.compress(raw))):
        got = kafka._decompress_records(codec, buf)
        assert got == jkafka._decompress_records(codec, buf) == raw
    for codec in (kafka.CODEC_LZ4, 6):
        for mod in (kafka, jkafka):
            with pytest.raises(ValueError):
                mod._decompress_records(codec, b"x")


def _make_trace(seed, n=3):
    tid = bytes([seed]) * 16
    spans = [Span(trace_id=tid, span_id=bytes([seed, i]) * 4, name=f"op-{i}",
                  start_unix_nano=10**18 + i, duration_nano=1000 + i,
                  attributes={"idx": i, "ok": i % 2 == 0}) for i in range(n)]
    return Trace(trace_id=tid, batches=[({"service.name": f"svc{seed}"}, spans)])


def _record(seed, n=3):
    return otlp.encode_traces_request([_make_trace(seed, n)])


def _consume(mod, scenario, **kw):
    """Run `scenario(broker, rx)` against a fresh scripted broker with
    `mod`'s receiver: (pushes, counters, the broker's group state)."""
    broker = FakeBroker(partitions=kw.pop("partitions", 2))
    got = []
    rx = mod.KafkaReceiver(lambda traces, org_id=None: got.append((org_id, doc(traces))),
                           [broker.addr], "traces", **kw)
    try:
        polls = scenario(broker, rx)
        member = rx._member
        state = (polls, rx.records, rx.spans, rx.errors, dict(broker.committed),
                 None if member is None else (member.assignment, member.generation))
        rx.stop()
        return got, state, broker.left
    finally:
        broker.close()


def _both(scenario, **kw):
    port, jax = _consume(kafka, scenario, **dict(kw)), _consume(jkafka, scenario, **dict(kw))
    assert port == jax
    return port


def test_kafka_consumes_resumes_and_skips_duplicates():
    def scenario(broker, rx):
        broker.produce(0, [_record(1)])
        broker.produce(1, [_record(2), _record(3)], codec=kafka.CODEC_GZIP)
        first = rx.poll_once()
        again = rx.poll_once()
        broker.produce(0, [_record(4)], codec=kafka.CODEC_SNAPPY)
        return first, again, rx.poll_once(), dict(rx._offsets)

    got, (polls, records, spans, errors, _, _), _ = _both(scenario, org_id="tenant-k")
    assert polls == (3, 0, 1, {0: 2, 1: 2}) and (records, spans, errors) == (4, 12, 0)
    assert [org for org, _ in got] == ["tenant-k"] * 4


def test_kafka_bad_record_counted_and_skipped():
    def scenario(broker, rx):
        broker.produce(0, [b"\xff\xff not OTLP", _record(5)])
        return rx.poll_once(), rx.poll_once()

    got, (polls, records, _, _, _, _), _ = _both(scenario, partitions=1)
    assert polls == (2, 0) and records == 2 and len(got) == 1


def test_kafka_offset_recovery():
    def scenario(broker, rx):
        broker.base[0] = broker.log_start[0] = 5  # retention removed [0, 5)
        broker.produce(0, [_record(9)])
        first = rx.poll_once()
        broker.log_start[0] = broker.base[0] = 10  # and then the tracked offset
        broker.produce(0, [_record(7)])
        return first, rx.poll_once(), rx.errors, rx.poll_once()

    got, (polls, records, _, errors, _, _), _ = _both(scenario, partitions=1)
    assert polls == (1, 0, 1, 1) and records == 2 and errors == 1
    assert [d[0]["trace_id"] for _, d in got] == [bytes([9]) * 16, bytes([7]) * 16]


def test_kafka_group_join_commit_and_rebalance():
    def scenario(broker, rx):
        for p in (0, 1):
            broker.produce(p, [_record(p + 1)])
        first = rx.poll_once()
        assignment, gen = list(rx._member.assignment), rx._member.generation
        broker.heartbeat_err = 27  # REBALANCE_IN_PROGRESS
        second = rx.poll_once()
        broker.heartbeat_err = 0
        broker.produce(1, [_record(3)])
        return first, second, rx.poll_once(), assignment, gen, rx._member.generation

    got, (polls, records, _, errors, committed, member), left = _both(scenario, group_id="g")
    assert polls[:4] == (2, 0, 1, [0, 1]) and polls[5] >= polls[4]
    assert records == 3 and errors == 0
    assert committed == {0: 1, 1: 2} and member[0] == [0, 1] and left


def test_kafka_group_mode_rejects_a_multi_broker_cluster():
    for mod in (kafka, jkafka):
        broker = FakeBroker(partitions=1)
        real = broker._metadata

        def two_brokers(real=real, broker=broker):
            host, port = broker.addr.rsplit(":", 1)
            one = mod._str(host) + struct.pack(">i", int(port)) + mod._str(None)
            raw = real()
            rest = raw[4 + 4 + len(one):]  # after the one broker's entry
            return struct.pack(">ii", 2, 0) + one + struct.pack(">i", 1) + one + rest

        broker._metadata = two_brokers
        try:
            rx = mod.KafkaReceiver(lambda *a, **k: None, [broker.addr], "traces", group_id="g")
            with pytest.raises(ValueError, match="single-broker"):
                rx.poll_once()
            assert rx._member is None
            rx.stop()
        finally:
            broker.close()


def test_kafka_receiver_thread_against_the_scripted_broker():
    """The receiver's own thread against chip_smoke's broker (a fetch
    waits for data there, as on a real broker), for every codec the
    native library allows."""
    broker = chip_smoke.ScriptedBroker()
    got = []
    rx = kafka.KafkaReceiver(lambda traces, org_id=None: got.append(doc(traces)),
                             [broker.addr], broker.topic).start()
    try:
        codecs = [c for n, c in sorted(CODECS.items()) if n != "zstd" or native.lib() is not None]
        for i, codec in enumerate(codecs):
            broker.produce([_record(10 + i, n=4)], codec=codec)
        deadline = time.monotonic() + 30
        while rx.records < len(codecs):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert got == [doc(jotlp.decode_traces_request(_record(10 + i, n=4)))
                       for i in range(len(codecs))]
        assert rx.errors == 0 and rx.spans == 4 * len(codecs)
    finally:
        rx.stop()
        broker.close()
