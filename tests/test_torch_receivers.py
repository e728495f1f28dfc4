"""The port's OTLP receivers against the JAX package's.

The same request bytes (protobuf, OTLP/JSON, gzip and deflate bodies)
go through both packages' decoders. The columnar fast path must give
equal SpanBatches column for column and dictionary for dictionary (block
bytes depend on the dictionary codes and the column order), the object
path equal Trace objects, and the encoders equal bytes; encode -> decode
round-trips the traces. Payloads are made from numpy seeds, with
resource attributes and every OTLP AnyValue type mixed in.
"""

import dataclasses
import gzip
import json
import zlib

import numpy as np
import pytest

from tempo_tpu import receivers as jreceivers
from tempo_tpu.receivers import otlp as jotlp
from tempo_tpu.receivers import protowire as jwire
from tempo_tpu_torch import receivers
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.trace import Span, Trace, batch_to_traces
from tempo_tpu_torch.receivers import otlp
from tempo_tpu_torch.receivers import protowire as wire

from test_torch_search import chain_parents

SEEDS = [0, 1, 7, 42]
T0 = 1_700_000_000


def mixed_traces(seed: int) -> list[Trace]:
    """make_batch traces plus spans carrying every AnyValue type, extra
    resource attributes and unset fields."""
    rng = np.random.default_rng(seed)
    traces = batch_to_traces(chain_parents(synth.make_batch(int(rng.integers(3, 20)), 3, seed=seed)))
    values = [True, False, -7, 2**40, 3.25, -0.0, "ü-ñ", "", [1, "a", 2.5],
              {"k": "v", "n": 3}, []]
    for t in traces[: len(traces) // 2]:
        res, spans = t.batches[0]
        t.batches[0] = ({**res, "k8s.namespace": f"ns{seed}", "host.id": int(rng.integers(0, 99))},
                        spans)
        for s in spans:
            for i in rng.choice(len(values), size=3, replace=False):
                s.attributes[f"x.{i}"] = values[i]
    tid = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    bare = Span(trace_id=tid, span_id=rng.integers(0, 256, 8, dtype=np.uint8).tobytes(),
                start_unix_nano=T0 * 10**9)
    traces.append(Trace(trace_id=tid, batches=[({"service.name": ""}, [bare])]))
    return traces


def _batch_equal(a, b):
    assert sorted(a.cols) == sorted(b.cols) and sorted(a.attrs) == sorted(b.attrs)
    for k in a.cols:
        assert a.cols[k].dtype == b.cols[k].dtype, k
        np.testing.assert_array_equal(a.cols[k], b.cols[k], err_msg=k)
    for k in a.attrs:
        assert a.attrs[k].dtype == b.attrs[k].dtype, k
        np.testing.assert_array_equal(a.attrs[k], b.attrs[k], err_msg=k)
    assert list(a.dictionary.entries) == list(b.dictionary.entries)


def _traces_doc(traces) -> list:
    return [dataclasses.asdict(t) for t in traces]


@pytest.mark.parametrize("seed", SEEDS)
def test_protobuf_columnar_equal(seed):
    body = otlp.encode_traces_request(mixed_traces(seed))
    _batch_equal(jotlp.decode_traces_request_columnar(body),
                 otlp.decode_traces_request_columnar(body))


@pytest.mark.parametrize("seed", SEEDS)
def test_json_columnar_equal(seed):
    doc = json.loads(json.dumps(otlp.encode_traces_json(mixed_traces(seed))))
    _batch_equal(jotlp.decode_traces_json_columnar(doc), otlp.decode_traces_json_columnar(doc))


@pytest.mark.parametrize("seed", SEEDS)
def test_object_decode_and_encode_equal(seed):
    traces = mixed_traces(seed)
    body = otlp.encode_traces_request(traces)
    jt, tt = jotlp.decode_traces_request(body), otlp.decode_traces_request(body)
    assert _traces_doc(jt) == _traces_doc(tt)
    assert jotlp.encode_traces_request(jt) == otlp.encode_traces_request(tt) == body
    doc = otlp.encode_traces_json(tt)
    assert jotlp.encode_traces_json(jt) == doc
    assert _traces_doc(jotlp.decode_traces_json(doc)) == _traces_doc(otlp.decode_traces_json(doc))


@pytest.mark.parametrize("seed", SEEDS)
def test_round_trip(seed):
    traces = mixed_traces(seed)
    assert _traces_doc(otlp.decode_traces_request(otlp.encode_traces_request(traces))) \
        == _traces_doc(traces)
    doc = json.loads(json.dumps(otlp.encode_traces_json(traces)))
    assert _traces_doc(otlp.decode_traces_json(doc)) == _traces_doc(traces)


@pytest.mark.parametrize("encoding,compress", [
    ("", lambda b: b), ("identity", lambda b: b), ("gzip", gzip.compress),
    ("deflate", zlib.compress),
])
@pytest.mark.parametrize("ctype", ["application/x-protobuf", "application/json; charset=utf-8"])
def test_http_dispatch_equal(encoding, compress, ctype):
    traces = mixed_traces(3)
    raw = (json.dumps(otlp.encode_traces_json(traces)).encode() if "json" in ctype
           else otlp.encode_traces_request(traces))
    body = compress(raw)
    jb = jreceivers.decompress_body(body, encoding)
    tb = receivers.decompress_body(body, encoding)
    assert jb == tb == raw
    _batch_equal(jreceivers.decode_http_columnar("/v1/traces", ctype, jb),
                 receivers.decode_http_columnar("/v1/traces", ctype, tb))
    assert _traces_doc(jreceivers.decode_http("/v1/traces", ctype, jb)) \
        == _traces_doc(receivers.decode_http("/v1/traces", ctype, tb))


def test_refusals_equal():
    for enc in ("br", "zstd"):
        with pytest.raises(jreceivers.UnsupportedPayload):
            jreceivers.decompress_body(b"x", enc)
        with pytest.raises(receivers.UnsupportedPayload):
            receivers.decompress_body(b"x", enc)
    # non-OTLP paths: no columnar decoder in either package; their object
    # decoders answer alike (an empty Zipkin list, v1's JSON carrier and
    # an unknown path refused)
    assert jreceivers.decode_http_columnar("/api/v2/spans", "application/json", b"[]") is None
    assert receivers.decode_http_columnar("/api/v2/spans", "application/json", b"[]") is None
    assert receivers.decode_http("/api/v2/spans", "application/json", b"[]") \
        == jreceivers.decode_http("/api/v2/spans", "application/json", b"[]") == []
    for path in ("/api/v1/spans", "/api/nope"):
        with pytest.raises(jreceivers.UnsupportedPayload):
            jreceivers.decode_http(path, "application/json", b"[]")
        with pytest.raises(receivers.UnsupportedPayload):
            receivers.decode_http(path, "application/json", b"[]")
    for bad in (b"\xff\xff\xff", b"\x0a\x05ab"):
        for mod in (jotlp, otlp):
            with pytest.raises(ValueError):
                mod.decode_traces_request_columnar(bad)


@pytest.mark.parametrize("v", [0, 1, 127, 128, 300, 2**32, 2**63 - 1, 2**64 - 1])
def test_protowire_varints_equal(v):
    a, b = bytearray(), bytearray()
    jwire.write_varint(a, v)
    wire.write_varint(b, v)
    assert a == b and wire.read_varint(bytes(b), 0) == jwire.read_varint(bytes(a), 0) == (v, len(b))
    assert wire.signed64(v) == jwire.signed64(v)
    assert wire.zigzag_decode(wire.zigzag_encode(-v // 2)) == -v // 2
