"""Port of tempo_tpu/receivers/jaeger.py, copied as is (host code).

Jaeger thrift-binary receiver codec.

Decodes the jaeger.thrift `Batch` struct (the POST /api/traces
payload accepted on the collector HTTP port, and the unit the reference's
hosted jaegerreceiver consumes — modules/distributor/receiver/shim.go:117-128
enables thrift_http among the Jaeger variants). Implements just enough
of the Thrift binary protocol (strict or lax struct reading: field
headers, the container types used by the schema) — no thrift runtime in
the image.

jaeger.thrift schema (public):
  Batch   {1: Process process, 2: list<Span> spans}
  Process {1: string serviceName, 2: list<Tag> tags}
  Span    {1: i64 traceIdLow, 2: i64 traceIdHigh, 3: i64 spanId,
           4: i64 parentSpanId, 5: string operationName,
           6: list<SpanRef> references, 7: i32 flags, 8: i64 startTime,
           9: i64 duration, 10: list<Tag> tags, 11: list<Log> logs}
  Tag     {1: string key, 2: TagType vType, 3: string vStr,
           4: double vDouble, 5: bool vBool, 6: i64 vLong, 7: binary vBinary}
TagType: STRING=0 DOUBLE=1 BOOL=2 LONG=3 BINARY=4.
Timestamps/durations are microseconds.
"""

from __future__ import annotations

import struct

from tempo_tpu_torch.model.trace import KIND_CLIENT, KIND_CONSUMER, KIND_PRODUCER, KIND_SERVER, Span, Trace

# thrift binary TTypes
T_STOP = 0
T_BOOL = 2
T_BYTE = 3
T_DOUBLE = 4
T_I16 = 6
T_I32 = 8
T_I64 = 10
T_STRING = 11
T_STRUCT = 12
T_MAP = 13
T_SET = 14
T_LIST = 15


class ThriftError(ValueError):
    pass


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ThriftError("truncated thrift payload")
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def double(self) -> float:
        return struct.unpack(">d", self._take(8))[0]

    def binary(self) -> bytes:
        n = self.i32()
        if n < 0:
            raise ThriftError("negative string length")
        return self._take(n)

    def skip(self, ttype: int) -> None:
        if ttype in (T_BOOL, T_BYTE):
            self._take(1)
        elif ttype == T_I16:
            self._take(2)
        elif ttype == T_I32:
            self._take(4)
        elif ttype in (T_I64, T_DOUBLE):
            self._take(8)
        elif ttype == T_STRING:
            self.binary()
        elif ttype == T_STRUCT:
            while True:
                ft = self.i8()
                if ft == T_STOP:
                    return
                self.i16()
                self.skip(ft)
        elif ttype in (T_LIST, T_SET):
            et = self.i8()
            n = self.i32()
            for _ in range(n):
                self.skip(et)
        elif ttype == T_MAP:
            kt, vt = self.i8(), self.i8()
            n = self.i32()
            for _ in range(n):
                self.skip(kt)
                self.skip(vt)
        else:
            raise ThriftError(f"unknown ttype {ttype}")

    def fields(self):
        """Yield (field_id, ttype) for one struct; caller must consume
        each field's value (or call skip)."""
        while True:
            ft = self.i8()
            if ft == T_STOP:
                return
            fid = self.i16()
            yield fid, ft

    def list_header(self, want: int) -> int:
        et = self.i8()
        n = self.i32()
        if et != want:
            raise ThriftError(f"list elem type {et} != {want}")
        if n < 0:
            raise ThriftError("negative list length")
        return n

    def read_bool(self) -> bool:
        return self.i8() != 0


class _CompactReader:
    """Thrift COMPACT protocol reader exposing the same interface as
    _Reader, with field/list types normalized to the binary T_*
    constants so the struct decoders are protocol-agnostic. This is the
    UDP agent wire format on port 6831 (jaeger clients' default).

    Compact encoding: zigzag varints for i16/i32/i64, field headers as
    (delta<<4)|ctype with bool values folded into the type nibble,
    short-form list headers, little-endian doubles (the byte order
    jaeger's thrift emits)."""

    # compact type nibble -> binary T_* (BOOL_TRUE=1 / BOOL_FALSE=2)
    _CTYPES = {1: T_BOOL, 2: T_BOOL, 3: T_BYTE, 4: T_I16, 5: T_I32,
               6: T_I64, 7: T_DOUBLE, 8: T_STRING, 9: T_LIST,
               10: T_SET, 11: T_MAP, 12: T_STRUCT}

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos
        self._bool_value = False  # set by fields() for T_BOOL fields

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ThriftError("truncated thrift payload")
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def _uvarint(self) -> int:
        u = shift = 0
        while True:
            b = self._take(1)[0]
            u |= (b & 0x7F) << shift
            if not b & 0x80:
                return u
            shift += 7
            if shift > 70:
                raise ThriftError("varint too long")

    def _zigzag(self) -> int:
        u = self._uvarint()
        return (u >> 1) ^ -(u & 1)

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return self._zigzag()

    def i32(self) -> int:
        return self._zigzag()

    def i64(self) -> int:
        return self._zigzag()

    def double(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def binary(self) -> bytes:
        n = self._uvarint()
        return self._take(n)

    def read_bool(self) -> bool:
        return self._bool_value

    def fields(self):
        """Yield (field_id, normalized ttype) for one struct; bool field
        values ride in the type nibble and are stashed for read_bool()."""
        last_fid = 0
        while True:
            b = self._take(1)[0]
            if b == 0:
                return
            delta = (b >> 4) & 0x0F
            ctype = b & 0x0F
            fid = last_fid + delta if delta else self._zigzag()
            last_fid = fid
            norm = self._CTYPES.get(ctype)
            if norm is None:
                raise ThriftError(f"unknown compact type {ctype}")
            if norm == T_BOOL:
                self._bool_value = ctype == 1
            yield fid, norm

    def list_header(self, want: int) -> int:
        b = self._take(1)[0]
        n = (b >> 4) & 0x0F
        ctype = b & 0x0F
        if n == 15:
            n = self._uvarint()
        norm = self._CTYPES.get(ctype)
        if norm != want:
            raise ThriftError(f"list elem type {norm} != {want}")
        return n

    def skip(self, ttype: int) -> None:
        if ttype == T_BOOL:
            return  # value lived in the field-type nibble
        if ttype == T_BYTE:
            self._take(1)
        elif ttype in (T_I16, T_I32, T_I64):
            self._zigzag()
        elif ttype == T_DOUBLE:
            self._take(8)
        elif ttype == T_STRING:
            self.binary()
        elif ttype == T_STRUCT:
            for _fid, ft in self.fields():
                self.skip(ft)
        elif ttype in (T_LIST, T_SET):
            b = self._take(1)[0]
            n = (b >> 4) & 0x0F
            ctype = b & 0x0F
            if n == 15:
                n = self._uvarint()
            et = self._CTYPES.get(ctype, -1)
            for _ in range(n):
                if et == T_BOOL:
                    self._take(1)  # list bools are one byte each
                else:
                    self.skip(et)
        elif ttype == T_MAP:
            n = self._uvarint()
            if n:
                kv = self._take(1)[0]
                kt = self._CTYPES.get((kv >> 4) & 0x0F, -1)
                vt = self._CTYPES.get(kv & 0x0F, -1)
                for _ in range(n):
                    self.skip(kt)
                    self.skip(vt)
        else:
            raise ThriftError(f"unknown ttype {ttype}")


def _read_tag(r):
    key, vtype = "", 0
    vstr, vdouble, vbool, vlong, vbin = "", 0.0, False, 0, b""
    for fid, ft in r.fields():
        if fid == 1 and ft == T_STRING:
            key = r.binary().decode("utf-8", "replace")
        elif fid == 2 and ft == T_I32:
            vtype = r.i32()
        elif fid == 3 and ft == T_STRING:
            vstr = r.binary().decode("utf-8", "replace")
        elif fid == 4 and ft == T_DOUBLE:
            vdouble = r.double()
        elif fid == 5 and ft == T_BOOL:
            vbool = r.read_bool()
        elif fid == 6 and ft == T_I64:
            vlong = r.i64()
        elif fid == 7 and ft == T_STRING:
            vbin = r.binary()
        else:
            r.skip(ft)
    value = {0: vstr, 1: vdouble, 2: vbool, 3: vlong, 4: vbin.hex()}.get(vtype, vstr)
    return key, value


_SPAN_KIND_TAG = {
    "client": KIND_CLIENT,
    "server": KIND_SERVER,
    "producer": KIND_PRODUCER,
    "consumer": KIND_CONSUMER,
}


def _read_span(r: _Reader) -> Span:
    tid_low = tid_high = span_id = parent = 0
    name = ""
    start_us = dur_us = 0
    tags: dict = {}
    for fid, ft in r.fields():
        if fid == 1 and ft == T_I64:
            tid_low = r.i64() & (2**64 - 1)
        elif fid == 2 and ft == T_I64:
            tid_high = r.i64() & (2**64 - 1)
        elif fid == 3 and ft == T_I64:
            span_id = r.i64() & (2**64 - 1)
        elif fid == 4 and ft == T_I64:
            parent = r.i64() & (2**64 - 1)
        elif fid == 5 and ft == T_STRING:
            name = r.binary().decode("utf-8", "replace")
        elif fid == 8 and ft == T_I64:
            start_us = r.i64()
        elif fid == 9 and ft == T_I64:
            dur_us = r.i64()
        elif fid == 10 and ft == T_LIST:
            for _ in range(r.list_header(T_STRUCT)):
                k, v = _read_tag(r)
                if k:
                    tags[k] = v
        else:
            r.skip(ft)
    kind = _SPAN_KIND_TAG.get(str(tags.pop("span.kind", "")).lower(), 0)
    status = 2 if tags.get("error") in (True, "true") else 0
    return Span(
        trace_id=struct.pack(">QQ", tid_high, tid_low),
        span_id=struct.pack(">Q", span_id),
        parent_span_id=struct.pack(">Q", parent),
        name=name,
        start_unix_nano=start_us * 1000,
        duration_nano=max(0, dur_us) * 1000,
        kind=kind,
        status_code=status,
        attributes=tags,
    )


def decode_batch(buf: bytes) -> list[Trace]:
    """Decode one thrift-binary jaeger Batch into Traces."""
    return _decode_batch_struct(_Reader(buf))


def _decode_batch_struct(r) -> list[Trace]:
    service = ""
    process_tags: dict = {}
    spans: list[Span] = []
    for fid, ft in r.fields():
        if fid == 1 and ft == T_STRUCT:  # Process
            for pfid, pft in r.fields():
                if pfid == 1 and pft == T_STRING:
                    service = r.binary().decode("utf-8", "replace")
                elif pfid == 2 and pft == T_LIST:
                    for _ in range(r.list_header(T_STRUCT)):
                        k, v = _read_tag(r)
                        if k:
                            process_tags[k] = v
                else:
                    r.skip(pft)
        elif fid == 2 and ft == T_LIST:
            for _ in range(r.list_header(T_STRUCT)):
                spans.append(_read_span(r))
        else:
            r.skip(ft)
    resource = {"service.name": service, **process_tags}
    per_trace: dict[bytes, Trace] = {}
    for s in spans:
        t = per_trace.setdefault(s.trace_id, Trace(trace_id=s.trace_id))
        if not t.batches:
            t.batches.append((dict(resource), []))
        t.batches[0][1].append(s)
    return list(per_trace.values())


# ---------------------------------------------------------------------------
# UDP agent envelopes (ports 6831 compact / 6832 binary)
# ---------------------------------------------------------------------------
#
# Each datagram is one thrift MESSAGE calling Agent.emitBatch:
#   compact: 0x82 | (msgtype<<5)|version | name varint-str | seqid uvarint
#   binary (strict): i32 0x80010000|msgtype | name i32-str | i32 seqid
# args struct: {1: Batch batch}. Reference: the jaegerreceiver hosts all
# four protocol variants (modules/distributor/receiver/shim.go:111).

_COMPACT_PROTOCOL_ID = 0x82
_BINARY_VERSION_MASK = 0xFFFF0000
_BINARY_VERSION_1 = 0x80010000


def decode_agent_datagram(buf: bytes) -> list[Trace]:
    """One UDP agent datagram (auto-detects compact vs binary) ->
    Traces."""
    if not buf:
        raise ThriftError("empty datagram")
    if buf[0] == _COMPACT_PROTOCOL_ID:
        r = _CompactReader(buf, 2)  # skip protocol id + (type|version)
        r._uvarint()  # seqid precedes the name in compact messages
        name = r.binary().decode("utf-8", "replace")
    else:
        r0 = _Reader(buf)
        ver = r0.i32() & 0xFFFFFFFF
        if (ver & _BINARY_VERSION_MASK) != (_BINARY_VERSION_1 & _BINARY_VERSION_MASK):
            raise ThriftError(f"unrecognized agent message version {ver:#x}")
        name = r0.binary().decode("utf-8", "replace")
        r0.i32()  # seqid
        r = r0
    if name != "emitBatch":
        raise ThriftError(f"unexpected agent method {name!r}")
    traces: list[Trace] = []
    for fid, ft in r.fields():  # the args struct
        if fid == 1 and ft == T_STRUCT:
            traces = _decode_batch_struct(r)
        else:
            r.skip(ft)
    return traces


# ---------------------------------------------------------------------------
# compact writer (tests + the vulture's agent-mode producer)
# ---------------------------------------------------------------------------


class _CompactWriter:
    def __init__(self):
        self.out = bytearray()

    def _uvarint(self, u: int) -> None:
        while True:
            b = u & 0x7F
            u >>= 7
            if u:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def _zigzag(self, v: int) -> None:
        self._uvarint((v << 1) ^ (v >> 63))

    def field(self, last_fid: int, fid: int, ctype: int) -> int:
        delta = fid - last_fid
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ctype)
        else:
            self.out.append(ctype)
            self._zigzag(fid)
        return fid

    def stop(self) -> None:
        self.out.append(0)

    def binary(self, b: bytes) -> None:
        self._uvarint(len(b))
        self.out += b

    def list_header(self, n: int, ctype: int) -> None:
        if n < 15:
            self.out.append((n << 4) | ctype)
        else:
            self.out.append(0xF0 | ctype)
            self._uvarint(n)


# compact type nibbles for the writer
_C_BOOL_TRUE, _C_BOOL_FALSE, _C_I32, _C_I64 = 1, 2, 5, 6
_C_DOUBLE, _C_BINARY, _C_LIST, _C_STRUCT = 7, 8, 9, 12


def _write_tag_compact(w: _CompactWriter, key: str, value) -> None:
    last = w.field(0, 1, _C_BINARY)
    w.binary(key.encode())
    if isinstance(value, bool):
        vtype, payload = 2, ("bool", value)
    elif isinstance(value, int):
        vtype, payload = 3, ("i64", value)
    elif isinstance(value, float):
        vtype, payload = 1, ("double", value)
    else:
        vtype, payload = 0, ("str", str(value))
    last = w.field(last, 2, _C_I32)
    w._zigzag(vtype)
    kind, v = payload
    if kind == "str":
        last = w.field(last, 3, _C_BINARY)
        w.binary(v.encode())
    elif kind == "double":
        last = w.field(last, 4, _C_DOUBLE)
        w.out += struct.pack("<d", v)
    elif kind == "bool":
        last = w.field(last, 5, _C_BOOL_TRUE if v else _C_BOOL_FALSE)
    else:
        last = w.field(last, 6, _C_I64)
        w._zigzag(v)
    w.stop()


def encode_agent_batch_compact(service: str, spans: list[Span],
                               process_tags: dict | None = None,
                               seqid: int = 0) -> bytes:
    """One compact-protocol emitBatch datagram (what a jaeger client
    sends to agent port 6831)."""
    w = _CompactWriter()
    w.out.append(_COMPACT_PROTOCOL_ID)
    w.out.append((4 << 5) | 1)  # ONEWAY, version 1
    w._uvarint(seqid)  # seqid BEFORE the name (thrift compact message)
    w.binary(b"emitBatch")
    # args struct {1: Batch}
    w.field(0, 1, _C_STRUCT)
    # Batch {1: Process, 2: list<Span>}
    last = w.field(0, 1, _C_STRUCT)
    pl = w.field(0, 1, _C_BINARY)
    w.binary(service.encode())
    if process_tags:
        pl = w.field(pl, 2, _C_LIST)
        w.list_header(len(process_tags), _C_STRUCT)
        for k, v in process_tags.items():
            _write_tag_compact(w, k, v)
    w.stop()  # Process
    last = w.field(last, 2, _C_LIST)
    w.list_header(len(spans), _C_STRUCT)
    for s in spans:
        sl = 0
        tid_high, tid_low = struct.unpack(">QQ", s.trace_id.rjust(16, b"\x00"))
        (sid,) = struct.unpack(">Q", s.span_id.rjust(8, b"\x00"))
        (psid,) = struct.unpack(">Q", (s.parent_span_id or b"").rjust(8, b"\x00"))

        def signed(u):
            return u - (1 << 64) if u >= (1 << 63) else u

        sl = w.field(sl, 1, _C_I64); w._zigzag(signed(tid_low))
        sl = w.field(sl, 2, _C_I64); w._zigzag(signed(tid_high))
        sl = w.field(sl, 3, _C_I64); w._zigzag(signed(sid))
        sl = w.field(sl, 4, _C_I64); w._zigzag(signed(psid))
        sl = w.field(sl, 5, _C_BINARY); w.binary(s.name.encode())
        sl = w.field(sl, 7, _C_I32); w._zigzag(1)  # flags: sampled
        sl = w.field(sl, 8, _C_I64); w._zigzag(s.start_unix_nano // 1000)
        sl = w.field(sl, 9, _C_I64); w._zigzag(s.duration_nano // 1000)
        attrs = dict(s.attributes or {})
        kind_name = {KIND_SERVER: "server", KIND_CLIENT: "client",
                     KIND_PRODUCER: "producer", KIND_CONSUMER: "consumer"}.get(s.kind)
        if kind_name:
            attrs["span.kind"] = kind_name
        if s.status_code == 2:
            attrs["error"] = True
        if attrs:
            sl = w.field(sl, 10, _C_LIST)
            w.list_header(len(attrs), _C_STRUCT)
            for k, v in attrs.items():
                _write_tag_compact(w, k, v)
        w.stop()  # Span
    w.stop()  # Batch
    w.stop()  # args
    return bytes(w.out)
