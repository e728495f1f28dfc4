"""Port of tempo_tpu/receivers/protowire.py, copied as is (host code).

Minimal protobuf wire-format reader/writer.

The reference links the vendored OTel collector's generated protos
(modules/distributor/receiver/shim.go:110-133 hosts the receiver
factories; pkg/tempopb vendors the OTLP trace protos). Here the OTLP
schema is small and stable enough that a hand-rolled wire codec is
simpler than shipping generated code: ~100 lines covering varint,
fixed64/32 and length-delimited fields, used by receivers/otlp.py and
the remote-write encoder.

Wire types: 0=varint 1=fixed64 2=len 5=fixed32.
"""

from __future__ import annotations

import struct


class WireError(ValueError):
    pass


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise WireError("varint too long")


def write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def iter_fields(buf: bytes, pos: int = 0, end: int | None = None):
    """Yield (field_number, wire_type, value) 3-tuples over a message.

    value is: int for varint/fixed; bytes for len-delimited.
    """
    end = len(buf) if end is None else end
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = read_varint(buf, pos)
        elif wt == 1:
            if pos + 8 > end:
                raise WireError("truncated fixed64")
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = read_varint(buf, pos)
            if pos + ln > end:
                raise WireError("truncated bytes field")
            val = bytes(buf[pos : pos + ln])
            pos += ln
        elif wt == 5:
            if pos + 4 > end:
                raise WireError("truncated fixed32")
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise WireError(f"unsupported wire type {wt}")
        yield field, wt, val


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def signed64(v: int) -> int:
    """Interpret a varint as a signed int64 (two's complement)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def put_tag(out: bytearray, field: int, wt: int) -> None:
    write_varint(out, (field << 3) | wt)


def put_varint_field(out: bytearray, field: int, value: int) -> None:
    put_tag(out, field, 0)
    write_varint(out, value)


def put_fixed64_field(out: bytearray, field: int, value: int) -> None:
    put_tag(out, field, 1)
    out += struct.pack("<Q", value)


def put_double_field(out: bytearray, field: int, value: float) -> None:
    put_tag(out, field, 1)
    out += struct.pack("<d", value)


def put_bytes_field(out: bytearray, field: int, value: bytes) -> None:
    put_tag(out, field, 2)
    write_varint(out, len(value))
    out += value


def put_str_field(out: bytearray, field: int, value: str) -> None:
    put_bytes_field(out, field, value.encode("utf-8"))


def fixed64_to_double(v: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", v))[0]
