"""Port of tempo_tpu/util/snappy.py, copied as is (host code).

Minimal snappy block-format codec (pure python).

Prometheus remote-write mandates snappy-compressed protobuf bodies
(the reference gets this via golang/snappy inside
prometheus/storage/remote, used by modules/generator/storage). This is
a compliant encoder/decoder for the *block* format (not the framing
format): varint preamble with the uncompressed length, then a tag
stream of literals and copies.

The encoder is a greedy 4-byte-hash matcher in the spirit of the C++
reference implementation — real compression, wire-compatible with any
standard snappy decoder. Throughput is control-plane-grade; metric
batches are small (KBs per send).
"""

from __future__ import annotations

_TAG_LITERAL = 0
_TAG_COPY1 = 1  # 1-byte offset-extra copy: len 4-11, offset < 2048
_TAG_COPY2 = 2  # 2-byte offset copy
_TAG_COPY4 = 3  # 4-byte offset copy


def _put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("snappy: truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise ValueError("snappy: varint too long")


def _emit_literal(out: bytearray, data: bytes, start: int, end: int) -> None:
    n = end - start
    if n <= 0:
        return
    n -= 1
    if n < 60:
        out.append(n << 2 | _TAG_LITERAL)
    elif n < 1 << 8:
        out.append(60 << 2 | _TAG_LITERAL)
        out.append(n)
    elif n < 1 << 16:
        out.append(61 << 2 | _TAG_LITERAL)
        out += n.to_bytes(2, "little")
    elif n < 1 << 24:
        out.append(62 << 2 | _TAG_LITERAL)
        out += n.to_bytes(3, "little")
    else:
        out.append(63 << 2 | _TAG_LITERAL)
        out += n.to_bytes(4, "little")
    out += data[start:end]


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # long copies split into <=64-byte chunks (format limit for copy2)
    while length > 0:
        if 4 <= length <= 11 and offset < 2048:
            out.append(((offset >> 8) << 5) | ((length - 4) << 2) | _TAG_COPY1)
            out.append(offset & 0xFF)
            return
        n = min(length, 64)
        if length - n < 4 and length > 64:  # don't strand a <4-byte tail
            n = length - 4
        out.append((n - 1) << 2 | _TAG_COPY2)
        out += offset.to_bytes(2, "little")
        length -= n


def compress(data: bytes) -> bytes:
    out = bytearray()
    _put_varint(out, len(data))
    n = len(data)
    if n == 0:
        return bytes(out)
    if n < 16:
        _emit_literal(out, data, 0, n)
        return bytes(out)

    table: dict[bytes, int] = {}
    i = 0
    lit_start = 0
    limit = n - 4
    while i <= limit:
        key = data[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and data[cand : cand + 4] == key:
            # extend the match
            m = 4
            while i + m < n and data[cand + m] == data[i + m]:
                m += 1
            _emit_literal(out, data, lit_start, i)
            _emit_copy(out, i - cand, m)
            i += m
            lit_start = i
        else:
            i += 1
    _emit_literal(out, data, lit_start, n)
    return bytes(out)


def decompress(data: bytes) -> bytes:
    want, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == _TAG_LITERAL:
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                if pos + extra > n:
                    raise ValueError("snappy: truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > n:
                raise ValueError("snappy: truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == _TAG_COPY1:
            length = ((tag >> 2) & 0x07) + 4
            if pos >= n:
                raise ValueError("snappy: truncated copy1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == _TAG_COPY2:
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise ValueError("snappy: truncated copy2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise ValueError("snappy: truncated copy4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: bad copy offset")
        # overlapping copies are byte-at-a-time by definition
        for _ in range(length):
            out.append(out[-offset])
    if len(out) != want:
        raise ValueError(f"snappy: length mismatch (got {len(out)}, want {want})")
    return bytes(out)
