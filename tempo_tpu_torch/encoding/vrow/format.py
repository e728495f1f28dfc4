"""Port of tempo_tpu/encoding/vrow/format.py.

vrow1 on-disk format: records -> pages -> data object + page index.

Reference: tempodb/encoding/v2 object.go (varint id+len records),
page.go / page_header.go (CRC'd pages), index_writer.go /
index_reader.go (downsampled ID index: one entry per page with the
id range, enabling binary search). A record's payload is a serialized
single-trace SpanBatch (the same segment format the distributor ships),
so record decode reuses the columnar codec.

Page layout:  u32 crc32(comp_body) | u32 comp_len | u32 raw_len | comp_body
Record layout (inside a raw page): 16B trace id | u32 len | payload
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from tempo_tpu_torch.encoding.vtpu import format as vfmt
from tempo_tpu_torch.model.columnar import ATTR_COLUMNS, SpanBatch, _empty_cols

_PAGE_HDR = struct.Struct("<III")
_REC_HDR = struct.Struct("<16sI")


class CorruptPage(ValueError):
    pass


def encode_record(trace_id: bytes, payload: bytes) -> bytes:
    return _REC_HDR.pack(trace_id, len(payload)) + payload


def iter_records(raw_page: bytes):
    pos = 0
    n = len(raw_page)
    while pos < n:
        if pos + _REC_HDR.size > n:
            raise CorruptPage("truncated record header")
        tid, ln = _REC_HDR.unpack_from(raw_page, pos)
        pos += _REC_HDR.size
        if pos + ln > n:
            raise CorruptPage("truncated record payload")
        yield tid, raw_page[pos : pos + ln]
        pos += ln


def encode_page(records: list[bytes]) -> bytes:
    raw = b"".join(records)
    comp = zlib.compress(raw, 6)
    return _PAGE_HDR.pack(zlib.crc32(comp), len(comp), len(raw)) + comp


def decode_page(buf: bytes) -> bytes:
    if len(buf) < _PAGE_HDR.size:
        raise CorruptPage("short page header")
    crc, comp_len, raw_len = _PAGE_HDR.unpack_from(buf, 0)
    body = buf[_PAGE_HDR.size : _PAGE_HDR.size + comp_len]
    if len(body) != comp_len:
        raise CorruptPage("truncated page body")
    if zlib.crc32(body) != crc:
        raise CorruptPage("page crc mismatch")
    raw = zlib.decompress(body)
    if len(raw) != raw_len:
        raise CorruptPage("page raw length mismatch")
    return raw


class PageEntry:
    """One downsampled index entry (reference: v2 Record types.go:13)."""

    __slots__ = ("min_id", "max_id", "offset", "length", "n_records", "start_s", "end_s")

    def __init__(self, min_id="", max_id="", offset=0, length=0, n_records=0,
                 start_s=0, end_s=0):
        self.min_id = min_id
        self.max_id = max_id
        self.offset = offset
        self.length = length
        self.n_records = n_records
        self.start_s = start_s
        self.end_s = end_s

    def to_dict(self):
        return {s: getattr(self, s) for s in self.__slots__}


class PageIndex:
    def __init__(self, pages: list[PageEntry] | None = None):
        self.pages = pages or []

    def to_bytes(self) -> bytes:
        return json.dumps({"pages": [p.to_dict() for p in self.pages]}).encode()

    @staticmethod
    def from_bytes(raw: bytes) -> "PageIndex":
        doc = json.loads(raw)
        return PageIndex([PageEntry(**p) for p in doc["pages"]])

    def find_pages(self, hex_id: str) -> list[int]:
        """Binary search for pages whose [min_id, max_id] covers hex_id
        (reference: v2 finder_paged.go:14)."""
        pages = self.pages
        lo, hi = 0, len(pages)
        while lo < hi:
            mid = (lo + hi) // 2
            if pages[mid].max_id < hex_id:
                lo = mid + 1
            else:
                hi = mid
        out = []
        while lo < len(pages) and pages[lo].min_id <= hex_id:
            if pages[lo].max_id >= hex_id:
                out.append(lo)
            lo += 1
        return out


def trace_records(batch, bounds: list[int]):
    """(trace id, record) of each trace [bounds[i], bounds[i+1]) of a
    trace-sorted batch, in time linear in the batch. The record is the
    one the reference's select of the trace's rows makes: select keeps
    the trace's attributes in their order and stable-sorts them by span,
    which is what one stable sort of the whole batch's attributes by
    span, cut by slices, gives. The dictionary is serialized once."""
    attrs_all = batch.attrs
    if batch.num_attrs:
        order = np.argsort(attrs_all["attr_span"], kind="stable")
        attrs_all = {k: v[order] for k, v in attrs_all.items()}
        attr_span = attrs_all["attr_span"]
        a_bounds = np.searchsorted(attr_span, np.asarray(bounds, dtype=attr_span.dtype))
    dict_bytes = vfmt.serialize_dictionary(batch.dictionary)
    tids = batch.cols["trace_id"]
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        cols = {k: v[lo:hi] for k, v in batch.cols.items()}
        if batch.num_attrs:
            a_lo, a_hi = int(a_bounds[i]), int(a_bounds[i + 1])
            attrs = {k: v[a_lo:a_hi] for k, v in attrs_all.items()}
            attrs["attr_span"] = (attr_span[a_lo:a_hi].astype(np.int64) - lo).astype(np.uint32)
        else:
            attrs = _empty_cols(ATTR_COLUMNS)
        sub = SpanBatch(cols=cols, attrs=attrs, dictionary=batch.dictionary)
        tid = tids[lo].astype(">u4").tobytes()
        yield tid, encode_record(tid, vfmt.serialize_batch(sub, dict_bytes=dict_bytes))


def decode_record_payload(payload: bytes):
    return vfmt.deserialize_batch(payload)
