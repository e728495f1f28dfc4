"""Port of tempo_tpu/encoding/vtpu/format.py, copied as is (host code).

On-disk format: row groups, block index, dictionary, batch segments.

Layout of data.bin: concatenation of row groups; each row group is a
concatenation of column pages (one per span column, then one per attr
column). index.json (gzip) records absolute (offset, length, crc) per
page, so readers issue ranged GETs for exactly the columns a query
touches (reference analog: parquet column chunk offsets +
tempodb/backend ContextReader ranged reads).

Row groups always end at trace boundaries (a trace never spans row
groups), mirroring vParquet's trace-per-row invariant so per-row-group
min/max trace ID pruning is exact.

`serialize_batch`/`deserialize_batch` is the standalone segment form
(WAL segments, distributor->ingester pushes): a self-contained header +
pages + its own dictionary.
"""

from __future__ import annotations

import gzip
import json
import struct
from dataclasses import dataclass, field

import numpy as np

from tempo_tpu_torch.encoding.vtpu import codec as codec_mod
from tempo_tpu_torch.model.columnar import ATTR_COLUMNS, SPAN_COLUMNS, Dictionary, SpanBatch

MAGIC = b"VTPU1\x00"


def id_to_hex(limbs: np.ndarray) -> str:
    return np.asarray(limbs, dtype=np.uint32).astype(">u4").tobytes().hex()


def hex_to_limbs(h: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(h.rjust(32, "0")), dtype=">u4").astype(np.uint32)


@dataclass
class PageMeta:
    offset: int  # absolute into data.bin
    length: int
    dtype: str
    shape: tuple
    codec: str
    crc: int

    def to_json(self):
        return [self.offset, self.length, self.dtype, list(self.shape), self.codec, self.crc]

    @staticmethod
    def from_json(v):
        return PageMeta(v[0], v[1], v[2], tuple(v[3]), v[4], v[5])


# zone-map columns (reference analog: parquet ColumnIndex min/max pages
# that vParquet's search prunes on, tempodb/encoding/vparquet ColumnIndex
# usage). Numeric columns carry [min, max]; dictionary-coded columns
# carry the SET of codes present (small sets only — a set near the
# dictionary size prunes nothing and bloats the index).
STATS_NUMERIC = ("start_unix_nano", "duration_nano", "status_code", "http_status")
STATS_CODES = ("name", "service", "http_method", "http_url", "attr_key")
MAX_STAT_CODES = 256


def compute_stats(cols: dict) -> dict:
    """Zone-map stats for whichever stats columns appear in `cols`.

    {col: [min, max]} for numeric columns, {col: sorted code list} for
    dictionary columns. A column with too many distinct codes is OMITTED
    (absence = unknown = never prune), never truncated — a partial code
    set would prune row groups that actually match.
    """
    out: dict = {}
    for name in STATS_NUMERIC:
        arr = cols.get(name)
        if arr is not None and len(arr):
            out[name] = [int(arr.min()), int(arr.max())]
    for name in STATS_CODES:
        arr = cols.get(name)
        if arr is not None and len(arr):
            codes = np.unique(arr)
            if len(codes) <= MAX_STAT_CODES:
                out[name] = [int(c) for c in codes]
    # root_first: root resolution degenerates to "first row of the
    # trace" for EVERY trace of this row group — either the first row
    # IS a root (parent id zero) or the trace has no root row at all
    # (both cases resolve to the first-row fallback). The run-space hit
    # collector then finds root rows with zero parent-column reads;
    # false/absent falls back to the parent scan. Recorded only when
    # true (absence = unknown, like all stats).
    tid = cols.get("trace_id")
    par = cols.get("parent_span_id")
    if tid is not None and par is not None and len(tid):
        new = np.ones(len(tid), bool)
        new[1:] = (tid[1:] != tid[:-1]).any(axis=1)
        is_root = (par == 0).all(axis=1)
        seg = np.cumsum(new) - 1
        has_root = np.zeros(int(seg[-1]) + 1, bool)
        np.logical_or.at(has_root, seg[is_root], True)
        if bool((~has_root | is_root[new]).all()):
            out["root_first"] = True
    return out


@dataclass
class RowGroupMeta:
    n_spans: int
    n_attrs: int
    min_id: str  # hex, inclusive
    max_id: str
    start_s: int
    end_s: int
    n_traces: int = 0
    pages: dict = field(default_factory=dict)  # column name -> PageMeta
    # zone maps: column -> [min, max] | [codes...]; {} on blocks written
    # before stats existed (readers must treat absence as "unknown")
    stats: dict = field(default_factory=dict)
    # step-partial downsampling tier (standing/rules.py): rule name ->
    # {"series": [keys], "step": s, "q": query}; the count table itself
    # is an ordinary page in `pages` under the reserved "__sp." prefix.
    # {} on blocks written before the tier existed (absence = evaluate
    # the spans, never wrong)
    partials: dict = field(default_factory=dict)

    def to_json(self):
        d = {
            "n_spans": self.n_spans,
            "n_attrs": self.n_attrs,
            "min_id": self.min_id,
            "max_id": self.max_id,
            "start_s": self.start_s,
            "end_s": self.end_s,
            "n_traces": self.n_traces,
            "pages": {k: v.to_json() for k, v in self.pages.items()},
        }
        if self.stats:
            d["stats"] = self.stats
        if self.partials:
            d["partials"] = self.partials
        return d

    @staticmethod
    def from_json(d):
        return RowGroupMeta(
            n_spans=d["n_spans"],
            n_attrs=d["n_attrs"],
            min_id=d["min_id"],
            max_id=d["max_id"],
            start_s=d["start_s"],
            end_s=d["end_s"],
            n_traces=d.get("n_traces", 0),
            pages={k: PageMeta.from_json(v) for k, v in d["pages"].items()},
            stats=d.get("stats", {}),
            partials=d.get("partials", {}),
        )


@dataclass
class BlockIndex:
    row_groups: list = field(default_factory=list)  # list[RowGroupMeta]

    def to_bytes(self) -> bytes:
        return gzip.compress(json.dumps({"row_groups": [r.to_json() for r in self.row_groups]}).encode())

    @staticmethod
    def from_bytes(raw: bytes) -> "BlockIndex":
        d = json.loads(gzip.decompress(raw))
        return BlockIndex(row_groups=[RowGroupMeta.from_json(r) for r in d["row_groups"]])


def serialize_dictionary(d: Dictionary) -> bytes:
    return gzip.compress(json.dumps(d.entries).encode())


def deserialize_dictionary(raw: bytes) -> Dictionary:
    return Dictionary(json.loads(gzip.decompress(raw)))


def serialize_row_group(batch: SpanBatch, lo: int, hi: int, base_offset: int,
                        codec: str, device, staging=None) -> tuple[bytes, RowGroupMeta]:
    """Serialize span rows [lo:hi) (and their attrs) as one row group.

    Row indices in the attr pages are rebased to the row group start so
    each row group decodes standalone. `device` is the writer's: where
    the device page encode is on, the row group's lightweight pages are
    encoded there in one dispatch (codec.encode_lightweight, through the
    writer's `staging`).
    """
    codec = codec_mod.resolve_codec(codec)
    n = hi - lo
    # attr_span is sorted by construction (pages store attrs in owner
    # order; select/concat preserve it), so the row group's attrs are a
    # contiguous slice found by binary search
    owner = batch.attrs["attr_span"]
    a_lo, a_hi = np.searchsorted(owner, [lo, hi])

    cols: list[tuple[str, np.ndarray]] = []
    for name in SPAN_COLUMNS:
        cols.append((name, batch.cols[name][lo:hi]))
    for name in ATTR_COLUMNS:
        arr = batch.attrs[name][a_lo:a_hi]
        if name == "attr_span":
            arr = (arr - np.uint32(lo)).astype(np.uint32)
        cols.append((name, arr))

    # column pages compress in parallel on the codec pool (the native
    # codec releases the GIL), then assemble in deterministic order.
    # Each column picks its own codec: the lightweight tier (rle/dbp)
    # when the data's run/delta structure earns it, else `codec`. With
    # the device arm on, the lightweight pages wait for one batched
    # dispatch below.
    arm = codec_mod.device_arm(device)

    def enc_one(c):
        name, arr = c
        chosen = codec_mod.choose_codec(name, arr, codec)
        if arm and chosen in codec_mod.LIGHTWEIGHT_CODECS:
            return None, codec_mod.raw_crc(arr), chosen
        page, crc = codec_mod.encode(arr, chosen, device)
        return page, crc, chosen

    encoded = codec_mod.map_pages(enc_one, cols)
    light = [i for i, (page, _, _) in enumerate(encoded) if page is None]
    for i, page in zip(light, codec_mod.encode_lightweight(
            [(cols[i][1], encoded[i][2]) for i in light], device, staging)):
        encoded[i] = (page,) + encoded[i][1:]
    payload = bytearray()
    pages: dict[str, PageMeta] = {}
    for (name, arr), (page, crc, chosen) in zip(cols, encoded):
        pages[name] = PageMeta(
            offset=base_offset + len(payload),
            length=len(page),
            dtype=arr.dtype.str,
            shape=tuple(arr.shape),
            codec=chosen,
            crc=crc,
        )
        payload.extend(page)

    t = batch.cols["trace_id"]
    start = int(batch.cols["start_unix_nano"][lo:hi].min()) // 10**9 if n else 0
    end_nano = (batch.cols["start_unix_nano"][lo:hi] + batch.cols["duration_nano"][lo:hi]).max() if n else 0
    tid = t[lo:hi]
    n_traces = int((tid[1:] != tid[:-1]).any(axis=1).sum()) + 1 if n else 0
    meta = RowGroupMeta(
        n_spans=n,
        n_attrs=int(a_hi - a_lo),
        min_id=id_to_hex(t[lo]),
        max_id=id_to_hex(t[hi - 1]),
        start_s=start,
        end_s=int(end_nano) // 10**9 + 1 if n else 0,
        n_traces=n_traces,
        pages=pages,
        stats=compute_stats(dict(cols)),
    )
    return bytes(payload), meta


def rg_byte_span(rg: RowGroupMeta) -> tuple[int, int]:
    """[lo, hi) absolute byte span of one row group's pages in data.bin.

    Pages of a row group are written contiguously (serialize_row_group
    and the relocation writer both lay them back to back), so the span
    is exactly the row group's own bytes — one ranged read covers every
    page of the group.
    """
    if not rg.pages:
        return 0, 0
    lo = min(p.offset for p in rg.pages.values())
    hi = max(p.offset + p.length for p in rg.pages.values())
    return lo, hi


def read_row_group_pages(reader, rg: RowGroupMeta) -> dict[str, bytes]:
    """Raw (still-compressed) page bytes of every column of one row
    group, fetched with a single ranged read — the zero-decode
    relocation path's input (no codec work happens here)."""
    lo, hi = rg_byte_span(rg)
    # memoryview: per-page slices stay zero-copy — the relocation path's
    # only memcpy should be the writer's payload append
    raw = memoryview(reader(lo, hi - lo)) if hi > lo else memoryview(b"")
    return {
        name: raw[pm.offset - lo : pm.offset - lo + pm.length]
        for name, pm in rg.pages.items()
    }


def decode_page(page: bytes, pm: PageMeta) -> np.ndarray:
    """Decode one already-fetched page (relocation guard + lazy gather
    decode straight from the bytes of read_row_group_pages — no second
    backend read)."""
    return codec_mod.decode(page, pm.dtype, pm.shape, pm.codec, pm.crc)


# gap tolerance for coalesced page reads: a second backend round trip
# (object-store GET latency ~10ms) costs far more than over-reading this
# many bytes inside one ranged GET
COALESCE_MAX_GAP = 128 << 10


def plan_page_runs(rg: RowGroupMeta, names, max_gap: int = COALESCE_MAX_GAP):
    """Group the pages of `names` into gap-tolerant byte runs.

    Pages of a row group are contiguous in data.bin, so pages of a
    column subset are separated only by the unneeded columns between
    them; runs whose gaps stay under max_gap merge into one ranged read.
    Returns [(lo, hi, [name, ...]), ...] sorted by offset.

    Run-building REQUIRES offset order, which neither `names` nor the
    rg.pages dict guarantees (relocation/reencode mixes interleave the
    page layout vs the schema order) — so pages are explicitly sorted by
    offset here, never by dict iteration order.
    """
    spans = sorted(
        ((rg.pages[n].offset, rg.pages[n].length, n) for n in names),
        key=lambda s: (s[0], s[1]),
    )
    runs: list = []
    for off, ln, name in spans:
        if runs and off - runs[-1][1] <= max_gap:
            runs[-1][1] = max(runs[-1][1], off + ln)
            runs[-1][2].append(name)
        else:
            runs.append([off, max(off + ln, off), [name]])
    return [(lo, hi, ns) for lo, hi, ns in runs]


def read_columns_coalesced(reader, rg: RowGroupMeta, names: list[str],
                           max_gap: int = COALESCE_MAX_GAP):
    """Fetch+decode selected columns with coalesced ranged reads: one
    gap-tolerant read per page run instead of one read per page
    (reference analog: parquetquery's async page reads coalescing
    column-chunk IO), then decode pages in parallel on the codec pool.

    Returns (columns dict, reads issued, bytes fetched) — bytes include
    tolerated gaps, so callers can account true IO.
    """
    runs = plan_page_runs(rg, names, max_gap)
    raw: dict[str, memoryview] = {}
    fetched = 0
    for lo, hi, run_names in runs:
        buf = memoryview(reader(lo, hi - lo)) if hi > lo else memoryview(b"")
        fetched += hi - lo
        for name in run_names:
            pm = rg.pages[name]
            raw[name] = buf[pm.offset - lo : pm.offset - lo + pm.length]

    def one(name):
        pm = rg.pages[name]
        return codec_mod.decode(raw[name], pm.dtype, pm.shape, pm.codec, pm.crc)

    cols = dict(zip(names, codec_mod.map_pages(one, list(names))))
    return cols, len(runs), fetched


def row_group_slices(batch: SpanBatch, target_spans: int) -> list[tuple[int, int]]:
    """Split a trace-sorted batch into [lo,hi) row-group ranges at trace
    boundaries, each ~target_spans (reference analog: RowGroupSizeBytes
    flush points, vparquet/compactor.go:160-175)."""
    n = batch.num_spans
    if n == 0:
        return []
    firsts, _ = batch.trace_boundaries()
    slices = []
    lo = 0
    for i, f in enumerate(firsts):
        nxt = firsts[i + 1] if i + 1 < len(firsts) else n
        if nxt - lo >= target_spans:
            slices.append((lo, int(nxt)))
            lo = int(nxt)
    if lo < n:
        slices.append((lo, n))
    return slices


# ---------------------------------------------------------------------------
# standalone batch segments (WAL, network pushes)
# ---------------------------------------------------------------------------


def serialize_batch(batch: SpanBatch, codec: str = "auto",
                    dict_bytes: bytes | None = None) -> bytes:
    """Self-contained segment: MAGIC | u32 header_len | header json | pages.

    The WAL appends one segment per trace-cut flush
    (reference analog: vparquet WAL writes one parquet file per flush,
    tempodb/encoding/vparquet/wal_block.go:309-386).

    dict_bytes: serialize_dictionary(batch.dictionary), when the caller
    already holds it (the vrow1 writer serializes many slices of one
    batch, each carrying the whole dictionary).
    """
    codec = codec_mod.resolve_codec(codec)
    pages = []
    header_cols = {}
    for group, schema in (("cols", SPAN_COLUMNS), ("attrs", ATTR_COLUMNS)):
        src = getattr(batch, group)
        for name in schema:
            arr = src[name]
            page, crc = codec_mod.encode(arr, codec)
            header_cols[f"{group}.{name}"] = {
                "len": len(page),
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "codec": codec,
                "crc": crc,
            }
            pages.append(page)
    if dict_bytes is None:
        dict_bytes = serialize_dictionary(batch.dictionary)
    header = json.dumps({"columns": header_cols, "dict_len": len(dict_bytes)}).encode()
    out = bytearray()
    out += MAGIC
    out += struct.pack("<I", len(header))
    out += header
    for p in pages:
        out += p
    out += dict_bytes
    return bytes(out)


def deserialize_batch(raw: bytes) -> SpanBatch:
    if raw[: len(MAGIC)] != MAGIC:
        raise codec_mod.CorruptPage("bad segment magic")
    hlen = struct.unpack("<I", raw[len(MAGIC) : len(MAGIC) + 4])[0]
    off = len(MAGIC) + 4
    header = json.loads(raw[off : off + hlen])
    off += hlen
    cols, attrs = {}, {}
    for key, cm in header["columns"].items():
        page = raw[off : off + cm["len"]]
        off += cm["len"]
        arr = codec_mod.decode(page, cm["dtype"], tuple(cm["shape"]), cm["codec"], cm["crc"])
        group, name = key.split(".", 1)
        (cols if group == "cols" else attrs)[name] = arr
    d = deserialize_dictionary(raw[off : off + header["dict_len"]])
    return SpanBatch(cols=cols, attrs=attrs, dictionary=d)
