"""Port of tempo_tpu/encoding/vtpu/lightweight.py, copied as is (host numpy).

Lightweight, device-decodable page encodings: RLE and delta+bitpack.

The zstd tier (codec.py) is an entropy codec: pages must fully decode on
the host before a single predicate runs, which is why the read path has
been winning by *not touching bytes* (zone maps, verbatim relocation)
rather than by decoding them faster. This module adds the tier "GPU
Acceleration of SQL Analytics on Compressed Data" (PAPERS.md) builds on:
encodings whose compressed form is itself evaluable —

- ``rle``  — run-length pages for low-cardinality columns (dictionary
  codes like ``service``/``name``, enums like ``status_code``, and the
  trace-ID limbs themselves, whose runs ARE the trace segmentation).
  Predicates evaluate per RUN (ops/scan.py run helpers) and unselected
  runs are never expanded; expansion is a plain ``repeat``, which the
  device does natively (ops/pallas_kernels.rle_expand_device).
- ``dbp``  — delta + zigzag + bitpack for near-sorted numerics
  (``attr_span``, ``start_unix_nano`` when ingest order is time-ish,
  trace-ID limb 0). Bit widths are capped at 32 so the device decode is
  two u32 word gathers + shifts + a two-limb prefix scan
  (ops/pallas_kernels.dbp_decode_device) — no host codec on the path.
  Absolute anchor values every ``DBP_MINIBLOCK`` rows make the page
  GATHERABLE: reading k rows decodes only the miniblocks containing
  them, so a selective query's later column reads cost the surviving
  rows, not the row count (parquet's DELTA_BINARY_PACKED miniblocks).
- ``dct``  — page-local value dictionary + bitpacked indices for
  low-cardinality columns whose runs are too short for ``rle``
  (``name``, ``parent_span_id``, enum/attr columns). Equality and set
  predicates evaluate against the TINY page dictionary first and then
  compare packed indices — values are never materialized — and gather
  reads only the requested rows' bit windows (parquet RLE_DICTIONARY).

Reference analog: parquet's RLE_DICTIONARY / DELTA_BINARY_PACKED
encodings, which the reference's vparquet schema leans on for exactly
these columns (see PARITY.md).

Both formats are self-checking: a body CRC over the encoded payload lets
the run-space read path verify integrity WITHOUT expanding to rows (the
page-level crc in PageMeta covers the decoded payload and is verified on
full decode, same as every other codec). Truncation or garbage raises
``CorruptPage`` — never a silently wrong array.

Choice happens at write time from the data itself (``choose_codec``):
a column only gets a lightweight codec when its encoded size beats the
raw payload by a margin; everything else keeps the default entropy
codec. Absence of a lightweight codec in PageMeta means "current codec"
— old blocks read unchanged, and legacy blocks pick the tier up on
their first compaction exactly like zone maps did.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# columns worth probing at write time. RLE is tried on the code/enum
# columns plus the ID limb arrays (runs = spans-per-trace); DBP on the
# sorted/near-sorted numerics. High-entropy columns (duration, random
# span ids, attr_num) are not probed: the chooser would reject them
# anyway and the probe costs a pass over the data.
RLE_CANDIDATES = frozenset({
    "service", "name", "status_code", "kind", "http_method", "http_url",
    "http_status", "attr_key", "attr_scope", "attr_vtype", "attr_str",
    "trace_id", "parent_span_id",
})
DBP_CANDIDATES = frozenset({
    "start_unix_nano", "duration_nano", "attr_span", "trace_id",
})
DCT_CANDIDATES = frozenset({
    "service", "name", "status_code", "kind", "http_method", "http_url",
    "http_status", "attr_key", "attr_scope", "attr_vtype", "attr_str",
    "parent_span_id",
})

# accept a lightweight codec only on a real win: the point is evaluating
# the encoded form, but a page that barely shrinks is better left on the
# entropy codec (smaller on disk, and nothing run-shaped to exploit)
_RLE_MAX_FRACTION = 0.5
_DBP_MAX_FRACTION = 0.5
_DCT_MAX_FRACTION = 0.5
# device decodability cap: dbp extraction reads a 64-bit window from two
# u32 words, so widths past 32 would need a third gather — reject them
# (the host could go wider, but one format keeps the fuzz surface small)
DBP_MAX_WIDTH = 32


class _Truncated(Exception):
    """Internal: page shorter than its own header claims (mapped to
    CorruptPage at the codec boundary)."""


def _take(buf: memoryview, off: int, n: int) -> memoryview:
    if off + n > len(buf):
        raise _Truncated(f"need {off + n} bytes, page has {len(buf)}")
    return buf[off : off + n]


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------
#
# page = u32 n_runs | u32 body_crc | values (n_runs rows, C order) |
#        lengths (n_runs u32)
# Runs are along axis 0; rows may be vectors ((n, k) limb arrays), in
# which case a run is a stretch of identical rows.


def rle_runs_of(arr: np.ndarray) -> int:
    """Number of runs along axis 0 (the chooser's size probe)."""
    n = arr.shape[0]
    if n == 0:
        return 0
    d = arr[1:] != arr[:-1]
    if d.ndim > 1:
        d = d.any(axis=tuple(range(1, d.ndim)))
    return int(d.sum()) + 1


def rle_encode(arr: np.ndarray) -> bytes:
    n = arr.shape[0]
    if n == 0:
        body = b""
        return struct.pack("<II", 0, zlib.crc32(body)) + body
    d = arr[1:] != arr[:-1]
    if d.ndim > 1:
        d = d.any(axis=tuple(range(1, d.ndim)))
    firsts = np.concatenate([[0], np.flatnonzero(d) + 1])
    lengths = np.diff(np.concatenate([firsts, [n]])).astype(np.uint32)
    values = np.ascontiguousarray(arr[firsts])
    body = values.tobytes() + lengths.tobytes()
    return struct.pack("<II", len(firsts), zlib.crc32(body)) + body


def rle_decode_runs(page: bytes, dtype: str, shape: tuple):
    """(values, lengths) WITHOUT row expansion — the run-space read.

    values: (n_runs, *shape[1:]) in the page dtype; lengths: (n_runs,)
    int64. Verifies the body CRC and the run structure (positive
    lengths summing to the row count), so a truncated or mangled page
    raises instead of yielding a wrong-but-plausible mask.
    """
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage

    buf = memoryview(page)
    try:
        n_runs, body_crc = struct.unpack("<II", _take(buf, 0, 8))
        body = _take(buf, 8, len(buf) - 8)
        if zlib.crc32(body) != body_crc:
            raise CorruptPage(f"rle body crc mismatch ({len(page)} bytes)")
        dt = np.dtype(dtype)
        row_items = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        vbytes = n_runs * row_items * dt.itemsize
        if vbytes + n_runs * 4 != len(body):
            raise CorruptPage(
                f"rle body is {len(body)} bytes, expected {vbytes + n_runs * 4} "
                f"for {n_runs} runs (dtype={dtype}, shape={shape})"
            )
        values = np.frombuffer(body[:vbytes], dtype=dt).reshape((n_runs,) + tuple(shape[1:]))
        lengths = np.frombuffer(body[vbytes:], dtype=np.uint32).astype(np.int64)
    except _Truncated as e:
        raise CorruptPage(f"rle page truncated: {e}") from e
    n = shape[0] if shape else 0
    if n_runs and (not (lengths > 0).all() or int(lengths.sum()) != n):
        raise CorruptPage(
            f"rle run structure invalid: {n_runs} runs sum to "
            f"{int(lengths.sum())}, expected {n} rows"
        )
    if n_runs == 0 and n != 0:
        raise CorruptPage(f"rle page empty but shape says {n} rows")
    return values, lengths


def rle_decode(page: bytes, dtype: str, shape: tuple) -> np.ndarray:
    values, lengths = rle_decode_runs(page, dtype, shape)
    if values.shape[0] == 0:
        return np.empty(shape, dtype=np.dtype(dtype))
    return np.repeat(values, lengths, axis=0)


# ---------------------------------------------------------------------------
# DBP: delta + zigzag + bitpack
# ---------------------------------------------------------------------------
#
# page = u8 ver | u8 k | u8 widths[k] | u32 body_crc | u64 first[k] |
#        u64 anchors[k][n_anchors] | packed zigzag deltas per sub-column
#        (byte-aligned each)
# 2-D arrays delta along axis 0 per sub-column (trace-ID limbs); 1-D is
# k=1. Values are carried as u64 bit patterns; deltas wrap mod 2^64, so
# any integer dtype round-trips exactly. Anchor j of a sub-column is the
# absolute value at row (j+1)*DBP_MINIBLOCK: a gather decodes only the
# miniblocks its rows land in (~0.8% size overhead at 128-row blocks).

DBP_MINIBLOCK = 128


def _n_anchors(n: int) -> int:
    return (n - 1) // DBP_MINIBLOCK if n > 0 else 0


_SIGNED_OF = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _deltas_s64(col: np.ndarray) -> np.ndarray:
    """Adjacent differences computed IN THE COLUMN'S OWN WIDTH (so a
    u32 column wrapping past 2^32 yields the small signed step, not a
    33-bit jump), sign-extended to int64. Decode truncates back to the
    dtype, so the modular arithmetic cancels exactly."""
    d = np.diff(col)  # wraps in the native dtype
    return d.view(_SIGNED_OF[col.dtype.itemsize]).astype(np.int64)


def _zigzag(d: np.ndarray) -> np.ndarray:
    s = d.astype(np.int64)
    return ((s << 1) ^ (s >> 63)).astype(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    zi = z.astype(np.uint64)
    return ((zi >> np.uint64(1)) ^ (np.uint64(0) - (zi & np.uint64(1)))).astype(np.uint64)


def _dbp_width(z: np.ndarray) -> int:
    if len(z) == 0:
        return 0
    m = int(z.max())
    return m.bit_length()


def _pack_bits(z: np.ndarray, w: int) -> bytes:
    """Little-endian bitstream: value i occupies bits [i*w, (i+1)*w)."""
    if w == 0 or len(z) == 0:
        return b""
    bits = ((z[:, None] >> np.arange(w, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.ravel(), bitorder="little").tobytes()


def _unpack_bits(raw: memoryview, n: int, w: int) -> np.ndarray:
    """Vectorized extraction: for each value, gather an 8-byte window at
    its starting byte and shift — one fancy-index gather instead of a
    per-bit unpack (w <= DBP_MAX_WIDTH <= 32, so bit_in_byte + w <= 39
    bits always fit the 64-bit window)."""
    if w == 0 or n == 0:
        return np.zeros(n, np.uint64)
    need = (n * w + 7) // 8
    if len(raw) < need:
        raise _Truncated(f"packed stream is {len(raw)} bytes, need {need}")
    padded = np.zeros(need + 8, np.uint8)
    padded[:need] = np.frombuffer(raw[:need], np.uint8)
    bit_off = np.arange(n, dtype=np.int64) * w
    byte_off = bit_off >> 3
    windows = np.lib.stride_tricks.sliding_window_view(padded, 8)[byte_off]
    vals = windows.copy().view("<u8").reshape(n)
    return (vals >> (bit_off & 7).astype(np.uint64)) & np.uint64((1 << w) - 1)


def _as_2d(arr: np.ndarray) -> np.ndarray:
    n = arr.shape[0]
    k = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
    return np.ascontiguousarray(arr).reshape(n, k)


def dbp_probe(arr: np.ndarray) -> tuple[int, list[int]] | None:
    """(encoded size, per-sub-column widths), or None when any width
    exceeds the device cap."""
    n = arr.shape[0]
    a2 = _as_2d(arr)
    k = a2.shape[1]
    widths = []
    size = 2 + k + 4 + 8 * k + 8 * k * _n_anchors(n)
    for c in range(k):
        z = _zigzag(_deltas_s64(a2[:, c]))
        w = _dbp_width(z)
        if w > DBP_MAX_WIDTH:
            return None
        widths.append(w)
        size += (max(n - 1, 0) * w + 7) // 8
    return size, widths


def dbp_encode(arr: np.ndarray) -> bytes:
    n = arr.shape[0]
    a2 = _as_2d(arr)
    k = a2.shape[1]
    u = a2.astype(np.uint64)
    widths = []
    streams = []
    na = _n_anchors(n)
    anchor_rows = (np.arange(na, dtype=np.int64) + 1) * DBP_MINIBLOCK
    anchors = []
    for c in range(k):
        z = _zigzag(_deltas_s64(a2[:, c])) if n > 1 else np.zeros(0, np.uint64)
        w = _dbp_width(z)
        if w > DBP_MAX_WIDTH:
            raise ValueError(f"dbp: delta width {w} exceeds cap {DBP_MAX_WIDTH}")
        widths.append(w)
        streams.append(_pack_bits(z, w))
        anchors.append(u[anchor_rows, c] if na else np.zeros(0, np.uint64))
    first = u[0] if n else np.zeros(0, np.uint64)
    body = (
        first.astype("<u8").tobytes()
        + b"".join(a.astype("<u8").tobytes() for a in anchors)
        + b"".join(streams)
    )
    return (
        struct.pack("<BB", 1, k)
        + bytes(widths)
        + struct.pack("<I", zlib.crc32(body))
        + body
    )


def dbp_parts(page: bytes, dtype: str, shape: tuple):
    """Parse a dbp page into its device-shippable parts WITHOUT the
    prefix-sum: (first (k,) u64, anchors (k, n_anchors) u64, widths
    list, packed streams list, n rows). The device decode
    (ops/pallas_kernels.dbp_decode_device) consumes exactly these; the
    host decode below is the same parts fed to a numpy cumsum."""
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage

    buf = memoryview(page)
    n = shape[0] if shape else 0
    try:
        ver, k = struct.unpack("<BB", _take(buf, 0, 2))
        if ver != 1:
            raise CorruptPage(f"dbp version {ver} unknown")
        row_items = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        if k != row_items:
            raise CorruptPage(f"dbp has {k} sub-columns, shape {shape} implies {row_items}")
        widths = list(_take(buf, 2, k))
        (body_crc,) = struct.unpack("<I", _take(buf, 2 + k, 4))
        body = _take(buf, 6 + k, len(buf) - 6 - k)
        if zlib.crc32(body) != body_crc:
            raise CorruptPage(f"dbp body crc mismatch ({len(page)} bytes)")
        if any(w > DBP_MAX_WIDTH for w in widths):
            raise CorruptPage(f"dbp widths {widths} exceed cap {DBP_MAX_WIDTH}")
        off = 0
        first = np.frombuffer(_take(body, 0, 8 * k if n else 0), "<u8").astype(np.uint64)
        off += 8 * k if n else 0
        na = _n_anchors(n)
        anchors = np.frombuffer(_take(body, off, 8 * k * na), "<u8").astype(
            np.uint64).reshape(k, na)
        off += 8 * k * na
        streams = []
        for c in range(k):
            nb = (max(n - 1, 0) * widths[c] + 7) // 8
            streams.append(_take(body, off, nb))
            off += nb
        if off != len(body):
            raise CorruptPage(
                f"dbp body is {len(body)} bytes, expected {off} "
                f"(dtype={dtype}, shape={shape})"
            )
    except _Truncated as e:
        raise CorruptPage(f"dbp page truncated: {e}") from e
    return first, anchors, widths, streams, n


def dbp_decode(page: bytes, dtype: str, shape: tuple) -> np.ndarray:
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage

    first, anchors, widths, streams, n = dbp_parts(page, dtype, shape)
    dt = np.dtype(dtype)
    if n == 0:
        return np.empty(shape, dt)
    k = len(widths)
    out = np.empty((n, k), np.uint64)
    try:
        for c in range(k):
            z = _unpack_bits(streams[c], n - 1, widths[c])
            d = _unzigzag(z)
            col = np.empty(n, np.uint64)
            col[0] = first[c]
            np.cumsum(d, out=d)  # wraps mod 2^64 — exact modular prefix
            col[1:] = first[c] + d
            # anchors are redundant on a full decode, but a mismatch
            # means the page is NOT the data that was written (compare
            # truncated to the dtype: deltas are modular in its width)
            na = anchors.shape[1]
            if na and (col[(np.arange(na) + 1) * DBP_MINIBLOCK].astype(dt)
                       != anchors[c].astype(dt)).any():
                raise CorruptPage("dbp anchors disagree with delta stream")
            out[:, c] = col
    except _Truncated as e:
        raise CorruptPage(f"dbp page truncated: {e}") from e
    return np.ascontiguousarray(out.astype(dt, copy=False).reshape(shape))


def dbp_gather(page: bytes, dtype: str, shape: tuple, rows: np.ndarray):
    """Decode ONLY the rows requested: (values (len(rows), *shape[1:]),
    miniblock rows touched). Each requested row costs its miniblock's
    delta window cumsum'd from the nearest anchor — a selective query's
    later column reads scale with the surviving rows, not the page."""
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage

    first, anchors, widths, streams, n = dbp_parts(page, dtype, shape)
    dt = np.dtype(dtype)
    rows = np.asarray(rows, np.int64)
    k = len(widths)
    if len(rows) == 0 or n == 0:
        return np.empty((0,) + tuple(shape[1:]), dt), 0
    if rows.min() < 0 or rows.max() >= n:
        raise IndexError(f"dbp gather rows out of range [0, {n})")
    A = DBP_MINIBLOCK
    mbs = np.unique(rows // A)  # touched miniblocks
    mb_lo = mbs * A
    mb_hi = np.minimum(mb_lo + A, n)
    out = np.empty((len(rows), k), np.uint64)
    try:
        for c in range(k):
            w = widths[c]
            prev = (anchors[c][np.maximum(mbs - 1, 0)] if anchors.shape[1]
                    else np.zeros(len(mbs), np.uint64))
            base = np.where(mbs == 0, first[c], prev)
            # per touched miniblock: unpack its (<= A-1) deltas,
            # prefix-sum from the block base (first value or anchor:
            # both are the absolute value at the block's first row),
            # then pick the requested offsets
            vals = np.empty((len(mbs), A), np.uint64)
            for j in range(len(mbs)):
                lo, hi = int(mb_lo[j]), int(mb_hi[j])
                # delta d[i] carries row i+1: rows (lo, hi) need deltas
                # [lo, hi-1) of the stream
                z = _unpack_window(streams[c], lo, hi - lo - 1, w, n - 1)
                d = _unzigzag(z)
                np.cumsum(d, out=d)
                vals[j, 0] = base[j]
                vals[j, 1 : hi - lo] = base[j] + d
            pos = np.searchsorted(mb_lo, rows // A * A)
            out[:, c] = vals[pos, rows - mb_lo[pos]]
    except _Truncated as e:
        raise CorruptPage(f"dbp page truncated: {e}") from e
    return (
        np.ascontiguousarray(out.astype(dt, copy=False).reshape((len(rows),) + tuple(shape[1:]))),
        int((mb_hi - mb_lo).sum()),
    )


def _unpack_window(raw: memoryview, start: int, count: int, w: int, total: int) -> np.ndarray:
    """Unpack values [start, start+count) of a packed stream of `total`
    values (the miniblock window of dbp_gather)."""
    if w == 0 or count <= 0:
        return np.zeros(max(count, 0), np.uint64)
    if start + count > total:
        raise _Truncated(f"window [{start}, {start + count}) past {total} values")
    need = (total * w + 7) // 8
    if len(raw) < need:
        raise _Truncated(f"packed stream is {len(raw)} bytes, need {need}")
    lo_byte = (start * w) >> 3
    hi_byte = min(((start + count) * w + 7) >> 3, len(raw))
    window = np.zeros(hi_byte - lo_byte + 8, np.uint8)
    window[: hi_byte - lo_byte] = np.frombuffer(raw[lo_byte:hi_byte], np.uint8)
    bit_off = np.arange(start, start + count, dtype=np.int64) * w - (lo_byte << 3)
    byte_off = bit_off >> 3
    windows = np.lib.stride_tricks.sliding_window_view(window, 8)[byte_off]
    vals = windows.copy().view("<u8").reshape(count)
    return (vals >> (bit_off & 7).astype(np.uint64)) & np.uint64((1 << w) - 1)


def rle_gather(values: np.ndarray, lengths: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Rows of an RLE column from its runs WITHOUT full expansion: a
    searchsorted over the run boundaries maps each requested row to its
    run (unselected runs are never expanded)."""
    cum = np.cumsum(lengths)
    run = np.searchsorted(cum, np.asarray(rows, np.int64), side="right")
    return values[run]


# ---------------------------------------------------------------------------
# DCT: page-local value dictionary + bitpacked indices
# ---------------------------------------------------------------------------
#
# page = u8 ver | u8 width | u32 n_dict | u32 body_crc |
#        dict values (n_dict rows, C order) | packed indices (n rows ×
#        width bits)
# The parquet RLE_DICTIONARY analog for columns whose runs are too
# short for rle: predicates resolve against the TINY page dictionary
# and compare packed indices; gather unpacks only the requested rows'
# bit windows. Rows may be vectors (parent_span_id limb pairs).


def dct_probe(arr: np.ndarray) -> tuple[int, int] | None:
    """(encoded size, n_dict), or None when the dictionary would not pay
    (cardinality near the row count, or index width past the cap)."""
    n = arr.shape[0]
    a2 = _as_2d(arr)
    uniq = np.unique(a2, axis=0)
    d = uniq.shape[0]
    if d > max(n // 2, 1):
        return None
    w = max(d - 1, 0).bit_length()
    if w > DBP_MAX_WIDTH:
        return None
    size = 10 + d * arr.dtype.itemsize * a2.shape[1] + (n * w + 7) // 8
    return size, d


def dct_encode(arr: np.ndarray) -> bytes:
    n = arr.shape[0]
    a2 = _as_2d(arr)
    if n == 0:
        body = b""
        return struct.pack("<BBII", 1, 0, 0, zlib.crc32(body)) + body
    uniq, inv = np.unique(a2, axis=0, return_inverse=True)
    d = uniq.shape[0]
    w = max(d - 1, 0).bit_length()
    if w > DBP_MAX_WIDTH:
        raise ValueError(f"dct: index width {w} exceeds cap {DBP_MAX_WIDTH}")
    body = np.ascontiguousarray(uniq).tobytes() + _pack_bits(
        inv.reshape(-1).astype(np.uint64), w)
    return struct.pack("<BBII", 1, w, d, zlib.crc32(body)) + body


def dct_parts(page: bytes, dtype: str, shape: tuple):
    """(dict values (n_dict, *shape[1:]), width, packed index stream,
    n rows) — the dictionary-space read: predicates match against the
    values, indices stay packed until someone truly needs rows."""
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage

    buf = memoryview(page)
    n = shape[0] if shape else 0
    try:
        ver, w, d, body_crc = struct.unpack("<BBII", _take(buf, 0, 10))
        if ver != 1:
            raise CorruptPage(f"dct version {ver} unknown")
        if w > DBP_MAX_WIDTH:
            raise CorruptPage(f"dct width {w} exceeds cap {DBP_MAX_WIDTH}")
        body = _take(buf, 10, len(buf) - 10)
        if zlib.crc32(body) != body_crc:
            raise CorruptPage(f"dct body crc mismatch ({len(page)} bytes)")
        dt = np.dtype(dtype)
        row_items = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        vbytes = d * row_items * dt.itemsize
        sbytes = (n * w + 7) // 8
        if vbytes + sbytes != len(body):
            raise CorruptPage(
                f"dct body is {len(body)} bytes, expected {vbytes + sbytes} "
                f"(n_dict={d}, width={w}, shape={shape})"
            )
        values = np.frombuffer(body[:vbytes], dt).reshape((d,) + tuple(shape[1:]))
        if n and d == 0:
            raise CorruptPage(f"dct page has no dictionary but shape says {n} rows")
    except _Truncated as e:
        raise CorruptPage(f"dct page truncated: {e}") from e
    return values, w, body[vbytes:], n


def dct_indices(page: bytes, dtype: str, shape: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(dict values, (n,) row index array) — index-space expansion
    (width-bits per row, values never materialized)."""
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage

    values, w, stream, n = dct_parts(page, dtype, shape)
    try:
        idx = _unpack_bits(stream, n, w).astype(np.uint32)
    except _Truncated as e:
        raise CorruptPage(f"dct page truncated: {e}") from e
    if n and w and (idx >= values.shape[0]).any():
        raise CorruptPage("dct index out of dictionary range")
    return values, idx


def dct_decode(page: bytes, dtype: str, shape: tuple) -> np.ndarray:
    values, idx = dct_indices(page, dtype, shape)
    if shape[0] == 0:
        return np.empty(shape, np.dtype(dtype))
    return np.ascontiguousarray(values[idx].reshape(shape))


def dct_gather(page: bytes, dtype: str, shape: tuple, rows: np.ndarray) -> np.ndarray:
    """Rows of a dct column by unpacking ONLY the requested rows' bit
    windows (one gather, no full index expansion)."""
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage

    values, w, stream, n = dct_parts(page, dtype, shape)
    rows = np.asarray(rows, np.int64)
    if len(rows) == 0:
        return np.empty((0,) + tuple(shape[1:]), np.dtype(dtype))
    if rows.min() < 0 or rows.max() >= n:
        raise IndexError(f"dct gather rows out of range [0, {n})")
    if w == 0:
        return np.broadcast_to(values[0], (len(rows),) + tuple(shape[1:])).copy()
    try:
        need = (n * w + 7) // 8
        if len(stream) < need:
            raise _Truncated(f"packed stream is {len(stream)} bytes, need {need}")
        padded = np.zeros(need + 8, np.uint8)
        padded[:need] = np.frombuffer(stream[:need], np.uint8)
        bit_off = rows * w
        byte_off = bit_off >> 3
        windows = np.lib.stride_tricks.sliding_window_view(padded, 8)[byte_off]
        idx = (windows.copy().view("<u8").reshape(len(rows))
               >> (bit_off & 7).astype(np.uint64)) & np.uint64((1 << w) - 1)
    except _Truncated as e:
        raise CorruptPage(f"dct page truncated: {e}") from e
    if (idx >= values.shape[0]).any():
        raise CorruptPage("dct index out of dictionary range")
    return np.ascontiguousarray(values[idx.astype(np.int64)])


# ---------------------------------------------------------------------------
# write-time choice
# ---------------------------------------------------------------------------


def choose_codec(name: str, arr: np.ndarray, default: str) -> str:
    """Pick a page codec for one column from the data in hand.

    Deterministic and purely size-driven past the candidate gate: a
    lightweight codec is chosen only when its encoded size beats
    _*_MAX_FRACTION of the raw payload (ties prefer RLE — its runs are
    evaluable and expansion is free on device; then DCT over DBP —
    dictionary-space predicates beat delta-space ones). Everything else
    keeps `default` (the entropy codec), so high-entropy columns and
    tiny pages are untouched.
    """
    n = arr.shape[0] if arr.ndim else 0
    if n < 16 or arr.dtype.kind not in "ui":
        return default
    raw = arr.nbytes
    best, best_size = default, raw
    if name in RLE_CANDIDATES:
        r = rle_runs_of(arr)
        row_bytes = arr.nbytes // n
        size = 8 + r * (row_bytes + 4)
        if size <= raw * _RLE_MAX_FRACTION:
            best, best_size = "rle", size
    if best != "rle" and name in DCT_CANDIDATES:
        probe = dct_probe(arr)
        if probe is not None:
            size, _ = probe
            if size <= raw * _DCT_MAX_FRACTION:
                best, best_size = "dct", size
    if best == default and name in DBP_CANDIDATES:
        probe = dbp_probe(arr)
        if probe is not None:
            size, _ = probe
            if size <= raw * _DBP_MAX_FRACTION and size < best_size:
                best, best_size = "dbp", size
    return best
