"""Device page encoders: the write-path inverse of the resident decode
formulas.

Port of tempo_tpu/ops/encode.py. The pages are byte-identical to the
host encoders of encoding/vtpu/lightweight.py — same header, same body
CRC, same np.packbits(bitorder="little") stream layout — so readers
cannot tell which arm wrote a block.

Division of labour per codec, as in the reference:

- rle — the device computes the row-change marks (the O(n*k) compare,
  kernel `rle_change_mask`, one bit a row); the host turns them into
  firsts/lengths and gathers the run values.
- dbp — per-column delta and zigzag on the device, in u32 limb planes
  for 64-bit columns, then the static-width bitpack (kernel `dbp_pack`,
  delta mode). Widths come from the host probe formulas, as in the
  reference.
- dct — the page dictionary (np.unique) stays on the host; the device
  packs the index stream at the static width (`dbp_pack`, pack mode).

Where the reference makes one dispatch a page, the port makes one a
batch of pages (`encode_pages_device`; the block writer hands it a row
group's lightweight pages). The host work before the launch
(`prepare_page`: dct's np.unique, the dbp widths) runs on the codec
pool; `PageBatch` lays every page's u32 lanes and two page tables out
in one staging buffer; the dispatch is one host-to-device copy, at most
one `rle_change_mask` and one `dbp_pack` launch over every page of the
batch, one device-to-host copy, and a wait on an event of the staging's
stream; headers, run values, anchors and CRCs are assembled on the
pool. On the card the staging (`PageStaging`, owned by the writer and
reused) is pinned host memory with device twins and a stream of its own.
No row is padded: each kernel masks the ragged edge of every page.

The kernels are CUDA C++ in csrc/codec_kernels.cu (ops/_build.py). Beside
each sits its plain PyTorch version of the same batched function
(_rle_change_plain, _dbp_pack_plain: the per-page expressions looped
over the page table); a wrapper takes the plain version only for
tensors on the CPU, and for CUDA tensors launches the kernel or raises.
Unlike the reference, a kernel failure is not absorbed into a host
fallback: it raises, so the fallback counter keeps its name for
/metrics parity and stays at 0.

`device_encode_enabled(device)`: TEMPO_TPU_DEVICE_ENCODE=0 turns the arm
off, =1 forces it on (on the CPU it then runs the plain versions);
unset, it follows the writer's device — on for cuda, off for cpu — as
the reference's follows the accelerator.
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
import zlib

import numpy as np
import torch

from tempo_tpu_torch.encoding.vtpu import lightweight as lw
from tempo_tpu_torch.ops import _build
from tempo_tpu_torch.ops.pallas_kernels import _check_cuda, _route, _stream, _u32
from tempo_tpu_torch.util import metrics
from tempo_tpu_torch.util.devicetiming import timed_dispatch

device_encode_pages_total = metrics.counter(
    "tempo_tpu_ingest_device_encode_pages_total",
    "Pages encoded by the device encode kernels, by codec",
)
encode_fallback_total = metrics.counter(
    "tempo_tpu_ingest_encode_fallback_total",
    "Lightweight pages that fell back to the host encoder (device kernel "
    "error), by codec",
)

_M32 = 0xFFFFFFFF
_launch_lock = threading.Lock()

# page tables: int64 rows, offsets in u32 words of the staging buffer
RLE_FIELDS = 6  # in_off, rows, lanes, out_off, first_tile, tile_rows
DBP_FIELDS = 8  # lo_off, hi_off (-1: none), rows, item_bits (0: pack mode), width, out_off, first_tile, 0
PACK_VALUES = 2048  # values a dbp_pack block packs (csrc kPackValues)
RLE_TILE_WORDS = 2048  # u32 lanes an rle_change_mask block stages, halo row aside
_SMEM_MAX = 231_424  # dynamic shared memory an rle_change_mask block may take (H100: 227 KiB a block)


def device_encode_enabled(device) -> bool:
    """TEMPO_TPU_DEVICE_ENCODE: 0 turns the arm off, 1 forces it on;
    unset, it is on where the writer's device is a CUDA device."""
    env = os.environ.get("TEMPO_TPU_DEVICE_ENCODE", "").strip().lower()
    if env in ("0", "false", "no"):
        return False
    if env in ("1", "true", "yes", "force"):
        return True
    return device is not None and torch.device(device).type == "cuda"


def _unsigned_2d(arr: np.ndarray) -> np.ndarray:
    """(n, k) view of the column as unsigned lanes: same-width unsigned
    for <=4-byte dtypes, u32 limb pairs (lo, hi interleaved,
    little-endian) for 8-byte ones. A pure bit reinterpret — row
    equality and modular arithmetic are preserved exactly."""
    a2 = lw._as_2d(arr)
    item = a2.dtype.itemsize
    u = np.ascontiguousarray(a2).view(f"<u{item}")
    if item == 8:
        u = u.view("<u4").reshape(a2.shape[0], a2.shape[1] * 2)
    return u


def rle_tile_rows(lanes: int) -> int:
    """Rows an rle_change_mask block compares on a page of `lanes` lanes:
    the largest power of two whose lanes fill at most RLE_TILE_WORDS,
    32 rows at least (csrc kMaxTileRows = RLE_TILE_WORDS)."""
    rows = RLE_TILE_WORDS
    while rows > 32 and rows * lanes > RLE_TILE_WORDS:
        rows >>= 1
    return rows


def _rle_stage_words(lanes: int) -> int:
    """The most words a tile stages, (tile_rows + 1) * k, over pages of
    at most `lanes` lanes."""
    return max(RLE_TILE_WORDS + lanes, 33 * lanes)


def _count(fn, n: int = 1) -> None:
    with _launch_lock:
        fn.launches += n


def _check_batch(kernel: str, data: torch.Tensor, table: torch.Tensor, fields: int,
                 tiles: torch.Tensor, out: torch.Tensor) -> None:
    if any(t.ndim != 1 or t.dtype != torch.int32 for t in (data, tiles, out)):
        raise ValueError(f"{kernel}: data, the tile list and out must be flat int32 tensors")
    if table.ndim != 2 or table.shape[1] != fields or table.dtype != torch.int64:
        raise ValueError(f"{kernel}: the table must be (pages, {fields}) int64")


def _words_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """(m,) 0/1 values -> the little-endian bytes of ceil(m/32) u32 words,
    bit i of the stream at bit i % 32 of word i // 32, the rest zero."""
    pad = -bits.numel() % 32
    b = torch.cat([bits.to(torch.int64), bits.new_zeros(pad, dtype=torch.int64)])
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], device=b.device)
    return (b.reshape(-1, 8) * weights).sum(dim=1).to(torch.uint8)


# ---------------------------------------------------------------------------
# K1: rle_change_mask over a table of pages
# ---------------------------------------------------------------------------


def _rle_change_plain(data: torch.Tensor, table: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version: for each page, (a[1:] != a[:-1]).any(1) over its
    (rows, lanes) u32 lanes, as bits in words from out_off."""
    by = out.view(torch.uint8)
    for in_off, rows, lanes, out_off, _, _ in table.tolist():
        a = data[in_off: in_off + rows * lanes].view(rows, lanes)
        words = _words_of_bits((a[1:] != a[:-1]).any(dim=1))
        by[4 * out_off: 4 * out_off + words.numel()] = words
    return out


def rle_change_mask(data: torch.Tensor, table: torch.Tensor, tile_page: torch.Tensor,
                    out: torch.Tensor, lanes: int) -> torch.Tensor:
    """Row-change marks of a batch of pages. data: flat int32 tensor of
    u32 lanes; table: (pages, RLE_FIELDS) int64 on data's device, a row
    (in_off, rows >= 2, lanes, out_off, first_tile, rle_tile_rows(lanes))
    a page, offsets in u32 words; tile_page: int32, the page of each tile
    (a page's ceil((rows-1) / tile_rows) tiles in order from first_tile).
    Page p's rows - 1 marks (bit i: row i+1 differs from row i in some
    lane) land as bits in ceil((rows-1)/32) words of `out` from out_off,
    the last word's spare bits zero. `lanes`: the widest page's, which
    sizes the kernel's shared memory. Returns out."""
    _check_batch("rle_change_mask", data, table, RLE_FIELDS, tile_page, out)
    if _route("rle_change_mask", data) == "cpu":
        return _rle_change_plain(data, table, out)
    _check_cuda("rle_change_mask", data, table, tile_page, out)
    stage = _rle_stage_words(lanes)
    if stage * 4 > _SMEM_MAX:
        raise ValueError(f"rle_change_mask: rows of {lanes} lanes exceed shared memory")
    if tile_page.numel():
        with torch.cuda.device(data.device):
            err = _build.lib().tt_rle_change_mask(data.data_ptr(), table.data_ptr(),
                                                  tile_page.data_ptr(), tile_page.numel(), stage,
                                                  out.data_ptr(), _stream(data))
        _build.check(err, "rle_change_mask")
        _count(rle_change_mask)
    return out


rle_change_mask.launches = 0


# ---------------------------------------------------------------------------
# K2: dbp_pack over a table of columns (delta mode for dbp, pack mode for
# the dct index stream)
# ---------------------------------------------------------------------------


def _zigzag_lo_plain(lo: torch.Tensor, hi: torch.Tensor | None, item_bits: int) -> torch.Tensor:
    """(rows,) limbs -> the rows - 1 low limbs of the zigzagged deltas of
    rows i, i+1 (u32 values in int64)."""
    lo64 = _u32(lo)
    a, b = lo64[:-1], lo64[1:]
    if item_bits == 64:
        hi64 = _u32(hi)
        d_lo = (b - a) & _M32
        d_hi = (hi64[1:] - hi64[:-1] - (b < a).to(torch.int64)) & _M32
    elif item_bits == 32:
        d_lo = (b - a) & _M32
        d_hi = (0 - (d_lo >> 31)) & _M32
    else:
        mask = (1 << item_bits) - 1
        d_w = (b - a) & mask
        sign = (d_w >> (item_bits - 1)) & 1
        d_lo = d_w | (sign * (_M32 & ~mask))
        d_hi = (0 - sign) & _M32
    neg = (0 - (d_hi >> 31)) & _M32
    return ((d_lo << 1) & _M32) ^ neg


def _pack_plain(z: torch.Tensor, w: int) -> torch.Tensor:
    """(m,) u32 values in int64 -> the little-endian bytes of the
    ceil(m*w/32) u32 words of their bit stream, value i at bits
    [i*w, (i+1)*w)."""
    return _words_of_bits(((z[:, None] >> torch.arange(w, device=z.device)) & 1).reshape(-1))


def _dbp_pack_plain(data: torch.Tensor, table: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version: each column's zigzagged deltas (or its values, in
    pack mode) packed at its width into words from out_off."""
    by = out.view(torch.uint8)
    for lo_off, hi_off, rows, item_bits, w, out_off, _, _ in table.tolist():
        lo = data[lo_off: lo_off + rows]
        if item_bits:
            hi = data[hi_off: hi_off + rows] if item_bits == 64 else None
            z = _zigzag_lo_plain(lo, hi, item_bits)
        else:
            z = _u32(lo)
        words = _pack_plain(z & ((1 << w) - 1), w)
        by[4 * out_off: 4 * out_off + words.numel()] = words
    return out


def dbp_pack(data: torch.Tensor, table: torch.Tensor, tile_col: torch.Tensor,
             out: torch.Tensor) -> torch.Tensor:
    """Bitpack a batch of columns at static widths. data: flat int32
    tensor of u32 values; table: (columns, DBP_FIELDS) int64 on data's
    device, a row (lo_off, hi_off, rows, item_bits, width, out_off,
    first_tile, 0) a column, offsets in u32 words; tile_col: int32, the
    column of each tile (a column's ceil(m / PACK_VALUES) tiles in order
    from first_tile). Delta mode (item_bits 8, 16, 32 or 64; rows >= 2):
    the rows - 1 zigzagged deltas of the limbs at lo_off (and, for 64-bit
    items, the high limbs at hi_off). Pack mode (item_bits 0): the rows
    values at lo_off as they are. The m values of a column pack at width
    w (1..32; value i at bits [i*w, (i+1)*w)) into ceil(m*w/32) words of
    `out` from out_off, the spare bits zero. Returns out."""
    _check_batch("dbp_pack", data, table, DBP_FIELDS, tile_col, out)
    if _route("dbp_pack", data) == "cpu":
        return _dbp_pack_plain(data, table, out)
    _check_cuda("dbp_pack", data, table, tile_col, out)
    if tile_col.numel():
        with torch.cuda.device(data.device):
            err = _build.lib().tt_dbp_pack(data.data_ptr(), table.data_ptr(), tile_col.data_ptr(),
                                           tile_col.numel(), out.data_ptr(), _stream(data))
        _build.check(err, "dbp_pack")
        _count(dbp_pack)
    return out


dbp_pack.launches = 0


# ---------------------------------------------------------------------------
# the batched page encode (byte-identical to the lightweight.py arm)
# ---------------------------------------------------------------------------


class PagePlan:
    """One page's host work before the launch: its codec, rows, and the
    u32 sources the kernels read (rle: the (rows, lanes) lanes; dbp: a
    (width, lo, hi) a column; dct: the dictionary and the index stream's
    width)."""

    __slots__ = ("arr", "codec", "n", "lanes", "cols", "item_bits", "uniq")

    def __init__(self, arr: np.ndarray, codec: str):
        self.arr, self.codec, self.n = arr, codec, arr.shape[0]
        self.lanes, self.cols, self.item_bits, self.uniq = None, [], 0, None


def prepare_page(arr: np.ndarray, codec: str) -> PagePlan | None:
    """The host work of one page before the launch; None where the host
    arm takes the page (a codec outside the lightweight tier, or fewer
    than 2 rows). ValueError for a width over the cap, the host
    encoder's contract too."""
    if codec not in ("rle", "dbp", "dct") or arr.shape[0] < 2:
        return None
    p = PagePlan(arr, codec)
    if codec == "rle":
        p.lanes = _unsigned_2d(arr)
        return p
    a2 = lw._as_2d(arr)
    if codec == "dct":
        p.uniq, inv = np.unique(a2, axis=0, return_inverse=True)
        w = max(p.uniq.shape[0] - 1, 0).bit_length()
        if w > lw.DBP_MAX_WIDTH:
            raise ValueError(f"dct: index width {w} exceeds cap {lw.DBP_MAX_WIDTH}")
        p.cols = [(w, inv.reshape(-1), None)]
        return p
    # widths from the host probe arithmetic: the kernel's static widths
    k, item = a2.shape[1], a2.dtype.itemsize
    u = _unsigned_2d(arr)
    limbs = u.reshape(p.n, k, 2) if item == 8 else None
    for c in range(k):
        w = lw._dbp_width(lw._zigzag(lw._deltas_s64(a2[:, c])))
        if w > lw.DBP_MAX_WIDTH:
            raise ValueError(f"dbp: delta width {w} exceeds cap {lw.DBP_MAX_WIDTH}")
        p.cols.append((w, u[:, c], None) if limbs is None else (w, limbs[:, c, 0], limbs[:, c, 1]))
    p.item_bits = item * 8
    return p


def _up4(n: int) -> int:
    return (n + 3) & ~3


class PageBatch:
    """One batched dispatch laid out: the two page tables and the two
    tile lists at the head of a u32 staging buffer, then every page's
    sources, each segment on a 16-byte boundary; the output words of
    every page."""

    def __init__(self, plans: list[PagePlan]):
        self.plans = plans
        rle = [p for p in plans if p.codec == "rle"]
        cols = [(p, c) for p in plans for c, (w, _, _) in enumerate(p.cols) if w]
        self.lanes = max((p.lanes.shape[1] for p in rle), default=1)
        self.rle_table = np.zeros((len(rle), RLE_FIELDS), np.int64)
        self.dbp_table = np.zeros((len(cols), DBP_FIELDS), np.int64)
        self.out_of: dict = {}  # (plan id, column or -1) -> first output word
        out = 0
        rle_tiles, dbp_tiles = [], []
        for i, p in enumerate(rle):
            n, k = p.lanes.shape
            rows = rle_tile_rows(k)
            self.rle_table[i] = (0, n, k, out, len(rle_tiles), rows)
            self.out_of[id(p), -1] = out
            out += _up4(-(-(n - 1) // 32))
            rle_tiles += [i] * -(-(n - 1) // rows)
        for i, (p, c) in enumerate(cols):
            w, _, hi = p.cols[c]
            m = p.n - 1 if p.item_bits else p.n
            self.dbp_table[i] = (0, -1, p.n, p.item_bits, w, out, len(dbp_tiles), 0)
            self.out_of[id(p), c] = out
            out += _up4(-(-m * w // 32))
            dbp_tiles += [i] * -(-m // PACK_VALUES)
        self.rle_tiles = np.asarray(rle_tiles, np.int32)
        self.dbp_tiles = np.asarray(dbp_tiles, np.int32)
        # segments: tables, tile lists, then the sources
        self.rle_off = 0
        self.dbp_off = _up4(self.rle_table.size * 2)
        self.rle_tiles_off = self.dbp_off + _up4(self.dbp_table.size * 2)
        self.dbp_tiles_off = self.rle_tiles_off + _up4(len(rle_tiles))
        words = self.dbp_tiles_off + _up4(len(dbp_tiles))
        for row, p in zip(self.rle_table, rle):
            row[0] = words
            words += _up4(p.lanes.size)
        for row, (p, c) in zip(self.dbp_table, cols):
            row[0] = words
            words += _up4(p.n)
            if p.cols[c][2] is not None:
                row[1] = words
                words += _up4(p.n)
        self.rle_pages, self.dbp_cols = rle, cols
        self.in_words, self.out_words = words, out

    def fill(self, buf: np.ndarray) -> None:
        """Write the tables, the tile lists and every page's sources into
        `buf` (u32, at least in_words): the page copies run on the codec
        pool."""
        from tempo_tpu_torch.encoding.vtpu.codec import map_pages

        for off, arr in ((self.rle_off, self.rle_table), (self.dbp_off, self.dbp_table)):
            buf[off: off + arr.size * 2].view(np.int64)[:] = arr.reshape(-1)
        for off, arr in ((self.rle_tiles_off, self.rle_tiles), (self.dbp_tiles_off, self.dbp_tiles)):
            buf[off: off + arr.size] = arr
        jobs = [(int(r[0]), p.lanes) for r, p in zip(self.rle_table, self.rle_pages)]
        for r, (p, c) in zip(self.dbp_table, self.dbp_cols):
            _, lo, hi = p.cols[c]
            jobs.append((int(r[0]), lo))
            if hi is not None:
                jobs.append((int(r[1]), hi))

        def put(job):
            off, src = job
            buf[off: off + src.size].reshape(src.shape)[...] = src

        map_pages(put, jobs)

    def tensors(self, data: torch.Tensor) -> tuple:
        """(rle table, rle tile list, dbp table, dbp tile list): views of
        the staged buffer `data`."""
        def table(off, arr, fields):
            return data[off: off + arr.size * 2].view(torch.int64).view(-1, fields)

        return (table(self.rle_off, self.rle_table, RLE_FIELDS),
                data[self.rle_tiles_off: self.rle_tiles_off + self.rle_tiles.size],
                table(self.dbp_off, self.dbp_table, DBP_FIELDS),
                data[self.dbp_tiles_off: self.dbp_tiles_off + self.dbp_tiles.size])

    def launch(self, data: torch.Tensor, out: torch.Tensor) -> None:
        """At most one rle_change_mask and one dbp_pack launch over the
        staged batch (`data` holds the filled buffer on the device)."""
        rle_t, rle_tiles, dbp_t, dbp_tiles = self.tensors(data)
        if len(self.rle_pages):
            rle_change_mask(data, rle_t, rle_tiles, out, self.lanes)
        if len(self.dbp_cols):
            dbp_pack(data, dbp_t, dbp_tiles, out)

    def assemble(self, p: PagePlan, out: np.ndarray) -> bytes:
        """Page bytes of plan p from the output bytes `out`."""
        n = p.n
        if p.codec == "rle":
            o = 4 * self.out_of[id(p), -1]
            d = np.unpackbits(out[o: o + (n + 6) // 8], count=n - 1, bitorder="little")
            firsts = np.concatenate([[0], np.flatnonzero(d) + 1])
            lengths = np.diff(np.concatenate([firsts, [n]])).astype(np.uint32)
            body = np.ascontiguousarray(p.arr[firsts]).tobytes() + lengths.tobytes()
            return struct.pack("<II", len(firsts), zlib.crc32(body)) + body
        streams = []
        m = n - 1 if p.item_bits else n
        for c, (w, _, _) in enumerate(p.cols):
            o = 4 * self.out_of[id(p), c] if w else 0
            streams.append(out[o: o + (m * w + 7) // 8].tobytes())
        if p.codec == "dct":
            (w, _, _), d = p.cols[0], p.uniq.shape[0]
            body = np.ascontiguousarray(p.uniq).tobytes() + streams[0]
            return struct.pack("<BBII", 1, w, d, zlib.crc32(body)) + body
        a2 = lw._as_2d(p.arr)
        anchors = a2[(np.arange(lw._n_anchors(n), dtype=np.int64) + 1) * lw.DBP_MINIBLOCK]
        parts = [a2[0].astype("<u8").tobytes()]
        parts += [anchors[:, c].astype("<u8").tobytes() for c in range(a2.shape[1])]
        body = b"".join(parts + streams)
        widths = bytes(w for w, _, _ in p.cols)
        return struct.pack("<BB", 1, a2.shape[1]) + widths + struct.pack("<I", zlib.crc32(body)) + body


class PageStaging:
    """A writer's reusable buffers for the batched page encode. On a CUDA
    device: pinned host memory for the inputs and the outputs, their
    device twins, and a stream of its own, so the dispatch waits on its
    own work only. On the CPU the host buffers are the device ones. Not
    shared between threads: one writer encodes one batch at a time."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._bufs: dict = {}

    def _buf(self, name: str, words: int, on_device: bool) -> torch.Tensor:
        t = self._bufs.get(name)
        if t is None or t.numel() < words:
            size = max(1 << 16, 1 << (max(words, 1) - 1).bit_length())
            if on_device:
                with torch.cuda.stream(self.stream):
                    t = torch.empty(size, dtype=torch.int32, device=self.device)
            else:
                t = torch.empty(size, dtype=torch.int32, pin_memory=self.cuda)
            self._bufs[name] = t
        return t[:words]

    def host_in(self, words: int) -> torch.Tensor:
        return self._buf("host_in", words, False)

    def context(self):
        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()

    def to_device(self, host: torch.Tensor) -> torch.Tensor:
        """The filled inputs on the device: one non-blocking copy."""
        if not self.cuda:
            return host
        dev = self._buf("dev_in", host.numel(), True)
        dev.copy_(host, non_blocking=True)
        return dev

    def device_out(self, words: int) -> torch.Tensor:
        return self._buf("dev_out" if self.cuda else "host_out", words, self.cuda)

    def to_host(self, dev: torch.Tensor) -> torch.Tensor:
        """The outputs in host memory: one non-blocking copy, read after
        the dispatch's wait."""
        if not self.cuda:
            return dev
        host = self._buf("host_out", dev.numel(), False)
        host.copy_(dev, non_blocking=True)
        return host


def encode_prepared(plans: list, device, staging: PageStaging | None = None) -> list:
    """Encode prepared pages (prepare_page's results; None entries stay
    None) on `device` in one dispatch: stage, copy, launch, copy back,
    wait on the staging's stream, assemble on the codec pool. `staging`
    is the caller's to reuse; without one the call takes its own."""
    from tempo_tpu_torch.encoding.vtpu.codec import map_pages

    live = [p for p in plans if p is not None]
    if not live:
        return [None] * len(plans)
    device = torch.device(device)
    st = staging if staging is not None else PageStaging(device)
    if st.device != device:
        raise ValueError(f"page staging on {st.device}, dispatch on {device}")
    batch = PageBatch(live)
    host_in = st.host_in(batch.in_words)
    batch.fill(host_in.numpy().view(np.uint32))

    def run():
        with st.context():
            data = st.to_device(host_in)
            out = st.device_out(batch.out_words)
            batch.launch(data, out)
            return st.to_host(out)

    if batch.rle_tiles.size or batch.dbp_tiles.size:
        out = timed_dispatch("page_encode", run, device=device, stream=st.stream)
        out_bytes = out.numpy().view(np.uint8)
    else:  # only width-0 streams: nothing to launch
        out_bytes = np.zeros(0, np.uint8)
    pages = iter(map_pages(lambda p: batch.assemble(p, out_bytes), live))
    for p in live:
        device_encode_pages_total.inc(codec=p.codec)
    return [None if p is None else next(pages) for p in plans]


def encode_pages_device(pages: list, device, staging: PageStaging | None = None) -> list:
    """Device-encode a batch of (array, codec) column pages on `device`
    in one dispatch -> page bytes a page, None where the host arm takes
    the page (a codec outside the lightweight tier, or fewer than 2
    rows). The host work before the launch runs on the codec pool. Every
    failure raises: ValueError for a width over the cap (the host
    encoder's contract too), anything else from the kernels."""
    from tempo_tpu_torch.encoding.vtpu.codec import map_pages

    return encode_prepared(map_pages(lambda pc: prepare_page(*pc), pages), device, staging)


def encode_page_device(arr: np.ndarray, codec: str, device) -> bytes | None:
    """Device-encode one column page on `device`: a batch of one."""
    return encode_pages_device([(arr, codec)], device)[0]
