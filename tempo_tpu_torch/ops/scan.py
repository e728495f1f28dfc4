"""Run-space predicate helpers over rle pages, the dictionary-side
code-set helpers (host numpy), and the device tier's resident scans.

Port of tempo_tpu/ops/scan.py: the host half (NO_MATCH_CODE,
in_set_runs, between_runs, expand_run_mask, runs_firsts_seg,
pad_codes_u32, dict_codes_matching), which the block read path uses to
answer predicates per run without expanding column values, and the
scans over pages resident in the device tier (resident_in_set_mask,
resident_range_mask; reference :169-305), and their batched forms over
many resident pages (resident_in_set_masks, resident_range_masks). Those
run three hand-written CUDA kernels (csrc/codec_kernels.cu), each beside
its plain PyTorch version:

  resident_rle_scan  per run: value in the code set (or not), or
                     lo <= value <= hi; repeated to the run's rows with
                     jnp.repeat(..., total_repeat_length=n)'s edges;
  resident_dct_scan  the same test once per dictionary entry, gathered
                     by the resident row index;
  resident_dbp_scan  the dbp delta decode with the unsigned 64-bit range
                     compare fused in; only the mask is written.

Each takes one launch a page, and its batched form
(resident_rle_scan_batch, resident_dct_scan_batch,
resident_dbp_scan_batch) one launch over a page table, each page's mask
at its offset of one buffer; the batches' plain versions loop over the
pages' plain versions. The tier keeps each resident page's row of that
table from its admission (page_row).

A wrapper takes the plain version only for tensors that lie on the CPU;
for CUDA tensors it launches its kernels or raises, and counts the calls
that launched in `<wrapper>.launches` (its kernels in
`.kernel_launches`). The resident arrays count as resident, never as
h2d: only the code set or the bounds ship (and a batch's page table).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tempo_tpu_torch.ops import _build
from tempo_tpu_torch.ops.pallas_kernels import _check_cuda, _dbp_decode_plain, _route, _stream

NO_MATCH_CODE = np.uint32(0xFFFFFFFF)  # dictionary code guaranteed unused


def in_set_runs(run_values: np.ndarray, codes: np.ndarray,
                invert: bool = False) -> np.ndarray:
    """Per-RUN in-set verdict: (n_runs,) bool. Row semantics match
    np.isin(expanded, codes, invert=...) exactly — every row of a run
    holds the run's value, so the run verdict IS the row verdict."""
    return np.isin(run_values, codes, invert=invert)


def between_runs(run_values: np.ndarray, lo, hi) -> np.ndarray:
    """Per-run lo <= v <= hi (inclusive both ends)."""
    v = run_values
    return (v >= np.asarray(lo, v.dtype)) & (v <= np.asarray(hi, v.dtype))


def expand_run_mask(run_mask: np.ndarray, run_lengths: np.ndarray,
                    n: int) -> np.ndarray:
    """Run verdicts -> (n,) row mask. A plain repeat: one bool per row,
    never the VALUES — unselected runs are never expanded."""
    if len(run_mask) == 0:
        return np.zeros(n, bool)
    out = np.repeat(run_mask, run_lengths)
    assert len(out) == n, (len(out), n)
    return out


def runs_firsts_seg(run_lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(firsts, seg) row segmentation implied by run lengths: firsts[r]
    = first row of run r, seg[i] = run of row i. For an RLE trace-ID
    column the runs ARE the traces (trace-sorted rows make equal IDs
    maximal stretches), so this replaces trace_segmentation without
    decoding a single ID."""
    lens = np.asarray(run_lengths, np.int64)
    firsts = np.zeros(len(lens), np.int64)
    if len(lens):
        np.cumsum(lens[:-1], out=firsts[1:])
    seg = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    return firsts, seg


def pad_codes_u32(codes: np.ndarray) -> np.ndarray:
    """Pow2-pad a code set by REPEATING its first code (bounds a kernel's
    code-table shapes without changing membership — unlike a sentinel
    pad, which would alter verdicts for columns that contain the
    sentinel). An empty set becomes [NO_MATCH_CODE]."""
    codes = np.asarray(codes).astype(np.uint32, copy=False).reshape(-1)
    if codes.size == 0:
        codes = np.array([NO_MATCH_CODE], np.uint32)
    k = 1
    while k < codes.size:
        k <<= 1
    if k == codes.size:
        return codes
    return np.concatenate([codes, np.full(k - codes.size, codes[0], np.uint32)])


def dict_codes_matching(entries: list, predicate) -> np.ndarray:
    """Apply a python string predicate to dictionary entries -> uint32 codes.

    Regex/substring/prefix never run on the device — only over the
    (small) dictionary, exactly like the reference prunes pages by
    dictionary before scanning (pkg/parquetquery/predicates.go:446).
    Returns [NO_MATCH_CODE] when nothing matches.
    """
    codes = [i for i, e in enumerate(entries) if predicate(e)]
    if not codes:
        return np.array([NO_MATCH_CODE], dtype=np.uint32)
    return np.asarray(codes, dtype=np.uint32)


# ---------------------------------------------------------------------------
# resident-tier scans (device-resident COMPRESSED pages)
# ---------------------------------------------------------------------------
#
# The hot tier (encoding/vtpu/colcache.DeviceTier) parks encoded page
# forms — rle runs, dct dictionary+indices, dbp packed words — as device
# tensors (uint32 as int32 bits). A scan that hits the tier never touches
# fetch/decode/h2d: the kernels fuse the (bit-exact) device decode into
# the predicate compare, and the only bytes that ship per query are the
# predicate's code set (a few hundred bytes) or, by value in the launch,
# its bounds. Code-set padding repeats a real code (pad_codes_u32), so
# membership is np.isin bit for bit even against pathological values.

_IN_SET, _NOT_IN_SET, _BETWEEN = 0, 1, 2
_PAGE_FIELDS = 8  # a page of a resident scan: int64 x 8 (csrc/codec_kernels.cu ScanPage)


def _mode(codes, invert: bool) -> int:
    if codes is None:
        return _BETWEEN
    return _NOT_IN_SET if invert else _IN_SET


def _verdict_plain(values: torch.Tensor, codes: torch.Tensor | None, invert: bool,
                   lo: int, hi: int) -> torch.Tensor:
    """Per-value verdict over uint32 values held as int32 bits, compared
    as unsigned (widened to int64, as pallas_kernels.u32_bits' inverse)."""
    v = values.to(torch.int64) & 0xFFFFFFFF
    if codes is None:
        return (v >= lo) & (v <= hi)
    hit = torch.isin(v, codes.to(torch.int64) & 0xFFFFFFFF)
    return ~hit if invert else hit


def _repeat_plain(run_hit: torch.Tensor, lengths: torch.Tensor, n: int) -> torch.Tensor:
    """jnp.repeat(run_hit, lengths, total_repeat_length=n): row r takes
    the verdict of the LAST run whose start (the exclusive prefix sum of
    lengths) is <= r, so rows past the runs' total take the last run's
    verdict and runs past n are cut."""
    ln = lengths.to(torch.int64)
    starts = torch.cumsum(ln, 0) - ln
    rows = torch.arange(n, dtype=torch.int64, device=run_hit.device)
    run = torch.searchsorted(starts, rows, right=True) - 1
    return run_hit[run]


def _rle_scan_plain(values, lengths, n, codes, invert, lo, hi) -> torch.Tensor:
    return _repeat_plain(_verdict_plain(values, codes, invert, lo, hi), lengths, n)


def _dct_scan_plain(values, idx, codes, invert, lo, hi) -> torch.Tensor:
    """The verdict once per dictionary entry, gathered by idx as jnp
    indexing reads it: a negative index from the end, one past the end
    clamped."""
    v = values.numel()
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + v, i).clamp(0, v - 1)
    return _verdict_plain(values, codes, invert, lo, hi)[i]


def _dbp_scan_plain(words, first, width, n, lo, hi) -> torch.Tensor:
    """The plain dbp decode (pallas_kernels._dbp_decode_plain, the
    reference's _dbp_decode_jit for every width) then the unsigned
    64-bit compare as (hi, lo) limbs, as the reference does."""
    v = _dbp_decode_plain(words[None, :], first.reshape(1), width.reshape(1), n)[0]
    vh, vl = (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF
    lo_h, lo_l, hi_h, hi_l = lo >> 32, lo & 0xFFFFFFFF, hi >> 32, hi & 0xFFFFFFFF
    ge = (vh > lo_h) | ((vh == lo_h) & (vl >= lo_l))
    le = (vh < hi_h) | ((vh == hi_h) & (vl <= hi_l))
    return ge & le


def _check(kernel: str, *tensors: torch.Tensor) -> str:
    """The wrapper's route ("cpu" or "cuda"); the scans take 1-D int32
    tensors only, on one device and contiguous on the card."""
    if any(t.dtype != torch.int32 or t.ndim != 1 for t in tensors):
        raise ValueError(f"{kernel}: 1-D int32 tensors only")
    route = _route(kernel, tensors[0])
    if route == "cuda":
        _check_cuda(kernel, *tensors)
    return route


def _launch(kernel: str, wrapper, entry: str, out: torch.Tensor, *args) -> torch.Tensor:
    launched = ctypes.c_int32(0)
    with torch.cuda.device(out.device):
        err = getattr(_build.lib(), entry)(*args, out.data_ptr(), ctypes.byref(launched),
                                           _stream(out))
    _build.check(err, kernel)
    wrapper.launches += 1 if launched.value else 0
    wrapper.kernel_launches += launched.value
    return out


def _as_codes(codes) -> torch.Tensor | None:
    """A code set as a 1-D int32 tensor of uint32 bits: a tensor as it
    is, a numpy array or sequence as a CPU tensor."""
    if codes is None or isinstance(codes, torch.Tensor):
        if codes is not None and (codes.dtype != torch.int32 or codes.ndim != 1):
            raise ValueError("codes: a 1-D int32 tensor of uint32 bits")
        return codes
    return torch.from_numpy(np.asarray(codes).astype(np.uint32).view(np.int32).reshape(-1))


def _scan_codes(codes: torch.Tensor | None, device: torch.device):
    """(host pointer, device pointer, count, keep) of a code set for the
    rle and dct kernels: a CPU code set of at most
    tt_resident_scan_codes() codes goes by value in the launch, a larger
    one is copied to the card once, one already on the card is read
    there. `keep` holds the tensors until the launch is enqueued."""
    if codes is None:
        return None, None, 0, None
    if codes.device.type == "cuda":
        if codes.device != device or not codes.is_contiguous():
            raise ValueError("codes: contiguous, on the scanned page's device")
        return None, codes.data_ptr(), codes.numel(), codes
    codes = codes.contiguous()
    if codes.numel() <= _build.lib().tt_resident_scan_codes():
        return codes.data_ptr(), None, codes.numel(), codes
    dev_codes = codes.to(device)
    return None, dev_codes.data_ptr(), codes.numel(), dev_codes


def _u64_bits(x: int) -> int:
    """A uint64 as the int64 with its bits."""
    x &= 2**64 - 1
    return x - 2**64 if x >= 2**63 else x


def resident_rle_scan(values: torch.Tensor, lengths: torch.Tensor, n: int,
                      codes=None, invert: bool = False,
                      lo: int = 0, hi: int = 0) -> torch.Tensor:
    """(n,) bool row mask of an rle page: values (R,) uint32 run values as
    int32 bits, lengths (R,) int32; `codes` (K,) uint32 (int32 bits as a
    tensor, or a numpy array) for `value in codes` (`not in` with invert),
    else lo <= value <= hi (uint32). On the card: one launch, the code set
    by value (a CPU set of up to tt_resident_scan_codes() codes)."""
    route = _check("resident_rle_scan", values, lengths)
    codes = _as_codes(codes)
    r = values.numel()
    if r == 0 or n == 0:  # no run to repeat: nothing launches
        return torch.zeros(n, dtype=torch.bool, device=values.device)
    if route == "cpu":
        return _rle_scan_plain(values, lengths, n, None if codes is None else codes.cpu(),
                               invert, lo, hi)
    out = torch.empty(n, dtype=torch.bool, device=values.device)
    page = (ctypes.c_int64 * _PAGE_FIELDS)(values.data_ptr(), lengths.data_ptr(), r, n,
                                           0, 0, 0, 0)
    codes_h, codes_d, k, _keep = _scan_codes(codes, values.device)
    return _launch("resident_rle_scan", resident_rle_scan, "tt_resident_rle_scan", out, page,
                   codes_h, k, codes_d, _mode(codes, invert), lo, hi)


resident_rle_scan.launches = 0
resident_rle_scan.kernel_launches = 0


def resident_dct_scan(values: torch.Tensor, idx: torch.Tensor, codes=None,
                      invert: bool = False, lo: int = 0, hi: int = 0) -> torch.Tensor:
    """(n,) bool row mask of a dct page: values (V,) uint32 dictionary as
    int32 bits, idx (n,) int32; `codes` as resident_rle_scan's, else lo <=
    value <= hi (uint32); the verdict once per dictionary entry, then
    gathered by idx. On the card: one launch, the code set by value (a
    CPU set of up to tt_resident_scan_codes() codes)."""
    route = _check("resident_dct_scan", values, idx)
    codes = _as_codes(codes)
    n = idx.numel()
    if n and values.numel() == 0:
        raise ValueError("resident_dct_scan: rows without a dictionary")
    if route == "cpu":
        return _dct_scan_plain(values, idx, None if codes is None else codes.cpu(), invert,
                               lo, hi)
    out = torch.empty(n, dtype=torch.bool, device=values.device)
    if n == 0:
        return out
    page = (ctypes.c_int64 * _PAGE_FIELDS)(values.data_ptr(), idx.data_ptr(), values.numel(), n,
                                           0, 0, 0, 0)
    codes_h, codes_d, k, _keep = _scan_codes(codes, values.device)
    return _launch("resident_dct_scan", resident_dct_scan, "tt_resident_dct_scan", out, page,
                   codes_h, k, codes_d, _mode(codes, invert), lo, hi)


resident_dct_scan.launches = 0
resident_dct_scan.kernel_launches = 0


def _dbp_first_width(first: int, width: int, device: torch.device):
    """The plain version's (1,) first (uint64 bits as int64) and width."""
    return (torch.tensor([_u64_bits(first)], dtype=torch.int64, device=device),
            torch.tensor([width], dtype=torch.int32, device=device))


def resident_dbp_scan(words: torch.Tensor, first: int, width: int, n: int,
                      lo: int, hi: int) -> torch.Tensor:
    """(n,) bool mask lo <= value <= hi (uint64) of a dbp page: words (W,)
    uint32 as int32 bits (the packed zigzag deltas, whole words plus a
    guard word), `first` the page's first value, `width` its delta width.
    The decode takes the low 32 bits of each width-bit field, as the
    reference's _dbp_decode_jit does at any width (pages hold <= 32). On
    the card: one launch."""
    if not 0 <= width <= 64:
        raise ValueError(f"resident_dbp_scan: width {width} outside 0..64")
    if _check("resident_dbp_scan", words) == "cpu":
        f, w = _dbp_first_width(first, width, words.device)
        return _dbp_scan_plain(words, f, w, n, lo, hi)
    out = torch.empty(n, dtype=torch.bool, device=words.device)
    if n == 0:
        return out
    page = (ctypes.c_int64 * _PAGE_FIELDS)(words.data_ptr(), 0, words.numel(), n,
                                           _u64_bits(first), width, 0, 0)
    return _launch("resident_dbp_scan", resident_dbp_scan, "tt_resident_dbp_scan", out, page,
                   lo & (2**64 - 1), hi & (2**64 - 1))


resident_dbp_scan.launches = 0
resident_dbp_scan.kernel_launches = 0


# ---------------------------------------------------------------------------
# batched scans: one launch over a page table
# ---------------------------------------------------------------------------

def _offsets(ns) -> tuple[np.ndarray, int]:
    """Each page's mask offset in the batch's buffer (16-byte aligned, so
    the kernel's row stores stay whole) and the buffer's size."""
    sizes = -(-np.asarray(ns, np.int64) // 16) * 16
    return np.cumsum(sizes) - sizes, int(sizes.sum())


def page_row(codec: str, arrays: dict, meta: dict) -> np.ndarray | None:
    """A resident page's row of the batched scans' page table (ScanPage:
    8 int64, the mask's offset 0), or None for a codec without a resident
    scan: rle values, lengths, runs, n; dct dictionary, idx, entries, n;
    dbp words, 0, words, n, first (uint64 bits), width."""
    n = int(meta.get("n", 0))
    if codec == "rle":
        a, b = arrays["values"], arrays["lengths"]
        row = [a.data_ptr(), b.data_ptr(), a.numel(), n, 0, 0]
    elif codec == "dct":
        a, b = arrays["values"], arrays["idx"]
        row = [a.data_ptr(), b.data_ptr(), a.numel(), n, 0, 0]
    elif codec == "dbp":
        w = arrays["words"]
        row = [w.data_ptr(), 0, w.numel(), n, _u64_bits(int(meta["first"])), int(meta["width"])]
    else:
        return None
    return np.array(row + [0, 0], np.int64)


def _batch_launch(kernel: str, wrapper, entry: str, rows: np.ndarray, device: torch.device,
                  *args) -> tuple[torch.Tensor, list[int]]:
    """Launch `entry` over the page table `rows` ((pages, 8) int64, rows n
    in field 3) into one buffer; returns (buffer, offsets). The table goes
    to the card in one pinned copy on the current stream, each page's
    offset written into field 6 on the way: a pinned block of its own a
    call, which the host allocator hands out again only once the copy is
    done, so concurrent callers never share one."""
    offs, total = _offsets(rows[:, 3])
    table_h = torch.empty(rows.shape, dtype=torch.int64, pin_memory=True)
    t = table_h.numpy()
    t[:] = rows
    t[:, 6] = offs
    table = table_h.to(device, non_blocking=True)
    out = torch.empty(total, dtype=torch.bool, device=device)
    _launch(kernel, wrapper, entry, out, table.data_ptr(), len(rows), int(rows[:, 3].max()),
            *args)
    return out, offs.tolist()


def _batch_plain(pages, ns, scan_page) -> tuple[torch.Tensor, list[int]]:
    """The plain version of a batch of pages of ns rows: each page's
    scan_page(page) at its offset of one buffer (zeros where it is None)."""
    offs, total = _offsets(ns)
    out = torch.zeros(total, dtype=torch.bool, device=pages[0][0].device)
    for page, n, off in zip(pages, ns, offs):
        mask = scan_page(page) if n else None
        if mask is not None:
            out[off:off + n] = mask
    return out, offs.tolist()


def _rle_scan_batch_plain(pages, codes, invert, lo, hi) -> tuple[torch.Tensor, list[int]]:
    return _batch_plain(  # a page of no run: no row in the set
        pages, [n for _, _, n in pages],
        lambda p: _rle_scan_plain(p[0], p[1], p[2], codes, invert, lo, hi)
        if p[0].numel() else None)


def resident_rle_scan_batch(pages: list, codes=None, invert: bool = False, lo: int = 0,
                            hi: int = 0, rows: np.ndarray | None = None
                            ) -> tuple[torch.Tensor, list[int]]:
    """resident_rle_scan over many pages [(values, lengths, n)] on one
    device in one launch: (buffer, offsets), page i's mask at
    buffer[offsets[i]:offsets[i] + n_i], equal to its resident_rle_scan.
    rows: the pages' page_row rows stacked, where the caller keeps them."""
    if not pages:
        raise ValueError("resident_rle_scan_batch: no page")
    route = _check("resident_rle_scan_batch", *(t for v, ln, _ in pages for t in (v, ln)))
    codes = _as_codes(codes)
    if route == "cpu":
        return _rle_scan_batch_plain(pages, None if codes is None else codes.cpu(), invert,
                                     lo, hi)
    device = pages[0][0].device
    if rows is None:
        rows = np.stack([page_row("rle", {"values": v, "lengths": ln}, {"n": n})
                         for v, ln, n in pages])
    codes_h, codes_d, k, _keep = _scan_codes(codes, device)
    return _batch_launch("resident_rle_scan_batch", resident_rle_scan_batch,
                         "tt_resident_rle_scan_batch", rows, device,
                         codes_h, k, codes_d, _mode(codes, invert), lo, hi)


resident_rle_scan_batch.launches = 0
resident_rle_scan_batch.kernel_launches = 0


def _dct_scan_batch_plain(pages, codes, invert, lo, hi) -> tuple[torch.Tensor, list[int]]:
    return _batch_plain(pages, [idx.numel() for _, idx in pages],
                        lambda p: _dct_scan_plain(p[0], p[1], codes, invert, lo, hi))


def resident_dct_scan_batch(pages: list, codes=None, invert: bool = False, lo: int = 0,
                            hi: int = 0, rows: np.ndarray | None = None
                            ) -> tuple[torch.Tensor, list[int]]:
    """resident_dct_scan over many pages [(values, idx)] on one device in
    one launch: (buffer, offsets) as resident_rle_scan_batch, each page's
    mask equal to its resident_dct_scan."""
    if not pages:
        raise ValueError("resident_dct_scan_batch: no page")
    route = _check("resident_dct_scan_batch", *(t for p in pages for t in p))
    if any(idx.numel() and not values.numel() for values, idx in pages):
        raise ValueError("resident_dct_scan_batch: rows without a dictionary")
    codes = _as_codes(codes)
    if route == "cpu":
        return _dct_scan_batch_plain(pages, None if codes is None else codes.cpu(), invert,
                                     lo, hi)
    device = pages[0][0].device
    if rows is None:
        rows = np.stack([page_row("dct", {"values": v, "idx": i}, {"n": i.numel()})
                         for v, i in pages])
    codes_h, codes_d, k, _keep = _scan_codes(codes, device)
    return _batch_launch("resident_dct_scan_batch", resident_dct_scan_batch,
                         "tt_resident_dct_scan_batch", rows, device, int(rows[:, 2].max()),
                         codes_h, k, codes_d, _mode(codes, invert), lo, hi)


resident_dct_scan_batch.launches = 0
resident_dct_scan_batch.kernel_launches = 0


def _dbp_scan_batch_plain(pages, lo, hi) -> tuple[torch.Tensor, list[int]]:
    def one(p):
        f, w = _dbp_first_width(p[1], p[2], p[0].device)
        return _dbp_scan_plain(p[0], f, w, p[3], lo, hi)

    return _batch_plain(pages, [p[3] for p in pages], one)


def resident_dbp_scan_batch(pages: list, lo: int, hi: int, rows: np.ndarray | None = None
                            ) -> tuple[torch.Tensor, list[int]]:
    """resident_dbp_scan over many pages [(words, first, width, n)] on one
    device in one launch: (buffer, offsets) as resident_rle_scan_batch."""
    if not pages:
        raise ValueError("resident_dbp_scan_batch: no page")
    if any(not 0 <= width <= 64 for _, _, width, _ in pages):
        raise ValueError("resident_dbp_scan_batch: a width outside 0..64")
    route = _check("resident_dbp_scan_batch", *(p[0] for p in pages))
    if route == "cpu":
        return _dbp_scan_batch_plain(pages, lo, hi)
    if rows is None:
        rows = np.stack([page_row("dbp", {"words": w}, {"n": n, "first": first, "width": width})
                         for w, first, width, n in pages])
    return _batch_launch("resident_dbp_scan_batch", resident_dbp_scan_batch,
                         "tt_resident_dbp_scan_batch", rows, pages[0][0].device,
                         lo & (2**64 - 1), hi & (2**64 - 1))


resident_dbp_scan_batch.launches = 0
resident_dbp_scan_batch.kernel_launches = 0


# ---------------------------------------------------------------------------
# serving: masks of resident entries (colcache._Resident) as numpy arrays
# ---------------------------------------------------------------------------


def _home(out: torch.Tensor) -> torch.Tensor:
    """A mask's copy home: on the card, enqueued into pinned memory on the
    current stream (the dispatch's wait covers it)."""
    if out.device.type != "cuda":
        return out
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    return host


def _dispatch(kernel: str, device: torch.device, fn):
    """fn() under the timing seam, waiting on an event of the current
    stream (the launches' and the copy's), never on the whole device."""
    from tempo_tpu_torch.util.devicetiming import timed_dispatch

    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    return timed_dispatch(kernel, fn, device=device, stream=stream)


def _serve(kernel: str, res, fn, h2d: int = 0) -> np.ndarray:
    """One resident scan: the mask comes home as a numpy bool array
    (d2h), the resident arrays count as resident."""
    from tempo_tpu_torch.util.devicetiming import count_transfer

    dev = next(iter(res.arrays.values())).device
    mask = _dispatch(kernel, dev, lambda: _home(fn())).numpy()
    count_transfer(kernel, h2d=h2d, d2h=mask.nbytes, resident=res.nbytes)
    return mask


def resident_in_set_mask(res, codes: np.ndarray,
                         invert: bool = False) -> np.ndarray | None:
    """Row mask for `column in codes` served from one resident entry
    (colcache._Resident: .codec/.arrays/.meta), or None when the
    resident form cannot answer (dbp). Only the padded code set ships."""
    n = int(res.meta["n"])
    if res.codec not in ("rle", "dct"):
        return None
    if n == 0:
        return np.zeros(0, bool)
    a = res.arrays
    padded = torch.from_numpy(pad_codes_u32(codes).view(np.int32))  # by value in the launch
    if res.codec == "rle":
        def fn():
            return resident_rle_scan(a["values"], a["lengths"], n, codes=padded,
                                     invert=bool(invert))
    else:
        def fn():
            return resident_dct_scan(a["values"], a["idx"], codes=padded, invert=bool(invert))
    return _serve(f"resident_{res.codec}_scan", res, fn, h2d=padded.numel() * 4)


def resident_range_mask(res, lo, hi) -> np.ndarray | None:
    """Row mask for lo <= column <= hi from one resident entry; dbp
    pages answer by fusing the device delta-decode into the compare."""
    n = int(res.meta["n"])
    if res.codec not in ("rle", "dct", "dbp"):
        return None
    if n == 0:
        return np.zeros(0, bool)
    a = res.arrays
    if res.codec == "rle":
        lo32, hi32 = int(np.uint32(lo)), int(np.uint32(hi))
        return _serve("resident_rle_scan", res, lambda: resident_rle_scan(
            a["values"], a["lengths"], n, lo=lo32, hi=hi32))
    if res.codec == "dct":
        lo32, hi32 = int(np.uint32(lo)), int(np.uint32(hi))
        return _serve("resident_dct_scan", res, lambda: resident_dct_scan(
            a["values"], a["idx"], lo=lo32, hi=hi32))
    # the four bound limbs ship as the reference's (4,) uint32 array
    # does, here by value in the launch
    return _serve("resident_dbp_scan", res, lambda: resident_dbp_scan(
        a["words"], int(res.meta["first"]), int(res.meta["width"]), n,
        int(lo) & (2**64 - 1), int(hi) & (2**64 - 1)), h2d=16)


def _serve_batch(kernel: str, entries: list, fn, h2d: int) -> list[np.ndarray]:
    """One batched scan over resident entries: fn(rows) with the entries'
    page table rows stacked, one dispatch, the buffer home in one copy;
    returns each entry's mask (a view of it). The page table ships with the
    code set or bounds."""
    from tempo_tpu_torch.util.devicetiming import count_transfer

    dev = next(iter(entries[0].arrays.values())).device
    rows = np.stack([r.row for r in entries]) if dev.type == "cuda" else None

    def run():
        out, offs = fn(rows)
        return _home(out), offs

    buf, offs = _dispatch(kernel, dev, run)
    flat = buf.numpy()
    table = _PAGE_FIELDS * 8 * len(entries) if dev.type == "cuda" else 0
    count_transfer(kernel, h2d=h2d + table, d2h=flat.nbytes,
                   resident=sum(r.nbytes for r in entries))
    return [flat[o:o + int(r.meta["n"])] for r, o in zip(entries, offs)]


def _by_codec(entries: list, codecs: tuple, what: str) -> dict:
    """{codec: [index in entries]} in the entries' order; raises on a codec
    outside `codecs`."""
    groups: dict = {}
    for i, r in enumerate(entries):
        if r.codec not in codecs:
            names = ", ".join(codecs[:-1]) + " and " + codecs[-1]
            raise ValueError(f"{what}: {names} entries only, not {r.codec}")
        groups.setdefault(r.codec, []).append(i)
    return groups


def _pages(codec: str, group: list) -> list:
    """The batched scan's pages of resident entries of one codec."""
    if codec == "rle":
        return [(r.arrays["values"], r.arrays["lengths"], int(r.meta["n"])) for r in group]
    if codec == "dct":
        return [(r.arrays["values"], r.arrays["idx"]) for r in group]
    return [(r.arrays["words"], int(r.meta["first"]), int(r.meta["width"]), int(r.meta["n"]))
            for r in group]


def resident_in_set_masks(entries: list, codes: np.ndarray,
                          invert: bool = False) -> list[np.ndarray]:
    """resident_in_set_mask of many resident rle and dct entries on one
    device: one launch a codec (resident_rle_scan_batch,
    resident_dct_scan_batch), one mask per entry in their order, each equal
    to the entry's own."""
    groups = _by_codec(entries, ("rle", "dct"), "resident_in_set_masks")
    out: list = [None] * len(entries)
    padded = torch.from_numpy(pad_codes_u32(codes).view(np.int32))
    batch = {"rle": resident_rle_scan_batch, "dct": resident_dct_scan_batch}
    for codec, idx in groups.items():
        group = [entries[i] for i in idx]
        pages = _pages(codec, group)
        masks = _serve_batch(f"resident_{codec}_scan", group,
                             lambda rows, batch_fn=batch[codec], pages=pages: batch_fn(
                                 pages, codes=padded, invert=bool(invert), rows=rows),
                             h2d=padded.numel() * 4)
        for i, m in zip(idx, masks):
            out[i] = m
    return out


def resident_range_masks(entries: list, lo, hi) -> list[np.ndarray]:
    """resident_range_mask of many resident rle, dct and dbp entries on one
    device: one launch a codec (resident_rle_scan_batch,
    resident_dct_scan_batch, resident_dbp_scan_batch), one mask per entry in
    their order, each equal to the entry's own."""
    groups = _by_codec(entries, ("rle", "dct", "dbp"), "resident_range_masks")
    out: list = [None] * len(entries)
    lo32, hi32 = int(np.uint32(lo)), int(np.uint32(hi))
    lo64, hi64 = int(lo) & (2**64 - 1), int(hi) & (2**64 - 1)
    for codec, idx in groups.items():
        group = [entries[i] for i in idx]
        pages = _pages(codec, group)

        def fn(rows, codec=codec, pages=pages):
            if codec == "rle":
                return resident_rle_scan_batch(pages, lo=lo32, hi=hi32, rows=rows)
            if codec == "dct":
                return resident_dct_scan_batch(pages, lo=lo32, hi=hi32, rows=rows)
            return resident_dbp_scan_batch(pages, lo64, hi64, rows=rows)

        # dbp's four bound limbs ship as the reference's (4,) uint32 array
        # does, here by value in the launch
        masks = _serve_batch(f"resident_{codec}_scan", group, fn, h2d=16 if codec == "dbp" else 0)
        for i, m in zip(idx, masks):
            out[i] = m
    return out
