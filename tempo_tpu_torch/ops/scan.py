"""Run-space predicate helpers over rle pages, the dictionary-side
code-set helpers (host numpy), and the device tier's resident scans.

Port of tempo_tpu/ops/scan.py: the host half (NO_MATCH_CODE,
in_set_runs, between_runs, expand_run_mask, runs_firsts_seg,
pad_codes_u32, dict_codes_matching), which the block read path uses to
answer predicates per run without expanding column values, and the
scans over pages resident in the device tier (resident_in_set_mask,
resident_range_mask; reference :169-305). Those run three hand-written
CUDA kernels (csrc/codec_kernels.cu), each beside its plain PyTorch
version:

  resident_rle_scan  per run: value in the code set (or not), or
                     lo <= value <= hi; repeated to the run's rows with
                     jnp.repeat(..., total_repeat_length=n)'s edges;
  resident_dct_scan  the same test once per dictionary entry, gathered
                     by the resident row index;
  resident_dbp_scan  the dbp delta decode with the unsigned 64-bit range
                     compare fused in; only the mask is written.

A wrapper takes the plain version only for tensors that lie on the CPU;
for CUDA tensors it launches its kernels or raises, and counts the calls
that launched in `<wrapper>.launches` (its kernels in
`.kernel_launches`). The resident arrays count as resident, never as
h2d: only the code set or the bounds ship.
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
    wrapper.launches += 1
    wrapper.kernel_launches += launched.value
    return out


def _codes_arg(codes: torch.Tensor | None):
    return (None, 0) if codes is None else (codes.data_ptr(), codes.numel())


def resident_rle_scan(values: torch.Tensor, lengths: torch.Tensor, n: int,
                      codes: torch.Tensor | None = None, invert: bool = False,
                      lo: int = 0, hi: int = 0) -> torch.Tensor:
    """(n,) bool row mask of an rle page: values (R,) uint32 run values as
    int32 bits, lengths (R,) int32; `codes` (K,) uint32 as int32 bits for
    `value in codes` (`not in` with invert), else lo <= value <= hi
    (uint32). On the card: run-tile length sums (pages of more than one
    2,048-run tile), the runs' starts and verdicts, the row expansion."""
    tensors = (values, lengths) + (() if codes is None else (codes,))
    route = _check("resident_rle_scan", *tensors)
    r = values.numel()
    if r == 0 or n == 0:  # no run to repeat: nothing launches
        return torch.zeros(n, dtype=torch.bool, device=values.device)
    if route == "cpu":
        return _rle_scan_plain(values, lengths, n, codes, invert, lo, hi)
    out = torch.empty(n, dtype=torch.bool, device=values.device)
    tile = _build.lib().tt_dbp_tile()
    sums = torch.empty(max(1, -(-r // tile)), dtype=torch.int64, device=values.device)
    packed = torch.empty(max(1, r), dtype=torch.int64, device=values.device)
    codes_p, n_codes = _codes_arg(codes)
    return _launch("resident_rle_scan", resident_rle_scan, "tt_resident_rle_scan", out,
                   values.data_ptr(), lengths.data_ptr(), r, codes_p, n_codes,
                   _mode(codes, invert), lo, hi, n, sums.data_ptr(), packed.data_ptr())


resident_rle_scan.launches = 0
resident_rle_scan.kernel_launches = 0


def resident_dct_scan(values: torch.Tensor, idx: torch.Tensor,
                      codes: torch.Tensor | None = None, invert: bool = False,
                      lo: int = 0, hi: int = 0) -> torch.Tensor:
    """(n,) bool row mask of a dct page: values (V,) uint32 dictionary as
    int32 bits, idx (n,) int32; the verdict once per dictionary entry,
    then gathered by idx. On the card: the entries' verdicts, the
    gather (a programmatic dependent launch)."""
    tensors = (values, idx) + (() if codes is None else (codes,))
    route = _check("resident_dct_scan", *tensors)
    n = idx.numel()
    if n and values.numel() == 0:
        raise ValueError("resident_dct_scan: rows without a dictionary")
    if route == "cpu":
        return _dct_scan_plain(values, idx, codes, invert, lo, hi)
    out = torch.empty(n, dtype=torch.bool, device=values.device)
    if n == 0:
        return out
    verdict = torch.empty(max(1, values.numel()), dtype=torch.uint8, device=values.device)
    codes_p, n_codes = _codes_arg(codes)
    return _launch("resident_dct_scan", resident_dct_scan, "tt_resident_dct_scan", out,
                   values.data_ptr(), values.numel(), idx.data_ptr(), n, codes_p, n_codes,
                   _mode(codes, invert), lo, hi, verdict.data_ptr())


resident_dct_scan.launches = 0
resident_dct_scan.kernel_launches = 0


def resident_dbp_scan(words: torch.Tensor, first: int, width: int, n: int,
                      lo: int, hi: int) -> torch.Tensor:
    """(n,) bool mask lo <= value <= hi (uint64) of a dbp page: words (W,)
    uint32 as int32 bits (the packed zigzag deltas, whole words plus a
    guard word), `first` the page's first value, `width` its delta width.
    The decode takes the low 32 bits of each width-bit field, as the
    reference's _dbp_decode_jit does at any width (pages hold <= 32). On
    the card: tile delta sums (more than one 2,048-row tile), then the
    decode and compare as a programmatic dependent launch."""
    if _check("resident_dbp_scan", words) == "cpu":
        dev = words.device
        return _dbp_scan_plain(words, torch.tensor([first & (2**64 - 1)], dtype=torch.uint64)
                               .view(torch.int64).to(dev),
                               torch.tensor([width], dtype=torch.int32, device=dev), n, lo, hi)
    out = torch.empty(n, dtype=torch.bool, device=words.device)
    if n == 0:
        return out
    sums = torch.empty(max(1, -(-n // _build.lib().tt_dbp_tile())), dtype=torch.int64,
                       device=words.device)
    return _launch("resident_dbp_scan", resident_dbp_scan, "tt_resident_dbp_scan", out,
                   words.data_ptr(), words.numel(), first & (2**64 - 1), width, n, lo, hi,
                   sums.data_ptr())


resident_dbp_scan.launches = 0
resident_dbp_scan.kernel_launches = 0


def _codes_tensor(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint32 code set as the int32 tensor the scans take."""
    return torch.from_numpy(codes.view(np.int32).copy()).to(device)


def _serve(kernel: str, res, fn, h2d: int = 0) -> np.ndarray:
    """One resident scan under the timing seam: the mask comes home as a
    numpy bool array (d2h), the resident arrays count as resident."""
    from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

    dev = next(iter(res.arrays.values())).device
    mask = timed_dispatch(kernel, fn, device=dev).cpu().numpy()
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
    dev = a["values"].device
    padded = pad_codes_u32(codes)
    if res.codec == "rle":
        def fn():
            return resident_rle_scan(a["values"], a["lengths"], n,
                                     codes=_codes_tensor(padded, dev), invert=bool(invert))
    else:
        def fn():
            return resident_dct_scan(a["values"], a["idx"],
                                     codes=_codes_tensor(padded, dev), invert=bool(invert))
    return _serve(f"resident_{res.codec}_scan", res, fn, h2d=padded.nbytes)


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
