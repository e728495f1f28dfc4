"""The three kernels that the JAX package wrote in Pallas, for Hopper.

Port of tempo_tpu/ops/pallas_kernels.py: seg_bincount (+ the host
pre-pass compress_slot_runs), in_set_scan and u64_range_scan, with the
same arguments and the same results, and the dbp page decode
(dbp_decode_limbs, dbp_decode_device: a dbp page decoded on the card; the
compiled query tier fuses the same tile machinery into its own program),
and the fused run-length decode + in-set scan of the mesh and batched
searches (rle_cols_hit, rle_cols_hit_live, fused_rle_in_set,
batched_rle_in_set, over one body rle_hit_lanes: the JAX package's jnp
program became the rle_cols_hit kernel). Each kernel is CUDA C++ in
csrc/kernels.cu (csrc/codec_kernels.cu for the decode and the fused
scan), built with nvcc at first use (ops/_build.py) and launched
through ctypes on PyTorch's current stream.

Beside each kernel sits its plain PyTorch version (_seg_bincount_plain,
_in_set_plain, _range_plain, _dbp_decode_plain, _rle_hit_plain). A
wrapper takes the plain version only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel or raises. Each wrapper counts its kernel launches in a plain
integer attribute, `<wrapper>.launches`.

seg_bincount and u64_range_scan take uint32 data as int32 tensors with
the same bits (`u32_bits`), since torch's uint32 dtype lacks most
operators; in_set_scan reads integer columns of any width where they lie.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tempo_tpu_torch.ops import _build

TILE = 1024
NO_MATCH_CODE = np.uint32(0xFFFFFFFF)  # sentinel code: matches no dictionary entry
_MAX_CODE_TABLE = 48 * 1024 // 4  # codes of one launch that fit its shared memory


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor of uint32 values -> int32 tensor with the same bits."""
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: non-contiguous input")


def _route(kernel: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# segmented bincount (the TraceQL metrics reduction)
# ---------------------------------------------------------------------------


def _seg_bincount_plain_into(out: torch.Tensor, slots: torch.Tensor, n_slots: int,
                             weights: torch.Tensor | None) -> None:
    """Plain version, adding into out: out[s] += w for slots in [0, n_slots)."""
    live = (slots >= 0) & (slots < n_slots)
    idx = torch.where(live, slots, 0).to(torch.int64)
    w = (live.to(torch.int64) if weights is None
         else torch.where(live, weights.to(torch.int64), 0))
    out.index_add_(0, idx, w)


def _seg_bincount_plain(slots: torch.Tensor, n_slots: int,
                        weights: torch.Tensor | None) -> torch.Tensor:
    """Plain version: counts[s] += w for slots in [0, n_slots); int64."""
    out = torch.zeros(n_slots, dtype=torch.int64, device=slots.device)
    _seg_bincount_plain_into(out, slots, n_slots, weights)
    return out


def _seg_bincount_cuda(out: torch.Tensor, slots: torch.Tensor, n_slots: int,
                       weights: torch.Tensor | None) -> None:
    if slots.dtype != torch.int32 or (weights is not None and weights.dtype != torch.int32):
        raise TypeError("seg_bincount: slots and weights must be int32")
    _check_cuda("seg_bincount", out, slots, *(() if weights is None else (weights,)))
    lib = _build.lib()
    with torch.cuda.device(slots.device):
        err = lib.tt_seg_bincount(
            slots.data_ptr(), None if weights is None else weights.data_ptr(),
            slots.numel(), n_slots, out.data_ptr(), _stream(slots))
    _build.check(err, "seg_bincount")
    seg_bincount.launches += 1


def seg_bincount_into(out: torch.Tensor, slots: torch.Tensor, n_slots: int,
                       weights: torch.Tensor | None = None) -> None:
    """seg_bincount that adds its counts into `out`, an (n_slots,) int64
    vector on the slots' device, in place of returning a fresh one: the
    metrics accumulator folds every flush of a query into one vector that
    stays on the card. An empty input launches nothing."""
    if slots.ndim != 1:
        raise ValueError("seg_bincount: slots must be 1-D")
    if weights is not None and weights.shape != slots.shape:
        raise ValueError("seg_bincount: weights and slots differ in shape")
    if not 0 < n_slots < 2**31:
        raise ValueError(f"seg_bincount: n_slots {n_slots} out of range")
    if out.dtype != torch.int64 or out.shape != (n_slots,):
        raise ValueError(f"seg_bincount: out must be ({n_slots},) int64")
    if slots.shape[0] == 0:
        return
    if _route("seg_bincount", slots) == "cpu":
        _seg_bincount_plain_into(out, slots, n_slots, weights)
    else:
        _seg_bincount_cuda(out, slots, n_slots, weights)


def seg_bincount(slots: torch.Tensor, n_slots: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Count occurrences of each slot id in [0, n_slots), each weighted
    by `weights` (the run-length form from compress_slot_runs) when
    given. Negative ids and ids >= n_slots are dropped. slots, weights:
    (N,) int32 on one device. Returns (n_slots,) int64 on that device;
    the counts are exact integers at any size."""
    out = torch.zeros(n_slots, dtype=torch.int64, device=slots.device)
    seg_bincount_into(out, slots, n_slots, weights)
    return out


seg_bincount.launches = 0


def compress_slot_runs(slots: np.ndarray, max_fraction: float = 0.75):
    """Run-compress a slot stream: consecutive equal slot ids collapse to
    one (slot, weight) pair, exact for the weighted counts. Streams that
    barely compress return (slots, None). Host numpy, as in the JAX
    package."""
    n = len(slots)
    if n == 0:
        return slots.astype(np.int32), np.zeros(0, np.int32)
    if n > 512:
        # cheap prefix probe before paying the full boundary pass
        head = int(np.count_nonzero(slots[1:257] != slots[:256]))
        if head > 256 * max_fraction:
            return slots, None
    new = np.ones(n, bool)
    new[1:] = slots[1:] != slots[:-1]
    r = int(np.count_nonzero(new))
    if r > n * max_fraction:
        return slots, None
    firsts = np.flatnonzero(new)
    weights = np.diff(np.append(firsts, n)).astype(np.int32)
    return slots[firsts].astype(np.int32), weights


# ---------------------------------------------------------------------------
# fused multi-column in-set scan
# ---------------------------------------------------------------------------

# integer dtypes the kernel reads in place: element bytes, signed
_IN_PLACE = {
    torch.bool: (1, False), torch.uint8: (1, False), torch.int8: (1, True),
    torch.uint16: (2, False), torch.int16: (2, True),
    torch.uint32: (4, False), torch.int32: (4, False),
    torch.uint64: (8, False), torch.int64: (8, False),
}
_MAX_KERNEL_COLS = 8  # columns one launch takes; more take further launches


def _code_table(code_sets: list[torch.Tensor]) -> torch.Tensor:
    """(C, S) int32 table of uint32 code bits, each row padded with
    NO_MATCH_CODE to one power-of-two width S, built on the device of the
    first code set."""
    s_pad = 1
    while s_pad < max(cs.shape[0] for cs in code_sets):
        s_pad <<= 1
    dev = code_sets[0].device
    codes = torch.full((len(code_sets), s_pad), -1, dtype=torch.int32, device=dev)
    for c, cs in enumerate(code_sets):
        codes[c, : cs.shape[0]] = u32_bits(cs.to(dev))
    return codes


def _in_set_plain(cols: list[torch.Tensor], codes: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Plain version: cols C (n,) integer tensors, codes (C, S) uint32 bits
    -> (n_pad,) bool, AND over c of (cols[c][r] in codes[c]), False from row n."""
    n = cols[0].shape[0]
    hit = torch.ones(n, dtype=torch.bool, device=codes.device)
    for c, col in enumerate(cols):
        hit &= (u32_bits(col)[:, None] == codes[c][None, :]).any(dim=1)
    out = torch.zeros(n_pad, dtype=torch.bool, device=codes.device)
    out[:n] = hit
    return out


def _in_set_cuda(cols: list[torch.Tensor], codes: torch.Tensor, n_pad: int) -> torch.Tensor:
    C, s_pad = codes.shape
    if codes.dtype != torch.int32:
        raise TypeError("in_set_scan: codes must be int32 bit patterns")
    if min(C, _MAX_KERNEL_COLS) * s_pad > _MAX_CODE_TABLE:
        raise ValueError(f"in_set_scan: code table {tuple(codes.shape)} does not fit")
    # integer columns are read where they lie, at their own width; others
    # (float) become uint32 bits first, as u32_bits gives them
    cols = [(c if c.dtype in _IN_PLACE else u32_bits(c)).contiguous() for c in cols]
    _check_cuda("in_set_scan", codes, *cols)
    widths = [_IN_PLACE[c.dtype][0] for c in cols]
    sign = sum(1 << i for i, c in enumerate(cols) if _IN_PLACE[c.dtype][1])
    lib = _build.lib()
    out = torch.empty(n_pad, dtype=torch.bool, device=codes.device)
    with torch.cuda.device(codes.device):
        err = lib.tt_in_set_scan((ctypes.c_void_p * C)(*(c.data_ptr() for c in cols)),
                                 (ctypes.c_int32 * C)(*widths), sign, C, codes.data_ptr(),
                                 s_pad, cols[0].shape[0], n_pad, out.data_ptr(),
                                 _stream(codes))
    _build.check(err, "in_set_scan")
    in_set_scan.launches += -(-C // _MAX_KERNEL_COLS)
    return out


def in_set_scan(cols: list[torch.Tensor], code_sets: list[torch.Tensor],
                n_pad: int) -> torch.Tensor:
    """Fused AND-of-in-set scan: row r matches iff for every predicate c,
    cols[c][r] is in code_sets[c]. cols: C (n,) integer tensors of
    dictionary codes on one device; code_sets: C tensors of candidate
    codes (ragged, padded to one power-of-two width with NO_MATCH_CODE).
    n_pad: padded row count, a multiple of TILE. Returns (n_pad,) bool;
    rows past n are False."""
    C = len(cols)
    if C == 0 or C != len(code_sets):
        raise ValueError("in_set_scan: need one code set per column")
    if n_pad % TILE:
        raise ValueError(f"in_set_scan: n_pad {n_pad} is not a multiple of {TILE}")
    n = cols[0].shape[0]
    if any(c.ndim != 1 or c.shape[0] != n for c in cols) or n > n_pad:
        raise ValueError(f"in_set_scan: columns must be 1-D of one length <= {n_pad}")
    dev = cols[0].device
    codes = _code_table(code_sets).to(dev)
    if _route("in_set_scan", cols[0]) == "cpu":
        return _in_set_plain(cols, codes, n_pad)
    return _in_set_cuda(cols, codes, n_pad)


in_set_scan.launches = 0


# ---------------------------------------------------------------------------
# fused duration-range scan (uint64 as two uint32 limbs)
# ---------------------------------------------------------------------------


def _range_plain(hi: torch.Tensor, lo: torch.Tensor, bounds: tuple[int, int, int, int],
                 n: int) -> torch.Tensor:
    """Plain version: hi, lo (n_pad,) uint32 bits; bounds = (min_hi,
    min_lo, max_hi, max_lo) -> (n_pad,) bool, False from row n."""
    h, l = _u32(hi), _u32(lo)
    min_h, min_l, max_h, max_l = bounds
    ge = (h > min_h) | ((h == min_h) & (l >= min_l))
    le = (h < max_h) | ((h == max_h) & (l <= max_l))
    out = ge & le
    out[n:] = False
    return out


def _range_cuda(hi: torch.Tensor, lo: torch.Tensor, bounds: tuple[int, int, int, int],
                n: int) -> torch.Tensor:
    if hi.dtype != torch.int32 or lo.dtype != torch.int32 or hi.shape != lo.shape:
        raise TypeError("u64_range_scan: hi and lo must be int32 limbs of one shape")
    _check_cuda("u64_range_scan", hi, lo)
    lib = _build.lib()
    min_h, min_l, max_h, max_l = bounds
    out = torch.empty(hi.shape[0], dtype=torch.bool, device=hi.device)
    with torch.cuda.device(hi.device):
        err = lib.tt_u64_range_scan(hi.data_ptr(), lo.data_ptr(),
                                    (min_h << 32) | min_l, (max_h << 32) | max_l,
                                    hi.shape[0], n, out.data_ptr(), _stream(hi))
    _build.check(err, "u64_range_scan")
    u64_range_scan.launches += 1
    return out


def range_limbs(values: torch.Tensor, n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,) uint64 values (torch.uint64, or int64 holding the same bits)
    -> (hi, lo) int32 limb tensors of length n_pad, zero padded."""
    if values.dtype == torch.uint64:
        values = values.view(torch.int64)
    v = values.to(torch.int64)
    n = v.shape[0]
    hi = torch.zeros(n_pad, dtype=torch.int32, device=v.device)
    lo = torch.zeros(n_pad, dtype=torch.int32, device=v.device)
    hi[:n] = u32_bits((v >> 32) & 0xFFFFFFFF)
    lo[:n] = u32_bits(v & 0xFFFFFFFF)
    return hi, lo


def u64_range_scan(values: torch.Tensor, lo_bound: int, hi_bound: int,
                   n_pad: int) -> torch.Tensor:
    """lo_bound <= values <= hi_bound over uint64 values, compared as
    (hi, lo) uint32 limbs. values: (n,) torch.uint64, or int64 holding
    the uint64 bits (numpy: `v.view(np.int64)`). Rows past n are False."""
    if n_pad % TILE:
        raise ValueError(f"u64_range_scan: n_pad {n_pad} is not a multiple of {TILE}")
    hi, lo = range_limbs(values, n_pad)
    bounds = (lo_bound >> 32, lo_bound & 0xFFFFFFFF, hi_bound >> 32, hi_bound & 0xFFFFFFFF)
    n = values.shape[0]
    if _route("u64_range_scan", hi) == "cpu":
        return _range_plain(hi, lo, bounds, n)
    return _range_cuda(hi, lo, bounds, n)


u64_range_scan.launches = 0


# ---------------------------------------------------------------------------
# dbp decode (the compiled tier's decode of delta-bitpacked pages)
# ---------------------------------------------------------------------------


def _dbp_decode_plain(words: torch.Tensor, first: torch.Tensor, width: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Plain version: words (U, W) uint32 bits, first (U,) int64 holding
    uint64 bits, width (U,) int -> (U, n) int64 holding the uint64 values:
    the inclusive prefix sum of [first, d_0, ..., d_{n-2}] mod 2^64."""
    u_count, n_words = words.shape
    dev = words.device
    if n == 0:
        return torch.zeros((u_count, 0), dtype=torch.int64, device=dev)
    w = width.to(torch.int64)[:, None]
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)[None, :]
    off = i * w
    wi = off >> 5
    rem = off & 31
    wv = _u32(words)
    pad = torch.zeros((u_count, 2), dtype=torch.int64, device=dev)
    wv = torch.cat([wv, pad], dim=1)  # reads past the stream take zeros
    lo_w = torch.gather(wv, 1, wi.clamp(max=n_words))
    hi_w = torch.gather(wv, 1, (wi + 1).clamp(max=n_words))
    hi_part = torch.where(rem == 0, 0, (hi_w << ((32 - rem) & 31)) & 0xFFFFFFFF)
    mask = torch.where(w >= 32, 0xFFFFFFFF, (1 << (w & 31)) - 1)
    z = ((lo_w >> rem) | hi_part) & mask
    d = (z >> 1) ^ ((0 - (z & 1)) & 0xFFFFFFFF)
    d = torch.where(d >= (1 << 31), d - (1 << 32), d)  # sign-extend the 32-bit delta
    e = torch.cat([first.to(torch.int64)[:, None], d], dim=1)
    return torch.cumsum(e, dim=1)  # int64 adds wrap as uint64 adds do


def _dbp_decode_cuda(words: torch.Tensor, first: torch.Tensor, width: torch.Tensor,
                     n: int) -> torch.Tensor:
    if words.dtype != torch.int32 or first.dtype != torch.int64 or width.dtype != torch.int32:
        raise TypeError("dbp_decode: words int32, first int64, width int32")
    _check_cuda("dbp_decode", words, first, width)
    u_count, n_words = words.shape
    out = torch.empty((u_count, n), dtype=torch.int64, device=words.device)
    if u_count and n:
        lib = _build.lib()
        # the tile sums of the reduce pass, one a (unit, tile)
        sums = torch.empty((u_count, -(-n // lib.tt_dbp_tile())), dtype=torch.int64,
                           device=words.device)
        launched = ctypes.c_int32(0)
        with torch.cuda.device(words.device):
            err = lib.tt_dbp_decode(words.data_ptr(), n_words, first.data_ptr(), width.data_ptr(),
                                    u_count, n, sums.data_ptr(), out.data_ptr(),
                                    ctypes.byref(launched), _stream(words))
        _build.check(err, "dbp_decode")
        dbp_decode_limbs.launches += 1
        dbp_decode_limbs.kernel_launches += launched.value
    return out


def dbp_decode_limbs(words: torch.Tensor, first: torch.Tensor, width: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Packed zigzag deltas -> absolute uint64 values, for U units at
    once: words (U, W) int32 tensor of the packed uint32 words (each row
    with room for the words its deltas straddle), first (U,) int64 of
    uint64 bits, width (U,) int32 (<= 32). Returns (U, n) int64 holding
    the uint64 bits. The JAX package carried the values as (hi, lo) u32
    limbs; the port keeps native 64-bit integers, bit for bit the same.
    On the card: two kernels over (tiles, units), a tile-sum pass and a
    scan pass (one when every unit fits one tile)."""
    if words.ndim != 2 or first.shape != (words.shape[0],) or width.shape != first.shape:
        raise ValueError("dbp_decode: words (U, W), first (U,), width (U,)")
    if _route("dbp_decode", words) == "cpu":
        return _dbp_decode_plain(words, first, width, n)
    return _dbp_decode_cuda(words, first, width, n)


dbp_decode_limbs.launches = 0  # calls that launched the decode
dbp_decode_limbs.kernel_launches = 0  # its kernels: the reduce pass (units of 2+ tiles), the scan


def dbp_decode_device(page: bytes, dtype: str, shape: tuple, device) -> np.ndarray:
    """Decode one dbp page on `device` (the host only reinterprets the
    packed bytes as u32 words), one dbp_decode launch a sub-column.
    Bit-identical to lightweight.dbp_decode."""
    from tempo_tpu_torch.encoding.vtpu import lightweight as lw
    from tempo_tpu_torch.util.devicetiming import timed_dispatch

    device = torch.device(device)
    first, _anchors, widths, streams, n = lw.dbp_parts(page, dtype, shape)
    dt = np.dtype(dtype)
    if n == 0:
        return np.empty(shape, dt)
    k = len(widths)
    out = np.empty((n, k), np.uint64)
    for c in range(k):
        raw = bytes(streams[c])
        pad = (-len(raw)) % 4 + 4  # round to words + one guard word
        words = np.frombuffer(raw + b"\x00" * pad, "<u4")

        def run(words=words, c=c):
            return dbp_decode_limbs(
                torch.from_numpy(words.view(np.int32).copy()).to(device)[None, :],
                torch.tensor([int(first[c])], dtype=torch.uint64).view(torch.int64).to(device),
                torch.tensor([widths[c]], dtype=torch.int32, device=device), n)

        vals = timed_dispatch("dbp_decode", run, device=device)
        out[:, c] = vals[0].cpu().numpy().view(np.uint64)
    return np.ascontiguousarray(out.astype(dt, copy=False).reshape(shape))


# ---------------------------------------------------------------------------
# fused RLE decode + in-set scan (the mesh and batched multi-query searches)
# ---------------------------------------------------------------------------

_RLE_MAX_SMEM = 48 * 1024  # a lane's (C, K) code table and C live flags a call takes
_RLE_MAX_LANES = 65535  # units x lanes a call takes


def rle_expand_device(values: torch.Tensor, lengths: torch.Tensor, n: int) -> torch.Tensor:
    """Run values + lengths -> (n,) rows, as jnp.repeat with
    total_repeat_length=n expands them: rows past the runs' total repeat
    the LAST run (a zero-length padding run included) and runs that
    overrun n are cut. A plain torch op: the JAX package's helper has no
    caller outside tests."""
    if values.shape[0] == 0 or n == 0:
        return values.new_zeros(n)
    rows = torch.repeat_interleave(values, lengths.to(torch.int64))
    if rows.shape[0] >= n:
        return rows[:n]
    return torch.cat([rows, values[-1:].expand(n - rows.shape[0])])


def unshuffle_device(planes: torch.Tensor, itemsize: int) -> torch.Tensor:
    """Invert the blosc-style byte shuffle: planes (itemsize, N) uint8 —
    plane j holds byte j of every element — recombined as shifts and ors
    into (N,) uint32 values (in int64; itemsize <= 4 bytes of each). A
    plain torch op, as rle_expand_device."""
    out = torch.zeros(planes.shape[1], dtype=torch.int64, device=planes.device)
    for j in range(min(itemsize, 4)):
        out = out | (planes[j].to(torch.int64) << (8 * j))
    return out


def _rle_lane_plain(values: torch.Tensor, lengths: torch.Tensor | None, codes: torch.Tensor,
                    live: torch.Tensor | None, hit: torch.Tensor | None, n: int) -> torch.Tensor:
    """Plain version for one (unit, lane): values (C, RP) and codes (C, K)
    uint32 bits, lengths (C, RP) or None (a run a row), live (C,) or None,
    hit (n,) or None -> (n,) bool: torch.isin a run, repeat_interleave to
    rows with jnp.repeat's padding rule, ANDed over the live columns."""
    dev = values.device
    out = (torch.ones(n, dtype=torch.bool, device=dev) if hit is None
           else hit.to(torch.bool).clone())
    no_match = int(u32_bits(torch.tensor([int(NO_MATCH_CODE)], dtype=torch.int64))[0])
    for c in range(values.shape[0]):
        cs = codes[c][codes[c] != no_match]  # the padding code never matches
        run_hit = torch.isin(values[c], cs)
        if lengths is None:
            row_hit = (run_hit[:n] if run_hit.shape[0] >= n
                       else torch.cat([run_hit, run_hit[-1:].expand(n - run_hit.shape[0])]))
        else:
            row_hit = rle_expand_device(run_hit, lengths[c], n)
        if live is not None:
            row_hit = row_hit | ~live[c].to(torch.bool)
        out &= row_hit
    return out


def _rle_hit_plain(values, lengths, codes, live, hit, n) -> torch.Tensor:
    U, Q = codes.shape[:2]
    out = torch.empty((U, Q, n), dtype=torch.bool, device=values.device)
    for u in range(U):
        for q in range(Q):
            out[u, q] = _rle_lane_plain(
                values[u], None if lengths is None else lengths[u], codes[u, q],
                None if live is None else live[u, q], None if hit is None else hit[u], n)
    return out


def _rle_hit_cuda(values, lengths, codes, live, hit, n) -> torch.Tensor:
    U, Q, C, K = codes.shape
    RP = values.shape[2]
    if C * K * 4 + C > _RLE_MAX_SMEM:
        raise ValueError(f"rle_cols_hit: code table ({C}, {K}) does not fit")
    if U * Q > _RLE_MAX_LANES:
        raise ValueError(f"rle_cols_hit: {U} x {Q} lanes in one launch")
    ts = [values, codes] + [t for t in (lengths, live, hit) if t is not None]
    _check_cuda("rle_cols_hit", *ts)
    out = torch.empty((U, Q, n), dtype=torch.bool, device=values.device)
    if n == 0 or U * Q == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(values.device):
        err = lib.tt_rle_cols_hit(
            values.data_ptr(), None if lengths is None else lengths.data_ptr(), U, C, RP,
            codes.data_ptr(), K, Q, None if live is None else live.data_ptr(),
            None if hit is None else hit.data_ptr(), n, out.data_ptr(), _stream(values))
    _build.check(err, "rle_cols_hit")
    rle_cols_hit.launches += 1
    return out


def rle_hit_lanes(values: torch.Tensor, lengths: torch.Tensor | None, codes: torch.Tensor,
                  n: int, live: torch.Tensor | None = None,
                  hit: torch.Tensor | None = None) -> torch.Tensor:
    """The one body behind every fused RLE scan: U units' run payloads,
    Q lanes of code sets each. values (U, C, RP) integer tensor of uint32
    values; lengths (U, C, RP) run lengths, or None when every run is one
    row (an expanded column); codes (U, Q, C, K) padded with NO_MATCH_CODE
    (K <= 64 in practice: 32 lanes' sets of a column sit in shared
    memory); live (U, Q, C) bool or None (all live: a dead column accepts
    every row);
    hit (U, n) bool or None (all True). Returns (U, Q, n) bool: the plain
    version for CPU tensors, the rle_cols_hit kernel for CUDA tensors (one
    launch a call, no scratch)."""
    if values.ndim != 3 or codes.ndim != 4 or codes.shape[0] != values.shape[0] \
            or codes.shape[2] != values.shape[1]:
        raise ValueError("rle_cols_hit: values (U, C, RP), codes (U, Q, C, K)")
    if values.shape[2] == 0 or values.shape[1] == 0:
        raise ValueError("rle_cols_hit: need at least one column and one run")
    if lengths is not None and lengths.shape != values.shape:
        raise ValueError("rle_cols_hit: lengths and values differ in shape")
    if live is not None and live.shape != codes.shape[:3]:
        raise ValueError("rle_cols_hit: live must be (U, Q, C)")
    if hit is not None and hit.shape != (values.shape[0], n):
        raise ValueError(f"rle_cols_hit: hit must be (U, {n})")
    values = u32_bits(values).contiguous()
    codes = u32_bits(codes).contiguous()
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    if live is not None:
        live = live.to(torch.bool).contiguous()
    if hit is not None:
        hit = hit.to(torch.bool).contiguous()
    if _route("rle_cols_hit", values) == "cpu":
        return _rle_hit_plain(values, lengths, codes, live, hit, n)
    return _rle_hit_cuda(values, lengths, codes, live, hit, n)


def rle_cols_hit(values: torch.Tensor, lengths: torch.Tensor, codes: torch.Tensor,
                 n: int, hit: torch.Tensor) -> torch.Tensor:
    """ONE unit's fused RLE decode + predicate: values/lengths (C, R),
    codes (C, K) — the in-set verdict per RUN, expanded to rows with
    jnp.repeat's padding rule, AND-folded into `hit` (n,)."""
    return rle_hit_lanes(values[None], lengths[None], codes[None, None], n,
                         hit=hit[None])[0, 0]


rle_cols_hit.launches = 0


def rle_cols_hit_live(values: torch.Tensor, lengths: torch.Tensor, codes: torch.Tensor,
                      live: torch.Tensor, n: int, hit: torch.Tensor) -> torch.Tensor:
    """rle_cols_hit with a per-column participation flag: a column whose
    `live` is False accepts every row. codes (C, K) with live (C,) ->
    (n,); codes (Q, C, K) with live (Q, C) -> (Q, n): Q query lanes over
    one run payload in one launch (the JAX package's vmap)."""
    one = codes.ndim == 2
    cq = codes[None, None] if one else codes[None]
    lq = live[None, None] if one else live[None]
    out = rle_hit_lanes(values[None], lengths[None], cq, n, live=lq, hit=hit[None])[0]
    return out[0] if one else out


def _dispatch_device(values, device) -> torch.device:
    if isinstance(values, torch.Tensor):
        return values.device
    from tempo_tpu_torch import device as _device

    return _device.resolve(device)


def _ship(a, dev: torch.device, dtype) -> tuple[torch.Tensor, int]:
    """(tensor on dev, bytes shipped): host arrays copy once, tensors
    already on the device ship nothing."""
    if isinstance(a, torch.Tensor):
        return a.to(dev), 0
    a = np.ascontiguousarray(np.asarray(a).astype(dtype, copy=False))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev), a.nbytes


def batched_rle_in_set(values, lengths, codes: np.ndarray, live: np.ndarray,
                       valid: np.ndarray, n: int, device=None) -> np.ndarray:
    """The single-device batched multi-query scan: values/lengths (C, R)
    — one unit's run payload, numpy (shipped, counted h2d) or tensors
    from the resident tier (counted as nothing moved) — codes (Q, C, K),
    live (Q, C), valid (n,) -> (Q, n) bool numpy, in one
    `batched_rle_scan` dispatch on `device` (the payload's device when it
    is a tensor; default CUDA)."""
    from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

    dev = _dispatch_device(values, device)

    def run():
        v, hv = _ship(values, dev, np.uint32)
        ln, hl = _ship(lengths, dev, np.int32)
        cd, hc = _ship(codes, dev, np.uint32)
        lv, hlv = _ship(live, dev, bool)
        vd, hvd = _ship(valid, dev, bool)
        out = rle_cols_hit_live(v, ln, cd, lv, n, vd).cpu().numpy()
        count_transfer("batched_rle_scan", h2d=hv + hl + hc + hlv + hvd, d2h=out.nbytes)
        return out

    return timed_dispatch("batched_rle_scan", run, device=dev)


def fused_rle_in_set(values: np.ndarray, lengths: np.ndarray, codes: np.ndarray,
                     n: int, device=None) -> np.ndarray:
    """The fused scan batched over U (block, row-group) units: values /
    lengths (U, C, R), codes (U, C, K) -> (U, n) bool numpy, one
    `fused_rle_scan` dispatch on `device` (default CUDA). Rows past a
    unit's true span count must be masked by the caller."""
    from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

    dev = _dispatch_device(values, device)

    def run():
        v, hv = _ship(values, dev, np.uint32)
        ln, hl = _ship(lengths, dev, np.int32)
        cd, hc = _ship(codes, dev, np.uint32)
        out = rle_hit_lanes(v, ln, cd[:, None], n)[:, 0].cpu().numpy()
        count_transfer("fused_rle_scan", h2d=hv + hl + hc, d2h=out.nbytes)
        return out

    return timed_dispatch("fused_rle_scan", run, device=dev)
