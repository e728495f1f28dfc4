"""The three kernels that the JAX package wrote in Pallas, for Hopper.

Port of tempo_tpu/ops/pallas_kernels.py: seg_bincount (+ the host
pre-pass compress_slot_runs), in_set_scan and u64_range_scan, with the
same arguments and the same results. Each kernel is CUDA C++ in
csrc/kernels.cu, built with nvcc at first use (ops/_build.py) and
launched through ctypes on PyTorch's current stream.

Beside each kernel sits its plain PyTorch version (_seg_bincount_plain,
_in_set_plain, _range_plain). A wrapper takes the plain version only
for tensors that lie on the CPU; for CUDA tensors it launches the
kernel or raises. Each wrapper counts its kernel launches in a plain
integer attribute, `<wrapper>.launches`.

uint32 data reaches the kernels as int32 tensors with the same bits
(`u32_bits`), since torch's uint32 dtype lacks most operators.
"""

from __future__ import annotations

import numpy as np
import torch

from tempo_tpu_torch.ops import _build

TILE = 1024
NO_MATCH_CODE = np.uint32(0xFFFFFFFF)  # sentinel code: matches no dictionary entry
_MAX_CODE_TABLE = 48 * 1024 // 4  # C*S codes that fit the kernel's shared memory


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


def _seg_bincount_plain(slots: torch.Tensor, n_slots: int,
                        weights: torch.Tensor | None) -> torch.Tensor:
    """Plain version: counts[s] += w for slots in [0, n_slots); int64."""
    live = (slots >= 0) & (slots < n_slots)
    idx = torch.where(live, slots.to(torch.int64), n_slots)  # trash slot
    w = (torch.ones_like(idx) if weights is None else weights.to(torch.int64))
    out = torch.zeros(n_slots + 1, dtype=torch.int64, device=slots.device)
    out.index_add_(0, idx, w)
    return out[:n_slots]


def _seg_bincount_cuda(slots: torch.Tensor, n_slots: int,
                       weights: torch.Tensor | None) -> torch.Tensor:
    if slots.dtype != torch.int32 or (weights is not None and weights.dtype != torch.int32):
        raise TypeError("seg_bincount: slots and weights must be int32")
    if weights is not None and weights.shape != slots.shape:
        raise ValueError("seg_bincount: weights and slots differ in shape")
    if not 0 < n_slots < 2**31:
        raise ValueError(f"seg_bincount: n_slots {n_slots} out of range")
    _check_cuda("seg_bincount", slots, *(() if weights is None else (weights,)))
    lib = _build.lib()
    out = torch.zeros(n_slots, dtype=torch.int64, device=slots.device)
    with torch.cuda.device(slots.device):
        err = lib.tt_seg_bincount(
            slots.data_ptr(), None if weights is None else weights.data_ptr(),
            slots.numel(), n_slots, out.data_ptr(), _stream(slots))
    _build.check(err, "seg_bincount")
    seg_bincount.launches += 1
    return out


def seg_bincount(slots: torch.Tensor, n_slots: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Count occurrences of each slot id in [0, n_slots), each weighted
    by `weights` (the run-length form from compress_slot_runs) when
    given. Negative ids and ids >= n_slots are dropped. slots, weights:
    (N,) int32 on one device. Returns (n_slots,) int64 on that device;
    the counts are exact integers at any size."""
    if slots.ndim != 1:
        raise ValueError("seg_bincount: slots must be 1-D")
    if slots.shape[0] == 0:
        return torch.zeros(n_slots, dtype=torch.int64, device=slots.device)
    if _route("seg_bincount", slots) == "cpu":
        return _seg_bincount_plain(slots, n_slots, weights)
    return _seg_bincount_cuda(slots, n_slots, weights)


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


def _in_set_plain(mat: torch.Tensor, codes: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version: mat (C, n_pad), codes (C, S) uint32 bits ->
    (n_pad,) bool, AND over c of (mat[c, r] in codes[c]), False from row n."""
    hit = (mat[:, :, None] == codes[:, None, :]).any(dim=2).all(dim=0)
    hit[n:] = False
    return hit


def _in_set_cuda(mat: torch.Tensor, codes: torch.Tensor, n: int) -> torch.Tensor:
    if mat.dtype != torch.int32 or codes.dtype != torch.int32:
        raise TypeError("in_set_scan: columns and codes must be int32 bit patterns")
    C, n_pad = mat.shape
    if codes.shape[0] != C or C * codes.shape[1] > _MAX_CODE_TABLE:
        raise ValueError(f"in_set_scan: code table {tuple(codes.shape)} does not fit")
    _check_cuda("in_set_scan", mat, codes)
    lib = _build.lib()
    out = torch.empty(n_pad, dtype=torch.bool, device=mat.device)
    with torch.cuda.device(mat.device):
        err = lib.tt_in_set_scan(mat.data_ptr(), codes.data_ptr(), C, codes.shape[1],
                                 n_pad, n, out.data_ptr(), _stream(mat))
    _build.check(err, "in_set_scan")
    in_set_scan.launches += 1
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
    dev = cols[0].device
    n = cols[0].shape[0]
    mat = torch.full((C, n_pad), -1, dtype=torch.int32, device=dev)  # NO_MATCH_CODE
    for c, col in enumerate(cols):
        mat[c, :n] = u32_bits(col)
    s_pad = 1
    while s_pad < max(cs.shape[0] for cs in code_sets):
        s_pad <<= 1
    codes = torch.full((C, s_pad), -1, dtype=torch.int32, device=dev)
    for c, cs in enumerate(code_sets):
        codes[c, : cs.shape[0]] = u32_bits(cs.to(dev))
    if _route("in_set_scan", mat) == "cpu":
        return _in_set_plain(mat, codes, n)
    return _in_set_cuda(mat, codes, n)


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
