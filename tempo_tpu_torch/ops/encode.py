"""Device page encoders: the write-path inverse of the resident decode
formulas.

Port of tempo_tpu/ops/encode.py. The pages are byte-identical to the
host encoders of encoding/vtpu/lightweight.py — same header, same body
CRC, same np.packbits(bitorder="little") stream layout — so readers
cannot tell which arm wrote a block.

Division of labour per codec, as in the reference (one timed_dispatch a
page, named rle_encode / dbp_encode / dct_encode):

- rle — the device computes the row-change mask (the O(n*k) compare,
  kernel `rle_change_mask`); the host turns the (n-1)-byte mask into
  firsts/lengths and gathers the run values.
- dbp — per-column delta and zigzag on the device, in u32 limb planes
  for 64-bit columns, then the static-width bitpack (kernel `dbp_pack`,
  delta mode). Widths come from the host probe formulas, as in the
  reference.
- dct — the page dictionary (np.unique) stays on the host; the device
  packs the index stream at the static width (`dbp_pack`, pack mode).

Padding: rows are padded to a power of two by REPEATING the last row,
which gives zero change marks (rle) and zero deltas (dbp), so cutting the
exact host byte count off the device stream reproduces np.packbits' zero
padding.

The kernels are CUDA C++ in csrc/codec_kernels.cu (ops/_build.py). Beside
each sits its plain PyTorch version (_rle_change_plain, _dbp_pack_plain);
a wrapper takes the plain version only for tensors on the CPU, and for
CUDA tensors launches the kernel or raises. Unlike the reference, a
kernel failure is not absorbed into a host fallback: it raises, so the
fallback counter keeps its name for /metrics parity and stays at 0.

`device_encode_enabled(device)`: TEMPO_TPU_DEVICE_ENCODE=0 turns the arm
off, =1 forces it on (on the CPU it then runs the plain versions);
unset, it follows the writer's device — on for cuda, off for cpu — as
the reference's follows the accelerator.
"""

from __future__ import annotations

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


def device_encode_enabled(device) -> bool:
    """TEMPO_TPU_DEVICE_ENCODE: 0 turns the arm off, 1 forces it on;
    unset, it is on where the writer's device is a CUDA device."""
    env = os.environ.get("TEMPO_TPU_DEVICE_ENCODE", "").strip().lower()
    if env in ("0", "false", "no"):
        return False
    if env in ("1", "true", "yes", "force"):
        return True
    return device is not None and torch.device(device).type == "cuda"


def _pow2(n: int) -> int:
    p = 8
    while p < n:
        p <<= 1
    return p


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


def _pad_rows(u: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad axis 0 to n_pad by repeating the last row (zero deltas, zero
    change marks)."""
    n = u.shape[0]
    if n_pad == n:
        return u
    out = np.empty((n_pad,) + u.shape[1:], u.dtype)
    out[:n] = u
    out[n:] = u[n - 1]
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 lanes -> an int32 tensor of the same bits on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.uint32, copy=False)).view(np.int32)).to(device)


def _count(fn, n: int = 1) -> None:
    with _launch_lock:
        fn.launches += n


# ---------------------------------------------------------------------------
# K1: rle_change_mask
# ---------------------------------------------------------------------------


def _rle_change_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version: (n_pad, k) lanes -> (n_pad - 1,) bool, row i+1
    differs from row i in any lane."""
    return (a[1:] != a[:-1]).any(dim=1)


def rle_change_mask(a: torch.Tensor) -> torch.Tensor:
    """Row-change mask of an (n_pad, k) int32 tensor of uint32 lane bits
    (n_pad >= 2) -> (n_pad - 1,) bool on its device."""
    if a.ndim != 2 or a.dtype != torch.int32 or a.shape[0] < 2:
        raise ValueError("rle_change_mask: need an (n_pad >= 2, k) int32 tensor")
    if _route("rle_change_mask", a) == "cpu":
        return _rle_change_plain(a)
    _check_cuda("rle_change_mask", a)
    n_pad, k = a.shape
    out = torch.empty(n_pad - 1, dtype=torch.bool, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.lib().tt_rle_change_mask(a.data_ptr(), n_pad, k, out.data_ptr(), _stream(a))
    _build.check(err, "rle_change_mask")
    _count(rle_change_mask)
    return out


rle_change_mask.launches = 0


# ---------------------------------------------------------------------------
# K2: dbp_pack (delta mode for dbp, pack mode for the dct index stream)
# ---------------------------------------------------------------------------


def _zigzag_lo_plain(lo: torch.Tensor, hi: torch.Tensor | None, item_bits: int) -> torch.Tensor:
    """(k, n_pad) limb planes -> (k, n_pad) low limbs of the zigzagged
    deltas of rows i, i+1 (u32 values in int64), the last one zero."""
    lo64 = _u32(lo)
    a, b = lo64[:, :-1], lo64[:, 1:]
    if item_bits == 64:
        hi64 = _u32(hi)
        d_lo = (b - a) & _M32
        d_hi = (hi64[:, 1:] - hi64[:, :-1] - (b < a).to(torch.int64)) & _M32
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
    z = ((d_lo << 1) & _M32) ^ neg
    return torch.cat([z, torch.zeros_like(z[:, :1])], dim=1)


def _pack_plain(z: torch.Tensor, w: int) -> torch.Tensor:
    """(m,) u32 values in int64, m*w a multiple of 8 -> the (m*w/8,) uint8
    little-endian bit stream, value i at bits [i*w, (i+1)*w)."""
    bits = (z[:, None] >> torch.arange(w, device=z.device)) & 1
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], device=z.device)
    return (bits.reshape(-1, 8) * weights).sum(dim=1).to(torch.uint8)


def _dbp_pack_plain(lo: torch.Tensor, hi: torch.Tensor | None, item_bits: int,
                    widths: list[int]) -> list[torch.Tensor]:
    z = _zigzag_lo_plain(lo, hi, item_bits) if item_bits else _u32(lo)
    return [_pack_plain(z[c], w) if w else torch.zeros(0, dtype=torch.uint8, device=lo.device)
            for c, w in enumerate(widths)]


def dbp_pack(lo: torch.Tensor, hi: torch.Tensor | None, item_bits: int,
             widths: list[int]) -> list[torch.Tensor]:
    """Bitpack at static widths (each <= 32). Delta mode (item_bits 8, 16,
    32 or 64): lo, hi are (k, n_pad) int32 tensors of uint32 limb planes
    (hi is read only for 64-bit items) and column c packs the zigzagged
    deltas of its rows, then a zero. Pack mode (item_bits 0): lo is (k,
    n_pad) uint32 values packed as they are. Returns k uint8 tensors of
    n_pad * w / 8 bytes (n_pad a power of two >= 8), empty for w = 0."""
    k, n_pad = lo.shape
    if len(widths) != k or any(not 0 <= w <= 32 for w in widths):
        raise ValueError("dbp_pack: one width in [0, 32] a column")
    if item_bits not in (0, 8, 16, 32, 64) or n_pad < 8 or n_pad & (n_pad - 1):
        raise ValueError(f"dbp_pack: item_bits {item_bits}, n_pad {n_pad}")
    if item_bits == 64 and (hi is None or hi.shape != lo.shape):
        raise ValueError("dbp_pack: 64-bit items need the hi limb plane")
    if _route("dbp_pack", lo) == "cpu":
        return _dbp_pack_plain(lo, hi, item_bits, widths)
    if lo.dtype != torch.int32 or (item_bits == 64 and hi.dtype != torch.int32):
        raise TypeError("dbp_pack: limb planes must be int32 bit patterns")
    _check_cuda("dbp_pack", lo, *((hi,) if item_bits == 64 else ()))
    words = [-(-n_pad * w // 32) for w in widths]
    off = np.concatenate([[0], np.cumsum(words)]).astype(np.int64)
    out = torch.empty(max(int(off[-1]), 1), dtype=torch.int32, device=lo.device)
    if off[-1]:
        w_arr = np.asarray(widths, np.int32)
        with torch.cuda.device(lo.device):
            err = _build.lib().tt_dbp_pack(
                lo.data_ptr(), hi.data_ptr() if item_bits == 64 else None, n_pad, item_bits,
                w_arr.ctypes.data, off.ctypes.data, k, out.data_ptr(), _stream(lo))
        _build.check(err, "dbp_pack")
        _count(dbp_pack)
    by = out.view(torch.uint8)
    return [by[4 * int(off[c]): 4 * int(off[c]) + n_pad * w // 8] for c, w in enumerate(widths)]


dbp_pack.launches = 0


# ---------------------------------------------------------------------------
# per-codec device encode (byte-identical to the lightweight.py arm)
# ---------------------------------------------------------------------------


def _rle_device(arr: np.ndarray, device: torch.device) -> bytes | None:
    n = arr.shape[0]
    if n < 2:
        return None
    up = _pad_rows(_unsigned_2d(arr), _pow2(n))
    change = timed_dispatch("rle_encode", lambda: rle_change_mask(_to_device(up, device)),
                            device=device)
    d = change.cpu().numpy()[: n - 1]
    firsts = np.concatenate([[0], np.flatnonzero(d) + 1])
    lengths = np.diff(np.concatenate([firsts, [n]])).astype(np.uint32)
    values = np.ascontiguousarray(arr[firsts])
    body = values.tobytes() + lengths.tobytes()
    return struct.pack("<II", len(firsts), zlib.crc32(body)) + body


def _dbp_device(arr: np.ndarray, device: torch.device) -> bytes | None:
    n = arr.shape[0]
    if n < 2:
        return None
    a2 = lw._as_2d(arr)
    k = a2.shape[1]
    # widths from the host probe arithmetic: the kernel's static widths
    widths = []
    for c in range(k):
        w = lw._dbp_width(lw._zigzag(lw._deltas_s64(a2[:, c])))
        if w > lw.DBP_MAX_WIDTH:
            raise ValueError(f"dbp: delta width {w} exceeds cap {lw.DBP_MAX_WIDTH}")
        widths.append(w)
    item = a2.dtype.itemsize
    n_pad = _pow2(n)
    u = _unsigned_2d(arr)  # (n, k) or (n, 2k) limb-interleaved
    if item == 8:
        limbs = u.reshape(n, k, 2)
        lo, hi = limbs[:, :, 0], limbs[:, :, 1]
    else:
        lo, hi = u, None
    lo = np.ascontiguousarray(_pad_rows(lo, n_pad).T)
    hi = None if hi is None else np.ascontiguousarray(_pad_rows(hi, n_pad).T)

    def run():
        return dbp_pack(_to_device(lo, device), None if hi is None else _to_device(hi, device),
                        item * 8, widths)

    streams = timed_dispatch("dbp_encode", run, device=device)
    uu = a2.astype(np.uint64)
    na = lw._n_anchors(n)
    anchor_rows = (np.arange(na, dtype=np.int64) + 1) * lw.DBP_MINIBLOCK
    parts = [uu[0].astype("<u8").tobytes()]
    for c in range(k):
        a = uu[anchor_rows, c] if na else np.zeros(0, np.uint64)
        parts.append(a.astype("<u8").tobytes())
    for c, w in enumerate(widths):
        nb = ((n - 1) * w + 7) // 8
        parts.append(streams[c][:nb].cpu().numpy().tobytes())
    body = b"".join(parts)
    return (
        struct.pack("<BB", 1, k)
        + bytes(widths)
        + struct.pack("<I", zlib.crc32(body))
        + body
    )


def _dct_device(arr: np.ndarray, device: torch.device) -> bytes | None:
    n = arr.shape[0]
    if n < 2:
        return None
    a2 = lw._as_2d(arr)
    uniq, inv = np.unique(a2, axis=0, return_inverse=True)
    d = uniq.shape[0]
    w = max(d - 1, 0).bit_length()
    if w > lw.DBP_MAX_WIDTH:
        raise ValueError(f"dct: index width {w} exceeds cap {lw.DBP_MAX_WIDTH}")
    if w == 0:
        stream = b""
    else:
        inv_p = np.zeros((1, _pow2(n)), np.uint32)
        inv_p[0, :n] = inv.reshape(-1)
        packed = timed_dispatch("dct_encode",
                                lambda: dbp_pack(_to_device(inv_p, device), None, 0, [w])[0],
                                device=device)
        stream = packed[: (n * w + 7) // 8].cpu().numpy().tobytes()
    body = np.ascontiguousarray(uniq).tobytes() + stream
    return struct.pack("<BBII", 1, w, d, zlib.crc32(body)) + body


_DEVICE_ENC = {"rle": _rle_device, "dbp": _dbp_device, "dct": _dct_device}


def encode_page_device(arr: np.ndarray, codec: str, device) -> bytes | None:
    """Device-encode one column page on `device`; None -> the caller
    uses the host arm (a codec outside the lightweight tier, or fewer
    than 2 rows). Every failure raises: ValueError for a width over the
    cap (the host encoder's contract too), anything else from the
    kernels."""
    fn = _DEVICE_ENC.get(codec)
    if fn is None:
        return None
    page = fn(arr, torch.device(device))
    if page is not None:
        device_encode_pages_total.inc(codec=codec)
    return page

