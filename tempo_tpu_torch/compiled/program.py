"""The fused device program: filter -> time-bin -> count, one dispatch.

Port of tempo_tpu/compiled/program.py. One program per static signature
evaluates Q same-shape query lanes over U stacked row-group units.
Everything literal- or time-dependent is a runtime argument (per-unit
code sets, range bounds, [start_s, step_s], n_bins), so a literal swap or
a shifted dashboard window reuses the same program.

On CUDA tensors the program is the hand-written `compiled_metrics`
(csrc/codec_kernels.cu), one dispatch of the executor in at most two
launches whatever its columns. A prepare launch computes the dbp tile
sums of every dbp column and the run starts of every rle column (none
when there are neither). The count launch runs one block a (row tile,
unit): it reads each row's t_s, valid and payloads once for all Q lanes,
decodes dbp columns inside the tile (no decoded column is written) and
finds each counted row's rle run among the tile's runs; it is a
programmatic dependent launch, reading its rows while the prepare launch
runs. It replaces the reference's one jitted program. What bounds it is
memory: each input read once and the counts written once
(csrc/codec_kernels.cu says what the design does about it). On CPU
tensors it is the plain PyTorch version `_metrics_plain` beside it.

Exactness: the per-codec formulas are the reference's (rle run verdicts
repeated to rows, dct dictionary verdicts gathered by index, dbp decoded
values in an inclusive u64 range), and the time binning uses the
epoch-seconds identity

    (t_ns - start_s*1e9) // (step_s*1e9)  ==  (t_s - start_s) // step_s
    with t_s = t_ns // 1e9,

exact for integer-second start/step, in u32 arithmetic guarded by
t_s >= start. Pad rows/runs/dictionary entries are neutralised by the
valid mask, never by the value they hold. Counts are int64; the
reference's are int32, exact below 2^31 a bin.

Signature: (sig_cols, n_pad, slot_pad, q), sig_cols one
(codec, "set"|"range", invert, pad) a column. Runtime arguments, tensors
on one device (uint32 data as int32 bits, uint64 as int64 bits):
  t_s (U, N) · valid (U, N) bool
  per column payload  rle (values (U, RP), lengths (U, RP))
                      dct (dvals (U, VP), idx (U, N))
                      dbp (words (U, WP), first (U,) int64, width (U,))
  per column query    set codes (Q, U, K) — per unit, since each block
                      dictionary maps the literal to its own codes;
                      range bounds (Q, 2) int64: inclusive lo, hi
  tb (Q, 2) [start_s, step_s] · nb (Q,)
  returns counts (Q, slot_pad) int64
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from tempo_tpu_torch.ops import _build
from tempo_tpu_torch.ops.pallas_kernels import (
    _check_cuda,
    _dbp_decode_plain,
    _route,
    _stream,
    _u32,
)

_CODEC_ID = {"rle": 0, "dct": 1, "dbp": 2}
_MAX_COLS = 16  # columns one compiled_metrics launch takes (kMaxCCols)
_I64_MIN = -(1 << 63)
_launch_lock = threading.Lock()


def _u64_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b over uint64 values held as int64 bits."""
    return (a ^ _I64_MIN) <= (b ^ _I64_MIN)


def _range_hit(v: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(U, X) uint64 bits against (Q, 2) inclusive bounds -> (Q, U, X)."""
    lo = bounds[:, 0].reshape(-1, 1, 1)
    hi = bounds[:, 1].reshape(-1, 1, 1)
    return _u64_le(lo, v[None]) & _u64_le(v[None], hi)


def _entry_hit(v: torch.Tensor, kind: str, invert: bool, qa: torch.Tensor) -> torch.Tensor:
    """Verdict of each run / dictionary entry: v (U, X) uint32 bits ->
    (Q, U, X) bool."""
    if kind == "range":
        return _range_hit(_u32(v), qa)
    hit = (_u32(v)[None, :, :, None] == _u32(qa)[:, :, None, :]).any(dim=-1)
    return ~hit if invert else hit


def _metrics_plain(sig, t_s, valid, payloads, qargs, tb, nb) -> torch.Tensor:
    """Plain version of compiled_metrics (dbp decoded by the plain decode)."""
    sig_cols, n_pad, slot_pad, _q = sig
    dev = t_s.device
    q = tb.shape[0]
    hit = valid[None].expand(q, *valid.shape)
    rows = torch.arange(n_pad, dtype=torch.int64, device=dev)
    for (codec, kind, invert, _pad), payload, qa in zip(sig_cols, payloads, qargs):
        if codec == "rle":
            values, lengths = payload
            run = _entry_hit(values, kind, invert, qa)
            ends = torch.cumsum(lengths.to(torch.int64), dim=1)
            starts = ends - lengths.to(torch.int64)
            # the last run starting at or before the row (rows past the
            # lengths' sum take the last run, as jnp.repeat fills them)
            k = torch.searchsorted(starts, rows.expand(starts.shape[0], n_pad).contiguous(),
                                   right=True) - 1
            col = torch.gather(run, 2, k.clamp(min=0)[None].expand(q, -1, -1))
        elif codec == "dct":
            dvals, idx = payload
            entry = _entry_hit(dvals, kind, invert, qa)
            col = torch.gather(entry, 2, idx.to(torch.int64)[None].expand(q, -1, -1))
        else:
            words, first, width = payload
            col = _range_hit(_dbp_decode_plain(words, first, width, n_pad), qa)
        hit = hit & col
    ts = _u32(t_s)[None]
    start = _u32(tb[:, 0]).reshape(-1, 1, 1)
    step = _u32(tb[:, 1]).reshape(-1, 1, 1)
    ok = hit & (ts >= start)
    bins = ((ts - start) & 0xFFFFFFFF) // step  # unsigned, as u32 wraps
    ok = ok & (bins < _u32(nb).reshape(-1, 1, 1))
    idx = torch.where(ok, bins, slot_pad).reshape(q, -1)
    counts = torch.zeros((q, slot_pad + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, idx, torch.ones_like(idx))
    return counts[:, :slot_pad]


def _describe(sig, t_s, payloads, qargs):
    """The C entry's column table (n_cols x 11 int64: codec, kind, invert,
    pad, n_codes, then the device pointers values, aux, scratch, first,
    codes, bounds) and the scratch tensors it points into (the prepare
    launch's: each rle column's run starts and tile first runs, each dbp
    column's tile sums), which the caller keeps alive until the launch is
    queued."""
    sig_cols, n_pad = sig[0], sig[1]
    n_units = t_s.shape[0]
    tiles = -(-n_pad // _build.lib().tt_dbp_tile())
    desc = np.zeros((len(sig_cols), 11), np.int64)
    scratch = []
    for c, ((codec, kind, invert, _pad), payload, qa) in enumerate(zip(sig_cols, payloads, qargs)):
        row = desc[c]
        row[0], row[1], row[2] = _CODEC_ID[codec], int(kind == "range"), int(bool(invert))
        _check_cuda("compiled_metrics", *payload, t_s)
        if codec == "dbp":
            words, first, width = payload
            if (words.dtype, first.dtype, width.dtype) != (torch.int32, torch.int64, torch.int32):
                raise TypeError("compiled_metrics: dbp words int32, first int64, width int32")
            sums = torch.empty((n_units, tiles), dtype=torch.int64, device=t_s.device)
            scratch.append(sums)
            row[3], row[5], row[6], row[7], row[8] = (words.shape[1], words.data_ptr(),
                                                      width.data_ptr(), sums.data_ptr(),
                                                      first.data_ptr())
        else:
            values, aux = payload  # rle values, lengths; dct dictionary, indices
            if values.dtype != torch.int32 or aux.dtype != torch.int32:
                raise TypeError(f"compiled_metrics: {codec} payload int32")
            row[3], row[5], row[6] = values.shape[1], values.data_ptr(), aux.data_ptr()
            if codec == "rle":  # run starts, then each row tile's first run
                runs = torch.empty((n_units, values.shape[1] + 1 + tiles), dtype=torch.int32,
                                   device=t_s.device)
                scratch.append(runs)
                row[7] = runs.data_ptr()
        _check_cuda("compiled_metrics", qa, t_s)
        if kind == "set":
            if qa.dtype != torch.int32:
                raise TypeError("compiled_metrics: codes int32")
            row[4], row[9] = qa.shape[2], qa.data_ptr()
        else:
            if qa.dtype != torch.int64:
                raise TypeError("compiled_metrics: bounds int64")
            row[10] = qa.data_ptr()
    return desc, scratch


def _metrics_cuda(sig, t_s, valid, payloads, qargs, tb, nb) -> torch.Tensor:
    sig_cols, n_pad, slot_pad, _q = sig
    if len(sig_cols) > _MAX_COLS:
        raise ValueError(f"compiled_metrics: {len(sig_cols)} columns, at most {_MAX_COLS}")
    if t_s.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("compiled_metrics: t_s int32 bits, valid bool")
    _check_cuda("compiled_metrics", t_s, valid, tb, nb)
    desc, _scratch = _describe(sig, t_s, payloads, qargs)
    n_units, q = t_s.shape[0], tb.shape[0]
    out = torch.zeros((q, slot_pad), dtype=torch.int64, device=t_s.device)
    launched = ctypes.c_int32(0)
    with torch.cuda.device(t_s.device):
        err = _build.lib().tt_compiled_metrics(
            desc.ctypes.data, len(sig_cols), t_s.data_ptr(), valid.data_ptr(), n_pad, n_units,
            q, tb.data_ptr(), nb.data_ptr(), slot_pad, out.data_ptr(), ctypes.byref(launched),
            _stream(t_s))
    _build.check(err, "compiled_metrics")
    with _launch_lock:
        compiled_metrics.launches += 1
        compiled_metrics.kernel_launches += launched.value
    return out


def compiled_metrics(sig, t_s, valid, payloads, qargs, tb, nb) -> torch.Tensor:
    """Run the fused program of signature `sig` over the stacked units:
    (Q, slot_pad) int64 counts on the units' device (see the module
    docstring for the arguments)."""
    if _route("compiled_metrics", t_s) == "cpu":
        return _metrics_plain(sig, t_s, valid, payloads, qargs, tb, nb)
    return _metrics_cuda(sig, t_s, valid, payloads, qargs, tb, nb)


compiled_metrics.launches = 0  # dispatches of the fused program
compiled_metrics.kernel_launches = 0  # its kernels: at most two a dispatch


def build_metrics_program(sig):
    """sig = (sig_cols, n_pad, slot_pad, q) -> the fused program, a
    callable of (t_s, valid, payloads, qargs, tb, nb)."""

    def prog(t_s, valid, payloads, qargs, tb, nb):
        return compiled_metrics(sig, t_s, valid, payloads, qargs, tb, nb)

    return prog
