"""Run-space predicate helpers over rle pages, and the dictionary-side
code-set helpers (host numpy).

Port of the host half of tempo_tpu/ops/scan.py (NO_MATCH_CODE,
in_set_runs, between_runs, expand_run_mask, runs_firsts_seg,
pad_codes_u32, dict_codes_matching), which the block read path uses to
answer predicates per run without expanding column values. The device
scans over resident compressed pages (tempo_tpu/ops/scan.py:169-305)
arrive with the device tier of the column cache.
"""

from __future__ import annotations

import numpy as np

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
