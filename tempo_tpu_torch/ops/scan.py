"""Run-space predicate helpers over rle pages (host numpy).

Port of the host half of tempo_tpu/ops/scan.py (in_set_runs,
expand_run_mask, runs_firsts_seg), which the block read
path uses to answer predicates per run without expanding column values.
The device scans over resident compressed pages arrive with the
decoded-column cache and its device tier.
"""

from __future__ import annotations

import numpy as np


def in_set_runs(run_values: np.ndarray, codes: np.ndarray,
                invert: bool = False) -> np.ndarray:
    """Per-RUN in-set verdict: (n_runs,) bool. Row semantics match
    np.isin(expanded, codes, invert=...) exactly — every row of a run
    holds the run's value, so the run verdict IS the row verdict."""
    return np.isin(run_values, codes, invert=invert)


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
