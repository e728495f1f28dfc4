"""Sort/dedupe/segment — the compaction core, in PyTorch.

Port of tempo_tpu/ops/merge.py (lexsort_rows, first_occurrence_mask,
segment_ids, merge_spans): concatenate the input blocks' span rows,
sort by (valid, traceID limbs, spanID limbs), mark first occurrences.

jnp.lexsort is stable, so the permutation is fixed even among equal
keys. Here it is a chain of stable sorts from the least significant key
to the most significant one. Pairs of uint32 limbs fold into one int64
key first (`_pair_key`), which turns the 7-key sort into 4 passes.
"""

from __future__ import annotations

import torch


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two uint32 limbs -> one int64 whose signed order is the unsigned
    order of the 64-bit value hi:lo. hi is re-centred to [-2**31, 2**31)
    so that hi * 2**32 + lo never overflows."""
    hi = (hi.to(torch.int64) & 0xFFFFFFFF) - (1 << 31)
    return hi * (1 << 32) + (lo.to(torch.int64) & 0xFFFFFFFF)


def _stable_lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable ascending sort by keys[0], then keys[1], ... -> (N,) int64."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm


def lexsort_rows(keys: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Stable ascending sort of (N, L) uint32 rows -> permutation (N,) int64.

    Invalid (padded) rows sort to the end regardless of key.
    """
    L = keys.shape[1]
    cols = [_pair_key(keys[:, i], keys[:, i + 1]) for i in range(0, L - 1, 2)]
    if L % 2:
        cols.append(keys[:, L - 1].to(torch.int64) & 0xFFFFFFFF)
    if valid is not None:
        cols = [(~valid).to(torch.int64)] + cols
    return _stable_lexsort(cols)


def first_occurrence_mask(sorted_keys: torch.Tensor,
                          valid_sorted: torch.Tensor | None = None) -> torch.Tensor:
    """True where a sorted row differs from its predecessor (unique rows)."""
    eq_prev = (sorted_keys[1:] == sorted_keys[:-1]).all(dim=1)
    first = torch.ones(1, dtype=torch.bool, device=sorted_keys.device)
    mask = torch.cat([first, ~eq_prev])
    if valid_sorted is not None:
        mask = mask & valid_sorted
    return mask


def segment_ids(change_mask: torch.Tensor) -> torch.Tensor:
    """0-based contiguous segment index per row from a boundary mask."""
    return torch.cumsum(change_mask.to(torch.int32), 0, dtype=torch.int32) - 1


def merge_spans(trace_limbs: torch.Tensor, span_limbs: torch.Tensor,
                valid: torch.Tensor | None = None) -> dict:
    """Plan a k-way merge+dedupe of span rows from several blocks.

    trace_limbs (N,4), span_limbs (N,2) uint32 values in any integer
    dtype, valid (N,) bool. Returns perm (N,) int32, keep (N,) bool,
    trace_seg (N,) int32, and 0-d int32 tensors n_rows and n_traces —
    the same outputs as the JAX merge_spans.
    """
    keys = torch.cat([trace_limbs.to(torch.int64), span_limbs.to(torch.int64)], dim=1)
    perm = lexsort_rows(keys, valid)
    skeys = keys[perm]
    if valid is not None:
        svalid = valid[perm]
    else:
        svalid = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    keep = first_occurrence_mask(skeys, svalid)
    trace_new = first_occurrence_mask(skeys[:, :4], svalid)
    new_kept = trace_new & keep
    return {
        "perm": perm.to(torch.int32),
        "keep": keep,
        "trace_seg": segment_ids(new_kept),
        "n_rows": keep.sum(dtype=torch.int32),
        "n_traces": new_kept.sum(dtype=torch.int32),
    }
