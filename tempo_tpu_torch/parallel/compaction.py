"""Compaction math on one device: merge plan plus bloom, HLL and
count-min partials over a padded span batch.

Port of tempo_tpu/parallel/compaction.py (CompactionPlans,
default_plans, local_compaction_step with axis=None). The sharded
compactor and its cross-device merges (psum/pmax over a mesh) arrive
with the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tempo_tpu_torch.ops import bloom, merge, sketch


@dataclass(frozen=True)
class CompactionPlans:
    bloom: bloom.BloomPlan
    hll: sketch.HLLPlan
    cm: sketch.CMPlan


def default_plans(n_traces_hint: int = 1 << 16, fp: float = 0.01) -> CompactionPlans:
    return CompactionPlans(
        bloom=bloom.plan(n_traces_hint, fp),
        hll=sketch.HLLPlan(12),
        cm=sketch.CMPlan(4, 1 << 12),
    )


def local_compaction_step(tids: torch.Tensor, sids: torch.Tensor,
                          valid: torch.Tensor | None, plans: CompactionPlans) -> dict:
    """One device's compaction step (the flagship step that entry()
    exposes). tids (N,4), sids (N,2) uint32 values in any integer dtype,
    valid (N,) bool, all on one device.

    Returns perm (N,) int32, keep (N,) bool, n_rows and n_traces (0-d
    int32; total_* equal them on one device), bloom (n_shards,
    words_per_shard), hll (m,) and cm (depth, width), the sketches as
    int64 tensors holding uint32 values.
    """
    plan = merge.merge_spans(tids, sids, valid)
    perm, keep = plan["perm"].to(torch.int64), plan["keep"]
    st = tids[perm]
    # first occurrence of each unique trace among surviving rows
    trace_first = merge.first_occurrence_mask(
        st.to(torch.int64), valid[perm] if valid is not None else None) & keep

    words = bloom.build(st, plans.bloom, valid=trace_first)
    regs = sketch.hll_update(sketch.hll_init(plans.hll, st.device), st, plans.hll,
                             valid=trace_first)
    # span count per trace id (hot-trace detection feeds max_spans_per_trace)
    counts = sketch.cm_update(sketch.cm_init(plans.cm, st.device), st, plans.cm, valid=keep)
    return {
        "perm": plan["perm"],
        "keep": keep,
        "n_rows": plan["n_rows"],
        "n_traces": plan["n_traces"],
        "total_rows": plan["n_rows"],
        "total_traces": plan["n_traces"],
        "bloom": words,
        "hll": regs,
        "cm": counts,
    }
