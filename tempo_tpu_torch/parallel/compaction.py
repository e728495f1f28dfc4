"""Compaction math on one device: merge plan plus bloom, HLL and
count-min partials over a padded span batch.

Port of tempo_tpu/parallel/compaction.py (CompactionPlans,
default_plans, local_compaction_step with axis=None, and the host
relocation planner plan_disjoint_runs that the block compactor's
zero-decode fast path uses). The sharded
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


def plan_disjoint_runs(block_rg_ranges):
    """Relocation plan for the zero-decode compaction fast path.

    block_rg_ranges[b] is block b's ordered row-group trace-ID ranges as
    inclusive (min_id, max_id) hex pairs (32-char, so string order ==
    numeric order). Returns segments in global trace-ID order:

      ("relocate", b, i)       — row group i of block b overlaps no row
                                 group of any other block: its rows pass
                                 through the k-way merge untouched, so
                                 its compressed pages can move verbatim
      ("merge", {b: (lo, hi)}) — half-open row-group index ranges whose
                                 trace-ID intervals overlap across
                                 blocks: the streaming merge runs over
                                 exactly these row groups

    Correctness rests on two block invariants: row groups are sorted by
    trace ID and a trace never spans row groups — so clusters of the
    interval sweep partition the trace-ID space, no trace appears in two
    segments, and concatenating segment outputs in plan order yields the
    globally sorted block. This is the same uniform ID-space reasoning
    as partition_by_id_range, at row-group instead of shard granularity.
    """
    items = []
    for b, ranges in enumerate(block_rg_ranges):
        for i, (lo, hi) in enumerate(ranges):
            items.append((lo, hi, b, i))
    items.sort()
    segments: list = []
    cluster: list = []
    cmax = ""

    def _close():
        if not cluster:
            return
        blocks = {b for _, _, b, _ in cluster}
        if len(blocks) == 1:
            # single-source cluster: every row group relocates (a whole
            # single-block job — a level bump — relocates end to end)
            segments.extend(("relocate", b, i) for _, _, b, i in cluster)
        else:
            rngs: dict[int, tuple[int, int]] = {}
            for _, _, b, i in cluster:
                lo_i, hi_i = rngs.get(b, (i, i + 1))
                rngs[b] = (min(lo_i, i), max(hi_i, i + 1))
            segments.append(("merge", rngs))

    for lo, hi, b, i in items:
        if cluster and lo <= cmax:
            cluster.append((lo, hi, b, i))
            cmax = max(cmax, hi)
        else:
            _close()
            cluster = [(lo, hi, b, i)]
            cmax = hi
    _close()
    return segments
