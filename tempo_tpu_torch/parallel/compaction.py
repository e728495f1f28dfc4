"""Sharded compaction: ID-range shards over the mesh, merged sketches.

Port of tempo_tpu/parallel/compaction.py: CompactionPlans,
default_plans, local_compaction_step (one device), the sharded step
(sharded_compaction_step, make_sharded_compactor,
init_sketch_accumulators), the device payload plane
(make_payload_compactor, init_payload_buffers, pack_payload_flush) and
the host planners partition_by_id_range and plan_disjoint_runs.

1. The host splits a tile's span rows into R shards by uniform 128-bit
   trace-ID ranges (shard = traceID_hi * R >> 32); shards partition the
   ID space, so per-shard sort/dedupe is globally correct.
2. Each shard runs the local merge plus bloom/HLL/count-min partials on
   its own device (parallel/mesh.map_shards).
3. Partials merge over the range axis (parallel/mesh.reduce_range):
   bloom by OR (ops.bloom.psum_merge), HLL by MAX, counts and count-min
   by SUM (count-min wraps mod 2**32, as the uint32 psum does), then
   fold into per-window accumulators that stay on the devices across
   tiles; the host reads them once, at finish().

The accumulators and payload buffers are never moved to the host per
tile: the tile mergers (encoding/vtpu/compactor.py) count their bytes
into the transfer plane with util/devicetiming.count_transfer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tempo_tpu_torch.ops import bloom, merge, sketch
from tempo_tpu_torch.ops.hashing import MASK32
from tempo_tpu_torch.parallel import mesh as _mesh
from tempo_tpu_torch.parallel.mesh import RANGE_AXIS, WINDOW_AXIS


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
    sk = _sketch_partials(tids[perm], keep, valid[perm] if valid is not None else None, plans)
    return {
        "perm": plan["perm"],
        "keep": keep,
        "n_rows": plan["n_rows"],
        "n_traces": plan["n_traces"],
        "total_rows": plan["n_rows"],
        "total_traces": plan["n_traces"],
        **sk,
    }


def _sketch_partials(st: torch.Tensor, keep: torch.Tensor, svalid: torch.Tensor | None,
                     plans: CompactionPlans) -> dict:
    """bloom, hll and cm partials of sorted trace IDs `st`: the first
    occurrence of each unique trace among surviving rows feeds the bloom
    and HLL, every surviving row the count-min."""
    trace_first = merge.first_occurrence_mask(st.to(torch.int64), svalid) & keep
    words = bloom.build(st, plans.bloom, valid=trace_first)
    regs = sketch.hll_update(sketch.hll_init(plans.hll, st.device), st, plans.hll,
                             valid=trace_first)
    # span count per trace id (hot-trace detection feeds max_spans_per_trace)
    counts = sketch.cm_update(sketch.cm_init(plans.cm, st.device), st, plans.cm, valid=keep)
    return {"bloom": words, "hll": regs, "cm": counts}


def _keys(t) -> torch.Tensor:
    """uint32 limbs (int32 bits or wider) -> int64 values."""
    return t.to(torch.int64) & MASK32


def _per_shard(mesh, a):
    """(W, R, ...) stacked shard inputs -> (W*R, ...), shards in order."""
    return a.reshape(mesh.size, *a.shape[2:])


def sharded_compaction_step(mesh, tids, sids, valid, plans: CompactionPlans) -> dict:
    """local_compaction_step on every shard, merged over the range axis
    (the JAX step under shard_map with axis="range").

    tids (W, R, N, 4), sids (W, R, N, 2) uint32 and valid (W, R, N) bool,
    host arrays or tensors. Returns per-shard lists (shard order
    window-major) perm, keep, n_rows, n_traces, each on its shard's
    device, and per-window lists total_rows, total_traces, bloom, hll, cm
    on the window's lead device."""
    t_f, s_f, v_f = (_per_shard(mesh, a) for a in (tids, sids, valid))

    def one(s, dev):
        return local_compaction_step(
            _keys(_mesh.to_shard(t_f[s], dev)), _keys(_mesh.to_shard(s_f[s], dev)),
            _mesh.to_shard(v_f[s], dev).to(torch.bool), plans)

    outs = _mesh.map_shards(mesh, one)
    merged = {k: [o[k] for o in outs] for k in ("perm", "keep", "n_rows", "n_traces")}
    merged["total_rows"] = _mesh.reduce_range(mesh, merged["n_rows"], "sum")
    merged["total_traces"] = _mesh.reduce_range(mesh, merged["n_traces"], "sum")
    merged["bloom"], merged["hll"], merged["cm"] = _range_merge(mesh, outs)
    return merged


def _range_merge(mesh, partials: list) -> tuple:
    """The shards' bloom, hll and cm partials merged over the range axis:
    lists of W tensors on the window leads (OR, MAX, SUM mod 2**32)."""
    r = mesh.shape[RANGE_AXIS]
    words = [bloom.psum_merge([p["bloom"] for p in partials[i * r:(i + 1) * r]],
                              mesh.window_lead(i))
             for i in range(mesh.shape[WINDOW_AXIS])]
    regs = _mesh.reduce_range(mesh, [p["hll"] for p in partials], "max")
    cm = _mesh.reduce_range(mesh, [p["cm"] for p in partials], "sum32")
    return words, regs, cm


def _fold(accs, words: list, regs: list, cm: list) -> tuple:
    """Fold per-window merged sketches into the carried accumulators."""
    bloom_acc, hll_acc, cm_acc = accs
    return (
        [a | b for a, b in zip(bloom_acc, words)],
        [torch.maximum(a, b) for a, b in zip(hll_acc, regs)],
        [(a + b) & MASK32 for a, b in zip(cm_acc, cm)],
    )


def make_sharded_compactor(mesh, plans: CompactionPlans):
    """The sharded step with carried accumulators: step(tids, sids, valid,
    bloom_acc, hll_acc, cm_acc) over (W, R, N, ...) stacked shard inputs
    -> (sharded, accs). sharded: per-shard perm, keep, n_rows, n_traces;
    accs: per-window bloom (OR), hll (MAX), cm (SUM mod 2**32) folded into
    the carried accumulators — lists of W tensors that stay on the window
    lead devices across tiles — plus total_rows and total_traces."""

    def step(tids, sids, valid, bloom_acc, hll_acc, cm_acc):
        out = sharded_compaction_step(mesh, tids, sids, valid, plans)
        sharded = {k: out[k] for k in ("perm", "keep", "n_rows", "n_traces")}
        folded = _fold((bloom_acc, hll_acc, cm_acc), out["bloom"], out["hll"], out["cm"])
        accs = dict(zip(("bloom", "hll", "cm"), folded), total_rows=out["total_rows"],
                    total_traces=out["total_traces"])
        return sharded, accs

    return step


def init_sketch_accumulators(mesh, plans: CompactionPlans):
    """Zeroed per-window accumulators (bloom, hll, cm) for the sharded
    steps: lists of W int64 tensors (uint32 values) on the window leads."""
    leads = [mesh.window_lead(i) for i in range(mesh.shape[WINDOW_AXIS])]
    return (
        [torch.zeros((plans.bloom.n_shards, plans.bloom.words_per_shard), dtype=torch.int64,
                     device=d) for d in leads],
        [sketch.hll_init(plans.hll, d) for d in leads],
        [sketch.cm_init(plans.cm, d) for d in leads],
    )


def fetch_accumulators(accs) -> tuple:
    """The per-window accumulators on the host, merged across windows
    (OR, MAX, ADD mod 2**32) -> (bloom_words (S, wps) uint32, hll_regs
    (m,) uint32, cm_counts (depth, width) uint32, d2h bytes)."""
    bl, hl, cm = ([a.cpu().numpy() for a in part] for part in accs)
    nbytes = sum(a.size * 4 for part in (bl, hl, cm) for a in part)
    bloom_words = np.bitwise_or.reduce(np.stack(bl), axis=0).astype(np.uint32)
    hll_regs = np.stack(hl).max(axis=0).astype(np.uint32)
    cm_counts = (np.stack(cm).sum(axis=0) & MASK32).astype(np.uint32)
    return bloom_words, hll_regs, cm_counts, nbytes


# ---------------------------------------------------------------------------
# device-resident payload plane (CompactionOptions.payload_plane="device")
# ---------------------------------------------------------------------------
#
# Per tile, each shard merges its rows, resolves combine survivors,
# gathers the packed payload lanes by the survivor order, and appends the
# result to an output buffer on its device; the host fetches one packed
# vector a flush (about once a output row group).
#
# Lane layout (uint32 values):
#   input aux lanes (cap, 15):
#     0-1 parent_span_id, 2-3 start_unix_nano (hi,lo),
#     4-5 duration_nano (hi,lo), 6 kind|status<<8|http_status<<16,
#     7 name, 8 service, 9 http_method, 10 http_url,
#     11 n_attrs, 12-13 attr fingerprint (hi,lo), 14 job ordinal
#   kept output rows (C, 18): tid(4), sid(2), payload lanes 0-10, ordinal
#   dropped rows (D, 2): ordinal, local run id (for host attr union)

PAYLOAD_IN_LANES = 15
PAYLOAD_OUT_LANES = 18
_CMP_LANES = 14  # lanes compared for combine `differs` (all but ordinal)
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def _segment(op: str, x: torch.Tensor, seg: torch.Tensor, num: int, empty: int) -> torch.Tensor:
    """jax.ops.segment_max / segment_min: `empty` where a segment has no
    member (the dtype's identity, as XLA gives it)."""
    out = torch.full((num,), empty, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg, x, reduce=op, include_self=False)


def _payload_phase1(tids, sids, valid, lanes):
    """One shard's tile, up to its local combine count: merge plan, run
    ids, which runs differ, and the run count."""
    cap = tids.shape[0]
    dev = tids.device
    plan = merge.merge_spans(tids, sids, valid)
    perm = plan["perm"].to(torch.int64)
    keep = plan["keep"]
    n_runs = plan["n_rows"].to(torch.int64)
    svalid = valid[perm]
    slanes = lanes[perm]
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    run_id_raw = torch.cumsum(keep.to(torch.int64), 0) - 1
    # invalid rows park in segment cap-1: they can only collide with a
    # real run when every row is valid AND unique, i.e. none exist
    run_id = torch.where(svalid, run_id_raw.clamp(min=0), cap - 1)
    # combine `differs`: any member whose payload/nattr/fingerprint lanes
    # differ from its run's first occurrence
    firstpos = torch.cummax(torch.where(keep, pos, -1), 0).values.clamp(min=0)
    cmp = slanes[:, :_CMP_LANES]
    differs_row = (cmp != cmp[firstpos]).any(dim=1) & svalid & ~keep
    run_differs = _segment("amax", differs_row.to(torch.int64), run_id, cap, _I32_MIN) > 0
    real_run = pos < n_runs
    local_comb = (run_differs & real_run).sum()
    return {"perm": perm, "keep": keep, "n_runs": n_runs, "svalid": svalid,
            "slanes": slanes, "pos": pos, "run_id": run_id, "run_differs": run_differs,
            "real_run": real_run, "local_comb": local_comb}


def _payload_phase2(st, tids, sids, tile_comb):
    """Survivors, kept rows and dropped-member pairs of one shard's tile,
    given the tile's combine count over every shard."""
    cap = tids.shape[0]
    perm, svalid, slanes, pos, run_id = (st[k] for k in ("perm", "svalid", "slanes", "pos",
                                                          "run_id"))
    skeys = torch.cat([tids, sids], dim=1)[perm]

    def segmax(x):
        return _segment("amax", x, run_id, cap, _I32_MIN)

    # survivor per run: max (duration, n_attrs, sorted position) — the
    # cascaded segment max reproduces the host lexsort tie-break
    dh, dl, na = slanes[:, 4], slanes[:, 5], slanes[:, 11]
    m1 = segmax(torch.where(svalid, dh, 0))
    is1 = svalid & (dh == m1[run_id])
    m2 = segmax(torch.where(is1, dl, 0))
    is2 = is1 & (dl == m2[run_id])
    m3 = segmax(torch.where(is2, na, 0))
    is3 = is2 & (na == m3[run_id])
    surv_pos = segmax(torch.where(is3, pos, 0))
    first_pos = _segment("amin", torch.where(svalid, pos, cap), run_id, cap, _I32_MAX)
    chosen = torch.where(tile_comb > 0, surv_pos, first_pos).clamp(0, cap - 1)

    out_rows = torch.cat([skeys[chosen], slanes[chosen][:, :11], slanes[chosen][:, 14:15]], dim=1)
    out_rows = torch.where(st["real_run"][:, None], out_rows, 0)

    is_surv = svalid & (pos == chosen[run_id])
    mask_d = svalid & ~is_surv & st["run_differs"][run_id]
    n_drop = mask_d.sum()
    d_rows = torch.stack([slanes[:, 14], run_id], dim=1)
    # stable partition: dropped members first, in sorted order
    d_rows = d_rows[torch.sort((~mask_d).to(torch.int8), stable=True).indices]
    d_rows = torch.where((pos < n_drop)[:, None], d_rows, 0)
    return out_rows, d_rows, n_drop


def _append(buf: torch.Tensor, cursor: torch.Tensor, rows: torch.Tensor) -> None:
    """Write `rows` (a full cap-row slab) at the device-side cursor; the
    caller has checked on the host that cursor + cap fits."""
    idx = cursor + torch.arange(rows.shape[0], dtype=torch.int64, device=buf.device)
    buf.index_copy_(0, idx, rows.to(buf.dtype))


def make_payload_compactor(mesh, plans: CompactionPlans):
    """The device payload plane's step: step(tids, sids, valid, lanes,
    bufs, accs, bounds) over (W, R, cap, ...) host inputs.

    bufs (init_payload_buffers): per shard, on its device, kept_buf
    (C, 18), drop_buf (D, 2), kept_log / drop_log / comb_log (T,) and
    cnts (3,) [kept_cnt, drop_cnt, tile_idx], int64 holding uint32
    values; accs: the per-window sketch accumulators. Returns the new
    (bufs, accs).

    CAPACITY CONTRACT: each append writes a full cap-row slab at the
    shard's cursor. `bounds` = (kept_ub, drop_ub, tiles): the host's
    per-shard upper bounds of the cursors and the tiles in the window; the
    step raises before it launches anything when kept_ub + cap > C,
    drop_ub + cap > D or tiles >= T — it never writes past a buffer (the
    JAX step relied on the caller: XLA clamps an overflowing start into
    silent corruption). tile_comb, the tile's combine count, is summed
    over BOTH mesh axes: a tile spans every shard."""

    def step(tids, sids, valid, lanes, bufs, accs, bounds):
        cap = tids.shape[2]
        kept_ub, drop_ub, tiles = bounds
        C, D, T = bufs[0][0].shape[0], bufs[1][0].shape[0], bufs[2][0].shape[0]
        if tiles >= T or any(int(k) + cap > C for k in kept_ub) \
                or any(int(d) + cap > D for d in drop_ub):
            raise RuntimeError(
                f"device payload plane: a {cap}-row tile does not fit the buffers "
                f"(kept {C}, dropped {D}, tiles {T}): flush first")
        t_f, s_f, v_f, l_f = (_per_shard(mesh, a) for a in (tids, sids, valid, lanes))
        shard_in = _mesh.map_shards(mesh, lambda s, dev: (
            _keys(_mesh.to_shard(t_f[s], dev)), _keys(_mesh.to_shard(s_f[s], dev)),
            _mesh.to_shard(v_f[s], dev).to(torch.bool), _keys(_mesh.to_shard(l_f[s], dev))))
        states = _mesh.map_shards(mesh, lambda s, dev: _payload_phase1(*shard_in[s]))
        tile_comb = _mesh.reduce_all(mesh, [st["local_comb"] for st in states], "sum")
        kept_buf, drop_buf, kept_log, drop_log, comb_log, cnts = bufs
        partials = []

        def two(s, dev):
            t, sd, v, _ = shard_in[s]
            st = states[s]
            out_rows, d_rows, n_drop = _payload_phase2(st, t, sd, tile_comb.to(dev))
            kc, dc, ti = cnts[s][0], cnts[s][1], cnts[s][2]
            _append(kept_buf[s], kc, out_rows)
            _append(drop_buf[s], dc, d_rows)
            kept_log[s].index_copy_(0, ti.view(1), st["n_runs"].view(1))
            drop_log[s].index_copy_(0, ti.view(1), n_drop.view(1))
            comb_log[s].index_copy_(0, ti.view(1), st["local_comb"].view(1))
            cnts[s].copy_(torch.stack([kc + st["n_runs"], dc + n_drop, ti + 1]))
            # the sketch plane: local_compaction_step's partials
            partials.append(_sketch_partials(t[st["perm"]], st["keep"], st["svalid"], plans))

        _mesh.map_shards(mesh, two)
        return bufs, _fold(accs, *_range_merge(mesh, partials))

    return step


def init_payload_buffers(mesh, kept_cap: int, drop_cap: int, t_max: int):
    """Zeroed per-shard output buffers for make_payload_compactor: six
    lists (kept_buf, drop_buf, kept_log, drop_log, comb_log, cnts), one
    tensor a shard on its device."""
    return tuple(
        [torch.zeros(shape, dtype=torch.int64, device=d) for d in mesh.flat_devices]
        for shape in ((kept_cap, PAYLOAD_OUT_LANES), (drop_cap, 2), (t_max,), (t_max,),
                      (t_max,), (3,)))


def pack_payload_flush(mesh, bufs) -> np.ndarray:
    """Everything the host needs from a flush as ONE uint32 vector — the
    kept rows of every shard, then the dropped pairs, the three logs and
    the cursors, shard-major as the JAX package packs its (W, R, ...)
    arrays — gathered on the mesh's lead device and copied to the host
    in one transfer."""
    lead = mesh.lead
    parts = [b.reshape(-1).to(lead) for group in bufs for b in group]
    return torch.cat(parts).cpu().numpy().astype(np.uint32)


def partition_by_id_range(tids: np.ndarray, sids: np.ndarray, r: int,
                          pad_to: int | None = None, bucket=None):
    """Host-side split of span rows into R uniform trace-ID ranges.

    -> (tids (R,N,4), sids (R,N,2), valid (R,N), row_index (R,N) int64)
    row_index maps shard rows back to input rows (-1 for padding) so the
    host can gather payload columns per shard after the device pass.
    `bucket` (callable cap->padded cap, e.g. BlockConfig.bucket_for)
    rounds the shard capacity up to a static kernel shape in the same
    pass, so callers don't partition twice to learn the cap.
    """
    n = tids.shape[0]
    shard = ((tids[:, 0].astype(np.uint64) * np.uint64(r)) >> np.uint64(32)).astype(np.int64)
    order = np.argsort(shard, kind="stable")
    sizes = np.bincount(shard, minlength=r)
    cap = int(sizes.max()) if n else 1
    if pad_to is not None:
        if pad_to < cap:
            raise ValueError(f"pad_to={pad_to} < largest shard {cap}")
        cap = pad_to
    elif bucket is not None:
        cap = bucket(cap)
    t_out = np.zeros((r, cap, 4), np.uint32)
    s_out = np.zeros((r, cap, 2), np.uint32)
    valid = np.zeros((r, cap), bool)
    ridx = np.full((r, cap), -1, np.int64)
    off = 0
    for s in range(r):
        k = int(sizes[s])
        rows = order[off : off + k]
        off += k
        t_out[s, :k] = tids[rows]
        s_out[s, :k] = sids[rows]
        valid[s, :k] = True
        ridx[s, :k] = rows
    return t_out, s_out, valid, ridx


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
