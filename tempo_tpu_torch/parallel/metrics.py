"""Mesh-sharded TraceQL metrics: row-group slot batches fanned across
the mesh's devices, counts summed over the range axis.

Port of tempo_tpu/parallel/metrics.py. Up to W*R (block, row-group)
units stack on the mesh a dispatch; every shard counts its combined
(series, bin, bucket) slot ids with the seg_bincount kernel on its own
device (the plain version on the CPU), and the shards' counts add up
over the range axis on each window's lead device (parallel/mesh). Metric
counts are integers that merge by addition, so the result is
bit-identical to the host path at ANY shard count.

Integer width: the JAX program counts and psums in int32 per dispatch
and the host adds dispatches up in int64; the port's kernel adds int64
throughout. The two agree while one dispatch puts fewer than 2**31 rows
in one slot — a dispatch holds at most W*R row groups, so that needs
row groups of more than 2**31 / (W*R) spans. Past it the JAX counts
wrap negative and the port's stay exact.
"""

from __future__ import annotations

import logging

import numpy as np

from tempo_tpu_torch.ops.pallas_kernels import compress_slot_runs, seg_bincount
from tempo_tpu_torch.parallel import mesh as _mesh
from tempo_tpu_torch.parallel.mesh import RANGE_AXIS, WINDOW_AXIS
from tempo_tpu_torch.parallel.search import dispatch_lock as _dispatch_lock

log = logging.getLogger(__name__)


def make_sharded_bincount(mesh, n_slots: int):
    """Sharded segmented bincount over RUN-COMPRESSED slots:
    fn(slots, weights) with slots (W, R, N) int32 (combined slot id an
    entry; -1 = drop) and weights (W, R, N) int32 (rows carried by each
    entry), host arrays -> counts (W, n_slots) int64 numpy, each window's
    row the sum of its range shards' counts."""

    def run(slots, weights):
        w, r = mesh.shape[WINDOW_AXIS], mesh.shape[RANGE_AXIS]
        s_f = slots.reshape(w * r, -1)
        w_f = weights.reshape(w * r, -1)

        def one(s, dev):
            return seg_bincount(_mesh.to_shard(s_f[s].astype(np.int32), dev), n_slots,
                                _mesh.to_shard(w_f[s].astype(np.int32), dev))

        parts = _mesh.map_shards(mesh, one)
        per_w = _mesh.reduce_range(mesh, parts, "sum")
        return np.stack([c.cpu().numpy() for c in per_w])

    return run


class MeshMetricsEvaluator:
    """Mesh-sharded multi-block metrics evaluation (the query_range
    analog of MeshSearcher). Feeds a HostAccumulator: counts come from
    the mesh reduction, exemplars/series bookkeeping stay host-side."""

    def __init__(self, mesh, bucket_for):
        self.mesh = mesh
        self.w = mesh.shape[WINDOW_AXIS]
        self.r = mesh.shape[RANGE_AXIS]
        self.bucket_for = bucket_for
        self.last_stats: dict = {}

    def evaluate_blocks(self, blocks, plan, acc, on_block_error=None,
                        on_block_ok=None) -> None:
        """blocks: iterable of lazily-opened VtpuBackendBlocks. Row
        groups are zone-map/time pruned with zero reads, surviving units
        evaluate host-side to slot ids, and slot batches dispatch in
        stacked (W, R) chunks under the process-wide dispatch lock.

        Failure domains mirror MeshSearcher.search_blocks: a block
        deleted mid-query (NotFound) is skipped, but any other read
        error raises — a metrics job must fail loudly, never return
        silently-reduced counts that look complete. The
        on_block_error/on_block_ok callbacks feed quarantine accounting."""
        from tempo_tpu_torch.backend.base import NotFound
        from tempo_tpu_torch.backend.faults import with_retries
        from tempo_tpu_torch.encoding.vtpu.block import (
            pruned_row_groups_total,
            zone_maps_enabled,
        )
        from tempo_tpu_torch.metrics_engine.evaluate import (
            _lower_prunes,
            eval_batch,
            rg_eval_view,
            rg_prunes,
        )
        from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

        stats = self.last_stats = {"dispatches": 0, "units": 0, "h2d_bytes": 0}
        zm = zone_maps_enabled()
        all_conds = plan.pipeline.conditions().all_conditions
        cap = self.w * self.r
        scan = make_sharded_bincount(self.mesh, plan.n_slots)
        pending: list = []  # run-compressed (slots, weights) pairs
        opened: list = []

        def flush():
            if not pending:
                return
            pad = self.bucket_for(max(len(s) for s, _ in pending))
            stacked = np.full((cap, pad), -1, np.int32)
            wstack = np.zeros((cap, pad), np.int32)
            for i, (s, w) in enumerate(pending):
                stacked[i, : len(s)] = s
                wstack[i, : len(s)] = w if w is not None else 1
            with _dispatch_lock:
                out = timed_dispatch(
                    "mesh_bincount", scan,
                    stacked.reshape(self.w, self.r, pad),
                    wstack.reshape(self.w, self.r, pad),
                    device=self.mesh.lead)
            counts = out.sum(axis=0, dtype=np.int64)
            count_transfer("mesh_bincount", h2d=stacked.nbytes + wstack.nbytes,
                           d2h=out.nbytes)
            acc.counts += counts
            stats["dispatches"] += 1
            stats["units"] += len(pending)
            stats["h2d_bytes"] += stacked.nbytes + wstack.nbytes
            pending.clear()

        for blk in blocks:
            opened.append(blk)
            # buffer this block's contributions and commit them only once
            # the WHOLE block has evaluated: counts are integer adds with
            # no dedupe, so a block deleted mid-scan (NotFound below)
            # must contribute nothing — its spans live on in the
            # compaction output that replaced it
            blk_batches: list = []  # (slots, weights) pairs
            blk_results: list = []  # (res, view) for exemplars
            blk_spans = 0
            blk_pruned = 0
            try:
                d = with_retries(blk.dictionary)
                resolvers, impossible = _lower_prunes(plan, d)
                if impossible:
                    acc.stats["inspectedBlocks"] += 1
                    if on_block_ok is not None:
                        on_block_ok(blk.meta.block_id)
                    continue
                for rg in with_retries(blk.index).row_groups:
                    if rg.end_s < plan.start_s or rg.start_s > plan.end_s:
                        continue
                    if zm and resolvers and rg_prunes(plan, rg, resolvers, all_conds):
                        blk_pruned += 1
                        continue
                    # encoded-space filters + lazy projection, same seam
                    # as the host path (a dead run-space verdict skips
                    # the unit)
                    view, premask, dead = with_retries(
                        lambda b=blk, r=rg: rg_eval_view(plan, b, r, d))
                    blk_spans += rg.n_spans
                    if dead:
                        continue
                    res = with_retries(
                        lambda v=view, p=premask: eval_batch(
                            plan, v, d, acc.series, premask=p))
                    blk_results.append((res, view))
                    live = res.slots[res.slots >= 0]
                    if len(live):
                        # run-compressed: the bincount consumes (slot,
                        # weight) pairs, not raw rows
                        blk_batches.append(compress_slot_runs(live))
            except NotFound as e:  # deleted mid-query: benign, skip whole block
                log.warning("mesh metrics: block %s deleted mid-query: %s",
                            blk.meta.block_id, e)
                continue
            except Exception as e:
                log.warning("mesh metrics: block %s failed: %s",
                            blk.meta.block_id, e)
                if on_block_error is not None:
                    on_block_error(blk.meta.block_id, e)
                raise
            acc.stats["inspectedBlocks"] += 1
            acc.stats["inspectedSpans"] += blk_spans
            if blk_pruned:
                acc.stats["prunedRowGroups"] += blk_pruned
                blk.pruned_row_groups += blk_pruned
                pruned_row_groups_total.inc(blk_pruned)
            for res, view in blk_results:
                acc.observe_exemplars(res, view)
            for live in blk_batches:
                pending.append(live)
                if len(pending) >= cap:
                    flush()
            if on_block_ok is not None:
                on_block_ok(blk.meta.block_id)
        flush()
        acc.stats["inspectedBytes"] += sum(b.bytes_read for b in opened)
        acc.stats["decodedBytes"] += sum(
            getattr(b, "decoded_bytes", 0) for b in opened)

