"""Block compactor: k blocks -> 1 block, streamed through bounded tiles.

Port of tempo_tpu/encoding/vtpu/compactor.py: compact() with the
zero-decode fast path, the block streams, tile production, the emit
stage, the three merge planners, the combine semantics, and with a mesh
(CompactionOptions.mesh, parallel/mesh.Mesh) the mesh-sharded tile
merger (_ShardedTileMerger: payload on the host) and the device payload
plane (_DevicePayloadTileMerger, payload_plane="device"). Output blocks
are byte-identical on every path.

Reference analog: tempodb/encoding/vparquet/compactor.go:31-215 — k-way
bookmark merge of parquet rows that never materializes a whole block
(row groups are flushed at RowGroupSizeBytes, compactor.go:160-188), and
a combine closure that dedupes byte-equal rows but merges rows that
share an ID with differing payload (compactor.go:76-127).

- **Streaming**: each input block is a sorted stream of row groups. Per
  round, the merge loads at most one new row group per input block,
  takes the rows strictly below the *safe boundary* (the minimum of the
  per-stream last-loaded keys — any unloaded row anywhere sorts after
  it), merges that tile, and hands complete traces to the block writer,
  which flushes output row groups as they fill. Peak resident rows are
  O(k x row_group_spans), independent of job size.
- **Tile merge plan**: merge_path "auto"/"native" plans the order with
  the native C++ k-way bookmark merge over the per-stream sorted runs
  (one linear pass off the GIL); "device" runs `ops.merge.merge_spans`
  (stable lexsort over 128-bit trace-ID + span-ID limbs, first-occurrence
  mask) over the bucket-padded tile on the compactor's device; "numpy"
  is the single-threaded host mirror.
- **Sketch plane**: without a mesh, every merged batch's trace IDs feed
  a DeviceSketchAccumulator on the compactor's device (bloom OR, HLL
  max), fetched once at the end. With a mesh, each tile is partitioned
  into uniform trace-ID ranges (parallel/compaction.py), each shard
  merges on its device, and the shards' bloom/HLL/count-min partials
  merge over the range axis into per-window accumulators that stay on
  the devices across tiles (OR, max and add are associative, so tile
  partials compose exactly).
- **Combine**: duplicate (traceID, spanID) runs are not first-wins
  dropped. The survivor is the run member with the richest payload
  (max duration, then attr count), the attrs of all members are
  unioned onto it, and runs whose members actually differ are counted
  in `spans_combined` (reference: Combine in
  modules/compactor/compactor.go:219 + vparquet/compactor.go:76-127).
"""

from __future__ import annotations

import numpy as np
import torch

from tempo_tpu_torch import device as _device
from tempo_tpu_torch import native
from tempo_tpu_torch.backend.base import BlockMeta, TypedBackend
from tempo_tpu_torch.encoding.common import CompactionOptions
from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.encoding.vtpu.create import BlockWriter, DeviceSketchAccumulator
from tempo_tpu_torch.model.columnar import (
    ATTR_COLUMNS,
    CODE_COLUMNS,
    SPAN_COLUMNS,
    VT_STR,
    Dictionary,
    SpanBatch,
)
from tempo_tpu_torch.ops import bloom, merge, sketch
from tempo_tpu_torch.parallel import compaction as pcomp
from tempo_tpu_torch.parallel.compaction import plan_disjoint_runs
from tempo_tpu_torch.util.devicetiming import count_transfer
from tempo_tpu_torch.util.pipeline import ReadAhead, overlap_enabled, prefetch_iter

# span columns whose values can legitimately differ between RF copies of
# the same span; trace_id/span_id are the identity key.
_PAYLOAD_COLS = [c for c in SPAN_COLUMNS if c not in ("trace_id", "span_id")]


def remap_codes(remap: np.ndarray, cols: dict, attrs: dict) -> None:
    """Apply a dictionary remap in place: span CODE_COLUMNS, attr_key,
    and attr_str for VT_STR rows (non-string rows keep their numeric
    payload untouched). THE single definition of which columns carry
    dictionary codes — the streaming decode path (_BlockStream) and the
    zero-decode lazy gather both call this, so they cannot diverge on
    the remap invariant."""
    for k in CODE_COLUMNS:
        cols[k] = remap[cols[k]]
    attrs["attr_key"] = remap[attrs["attr_key"]]
    is_str = attrs["attr_vtype"] == VT_STR
    attrs["attr_str"] = np.where(
        is_str, remap[attrs["attr_str"]], attrs["attr_str"]
    ).astype(np.uint32)


def _sketch_tee(gen, acc):
    """Feed each merged batch to the device sketch accumulator (async
    dispatch) on its way to the block writer."""
    for b in gen:
        acc.update(b)
        yield b


class VtpuCompactor:
    """Compacts blocks: without a mesh the sketch plane (and, with
    merge_path="device", the merge plan) runs on `device` — CUDA unless
    device="cpu" is passed; raises without CUDA. With opts.mesh every
    tile merges over the mesh's devices. Output blocks are byte-identical
    whichever devices run them."""

    def __init__(self, opts: CompactionOptions | None = None, device=None):
        self.opts = opts or CompactionOptions()
        if self.opts.payload_plane not in ("host", "device"):
            raise ValueError(f"unknown payload_plane {self.opts.payload_plane!r}")
        if self.opts.payload_plane == "device" and self.opts.mesh is None:
            raise ValueError("payload_plane='device' requires a mesh")
        if self.opts.merge_path not in ("auto", "native", "device", "numpy"):
            raise ValueError(f"unknown merge_path {self.opts.merge_path!r}")
        self.device = (self.opts.mesh.lead if self.opts.mesh is not None
                       else _device.resolve(device))
        self.spans_dropped = 0
        self.spans_combined = 0
        # zero-decode accounting (host fast path): pages moved verbatim
        # vs pages that went through decode->re-encode
        self.pages_copied_verbatim = 0
        self.pages_reencoded = 0
        self.bytes_copied_verbatim = 0
        self.bytes_reencoded = 0
        self.row_groups_relocated = 0
        # resident-row high-water mark (stream buffers + tile), for the
        # bounded-memory contract tests
        self.max_resident_rows = 0
        # padded row counts of the merge plans run on the device
        self.device_merge_pads: list[int] = []
        # the sketch accumulator of the last compact() (transfer bytes)
        self.sketcher: DeviceSketchAccumulator | None = None
        # emit-stage state (per compact() run; compactors are single-job)
        self._pending: list[SpanBatch] = []
        self._pending_rows = 0
        self._stream_resident = 0
        self._devm = None
        # transfer accounting of the mesh merger of the last compact()
        self.payload_stats: dict | None = None

    # ------------------------------------------------------------------
    def compact(self, metas: list[BlockMeta], tenant: str, backend: TypedBackend) -> list[BlockMeta]:
        """Merge input blocks; returns metas of output blocks (1 today)."""
        if not metas:
            return []
        cfg = self.opts.block_config
        # reset emit-stage state: a previous compact() that failed
        # mid-stream must not leak its held-back spans into this job's
        # first row group (instance reuse across jobs is legal)
        self._pending, self._pending_rows, self._stream_resident = [], 0, 0
        out_dict = Dictionary()
        # column_cache=None: compaction reads every row group exactly
        # once — caching would only evict the query working set
        blocks = [VtpuBackendBlock(m, backend, cfg, column_cache=None) for m in metas]
        # remap every input dictionary onto the shared output dictionary
        # up front, in metas order (the same order the streams would) —
        # the fast path needs the remaps before any stream exists
        remaps = [b.dictionary().remap_onto(out_dict) for b in blocks]
        level = max(m.compaction_level for m in metas) + 1
        mesh = self.opts.mesh
        sketcher = None
        if mesh is None:
            # single-device sketch plane: per-batch async device updates
            # overlap the host's column encode; one small D2H at the end
            sketcher = self.sketcher = DeviceSketchAccumulator(
                cfg, sum(m.total_objects for m in metas), device=self.device)

        # zero-decode fast path: one device only (the mesh planes stage
        # rows to devices regardless); max_spans_per_trace forces the
        # decode path (a relocated row group can't be capped)
        if mesh is None and self.opts.zero_decode and not self.opts.max_spans_per_trace:
            segments = plan_disjoint_runs(
                [[(rg.min_id, rg.max_id) for rg in b.index().row_groups]
                 for b in blocks]
            )
            if any(s[0] == "relocate" for s in segments):
                return self._compact_fast(
                    blocks, remaps, segments, tenant, backend, out_dict, level, sketcher
                )

        streams = [
            _BlockStream(b, out_dict, remap=r) for b, r in zip(blocks, remaps)
        ]
        devm = sharded = None
        self._devm = None
        if mesh is not None and self.opts.payload_plane == "device":
            devm = self._devm = _DevicePayloadTileMerger(self.opts, metas)
            self.payload_stats = devm.stats
        elif mesh is not None:
            sharded = _ShardedTileMerger.build(self.opts, metas)
            self.payload_stats = sharded.stats
        # merge runs on a producer thread, overlapped with the consumer's
        # encode+write (native codec drops the GIL). On a single-core
        # host the overlap is pure overhead (see pipeline.overlap_enabled)
        # and the generator runs inline.
        inner = self._stream_merge(streams, out_dict, sharded, devm)
        gen = _sketch_tee(inner, sketcher) if sketcher else inner
        batches = prefetch_iter(gen, depth=2) if overlap_enabled() else gen
        sketches = (devm.finish if devm else
                    sharded.finish if sharded else sketcher.finish)
        writer = BlockWriter(tenant, backend, cfg, compaction_level=level,
                             device=self.device)
        try:
            for batch in batches:
                writer.append_batch(batch)
            out = writer.finish(sketches=sketches)
            self.pages_reencoded += writer.pages_reencoded
            self.bytes_reencoded += writer.bytes_reencoded
            if devm is not None:
                self.spans_combined += devm.spans_combined
        finally:
            # stop the producer thread + per-stream readahead even when
            # write/encode fails mid-stream (a long-lived compactor daemon
            # must not leak a thread per failed job)
            batches.close()
            try:
                inner.close()
            except ValueError:
                # prefetch join timed out with the producer wedged inside
                # the generator; the thread is leaked (already logged) and
                # the original exception must not be masked here
                pass
            for s in streams:
                s.close()
        return [out] if out else []

    # ------------------------------------------------------------------
    # zero-decode fast path
    # ------------------------------------------------------------------

    def _compact_fast(self, blocks, remaps, segments, tenant, backend,
                      out_dict, level, acc):
        """Drive the relocation plan: verbatim page moves for disjoint
        row groups, the streaming k-way merge for overlapping clusters —
        in plan order, which IS global trace-ID order, into one writer.

        The device sketch plane is unchanged: every trace ID (decoded
        IDs for relocated groups, merged batches for clusters) feeds the
        same DeviceSketchAccumulator — async launches, one D2H copy at
        finish — so block sketches are identical to the slow path's.
        """
        cfg = self.opts.block_config
        writer = BlockWriter(tenant, backend, cfg, compaction_level=level,
                             dictionary=out_dict, device=self.device)
        identity = [
            np.array_equal(r, np.arange(len(r), dtype=np.uint32)) for r in remaps
        ]
        # undersized groups (< half the target) take the decode path and
        # coalesce with their plan neighbors: relocating tails 1:1 would
        # let tiny row groups accumulate across compaction levels, where
        # the slow path re-chunks them to row_group_spans
        min_reloc = cfg.row_group_spans // 2
        small: list[SpanBatch] = []
        small_rows = 0

        def flush_small():
            nonlocal small, small_rows
            if small:
                batch = _concat_shared(small, out_dict)
                small, small_rows = [], 0
                acc.update(batch)
                writer.append_batch(batch)

        try:
            for seg in segments:
                if seg[0] == "relocate":
                    _, bi, ri = seg
                    rg = blocks[bi].index().row_groups[ri]
                    if rg.n_spans == 0:
                        continue
                    self.max_resident_rows = max(self.max_resident_rows, rg.n_spans)
                    if rg.n_spans >= min_reloc:
                        flush_small()  # held-back rows sort before this group
                        fallback = self._relocate_row_group(
                            blocks[bi], remaps[bi], identity[bi], rg, writer,
                            acc, out_dict,
                        )
                        if fallback is None:
                            continue
                        # intra-group duplicate keys (guard tripped): the
                        # already-fetched group dedupes through the merge
                        # plan alone — no other block overlaps it, so
                        # global order holds
                        merged = self._merge_tile(fallback, [fallback.num_spans])
                        acc.update(merged)
                        writer.append_batch(merged)
                        continue
                    raw = fmt.read_row_group_pages(blocks[bi]._reader(), rg)
                    batch = self._decode_rg(raw, rg, remaps[bi], out_dict)
                    small.append(self._merge_tile(batch, [batch.num_spans]))
                    small_rows += batch.num_spans
                    if small_rows >= cfg.row_group_spans:
                        flush_small()
                else:
                    flush_small()  # merge-cluster rows sort after
                    rngs = seg[1]
                    streams = [
                        _BlockStream(blocks[b], out_dict, remap=remaps[b],
                                     rg_range=rngs[b])
                        for b in sorted(rngs)
                    ]
                    inner = self._stream_merge(streams, out_dict)
                    gen = prefetch_iter(inner, depth=2) if overlap_enabled() else inner
                    try:
                        for batch in gen:
                            acc.update(batch)
                            writer.append_batch(batch)
                    finally:
                        gen.close()
                        try:
                            inner.close()
                        except ValueError:
                            pass  # wedged producer already logged; see compact()
                        for s in streams:
                            s.close()
            flush_small()
            out = writer.finish(sketches=acc.finish)
        finally:
            self.pages_copied_verbatim += writer.pages_copied_verbatim
            self.pages_reencoded += writer.pages_reencoded
            self.bytes_copied_verbatim += writer.bytes_copied_verbatim
            self.bytes_reencoded += writer.bytes_reencoded
            self.row_groups_relocated += writer.row_groups_relocated
        return [out] if out else []

    @staticmethod
    def _decode_rg(raw_pages: dict, rg, remap, out_dict) -> SpanBatch:
        """Full decode of one row group from already-fetched page bytes
        (no second backend read), remapped onto the output dictionary —
        the fast path's escape hatch for groups that can't relocate."""
        cols = {n: fmt.decode_page(raw_pages[n], rg.pages[n]) for n in SPAN_COLUMNS}
        attrs = {n: fmt.decode_page(raw_pages[n], rg.pages[n]) for n in ATTR_COLUMNS}
        remap_codes(remap, cols, attrs)
        return SpanBatch(cols=cols, attrs=attrs, dictionary=out_dict)

    def _relocate_row_group(self, block, remap, identity, rg, writer, acc,
                            out_dict):
        """Move one disjoint row group without decoding its payload.

        One ranged read fetches the group's compressed pages; only the
        trace/span ID pages decode — for the strict-ascending guard and
        to feed the sketch plane + exact group metadata. Under a
        non-identity dictionary remap, the dictionary-coded pages
        additionally decode -> remap -> re-encode (lazy column gather);
        every other page is copied byte-for-byte.

        Returns None on success. A duplicate key in the group needs the
        slow path's dedupe: the group is then fully decoded from the
        bytes already in hand and returned for the caller to merge.
        """
        raw_pages = fmt.read_row_group_pages(block._reader(), rg)
        tid = fmt.decode_page(raw_pages["trace_id"], rg.pages["trace_id"])
        sid = fmt.decode_page(raw_pages["span_id"], rg.pages["span_id"])
        if not merge.np_keys_strictly_increasing(tid, sid):
            return self._decode_rg(raw_pages, rg, remap, out_dict)
        new = np.ones(len(tid), bool)
        new[1:] = (tid[1:] != tid[:-1]).any(axis=1)
        firsts = np.flatnonzero(new)
        acc.update_ids(tid[firsts])
        reencode: dict[str, np.ndarray] = {}
        if not identity:
            # lazy column gather: decode exactly the dictionary-coded
            # pages (+ attr_vtype, which steers attr_str but relocates
            # verbatim itself) and push them through the shared remap
            cols = {
                name: fmt.decode_page(raw_pages[name], rg.pages[name])
                for name in CODE_COLUMNS
            }
            attrs = {
                name: fmt.decode_page(raw_pages[name], rg.pages[name])
                for name in ("attr_key", "attr_vtype", "attr_str")
            }
            remap_codes(remap, cols, attrs)
            reencode = {**cols, "attr_key": attrs["attr_key"],
                        "attr_str": attrs["attr_str"]}
        writer.append_relocated(
            rg, raw_pages, reencode,
            min_id=fmt.id_to_hex(tid[0]), max_id=fmt.id_to_hex(tid[-1]),
            n_traces=len(firsts),
            # the guard already decoded the ID column: offer it for the
            # lightweight-codec upgrade (legacy blocks gain rle trace_id
            # — and with it run-space trace segmentation — on their
            # first compaction, at zero extra decode)
            decoded={"trace_id": tid},
        )
        return None

    # ------------------------------------------------------------------
    def _stream_merge(self, streams, out_dict, sharded=None, devm=None):
        """Generator of merged, trace-complete SpanBatches in ID order.

        Three stages: tile production (k-way boundary rounds), tile merge
        (host/native/device plan, the mesh's sharded plan, or the device
        payload plane when devm is given — merged rows then surface only
        at its flushes), and emit (row-group-sized cuts with
        trailing-trace holdback). The emit stage sees per-tile merged
        batches in the same order under every mode, so output row-group
        boundaries are identical whether payload lives on host or device.
        """
        tiles = self._tile_stream(streams, out_dict)
        if devm is not None:
            merged_iter = devm.merged_stream(tiles)
        else:
            merged_iter = (
                self._merge_tile(tile, run_lengths, sharded)
                for tile, run_lengths in tiles
            )
        yield from self._emit_stream(merged_iter, out_dict)

    def _tile_stream(self, streams, out_dict):
        """Yield (tile, run_lengths) merge tiles in key order."""
        buffers: list[SpanBatch | None] = [None] * len(streams)
        while True:
            for i, s in enumerate(streams):
                # loop (not if): an empty row group in a corrupted or
                # foreign block must not stall the refill — dropping out
                # with an empty buffer while the stream still has rows
                # would silently truncate the merge
                while (buffers[i] is None or buffers[i].num_spans == 0) and not s.exhausted():
                    buffers[i] = s.next_batch()
            live = [i for i in range(len(streams)) if buffers[i] is not None and buffers[i].num_spans > 0]
            if not live:
                break
            open_streams = [i for i in live if not streams[i].exhausted()]

            parts: list[SpanBatch] = []
            if open_streams:
                boundary = min(_last_key(buffers[i]) for i in open_streams)
                for i in live:
                    cut = _count_below(buffers[i], boundary)
                    if cut:
                        parts.append(_slice_rows(buffers[i], 0, cut))
                        buffers[i] = _slice_rows(buffers[i], cut, buffers[i].num_spans)
                # progress: streams pinned at the boundary pull their next
                # row group so the boundary advances next round
                for i in open_streams:
                    if _last_key(buffers[i]) == boundary and not streams[i].exhausted():
                        nxt = streams[i].next_batch()
                        buffers[i] = _concat_shared([buffers[i], nxt], out_dict)
            else:
                # final round: everything left is safe
                for i in live:
                    parts.append(buffers[i])
                    buffers[i] = None

            self._stream_resident = sum(b.num_spans for b in buffers if b is not None)
            self._stream_resident += sum(p.num_spans for p in parts)

            if parts:
                tile = _concat_shared(parts, out_dict)
                yield tile, [p.num_spans for p in parts]

    def _emit_stream(self, merged_iter, out_dict):
        """Row-group-sized emits with trailing-trace holdback; the LAST
        merged batch is fed with final semantics (no holdback), detected
        by one-batch lookahead so deferred-merge modes need no separate
        end signal."""
        prev = None
        for merged in merged_iter:
            if prev is not None:
                yield from self._feed_emit(prev, out_dict, final=False)
            prev = merged
        if prev is not None:
            yield from self._feed_emit(prev, out_dict, final=True)

    def _feed_emit(self, merged, out_dict, final: bool):
        target = self.opts.block_config.row_group_spans
        resident = self._stream_resident + self._pending_rows
        if self._devm is not None:
            # tiles the device plane retains host-side for attr
            # reconstruction count against the bounded-memory contract
            resident += self._devm.retained_rows
        self.max_resident_rows = max(self.max_resident_rows, resident)
        if merged.num_spans:
            self._pending.append(merged)
            self._pending_rows += merged.num_spans
        if self._pending and (final or self._pending_rows >= target):
            pending = self._pending
            pend = _concat_shared(pending, out_dict) if len(pending) > 1 else pending[0]
            if final:
                emit, rest = pend, None
            else:
                # hold back the trailing trace — later rounds may merge
                # more of its spans (only the last trace can grow: all
                # future keys are >= the safe boundary)
                firsts, _ = pend.trace_boundaries()
                cut = int(firsts[-1])
                if cut == 0:
                    self._pending, self._pending_rows = [pend], pend.num_spans
                    return
                emit = _slice_rows(pend, 0, cut)
                rest = _slice_rows(pend, cut, pend.num_spans)
            self._pending = [rest] if rest is not None and rest.num_spans else []
            self._pending_rows = sum(p.num_spans for p in self._pending)
            if self.opts.max_spans_per_trace:
                emit, dropped = _cap_spans_per_trace(emit, self.opts.max_spans_per_trace)
                self.spans_dropped += dropped
                if dropped and self.opts.on_spans_dropped:
                    self.opts.on_spans_dropped(dropped)
            if emit.num_spans:
                yield emit

    # ------------------------------------------------------------------
    def _merge_tile(self, tile: SpanBatch, run_lengths: list[int], sharded=None) -> SpanBatch:
        if sharded is not None:
            order, keep = sharded.merge(tile)
        else:
            order, keep = _plan_order_host(
                tile, run_lengths, self.opts.block_config.bucket_for,
                self.opts.merge_path, self.device, self.device_merge_pads,
            )
        batch, combined = _combine_duplicates(tile, order, keep)
        self.spans_combined += combined
        return batch


# ---------------------------------------------------------------------------
# input streams
# ---------------------------------------------------------------------------


class _BlockStream:
    """Sorted row-group stream of one input block, with its dictionary
    codes remapped onto the shared output dictionary (one remap table per
    block — a block has a single dictionary — applied as vectorized
    gathers per row group).

    remap: precomputed dictionary remap table (the compactor builds all
    remaps up front); None computes it here. rg_range: half-open row
    group index range to stream (a merge segment of the zero-decode
    plan); None streams the whole block.
    """

    def __init__(self, block: VtpuBackendBlock, out_dict: Dictionary,
                 remap=None, rg_range: tuple[int, int] | None = None):
        self.block = block
        rgs = list(block.index().row_groups)
        self.rgs = rgs[rg_range[0] : rg_range[1]] if rg_range is not None else rgs
        self.pos = 0
        self.remap = (block.dictionary().remap_onto(out_dict)
                      if remap is None else remap)
        self.out_dict = out_dict
        # fetch+decode of row group i+1 overlaps the merge of row group i
        self._ahead = ReadAhead(self._load, len(self.rgs))

    def exhausted(self) -> bool:
        return self.pos >= len(self.rgs)

    def _load(self, i: int) -> SpanBatch:
        rg = self.rgs[i]
        cols = self.block.read_columns(rg, list(SPAN_COLUMNS))
        attrs = self.block.read_columns(rg, list(ATTR_COLUMNS))
        remap_codes(self.remap, cols, attrs)
        return SpanBatch(cols=cols, attrs=attrs, dictionary=self.out_dict)

    def next_batch(self) -> SpanBatch:
        batch = self._ahead.get(self.pos)
        self.pos += 1
        return batch

    def close(self):
        self._ahead.close()


def _concat_shared(batches: list[SpanBatch], out_dict: Dictionary) -> SpanBatch:
    """Concat batches that already share `out_dict` (no remapping)."""
    batches = [b for b in batches if b.num_spans > 0]
    if not batches:
        return SpanBatch(dictionary=out_dict)
    if len(batches) == 1:
        return batches[0]
    cols = {k: np.concatenate([b.cols[k] for b in batches]) for k in SPAN_COLUMNS}
    attrs = {}
    base = 0
    owners = []
    for b in batches:
        owners.append(b.attrs["attr_span"] + np.uint32(base))
        base += b.num_spans
    attrs["attr_span"] = np.concatenate(owners)
    for k in ATTR_COLUMNS:
        if k != "attr_span":
            attrs[k] = np.concatenate([b.attrs[k] for b in batches])
    return SpanBatch(cols=cols, attrs=attrs, dictionary=out_dict)


def _slice_rows(batch: SpanBatch, lo: int, hi: int) -> SpanBatch:
    if lo == 0 and hi == batch.num_spans:
        return batch
    cols = {k: v[lo:hi] for k, v in batch.cols.items()}
    # attr_span is sorted (row-group pages store attrs in owner order and
    # select/concat preserve it), so the owner range is a contiguous slice
    o = batch.attrs["attr_span"]
    a_lo, a_hi = np.searchsorted(o, [lo, hi])
    attrs = {k: v[a_lo:a_hi] for k, v in batch.attrs.items()}
    attrs["attr_span"] = (attrs["attr_span"] - np.uint32(lo)).astype(np.uint32)
    return SpanBatch(cols=cols, attrs=attrs, dictionary=batch.dictionary)


def _key_lanes(batch: SpanBatch):
    """(hi, mid, lo) uint64 lanes of the (traceID, spanID) sort key."""
    tid = batch.cols["trace_id"].astype(np.uint64)
    sid = batch.cols["span_id"].astype(np.uint64)
    hi = (tid[:, 0] << np.uint64(32)) | tid[:, 1]
    mid = (tid[:, 2] << np.uint64(32)) | tid[:, 3]
    lo = (sid[:, 0] << np.uint64(32)) | sid[:, 1]
    return hi, mid, lo


def _last_key(batch: SpanBatch):
    t = batch.cols["trace_id"][-1]
    s = batch.cols["span_id"][-1]
    return (int(t[0]), int(t[1]), int(t[2]), int(t[3]), int(s[0]), int(s[1]))


def _count_below(batch: SpanBatch, boundary) -> int:
    """Rows with key strictly below `boundary` (rows are sorted, so the
    below-set is a prefix)."""
    hi, mid, lo = _key_lanes(batch)
    bhi = (boundary[0] << 32) | boundary[1]
    bmid = (boundary[2] << 32) | boundary[3]
    blo = (boundary[4] << 32) | boundary[5]
    below = (hi < bhi) | ((hi == bhi) & ((mid < bmid) | ((mid == bmid) & (lo < blo))))
    return int(below.sum())


# ---------------------------------------------------------------------------
# tile merge planning
# ---------------------------------------------------------------------------


def _plan_order_host(tile: SpanBatch, run_lengths: list[int], bucket_for,
                     path: str = "auto", device: torch.device | None = None,
                     device_pads: list | None = None):
    """Full sorted order + first-occurrence mask for one tile.

    path "auto"/"native": native C++ k-way bookmark merge over the
    per-stream sorted runs when the .so is built; "device" (or no .so,
    or a single run): `merge.merge_spans` on `device` over the tile
    padded to bucket_for(n) rows (invalid rows sort last), whose padded
    size is appended to `device_pads`; "numpy": the single-threaded host
    mirror (the benchmark's CPU-pipeline baseline).
    """
    if path == "numpy":
        plan = merge.np_merge_spans(tile.cols["trace_id"], tile.cols["span_id"])
        return plan["perm"].astype(np.int64), plan["keep"]
    nat = native.lib() if path in ("auto", "native") else None
    if nat is not None and len(run_lengths) > 1:
        hi, mid, lo = _key_lanes(tile)
        his, mids, los, bases = [], [], [], []
        off = 0
        for rows in run_lengths:
            his.append(hi[off : off + rows])
            mids.append(mid[off : off + rows])
            los.append(lo[off : off + rows])
            bases.append(off)
            off += rows
        stream, row, dup = nat.kway_merge_u192(his, mids, los)
        order = np.asarray(bases, dtype=np.int64)[stream] + row
        return order, ~dup
    n = tile.num_spans
    pad = bucket_for(n)
    if device is None:
        device = _device.resolve(None)
    keys = np.zeros((pad, 6), np.uint32)
    keys[:n, :4] = tile.cols["trace_id"]
    keys[:n, 4:] = tile.cols["span_id"]
    # the limbs ship as 4-byte words and widen to int64 on the device
    d_keys = torch.from_numpy(keys.view(np.int32)).to(device).to(torch.int64) & 0xFFFFFFFF
    valid = torch.arange(pad, device=device) < n
    count_transfer("merge_spans", h2d=keys.nbytes)
    plan = merge.merge_spans(d_keys[:, :4], d_keys[:, 4:], valid)
    # invalid rows sort to the end: the first n perm entries are the real rows
    perm = plan["perm"][:n].to(torch.int64).cpu().numpy()
    keep = plan["keep"][:n].cpu().numpy()
    count_transfer("merge_spans", d2h=perm.nbytes + keep.nbytes)
    if device_pads is not None:
        device_pads.append(pad)
    return perm, keep


def _mesh_plans(opts: CompactionOptions, metas: list[BlockMeta]) -> pcomp.CompactionPlans:
    """The mesh mergers' sketch plans: the bloom sized from the bucketed
    sum of input object counts, as DeviceSketchAccumulator sizes it, so
    the mesh's block is byte-identical to the one-device block."""
    cfg = opts.block_config
    est_traces = cfg.bucket_for(max(1, sum(m.total_objects for m in metas)))
    return pcomp.CompactionPlans(
        bloom=bloom.plan(est_traces, cfg.bloom_fp, cfg.bloom_shard_size_bytes),
        hll=sketch.HLLPlan(cfg.hll_precision),
        cm=sketch.CMPlan(4, 1 << 12),
    )


def _finish_sketches(accs, plans: pcomp.CompactionPlans, kernel: str) -> dict:
    """Block-level sketches from the per-window accumulators — the ONLY
    device-to-host sketch copy of the job; windows merge on the host
    (OR, max, add), as the JAX package merges them.

    hll_regs/cm_counts ride along for callers beyond write_block
    (hot-trace detection, bench recall accounting)."""
    bloom_words, hll_regs, cm_counts, nbytes = pcomp.fetch_accumulators(accs)
    count_transfer(kernel, d2h=nbytes)
    est = float(sketch.hll_estimate(torch.from_numpy(hll_regs.astype(np.int64)), plans.hll))
    return {
        "bloom_plan": plans.bloom,
        "bloom_words": bloom_words,
        "hll_regs": hll_regs,
        "cm_counts": cm_counts,
        "est_distinct": int(est),
    }


class _ShardedTileMerger:
    """Per-tile mesh-sharded merge + tile-accumulated sketches.

    Tiles are partitioned into uniform trace-ID ranges; each shard runs
    the local merge on its device and the shards' bloom/HLL/CM partials
    merge over the range axis (parallel/compaction.make_sharded_compactor).
    Because all spans of a trace land in one shard and tiles partition
    the key space, concatenating shard outputs in shard order yields the
    globally sorted order, and OR/max/add of tile sketches equals the
    sketches of the whole block. perm/keep come back to the host every
    tile (the payload columns are gathered there).
    """

    def __init__(self, mesh, plans, bucket_for):
        self.mesh = mesh
        self.plans = plans
        self.r = mesh.shape["range"] * mesh.shape["window"]
        self.bucket_for = bucket_for
        self.step = pcomp.make_sharded_compactor(mesh, plans)
        # sketch accumulators live ON DEVICE across tiles; one D2H in
        # finish() per block
        self._accs = pcomp.init_sketch_accumulators(mesh, plans)
        # dispatch counts, reduction counts, per-shard row balance and
        # transfer volumes of the job
        self.stats = {
            "tiles": 0, "dispatches": 0, "collectives": 0,
            "h2d_bytes": 0, "d2h_bytes": 0, "d2h_plan_fetches": 0,
            "per_shard_rows": np.zeros(self.r, np.int64),
        }

    @staticmethod
    def build(opts: CompactionOptions, metas: list[BlockMeta]) -> "_ShardedTileMerger":
        return _ShardedTileMerger(opts.mesh, _mesh_plans(opts, metas),
                                  opts.block_config.bucket_for)

    def merge(self, tile: SpanBatch):
        tids = tile.cols["trace_id"]
        sids = tile.cols["span_id"]
        t, s, v, ridx = pcomp.partition_by_id_range(tids, sids, self.r, bucket=self.bucket_for)
        cap = t.shape[1]
        w = self.mesh.shape["window"]
        rr = self.mesh.shape["range"]
        shaped, accs = self.step(
            t.reshape(w, rr, cap, 4), s.reshape(w, rr, cap, 2), v.reshape(w, rr, cap),
            *self._accs)
        # carry the device-resident accumulators into the next tile; no
        # host transfer happens here (perm/keep ARE needed on host to
        # reorder the payload columns)
        self._accs = (accs["bloom"], accs["hll"], accs["cm"])
        perm = np.stack([p.cpu().numpy() for p in shaped["perm"]])
        keep = np.stack([k.cpu().numpy() for k in shaped["keep"]])
        n_valid = v.sum(axis=1)
        st = self.stats
        st["tiles"] += 1
        st["dispatches"] += 1
        # OR(bloom) + MAX(hll) + SUM(cm) + SUM(rows) + SUM(traces)
        st["collectives"] += 5
        st["h2d_bytes"] += t.nbytes + s.nbytes + v.nbytes
        st["d2h_plan_fetches"] += 1  # the per-tile perm/keep fetch the
        # device payload plane (payload_plane="device") eliminates
        st["d2h_bytes"] += perm.nbytes + keep.nbytes
        st["per_shard_rows"] += n_valid
        # process-wide transfer plane, at the SAME statements as the
        # per-job stats (the sketch accumulators stay on the devices)
        count_transfer("mesh_compaction",
                       h2d=t.nbytes + s.nbytes + v.nbytes,
                       d2h=perm.nbytes + keep.nbytes)

        orders, keeps = [], []
        for shard in range(self.r):
            k = int(n_valid[shard])
            if k == 0:
                continue
            p = perm[shard, :k].astype(np.int64)  # invalid rows sort last; the prefix is real
            orders.append(ridx[shard][p])
            keeps.append(keep[shard, :k])
        order = np.concatenate(orders) if orders else np.empty(0, np.int64)
        keepm = np.concatenate(keeps) if keeps else np.empty(0, bool)
        return order, keepm

    def finish(self) -> dict:
        """Block-level sketches for write_block (post all tiles)."""
        return _finish_sketches(self._accs, self.plans, "mesh_compaction")


class _DevicePayloadTileMerger:
    """Mesh merge with the payload plane ON DEVICE.

    Each tile's span columns are packed into u32 lanes and staged to the
    shards' devices; every shard merges, resolves combine survivors, and
    gathers its payload rows on its device, appending survivors to a
    device-resident buffer. The host fetches ONE packed array per flush
    (~once per output row group: flushes trigger at 2x the row-group
    span target) and rebuilds span columns from the returned lanes. Only
    the ragged attr table is gathered host-side, driven by the
    survivor/dropped ordinals carried in the same fetch. No per-tile plan
    fetch; the sketch accumulators ride the same step, as in
    _ShardedTileMerger.

    Byte-parity: merged batches surface to the emit stage per tile in
    tile order (flush timing never changes emit decisions), and
    survivors and combine semantics mirror _combine_duplicates exactly,
    so output blocks are byte-identical to the host-payload path.
    """

    T_MAX = 64  # max tiles per flush window (the logs' length)

    def __init__(self, opts: CompactionOptions, metas: list[BlockMeta]):
        cfg = opts.block_config
        self.plans = _mesh_plans(opts, metas)
        self.mesh = opts.mesh
        self.w = self.mesh.shape["window"]
        self.rr = self.mesh.shape["range"]
        self.r = self.w * self.rr
        self.bucket_for = cfg.bucket_for
        self.target = cfg.row_group_spans
        self.step = pcomp.make_payload_compactor(self.mesh, self.plans)
        self._accs = pcomp.init_sketch_accumulators(self.mesh, self.plans)
        self._bufs = None
        self._cap_alloc = 0  # largest tile shard cap the buffers accept
        self.kept_cap = 0
        self.drop_cap = 0
        # host-side flush bookkeeping
        self._tiles: list[tuple[SpanBatch, int]] = []  # (tile, base ordinal)
        self.retained_rows = 0  # host-resident rows across retained tiles
        self._ub_k = np.zeros(self.r, np.int64)  # per-shard kept upper bound
        self._ub_d = np.zeros(self.r, np.int64)
        self._pushed = 0  # valid rows since last flush
        self._base = 0  # next job-global row ordinal
        self._ready: list[SpanBatch] = []
        self.spans_combined = 0
        self.stats = {
            "tiles": 0, "h2d_bytes": 0, "d2h_flushes": 0, "d2h_bytes": 0,
            "dispatches": 0, "collectives": 0, "kept_rows": 0,
            "dropped_rows": 0, "per_shard_kept": np.zeros(self.r, np.int64),
        }

    # ------------------------------------------------------------------
    def merged_stream(self, tiles):
        """Drive tiles through the device plane; yield per-tile merged
        batches in tile order (they surface at flush boundaries)."""
        for tile, _run_lengths in tiles:
            self.push(tile)
            while self._ready:
                yield self._ready.pop(0)
        self._flush()
        while self._ready:
            yield self._ready.pop(0)

    # ------------------------------------------------------------------
    def push(self, tile: SpanBatch) -> None:
        tids = tile.cols["trace_id"]
        sids = tile.cols["span_id"]
        t, s, v, ridx = pcomp.partition_by_id_range(tids, sids, self.r, bucket=self.bucket_for)
        cap = t.shape[1]
        sizes = v.sum(axis=1)

        # CAPACITY CONTRACT (make_payload_compactor): each append writes
        # a full cap-row slab at the cursor — flush BEFORE any shard could
        # overflow, before the tile log fills, and once enough rows for
        # ~one output row group are buffered (the step refuses a tile
        # that would not fit)
        if self._tiles and (
            len(self._tiles) >= self.T_MAX
            or (self._ub_k + cap > self.kept_cap).any()
            or (self._ub_d + cap > self.drop_cap).any()
            or self._pushed >= 2 * self.target
        ):
            self._flush()
        if self._bufs is None or cap > self._cap_alloc:
            if self._tiles:
                self._flush()
            self._alloc_buffers(cap)

        lanes = self._pack_lanes(tile)
        lanes_sh = lanes[np.maximum(ridx, 0)]
        lanes_sh[ridx < 0] = 0

        self._bufs, self._accs = self.step(
            t.reshape(self.w, self.rr, cap, 4),
            s.reshape(self.w, self.rr, cap, 2),
            v.reshape(self.w, self.rr, cap),
            lanes_sh.reshape(self.w, self.rr, cap, pcomp.PAYLOAD_IN_LANES),
            self._bufs, self._accs, (self._ub_k, self._ub_d, len(self._tiles)))

        self._tiles.append((tile, self._base))
        self.retained_rows += tile.num_spans
        self._base += tile.num_spans
        self._ub_k += sizes
        self._ub_d += sizes
        self._pushed += int(sizes.sum())
        st = self.stats
        st["tiles"] += 1
        st["dispatches"] += 1
        # OR(bloom) + MAX(hll) + SUM(cm) + SUM(tile_comb) per tile
        st["collectives"] += 4
        h2d = sum(int(x.nbytes) for x in (t, s, v, lanes_sh))
        st["h2d_bytes"] += h2d
        count_transfer("payload_compaction", h2d=h2d)

    # ------------------------------------------------------------------
    def _alloc_buffers(self, cap: int) -> None:
        # room for ~one flush window (2x row-group target spread over R
        # shards) plus one full slab of the largest tile, rounded to a
        # bucket
        per_shard = 2 * max(self.target // self.r, 1)
        self.kept_cap = self.bucket_for(per_shard + 2 * cap)
        self.drop_cap = self.kept_cap
        self._cap_alloc = cap
        self._bufs = pcomp.init_payload_buffers(self.mesh, self.kept_cap, self.drop_cap,
                                                self.T_MAX)

    # ------------------------------------------------------------------
    def _pack_lanes(self, tile: SpanBatch) -> np.ndarray:
        n = tile.num_spans
        lanes = np.zeros((n, pcomp.PAYLOAD_IN_LANES), np.uint32)
        c = tile.cols
        lanes[:, 0:2] = c["parent_span_id"]
        start = c["start_unix_nano"]
        lanes[:, 2] = (start >> np.uint64(32)).astype(np.uint32)
        lanes[:, 3] = (start & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        dur = c["duration_nano"]
        lanes[:, 4] = (dur >> np.uint64(32)).astype(np.uint32)
        lanes[:, 5] = (dur & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        lanes[:, 6] = (
            c["kind"].astype(np.uint32)
            | (c["status_code"].astype(np.uint32) << 8)
            | (c["http_status"].astype(np.uint32) << 16)
        )
        lanes[:, 7] = c["name"]
        lanes[:, 8] = c["service"]
        lanes[:, 9] = c["http_method"]
        lanes[:, 10] = c["http_url"]
        if tile.num_attrs:
            lanes[:, 11] = np.bincount(
                tile.attrs["attr_span"], minlength=n).astype(np.uint32)
            fp = _attr_fingerprint(tile)
            lanes[:, 12] = (fp >> np.uint64(32)).astype(np.uint32)
            lanes[:, 13] = (fp & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        lanes[:, 14] = (self._base + np.arange(n)).astype(np.uint32)
        return lanes

    # ------------------------------------------------------------------
    def _flush(self) -> None:
        """ONE packed D2H: kept payload rows, dropped-member pairs, and
        per-(tile, shard) counts; rebuild per-tile merged batches."""
        if not self._tiles:
            return
        packed = pcomp.pack_payload_flush(self.mesh, self._bufs)
        self.stats["d2h_flushes"] += 1
        self.stats["d2h_bytes"] += packed.nbytes
        count_transfer("payload_compaction", d2h=packed.nbytes)

        r, C, D, T = self.r, self.kept_cap, self.drop_cap, self.T_MAX
        lanes_out = pcomp.PAYLOAD_OUT_LANES
        o = 0
        kept = packed[o : o + r * C * lanes_out].reshape(r, C, lanes_out)
        o += r * C * lanes_out
        drop = packed[o : o + r * D * 2].reshape(r, D, 2)
        o += r * D * 2
        kept_log = packed[o : o + r * T].reshape(r, T).astype(np.int64)
        o += r * T
        drop_log = packed[o : o + r * T].reshape(r, T).astype(np.int64)
        o += r * T
        comb_log = packed[o : o + r * T].reshape(r, T).astype(np.int64)
        o += r * T
        cnts = packed[o : o + r * 3].reshape(r, 3).astype(np.int64)

        n_tiles = len(self._tiles)
        # sanity: device cursors must equal the log sums
        if not (np.array_equal(cnts[:, 0], kept_log[:, :n_tiles].sum(axis=1))
                and np.array_equal(cnts[:, 1], drop_log[:, :n_tiles].sum(axis=1))
                and (cnts[:, 2] == n_tiles).all()):
            raise AssertionError("device payload buffers out of sync with logs")

        offs_k = np.zeros(r, np.int64)
        offs_d = np.zeros(r, np.int64)
        for t_i, (tile, tbase) in enumerate(self._tiles):
            shard_rows = []
            for sh in range(r):
                k = int(kept_log[sh, t_i])
                shard_rows.append(kept[sh, offs_k[sh] : offs_k[sh] + k])
                offs_k[sh] += k
            rows = np.concatenate(shard_rows) if shard_rows else np.empty(
                (0, lanes_out), np.uint32)
            shard_base = np.concatenate(
                [[0], np.cumsum([len(x) for x in shard_rows])])[:-1]
            drop_pairs = []
            for sh in range(r):
                dn = int(drop_log[sh, t_i])
                if dn:
                    dp = drop[sh, offs_d[sh] : offs_d[sh] + dn]
                    drop_pairs.append(
                        (dp[:, 0].astype(np.int64), shard_base[sh] + dp[:, 1].astype(np.int64)))
                offs_d[sh] += dn
            comb_t = int(comb_log[:, t_i].sum())
            self._ready.append(self._reconstruct(tile, tbase, rows, drop_pairs, comb_t))
            self.stats["kept_rows"] += len(rows)
            self.stats["per_shard_kept"] += kept_log[:, t_i]
        self.stats["dropped_rows"] += int(drop_log[:, :n_tiles].sum())

        # reset the flush window (fresh zeroed buffers; accs carry on)
        self._bufs = pcomp.init_payload_buffers(self.mesh, self.kept_cap, self.drop_cap,
                                                self.T_MAX)
        self._tiles = []
        self.retained_rows = 0
        self._ub_k[:] = 0
        self._ub_d[:] = 0
        self._pushed = 0

    # ------------------------------------------------------------------
    def _reconstruct(self, tile: SpanBatch, tbase: int, rows: np.ndarray,
                     drop_pairs, comb_t: int) -> SpanBatch:
        """Merged batch from device lanes; attrs host-gathered to mirror
        _combine_duplicates byte-for-byte."""
        n = len(rows)
        u64 = np.uint64
        cols = {
            "trace_id": np.ascontiguousarray(rows[:, 0:4]),
            "span_id": np.ascontiguousarray(rows[:, 4:6]),
            "parent_span_id": np.ascontiguousarray(rows[:, 6:8]),
            "start_unix_nano": (rows[:, 8].astype(u64) << u64(32)) | rows[:, 9].astype(u64),
            "duration_nano": (rows[:, 10].astype(u64) << u64(32)) | rows[:, 11].astype(u64),
            "kind": (rows[:, 12] & 0xFF).astype(np.uint8),
            "status_code": ((rows[:, 12] >> 8) & 0xFF).astype(np.uint8),
            "http_status": ((rows[:, 12] >> 16) & 0xFFFF).astype(np.uint16),
            "name": np.ascontiguousarray(rows[:, 13]),
            "service": np.ascontiguousarray(rows[:, 14]),
            "http_method": np.ascontiguousarray(rows[:, 15]),
            "http_url": np.ascontiguousarray(rows[:, 16]),
        }
        survivors = rows[:, 17].astype(np.int64) - tbase  # tile-local rows
        self.spans_combined += comb_t

        if tile.num_attrs == 0:
            from tempo_tpu_torch.model.columnar import _empty_cols

            return SpanBatch(cols=cols, attrs=_empty_cols(ATTR_COLUMNS),
                             dictionary=tile.dictionary)

        # survivor attrs: exact mirror of SpanBatch.select's attr path
        pos = np.full(tile.num_spans, -1, np.int64)
        pos[survivors] = np.arange(n)
        o = tile.attrs["attr_span"]
        owner = pos[o]
        keepm = owner >= 0
        sel = {k: v[keepm] for k, v in tile.attrs.items()}
        sel["attr_span"] = owner[keepm].astype(np.uint32)
        order = np.argsort(sel["attr_span"], kind="stable")
        sel = {k: v[order] for k, v in sel.items()}

        if drop_pairs:
            m_ord = np.concatenate([p[0] for p in drop_pairs]) - tbase
            m_run = np.concatenate([p[1] for p in drop_pairs])
            row_to_run = np.full(tile.num_spans, -1, np.int64)
            row_to_run[m_ord] = m_run
            take = row_to_run[o] >= 0
            if take.any():
                extra = {k: v[take] for k, v in tile.attrs.items()}
                extra["attr_span"] = row_to_run[o[take]].astype(np.uint32)
                attrs = {k: np.concatenate([sel[k], extra[k]]) for k in ATTR_COLUMNS}
                sel = _dedupe_attrs(attrs)
        return SpanBatch(cols=cols, attrs=sel, dictionary=tile.dictionary)

    # ------------------------------------------------------------------
    def finish(self) -> dict:
        """Block-level sketches — same contract as _ShardedTileMerger."""
        return _finish_sketches(self._accs, self.plans, "payload_compaction")


def _combine_duplicates(batch: SpanBatch, order: np.ndarray, keep_sorted: np.ndarray):
    """Collapse duplicate (traceID, spanID) runs with combine semantics.

    order: all tile rows in sorted key order; keep_sorted: aligned
    first-occurrence mask. Returns (merged batch, runs_combined).
    Reference: vparquet/compactor.go:76-127 (equal rows dedupe fast-path,
    differing rows reconstruct-and-combine).
    """
    n = len(order)
    if n == 0:
        return SpanBatch(dictionary=batch.dictionary), 0
    run_id = np.cumsum(keep_sorted) - 1
    n_runs = int(run_id[-1]) + 1
    counts = np.bincount(run_id, minlength=n_runs)
    if counts.max(initial=0) <= 1:
        # (keep_sorted is necessarily all-True in this branch: a False
        # would create a >=2-member run and fail the counts check above)
        if n == batch.num_spans and np.array_equal(
            order, np.arange(n, dtype=order.dtype)
        ):
            # already sorted, nothing dropped: skip the O(rows x cols)
            # gather entirely. Hits on every tile of a single-block
            # rewrite (level bumps, retention-driven rewrites); k-way
            # tiles with interleaved IDs take the gather below.
            return batch, 0
        return batch.select(order[keep_sorted]), 0

    rows = order
    if batch.num_attrs:
        nattr_all = np.bincount(batch.attrs["attr_span"], minlength=batch.num_spans)
    else:
        nattr_all = np.zeros(batch.num_spans, np.int64)
    nattr = nattr_all[rows]

    # which runs actually differ (payload or attr count)? Equal RF copies
    # are the overwhelmingly common case (reference fast-path: equal rows
    # dedupe without reconstruction, vparquet/compactor.go:85-95) — only
    # members of multi-runs are compared, and only differing runs pay for
    # survivor selection + attr union.
    starts = np.flatnonzero(keep_sorted)
    multi_pos = np.flatnonzero(counts[run_id] > 1)  # sorted-order positions
    m_rows = rows[multi_pos]
    m_first = rows[starts][run_id[multi_pos]]
    differs = nattr[multi_pos] != nattr_all[m_first]
    for name in _PAYLOAD_COLS:
        a, b = batch.cols[name][m_rows], batch.cols[name][m_first]
        d = (a != b)
        differs |= d.any(axis=1) if d.ndim > 1 else d
    if batch.num_attrs:
        # attr CONTENT can diverge even when counts match — compare
        # order-independent per-span attr fingerprints (xor of per-attr
        # mix hashes), so {k: "a"} vs {k: "b"} counts as a difference
        fp = _attr_fingerprint(batch)
        differs |= fp[m_rows] != fp[m_first]
    run_differs = np.zeros(n_runs, bool)
    np.logical_or.at(run_differs, run_id[multi_pos], differs)
    combined = int(run_differs.sum())
    if combined == 0:
        return batch.select(order[keep_sorted]), 0

    # survivor per run: member with max (duration, attr count); ties keep
    # the latest input row (deterministic; runs are contiguous in `order`)
    dur = batch.cols["duration_nano"][rows]
    lex = np.lexsort((np.arange(n), nattr, dur, run_id))
    surv_pos = lex[np.cumsum(counts) - 1]
    survivors = rows[np.sort(surv_pos)]  # preserve run (ID) order

    sel = batch.select(survivors)
    if batch.num_attrs:
        # union non-survivor members' attrs onto the survivor (new owner =
        # run index, since `sel` has one row per run in run order); only
        # runs that differ take part
        row_to_run = np.full(batch.num_spans, -1, np.int64)
        row_to_run[rows] = run_id
        is_surv = np.zeros(batch.num_spans, bool)
        is_surv[survivors] = True
        o = batch.attrs["attr_span"].astype(np.int64)
        take = (~is_surv[o]) & run_differs[row_to_run[o]]
        if take.any():
            extra = {k: v[take] for k, v in batch.attrs.items()}
            extra["attr_span"] = row_to_run[o[take]].astype(np.uint32)
            attrs = {
                k: np.concatenate([sel.attrs[k], extra[k]]) for k in ATTR_COLUMNS
            }
            attrs = _dedupe_attrs(attrs)
            sel = SpanBatch(cols=sel.cols, attrs=attrs, dictionary=sel.dictionary)
    return sel, combined


def _attr_fingerprint(batch: SpanBatch) -> np.ndarray:
    """Order-independent uint64 fingerprint of each span's attr multiset.

    Each attr row is mixed (splitmix64-style) over (scope, key, vtype,
    str, num-bits) and xor-folded into its owner span. Equal attr sets
    always collide (xor is commutative); unequal sets collide with
    ~2^-64 probability — acceptable for routing runs to the combine
    path, since a false "equal" only means keep-one of two copies.
    """
    a = batch.attrs
    # each field is spread by its own odd multiplier BEFORE combining, so
    # structurally related sets (key=256/str=0 vs key=0/str=1 under the
    # old shifted packing) cannot cancel; the splitmix finalizer then
    # mixes the combined word
    with np.errstate(over="ignore"):
        h = (
            a["attr_scope"].astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
            ^ a["attr_key"].astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
            ^ a["attr_vtype"].astype(np.uint64) * np.uint64(0x165667B19E3779F9)
            ^ a["attr_str"].astype(np.uint64) * np.uint64(0x27D4EB2F165667C5)
            ^ a["attr_num"].view(np.uint64) * np.uint64(0x2545F4914F6CDD1D)
        )
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = h ^ (h >> np.uint64(31))
    out = np.zeros(batch.num_spans, np.uint64)
    np.bitwise_xor.at(out, a["attr_span"], h)
    return out


def _dedupe_attrs(attrs: dict) -> dict:
    """Exact-duplicate attr rows collapse; result sorted by owner."""
    m = len(attrs["attr_span"])
    if m == 0:
        return attrs
    packed = np.empty((m, 6), np.uint64)
    packed[:, 0] = attrs["attr_span"]
    packed[:, 1] = attrs["attr_scope"]
    packed[:, 2] = attrs["attr_key"]
    packed[:, 3] = attrs["attr_vtype"]
    packed[:, 4] = attrs["attr_str"]
    packed[:, 5] = attrs["attr_num"].view(np.uint64)
    _, idx = np.unique(packed, axis=0, return_index=True)
    idx.sort()  # stable original order among unique rows
    out = {k: v[idx] for k, v in attrs.items()}
    order = np.argsort(out["attr_span"], kind="stable")
    return {k: v[order] for k, v in out.items()}


def _cap_spans_per_trace(batch: SpanBatch, cap: int) -> tuple[SpanBatch, int]:
    """Drop spans beyond `cap` per trace (reference: oversize traces are
    truncated + counted during compaction, vparquet/compactor.go:96-111)."""
    _, seg = batch.trace_boundaries()
    # rank of each span within its trace
    idx = np.arange(batch.num_spans)
    n_seg = int(seg.max()) + 1 if len(seg) else 0
    first_of_seg = np.full(n_seg, batch.num_spans, dtype=np.int64)
    np.minimum.at(first_of_seg, seg, idx)
    rank = idx - first_of_seg[seg]
    keep = rank < cap
    dropped = int((~keep).sum())
    if dropped == 0:
        return batch, 0
    return batch.select(np.flatnonzero(keep)), dropped
