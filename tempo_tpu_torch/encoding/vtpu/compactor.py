"""Block compactor: k blocks -> 1 block, streamed through bounded tiles.

Port of tempo_tpu/encoding/vtpu/compactor.py on one device: compact()
with the zero-decode fast path, the block streams, tile production, the
emit stage, the three merge planners and the combine semantics. The
mesh-sharded tile merger and the device payload plane arrive with the
multi-GPU slice (a mesh or payload_plane="device" raises
NotImplementedError).

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
- **Sketch plane**: every merged batch's trace IDs feed a
  DeviceSketchAccumulator on the compactor's device (bloom OR, HLL max),
  fetched once at the end.
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
from tempo_tpu_torch.ops import merge
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
    """Compacts blocks on one device: the sketch plane (and, with
    merge_path="device", the merge plan) runs on `device` — CUDA unless
    device="cpu" is passed; raises without CUDA. Output blocks are
    byte-identical whichever device runs them."""

    def __init__(self, opts: CompactionOptions | None = None, device=None):
        self.opts = opts or CompactionOptions()
        if self.opts.mesh is not None or self.opts.payload_plane != "host":
            raise NotImplementedError(
                "tempo_tpu_torch compacts on one device: mesh must be None and "
                "payload_plane 'host' until the multi-GPU slice")
        if self.opts.merge_path not in ("auto", "native", "device", "numpy"):
            raise ValueError(f"unknown merge_path {self.opts.merge_path!r}")
        self.device = _device.resolve(device)
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
        # single-device sketch plane: per-batch async device updates
        # overlap the host's column encode; one small D2H at the end
        sketcher = self.sketcher = DeviceSketchAccumulator(
            cfg, sum(m.total_objects for m in metas), device=self.device)

        # zero-decode fast path; max_spans_per_trace forces the decode
        # path (a relocated row group can't be capped)
        if self.opts.zero_decode and not self.opts.max_spans_per_trace:
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
        # merge runs on a producer thread, overlapped with the consumer's
        # encode+write (native codec drops the GIL). On a single-core
        # host the overlap is pure overhead (see pipeline.overlap_enabled)
        # and the generator runs inline.
        inner = self._stream_merge(streams, out_dict)
        gen = _sketch_tee(inner, sketcher)
        batches = prefetch_iter(gen, depth=2) if overlap_enabled() else gen
        writer = BlockWriter(tenant, backend, cfg, compaction_level=level,
                             device=self.device)
        try:
            for batch in batches:
                writer.append_batch(batch)
            out = writer.finish(sketches=sketcher.finish)
            self.pages_reencoded += writer.pages_reencoded
            self.bytes_reencoded += writer.bytes_reencoded
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
    def _stream_merge(self, streams, out_dict):
        """Generator of merged, trace-complete SpanBatches in ID order.

        Three stages: tile production (k-way boundary rounds), tile merge
        (host/native/device plan), and emit (row-group-sized cuts with
        trailing-trace holdback).
        """
        tiles = self._tile_stream(streams, out_dict)
        merged_iter = (
            self._merge_tile(tile, run_lengths) for tile, run_lengths in tiles
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
    def _merge_tile(self, tile: SpanBatch, run_lengths: list[int]) -> SpanBatch:
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
