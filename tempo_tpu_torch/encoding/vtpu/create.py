"""Block writer: trace-sorted span batches -> a complete vtpu1 block.

Port of tempo_tpu/encoding/vtpu/create.py (BlockWriter, write_block,
DeviceSketchAccumulator, _sketch_step). Reference analog:
tempodb/encoding/vparquet/create.go (streamingBlock: append rows, flush
row groups by size, bloom from IDs, meta last).

The block's sketch plane runs on the resolved device: the sharded
bloom filter (ops.bloom.build) and the HLL distinct estimate
(ops.sketch.hll_update, hll_estimate), fetched with one device-to-host
copy. Pages, zone maps, step partials, index and dictionary are host
code, byte-identical to the reference's.

Write order matters for crash safety: data pages are appended first,
then bloom/index/dict, then meta.json LAST — a block without meta is
invisible and gets garbage-collected, like the reference's write path
(tempodb/tempodb.go WriteBlock).
"""

from __future__ import annotations

import numpy as np
import torch

from tempo_tpu_torch import device as _device
from tempo_tpu_torch.backend.base import (
    BlockMeta,
    ColumnIndexName,
    DataName,
    DictionaryName,
    TypedBackend,
    bloom_name,
)
from tempo_tpu_torch.encoding.common import BlockConfig
from tempo_tpu_torch.encoding.vtpu import codec as codec_mod
from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.ops import bloom, sketch
from tempo_tpu_torch.standing import rules as sp_rules
from tempo_tpu_torch.util.devicetiming import count_transfer


def _ids_to_device(ids: np.ndarray, device: torch.device) -> torch.Tensor:
    """(N, 4) uint32 trace-ID limbs -> an int32 tensor on `device` (the
    hashes read the limbs back as uint32), 16 bytes an ID."""
    return torch.from_numpy(np.ascontiguousarray(ids, np.uint32).view(np.int32)).to(device)


def _pack_sketch(words: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """Bloom words + the float32 estimate's bits as one flat int32 tensor,
    so the host fetches both with a single copy (the reference's layout:
    words, then the bitcast estimate)."""
    return torch.cat([words.reshape(-1).to(torch.int32), est.reshape(1).view(torch.int32)])


def _unpack_sketch(packed: np.ndarray, plan: "bloom.BloomPlan") -> tuple[np.ndarray, int]:
    """Split the one-fetch packed u32 array back into bloom shard words
    + the bitcast HLL distinct estimate (stored as int(float32), as the
    reference stores it)."""
    words = packed[:-1].reshape(plan.n_shards, -1)
    est = int(float(packed[-1:].view(np.float32)[0]))
    return words, est


def _sketch_step(ids: torch.Tensor, plan: "bloom.BloomPlan", hp: "sketch.HLLPlan"):
    """Bloom words + HLL estimate of one block's unique trace IDs, on the
    IDs' device: (words (n_shards, words_per_shard), est 0-d float32)."""
    words = bloom.build(ids, plan)
    regs = sketch.hll_update(sketch.hll_init(hp, ids.device), ids, hp)
    return words, sketch.hll_estimate(regs, hp)


class DeviceSketchAccumulator:
    """The block's sketch plane kept on the device across merged batches:
    bloom words and HLL registers live on `device` and every update folds
    into them in place (the counterpart of the reference's donated
    buffers). Buffered IDs ship every _FLUSH_IDS traces, so the launches
    overlap the host's column encode; finish() synchronises the device
    and copies the words and the estimate to the host once. Updates may
    run on another thread than finish() (the compactor's producer), on
    the same device and the default stream.

    The bloom plan is sized from the bucketed SUM of input object counts
    — an upper bound on output traces, since compaction only dedupes —
    as in the reference (overshoot only lowers the FP rate below budget;
    the reference also sizes its sharded bloom from an object-count
    estimate, tempodb/encoding/common/bloom.go:20-90).

    Runs on CUDA unless device="cpu"; raises without CUDA.
    """

    # ids buffered host-side until one launch is worth its fixed cost
    # (merged batches carry ~1k traces each)
    _FLUSH_IDS = 8192

    def __init__(self, cfg: BlockConfig, est_traces: int, device=None):
        self.device = _device.resolve(device)
        self.plan = bloom.plan(
            cfg.bucket_for(max(1, est_traces)), cfg.bloom_fp, cfg.bloom_shard_size_bytes
        )
        self.hp = sketch.HLLPlan(cfg.hll_precision)
        self._words = torch.zeros((self.plan.n_shards, self.plan.words_per_shard),
                                  dtype=torch.int64, device=self.device)
        self._regs = sketch.hll_init(self.hp, self.device)
        self._pending: list[np.ndarray] = []
        self._n_pending = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.launches = 0  # flushes that reached the device

    def update(self, batch: SpanBatch) -> None:
        if batch.num_spans == 0:
            return
        firsts, _ = batch.trace_boundaries()
        self.update_ids(batch.cols["trace_id"][firsts])

    def update_ids(self, ids: np.ndarray) -> None:
        """Feed unique trace-ID limbs directly — the zero-decode
        relocation path has the decoded ID column but never builds a
        SpanBatch (bloom OR / HLL max are idempotent, so IDs repeated
        across updates cannot skew the sketches)."""
        if len(ids) == 0:
            return
        self._pending.append(ids)
        self._n_pending += len(ids)
        if self._n_pending >= self._FLUSH_IDS:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        ids = self._pending[0] if len(self._pending) == 1 else np.concatenate(self._pending)
        self._pending, self._n_pending = [], 0
        d_ids = _ids_to_device(ids, self.device)
        self.h2d_bytes += d_ids.numel() * 4
        count_transfer("sketch_accumulate", h2d=d_ids.numel() * 4)
        # no sync: the kernels queue on the device while the host goes
        # back to encoding columns
        self._words |= bloom.build(d_ids, self.plan)
        self._regs.copy_(sketch.hll_update(self._regs, d_ids, self.hp))
        self.launches += 1

    def finish(self) -> dict:
        self._flush()
        packed_d = _pack_sketch(self._words, sketch.hll_estimate(self._regs, self.hp))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        packed = packed_d.cpu().numpy().view(np.uint32)
        # the one device-to-host copy of the whole accumulation
        self.d2h_bytes += packed.nbytes
        count_transfer("sketch_finish", d2h=packed.nbytes)
        words, est = _unpack_sketch(packed, self.plan)
        return {"bloom_plan": self.plan, "bloom_words": words, "est_distinct": est}


class BlockWriter:
    """Incremental block writer: append encoded row groups (from
    SpanBatches) AND relocated row groups (raw compressed pages moved
    verbatim from an input block), then finish() writes bloom/index/
    dict/meta in the crash-safe order.

    This is write_block() split open so the compactor's zero-decode fast
    path can interleave the two append kinds in global trace-ID order;
    write_block() below remains the one-shot wrapper every other caller
    uses. Counters (pages_copied_verbatim / pages_reencoded and their
    byte twins) make the copy-vs-encode split observable in bench
    artifacts and compaction metrics. Without `sketches`, finish() builds
    the bloom and HLL on `device`: CUDA unless device="cpu", and it
    raises without CUDA.
    """

    def __init__(self, tenant: str, backend: TypedBackend, cfg: BlockConfig,
                 block_id: str | None = None, compaction_level: int = 0,
                 dictionary=None, collect_ids: bool = False, device=None):
        self.device = _device.resolve(device)
        self.backend = backend
        self.cfg = cfg
        self.meta = BlockMeta(tenant_id=tenant, version=cfg.version,
                              compaction_level=compaction_level)
        if block_id:
            self.meta.block_id = block_id
        self.index = fmt.BlockIndex()
        self.offset = 0
        self.dictionary = dictionary
        self.collect_ids = collect_ids
        self._unique_ids: list[np.ndarray] = []
        self._n_traces = 0
        self._n_spans = 0
        self._start_s: int | None = None
        self._end_s = 0
        self._min_id: str | None = None
        self._max_id: str | None = None
        # copy-vs-encode accounting
        self.pages_copied_verbatim = 0
        self.pages_reencoded = 0
        self.bytes_copied_verbatim = 0
        self.bytes_reencoded = 0
        self.row_groups_relocated = 0
        # step-partial downsampling tier (standing/rules.py): rules this
        # writer materializes per row group; () disables
        self.step_rules = sp_rules.block_rules(cfg)

    # ------------------------------------------------------------------
    def _add_rg(self, rg: fmt.RowGroupMeta) -> None:
        self.index.row_groups.append(rg)
        self._n_spans += rg.n_spans
        self._start_s = rg.start_s if self._start_s is None else min(self._start_s, rg.start_s)
        self._end_s = max(self._end_s, rg.end_s)
        self._min_id = rg.min_id if self._min_id is None else min(self._min_id, rg.min_id)
        self._max_id = rg.max_id if self._max_id is None else max(self._max_id, rg.max_id)

    def append_batch(self, batch: SpanBatch) -> None:
        """Encode a trace-sorted SpanBatch as one or more row groups."""
        if batch.num_spans == 0:
            return
        if self.dictionary is None:
            self.dictionary = batch.dictionary
        elif batch.dictionary is not self.dictionary:
            raise ValueError("all batches of one block must share a dictionary")
        firsts, _ = batch.trace_boundaries()
        self._n_traces += len(firsts)
        if self.collect_ids:
            self._unique_ids.append(batch.cols["trace_id"][firsts])
        partials = self._batch_partials(batch)
        for lo, hi in fmt.row_group_slices(batch, self.cfg.row_group_spans):
            payload, rg = fmt.serialize_row_group(batch, lo, hi, self.offset, self.cfg.codec)
            self.backend.append_named(self.meta, DataName, payload)
            self.offset += len(payload)
            self.pages_reencoded += len(rg.pages)
            self.bytes_reencoded += len(payload)
            self._write_partials(rg, partials, lo, hi)
            self._add_rg(rg)

    def _batch_partials(self, batch) -> list:
        """Per-row (series, abs-bin, bucket) decomposition of the batch
        under every configured downsampling rule — computed once per
        batch, sliced per row group. A rule that can't describe this
        batch exactly (series over ceiling, wild timestamps) yields no
        partial: readers fall back to the span path, never a wrong one."""
        out = []
        for rule in self.step_rules:
            try:
                bp = sp_rules.batch_partial(batch, self.dictionary, rule)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "step-partial rule %s skipped for this batch", rule.name)
                bp = None
            if bp is not None:
                out.append(bp)
        return out

    def _write_partials(self, rg: fmt.RowGroupMeta, partials: list,
                        lo: int, hi: int) -> None:
        """Append this row group's step-partial tables as ordinary pages
        right after its column pages (contiguous, so relocation's single
        ranged read and the coalesced span reads both cover them)."""
        for bp in partials:
            table = bp.rg_table(lo, hi)
            if table is None:
                continue
            keys, arr = table
            page, crc = codec_mod.encode(arr, codec_mod.resolve_codec(self.cfg.codec))
            name = sp_rules.page_name(bp.rule.name)
            rg.pages[name] = fmt.PageMeta(
                offset=self.offset, length=len(page), dtype=arr.dtype.str,
                shape=tuple(arr.shape), codec=codec_mod.resolve_codec(self.cfg.codec),
                crc=crc,
            )
            rg.partials[bp.rule.name] = sp_rules.partial_meta(bp.rule, keys)
            self.backend.append_named(self.meta, DataName, page)
            self.offset += len(page)
            self.pages_reencoded += 1
            self.bytes_reencoded += len(page)

    def append_relocated(self, rg: fmt.RowGroupMeta, raw_pages: dict,
                         reencode: dict, min_id: str, max_id: str,
                         n_traces: int, decoded: dict | None = None) -> None:
        """Relocate one input row group: copy its compressed pages
        verbatim — per-page crc/dtype/shape/codec preserved, nothing
        recomputed but the page-index offsets — re-encoding only the
        columns in `reencode` (dictionary-coded columns under a
        non-identity remap: the lazy column gather).

        raw_pages: column -> compressed page bytes from the source block
        (fmt.read_row_group_pages). min_id/max_id/n_traces come from the
        decoded trace-ID column the relocation guard already paid for,
        so stale input index metadata cannot propagate.

        Zone maps: remapped columns recompute stats from the remapped
        arrays (input code sets are in the OLD dictionary's code space —
        copying them would make pruning unsound); verbatim columns copy
        the input stats when present, else decode from the page bytes
        already in hand (legacy stats-less inputs gain zone maps on
        their first compaction; no extra backend read either way).

        Lightweight-encoding upgrade, same economics as the zone-map
        back-fill: columns whose arrays are ALREADY decoded — remapped
        columns, stats back-fills, and `decoded` (arrays the caller paid
        for anyway, e.g. the relocation guard's trace-ID column) — are
        re-encoded when the write-time chooser picks a lightweight codec
        their current page lacks. Pages that are not in hand decoded
        stay verbatim: the zero-decode fast path never decodes a page
        just to change its codec.
        """
        reencode = dict(reencode)
        stat_arrays: dict = {}
        copied_stats: dict = {}
        upgradable: dict = dict(decoded or {})
        for name in fmt.STATS_NUMERIC + fmt.STATS_CODES:
            if name not in rg.pages:
                continue
            arr = reencode.get(name)
            if arr is not None:
                stat_arrays[name] = arr
            elif name in rg.stats:
                copied_stats[name] = rg.stats[name]
            else:
                stat_arrays[name] = fmt.decode_page(raw_pages[name], rg.pages[name])
                upgradable[name] = stat_arrays[name]
        if rg.stats.get("root_first"):
            # sound to copy: relocation preserves row order and neither
            # the trace grouping nor the (non-dictionary) parent ids
            # change under a remap
            copied_stats["root_first"] = True
        elif not rg.stats:
            # fully-legacy input (no stats at all): back-fill root_first
            # from the pages in hand, like every other stat — the ID
            # column is usually already decoded (the relocation guard),
            # only the parent page pays a one-time decode here
            tid = upgradable.get("trace_id")
            if tid is None and "trace_id" in rg.pages:
                tid = fmt.decode_page(raw_pages["trace_id"], rg.pages["trace_id"])
            if tid is not None and "parent_span_id" in rg.pages:
                stat_arrays["trace_id"] = tid
                stat_arrays["parent_span_id"] = fmt.decode_page(
                    raw_pages["parent_span_id"], rg.pages["parent_span_id"])
        stats = {**fmt.compute_stats(stat_arrays), **copied_stats}

        chosen_codecs: dict[str, str] = {}
        for name, arr in upgradable.items():
            if name in reencode or name not in rg.pages:
                continue
            if rg.pages[name].codec in codec_mod.LIGHTWEIGHT_CODECS:
                continue  # already on the lightweight tier: copy verbatim
            chosen = codec_mod.choose_codec(name, arr, self.cfg.codec)
            if chosen in codec_mod.LIGHTWEIGHT_CODECS:
                reencode[name] = arr
                chosen_codecs[name] = chosen  # don't re-run the probe below

        payload = bytearray()
        pages: dict[str, fmt.PageMeta] = {}
        for name, pm in rg.pages.items():
            arr = reencode.get(name)
            if arr is not None:
                chosen = chosen_codecs.get(name) or codec_mod.choose_codec(
                    name, arr, self.cfg.codec)
                page, crc = codec_mod.encode(arr, chosen)
                pages[name] = fmt.PageMeta(
                    offset=self.offset + len(payload), length=len(page),
                    dtype=arr.dtype.str, shape=tuple(arr.shape),
                    codec=chosen, crc=crc,
                )
                self.pages_reencoded += 1
                self.bytes_reencoded += len(page)
            else:
                page = raw_pages[name]
                pages[name] = fmt.PageMeta(
                    offset=self.offset + len(payload), length=pm.length,
                    dtype=pm.dtype, shape=pm.shape, codec=pm.codec, crc=pm.crc,
                )
                self.pages_copied_verbatim += 1
                self.bytes_copied_verbatim += len(page)
            payload.extend(page)
        self.backend.append_named(self.meta, DataName, bytes(payload))
        self.offset += len(payload)
        self._n_traces += n_traces
        self.row_groups_relocated += 1
        self._add_rg(fmt.RowGroupMeta(
            n_spans=rg.n_spans, n_attrs=rg.n_attrs, min_id=min_id,
            max_id=max_id, start_s=rg.start_s, end_s=rg.end_s,
            n_traces=n_traces, pages=pages, stats=stats,
            # step partials relocate with their rows: series keys are
            # strings (dictionary-independent), the count page moved
            # verbatim above, and relocation never drops/dedupes spans —
            # so the copied tables still describe exactly these rows
            partials=dict(rg.partials),
        ))

    # ------------------------------------------------------------------
    def finish(self, sketches=None) -> BlockMeta | None:
        """Write bloom/index/dictionary/meta (meta LAST: a block without
        meta is invisible and gets garbage-collected). sketches:
        zero-arg callable yielding device-accumulated block sketches;
        without it the writer builds them from the trace IDs collected
        by append_batch (requires collect_ids=True)."""
        if self._n_traces == 0:
            return None
        meta, cfg, backend = self.meta, self.cfg, self.backend
        if sketches is not None:
            # index + dictionary writes first: when the device is still
            # draining async sketch updates (large jobs), every host-side
            # byte written here is overlap for free
            backend.write_named(meta, ColumnIndexName, self.index.to_bytes())
            backend.write_named(meta, DictionaryName, fmt.serialize_dictionary(self.dictionary))
            sk = sketches()
            plan = sk["bloom_plan"]
            words = np.asarray(sk["bloom_words"])
            est = int(sk["est_distinct"])
        else:
            ids = np.concatenate(self._unique_ids)
            # the bloom plan is sized from the bucketed ID count, as the
            # reference sizes it (its bucket bounds the XLA shapes); the
            # slightly larger plan only lowers the FP rate below budget
            plan = bloom.plan(cfg.bucket_for(len(ids)), cfg.bloom_fp,
                              cfg.bloom_shard_size_bytes)
            hp = sketch.HLLPlan(cfg.hll_precision)
            d_ids = _ids_to_device(ids, self.device)
            count_transfer("block_sketch", h2d=d_ids.numel() * 4)
            # the launches queue while the host writes index + dictionary;
            # then ONE copy fetches the words and the estimate
            packed_d = _pack_sketch(*_sketch_step(d_ids, plan, hp))
            backend.write_named(meta, ColumnIndexName, self.index.to_bytes())
            backend.write_named(meta, DictionaryName, fmt.serialize_dictionary(self.dictionary))
            packed = packed_d.cpu().numpy().view(np.uint32)
            count_transfer("block_sketch", d2h=packed.nbytes)
            words, est = _unpack_sketch(packed, plan)
        for s in range(plan.n_shards):
            backend.write_named(meta, bloom_name(s), bloom.shard_to_bytes(words[s]))

        meta.start_time = int(self._start_s or 0)
        meta.end_time = int(self._end_s)
        meta.total_objects = int(self._n_traces)
        meta.total_spans = int(self._n_spans)
        meta.size_bytes = self.offset
        meta.min_id = self._min_id
        meta.max_id = self._max_id
        meta.total_records = len(self.index.row_groups)
        meta.bloom_shards = plan.n_shards
        meta.bloom_bits_per_shard = plan.bits_per_shard
        meta.bloom_k = plan.k
        meta.hll_precision = cfg.hll_precision
        meta.est_distinct_traces = est
        backend.write_block_meta(meta)  # last: makes the block visible
        return meta


def write_block(
    batches,
    tenant: str,
    backend: TypedBackend,
    cfg: BlockConfig,
    block_id: str | None = None,
    compaction_level: int = 0,
    sketches=None,
    device=None,
) -> BlockMeta | None:
    """Write one block from an iterable of trace-sorted SpanBatches in
    nondecreasing trace order (a single batch is the common case; the
    compactor streams several). Returns None for empty input.

    sketches: optional zero-arg callable yielding block-level sketches
    already computed on device (the sharded compactor's psum/pmax-merged
    bloom/HLL accumulated per tile) — called after all batches are
    consumed. When given, trace IDs are only counted, never retained, so
    peak memory stays bounded by one batch.

    device: where the block's bloom and HLL are built when `sketches` is
    None — CUDA unless "cpu" is passed; raises without CUDA.
    """
    w = BlockWriter(tenant, backend, cfg, block_id=block_id,
                    compaction_level=compaction_level,
                    collect_ids=(sketches is None), device=device)
    for batch in batches:
        w.append_batch(batch)
    return w.finish(sketches=sketches)
