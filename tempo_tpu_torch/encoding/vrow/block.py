"""Port of tempo_tpu/encoding/vrow/block.py. The writer and the
compactor take the `device` their bloom and HLL run on (CUDA unless
"cpu" is passed: the bloom's torch ops and the hll_update kernel on the
card, their plain versions on the CPU), as vtpu1's do; each trace's
record is cut from the sorted batch by slices (format.trace_records),
with the reference's bytes.

vrow1 block writer, backend block, and compactor.

Reference: tempodb/encoding/v2 — streaming_block.go (page-buffered
writer), finder_paged.go (bloom -> index binary search -> page read),
iterator_multiblock.go + compactor.go (k-way bookmark merge by ID,
dedupe/combine), plus the common sharded bloom. TraceQL Fetch is
unsupported on this encoding, exactly like v2 in the reference snapshot
(only the columnar encoding implements Fetch).
"""

from __future__ import annotations

import heapq

import numpy as np

from tempo_tpu_torch import device as _device
from tempo_tpu_torch.backend.base import (
    BlockMeta,
    ColumnIndexName,
    DataName,
    TypedBackend,
    bloom_name,
)
from tempo_tpu_torch.encoding.common import (
    BlockConfig,
    CompactionOptions,
    SearchRequest,
    SearchResponse,
)
from tempo_tpu_torch.encoding.vrow import format as rfmt
from tempo_tpu_torch.encoding.vtpu import format as vfmt
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.model.trace import Trace, batch_to_traces, combine_traces
from tempo_tpu_torch.ops import bloom, sketch
from tempo_tpu_torch.util import usage
from tempo_tpu_torch.encoding.vtpu.block import inspected_bytes_total
from tempo_tpu_torch.encoding.vtpu.create import (
    _ids_to_device,
    _pack_sketch,
    _sketch_step,
    _unpack_sketch,
)


class TraceQLUnsupported(NotImplementedError):
    """Reference parity: v2 blocks do not implement TraceQL Fetch."""


# -- writer --------------------------------------------------------------
def write_block(
    batches,
    tenant: str,
    backend: TypedBackend,
    cfg: BlockConfig,
    block_id: str | None = None,
    compaction_level: int = 0,
    page_target_bytes: int = 256 * 1024,
    device=None,
) -> BlockMeta | None:
    """Stream trace-sorted batches into pages + downsampled index; the
    bloom and HLL are built on `device` (CUDA unless "cpu"; raises
    without CUDA)."""
    dev = _device.resolve(device)
    meta = BlockMeta(tenant_id=tenant, version="vrow1", compaction_level=compaction_level)
    if block_id:
        meta.block_id = block_id

    writer = _PageWriter(meta, backend, page_target_bytes)
    ids = []
    for batch in batches:
        if batch.num_spans == 0:
            continue
        firsts, _ = batch.trace_boundaries()
        bounds = [int(x) for x in firsts] + [batch.num_spans]
        starts = batch.cols["start_unix_nano"]
        ends = starts + batch.cols["duration_nano"]
        records = rfmt.trace_records(batch, bounds)
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            tid, record = next(records)
            t0 = int(starts[lo:hi].min()) // 10**9
            t1 = int(ends[lo:hi].max()) // 10**9
            writer.add(tid, record, t0, t1)
            writer.n_spans += hi - lo
            ids.append(batch.cols["trace_id"][lo])
    if not ids:
        return None
    writer.flush()

    id_arr = np.stack(ids)
    plan = bloom.plan(len(id_arr), cfg.bloom_fp, cfg.bloom_shard_size_bytes)
    hp = sketch.HLLPlan(cfg.hll_precision)
    # bloom words and the estimate come home in one copy
    packed = _pack_sketch(*_sketch_step(_ids_to_device(id_arr, dev), plan, hp))
    words, est = _unpack_sketch(packed.cpu().numpy().view(np.uint32), plan)
    for s in range(plan.n_shards):
        backend.write_named(meta, bloom_name(s), bloom.shard_to_bytes(words[s]))

    backend.write_named(meta, ColumnIndexName, writer.index.to_bytes())

    meta.start_time = writer.start_s
    meta.end_time = writer.end_s
    meta.total_objects = len(id_arr)
    meta.total_spans = writer.n_spans
    meta.size_bytes = writer.offset
    meta.min_id = min(p.min_id for p in writer.index.pages)
    meta.max_id = max(p.max_id for p in writer.index.pages)
    meta.total_records = len(writer.index.pages)
    meta.bloom_shards = plan.n_shards
    meta.bloom_bits_per_shard = plan.bits_per_shard
    meta.bloom_k = plan.k
    meta.hll_precision = cfg.hll_precision
    meta.est_distinct_traces = est
    backend.write_block_meta(meta)  # last
    return meta


class _PageWriter:
    def __init__(self, meta: BlockMeta, backend: TypedBackend, target: int):
        self.meta = meta
        self.backend = backend
        self.target = target
        self.index = rfmt.PageIndex()
        self.offset = 0
        self.n_spans = 0
        self.start_s = None
        self.end_s = 0
        self._records: list[bytes] = []
        self._ids: list[str] = []
        self._t0 = None
        self._t1 = 0
        self._size = 0

    def add(self, tid: bytes, record: bytes, t0: int, t1: int) -> None:
        self._records.append(record)
        self._ids.append(tid.hex())
        self._size += len(record)
        self._t0 = t0 if self._t0 is None else min(self._t0, t0)
        self._t1 = max(self._t1, t1)
        self.start_s = t0 if self.start_s is None else min(self.start_s, t0)
        self.end_s = max(self.end_s, t1)
        if self._size >= self.target:
            self.flush()

    def flush(self) -> None:
        if not self._records:
            return
        page = rfmt.encode_page(self._records)
        self.backend.append_named(self.meta, DataName, page)
        self.index.pages.append(
            rfmt.PageEntry(
                min_id=min(self._ids),
                max_id=max(self._ids),
                offset=self.offset,
                length=len(page),
                n_records=len(self._records),
                start_s=self._t0 or 0,
                end_s=self._t1,
            )
        )
        self.offset += len(page)
        self._records, self._ids = [], []
        self._size, self._t0, self._t1 = 0, None, 0


# -- backend block -------------------------------------------------------
class VrowBackendBlock:
    def __init__(self, meta: BlockMeta, backend: TypedBackend, cfg: BlockConfig | None = None):
        self.meta = meta
        self.backend = backend
        self.cfg = cfg or BlockConfig()
        self._index = None
        self.bytes_read = 0

    def _account_inspected(self, nbytes: int) -> None:
        usage.account_bytes(inspected_bytes_total, "inspected_bytes",
                            self.meta.tenant_id, nbytes, round_trip=True)

    def index(self) -> rfmt.PageIndex:
        if self._index is None:
            raw = self.backend.read_named(self.meta.tenant_id, self.meta.block_id, ColumnIndexName)
            self.bytes_read += len(raw)
            self._account_inspected(len(raw))
            self._index = rfmt.PageIndex.from_bytes(raw)
        return self._index

    def _read_page(self, entry: rfmt.PageEntry) -> bytes:
        buf = self.backend.read_range_named(
            self.meta.tenant_id, self.meta.block_id, DataName, entry.offset, entry.length
        )
        self.bytes_read += len(buf)
        self._account_inspected(len(buf))
        usage.charge("pages_fetched")
        return rfmt.decode_page(buf)

    def bloom_plan(self) -> bloom.BloomPlan:
        return bloom.BloomPlan(
            n_shards=self.meta.bloom_shards,
            bits_per_shard=self.meta.bloom_bits_per_shard,
            k=self.meta.bloom_k,
        )

    def _bloom_test(self, trace_id: bytes) -> bool:
        p = self.bloom_plan()
        limbs = np.frombuffer(trace_id.rjust(16, b"\x00")[-16:], dtype=">u4").astype(np.uint32)
        shard = int(bloom.shard_for_ids(limbs[None, :], p)[0])
        raw = self.backend.read_named(self.meta.tenant_id, self.meta.block_id, bloom_name(shard))
        self.bytes_read += len(raw)
        self._account_inspected(len(raw))
        words = bloom.shard_from_bytes(raw)
        return bool(bloom.np_test_one_shard(words, limbs[None, :], p)[0])

    def find_trace_by_id(self, trace_id: bytes) -> Trace | None:
        hex_id = trace_id.hex().rjust(32, "0")
        if hex_id < self.meta.min_id or hex_id > self.meta.max_id:
            return None
        if not self._bloom_test(trace_id):
            return None
        parts = []
        idx = self.index()
        for pi in idx.find_pages(hex_id):
            raw = self._read_page(idx.pages[pi])
            for tid, payload in rfmt.iter_records(raw):
                if tid.hex() == hex_id:
                    parts.extend(batch_to_traces(rfmt.decode_record_payload(payload)))
        return combine_traces(parts)

    def _iter_page_batches(self, start_page: int = 0, n_pages: int = 0,
                           start_s: int = 0, end_s: int = 0):
        idx = self.index()
        end = (start_page + n_pages) if n_pages else len(idx.pages)
        for entry in idx.pages[start_page:end]:
            if start_s and entry.end_s < start_s:
                continue
            if end_s and entry.start_s > end_s:
                continue
            raw = self._read_page(entry)
            for _, payload in rfmt.iter_records(raw):
                yield rfmt.decode_record_payload(payload)

    def search(self, req: SearchRequest, start_row_group: int = 0,
               row_groups: int = 0) -> SearchResponse:
        """Full record scan with tag filters — the v2 way: decode pages,
        match, early-exit at limit (reference: v2 searches pages via the
        flatbuffer sidecar; here records are columnar segments so the
        live-batch matcher applies directly)."""
        from tempo_tpu_torch.modules.querier import _search_batch

        resp = SearchResponse(inspected_blocks=1)
        before = self.bytes_read
        for batch in self._iter_page_batches(
            start_row_group, row_groups, req.start_seconds, req.end_seconds
        ):
            resp.inspected_traces += 1
            resp.merge(_search_batch(batch, req), limit=req.limit)
            if req.limit and len(resp.traces) >= req.limit:
                break
        resp.inspected_bytes = self.bytes_read - before
        return resp

    def fetch_candidates(self, spec, start_s: int = 0, end_s: int = 0,
                         max_traces: int = 0):
        raise TraceQLUnsupported(
            "vrow1 blocks do not support TraceQL fetch (reference parity: "
            "tempodb/encoding/v2 has no Fetch; use vtpu1 blocks)"
        )

    def collect_spans_for_ids(self, hex_ids: set) -> list:
        out = []
        idx = self.index()
        lo, hi = min(hex_ids), max(hex_ids)
        if hi < self.meta.min_id or lo > self.meta.max_id:
            return []
        for entry in idx.pages:
            if entry.max_id < lo or entry.min_id > hi:
                continue
            raw = self._read_page(entry)
            for tid, payload in rfmt.iter_records(raw):
                if tid.hex() in hex_ids:
                    out.extend(batch_to_traces(rfmt.decode_record_payload(payload)))
        return out

    def iter_trace_batches(self):
        """All spans, one SpanBatch per page record stream — the
        block-convert read surface (mirrors VtpuBackendBlock's)."""
        yield from self._iter_page_batches()

    def iter_records_raw(self):
        """(hex_id, record_payload) stream in ID order, for compaction."""
        idx = self.index()
        for entry in idx.pages:
            raw = self._read_page(entry)
            for tid, payload in rfmt.iter_records(raw):
                yield tid.hex(), tid, payload


# -- compactor -----------------------------------------------------------
class VrowCompactor:
    """K-way bookmark merge by trace ID (reference: v2 compactor.go:19 +
    iterator_multiblock.go:19): equal IDs are combined span-level, the
    merged stream is re-paged into one output block."""

    def __init__(self, opts: CompactionOptions | None = None, device=None):
        self.opts = opts or CompactionOptions()
        self.device = device

    def compact(self, metas: list[BlockMeta], tenant: str, backend: TypedBackend) -> list[BlockMeta]:
        cfg = BlockConfig(version="vrow1")
        blocks = [VrowBackendBlock(m, backend) for m in metas]
        iters = [b.iter_records_raw() for b in blocks]

        def merged():
            heap = []
            for i, it in enumerate(iters):
                first = next(it, None)
                if first:
                    heapq.heappush(heap, (first[0], i, first[1], first[2]))
            while heap:
                hex_id, i, tid, payload = heapq.heappop(heap)
                group = [payload]
                nxt = next(iters[i], None)
                if nxt:
                    heapq.heappush(heap, (nxt[0], i, nxt[1], nxt[2]))
                while heap and heap[0][0] == hex_id:
                    _, j, _, p2 = heapq.heappop(heap)
                    group.append(p2)
                    nxt = next(iters[j], None)
                    if nxt:
                        heapq.heappush(heap, (nxt[0], j, nxt[1], nxt[2]))
                yield tid, group

        def batches():
            for tid, group in merged():
                if len(group) == 1:
                    batch = rfmt.decode_record_payload(group[0])
                else:
                    # combine: span-level dedupe across duplicate records
                    traces = []
                    for p in group:
                        traces.extend(batch_to_traces(rfmt.decode_record_payload(p)))
                    combined = combine_traces(traces)
                    from tempo_tpu_torch.model.trace import traces_to_batch

                    batch = traces_to_batch([combined]).sorted_by_trace()
                yield batch

        level = max((m.compaction_level for m in metas), default=0) + 1
        out = write_block(batches(), tenant, backend, cfg, compaction_level=level,
                          device=self.device)
        return [out] if out else []
