"""Backend block reader: trace-by-ID lookup + tag search + column fetch.

Port of tempo_tpu/encoding/vtpu/block.py on the host: VtpuBackendBlock
(index, dictionary, coalesced column reads through the process-wide
decoded-column cache, find_trace_by_id, search, hits_for_mask,
fetch_candidates, iter_eval_views, tag_names/tag_values,
collect_spans_for_ids, scrub), EncodedColumn with its rle/dct/dbp arms
and its device-tier residency (`resident*`: a page the page-heat ledger
admits is scanned on the card by the resident kernels of ops/scan), the
page-heat touches of every query-path page access, the zone-map and
condition lowering and the Prometheus counter families.

Reference analogs: tempodb/encoding/vparquet/block_findtracebyid.go
(bloom shard test then ID-column probe) and block_search.go
(makePipelineWithRowGroups — well-known columns + attr k/v scans).

Read path economy, in pruning order (cheapest veto first):
1. dictionary resolution — a string absent from the block dictionary
   kills the whole block before any index/page IO;
2. zone maps — per-row-group column stats in the index
   (fmt.RowGroupMeta.stats: numeric min/max + dictionary-code presence
   sets) skip row groups with ZERO backend reads, the analog of
   vParquet pruning on parquet page statistics;
3. selectivity-ordered lazy evaluation — the predicate accepting the
   fewest dictionary codes reads its column first; the moment the span
   mask dies, no further column of that row group is fetched;
4. coalesced ranged reads — all pages needed together fetch as one
   gap-tolerant ranged read (pages of a row group are contiguous in
   data.bin), so a row group costs ~1-3 backend round trips, not one
   per page;
5. prefetch — the next surviving row group's first predicate column
   loads while the current group evaluates (util/pipeline.ReadAhead,
   auto-disabled on single-core hosts).

Predicate masks evaluate on the host (numpy over run/dictionary space
or decoded columns), as the reference's single-device search does,
except over pages resident in the device tier, which the resident
kernels scan on the card.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from tempo_tpu_torch.backend.base import (
    BlockMeta,
    ColumnIndexName,
    DataName,
    DictionaryName,
    TypedBackend,
    bloom_name,
)
from tempo_tpu_torch.encoding.common import (
    BlockConfig,
    SearchRequest,
    SearchResponse,
    TraceSearchMetadata,
)
from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.model.columnar import ATTR_COLUMNS, SPAN_COLUMNS, VT_STR, SpanBatch
from tempo_tpu_torch.model.trace import Trace, batch_to_traces
from tempo_tpu_torch.ops import bloom, hashing
from tempo_tpu_torch.util import metrics, stagetimings, usage

# columns needed to build TraceSearchMetadata for matching traces
_META_COLS = ["trace_id", "parent_span_id", "start_unix_nano", "duration_nano", "name", "service"]

# process-wide read-path counters (satellite of the per-response stats):
# /metrics exposes these so pruning behavior is observable without a
# bench run (reference: tempodb_* promauto counters)
pruned_row_groups_total = metrics.counter(
    "tempodb_search_pruned_row_groups_total",
    "Row groups skipped by zone-map pruning (zero backend reads)",
)
coalesced_reads_total = metrics.counter(
    "tempodb_search_coalesced_reads_total",
    "Backend round trips saved by coalescing page reads",
)
decoded_bytes_total = metrics.counter(
    "tempodb_decoded_bytes_total",
    "Column value bytes materialized into row space by decode work "
    "(run/dictionary-space reads count their encoded size; selective "
    "gathers count the rows/miniblocks touched)",
)
inspected_bytes_total = metrics.counter(
    "tempodb_inspected_bytes_total",
    "Bytes read from backend storage by block readers (index, "
    "dictionary, bloom, coalesced page ranges), by tenant",
)
# tenant series of the read counters evict with the usage accountant's
# idle-tenant GC (the readers touch() the accountant on every account),
# so a tenant-ID fuzzing querier can't grow /metrics forever
usage.register_tenant_family(inspected_bytes_total)
usage.register_tenant_family(decoded_bytes_total)


def runspace_enabled() -> bool:
    """Run-space evaluation kill switch (TEMPO_TPU_RUNSPACE=0): the
    bench's row-space A/B arm and the operator escape hatch. Off means
    every predicate/gather expands full columns, exactly the pre-tier
    read path; results are bit-identical either way."""
    return os.environ.get("TEMPO_TPU_RUNSPACE", "1").strip().lower() not in (
        "0", "false", "no",
    )


def zone_maps_enabled() -> bool:
    """Zone-map pruning kill switch (TEMPO_TPU_ZONEMAPS=0): the bench's
    A/B arm and the operator escape hatch if a block's stats are ever
    suspect."""
    return os.environ.get("TEMPO_TPU_ZONEMAPS", "1").strip().lower() not in (
        "0", "false", "no",
    )


def _stats_admit(rg: fmt.RowGroupMeta, col: str, values: np.ndarray) -> bool:
    """Can any of `values` (accepted codes / numeric values) occur in
    this row group's column, per its zone map? Absent stats admit
    everything — unknown never prunes."""
    s = rg.stats.get(col) if rg.stats else None
    if s is None:
        return True
    if col in fmt.STATS_NUMERIC:
        lo, hi = s
        v = values.astype(np.int64, copy=False)
        return bool(((v >= lo) & (v <= hi)).any())
    return bool(np.isin(values, np.asarray(s, np.uint32)).any())


def zone_prunes(rg: fmt.RowGroupMeta, preds, req: SearchRequest) -> bool:
    """True when the zone maps prove no span of this row group can match
    the resolved tag predicates. Only POSITIVE predicates consult
    presence sets (tag search is equality-only, so every span_eq entry
    is positive); attr-key presence is sound for attr predicates because
    a span without the attr row never matches them."""
    if not rg.stats:
        return False
    for col, codes in preds["span_eq"]:
        if not _stats_admit(rg, col, codes):
            return True
    if req.min_duration_ns or req.max_duration_ns:
        mm = rg.stats.get("duration_nano")
        if mm is not None:
            if req.min_duration_ns and mm[1] < req.min_duration_ns:
                return True
            if req.max_duration_ns and mm[0] > req.max_duration_ns:
                return True
    keys = rg.stats.get("attr_key")
    if keys is not None and preds["attr"]:
        for key_code, _val_codes in preds["attr"]:
            if int(key_code) not in keys:
                return True
    return False


def _duration_bounds(req) -> tuple[int, int]:
    """A search's inclusive duration range in ns."""
    return req.min_duration_ns or 0, req.max_duration_ns or ((1 << 64) - 1)


class EncodedColumn:
    """Predicate/gather access to ONE column page in its encoded space
    (lightweight tier only — encoding/vtpu/lightweight.py).

    eq/in_set/between evaluate per RUN (rle) or per page-DICTIONARY
    entry (dct) and the verdict expands as one bool per row: the values
    of unselected runs are never materialized. gather() reads only the
    requested rows (rle: run lookup; dct: bit windows; dbp: miniblocks).
    Every operation reports what it materialized to the owning block's
    decoded_bytes counter, so decodedBytes tracks the selectivity, not
    the row count.
    """

    def __init__(self, blk: "VtpuBackendBlock", rg, name: str):
        self.blk = blk
        self.rg = rg
        self.name = name
        self.pm = rg.pages[name]
        self.codec = self.pm.codec
        self.n = self.pm.shape[0] if self.pm.shape else 0

    # -- raw page bytes (cached process-wide; misses pay one ranged read)
    def _page(self) -> bytes:
        blk, pm = self.blk, self.pm
        cache = blk._colcache
        key = (blk.meta.block_id, self.name, pm.offset, "page")
        if cache is not None:
            hit = cache.get(key)
            if hit is not None:
                return hit.tobytes()
        page = blk._reader()(pm.offset, pm.length)
        if cache is not None:
            cache.put(key, np.frombuffer(page, np.uint8))
        return page

    def runs(self):
        """(values, lengths) of an rle page — the run-space read."""
        from tempo_tpu_torch.encoding.vtpu import lightweight as lw

        blk, pm = self.blk, self.pm
        cache = blk._colcache
        kv = (blk.meta.block_id, self.name, pm.offset, "runv")
        kl = (blk.meta.block_id, self.name, pm.offset, "runl")
        if cache is not None:
            values, lengths = cache.get(kv), cache.get(kl)
            if values is not None and lengths is not None:
                # a warm hit is STILL a re-ship: the host cache elides
                # IO+decode, not the h2d trip — exactly the signal the
                # page-heat ledger exists to surface
                blk._touch_pageheat(self.name, pm,
                                    values.nbytes + lengths.nbytes)
                return values, lengths
        values, lengths = lw.rle_decode_runs(self._page(), pm.dtype, pm.shape)
        blk._account_decoded(values.nbytes + lengths.nbytes)
        blk._touch_pageheat(self.name, pm, values.nbytes + lengths.nbytes)
        if cache is not None:
            cache.put(kv, values)
            cache.put(kl, lengths)
        return values, lengths

    def _dct_indices(self):
        from tempo_tpu_torch.encoding.vtpu import lightweight as lw

        blk, pm = self.blk, self.pm
        cache = blk._colcache
        kv = (blk.meta.block_id, self.name, pm.offset, "dctv")
        ki = (blk.meta.block_id, self.name, pm.offset, "dcti")
        if cache is not None:
            values, idx = cache.get(kv), cache.get(ki)
            if values is not None and idx is not None:
                w = max(values.shape[0] - 1, 0).bit_length()
                blk._touch_pageheat(self.name, pm,
                                    values.nbytes + (self.n * w + 7) // 8)
                return values, idx
        values, idx = lw.dct_indices(self._page(), pm.dtype, pm.shape)
        # index expansion materializes no values: count the packed
        # stream's size (width bits per row), i.e. the encoded form
        w = max(values.shape[0] - 1, 0).bit_length()
        blk._account_decoded(values.nbytes + (self.n * w + 7) // 8)
        blk._touch_pageheat(self.name, pm, values.nbytes + (self.n * w + 7) // 8)
        if cache is not None:
            cache.put(kv, values)
            cache.put(ki, idx)
        return values, idx

    # -- device-resident hot tier --------------------------------------
    def resident_key(self) -> tuple:
        return (str(self.blk.meta.block_id), self.name, int(self.pm.offset))

    def _device_tier(self):
        # one-shot streaming readers (compaction, column_cache=None)
        # bypass the tier the same way they bypass the heat ledger
        if self.blk._colcache is None:
            return None
        from tempo_tpu_torch.encoding.vtpu.colcache import shared_device_tier

        return shared_device_tier()

    def resident_payload(self):
        """This page's encoded form as host arrays ready for device
        placement: (codec, arrays, meta, host_bytes), or None when the
        shape cannot be evaluated on the device (vector columns, >32-bit
        or signed rle/dct values, multi-subcolumn dbp). host_bytes is
        what one host-path serve moves — the per-hit avoided-transfer
        increment. The device tier keeps these resident (resident()), and
        the compiled query tier stacks them (compiled/executor)."""
        from tempo_tpu_torch.encoding.vtpu import lightweight as lw

        pm = self.pm
        if pm.shape and len(pm.shape) > 1:
            return None
        if self.codec == "rle":
            values, lengths = self.runs()
            # unsigned-only: the device compares in u32, which preserves
            # equality under wrap but not ordering, and range_mask needs
            # ordering
            if (values.ndim != 1 or values.dtype.kind != "u"
                    or values.dtype.itemsize > 4):
                return None
            return ("rle",
                    {"values": values.astype(np.uint32),
                     "lengths": lengths.astype(np.int32)},
                    {"n": self.n},
                    values.nbytes + lengths.nbytes)
        if self.codec == "dct":
            values, idx = self._dct_indices()
            if (values.ndim != 1 or values.dtype.kind != "u"
                    or values.dtype.itemsize > 4):
                return None
            w = max(values.shape[0] - 1, 0).bit_length()
            return ("dct",
                    {"values": values.astype(np.uint32),
                     "idx": idx.astype(np.int32)},
                    {"n": self.n},
                    values.nbytes + (self.n * w + 7) // 8)
        if self.codec == "dbp":
            first, _anchors, widths, streams, n = lw.dbp_parts(
                self._page(), pm.dtype, pm.shape)
            if len(widths) != 1 or n == 0:
                return None
            raw = bytes(streams[0])
            pad = (-len(raw)) % 4 + 4  # round to words + one guard word
            words = np.frombuffer(raw + b"\x00" * pad, "<u4")
            return ("dbp", {"words": words},
                    {"n": n, "first": int(first[0]), "width": int(widths[0])},
                    n * np.dtype(pm.dtype).itemsize)
        return None

    def resident(self):
        """Resident entry for this page, admitting it (one h2d, counted)
        when the page-heat ledger puts it inside the what-if knee. The
        admitting query serves from the fresh entry too — host decode
        ran once to build the payload, never twice."""
        tier = self._device_tier()
        if tier is None:
            return None
        key = self.resident_key()
        res = tier.get(key)
        if res is not None:
            return res
        if not tier.should_admit([key]):
            return None
        payload = self.resident_payload()
        if payload is None:
            return None
        codec, arrays, meta, host_bytes = payload
        if tier.offer(key, codec, arrays, meta, host_bytes=host_bytes):
            return tier.get(key)
        return None

    # -- predicate evaluation in encoded space -------------------------
    def in_set_mask(self, codes: np.ndarray, invert: bool = False):
        """Row mask for `column in codes` (1-D columns), or None when
        this codec cannot answer without full decode (dbp)."""
        from tempo_tpu_torch.ops import scan

        res = self.resident()
        if res is not None:
            m = scan.resident_in_set_mask(res, codes, invert=invert)
            if m is not None:
                # fetch+decode+h2d all skipped: the fused device decode
                # ran over the parked compressed page
                self._device_tier().record_avoided(
                    res.host_bytes, kernel=f"resident_{res.codec}_scan")
                return m
        if self.codec == "rle":
            values, lengths = self.runs()
            return scan.expand_run_mask(
                scan.in_set_runs(values, codes, invert=invert), lengths, self.n)
        if self.codec == "dct":
            values, idx = self._dct_indices()
            hit = np.isin(values, codes, invert=invert)
            return hit[idx] if self.n else np.zeros(0, bool)
        return None

    def range_mask(self, lo, hi):
        """Row mask for lo <= column <= hi, or None (dbp/entropy —
        though a RESIDENT dbp page answers: its device delta-decode is
        fused into the compare)."""
        from tempo_tpu_torch.ops import scan

        res = self.resident()
        if res is not None:
            m = scan.resident_range_mask(res, lo, hi)
            if m is not None:
                self._device_tier().record_avoided(
                    res.host_bytes, kernel=f"resident_{res.codec}_scan")
                return m
        if self.codec == "rle":
            values, lengths = self.runs()
            return scan.expand_run_mask(
                scan.between_runs(values, lo, hi), lengths, self.n)
        if self.codec == "dct":
            values, idx = self._dct_indices()
            hit = (values >= lo) & (values <= hi)
            return hit[idx] if self.n else np.zeros(0, bool)
        return None

    def map_mask(self, fn) -> np.ndarray | None:
        """Row mask from an arbitrary per-VALUE boolean predicate: fn
        runs once per run (rle) or page-dictionary entry (dct) — never
        per row — and the verdict expands. fn must be elementwise (the
        same value always gets the same verdict), which is what makes
        the run verdict the row verdict."""
        from tempo_tpu_torch.ops import scan

        if self.codec == "rle":
            values, lengths = self.runs()
            return scan.expand_run_mask(np.asarray(fn(values), bool), lengths, self.n)
        if self.codec == "dct":
            values, idx = self._dct_indices()
            hit = np.asarray(fn(values), bool)
            return hit[idx] if self.n else np.zeros(0, bool)
        return None

    def rows_equal_mask(self, target_row) -> np.ndarray | None:
        """Row mask for `row == target_row` on vector columns (limb
        arrays) — the parent==0 root test without expanding IDs."""
        if self.codec == "rle":
            values, lengths = self.runs()
            from tempo_tpu_torch.ops import scan

            hit = (values == target_row).all(axis=tuple(range(1, values.ndim)))
            return scan.expand_run_mask(hit, lengths, self.n)
        if self.codec == "dct":
            values, idx = self._dct_indices()
            hit = (values == target_row).all(axis=tuple(range(1, values.ndim)))
            return hit[idx] if self.n else np.zeros(0, bool)
        return None

    # -- selective materialization -------------------------------------
    def gather(self, rows: np.ndarray) -> np.ndarray:
        """Values at `rows` only. rle/dct/dbp pay the rows (and, for
        dbp, the miniblocks) touched; anything else falls back to the
        full-column read (counted as such)."""
        from tempo_tpu_torch.encoding.vtpu import lightweight as lw

        rows = np.asarray(rows, np.int64)
        pm = self.pm
        if self.codec == "rle":
            values, lengths = self.runs()
            out = lw.rle_gather(values, lengths, rows)
            self.blk._account_decoded(out.nbytes)
            return out
        if self.codec == "dct":
            out = lw.dct_gather(self._page(), pm.dtype, pm.shape, rows)
            self.blk._account_decoded(out.nbytes)
            return out
        if self.codec == "dbp":
            out, touched_rows = lw.dbp_gather(self._page(), pm.dtype, pm.shape, rows)
            self.blk._account_decoded(touched_rows * np.dtype(pm.dtype).itemsize
                                      * (out.shape[1] if out.ndim > 1 else 1))
            return out
        col = self.blk.read_columns(self.rg, [self.name])[self.name]
        return col[rows]


class VtpuBackendBlock:
    """Lazy reader over one block; caches index + dictionary."""

    def __init__(self, meta: BlockMeta, backend: TypedBackend, cfg: BlockConfig | None = None,
                 column_cache="shared"):
        from tempo_tpu_torch.encoding.vtpu.colcache import shared_cache

        self.meta = meta
        self.backend = backend
        self.cfg = cfg or BlockConfig()
        self._index: fmt.BlockIndex | None = None
        self._dict = None
        self.bytes_read = 0
        # read-path economy counters (per block instance; search()
        # snapshots them into per-response stats)
        self.pruned_row_groups = 0
        self.coalesced_reads = 0  # backend round trips SAVED by coalescing
        # column value bytes materialized into row space by decode work.
        # Cache hits cost no decode and are not counted (same convention
        # as bytes_read); run/dict-space reads count their encoded size;
        # selective gathers count the rows/miniblocks touched — so on a
        # selective query this tracks the surviving bytes, not the row
        # count (the ROADMAP "inspectedBytes ≈ decodedBytes" target)
        self.decoded_bytes = 0
        # counter guard: the prefetcher loads row group N+1's column on a
        # worker thread while the caller reads N's remaining columns
        self._io_lock = threading.Lock()
        # decoded-column LRU shared across every block of the process
        # (reference: vparquet/readers.go + backend cache); pass
        # column_cache=None for one-shot streaming reads (compaction)
        # that would only churn the query working set
        self._colcache = shared_cache() if column_cache == "shared" else column_cache

    # ------------------------------------------------------------------
    def index(self) -> fmt.BlockIndex:
        if self._index is None:
            with stagetimings.stage("fetch"):
                raw = self.backend.read_named(
                    self.meta.tenant_id, self.meta.block_id, ColumnIndexName)
            self.bytes_read += len(raw)
            self._account_inspected(len(raw))
            self._index = fmt.BlockIndex.from_bytes(raw)
        return self._index

    def scrub(self) -> int:
        """Integrity pass: fetch and decode EVERY page, bypassing the
        decoded-page cache, so any stored corruption raises CorruptPage.
        Returns the number of pages verified. Used to attribute a
        compaction-time checksum failure to the guilty input block (the
        merge can't know whose page it was) and as an operator check
        before unquarantining."""
        n = 0
        for rg in self.index().row_groups:
            cols = self._fetch_columns(rg, list(rg.pages))
            n += len(cols)
        return n

    def iter_trace_batches(self):
        """All span rows, one SpanBatch per row group, trace-sorted —
        the streaming read the block-convert tooling uses (reference:
        tempo-cli convert reads whole blocks row-group-wise)."""
        for rg in self.index().row_groups:
            yield self._rows_to_batch(rg, np.arange(rg.n_spans))

    def dictionary(self):
        if self._dict is None:
            with stagetimings.stage("fetch"):
                raw = self.backend.read_named(
                    self.meta.tenant_id, self.meta.block_id, DictionaryName)
            self.bytes_read += len(raw)
            self._account_inspected(len(raw))
            self._dict = fmt.deserialize_dictionary(raw)
        return self._dict

    def _reader(self):
        def read(offset, length):
            with self._io_lock:
                self.bytes_read += length
            self._account_inspected(length)
            # every page read lands in the waterfall's "fetch" bucket
            # (exclusive: the enclosing "decode" stage subtracts it)
            with stagetimings.stage("fetch"):
                return self.backend.read_range_named(
                    self.meta.tenant_id, self.meta.block_id, DataName, offset, length
                )

        return read

    def _account_inspected(self, nbytes: int) -> None:
        """One backend read of nbytes (usage.account_bytes keeps the
        untagged counter and the active request's cost vector moving
        together, so per-tenant attribution always sums to the counter)."""
        usage.account_bytes(inspected_bytes_total, "inspected_bytes",
                            self.meta.tenant_id, nbytes, round_trip=True)

    def _account_decoded(self, nbytes: int) -> None:
        with self._io_lock:
            self.decoded_bytes += nbytes
        usage.account_bytes(decoded_bytes_total, "decoded_bytes",
                            self.meta.tenant_id, nbytes)

    def _touch_pageheat(self, name: str, pm, moved_bytes: int) -> None:
        """Feed the device data-movement ledger (util/pageheat): one
        query-path access to this (block, column, page), sized by what
        would ship to the device (`moved_bytes`) vs the page's stored
        size. Query paths only — one-shot streaming readers (compaction,
        column_cache=None) would poison the heat signal with pages that
        are about to be rewritten."""
        if self._colcache is None:
            return
        from tempo_tpu_torch.util import pageheat

        pageheat.touch(self.meta.block_id, name, pm.offset,
                       moved_bytes, pm.length)

    def _fetch_columns(self, rg: fmt.RowGroupMeta, names: list[str]) -> dict[str, np.ndarray]:
        """Fetch+decode columns with coalesced ranged reads, accounting
        the round trips saved vs one-read-per-page."""
        with stagetimings.stage("decode"):  # IO inside lands in "fetch"
            cols, n_reads, _ = fmt.read_columns_coalesced(self._reader(), rg, names)
        usage.charge("pages_fetched", len(names))
        saved = len(names) - n_reads
        if saved > 0:
            with self._io_lock:
                self.coalesced_reads += saved
            coalesced_reads_total.inc(saved)
        self._account_decoded(sum(c.nbytes for c in cols.values()))
        return cols

    def encoded_column(self, rg: fmt.RowGroupMeta, name: str) -> EncodedColumn | None:
        """Encoded-space access to one column, or None when its page is
        on the entropy tier (or run-space evaluation is switched off)."""
        from tempo_tpu_torch.encoding.vtpu.codec import LIGHTWEIGHT_CODECS

        if not runspace_enabled():
            return None
        pm = rg.pages.get(name)
        if pm is None or pm.codec not in LIGHTWEIGHT_CODECS:
            return None
        return EncodedColumn(self, rg, name)

    def column_in_set_mask(self, rg: fmt.RowGroupMeta, name: str,
                           codes: np.ndarray, invert: bool = False) -> np.ndarray:
        """Span mask for `column in codes`, evaluated in run/dictionary
        space when the page allows (values of unselected runs never
        expand), else over the decoded column — bit-identical either
        way."""
        enc = self.encoded_column(rg, name)
        if enc is not None:
            m = enc.in_set_mask(codes, invert=invert)
            if m is not None:
                return m
        c = self.read_columns(rg, [name])[name]
        return np.isin(c, codes, invert=invert)

    def read_columns(self, rg: fmt.RowGroupMeta, names: list[str]) -> dict[str, np.ndarray]:
        """Decoded column chunks, via the process-wide cache when armed.
        Cache keys are (block_id, column name, page offset) — immutable
        content at a fixed offset, so no invalidation exists to get
        wrong; the column name disambiguates zero-byte pages, which
        share an offset with their neighbor (an empty attr table writes
        several length-0 pages at one offset — offset alone would alias
        them across columns and serve the wrong dtype/shape). A warm
        read costs zero backend bytes and zero codec work; arrays come
        back read-only (columns are immutable by convention). Misses
        fetch with coalesced gap-tolerant ranged reads (one per page
        run, not one per page)."""
        cache = self._colcache
        if cache is None:
            return self._fetch_columns(rg, names)
        out = {}
        missing = []
        for name in names:
            arr = cache.get((self.meta.block_id, name, rg.pages[name].offset))
            if arr is not None:
                out[name] = arr
            else:
                missing.append(name)
        if missing:
            dec = self._fetch_columns(rg, missing)
            for name, arr in dec.items():
                cache.put((self.meta.block_id, name, rg.pages[name].offset), arr)
                out[name] = arr
        # page-heat ledger: hits AND misses are accesses — the host
        # cache elides IO/decode, never the per-dispatch h2d trip
        for name, arr in out.items():
            self._touch_pageheat(name, rg.pages[name], arr.nbytes)
        return out

    def bloom_plan(self) -> bloom.BloomPlan:
        return bloom.BloomPlan(
            n_shards=self.meta.bloom_shards,
            bits_per_shard=self.meta.bloom_bits_per_shard,
            k=self.meta.bloom_k,
        )

    # ------------------------------------------------------------------
    # trace by ID
    # ------------------------------------------------------------------

    def find_trace_by_id(self, trace_id: bytes) -> Trace | None:
        limbs = hashing.trace_id_to_limbs(trace_id)
        hex_id = trace_id.hex().rjust(32, "0")
        if not (self.meta.min_id <= hex_id <= self.meta.max_id):
            return None
        # bloom: fetch only the shard this ID hashes to
        p = self.bloom_plan()
        shard = int(bloom.shard_for_ids(limbs[None, :], p)[0])
        raw = self.backend.read_named(self.meta.tenant_id, self.meta.block_id, bloom_name(shard))
        self.bytes_read += len(raw)
        self._account_inspected(len(raw))
        words = bloom.shard_from_bytes(raw)
        if not bloom.np_test_one_shard(words, limbs[None, :], p)[0]:
            return None
        # row groups whose [min,max] cover the ID
        parts = []
        for rg in self.index().row_groups:
            if not (rg.min_id <= hex_id <= rg.max_id):
                continue
            tid_col = self.read_columns(rg, ["trace_id"])["trace_id"]
            rows = np.flatnonzero((tid_col == limbs[None, :]).all(axis=1))
            if len(rows) == 0:
                continue
            parts.append(self._rows_to_batch(rg, rows))
        if not parts:
            return None
        combined = SpanBatch.concat(parts) if len(parts) > 1 else parts[0]
        traces = batch_to_traces(combined)
        return traces[0] if traces else None

    def _rows_to_batch(self, rg: fmt.RowGroupMeta, rows: np.ndarray) -> SpanBatch:
        """Materialize full span rows (all columns + attrs) for row indices."""
        cols = self.read_columns(rg, list(SPAN_COLUMNS))
        attrs = self.read_columns(rg, list(ATTR_COLUMNS))
        batch = SpanBatch(cols=cols, attrs=attrs, dictionary=self.dictionary())
        return batch.select(rows)

    # ------------------------------------------------------------------
    # tag search
    # ------------------------------------------------------------------

    def search(self, req: SearchRequest, start_row_group: int = 0,
               row_groups: int = 0) -> SearchResponse:
        """start_row_group/row_groups bound the scan to a page subrange —
        the unit of the frontend's job sharding and the serverless
        contract (reference: api.SearchBlockRequest StartPage/PagesToSearch,
        cmd/tempo-serverless/handler.go:53). row_groups=0 = all remaining."""
        from tempo_tpu_torch.util.pipeline import ReadAhead

        bytes_before = self.bytes_read
        decoded_before = self.decoded_bytes
        coalesced_before = self.coalesced_reads
        resp = SearchResponse(inspected_blocks=1)
        d = self.dictionary()

        # resolve string predicates against the dictionary once per block;
        # an impossible predicate must return before any index/page IO
        preds = _resolve_tag_predicates(req, d)
        if preds is not None:  # None -> a predicate can never match here
            # most selective predicate first: fewest accepted codes ≈
            # fewest surviving spans, so later columns are read rarely
            preds["span_eq"].sort(key=lambda cv: len(cv[1]))
            all_rgs = self.index().row_groups
            end_rg = (start_row_group + row_groups) if row_groups else len(all_rgs)
            zm = zone_maps_enabled()
            live: list = []
            with stagetimings.stage("zonemap_prune"):
                for rg in all_rgs[start_row_group:end_rg]:
                    if req.start_seconds and rg.end_s < req.start_seconds:
                        continue
                    if req.end_seconds and rg.start_s > req.end_seconds:
                        continue
                    if zm and zone_prunes(rg, preds, req):
                        resp.pruned_row_groups += 1
                        continue
                    live.append(rg)
            if resp.pruned_row_groups:
                self.pruned_row_groups += resp.pruned_row_groups
                pruned_row_groups_total.inc(resp.pruned_row_groups)

            # prefetch: load row group N+1's first predicate column while
            # N evaluates (no-op on single-core hosts — ReadAhead gates
            # its worker on pipeline.overlap_enabled). Encoded-evaluable
            # pages prefetch their raw bytes only (the IO); the run/dict
            #-space verdict is cheap and computed inline.
            stage1 = ([preds["span_eq"][0][0]] if preds["span_eq"]
                      else ["duration_nano"]
                      if (req.min_duration_ns or req.max_duration_ns) else [])

            def load_stage1(i):
                out = {}
                for nm in stage1:
                    enc = self.encoded_column(live[i], nm)
                    if enc is not None:
                        enc._page()  # warm the raw-page cache
                    else:
                        out.update(self.read_columns(live[i], [nm]))
                return out

            # an unbounded search visits every live row group, so the
            # stage-1 masks of the pages the device tier holds come first,
            # from one batched scan a codec; a limited one stops early and
            # touches no page its loop never reaches
            pre = (self._resident_stage1(live, stage1[0], preds, req)
                   if stage1 and live and not req.limit else {})
            ra = ReadAhead(load_stage1, len(live)) if stage1 and live else None
            try:
                for i, rg in enumerate(live):
                    resp.inspected_traces += rg.n_traces
                    have = ra.get(i) if ra is not None else {}
                    remaining = (req.limit - len(resp.traces)) if req.limit else 0
                    resp.traces.extend(self._search_row_group(
                        rg, req, preds, limit=remaining, have_cols=have,
                        stage1=pre.get(i)))
                    if req.limit and len(resp.traces) >= req.limit:
                        break
            finally:
                if ra is not None:
                    ra.close()
        resp.inspected_bytes = self.bytes_read - bytes_before
        resp.decoded_bytes = self.decoded_bytes - decoded_before
        resp.coalesced_reads = self.coalesced_reads - coalesced_before
        return resp

    def _resident_stage1(self, live: list, col: str, preds, req) -> dict:
        """{index in live: serve} for the live row groups whose stage-1
        predicate page (on `col`) the device tier already holds: rle and
        dct pages for a code set, rle, dct and dbp pages for the duration
        range, their masks from one batched scan a codec
        (ops/scan.resident_in_set_masks / resident_range_masks). serve()
        returns the mask and counts the tier's get and avoided bytes where
        the per-page serve would, when _search_row_group reaches the page,
        so the tier's counters and LRU order stay the loop's; it returns
        None for a page evicted since the batch. Pages not resident are
        left to _search_row_group, which admits and serves them as it
        does; this admits nothing."""
        from tempo_tpu_torch.encoding.vtpu.colcache import shared_device_tier
        from tempo_tpu_torch.ops import scan

        # one-shot readers (column_cache=None) bypass the tier, as
        # EncodedColumn._device_tier does
        tier = shared_device_tier() if self._colcache is not None else None
        if tier is None:
            return {}
        in_set = bool(preds["span_eq"])
        codecs = ("rle", "dct") if in_set else ("rle", "dct", "dbp")
        found = []
        for i, rg in enumerate(live):
            enc = self.encoded_column(rg, col) if rg.n_spans else None
            if enc is None or enc.codec not in codecs:
                continue
            key = enc.resident_key()
            res = tier.peek(key)
            if res is not None:
                found.append((i, key, res))
        if not found:
            return {}
        entries = [res for _, _, res in found]
        if in_set:
            masks = scan.resident_in_set_masks(entries, preds["span_eq"][0][1])
        else:
            lo, hi = _duration_bounds(req)
            masks = scan.resident_range_masks(entries, np.uint64(lo), np.uint64(hi))

        def serve(mask, key, res):
            def served():
                # evicted since the batch (by this search's own admissions
                # or a shed): None, and the per-page path takes its miss
                # and re-admits the page as the loop does
                if tier.get(key, count_miss=False) is None:
                    return None
                tier.record_avoided(res.host_bytes, kernel=f"resident_{res.codec}_scan")
                return mask
            return served

        return {i: serve(m, key, res) for (i, key, res), m in zip(found, masks)}

    def _search_row_group(self, rg, req, preds, limit: int,
                          have_cols: dict | None = None,
                          stage1=None) -> list[TraceSearchMetadata]:
        """limit: max hits to return; 0 means unbounded. stage1: when the
        caller has the first predicate's mask, a call that returns it
        (_resident_stage1).

        Lazy projection in three stages: the most selective predicate's
        column alone (usually prefetched), then — only if spans survive —
        every remaining predicate column in ONE coalesced read, then
        metadata pages only when something matched. Most row groups of a
        selective search cost one page, not seven.
        """
        n = rg.n_spans
        if n == 0:
            return []
        cols = dict(have_cols or {})
        span_mask = np.ones(n, bool)
        dur_pred = bool(req.min_duration_ns or req.max_duration_ns)

        def expandable(name: str) -> bool:
            # a column whose predicate evaluates in encoded space never
            # joins a coalesced full read
            return self.encoded_column(rg, name) is not None

        for k, (col, codes) in enumerate(preds["span_eq"]):
            m = stage1() if k == 0 and stage1 is not None else None
            if m is None and col not in cols:
                enc = self.encoded_column(rg, col)
                if enc is not None:
                    m = enc.in_set_mask(codes)
            if m is None:
                if col not in cols:
                    if k == 0:
                        cols.update(self.read_columns(rg, [col]))
                    else:
                        # the mask survived the most selective predicate:
                        # fetch everything still needed in one coalesced
                        # read (encoded-evaluable columns excluded)
                        rest = [c for c, _ in preds["span_eq"][k:]
                                if c not in cols and not expandable(c)]
                        if dur_pred and "duration_nano" not in cols \
                                and not expandable("duration_nano"):
                            rest.append("duration_nano")
                        cols.update(self.read_columns(rg, rest))
                m = np.isin(cols[col], codes)
            span_mask &= m
            if not span_mask.any():
                return []
        if dur_pred:
            lo, hi = _duration_bounds(req)
            m = stage1() if stage1 is not None and not preds["span_eq"] else None
            if m is None and "duration_nano" not in cols:
                enc = self.encoded_column(rg, "duration_nano")
                if enc is not None:
                    m = enc.range_mask(np.uint64(lo), np.uint64(hi))
            if m is None:
                if "duration_nano" not in cols:
                    cols.update(self.read_columns(rg, ["duration_nano"]))
                dur = cols["duration_nano"]
                m = (dur >= np.uint64(lo)) & (dur <= np.uint64(hi))
            span_mask &= m
            if not span_mask.any():
                return []

        # attr predicates: evaluate over the attr table then AND per-span
        if preds["attr"]:
            span_mask &= attr_predicate_mask(self, rg, preds)
            if not span_mask.any():
                return []
        return self.hits_for_mask(rg, span_mask, req, limit, have_cols=cols)

    def hits_for_mask(self, rg, span_mask: np.ndarray, req, limit: int = 0,
                      have_cols: dict | None = None) -> list[TraceSearchMetadata]:
        """Phase 2 of search: fetch metadata pages and roll a span hit
        mask up to TraceSearchMetadata (also the mesh scan's collector —
        the scan produces the mask, this builds the hits).

        With an RLE trace-ID page the whole phase runs in RUN SPACE:
        the ID runs ARE the trace segmentation (zero decode), and the
        metadata columns are GATHERED for the hit traces' rows only —
        the surviving-span selection pushed into the later column reads,
        so decodedBytes scales with the hits, not the row count. The
        row-space path below is the exact fallback (and the
        TEMPO_TPU_RUNSPACE=0 arm); both produce identical hits.

        The rollup is fully vectorized (reduceat over trace segments):
        the per-hit Python work is only dataclass construction, so
        unlimited searches don't pay a numpy call per trace.
        """
        n = rg.n_spans
        if n == 0:
            return []
        tid_enc = self.encoded_column(rg, "trace_id")
        if tid_enc is not None and tid_enc.codec == "rle":
            out = self._hits_for_mask_runspace(
                rg, tid_enc, span_mask, req, limit, have_cols)
            if out is not None:
                return out
        cols = dict(have_cols or {})
        missing = sorted(set(_META_COLS) - set(cols))
        if missing:
            cols.update(self.read_columns(rg, missing))

        # roll up to traces (any span matched), honoring time window
        from tempo_tpu_torch.model.columnar import hit_trace_mask, trace_segmentation

        tid = cols["trace_id"]
        new, seg, firsts = trace_segmentation(tid)
        starts = cols["start_unix_nano"]
        ends = starts + cols["duration_nano"]
        if req.start_seconds:
            span_mask = span_mask & (ends >= np.uint64(req.start_seconds * 10**9))
        if req.end_seconds:
            span_mask = span_mask & (starts <= np.uint64(req.end_seconds * 10**9))

        n_traces = int(seg[-1]) + 1
        trace_hit = hit_trace_mask(seg, span_mask, n_traces)
        hit_ts = np.flatnonzero(trace_hit)
        if limit > 0:
            hit_ts = hit_ts[:limit]
        if not len(hit_ts):
            return []

        bounds_next = np.append(firsts[1:], n)
        t_start = np.minimum.reduceat(starts, firsts)
        t_end = np.maximum.reduceat(ends, firsts)
        # root span per trace: first row with parent == 0, else first row
        is_root = (cols["parent_span_id"] == 0).all(axis=1)
        cand = np.where(is_root, np.arange(n), n)
        first_root = np.minimum.reduceat(cand, firsts)
        root = np.where(first_root < bounds_next, first_root, firsts)

        d = self.dictionary()
        svc = cols["service"][root]
        nm = cols["name"][root]
        out = []
        for t in hit_ts:
            s = int(t_start[t])
            out.append(
                TraceSearchMetadata(
                    trace_id_hex=fmt.id_to_hex(tid[firsts[t]]),
                    root_service_name=d[int(svc[t])],
                    root_trace_name=d[int(nm[t])],
                    start_time_unix_nano=s,
                    duration_ms=(int(t_end[t]) - s) // 10**6,
                )
            )
        return out


    def _hits_for_mask_runspace(self, rg, tid_enc: EncodedColumn,
                                span_mask: np.ndarray, req, limit: int,
                                have_cols: dict | None) -> list | None:
        """Run-space hit collection: trace segmentation from the RLE
        trace-ID runs (the runs ARE the traces — rows are trace-sorted,
        so equal IDs form maximal stretches, exactly
        trace_segmentation's rule), metadata gathered for hit-trace rows
        only. Bit-identical to the row-space rollup."""
        from tempo_tpu_torch.model.columnar import hit_trace_mask
        from tempo_tpu_torch.ops import scan

        n = rg.n_spans
        have = dict(have_cols or {})

        def g(name: str, rows: np.ndarray) -> np.ndarray:
            if name in have:
                return have[name][rows]
            enc = self.encoded_column(rg, name)
            if enc is not None:
                return enc.gather(rows)
            return self.read_columns(rg, [name])[name][rows]

        values, lengths = tid_enc.runs()
        firsts, seg = scan.runs_firsts_seg(lengths)
        n_traces = len(lengths)
        if n_traces == 0:
            return []

        mask = span_mask
        if req.start_seconds or req.end_seconds:
            rows_m = np.flatnonzero(mask)
            if not len(rows_m):
                return []
            starts_m = g("start_unix_nano", rows_m)
            ends_m = starts_m + g("duration_nano", rows_m)
            keep = np.ones(len(rows_m), bool)
            if req.start_seconds:
                keep &= ends_m >= np.uint64(req.start_seconds * 10**9)
            if req.end_seconds:
                keep &= starts_m <= np.uint64(req.end_seconds * 10**9)
            mask = np.zeros(n, bool)
            mask[rows_m[keep]] = True

        trace_hit = hit_trace_mask(seg, mask, n_traces)
        hit_ts = np.flatnonzero(trace_hit)
        if limit > 0:
            hit_ts = hit_ts[:limit]
        if not len(hit_ts):
            return []

        # all rows of the hit traces (the per-trace metadata reductions
        # run over the trace's own rows, matched or not)
        bounds_next = np.append(firsts[1:], n)
        counts = bounds_next[hit_ts] - firsts[hit_ts]
        tot = int(counts.sum())
        hfirsts = np.cumsum(counts) - counts
        offs = np.arange(tot, dtype=np.int64) - np.repeat(hfirsts, counts)
        rows = np.repeat(firsts[hit_ts], counts) + offs

        starts_h = g("start_unix_nano", rows)
        ends_h = starts_h + g("duration_nano", rows)
        t_start = np.minimum.reduceat(starts_h, hfirsts)
        t_end = np.maximum.reduceat(ends_h, hfirsts)
        # first TRUE-root row per hit trace, else the trace's first row.
        # The write-time root_first stat proves the answer is the first
        # row for every trace here — zero parent reads; otherwise scan
        # the hit traces' parent ids.
        if rg.stats and rg.stats.get("root_first"):
            root_rows = firsts[hit_ts]
        else:
            par_enc = self.encoded_column(rg, "parent_span_id")
            root_mask = par_enc.rows_equal_mask(0) if par_enc is not None else None
            if root_mask is not None:
                is_root = root_mask[rows]  # run/dict-space zero test
            else:
                is_root = (g("parent_span_id", rows) == 0).all(axis=1)
            cand = np.where(is_root, rows, n)
            first_root = np.minimum.reduceat(cand, hfirsts)
            root_rows = np.where(first_root < bounds_next[hit_ts],
                                 first_root, firsts[hit_ts])
        svc = g("service", root_rows)
        nm = g("name", root_rows)

        d = self.dictionary()
        tid_be = np.ascontiguousarray(values[hit_ts]).astype(">u4")
        out = []
        for j in range(len(hit_ts)):
            s = int(t_start[j])
            out.append(
                TraceSearchMetadata(
                    trace_id_hex=tid_be[j].tobytes().hex(),
                    root_service_name=d[int(svc[j])],
                    root_trace_name=d[int(nm[j])],
                    start_time_unix_nano=s,
                    duration_ms=(int(t_end[j]) - s) // 10**6,
                )
            )
        return out

    # ------------------------------------------------------------------
    # TraceQL fetch: approximate condition pushdown -> candidate traces
    # ------------------------------------------------------------------

    def fetch_candidates(self, spec, start_s: int = 0, end_s: int = 0,
                         max_traces: int = 0) -> list:
        """Candidate Trace objects for a TraceQL FetchSpec.

        Reference analog: vparquet's Fetch compiling traceql conditions
        into a parquetquery iterator tree (block_traceql.go:92-617).
        Here each condition lowers to a span-row mask over row-group
        columns (strings resolved via the block dictionary first);
        unsupported conditions are skipped in AND mode (superset is
        safe — the engine re-evaluates exactly) and force fetch-all in
        OR mode (skipping would drop true matches).
        """
        from tempo_tpu_torch.model.trace import batch_to_traces

        d = self.dictionary()
        resolvers = []
        fetch_all = not spec.conditions
        impossible = False
        for cond in spec.conditions:
            r = _lower_condition(cond, d)
            if r == "impossible":
                if spec.all_conditions:
                    impossible = True
                    break
                continue  # OR: this arm matches nothing; others may match
            if r is None:  # unsupported op
                if not spec.all_conditions:
                    fetch_all = True  # OR with an opaque arm: can't prune
                continue
            resolvers.append(r)
        if impossible:
            return []
        if not resolvers:
            fetch_all = True

        # cheapest veto first: equality code sets, then numeric ranges,
        # then attr-table scans (see _lower_condition's sel estimates)
        resolvers.sort(key=lambda r: getattr(r, "sel", 1 << 30))
        zm = zone_maps_enabled()
        out = []
        for rg in self.index().row_groups:
            if start_s and rg.end_s < start_s:
                continue
            if end_s and rg.start_s > end_s:
                continue
            if not fetch_all and zm and resolvers:
                # zone maps: a condition whose prune hook proves this row
                # group empty skips it with zero backend reads. AND: any
                # provably-empty arm vetoes; OR: every arm must prove empty
                # (and every arm must HAVE a prune hook — negated ops
                # deliberately don't, presence says nothing about them)
                prunes = [r.prune(rg) for r in resolvers
                          if getattr(r, "prune", None) is not None]
                dead = (any(prunes) if spec.all_conditions
                        else bool(prunes) and len(prunes) == len(resolvers) and all(prunes))
                if dead:
                    self.pruned_row_groups += 1
                    pruned_row_groups_total.inc()
                    continue
            n = rg.n_spans
            if fetch_all:
                span_mask = np.ones(n, bool)
            else:
                # lazy short-circuit: in AND mode a dead mask means later
                # conditions' columns are never fetched
                span_mask = None
                for r in resolvers:
                    m = r(self, rg)
                    span_mask = m if span_mask is None else (
                        (span_mask & m) if spec.all_conditions else (span_mask | m))
                    if spec.all_conditions and not span_mask.any():
                        break
            if not span_mask.any():
                continue
            tid = self.read_columns(rg, ["trace_id"])["trace_id"]
            from tempo_tpu_torch.model.columnar import hit_trace_mask, trace_segmentation

            _, seg, _ = trace_segmentation(tid)
            hit_traces = hit_trace_mask(seg, span_mask, int(seg[-1]) + 1)
            rows = np.flatnonzero(hit_traces[seg])  # all spans of hit traces
            out.extend(batch_to_traces(self._rows_to_batch(rg, rows)))
            if max_traces and len(out) >= max_traces:
                break
        return out

    def iter_eval_views(self, pipeline, start_s: int = 0, end_s: int = 0):
        """Projection-limited column views for the vectorized TraceQL
        path (traceql/vector.py): per time-pruned row group, decode only
        the span columns the pipeline names (+ the attr table when a
        non-dedicated attribute appears) — the columnar analog of the
        reference's per-predicate parquet column iterators
        (vparquet/block_traceql.go:279)."""
        from tempo_tpu_torch.model.columnar import _empty_cols
        from tempo_tpu_torch.traceql import vector

        span_cols, needs_attrs = vector.needed_columns(pipeline)
        d = self.dictionary()
        for rg in self.index().row_groups:
            if start_s and rg.end_s < start_s:
                continue
            if end_s and rg.start_s > end_s:
                continue
            cols = self.read_columns(rg, span_cols)
            attrs = (
                self.read_columns(rg, list(ATTR_COLUMNS))
                if needs_attrs
                else _empty_cols(ATTR_COLUMNS)
            )
            yield vector.ColumnView(cols, attrs, rg.n_spans), d

    def tag_names(self) -> set:
        """Tag names present anywhere in this block: well-known columns
        + attr keys, per row group (reference parity-plus: the snapshot
        serves tags from ingesters only; Tempo v2 added block-backed
        SearchTags, which this provides)."""
        from tempo_tpu_torch.model.tags import WELL_KNOWN_TAGS, tag_names_from_columns

        d = self.dictionary()
        out: set = set()
        wk_cols = sorted({col for col, _ in WELL_KNOWN_TAGS.values()})
        for rg in self.index().row_groups:
            cols = self.read_columns(rg, wk_cols)
            attrs = self.read_columns(rg, ["attr_key"])
            out |= tag_names_from_columns(cols, attrs, d)
        return out

    def tag_values(self, tag: str) -> set:
        """Values of one tag across the block's row groups."""
        from tempo_tpu_torch.model.tags import WELL_KNOWN_TAGS, tag_values_from_columns

        d = self.dictionary()
        out: set = set()
        wk = WELL_KNOWN_TAGS.get(tag)
        if wk is None and d.get(tag) is None:
            return out  # key not interned: nothing to scan
        for rg in self.index().row_groups:
            if wk is not None:
                cols = self.read_columns(rg, [wk[0]])
                attrs: dict = {}
            else:
                cols = {}
                attrs = self.read_columns(rg, ["attr_key", "attr_vtype", "attr_str", "attr_num"])
            out |= tag_values_from_columns(cols, attrs, d, tag)
        return out

    def collect_spans_for_ids(self, hex_ids: set) -> list:
        """All spans of the given trace IDs present in this block.

        Completes partial traces when a trace straddles blocks and only
        some blocks' spans matched the pushdown conditions — structural
        operators (childCount, parent, >>) need whole traces
        (traceql engine contract)."""
        from tempo_tpu_torch.model.trace import batch_to_traces

        lo, hi = min(hex_ids), max(hex_ids)
        if hi < self.meta.min_id or lo > self.meta.max_id:
            return []
        limbs = np.stack([fmt.hex_to_limbs(h) for h in hex_ids])
        key_view = limbs.copy().view("V16").reshape(-1)
        out = []
        for rg in self.index().row_groups:
            if rg.max_id < lo or rg.min_id > hi:
                continue
            tid = self.read_columns(rg, ["trace_id"])["trace_id"]
            rows = np.flatnonzero(np.isin(tid.copy().view("V16").reshape(-1), key_view))
            if len(rows):
                out.extend(batch_to_traces(self._rows_to_batch(rg, rows)))
        return out


_STR_OPS = ("=", "=~", "!=", "!~")


def _numeric_range_prune(col_name, op, val):
    """prune(rg) for a numeric comparison against a [min,max] zone map,
    or None when the op can't be range-pruned (!=: a group whose range
    contains only `val` is theoretically prunable, but min==max==val is
    too rare to buy complexity)."""
    if op not in (">", ">=", "<", "<=", "="):
        return None
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        return None

    def prune(rg):
        mm = rg.stats.get(col_name) if rg.stats else None
        if mm is None:
            return False
        lo, hi = mm
        return {
            ">": hi <= val,
            ">=": hi < val,
            "<": lo >= val,
            "<=": lo > val,
            "=": val < lo or val > hi,
        }[op]

    return prune


def _lower_condition(cond, d):
    """Condition -> callable(block, rg) -> span mask, or None
    (unsupported), or "impossible" (can never match this block).

    Each supported resolver carries zone-map hooks: `run.prune(rg)` —
    True when the row group's stats prove no span can match (only
    POSITIVE ops get one; != / !~ match spans whose code is absent from
    the presence set, so presence can never veto them) — and `run.sel`,
    a cost/selectivity estimate fetch_candidates orders evaluation by.

    Negated ops (!=, !~) lower to inverted code-set scans: a superset of
    the exact result (spans lacking the column/attr may slip through;
    the engine re-evaluates exactly). Reference: the reference pushes
    OpNotEqual/OpNotRegex into parquet predicates the same way
    (vparquet/block_traceql.go createPredicate)."""
    op, val = cond.op, cond.value

    def col_mask(col_name, codes, invert=False):
        def run(blk, rg):
            if codes is None:  # negated op with nothing to exclude
                return np.ones(rg.n_spans, bool)
            # run/dictionary-space when the page allows: unselected runs
            # are never expanded (column_in_set_mask falls back to the
            # decoded column bit-identically)
            return blk.column_in_set_mask(rg, col_name, codes, invert=invert)

        if not invert and codes is not None:
            run.prune = lambda rg: not _stats_admit(rg, col_name, codes)
            run.sel = len(codes)
        return run

    def str_col(col_name):
        codes = _string_codes(d, "=" if op in ("=", "!=") else "=~", val)
        if op in ("=", "=~"):
            if codes is None:
                return "impossible"
            return col_mask(col_name, codes)
        return col_mask(col_name, codes, invert=True)

    def numeric_col(col_name, table):
        def run(blk, rg):
            c = blk.read_columns(rg, [col_name])[col_name]
            return table(c)

        run.prune = _numeric_range_prune(col_name, op, val)
        run.sel = 1000
        return run

    if cond.scope == "intrinsic":
        if cond.name == "name" and op in _STR_OPS:
            return str_col("name")
        if cond.name == "duration" and op in (">", ">=", "<", "<=", "=", "!="):
            return numeric_col("duration_nano", lambda dur: {
                ">": dur > val,
                ">=": dur >= val,
                "<": dur < val,
                "<=": dur <= val,
                "=": dur == val,
                "!=": dur != val,
            }[op])
        if cond.name in ("status", "kind") and op in ("=", "!="):
            col = "status_code" if cond.name == "status" else "kind"
            return numeric_col(col, lambda c: (c == val) if op == "=" else (c != val))
        return None

    if cond.scope in ("any", "span", "resource"):
        if cond.name == "service.name" and op in _STR_OPS:
            return str_col("service")
        if cond.name == "http.method" and op in _STR_OPS:
            return str_col("http_method")
        if cond.name == "http.url" and op in _STR_OPS:
            return str_col("http_url")
        if cond.name == "http.status_code" and op in ("=", "!=", ">", ">=", "<", "<="):
            return numeric_col("http_status", lambda c: {
                "=": c == val,
                "!=": c != val,
                ">": c > val,
                ">=": c >= val,
                "<": c < val,
                "<=": c <= val,
            }[op])
        return _lower_attr_condition(cond, d)

    return None


def _lower_attr_condition(cond, d):
    from tempo_tpu_torch.model.columnar import SCOPE_RESOURCE, SCOPE_SPAN, VT_BOOL, VT_FLOAT, VT_INT, VT_STR

    op, val = cond.op, cond.value
    kc = d.get(cond.name)
    if kc is None:
        # negated ops are trivially satisfied by every span carrying the
        # attr — but the key itself is absent from this block, so nothing
        # can match either way ("span HAS attr and value differs")
        return "impossible"

    invert = False
    if isinstance(val, str):
        if op not in ("=", "=~", "!=", "!~"):
            return None
        codes = _string_codes(d, "=" if op in ("=", "!=") else "=~", val)
        invert = op in ("!=", "!~")
        if codes is None and not invert:
            return "impossible"
        want_vt = VT_STR
    elif isinstance(val, bool):
        if op not in ("=", "!="):
            return None
        codes, want_vt = None, VT_BOOL
    elif isinstance(val, (int, float)):
        if op not in ("=", "!=", ">", ">=", "<", "<="):
            return None
        codes, want_vt = None, None  # numeric: INT or FLOAT
    else:
        return None

    def run(blk, rg):
        a = blk.read_columns(rg, ["attr_span", "attr_scope", "attr_key", "attr_vtype", "attr_str", "attr_num"])
        rows = a["attr_key"] == np.uint32(kc)
        if cond.scope == "span":
            rows &= a["attr_scope"] == SCOPE_SPAN
        elif cond.scope == "resource":
            rows &= a["attr_scope"] == SCOPE_RESOURCE
        if want_vt == VT_STR:
            rows &= a["attr_vtype"] == VT_STR
            if codes is None:  # negated, value not in dictionary: all differ
                pass
            else:
                rows &= np.isin(a["attr_str"], codes, invert=invert)
        elif want_vt == VT_BOOL:
            rows &= (a["attr_vtype"] == VT_BOOL) & (
                ((a["attr_num"] != 0) == val) if op == "=" else ((a["attr_num"] != 0) != val)
            )
        else:
            num = a["attr_num"]
            rows &= np.isin(a["attr_vtype"], [VT_INT, VT_FLOAT]) & {
                "=": num == val,
                "!=": num != val,
                ">": num > val,
                ">=": num >= val,
                "<": num < val,
                "<=": num <= val,
            }[op]
        mask = np.zeros(rg.n_spans, bool)
        mask[a["attr_span"][rows]] = True
        return mask

    def prune(rg):
        # sound for EVERY attr op, negated included: a span matches only
        # via an attr-table row with this key, so a row group whose
        # attr_key presence set lacks the key cannot produce matches
        keys = rg.stats.get("attr_key") if rg.stats else None
        return keys is not None and int(kc) not in keys

    run.prune = prune
    run.sel = 2000  # attr-table scan: six columns, evaluate last
    return run


def _string_codes(d, op, val):
    """Dictionary codes matching a string predicate, or None if nothing
    can match in this block."""
    import re as _re

    if op == "=":
        code = d.get(val)
        return None if code is None else np.array([code], np.uint32)
    rx = _re.compile(val)
    codes = [i for i, e in enumerate(d.entries) if rx.search(e)]
    return np.asarray(codes, np.uint32) if codes else None


def attr_predicate_mask(blk, rg, preds) -> np.ndarray:
    """AND of the attr-table predicates as a span mask — shared by the
    single-block scan and the mesh searcher so the two paths cannot
    drift.

    Attr-table columns evaluate in encoded space when their pages
    allow: key/vtype/value tests are run- or dictionary-space masks and
    only the MATCHING attr rows' owner spans gather out of attr_span —
    on a selective attr predicate the table is never expanded. Columns
    whose pages are NOT encoded fetch together in ONE coalesced ranged
    read (the PR-3 IO economy), never one read per column."""
    n = rg.n_spans
    mask = np.ones(n, bool)
    if not preds["attr"]:
        return mask
    table_cols = ("attr_span", "attr_key", "attr_vtype", "attr_str")
    encs = {c: blk.encoded_column(rg, c) for c in table_cols}
    plain = [c for c in table_cols if encs[c] is None]
    attrs = blk.read_columns(rg, plain) if plain else {}

    def in_set(col, codes):
        enc = encs[col]
        if enc is not None:
            m = enc.in_set_mask(codes)
            if m is not None:
                return m
        c = attrs.get(col)
        if c is None:
            c = blk.read_columns(rg, [col])[col]
            attrs[col] = c
        return np.isin(c, codes)

    is_str = in_set("attr_vtype", np.array([VT_STR], np.uint8))
    for key_code, val_codes in preds["attr"]:
        arow = (
            in_set("attr_key", np.array([key_code], np.uint32))
            & is_str
            & in_set("attr_str", val_codes)
        )
        ok_spans = np.zeros(n, bool)
        rows = np.flatnonzero(arow)
        if len(rows):
            if encs["attr_span"] is not None:
                owners = encs["attr_span"].gather(rows)
            else:
                owners = attrs["attr_span"][rows]
            ok_spans[owners] = True
        mask &= ok_spans
    return mask


def _resolve_tag_predicates(req: SearchRequest, d):
    """tags dict -> {'span_eq': [(col, codes)], 'attr': [(key_code, val_codes)]}.

    Returns None if some predicate can never match in this block
    (string absent from dictionary -> zero hits, skip all IO).
    """
    span_eq = []
    attr = []
    for k, v in req.tags.items():
        v = str(v)
        if k in ("name", "root.name"):
            code = d.get(v)
            if code is None:
                return None
            span_eq.append(("name", np.array([code], np.uint32)))
        elif k in ("service.name", "root.service.name", "service"):
            code = d.get(v)
            if code is None:
                return None
            span_eq.append(("service", np.array([code], np.uint32)))
        elif k == "http.method":
            code = d.get(v)
            if code is None:
                return None
            span_eq.append(("http_method", np.array([code], np.uint32)))
        elif k == "http.url":
            code = d.get(v)
            if code is None:
                return None
            span_eq.append(("http_url", np.array([code], np.uint32)))
        elif k == "http.status_code":
            try:
                status = int(v)
            except ValueError:
                return None  # non-numeric status can never match
            span_eq.append(("http_status", np.array([status], np.uint32)))
        else:
            kc = d.get(k)
            vc = d.get(v)
            if kc is None or vc is None:
                return None
            attr.append((np.uint32(kc), np.array([vc], np.uint32)))
    return {"span_eq": span_eq, "attr": attr}
