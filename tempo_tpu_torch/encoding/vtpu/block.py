"""Backend block reader: trace-by-ID lookup, column fetch and the
zone-map / encoded-space helpers the metrics path uses.

Port of the read side of tempo_tpu/encoding/vtpu/block.py that the
block lifecycle needs: VtpuBackendBlock (index, dictionary, coalesced
column reads, bloom plan, find_trace_by_id, row materialization,
iter_trace_batches, scrub), EncodedColumn with its host rle/dct arms,
and the zone-map and condition lowering (_stats_admit, zone_prunes,
_numeric_range_prune, _lower_condition, _lower_attr_condition,
_string_codes). Tag search, the decoded-column cache with its resident
device tier, the page-heat ledger and the Prometheus counter families
arrive with later slices: reads here always fetch and decode (the
reference's column_cache=None path), and encoded-space predicates take
the host rle/dct arms, which the reference's resident arms equal bit for
bit. The per-block counters stay: bytes_read,
decoded_bytes, pruned_row_groups, coalesced_reads.

Reference analogs: tempodb/encoding/vparquet/block_findtracebyid.go
(bloom shard test then ID-column probe) and block_search.go.

Read path economy, in pruning order (cheapest veto first):
1. dictionary resolution — a string absent from the block dictionary
   kills the whole block before any index/page IO;
2. zone maps — per-row-group column stats in the index
   (fmt.RowGroupMeta.stats: numeric min/max + dictionary-code presence
   sets) skip row groups with ZERO backend reads;
3. encoded-space evaluation — predicates over rle/dct pages evaluate per
   run or per page-dictionary entry, never per row;
4. coalesced ranged reads — all pages needed together fetch as one
   gap-tolerant ranged read (pages of a row group are contiguous in
   data.bin).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from tempo_tpu_torch.backend.base import (
    BlockMeta,
    ColumnIndexName,
    DictionaryName,
    DataName,
    TypedBackend,
    bloom_name,
)
from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest
from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.encoding.vtpu import lightweight as lw
from tempo_tpu_torch.encoding.vtpu.codec import LIGHTWEIGHT_CODECS
from tempo_tpu_torch.model.columnar import ATTR_COLUMNS, SPAN_COLUMNS, SpanBatch
from tempo_tpu_torch.model.trace import Trace, batch_to_traces
from tempo_tpu_torch.ops import bloom, hashing, scan


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


class EncodedColumn:
    """Predicate/gather access to ONE column page in its encoded space
    (lightweight tier only — encoding/vtpu/lightweight.py).

    eq/in_set/between evaluate per RUN (rle) or per page-DICTIONARY
    entry (dct) and the verdict expands as one bool per row: the values
    of unselected runs are never materialized. Every operation reports
    what it materialized to the owning block's decoded_bytes counter.
    The search-side accessors (selective gather, the root-row test)
    arrive with the block search read path.
    """

    def __init__(self, blk: "VtpuBackendBlock", rg, name: str):
        self.blk = blk
        self.rg = rg
        self.name = name
        self.pm = rg.pages[name]
        self.codec = self.pm.codec
        self.n = self.pm.shape[0] if self.pm.shape else 0

    def _page(self) -> bytes:
        """Raw page bytes: one ranged read."""
        return self.blk._reader()(self.pm.offset, self.pm.length)

    def runs(self):
        """(values, lengths) of an rle page — the run-space read."""
        values, lengths = lw.rle_decode_runs(self._page(), self.pm.dtype, self.pm.shape)
        self.blk._account_decoded(values.nbytes + lengths.nbytes)
        return values, lengths

    def _dct_indices(self):
        values, idx = lw.dct_indices(self._page(), self.pm.dtype, self.pm.shape)
        # index expansion materializes no values: count the packed
        # stream's size (width bits per row), i.e. the encoded form
        w = max(values.shape[0] - 1, 0).bit_length()
        self.blk._account_decoded(values.nbytes + (self.n * w + 7) // 8)
        return values, idx

    # -- predicate evaluation in encoded space -------------------------
    def in_set_mask(self, codes: np.ndarray, invert: bool = False):
        """Row mask for `column in codes` (1-D columns), or None when
        this codec cannot answer without full decode (dbp)."""
        if self.codec == "rle":
            values, lengths = self.runs()
            return scan.expand_run_mask(
                scan.in_set_runs(values, codes, invert=invert), lengths, self.n)
        if self.codec == "dct":
            values, idx = self._dct_indices()
            hit = np.isin(values, codes, invert=invert)
            return hit[idx] if self.n else np.zeros(0, bool)
        return None

    def map_mask(self, fn) -> np.ndarray | None:
        """Row mask from an arbitrary per-VALUE boolean predicate: fn
        runs once per run (rle) or page-dictionary entry (dct) — never
        per row — and the verdict expands. fn must be elementwise (the
        same value always gets the same verdict), which is what makes
        the run verdict the row verdict."""
        if self.codec == "rle":
            values, lengths = self.runs()
            return scan.expand_run_mask(np.asarray(fn(values), bool), lengths, self.n)
        if self.codec == "dct":
            values, idx = self._dct_indices()
            hit = np.asarray(fn(values), bool)
            return hit[idx] if self.n else np.zeros(0, bool)
        return None


class VtpuBackendBlock:
    """Lazy reader over one block; caches index + dictionary. Every
    column read fetches and decodes (the decoded-column cache arrives
    with a later slice)."""

    def __init__(self, meta: BlockMeta, backend: TypedBackend, cfg: BlockConfig | None = None):
        self.meta = meta
        self.backend = backend
        self.cfg = cfg or BlockConfig()
        self._index: fmt.BlockIndex | None = None
        self._dict = None
        self.bytes_read = 0
        # read-path economy counters (per block instance)
        self.pruned_row_groups = 0
        self.coalesced_reads = 0  # backend round trips SAVED by coalescing
        # column value bytes materialized into row space by decode work;
        # run/dict-space reads count their encoded size, selective
        # gathers the rows/miniblocks touched
        self.decoded_bytes = 0
        # counter guard: a prefetcher may load row group N+1's columns on
        # a worker thread while the caller reads N's
        self._io_lock = threading.Lock()

    # ------------------------------------------------------------------
    def index(self) -> fmt.BlockIndex:
        if self._index is None:
            raw = self.backend.read_named(
                self.meta.tenant_id, self.meta.block_id, ColumnIndexName)
            self.bytes_read += len(raw)
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
            cols = self.read_columns(rg, list(rg.pages))
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
            raw = self.backend.read_named(
                self.meta.tenant_id, self.meta.block_id, DictionaryName)
            self.bytes_read += len(raw)
            self._dict = fmt.deserialize_dictionary(raw)
        return self._dict

    def _reader(self):
        def read(offset, length):
            with self._io_lock:
                self.bytes_read += length
            return self.backend.read_range_named(
                self.meta.tenant_id, self.meta.block_id, DataName, offset, length
            )

        return read

    def _account_decoded(self, nbytes: int) -> None:
        with self._io_lock:
            self.decoded_bytes += nbytes

    def read_columns(self, rg: fmt.RowGroupMeta, names: list[str]) -> dict[str, np.ndarray]:
        """Decoded column chunks, fetched with coalesced gap-tolerant
        ranged reads (one per page run, not one per page), accounting the
        round trips saved."""
        cols, n_reads, _ = fmt.read_columns_coalesced(self._reader(), rg, names)
        saved = len(names) - n_reads
        if saved > 0:
            with self._io_lock:
                self.coalesced_reads += saved
        self._account_decoded(sum(c.nbytes for c in cols.values()))
        return cols

    def encoded_column(self, rg: fmt.RowGroupMeta, name: str) -> EncodedColumn | None:
        """Encoded-space access to one column, or None when its page is
        on the entropy tier (or run-space evaluation is switched off)."""
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
