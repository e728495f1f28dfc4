"""Columnar span batches — the canonical in-memory trace representation.

The reference converts proto object trees to a columnar form only at
rest (vParquet schema, tempodb/encoding/vparquet/schema.go:77-175, one
row per trace with nested span lists + dedicated columns for well-known
attributes). Profiling showed that conversion and the object churn
around it dominate its compactor (the reference even calls runtime.GC()
inside the loop, vparquet/compactor.go). Here the columnar layout IS the
in-memory representation at every stage, so ingest -> WAL -> block ->
compaction -> query moves arrays, never object trees.

Layout: one row per span (flattened; resource-level values are
replicated into span rows as dictionary codes — cheap, they're uint32).
Well-known attributes get dedicated columns like vParquet does; the rest
live in a ragged attribute table (span index + key/value codes) that
maps directly onto device segment ops.

Host side is numpy (full uint64 fidelity for timestamps); `to_device`
produces padded fixed-shape jnp column dicts + valid mask, which is what
kernels and shard_map consume.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# attribute value types
VT_STR = 0
VT_INT = 1
VT_FLOAT = 2
VT_BOOL = 3

# attribute scopes
SCOPE_SPAN = 0
SCOPE_RESOURCE = 1

# fixed-width span columns: name -> (dtype, width or None for 1-D)
SPAN_COLUMNS = {
    "trace_id": (np.uint32, 4),  # big-endian limbs
    "span_id": (np.uint32, 2),
    "parent_span_id": (np.uint32, 2),
    "start_unix_nano": (np.uint64, None),
    "duration_nano": (np.uint64, None),
    "kind": (np.uint8, None),
    "status_code": (np.uint8, None),
    "name": (np.uint32, None),  # dictionary code
    "service": (np.uint32, None),  # dictionary code of resource service.name
    "http_status": (np.uint16, None),  # 0 when absent
    "http_method": (np.uint32, None),  # dictionary code, 0 when absent
    "http_url": (np.uint32, None),  # dictionary code, 0 when absent
}

# span columns holding dictionary codes (must be remapped when batches
# with different dictionaries merge)
CODE_COLUMNS = ("name", "service", "http_method", "http_url")

ATTR_COLUMNS = {
    "attr_span": (np.uint32, None),  # row index of owning span
    "attr_scope": (np.uint8, None),  # SCOPE_*
    "attr_key": (np.uint32, None),  # dictionary code
    "attr_vtype": (np.uint8, None),  # VT_*
    "attr_str": (np.uint32, None),  # dictionary code when VT_STR
    "attr_num": (np.float64, None),  # numeric value otherwise
}


class Dictionary:
    """Append-only string dictionary; code 0 is always the empty string.

    Fills the role of parquet dictionary encoding in the reference's
    column chunks, but is shared across all string columns of a batch so
    predicate pushdown resolves strings once (ops/scan.dict_codes_matching).
    """

    def __init__(self, entries: list[str] | None = None):
        self.entries: list[str] = [""]
        self._index: dict[str, int] = {"": 0}
        if entries:
            if entries[0] != "":
                raise ValueError("dictionary entry 0 must be the empty string")
            for e in entries[1:]:
                self.add(e)

    def add(self, s: str) -> int:
        code = self._index.get(s)
        if code is None:
            code = len(self.entries)
            self.entries.append(s)
            self._index[s] = code
        return code

    def get(self, s: str) -> int | None:
        """Code for s, or None if absent (lookup without insertion)."""
        return self._index.get(s)

    def add_many(self, values: list) -> np.ndarray:
        """Vectorized add: one code array for a whole column of strings,
        with hash/append work per UNIQUE string instead of per row (the
        receiver hot path encodes thousands of rows drawn from a handful
        of distinct names/services)."""
        if not values:
            return np.empty(0, dtype=np.uint32)
        arr = np.asarray(values, dtype=object)
        uniq, inv = np.unique(arr, return_inverse=True)
        codes = np.empty(len(uniq), dtype=np.uint32)
        for i, s in enumerate(uniq):
            codes[i] = self.add(s)
        return codes[inv].astype(np.uint32, copy=False)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, code: int) -> str:
        return self.entries[code]

    def remap_onto(self, other: "Dictionary") -> np.ndarray:
        """Merge self's entries into `other`; return old->new code table.

        The remap table is a gather array: device-side code columns are
        rewritten with one vectorized gather during batch concat /
        compaction (no string touches on the hot path).
        """
        table = np.empty(len(self.entries), dtype=np.uint32)
        for old_code, s in enumerate(self.entries):
            table[old_code] = other.add(s)
        return table


def trace_segmentation(tid: np.ndarray):
    """For trace-sorted ID rows (N,4): (new_mask, seg_ids, firsts).

    The shared idiom behind every span->trace rollup (search, fetch,
    live scan): new_mask flags the first row of each trace, seg_ids maps
    span row -> 0-based trace index, firsts lists first-row indices.
    """
    n = tid.shape[0]
    if n == 0:
        return np.empty(0, bool), np.empty(0, np.int64), np.empty(0, np.int64)
    new = np.ones(n, dtype=bool)
    new[1:] = (tid[1:] != tid[:-1]).any(axis=1)
    seg = np.cumsum(new) - 1
    return new, seg, np.flatnonzero(new)


def hit_trace_mask(seg: np.ndarray, span_mask: np.ndarray, n_traces: int) -> np.ndarray:
    """Trace-level any-span-matched rollup (numpy twin of
    ops.scan.spans_to_traces_any)."""
    hit = np.zeros(n_traces, bool)
    np.logical_or.at(hit, seg[span_mask], True)
    return hit


def _empty_cols(schema: dict) -> dict[str, np.ndarray]:
    out = {}
    for name, (dtype, width) in schema.items():
        shape = (0, width) if width else (0,)
        out[name] = np.empty(shape, dtype=dtype)
    return out


@dataclass
class SpanBatch:
    """Structure-of-arrays span batch + shared string dictionary."""

    cols: dict[str, np.ndarray] = field(default_factory=lambda: _empty_cols(SPAN_COLUMNS))
    attrs: dict[str, np.ndarray] = field(default_factory=lambda: _empty_cols(ATTR_COLUMNS))
    dictionary: Dictionary = field(default_factory=Dictionary)

    def __post_init__(self):
        self.validate()
        # lazy caches (batches are immutable by convention): trace
        # boundaries are recomputed by every consumer on the write path
        # (row-group slicing, block writer, compactor emit) — O(N) each
        # time over the same rows
        self._tb_cache: tuple[np.ndarray, np.ndarray] | None = None

    @property
    def num_spans(self) -> int:
        return int(self.cols["trace_id"].shape[0])

    @property
    def num_attrs(self) -> int:
        return int(self.attrs["attr_span"].shape[0])

    def validate(self):
        n = self.num_spans
        for name, (dtype, width) in SPAN_COLUMNS.items():
            c = self.cols[name]
            want = (n, width) if width else (n,)
            if c.shape != want or c.dtype != dtype:
                raise ValueError(f"column {name}: shape {c.shape} dtype {c.dtype}, want {want} {dtype}")
        m = self.num_attrs
        for name, (dtype, width) in ATTR_COLUMNS.items():
            c = self.attrs[name]
            if c.shape != (m,) or c.dtype != dtype:
                raise ValueError(f"attr column {name}: shape {c.shape} dtype {c.dtype}")
        if m and (n == 0 or self.attrs["attr_span"].max(initial=0) >= n):
            raise ValueError("attr_span references out-of-range span row")

    # ------------------------------------------------------------------
    # core transforms (all vectorized numpy; device variants live in the
    # encoding/compaction layers which own padding/static shapes)
    # ------------------------------------------------------------------

    def select(self, idx: np.ndarray) -> "SpanBatch":
        """New batch with span rows idx (in given order) + their attrs."""
        idx = np.asarray(idx)
        cols = {k: v[idx] for k, v in self.cols.items()}
        m = self.num_attrs
        if m:
            # map old span row -> new position (or -1 if dropped)
            pos = np.full(self.num_spans, -1, dtype=np.int64)
            pos[idx] = np.arange(idx.shape[0])
            owner = pos[self.attrs["attr_span"]]
            keep = owner >= 0
            attrs = {k: v[keep] for k, v in self.attrs.items()}
            attrs["attr_span"] = owner[keep].astype(np.uint32)
            order = np.argsort(attrs["attr_span"], kind="stable")
            attrs = {k: v[order] for k, v in attrs.items()}
        else:
            attrs = _empty_cols(ATTR_COLUMNS)
        return SpanBatch(cols=cols, attrs=attrs, dictionary=self.dictionary)

    def trace_sort_perm(self) -> np.ndarray:
        """Permutation ordering rows by (trace_id, span_id) — block
        storage order. Exposed so callers can reorder parallel arrays
        (masks) with the same permutation."""
        keys = np.concatenate([self.cols["trace_id"], self.cols["span_id"]], axis=1)
        return np.lexsort(tuple(keys[:, i] for i in reversed(range(keys.shape[1]))))

    def sorted_by_trace(self) -> "SpanBatch":
        """Rows ordered by (trace_id, span_id) — block storage order."""
        return self.select(self.trace_sort_perm())

    def trace_boundaries(self) -> tuple[np.ndarray, np.ndarray]:
        """(first_row_of_each_trace, segment_id_per_span); rows must be
        sorted by trace. Cached after the first call."""
        if self._tb_cache is None:
            _, seg, firsts = trace_segmentation(self.cols["trace_id"])
            self._tb_cache = (firsts, seg)
        return self._tb_cache

    @staticmethod
    def concat(batches: list["SpanBatch"]) -> "SpanBatch":
        """Concatenate batches, unioning dictionaries via gather remaps."""
        batches = [b for b in batches if b.num_spans > 0]
        if not batches:
            return SpanBatch()
        target = Dictionary()
        cols_out: dict[str, list[np.ndarray]] = {k: [] for k in SPAN_COLUMNS}
        attrs_out: dict[str, list[np.ndarray]] = {k: [] for k in ATTR_COLUMNS}
        row_base = 0
        for b in batches:
            remap = b.dictionary.remap_onto(target)
            for k in SPAN_COLUMNS:
                v = b.cols[k]
                if k in CODE_COLUMNS:
                    v = remap[v]
                cols_out[k].append(v)
            for k in ATTR_COLUMNS:
                v = b.attrs[k]
                if k in ("attr_key",):
                    v = remap[v]
                elif k == "attr_str":
                    # only remap codes of string-typed values
                    is_str = b.attrs["attr_vtype"] == VT_STR
                    v = np.where(is_str, remap[v], v).astype(np.uint32)
                elif k == "attr_span":
                    v = v + np.uint32(row_base)
                attrs_out[k].append(v)
            row_base += b.num_spans
        return SpanBatch(
            cols={k: np.concatenate(v) for k, v in cols_out.items()},
            attrs={k: np.concatenate(v) for k, v in attrs_out.items()},
            dictionary=target,
        )

    def pad_to(self, n: int) -> tuple["SpanBatch", np.ndarray]:
        """Pad span rows to length n; returns (padded batch, valid mask).

        Padding feeds static-shape device kernels (row groups are padded
        to bucket sizes so XLA compiles once per bucket — SURVEY.md 7.4
        'streaming vs static shapes').
        """
        cur = self.num_spans
        if n < cur:
            raise ValueError(f"pad_to({n}) smaller than batch ({cur})")
        valid = np.zeros(n, dtype=bool)
        valid[:cur] = True
        if n == cur:
            return self, valid
        cols = {}
        for k, v in self.cols.items():
            pad_shape = (n - cur,) + v.shape[1:]
            cols[k] = np.concatenate([v, np.zeros(pad_shape, dtype=v.dtype)])
        return SpanBatch(cols=cols, attrs=self.attrs, dictionary=self.dictionary), valid

    def nbytes(self) -> int:
        n = sum(v.nbytes for v in self.cols.values())
        n += sum(v.nbytes for v in self.attrs.values())
        n += sum(len(e) for e in self.dictionary.entries)
        return n

    def end_unix_nano(self) -> np.ndarray:
        return self.cols["start_unix_nano"] + self.cols["duration_nano"]
