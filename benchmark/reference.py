"""The plain reference: what each served answer should be, worked out in
NumPy from the generated span columns alone.

It imports nothing of the program and nothing of JAX. The semantics are
Tempo's as the port serves them:

- a condition holds on a span; values are compared as strings against
  the span's name, service, HTTP method and string attributes, the status
  code as a number, the duration in nanoseconds; regular expressions
  match anywhere in the string;
- `query_range` counts each stored span that meets every condition, in
  the bin `(start - range start) // step`, over every block: a trace that
  two blocks both hold (a replication factor of 2's copies) counts in
  each; `rate` is the count over the step in seconds;
- compaction keeps each span that its input blocks hold once, however
  many of them hold it.
"""

from __future__ import annotations

import re

import numpy as np

from benchmark import spans

UNITS_NS = {"ns": 1, "us": 10**3, "ms": 10**6, "s": 10**9, "m": 60 * 10**9}
ATTR_FIELDS = {"span." + k: k for k in spans.ATTR_KEYS}
SPAN_FIELDS = {"resource.service.name": "service", "service.name": "service",
               "name": "name", "span.http.method": "http_method", "http.method": "http_method",
               "span.http.status_code": "http_status", "http.status_code": "http_status",
               "duration": "duration_nano"}


def duration_ns(text: str) -> int:
    m = re.fullmatch(r"(\d+)(ns|us|ms|s|m)", text)
    if m is None:
        raise ValueError(f"bad duration {text!r}")
    return int(m.group(1)) * UNITS_NS[m.group(2)]


def _strings_matching(op: str, value: str) -> np.ndarray:
    """Codes of STRINGS for which `string op value` holds."""
    if op in ("=", "!="):
        hit = np.array([s == value for s in spans.STRINGS])
    else:
        rx = re.compile(value)
        hit = np.array([rx.search(s) is not None for s in spans.STRINGS])
    if op in ("!=", "!~"):
        hit = ~hit
    hit[0] = False  # an absent string meets no condition
    return hit


def _compare(values: np.ndarray, op: str, bound: int) -> np.ndarray:
    return {"=": values == bound, "!=": values != bound, ">": values > bound,
            ">=": values >= bound, "<": values < bound, "<=": values <= bound}[op]


def condition_mask(block: dict, field: str, op: str, value) -> np.ndarray:
    """Spans of the block that meet one condition."""
    cols, attrs = block["cols"], block["attrs"]
    n = len(cols["trace_id"])
    if field == "duration":
        ns = value if isinstance(value, int) else duration_ns(value)
        return _compare(cols["duration_nano"].astype(np.int64), op, ns)
    col = SPAN_FIELDS.get(field)
    if col == "http_status":
        return _compare(cols["http_status"].astype(np.int64), op, int(value))
    if col is not None:
        return _strings_matching(op, str(value))[cols[col]]
    key = ATTR_FIELDS.get(field, field)
    kcode = spans.code(key)
    rows = attrs["attr_key"] == kcode
    rows &= attrs["attr_vtype"] == spans.VT_STR
    if op in ("=", "=~"):
        rows &= _strings_matching(op, str(value))[attrs["attr_str"]]
        out = np.zeros(n, bool)
        out[attrs["attr_span"][rows]] = True
        return out
    raise ValueError(f"unsupported condition {field} {op}")


def where_mask(block: dict, where: list) -> np.ndarray:
    mask = np.ones(len(block["cols"]["trace_id"]), bool)
    for field, op, value in where:
        mask &= condition_mask(block, field, op, value)
    return mask


def range_counts(blocks: list, where: list, start_s: int, end_s: int, step_s: int) -> np.ndarray:
    """Matching spans a bin, over every block."""
    n_bins = -(-(end_s - start_s) // step_s)
    counts = np.zeros(n_bins, np.int64)
    for block in blocks:
        t = block["cols"]["start_unix_nano"].astype(np.int64) - start_s * 10**9
        ok = where_mask(block, where) & (t >= 0)
        bins = t[ok] // (step_s * 10**9)
        counts += np.bincount(bins[bins < n_bins], minlength=n_bins)
    return counts


def range_values(blocks: list, func: str, where: list, start_s: int, end_s: int,
                 step_s: int) -> np.ndarray:
    counts = range_counts(blocks, where, start_s, end_s, step_s).astype(np.float64)
    return counts / step_s if func == "rate" else counts


def hex_ids(tid: np.ndarray) -> list:
    return ["".join(f"{int(x):08x}" for x in row) for row in tid]


class RangeReference:
    """query_range counts a distinct query, worked out once."""

    def __init__(self, blocks: list):
        self.blocks = blocks
        self._cache: dict = {}

    def counts(self, spec: dict) -> np.ndarray:
        key = repr((spec["where"], spec["start"], spec["end"], spec["step"]))
        if key not in self._cache:
            self._cache[key] = range_counts(self.blocks, spec["where"], spec["start"],
                                            spec["end"], spec["step"])
        return self._cache[key]


def judge_query_range(ref: RangeReference, spec: dict, result: list,
                      counts: np.ndarray | None = None) -> float:
    """Widest gap, in spans, between a served bin and the reference's
    count (a rate times the step); inf for a malformed matrix. counts, if
    given, stands in for the reference's."""
    want = ref.counts(spec) if counts is None else counts
    if len(result) != 1 or len(result[0].get("values", [])) != len(want):
        return float("inf")
    ts = [int(t) for t, _ in result[0]["values"]]
    if ts != [spec["start"] + i * spec["step"] for i in range(len(want))]:
        return float("inf")
    got = np.array([float(v) for _, v in result[0]["values"]])
    if spec["func"] == "rate":
        got = got * spec["step"]
    return float(np.abs(got - want).max())


def span_keys(blocks: list) -> np.ndarray:
    """The distinct (trace ID, span ID) rows of the blocks, sorted: the
    spans that compacting them keeps."""
    return np.unique(np.concatenate(
        [np.concatenate([b["cols"]["trace_id"], b["cols"]["span_id"]], axis=1) for b in blocks]),
        axis=0)


def key_gap(got: np.ndarray, want: np.ndarray) -> int:
    """How far the (trace ID, span ID) rows got are from the distinct rows
    want: the difference of the counts, plus the distinct rows that only
    one side holds."""
    both = np.concatenate([np.unique(got, axis=0), want])
    _, n = np.unique(both, axis=0, return_counts=True)
    return abs(len(got) - len(want)) + int((n == 1).sum())


def trace_spans(block: dict, rows: np.ndarray) -> set:
    """Each row as (span ID hex, parent hex, start, duration, name, service)."""
    c = block["cols"]
    return {(hex_ids(c["span_id"][i:i + 1])[0], hex_ids(c["parent_span_id"][i:i + 1])[0],
             int(c["start_unix_nano"][i]), int(c["duration_nano"][i]),
             spans.STRINGS[int(c["name"][i])], spans.STRINGS[int(c["service"][i])])
            for i in rows}


def trace_of(blocks: list, tid: np.ndarray) -> set:
    """The distinct spans of trace tid over the blocks: a span that two
    blocks both hold once (what compaction keeps)."""
    out: set = set()
    for b in blocks:
        out |= trace_spans(b, np.flatnonzero((b["cols"]["trace_id"] == tid).all(axis=1)))
    return out
