"""Port of tempo_tpu/util/queryshape.py, copied as is (host code).

Literal-stripped query *shapes* — the one shared definition.

Two subsystems group queries by shape and MUST agree by construction:

  * the query-insights log (util/insights.py) groups its records by
    normalized shape so the ring bounds memory and operators see
    "which shape is slow", and
  * the compiled-query tier (tempo_tpu_torch/compiled/) keys its executable
    cache by the same shape — a dashboard refresh with new literals or
    a shifted time range must land on the SAME cache entry, because
    the lowered program takes literals and time bounds as runtime
    arguments.

If the two normalizers ever diverged, the insights log would report a
hit rate for a different key space than the cache actually uses, so
the regexes live here and insights re-exports them.
"""

from __future__ import annotations

import re

# Version of THIS normalizer's key space. The result cache prefixes
# every key with it (rc{format}|qs{keyspace}|...), so any change to the
# regexes or normalize_* functions below MUST bump it: a silent
# normalizer change would otherwise map new queries onto old cache
# entries and serve stale partials. tests/test_queryshape.py pins the
# current value against a golden shape corpus.
KEYSPACE_VERSION = 1

# literals in TraceQL / tag expressions -> "?" so records group by shape
_STR_RE = re.compile(r'"(?:[^"\\]|\\.)*"|`[^`]*`')
_NUM_RE = re.compile(r"\b\d+(?:\.\d+)?(?:ns|us|ms|s|m|h)?\b")


def normalize_query(q: str) -> str:
    """Strip literal values from a TraceQL query, keep its shape."""
    q = _STR_RE.sub('"?"', q)
    q = _NUM_RE.sub("?", q)
    return " ".join(q.split())


def normalize_search(req) -> str:
    """Normalized form of a tag-search request: TraceQL shape when a
    query rides it, else the sorted tag-key skeleton."""
    if getattr(req, "query", ""):
        return normalize_query(req.query)
    keys = ",".join(sorted(getattr(req, "tags", {}) or {}))
    parts = [f"tags:{keys or '<none>'}"]
    if getattr(req, "min_duration_ns", 0) or getattr(req, "max_duration_ns", 0):
        parts.append("duration:?")
    return " ".join(parts)


def metrics_shape(query: str) -> str:
    """Cache key for a query_range plan: kind-tagged normalized shape."""
    return "query_range|" + normalize_query(query)


def search_shape(req) -> str:
    """Cache key for a search request: kind-tagged normalized shape."""
    return "search|" + normalize_search(req)


def query_literals(q: str) -> list[str]:
    """The literals normalize_query strips, in source order — the shape
    plus this list round-trips a query's identity, so the result cache
    fingerprints (shape, literals) instead of raw text: two queries that
    differ only in whitespace share an entry, two that differ in any
    literal never do."""
    out = list(_STR_RE.findall(q))
    out.extend(_NUM_RE.findall(_STR_RE.sub('"?"', q)))
    return out
