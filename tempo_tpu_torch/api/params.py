"""Search/query HTTP parameter schema.

Reference: pkg/api/http.go — ParseSearchRequest:89 (q, tags as logfmt,
minDuration/maxDuration as Go durations, start/end unix seconds, limit),
ParseSearchBlockRequest:213 / BuildSearchBlockRequest:361 (adds blockID,
startPage, pagesToSearch, version, size, footerSize — the sub-request a
frontend shard sends a querier), ParseTraceID from the /api/traces/{id}
path, and ValidateAndSanitizeRequest:428.

Port of tempo_tpu/api/params.py, with the standing-query read request
and the graph request (GraphRequest, parse_graph_request).
"""

from __future__ import annotations

import binascii
import re
from dataclasses import dataclass

from tempo_tpu_torch.encoding.common import SearchRequest

PATH_PREFIX = "/api"
PATH_TRACES = "/api/traces"  # + /{traceID}
PATH_SEARCH = "/api/search"
PATH_SEARCH_TAGS = "/api/search/tags"
PATH_SEARCH_TAG_VALUES = "/api/search/tag"  # + /{name}/values
PATH_METRICS_QUERY_RANGE = "/api/metrics/query_range"
PATH_METRICS_STANDING = "/api/metrics/standing"  # + /{id}[/state]
PATH_USAGE = "/api/usage"  # tenant-scoped cost rollup
# trace-graph analytics plane (tempo_tpu_torch/graph)
PATH_GRAPH_DEPENDENCIES = "/api/graph/dependencies"
PATH_GRAPH_CRITICAL_PATH = "/api/graph/critical-path"
PATH_GRAPH_WALKS = "/api/graph/walks"
PATH_QUERY_INSIGHTS = "/api/query-insights"  # tenant-scoped query records
PATH_RCA = "/api/rca"  # + /{incidentID} — auto-RCA incident records
PATH_ECHO = "/api/echo"

_DUR_RE = re.compile(r"([0-9]*\.?[0-9]+)(ns|us|µs|ms|s|m|h)")
_DUR_NS = {"ns": 1, "us": 1_000, "µs": 1_000, "ms": 10**6, "s": 10**9, "m": 60 * 10**9, "h": 3600 * 10**9}


class BadRequest(ValueError):
    """Maps to HTTP 400."""


def parse_duration_ns(s: str) -> int:
    """Go-style duration string ("1h30m", "250ms", "1.5s") → nanoseconds."""
    s = (s or "").strip()
    if not s:
        return 0
    if s.isdigit():  # bare integer = nanoseconds (time.ParseDuration rejects
        # these, but being lenient here costs nothing)
        return int(s)
    pos = 0
    total = 0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            raise BadRequest(f"invalid duration {s!r}")
        total += int(float(m.group(1)) * _DUR_NS[m.group(2)])
        pos = m.end()
    if pos != len(s):
        raise BadRequest(f"invalid duration {s!r}")
    return total


def parse_logfmt_tags(s: str) -> dict:
    """Parse the `tags` param: logfmt key=value pairs
    (reference: ParseSearchRequest uses go-logfmt, http.go:120-140)."""
    tags: dict = {}
    i, n = 0, len(s)
    while i < n:
        while i < n and s[i].isspace():
            i += 1
        if i >= n:
            break
        eq = s.find("=", i)
        if eq < 0:
            raise BadRequest(f"invalid tags {s!r}: missing '='")
        key = s[i:eq].strip()
        i = eq + 1
        if i < n and s[i] == '"':
            j = i + 1
            val = []
            while j < n and s[j] != '"':
                if s[j] == "\\" and j + 1 < n:
                    j += 1
                val.append(s[j])
                j += 1
            if j >= n:
                raise BadRequest(f"invalid tags {s!r}: unterminated quote")
            value = "".join(val)
            i = j + 1
        else:
            j = i
            while j < n and not s[j].isspace():
                j += 1
            value = s[i:j]
            i = j
        if not key:
            raise BadRequest(f"invalid tags {s!r}: empty key")
        tags[key] = value
    return tags


def parse_time_range(start, end, step=None, *, require_range: bool = False,
                     now_s: int | None = None,
                     default_window_s: int = 3600) -> tuple[int, int, int]:
    """Shared start/end/step validation for search and query_range.

    start/end are unix seconds, step in seconds; all accept str or int.
    Inverted ranges are rejected (BadRequest -> 400) instead of
    silently returning empty. With require_range=True (query_range) the
    range is mandatory and defaulted — end=now, start=end-1h, step
    sized to ~120 points — and step must be positive; without it
    (search) 0 means unbounded and step is not defaulted.
    """
    import time as _time

    try:
        start_s = int(start or 0)
        end_s = int(end or 0)
        step_s = int(step or 0)
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid time range: {e}") from None
    if start_s < 0 or end_s < 0 or step_s < 0:
        raise BadRequest("start/end/step must be non-negative")
    if require_range:
        if not end_s:
            end_s = int(now_s if now_s is not None else _time.time())
        if not start_s:
            start_s = end_s - default_window_s
        if start_s < 0:
            raise BadRequest("start must be non-negative")
        if not step_s:
            step_s = max(1, (end_s - start_s) // 120)
        if step_s <= 0:
            raise BadRequest("step must be positive")
    if start_s and end_s and end_s <= start_s:
        raise BadRequest("http parameter start must be before end")
    return start_s, end_s, step_s


def _first(qs: dict, key: str, default: str = "") -> str:
    v = qs.get(key)
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return v[0] if v else default
    return v


def parse_search_request(qs: dict) -> SearchRequest:
    """qs: dict of query params (values str or list[str])."""
    req = SearchRequest()
    req.query = _first(qs, "q")
    tags = _first(qs, "tags")
    if tags:
        req.tags = parse_logfmt_tags(tags)
    # individual k=v params also accepted as tags (reference behavior for
    # the non-logfmt form: any unreserved param is a tag)
    reserved = {
        "q",
        "tags",
        "minDuration",
        "maxDuration",
        "start",
        "end",
        "limit",
        "spss",
        # block sub-request + trace-by-id shard params are not tags
        "blockID",
        "startRowGroup",
        "rowGroups",
        "version",
        "size",
        "mode",
        "blockStart",
        "blockEnd",
    }
    for k in qs:
        if k not in reserved and not k.startswith("_"):
            req.tags.setdefault(k, _first(qs, k))
    req.min_duration_ns = parse_duration_ns(_first(qs, "minDuration"))
    req.max_duration_ns = parse_duration_ns(_first(qs, "maxDuration"))
    if req.max_duration_ns and req.min_duration_ns > req.max_duration_ns:
        raise BadRequest("invalid maxDuration: must be greater than minDuration")
    req.start_seconds, req.end_seconds, _ = parse_time_range(
        _first(qs, "start", "0"), _first(qs, "end", "0")
    )
    try:
        req.limit = int(_first(qs, "limit", "20"))
    except ValueError as e:
        raise BadRequest(str(e)) from None
    if req.limit <= 0:
        raise BadRequest("invalid limit: must be a positive number")
    return req


@dataclass
class SearchBlockRequest:
    """One frontend shard job against a single block
    (reference: api.SearchBlockRequest, the querier/serverless contract)."""

    search: SearchRequest
    block_id: str = ""
    start_row_group: int = 0
    row_groups: int = 0  # 0 = all remaining
    version: str = ""
    size_bytes: int = 0


def parse_search_block_request(qs: dict) -> SearchBlockRequest:
    req = SearchBlockRequest(search=parse_search_request(qs))
    req.block_id = _first(qs, "blockID")
    if not req.block_id:
        raise BadRequest("blockID required")
    try:
        req.start_row_group = int(_first(qs, "startRowGroup", "0"))
        req.row_groups = int(_first(qs, "rowGroups", "0"))
        req.size_bytes = int(_first(qs, "size", "0"))
    except ValueError as e:
        raise BadRequest(str(e)) from None
    if req.start_row_group < 0:
        raise BadRequest("startRowGroup must be non-negative")
    req.version = _first(qs, "version")
    return req


def build_search_block_params(req: SearchBlockRequest) -> dict:
    """Inverse of parse_search_block_request (reference:
    BuildSearchBlockRequest http.go:361)."""
    qs: dict = {}
    s = req.search
    if s.query:
        qs["q"] = s.query
    if s.tags:
        qs["tags"] = " ".join(
            f'{k}="{v}"' if any(c.isspace() for c in str(v)) else f"{k}={v}" for k, v in s.tags.items()
        )
    if s.min_duration_ns:
        qs["minDuration"] = f"{s.min_duration_ns}ns"
    if s.max_duration_ns:
        qs["maxDuration"] = f"{s.max_duration_ns}ns"
    if s.start_seconds:
        qs["start"] = str(s.start_seconds)
    if s.end_seconds:
        qs["end"] = str(s.end_seconds)
    qs["limit"] = str(s.limit)
    qs["blockID"] = req.block_id
    qs["startRowGroup"] = str(req.start_row_group)
    qs["rowGroups"] = str(req.row_groups)
    if req.version:
        qs["version"] = req.version
    if req.size_bytes:
        qs["size"] = str(req.size_bytes)
    return qs


@dataclass
class QueryRangeRequest:
    """One /api/metrics/query_range request (reference: api.QueryRangeRequest
    — q, start, end, step, plus engine knobs)."""

    query: str = ""
    start_s: int = 0
    end_s: int = 0
    step_s: int = 0
    max_series: int = 64
    exemplars: int = 0


def parse_query_range_request(qs: dict, now_s: int | None = None) -> QueryRangeRequest:
    """q + start/end (unix seconds) + step (seconds or Go duration).
    Range is mandatory-with-defaults and validated by parse_time_range."""
    req = QueryRangeRequest()
    req.query = _first(qs, "q") or _first(qs, "query")
    if not req.query:
        raise BadRequest("q is required")
    step_raw = _first(qs, "step")
    step_s = 0
    if step_raw:
        if step_raw.lstrip("-").isdigit():
            step_s = int(step_raw)
        else:
            ns = parse_duration_ns(step_raw)
            step_s = ns // 10**9
            if ns and not step_s:
                raise BadRequest("step must be at least 1s")
        if step_s <= 0:
            # explicit zero/negative step is a client error (the
            # Prometheus API contract); only an ABSENT step defaults
            raise BadRequest("step must be positive")
    req.start_s, req.end_s, req.step_s = parse_time_range(
        _first(qs, "start", "0"), _first(qs, "end", "0"), step_s,
        require_range=True, now_s=now_s,
    )
    try:
        req.max_series = int(_first(qs, "maxSeries", "64"))
        req.exemplars = int(_first(qs, "exemplars", "0"))
    except ValueError as e:
        raise BadRequest(str(e)) from None
    if req.max_series <= 0:
        raise BadRequest("maxSeries must be positive")
    if req.exemplars < 0:
        raise BadRequest("exemplars must be non-negative")
    return req


@dataclass
class GraphRequest:
    query: str = ""
    start_s: int = 0
    end_s: int = 0
    by: str = "service"  # critical-path attribution: service | name
    # walk sampler knobs (graph/walks.py)
    walks: int = 32
    steps: int = 6
    seed: int = 0
    window_s: int = 0
    start_node: str | None = None


def parse_graph_request(qs: dict) -> GraphRequest:
    """Params of the /api/graph/* endpoints: optional TraceQL spanset
    filter `q` selecting the root set, optional start/end (unix s), and
    the critical-path/walk knobs. An empty q means every trace in range."""
    req = GraphRequest()
    req.query = _first(qs, "q") or _first(qs, "query")
    req.start_s, req.end_s, _ = parse_time_range(
        _first(qs, "start", "0"), _first(qs, "end", "0"))
    req.by = _first(qs, "by", "service")
    try:
        req.walks = int(_first(qs, "walks", "32"))
        req.steps = int(_first(qs, "steps", "6"))
        req.seed = int(_first(qs, "seed", "0"))
        req.window_s = int(_first(qs, "window", "0"))
    except ValueError as e:
        raise BadRequest(str(e)) from None
    if req.walks < 0 or req.walks > 4096:
        raise BadRequest("walks must be in [0, 4096]")
    if req.steps < 1 or req.steps > 256:
        raise BadRequest("steps must be in [1, 256]")
    if req.window_s < 0:
        raise BadRequest("window must be non-negative")
    req.start_node = _first(qs, "from") or None
    return req


def parse_trace_id(path_tail: str) -> bytes:
    """Hex trace ID (up to 32 hex chars, left-padded; reference:
    util.HexStringToTraceID)."""
    s = path_tail.strip().lower()
    if not s or len(s) > 32 or not re.fullmatch(r"[0-9a-f]+", s):
        raise BadRequest(f"invalid trace id {path_tail!r}")
    if len(s) % 2:
        s = "0" + s
    return binascii.unhexlify(s).rjust(16, b"\x00")


@dataclass
class StandingReadRequest:
    """GET /api/metrics/standing/{id}: optional start/end/step — all
    default to the registration's own window/grid."""

    start_s: int = 0
    end_s: int = 0
    step_s: int = 0


def parse_standing_read_request(qs: dict) -> StandingReadRequest:
    req = StandingReadRequest()
    try:
        req.start_s = int(_first(qs, "start", "0"))
        req.end_s = int(_first(qs, "end", "0"))
    except ValueError as e:
        raise BadRequest(str(e)) from None
    step_raw = _first(qs, "step")
    if step_raw:
        if step_raw.lstrip("-").isdigit():
            req.step_s = int(step_raw)
        else:
            req.step_s = parse_duration_ns(step_raw) // 10**9
        if req.step_s <= 0:
            raise BadRequest("step must be positive")
    if req.start_s < 0 or req.end_s < 0:
        raise BadRequest("start/end must be non-negative")
    if req.end_s and req.start_s and req.end_s <= req.start_s:
        raise BadRequest("end must be after start")
    return req
