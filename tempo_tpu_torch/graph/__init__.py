"""Trace-graph analytics: cross-block service graphs + critical paths.

Port of tempo_tpu/graph/__init__.py: the same edge semantics, root-set
selection, wires, merges and finalizers, and the same metric families.
cp_partial takes `device`, the torch device whose arm sums the root
paths (the querier passes its DB's: the root_path_sums kernel on the
card, the host arm on the CPU; ops/graph.py).

The reference computes service-dependency edges only in the live
metrics-generator (modules/generator/processor/servicegraphs — edges
exist for ~10s of paired spans in the expiring store, then evaporate);
the stored blocks, which hold months of parent/child structure, answer
no graph question. This module is the stored-block graph engine:

- ONE definition of edge semantics (edge pairing rule, failure
  classification, edge-key hashing) shared by the live processor and
  the stored aggregation, so the two planes cannot drift;
- per-block aggregation producing integer, psum-mergeable partials
  (edge counts + ops/sketch.HistogramPlan latency sketches; per-group
  critical-path nanoseconds), merged shard-wise through the frontend's
  `_run_jobs` seam exactly like the metrics partials — results are
  bit-identical at any shard count because every partial merges by
  integer addition / min / max;
- the device critical-path kernel lives in ops/graph.py (pointer
  doubling over (parent_idx, duration) arrays, host/device
  bit-identical); the temporal random-walk sampler in graph/walks.py.

An edge exists when a SERVER span's parent is a CLIENT span from
another service (reference: servicegraphs.go consume); its latency is
the server span's duration, its failure the server span's error status.
"""

from __future__ import annotations

import hashlib

import numpy as np

from tempo_tpu_torch.model.columnar import ATTR_COLUMNS, _empty_cols, trace_segmentation
from tempo_tpu_torch.model.trace import KIND_CLIENT, KIND_SERVER, STATUS_ERROR
from tempo_tpu_torch.ops.sketch import HistogramPlan, np_hist_quantile
from tempo_tpu_torch.util import metrics

# latency-sketch plan for edge histograms and critical-path totals:
# nanosecond domain, <= 1/8 relative bucket width (the query_range
# quantile contract; counts are uint and merge by addition)
GRAPH_HIST = HistogramPlan()

# columns every graph aggregation reads (one coalesced projection)
GRAPH_COLUMNS = [
    "trace_id", "span_id", "parent_span_id", "kind", "status_code",
    "service", "name", "start_unix_nano", "duration_nano",
]

EDGE_SEP = "\x1f"  # wire key separator: services cannot contain it

CP_BY = ("service", "name")

graph_edges_total = metrics.counter(
    "tempo_tpu_graph_edges_total",
    "Service-graph edge instances aggregated from stored/live spans",
)
graph_unpaired_total = metrics.counter(
    "tempo_tpu_graph_unpaired_spans_total",
    "Client/server spans that found no cross-service partner in their "
    "stored trace (the stored-block analog of the live processor's "
    "expired-unpaired accounting)",
)
graph_queries_total = metrics.counter(
    "tempo_tpu_graph_queries_total",
    "Graph-plane queries served, by endpoint kind",
)


# ---------------------------------------------------------------------------
# shared live/stored edge semantics (satellite: extracted from
# ServiceGraphsProcessor so generator and stored aggregation agree)
# ---------------------------------------------------------------------------


def spans_failed(status_codes: np.ndarray) -> np.ndarray:
    """Vectorized failed-request classification for service-graph edges
    (ONE definition for the live processor and the stored aggregation)."""
    return np.asarray(status_codes) == STATUS_ERROR


def span_failed(status_code: int) -> bool:
    return bool(spans_failed(np.array([status_code]))[0])


def edge_hash_limbs(client_svc: str, server_svc: str) -> np.ndarray:
    """(4,) uint32 sketch key for one edge. Hashes the full pair so long
    client names don't truncate away the server half of the key."""
    digest = hashlib.blake2s(
        (client_svc + "\x00" + server_svc).encode(), digest_size=16
    ).digest()
    return np.frombuffer(digest, dtype=">u4").astype(np.uint32)


# ---------------------------------------------------------------------------
# root-set selection (TraceQL spanset filters)
# ---------------------------------------------------------------------------


def parse_root_filter(q: str):
    """Parse the root-set query: a pure spanset-filter pipeline
    (`{ .service.name = "api" }`); anything with pipeline stages beyond
    filters (by/select/aggregates/metrics) is a client error. Returns
    None for the match-everything empty query."""
    if not q or q.strip() in ("", "{}"):
        return None
    from tempo_tpu_torch.traceql import ast_nodes as A
    from tempo_tpu_torch.traceql import parse

    pipeline = parse(q)
    for st in pipeline.stages:
        if not isinstance(st, A.SpansetFilter):
            raise ValueError(
                "graph queries select their root set with spanset filters "
                "only ({ ... }); pipeline stages like by()/select()/"
                "aggregates/metrics are not supported here"
            )
    return pipeline


def _filter_mask(pipeline, view, d) -> np.ndarray:
    from tempo_tpu_torch.traceql import vector

    mask = np.ones(view.num_spans, bool)
    for st in pipeline.stages:
        mask &= vector.filter_mask(st.expr, view, d)
    return mask


def _member_rows(tid: np.ndarray, hit: np.ndarray) -> np.ndarray:
    """(N,) bool: row's trace id is in the hit set. Exact vectorized
    membership via the shared unique-rank idiom (no 128-bit packing)."""
    if not len(hit):
        return np.zeros(len(tid), bool)
    allk = np.concatenate([hit, tid])
    uniq, inv = np.unique(allk, axis=0, return_inverse=True)
    is_hit = np.zeros(len(uniq), bool)
    is_hit[inv[: len(hit)]] = True
    return is_hit[inv[len(hit):]]


def collect_block_rows(blk, pipeline, start_s: int = 0, end_s: int = 0,
                       stats: dict | None = None) -> dict | None:
    """Two-pass root-set collection over one backend block.

    Pass 1 (zone-map pruned, projection-limited) finds the hit traces:
    traces with >= 1 span matching the filter inside the time window.
    Pass 2 gathers GRAPH_COLUMNS for EVERY span of those traces across
    all row groups — graph structure needs whole traces, so the window/
    filter select traces, never clip their spans. Returns a trace-sorted
    column dict (traces straddling row groups stay contiguous because
    row groups are scanned in order), or None when nothing matches."""
    from tempo_tpu_torch.encoding.vtpu.block import (
        _lower_condition,
        pruned_row_groups_total,
        zone_maps_enabled,
    )
    from tempo_tpu_torch.encoding.vtpu import format as fmt
    from tempo_tpu_torch.traceql import vector

    d = blk.dictionary()
    index = blk.index()
    windowed = bool(start_s or end_s)
    hit = None  # None = every trace
    if pipeline is not None or windowed:
        resolvers, all_conds = [], True
        if pipeline is not None:
            spec = pipeline.conditions()
            all_conds = spec.all_conditions
            for cond in spec.conditions:
                r = _lower_condition(cond, d)
                if r == "impossible":
                    if all_conds:
                        return None  # a filter literal absent from the
                        # dictionary: zero IO, block contributes nothing
                    continue
                if r is None:
                    if not all_conds:
                        resolvers = []
                        break  # OR with an opaque arm: no sound pruning
                    continue
                resolvers.append(r)
        zm = zone_maps_enabled()
        span_cols, needs_attrs = (
            vector.needed_columns(pipeline) if pipeline is not None else ([], False)
        )
        names = sorted(set(span_cols) | {"trace_id", "start_unix_nano"})
        hits: list[np.ndarray] = []
        for rg in index.row_groups:
            if start_s and rg.end_s < start_s:
                continue
            if end_s and rg.start_s > end_s:
                continue
            if zm and resolvers:
                hooks = [r.prune(rg) for r in resolvers
                         if getattr(r, "prune", None) is not None]
                pruned = (any(hooks) if all_conds
                          else bool(hooks) and len(hooks) == len(resolvers) and all(hooks))
                if pruned:
                    if stats is not None:
                        stats["prunedRowGroups"] = stats.get("prunedRowGroups", 0) + 1
                    pruned_row_groups_total.inc()
                    continue
            cols = blk.read_columns(rg, names)
            mask = np.ones(rg.n_spans, bool)
            if pipeline is not None:
                attrs = (blk.read_columns(rg, list(ATTR_COLUMNS))
                         if needs_attrs else _empty_cols(ATTR_COLUMNS))
                view = vector.ColumnView(cols, attrs, rg.n_spans)
                mask &= _filter_mask(pipeline, view, d)
            if windowed:
                starts = cols["start_unix_nano"]
                if start_s:
                    mask &= starts >= np.uint64(start_s * 10**9)
                if end_s:
                    mask &= starts <= np.uint64(end_s * 10**9)
            if mask.any():
                hits.append(np.unique(cols["trace_id"][mask], axis=0))
        if not hits:
            return None
        hit = np.unique(np.concatenate(hits), axis=0)

    out: dict[str, list] = {c: [] for c in GRAPH_COLUMNS}
    collected = 0
    for rg in index.row_groups:
        if hit is not None:
            # blocks are trace-sorted, so the row group's [min,max] id
            # range vs the hit set's hull prunes collection reads
            if (rg.max_id < fmt.id_to_hex(hit[0])
                    or rg.min_id > fmt.id_to_hex(hit[-1])):
                continue
        cols = blk.read_columns(rg, GRAPH_COLUMNS)
        if stats is not None:
            stats["inspectedSpans"] = stats.get("inspectedSpans", 0) + rg.n_spans
        rows = (np.arange(rg.n_spans) if hit is None
                else np.flatnonzero(_member_rows(cols["trace_id"], hit)))
        if not len(rows):
            continue
        collected += len(rows)
        for c in GRAPH_COLUMNS:
            out[c].append(cols[c][rows])
    if not collected:
        return None
    return {c: np.concatenate(parts) for c, parts in out.items()}


def batch_graph_rows(batch, pipeline, start_s: int = 0, end_s: int = 0) -> dict | None:
    """Root-set collection over one in-memory SpanBatch (the live/
    recent path): same trace-selection semantics as collect_block_rows."""
    sb = batch.sorted_by_trace()
    n = sb.num_spans
    if n == 0:
        return None
    d = sb.dictionary
    mask = np.ones(n, bool)
    if pipeline is not None:
        mask &= _filter_mask(pipeline, sb, d)
    starts = sb.cols["start_unix_nano"]
    if start_s:
        mask &= starts >= np.uint64(start_s * 10**9)
    if end_s:
        mask &= starts <= np.uint64(end_s * 10**9)
    if not mask.any():
        return None
    _, seg, _ = trace_segmentation(sb.cols["trace_id"])
    hit_traces = np.zeros(int(seg[-1]) + 1, bool)
    hit_traces[seg[mask]] = True
    rows = np.flatnonzero(hit_traces[seg])
    return {c: sb.cols[c][rows] for c in GRAPH_COLUMNS}


# ---------------------------------------------------------------------------
# dependency-edge partials
# ---------------------------------------------------------------------------


def new_deps_wire() -> dict:
    return {"edges": {}, "unpaired": 0, "stats": {}}


def deps_partial(cols: dict, d, wire: dict | None = None) -> dict:
    """Fold one trace-sorted column set into a dependency wire: rank-join
    child->parent, emit (client_service, server_service) edges with
    latency histogram sketches and failure counts — every field an
    integer (or min/max) so shard partials merge exactly."""
    from tempo_tpu_torch.ops import graph as ops_graph

    wire = wire if wire is not None else new_deps_wire()
    n = len(cols["kind"])
    if n == 0:
        return wire
    _, seg, _ = trace_segmentation(cols["trace_id"])
    pr = ops_graph.parent_row_join(seg, cols["span_id"], cols["parent_span_id"])
    kind = cols["kind"]
    svc = cols["service"]
    safe = np.maximum(pr, 0)
    is_server = kind == KIND_SERVER
    paired = is_server & (pr >= 0) & (kind[safe] == KIND_CLIENT)
    cross = paired & (svc[safe] != svc)
    # unpaired accounting, both halves: server spans with no client
    # parent, client spans no server child claimed
    claimed = np.zeros(n, bool)
    claimed[safe[paired]] = True
    unpaired = int(np.count_nonzero(is_server & ~paired))
    unpaired += int(np.count_nonzero((kind == KIND_CLIENT) & ~claimed))
    rows = np.flatnonzero(cross)
    if len(rows):
        k = np.int64(len(d) + 1)
        comb = svc[safe[rows]].astype(np.int64) * k + svc[rows]
        uniq, inv = np.unique(comb, return_inverse=True)
        buckets = GRAPH_HIST.np_bucket_of(cols["duration_nano"][rows])
        failed = spans_failed(cols["status_code"][rows])
        starts_s = (cols["start_unix_nano"][rows] // np.uint64(10**9)).astype(np.int64)
        edges = wire["edges"]
        for i, key in enumerate(uniq):
            m = inv == i
            ekey = d[int(key // k)] + EDGE_SEP + d[int(key % k)]
            hist = np.bincount(buckets[m], minlength=GRAPH_HIST.n_buckets)
            part = {
                "count": int(np.count_nonzero(m)),
                "failed": int(np.count_nonzero(failed & m)),
                "minStartS": int(starts_s[m].min()),
                "maxStartS": int(starts_s[m].max()),
                "hist": {str(b): int(c) for b, c in enumerate(hist) if c},
            }
            _merge_edge(edges, ekey, part)
    wire["unpaired"] += unpaired
    graph_edges_total.inc(len(rows))
    if unpaired:
        graph_unpaired_total.inc(unpaired)
    return wire


def _merge_edge(edges: dict, key: str, part: dict) -> None:
    have = edges.get(key)
    if have is None:
        edges[key] = {**part, "hist": dict(part["hist"])}
        return
    have["count"] += part["count"]
    have["failed"] += part["failed"]
    have["minStartS"] = min(have["minStartS"], part["minStartS"])
    have["maxStartS"] = max(have["maxStartS"], part["maxStartS"])
    h = have["hist"]
    for b, c in part["hist"].items():
        h[b] = h.get(b, 0) + c


def merge_deps_wire(dst: dict, src: dict | None) -> None:
    if not src:
        return
    for key, part in src.get("edges", {}).items():
        _merge_edge(dst["edges"], key, part)
    dst["unpaired"] += int(src.get("unpaired", 0))
    _merge_stats(dst["stats"], src.get("stats"))


def _merge_stats(dst: dict, src: dict | None) -> None:
    for k, v in (src or {}).items():
        dst[k] = dst.get(k, 0) + int(v)


def _hist_quantiles_ms(sparse: dict, qs=(0.5, 0.95, 0.99)) -> list[float]:
    dense = np.zeros(GRAPH_HIST.n_buckets, np.int64)
    for b, c in sparse.items():
        dense[int(b)] = int(c)
    vals = np_hist_quantile(dense, qs, GRAPH_HIST)  # upper edges, ns
    return [round(float(v) / 1e6, 3) if np.isfinite(v) else 0.0 for v in vals]


def finalize_deps(wire: dict) -> dict:
    """Merged wire -> response document (sorted most-traveled first)."""
    edges = []
    for key in sorted(wire["edges"],
                      key=lambda k: (-wire["edges"][k]["count"], k)):
        e = wire["edges"][key]
        client, server = key.split(EDGE_SEP, 1)
        p50, p95, p99 = _hist_quantiles_ms(e["hist"])
        edges.append({
            "client": client,
            "server": server,
            "count": e["count"],
            "failed": e["failed"],
            "errorRate": round(e["failed"] / e["count"], 6) if e["count"] else 0.0,
            "p50Ms": p50, "p95Ms": p95, "p99Ms": p99,
            "minStartS": e["minStartS"], "maxStartS": e["maxStartS"],
        })
    return {"edges": edges, "unpairedSpans": wire["unpaired"],
            "stats": dict(wire.get("stats") or {})}


# ---------------------------------------------------------------------------
# critical-path partials
# ---------------------------------------------------------------------------


def new_cp_wire(by: str = "service") -> dict:
    return {"groups": {}, "traces": 0, "pathHist": {}, "by": by, "stats": {}}


def cp_partial(cols: dict, d, by: str = "service", device=None,
               bucket_for=None, wire: dict | None = None) -> dict:
    """Fold one trace-sorted column set into a critical-path wire:
    per-trace longest self-time path (ops/graph pointer doubling, host
    arm or `device`'s arm — bit-identical), self-time nanoseconds attributed to
    the winning path's spans grouped by `by` (service | name)."""
    from tempo_tpu_torch.ops import graph as ops_graph

    if by not in CP_BY:
        raise ValueError(f"unknown critical-path grouping {by!r} (have {CP_BY})")
    wire = wire if wire is not None else new_cp_wire(by)
    n = len(cols["kind"])
    if n == 0:
        return wire
    _, seg, firsts = trace_segmentation(cols["trace_id"])
    pr = ops_graph.parent_row_join(seg, cols["span_id"], cols["parent_span_id"])
    self_ns, on_path, path_ns = ops_graph.critical_path(
        pr, cols["duration_nano"], seg, firsts,
        device=device, bucket_for=bucket_for,
    )
    rows = np.flatnonzero(on_path)
    codes = cols[by][rows]
    uniq, inv = np.unique(codes, return_inverse=True)
    ns = np.zeros(len(uniq), np.int64)
    np.add.at(ns, inv, self_ns[rows].astype(np.int64))
    cnt = np.bincount(inv, minlength=len(uniq))
    groups = wire["groups"]
    for i, code in enumerate(uniq):
        label = d[int(code)]
        g = groups.setdefault(label, {"ns": 0, "spans": 0})
        g["ns"] += int(ns[i])
        g["spans"] += int(cnt[i])
    wire["traces"] += len(firsts)
    buckets = GRAPH_HIST.np_bucket_of(path_ns)
    hist = np.bincount(buckets, minlength=GRAPH_HIST.n_buckets)
    ph = wire["pathHist"]
    for b in np.flatnonzero(hist):
        ph[str(b)] = ph.get(str(b), 0) + int(hist[b])
    return wire


def merge_cp_wire(dst: dict, src: dict | None) -> None:
    if not src:
        return
    for label, g in src.get("groups", {}).items():
        have = dst["groups"].setdefault(label, {"ns": 0, "spans": 0})
        have["ns"] += int(g["ns"])
        have["spans"] += int(g["spans"])
    dst["traces"] += int(src.get("traces", 0))
    ph = dst["pathHist"]
    for b, c in src.get("pathHist", {}).items():
        ph[b] = ph.get(b, 0) + int(c)
    _merge_stats(dst["stats"], src.get("stats"))


def finalize_cp(wire: dict) -> dict:
    total_ns = sum(g["ns"] for g in wire["groups"].values())
    groups = []
    for label in sorted(wire["groups"],
                        key=lambda g: (-wire["groups"][g]["ns"], g)):
        g = wire["groups"][label]
        groups.append({
            "name": label,
            "seconds": round(g["ns"] / 1e9, 6),
            "spans": g["spans"],
            "share": round(g["ns"] / total_ns, 6) if total_ns else 0.0,
        })
    p50, p95, p99 = _hist_quantiles_ms(wire["pathHist"])
    return {
        "by": wire["by"],
        "groups": groups,
        "traces": wire["traces"],
        "totalSeconds": round(total_ns / 1e9, 6),
        "pathP50Ms": p50, "pathP95Ms": p95, "pathP99Ms": p99,
        "stats": dict(wire.get("stats") or {}),
    }


# register the walk sampler's metric families alongside this module's
# (the generator imports the graph plane at boot, so every
# tempo_tpu_graph_* family exists from process start — the
# metrics-hygiene budget guard depends on that)
from tempo_tpu_torch.graph import walks as _walks  # noqa: E402,F401
