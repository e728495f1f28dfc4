"""Port of tempo_tpu/cli.py. The commands that do device work (`gen
bloom`, `convert`) take `--device` (default cuda; without CUDA they
raise unless `--device cpu`): the bloom's torch ops, and the writer's
sketches (the hll_update kernel) and device page encode, run there. The
offline critical path keeps the reference's host arm.

tempo-cli equivalent: offline block tooling against a backend.

Reference: cmd/tempo-cli (kong command tree main.go:38-78; per-command
files cmd-list-*.go, cmd-view-*.go, cmd-query.go, cmd-gen-*.go):
list tenants/blocks/compaction summary, view block meta + index +
columns, query trace-by-id and search straight against the backend
(no running cluster), regenerate bloom filters, dump the tenant index.

Usage: python -m tempo_tpu_torch.cli --path /data/blocks <command> ...
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _backend(args):
    from tempo_tpu_torch.backend.base import TypedBackend
    from tempo_tpu_torch.backend.local import LocalBackend

    if args.backend != "local":
        raise SystemExit(f"unsupported backend {args.backend!r} for CLI (local only)")
    return TypedBackend(LocalBackend(args.path))


def _open_block(backend, tenant: str, block_id: str):
    """Open with the encoding named in the block meta (reference:
    FromVersion dispatch at open, tempodb/encoding/versioned.go:54)."""
    from tempo_tpu_torch import encoding as encoding_registry

    meta = backend.block_meta(tenant, block_id)
    return encoding_registry.from_version(meta.version).open_block(meta, backend)


def _fmt_ts(sec: int) -> str:
    import datetime

    if not sec:
        return "-"
    return datetime.datetime.fromtimestamp(sec, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _print_table(rows: list[list], headers: list[str]) -> None:
    rows = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in rows) for i in range(len(headers))]
    for i, r in enumerate(rows):
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            print("  ".join("-" * w for w in widths))


# -- list ------------------------------------------------------------------


def cmd_list_tenants(args) -> int:
    be = _backend(args)
    for t in sorted(be.tenants()):
        print(t)
    return 0


def _tenant_metas(be, tenant):
    from tempo_tpu_torch.db.blocklist import scan_tenant

    return scan_tenant(be, tenant)


def cmd_list_blocks(args) -> int:
    be = _backend(args)
    metas, compacted = _tenant_metas(be, args.tenant)
    rows = []
    for m in sorted(metas, key=lambda m: m.start_time):
        rows.append(
            [
                m.block_id,
                m.compaction_level,
                m.total_objects,
                m.total_spans,
                f"{m.size_bytes:,}",
                _fmt_ts(m.start_time),
                _fmt_ts(m.end_time),
            ]
        )
    _print_table(rows, ["block", "lvl", "traces", "spans", "bytes", "start", "end"])
    if args.include_compacted and compacted:
        print(f"\ncompacted ({len(compacted)}):")
        for c in sorted(compacted, key=lambda c: c.compacted_time):
            print(f"  {c.meta.block_id}  compacted_at={_fmt_ts(int(c.compacted_time))}")
    return 0


def cmd_list_compaction_summary(args) -> int:
    be = _backend(args)
    metas, _ = _tenant_metas(be, args.tenant)
    by_level: dict[int, list] = {}
    for m in metas:
        by_level.setdefault(m.compaction_level, []).append(m)
    rows = []
    for lvl in sorted(by_level):
        ms = by_level[lvl]
        rows.append(
            [
                lvl,
                len(ms),
                sum(m.total_objects for m in ms),
                f"{sum(m.size_bytes for m in ms):,}",
                _fmt_ts(min(m.start_time for m in ms)),
                _fmt_ts(max(m.end_time for m in ms)),
            ]
        )
    _print_table(rows, ["lvl", "blocks", "traces", "bytes", "oldest", "newest"])
    return 0


def cmd_list_index(args) -> int:
    """Dump the tenant index (reference: cmd-list-index.go)."""
    from tempo_tpu_torch.backend.tenantindex import read_tenant_index

    be = _backend(args)
    idx = read_tenant_index(be.raw, args.tenant)
    doc = {
        "created_at": idx.created_at,
        "blocks": [m.block_id for m in idx.metas],
        "compacted": [c.meta.block_id for c in idx.compacted],
    }
    print(json.dumps(doc, indent=2))
    return 0


# -- view ------------------------------------------------------------------


def cmd_view_block(args) -> int:
    be = _backend(args)
    blk = _open_block(be, args.tenant, args.block)
    m = blk.meta
    print(json.dumps(json.loads(m.to_json()), indent=2))
    idx = blk.index()
    print(f"\nrow groups: {len(idx.row_groups)}")
    rows = [
        [i, rg.n_spans, rg.n_traces, rg.min_id[:8] + "..", rg.max_id[:8] + "..", rg.start_s, rg.end_s]
        for i, rg in enumerate(idx.row_groups)
    ]
    _print_table(rows, ["rg", "spans", "traces", "min_id", "max_id", "start_s", "end_s"])
    return 0


def cmd_view_columns(args) -> int:
    """Per-column page sizes across row groups (reference:
    cmd-view-schema/parquet column dumps)."""
    be = _backend(args)
    blk = _open_block(be, args.tenant, args.block)
    totals: dict[str, list[int]] = {}
    for rg in blk.index().row_groups:
        for name, pm in rg.pages.items():
            t = totals.setdefault(name, [0, 0])
            t[0] += pm.length
            t[1] += int(np.prod(pm.shape)) * np.dtype(pm.dtype).itemsize
    rows = [
        [name, f"{stored:,}", f"{raw:,}", f"{stored / max(raw, 1):.3f}"]
        for name, (stored, raw) in sorted(totals.items(), key=lambda kv: -kv[1][0])
    ]
    _print_table(rows, ["column", "stored", "raw", "ratio"])
    d = blk.dictionary()
    print(f"\ndictionary: {len(d)} entries")
    return 0


# -- query -----------------------------------------------------------------


def cmd_query_trace(args) -> int:
    from tempo_tpu_torch.api.params import parse_trace_id
    from tempo_tpu_torch.receivers import otlp

    be = _backend(args)
    tid = parse_trace_id(args.trace_id)
    metas, _ = _tenant_metas(be, args.tenant)
    from tempo_tpu_torch import encoding as encoding_registry

    hits = []
    for m in metas:
        blk = encoding_registry.from_version(m.version).open_block(m, be)
        t = blk.find_trace_by_id(tid)
        if t is not None:
            hits.append(t)
            print(f"found in block {m.block_id}", file=sys.stderr)
    if not hits:
        print("trace not found", file=sys.stderr)
        return 1
    from tempo_tpu_torch.model.trace import combine_traces

    print(json.dumps(otlp.encode_traces_json([combine_traces(hits)]), indent=2))
    return 0


def cmd_query_search(args) -> int:
    from tempo_tpu_torch.api.params import parse_logfmt_tags
    from tempo_tpu_torch.encoding.common import SearchRequest

    from tempo_tpu_torch import encoding as encoding_registry

    be = _backend(args)
    req = SearchRequest(tags=parse_logfmt_tags(args.tags or ""), limit=args.limit, query=args.q or "")
    metas, _ = _tenant_metas(be, args.tenant)
    results = []
    if req.query:
        from tempo_tpu_torch.traceql import execute

        for m in metas:
            blk = encoding_registry.from_version(m.version).open_block(m, be)

            def fetcher(spec, s, e, _blk=blk):
                return _blk.fetch_candidates(spec, s, e)

            results.extend(execute(req.query, fetcher, limit=req.limit))
    else:
        for m in metas:
            blk = encoding_registry.from_version(m.version).open_block(m, be)
            results.extend(blk.search(req).traces)
    seen = set()
    for r in sorted(results, key=lambda r: -r.start_time_unix_nano):
        if r.trace_id_hex in seen:
            continue
        seen.add(r.trace_id_hex)
        print(json.dumps(r.to_dict()))
        if req.limit and len(seen) >= req.limit:
            break
    return 0


def cmd_query_search_tags(args) -> int:
    """Tag names across a tenant's blocks (reference:
    cmd-query-search-tags.go, straight against the backend)."""
    from tempo_tpu_torch import encoding as encoding_registry
    from tempo_tpu_torch.model.tags import block_tag_names

    be = _backend(args)
    metas, _ = _tenant_metas(be, args.tenant)
    names: set = set()
    for m in metas:
        blk = encoding_registry.from_version(m.version).open_block(m, be)
        names |= block_tag_names(blk)
    print(json.dumps({"tagNames": sorted(names)}, indent=2))
    return 0


def cmd_query_search_tag_values(args) -> int:
    """Values of one tag across a tenant's blocks (reference:
    cmd-query-search-tag-values.go)."""
    from tempo_tpu_torch import encoding as encoding_registry
    from tempo_tpu_torch.model.tags import block_tag_values

    be = _backend(args)
    metas, _ = _tenant_metas(be, args.tenant)
    vals: set = set()
    for m in metas:
        blk = encoding_registry.from_version(m.version).open_block(m, be)
        vals |= block_tag_values(blk, args.tag)
    print(json.dumps({"tagValues": sorted(vals)}, indent=2))
    return 0


def cmd_list_cache_summary(args) -> int:
    """Bloom-filter bytes per compaction level — what the bloom cache
    would hold for this tenant (reference: cmd-list-cachesummary.go)."""
    from tempo_tpu_torch.backend.base import bloom_name

    be = _backend(args)
    metas, _ = _tenant_metas(be, args.tenant)
    by_level: dict[int, list] = {}
    for m in metas:
        by_level.setdefault(m.compaction_level, []).append(m)
    rows = []
    for lvl in sorted(by_level):
        ms = by_level[lvl]
        bloom_bytes = 0
        for m in ms:
            for s in range(m.bloom_shards):
                try:
                    bloom_bytes += len(be.read_named(m.tenant_id, m.block_id, bloom_name(s)))
                except Exception as e:
                    print(f"warning: bloom shard {s} of block {m.block_id} "
                          f"unreadable ({e}); summary undercounts", file=sys.stderr)
        rows.append([lvl, len(ms), f"{bloom_bytes:,}"])
    _print_table(rows, ["lvl", "blocks", "bloom bytes"])
    return 0


# -- analyse ---------------------------------------------------------------


def cmd_analyse_block(args) -> int:
    """Per-column bytes / compression by codec + zone-map coverage for
    one block (reference: tempo-cli analyse block)."""
    from tempo_tpu_torch.db import analytics

    be = _backend(args)
    meta = be.block_meta(args.tenant, args.block)
    a = analytics.analyse_block(be, meta)
    if args.json:
        print(json.dumps({k: v for k, v in a.items() if k != "rgRanges"}, indent=2))
        return 0
    if not a.get("supported"):
        print(f"block {args.block} ({a['version']}) has no analysable index; "
              "meta-only facts:")
        print(json.dumps(a, indent=2))
        return 0
    print(f"block {a['blockID']}  level={a['compactionLevel']}  "
          f"rowGroups={a['rowGroups']}  spans={a['totalSpans']:,}")
    rows = [
        [name, f"{c['storedBytes']:,}", f"{c['rawBytes']:,}", f"{c['ratio']:.3f}",
         ",".join(f"{k}:{v}" for k, v in sorted(c["codecs"].items()))]
        for name, c in a["columns"].items()
    ]
    _print_table(rows, ["column", "stored", "raw", "ratio", "codec pages"])
    z = a["zonemap"]
    print(f"\ncompression: {a['storedBytes']:,} / {a['rawBytes']:,} "
          f"= {a['compressionRatio']:.3f}")
    print(f"zone maps: {z['rowGroupsWithStats']}/{a['rowGroups']} row groups "
          f"({z['coverageRatio']:.0%} coverage, "
          f"{z['statsColumnsPerRowGroup']} stats columns/rg)")
    return 0


def cmd_analyse_blocks(args) -> int:
    """Tenant rollup: codec mix, compression, zone-map coverage, block
    age/size distributions, compaction debt (reference: tempo-cli
    analyse blocks, plus the sweep-scheduler payoff signals)."""
    from tempo_tpu_torch.db import analytics

    be = _backend(args)
    metas, _ = _tenant_metas(be, args.tenant)
    # a bare TypedBackend suffices: metas and window_s are explicit, so
    # analyse_tenant never touches the db-only members
    r = analytics.analyse_tenant(be, args.tenant, metas=metas,
                                 window_s=args.window_s)
    if args.json:
        print(json.dumps(r, indent=2))
        return 0
    print(f"tenant {r['tenant']}: {r['blocks']} blocks "
          f"({r['analysedBlocks']} analysed), {r['totalBytes']:,} bytes, "
          f"{r['totalSpans']:,} spans, levels {r['levels']}")
    rows = [[c, n, f"{r['codecStoredBytes'].get(c, 0):,}"]
            for c, n in sorted(r["codecPages"].items())]
    _print_table(rows, ["codec", "pages", "stored bytes"])
    z = r["zonemap"]
    debt = r["compactionDebt"]
    print(f"\ncompression ratio: {r['compressionRatio']:.3f}")
    print(f"zone-map coverage: {z['rowGroupsWithStats']}/{z['rowGroups']} "
          f"row groups ({z['coverageRatio']:.0%})")
    print(f"compaction debt: {debt['mergeRowGroups']}/{debt['totalRowGroups']} "
          f"row groups overlap ({debt['debtRatio']:.0%}); payoff={debt['payoff']}")
    for w in debt["windows"][:5]:
        print(f"  window {w['window']}: {w['blocks']} blocks, "
              f"{w['mergeRowGroups']}/{w['rowGroups']} overlapping rgs, "
              f"zonemap density {w['zonemapDensity']:.0%}, payoff={w['payoff']}")
    return 0


def cmd_analyse_device(args) -> int:
    """Offline device data-movement analysis over a page-heat ledger
    snapshot (the periodic exporter's device_ledger.json): hot-set
    report, transfer amplification, and the ghost-LRU what-if curve —
    recomputed at --budgets-mb when given, since the snapshot carries
    the raw access stream (the same answer /status/device serves live)."""
    from tempo_tpu_torch.util import pageheat

    doc = pageheat.load_snapshot(args.snapshot)
    budgets = [b for b in (args.budgets_mb or "").split(",") if b.strip()]
    r = pageheat.analyse_snapshot(doc, budgets_mb=budgets or None)
    if args.json:
        print(json.dumps(r, indent=2))
        return 0
    heat = r["pageHeat"]
    print(f"pages tracked: {heat.get('trackedPages', 0)}  "
          f"ships: {heat.get('totalShips', 0)}  "
          f"moved: {heat.get('totalMovedBytes', 0):,} bytes  "
          f"amplification: {heat.get('amplification', 0)}x")
    rows = [
        [h["block"][:16], h["column"], h["ships"], f"{h['movedBytes']:,}",
         f"{h['encodedBytes']:,}", f"{h['amplification']}x"]
        for h in heat.get("hotSet", [])[: args.top]
    ]
    _print_table(rows, ["block", "column", "ships", "moved", "encoded", "amp"])
    print("\nwhat-if HBM residency (ghost-LRU over the access stream):")
    for c in r["whatIf"].get("curve", []):
        print(f"  budget {c.get('budget', c['budgetBytes'])}"
              f" ({c['budgetBytes']:,} B): miss {c['missRatio']:.1%}, "
              f"eliminates {c['savedBytes']:,} transfer bytes "
              f"({c['savedRatio']:.1%})")
    for p in heat.get("pinning", [])[:4]:
        print(f"  pin top {p['pages']} pages ({p['pinnedBytes']:,} B) -> "
              f"saves {p['savedBytes']:,} B ({p['savedRatio']:.1%})")
    if args.resident:
        rt = doc.get("residentTier") or r.get("residentTier") or {}
        print("\ndevice-resident hot tier:")
        if not rt.get("enabled"):
            print("  disabled at snapshot time "
                  "(device_tier.budget_mb=0 / TEMPO_TPU_DEVICE_TIER_MB unset)")
            return 0
        st = rt.get("stats", {})
        print(f"  resident: {st.get('entries', 0)} entries, "
              f"{st.get('bytes', 0):,} B of {st.get('max_bytes', 0):,} B "
              f"(effective {st.get('effective_max_bytes', 0):,} B under "
              "current pressure)")
        print(f"  hits {st.get('hits', 0)}  misses {st.get('misses', 0)}  "
              f"admissions {st.get('admissions', 0)}  "
              f"evictions {st.get('evictions', 0)}  "
              f"h2d avoided {st.get('avoided_bytes', 0):,} B")
        print(f"  admission set: {rt.get('admissionSetSize', 0)} pages inside "
              f"{rt.get('admissionBudgetBytes', 0):,} B (what-if knee "
              "capped at the configured budget)")
        rows = [
            [p.get("block", p.get("key", ""))[:16], p.get("column", "-"),
             p.get("codec", ""), f"{p.get('deviceBytes', 0):,}",
             f"{p.get('hostBytes', 0):,}"]
            for p in rt.get("residentPages", [])[: args.top]
        ]
        if rows:
            _print_table(rows, ["block", "column", "codec", "devBytes",
                                "hostBytes/hit"])
    return 0


# -- graph -----------------------------------------------------------------


def _graph_wire(args, want: str):
    """Offline trace-graph aggregation straight off stored blocks (no
    running cluster): the same per-block partials the graph_* worker
    jobs compute, merged locally."""
    from tempo_tpu_torch import encoding as encoding_registry
    from tempo_tpu_torch import graph

    be = _backend(args)
    metas, _ = _tenant_metas(be, args.tenant)
    pipeline = graph.parse_root_filter(args.q)
    by = getattr(args, "by", "service")
    wire = graph.new_deps_wire() if want == "deps" else graph.new_cp_wire(by)
    merge = graph.merge_deps_wire if want == "deps" else graph.merge_cp_wire
    for m in sorted(metas, key=lambda m: str(m.block_id)):
        if args.start and m.end_time < args.start:
            continue
        if args.end and m.start_time > args.end:
            continue
        blk = encoding_registry.from_version(m.version).open_block(m, be)
        stats = {"inspectedBlocks": 1}
        rows = graph.collect_block_rows(blk, pipeline, args.start, args.end,
                                        stats=stats)
        sub = graph.new_deps_wire() if want == "deps" else graph.new_cp_wire(by)
        if rows is not None:
            if want == "deps":
                graph.deps_partial(rows, blk.dictionary(), wire=sub)
            else:
                graph.cp_partial(rows, blk.dictionary(), by=by, wire=sub,
                                 device=None)
        stats["inspectedBytes"] = blk.bytes_read
        sub["stats"] = {**sub["stats"], **stats}
        merge(wire, sub)
    return wire


def cmd_graph_dependencies(args) -> int:
    """Service-dependency edges aggregated offline from stored blocks
    (the /api/graph/dependencies result without a cluster)."""
    from tempo_tpu_torch import graph

    doc = graph.finalize_deps(_graph_wire(args, "deps"))
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    rows = [
        [e["client"], e["server"], e["count"], e["failed"],
         f"{e['errorRate']:.1%}", e["p50Ms"], e["p99Ms"]]
        for e in doc["edges"]
    ]
    _print_table(rows, ["client", "server", "count", "failed", "err%",
                        "p50ms", "p99ms"])
    print(f"\nunpaired spans: {doc['unpairedSpans']}  "
          f"blocks: {doc['stats'].get('inspectedBlocks', 0)}")
    return 0


def cmd_graph_critical_path(args) -> int:
    """Per-service/name critical-path seconds aggregated offline."""
    from tempo_tpu_torch import graph

    doc = graph.finalize_cp(_graph_wire(args, "cp"))
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    rows = [[g["name"], f"{g['seconds']:.3f}", g["spans"], f"{g['share']:.1%}"]
            for g in doc["groups"]]
    _print_table(rows, [doc["by"], "seconds", "spans", "share"])
    print(f"\ntraces: {doc['traces']}  total: {doc['totalSeconds']:.3f}s  "
          f"path p50/p99: {doc['pathP50Ms']}/{doc['pathP99Ms']} ms")
    return 0


# -- vulture ---------------------------------------------------------------


def cmd_vulture_check(args) -> int:
    """Offline aged-tier audit: recompute the deterministic vulture
    probes (util/traceinfo) whose cadence timestamps fall inside the
    tenant's stored block range and verify each is present and complete
    DIRECTLY against the backend blocks — no running cluster. This is
    the post-compaction arm of the continuous-verification plane: the
    live vulture proves the query path, this proves the bytes at rest.

    The audit assumes the prober wrote EVERY cadence slot of the
    audited window — bound it with --since/--until to the interval the
    vulture actually ran (its start time / last stop), or every slot of
    a gap reads as MISSING (a false data-loss verdict).
    """
    from tempo_tpu_torch import encoding as encoding_registry
    from tempo_tpu_torch.util.traceinfo import TraceInfo

    be = _backend(args)
    metas, _ = _tenant_metas(be, args.tenant)
    if not metas:
        print("no blocks for tenant", file=sys.stderr)
        return 1
    lo = min(m.start_time for m in metas)
    hi = max(m.end_time for m in metas)
    if args.since:
        lo = max(lo, args.since)
    if args.until:
        hi = min(hi, args.until)
    backoff = max(1, args.write_backoff)
    first = lo + (-lo) % backoff  # first cadence-aligned ts >= lo
    timestamps = list(range(first, hi + 1, backoff))
    if args.max_probes and len(timestamps) > args.max_probes:
        timestamps = timestamps[-args.max_probes:]  # newest-biased window
    if not timestamps:
        print("no cadence slots inside the audited window", file=sys.stderr)
        return 0
    # only open blocks that can overlap an audited slot — a bounded
    # audit must not pay index reads for the whole tenant
    lo, hi = timestamps[0], timestamps[-1]
    metas = [m for m in metas if m.end_time >= lo and m.start_time <= hi + 2]
    blocks = [encoding_registry.from_version(m.version).open_block(m, be)
              for m in metas]
    found = missing = incomplete = 0
    for ts in timestamps:
        info = TraceInfo(ts, args.seed_tenant)
        want = {s.span_id for s in info.construct_trace().all_spans()}
        got: set = set()
        for m, blk in zip(metas, blocks):
            if m.end_time < ts or m.start_time > ts + 2:
                continue
            t = blk.find_trace_by_id(info.trace_id())
            if t is not None:
                got |= {s.span_id for s in t.all_spans()}
        if not got:
            missing += 1
            print(f"MISSING  ts={ts} trace={info.trace_id().hex()}")
        elif not want <= got:
            incomplete += 1
            print(f"PARTIAL  ts={ts} trace={info.trace_id().hex()} "
                  f"({len(want & got)}/{len(want)} spans)")
        else:
            found += 1
    print(f"probes={len(timestamps)} found={found} missing={missing} "
          f"incomplete={incomplete}")
    return 0 if not (missing or incomplete) else 1


# -- gen -------------------------------------------------------------------


def cmd_gen_bloom(args) -> int:
    """Rebuild bloom shards from the block's trace IDs (reference:
    cmd-gen-bloom.go). The bloom is built on --device."""
    from tempo_tpu_torch import device as _device
    from tempo_tpu_torch.backend.base import bloom_name
    from tempo_tpu_torch.encoding.vtpu.create import _ids_to_device
    from tempo_tpu_torch.ops import bloom as bloom_ops

    dev = _device.resolve(args.device)
    be = _backend(args)
    blk = _open_block(be, args.tenant, args.block)
    m = blk.meta
    ids = []
    for rg in blk.index().row_groups:
        cols = blk.read_columns(rg, ["trace_id"])
        ids.append(cols["trace_id"])
    tids = np.unique(np.concatenate(ids), axis=0)
    plan = blk.bloom_plan()
    words = bloom_ops.build(_ids_to_device(tids, dev), plan).cpu().numpy().astype(np.uint32)
    for shard in range(plan.n_shards):
        be.write_named(m, bloom_name(shard), bloom_ops.shard_to_bytes(words[shard]))
    print(f"rebuilt {plan.n_shards} bloom shard(s) from {len(tids)} trace ids")
    return 0


def cmd_gen_index(args) -> int:
    """Re-write the tenant index from a bucket scan (reference:
    cmd-gen-index.go)."""
    import time

    from tempo_tpu_torch.backend.tenantindex import TenantIndex, write_tenant_index

    be = _backend(args)
    metas, compacted = _tenant_metas(be, args.tenant)
    write_tenant_index(be.raw, args.tenant, TenantIndex(created_at=time.time(), metas=metas, compacted=compacted))
    print(f"wrote tenant index: {len(metas)} blocks, {len(compacted)} compacted")
    return 0


def cmd_convert(args) -> int:
    """Re-encode one block into another registered encoding (reference:
    cmd-convert-parquet-*.go — offline format migration). Writes a NEW
    block; the source is left untouched unless --mark-compacted. The
    writer's device work runs on --device."""
    import time

    from tempo_tpu_torch import device as _device

    from tempo_tpu_torch import encoding as encoding_registry
    from tempo_tpu_torch.encoding.common import BlockConfig
    from tempo_tpu_torch.model.columnar import SpanBatch

    dev = _device.resolve(args.device)
    be = _backend(args)
    blk = _open_block(be, args.tenant, args.block)
    src_version = blk.meta.version
    enc = encoding_registry.from_version(args.to)

    # collect + re-sort: encodings require trace-sorted batches sharing
    # one dictionary, and row-group/page boundaries differ per encoding
    batches = list(blk.iter_trace_batches())
    if not batches:
        print("source block is empty; nothing to convert")
        return 1
    merged = SpanBatch.concat(batches).sorted_by_trace()
    cfg = BlockConfig(version=args.to)
    meta = enc.create_block([merged], args.tenant, be, cfg,
                            compaction_level=blk.meta.compaction_level, device=dev)
    print(
        f"converted {args.block} ({src_version}) -> {meta.block_id} ({meta.version}): "
        f"{meta.total_objects} traces, {meta.total_spans} spans"
    )
    if args.mark_compacted:
        be.mark_block_compacted(args.tenant, args.block, time.time())
        print(f"marked source {args.block} compacted")
    return 0


# -- rca -------------------------------------------------------------------


def cmd_rca_replay(args) -> int:
    """Offline replay of a saved incident (or bare evidence bundle): re-run
    the cause classifier and suspect ranking over the recorded evidence so
    an attribution can be audited — or re-derived after a classifier fix —
    without a running cluster."""
    from tempo_tpu_torch.graph.walks import rank_suspects
    from tempo_tpu_torch.rca.classify import classify

    with open(args.bundle, encoding="utf-8") as fh:
        doc = json.load(fh)
    # Accept either a full incident record (as served by /api/rca/{id})
    # or just its "evidence" object.
    evidence = doc.get("evidence", doc)
    finding = classify(evidence)
    walk_doc = evidence.get("walks") or {}
    suspects = evidence.get("suspects") or []
    if walk_doc.get("edgeVisits") and not suspects:
        suspects = rank_suspects(walk_doc)
    if args.json:
        print(json.dumps({"finding": finding, "suspects": suspects}, indent=2, sort_keys=True))
        return 0
    print(f"cause:      {finding['cause']}" + ("  (suppressed)" if finding.get("suppressed") else ""))
    for k in ("tier", "service", "stage", "suspect"):
        if finding.get(k):
            print(f"{k + ':':<11} {finding[k]}")
    if finding.get("details"):
        print(f"details:    {finding['details']}")
    recorded = doc.get("finding")
    if recorded and recorded.get("cause") != finding["cause"]:
        print(f"note: recorded finding was {recorded.get('cause')!r}; "
              f"replay classified {finding['cause']!r}")
    if suspects:
        _print_table(
            [[s.get("edge", ""), s.get("edgeVisits", 0), s.get("serverVisits", 0)] for s in suspects],
            ["suspect edge", "edge visits", "server visits"],
        )
    exemplars = evidence.get("exemplarTraceIds") or []
    if exemplars:
        print("exemplar traces: " + ", ".join(exemplars[:5]))
    return 0


# -- wiring ----------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tempo-tpu-cli", description=__doc__)
    p.add_argument("--backend", default="local")
    p.add_argument("--path", required=True, help="backend root (local dir)")
    sub = p.add_subparsers(dest="cmd", required=True)

    lst = sub.add_parser("list", help="list tenants/blocks/summary/index").add_subparsers(
        dest="what", required=True
    )
    lst.add_parser("tenants").set_defaults(fn=cmd_list_tenants)
    lb = lst.add_parser("blocks")
    lb.add_argument("tenant")
    lb.add_argument("--include-compacted", action="store_true")
    lb.set_defaults(fn=cmd_list_blocks)
    lc = lst.add_parser("compaction-summary")
    lc.add_argument("tenant")
    lc.set_defaults(fn=cmd_list_compaction_summary)
    lcs = lst.add_parser("cache-summary")
    lcs.add_argument("tenant")
    lcs.set_defaults(fn=cmd_list_cache_summary)
    li = lst.add_parser("index")
    li.add_argument("tenant")
    li.set_defaults(fn=cmd_list_index)

    view = sub.add_parser("view", help="view block meta/index/columns").add_subparsers(
        dest="what", required=True
    )
    vb = view.add_parser("block")
    vb.add_argument("tenant")
    vb.add_argument("block")
    vb.set_defaults(fn=cmd_view_block)
    vc = view.add_parser("columns")
    vc.add_argument("tenant")
    vc.add_argument("block")
    vc.set_defaults(fn=cmd_view_columns)

    q = sub.add_parser("query", help="query backend directly").add_subparsers(dest="what", required=True)
    qt = q.add_parser("trace-id")
    qt.add_argument("tenant")
    qt.add_argument("trace_id")
    qt.set_defaults(fn=cmd_query_trace)
    qst = q.add_parser("search-tags")
    qst.add_argument("tenant")
    qst.set_defaults(fn=cmd_query_search_tags)
    qsv = q.add_parser("search-tag-values")
    qsv.add_argument("tenant")
    qsv.add_argument("tag")
    qsv.set_defaults(fn=cmd_query_search_tag_values)
    qs = q.add_parser("search")
    qs.add_argument("tenant")
    qs.add_argument("--tags", default="")
    qs.add_argument("--q", default="", help="TraceQL query")
    qs.add_argument("--limit", type=int, default=20)
    qs.set_defaults(fn=cmd_query_search)

    an = sub.add_parser(
        "analyse", help="storage health: codec/compression/zone-map/debt"
    ).add_subparsers(dest="what", required=True)
    ab = an.add_parser("block")
    ab.add_argument("tenant")
    ab.add_argument("block")
    ab.add_argument("--json", action="store_true")
    ab.set_defaults(fn=cmd_analyse_block)
    abs_ = an.add_parser("blocks")
    abs_.add_argument("tenant")
    abs_.add_argument("--json", action="store_true")
    abs_.add_argument("--window-s", type=int, default=3600,
                      help="compaction window for the debt sweep")
    abs_.set_defaults(fn=cmd_analyse_blocks)
    ad = an.add_parser(
        "device",
        help="device data-movement: page heat + what-if HBM residency "
             "over an exported ledger snapshot")
    ad.add_argument("snapshot", help="device_ledger.json written by the "
                                     "page-heat exporter")
    ad.add_argument("--budgets-mb", default="",
                    help="comma-separated HBM budgets in MB to re-run the "
                         "ghost-LRU simulation at (default: the snapshot's "
                         "working-set-fraction curve)")
    ad.add_argument("--top", type=int, default=20)
    ad.add_argument("--resident", action="store_true",
                    help="also print the device-resident hot tier view "
                         "captured in the snapshot (resident set, admission "
                         "budget, avoided-transfer rollup)")
    ad.add_argument("--json", action="store_true")
    ad.set_defaults(fn=cmd_analyse_device)

    gr = sub.add_parser(
        "graph", help="trace-graph analytics over stored blocks (offline)"
    ).add_subparsers(dest="what", required=True)
    for gname, gfn in (("dependencies", cmd_graph_dependencies),
                       ("critical-path", cmd_graph_critical_path)):
        gp = gr.add_parser(gname)
        gp.add_argument("tenant")
        gp.add_argument("--q", default="", help="TraceQL spanset filter (root set)")
        gp.add_argument("--start", type=int, default=0, help="unix seconds")
        gp.add_argument("--end", type=int, default=0)
        gp.add_argument("--json", action="store_true")
        if gname == "critical-path":
            gp.add_argument("--by", choices=("service", "name"), default="service")
        gp.set_defaults(fn=gfn)

    vc = sub.add_parser(
        "vulture-check",
        help="offline audit of deterministic vulture probes in stored blocks",
    )
    vc.add_argument("tenant")
    vc.add_argument("--seed-tenant", default="single-tenant",
                    help="tenant string the probes were seeded with "
                         "(vulture.tenant of the writing prober)")
    vc.add_argument("--write-backoff", type=int, default=10,
                    help="the writing vulture's cadence in seconds")
    vc.add_argument("--max-probes", type=int, default=500,
                    help="check at most the newest N cadence timestamps")
    vc.add_argument("--since", type=int, default=0,
                    help="audit slots at/after this unix second (bound "
                         "to when the prober actually started writing)")
    vc.add_argument("--until", type=int, default=0,
                    help="audit slots at/before this unix second")
    vc.set_defaults(fn=cmd_vulture_check)

    gen = sub.add_parser("gen", help="regenerate derived objects").add_subparsers(dest="what", required=True)
    gb = gen.add_parser("bloom")
    gb.add_argument("tenant")
    gb.add_argument("block")
    gb.add_argument("--device", default="cuda", help="where the bloom is built (cuda|cpu)")
    gb.set_defaults(fn=cmd_gen_bloom)
    gi = gen.add_parser("index")
    gi.add_argument("tenant")
    gi.set_defaults(fn=cmd_gen_index)

    cv = sub.add_parser("convert", help="re-encode a block into another encoding")
    cv.add_argument("tenant")
    cv.add_argument("block")
    cv.add_argument("--to", required=True, help="target encoding version (vtpu1|vrow1)")
    cv.add_argument("--mark-compacted", action="store_true",
                    help="mark the source block compacted after converting")
    cv.add_argument("--device", default="cuda",
                    help="where the writer's sketches and page encode run (cuda|cpu)")
    cv.set_defaults(fn=cmd_convert)

    rca = sub.add_parser(
        "rca", help="auto-RCA incident tooling (offline)"
    ).add_subparsers(dest="what", required=True)
    rr = rca.add_parser(
        "replay",
        help="re-run cause classification over a saved incident/evidence JSON",
    )
    rr.add_argument("bundle", help="incident record (from /api/rca/{id}) or bare evidence JSON")
    rr.add_argument("--json", action="store_true")
    rr.set_defaults(fn=cmd_rca_replay)

    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from tempo_tpu_torch.api.params import BadRequest
    from tempo_tpu_torch.backend.base import NotFound

    try:
        return args.fn(args)
    except NotFound as e:
        print(f"not found: {e or e.__class__.__name__}", file=sys.stderr)
        return 1
    except BadRequest as e:
        print(f"bad argument: {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        # output piped into a closed reader (| head): not an error
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
