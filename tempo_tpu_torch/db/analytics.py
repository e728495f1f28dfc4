"""Storage-fleet analytics: codec economics, zone-map coverage,
compaction debt.

Port of tempo_tpu/db/analytics.py (host code, copied as is): the
`/status/storage` document and the periodic StorageScanner with its
gauges. Reference: `tempo-cli analyse block/blocks` (per-block
per-column bytes and dictionary efficiency, rolled up across a tenant's
recent blocks to decide which attributes deserve dedicated columns).
The same pass additionally measures:

- **zone-map coverage** — fraction of row groups carrying pruning
  stats, per column class: how much of the store queries can skip
  without reading;
- **compaction debt** — trace-ID interval overlap between blocks of
  one compaction window, measured with the SAME sweep the zero-decode
  fast path plans with (`parallel/compaction.plan_disjoint_runs`): row
  groups landing in "merge" segments are the work a compactor must pay
  decode for, row groups in "relocate" segments move verbatim. Debt x
  zone-map density is the read-amplification payoff of sweeping that
  window first.

Two consumers share this module: the `/status/storage` endpoint and the
periodic StorageScanner exporting `tempodb_compaction_debt_*` /
`tempodb_zonemap_coverage_ratio` gauges (App starts it on target `all`
every `storage.trace.analytics_scan_s`, 600 s by default). Per-block
analyses are memoized by block ID — blocks are immutable, so a
steady-state scan only pays IO for blocks born since the last one. The
scan reads block indexes only, on the host.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from tempo_tpu_torch.util import metrics

log = logging.getLogger(__name__)

zonemap_coverage_gauge = metrics.gauge(
    "tempodb_zonemap_coverage_ratio",
    "Fraction of row groups carrying zone-map stats, per tenant "
    "(absent stats = row group can never be pruned)",
)
debt_row_groups_gauge = metrics.gauge(
    "tempodb_compaction_debt_row_groups",
    "Row groups whose trace-ID range overlaps another block of the same "
    "compaction window (plan_disjoint_runs merge segments), per tenant",
)
debt_ratio_gauge = metrics.gauge(
    "tempodb_compaction_debt_ratio",
    "Overlapping row groups / total row groups across multi-block "
    "compaction windows, per tenant (0 = fully disjoint store)",
)
debt_payoff_gauge = metrics.gauge(
    "tempodb_compaction_debt_payoff",
    "Zone-map density x overlapping row groups, per tenant — the "
    "read-amplification payoff of sweeping this tenant first",
)
compression_ratio_gauge = metrics.gauge(
    "tempodb_storage_compression_ratio",
    "Stored bytes / raw decoded bytes across analysed blocks, per tenant",
)
storage_codec_bytes_gauge = metrics.gauge(
    "tempodb_storage_codec_stored_bytes",
    "Stored page bytes by codec across all tenants (the fleet codec mix)",
)
analytics_scans_total = metrics.counter(
    "tempodb_storage_analytics_scans_total",
    "Background storage-analytics scans completed",
)
analytics_scan_seconds = metrics.histogram(
    "tempodb_storage_analytics_scan_seconds",
    "Wall-clock seconds per storage-analytics scan",
)


def _page_raw_bytes(pm) -> int:
    """Decoded (row-space) size of one page from its dtype/shape."""
    n = 1
    for d in pm.shape:
        n *= int(d)
    return n * np.dtype(pm.dtype).itemsize


def analyse_block(db_or_backend, meta, cfg=None) -> dict:
    """One block's storage economics (reference: tempo-cli analyse
    block). Accepts a TempoDB (uses its backend/config) or a
    TypedBackend. Non-vtpu1 blocks get meta-only facts with
    supported=False — no index format to walk."""
    backend = getattr(db_or_backend, "backend", db_or_backend)
    out = {
        "blockID": str(meta.block_id),
        "tenant": meta.tenant_id,
        "version": meta.version,
        "compactionLevel": meta.compaction_level,
        "sizeBytes": meta.size_bytes,
        "totalObjects": meta.total_objects,
        "totalSpans": meta.total_spans,
        "startTime": meta.start_time,
        "endTime": meta.end_time,
    }
    if meta.version != "vtpu1":
        out["supported"] = False
        return out
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock

    # column_cache=None: the analytics pass reads only the index — it
    # must never churn the query working set
    blk = VtpuBackendBlock(meta, backend, cfg, column_cache=None)
    idx = blk.index()

    columns: dict[str, dict] = {}
    codec_pages: dict[str, int] = {}
    codec_stored: dict[str, int] = {}
    codec_raw: dict[str, int] = {}
    rgs_with_stats = 0
    stats_cols = 0
    rg_ranges: list[tuple[str, str]] = []
    for rg in idx.row_groups:
        rg_ranges.append((rg.min_id, rg.max_id))
        stats = getattr(rg, "stats", None) or {}
        if stats:
            rgs_with_stats += 1
            stats_cols += len(stats)
        for name, pm in rg.pages.items():
            raw = _page_raw_bytes(pm)
            col = columns.setdefault(
                name, {"storedBytes": 0, "rawBytes": 0, "pages": 0, "codecs": {}})
            col["storedBytes"] += pm.length
            col["rawBytes"] += raw
            col["pages"] += 1
            col["codecs"][pm.codec] = col["codecs"].get(pm.codec, 0) + 1
            codec_pages[pm.codec] = codec_pages.get(pm.codec, 0) + 1
            codec_stored[pm.codec] = codec_stored.get(pm.codec, 0) + pm.length
            codec_raw[pm.codec] = codec_raw.get(pm.codec, 0) + raw
    for col in columns.values():
        col["ratio"] = round(col["storedBytes"] / max(col["rawBytes"], 1), 4)
    stored_sum = sum(c["storedBytes"] for c in columns.values())
    raw_sum = sum(c["rawBytes"] for c in columns.values())
    n_rgs = len(idx.row_groups)
    out.update({
        "supported": True,
        "rowGroups": n_rgs,
        "columns": dict(sorted(columns.items(),
                               key=lambda kv: -kv[1]["storedBytes"])),
        "codecPages": codec_pages,
        "codecStoredBytes": codec_stored,
        "codecCompressionRatio": {
            c: round(codec_stored[c] / max(codec_raw[c], 1), 4) for c in codec_stored
        },
        "storedBytes": stored_sum,
        "rawBytes": raw_sum,
        "compressionRatio": round(stored_sum / max(raw_sum, 1), 4),
        "zonemap": {
            "rowGroupsWithStats": rgs_with_stats,
            "coverageRatio": round(rgs_with_stats / max(n_rgs, 1), 4),
            "statsColumnsPerRowGroup": round(stats_cols / max(n_rgs, 1), 2),
        },
        "rgRanges": rg_ranges,
    })
    return out


def compaction_debt(block_analyses: list[dict], window_s: int) -> dict:
    """Tenant-level compaction debt from per-block analyses.

    Blocks are grouped by the compaction window (end_time // window_s —
    the exact bucketing TimeWindowBlockSelector uses) and each
    multi-block window's row-group trace-ID ranges go through
    plan_disjoint_runs: row groups in "merge" segments are the debt (a
    compactor must decode-merge them), "relocate" row groups move
    verbatim. Single-block windows carry no cross-block overlap by
    definition.
    """
    from tempo_tpu_torch.parallel.compaction import plan_disjoint_runs

    windows: dict[int, list[dict]] = {}
    for a in block_analyses:
        if not a.get("supported"):
            continue
        windows.setdefault(int(a["endTime"]) // max(window_s, 1), []).append(a)

    per_window = []
    total_rgs = merge_rgs = relocate_rgs = 0
    for w, blocks in sorted(windows.items()):
        n_rgs = sum(len(a["rgRanges"]) for a in blocks)
        total_rgs += n_rgs
        if len(blocks) < 2:
            relocate_rgs += n_rgs
            continue
        segments = plan_disjoint_runs([a["rgRanges"] for a in blocks])
        w_merge = sum(
            sum(hi - lo for lo, hi in seg[1].values())
            for seg in segments if seg[0] == "merge"
        )
        w_reloc = sum(1 for seg in segments if seg[0] == "relocate")
        merge_rgs += w_merge
        relocate_rgs += w_reloc
        cov = [a["zonemap"]["coverageRatio"] for a in blocks]
        density = sum(cov) / len(cov)
        per_window.append({
            "window": w,
            "blocks": len(blocks),
            "rowGroups": n_rgs,
            "mergeRowGroups": w_merge,
            "relocateRowGroups": w_reloc,
            "debtRatio": round(w_merge / max(n_rgs, 1), 4),
            "zonemapDensity": round(density, 4),
            # the sweep scheduler's ordering key (ROADMAP 4b): windows
            # where pruning-ready row groups overlap are where one
            # compaction buys the most read amplification back
            "payoff": round(density * w_merge, 4),
        })
    per_window.sort(key=lambda d: -d["payoff"])
    return {
        "totalRowGroups": total_rgs,
        "mergeRowGroups": merge_rgs,
        "relocateRowGroups": relocate_rgs,
        "debtRatio": round(merge_rgs / max(total_rgs, 1), 4),
        "payoff": round(sum(w["payoff"] for w in per_window), 4),
        "windows": per_window,
    }


def _distribution(values: list) -> dict:
    if not values:
        return {"count": 0}
    vals = sorted(values)

    def pct(p):
        return vals[min(len(vals) - 1, int(len(vals) * p))]

    return {
        "count": len(vals),
        "min": vals[0],
        "p50": pct(0.5),
        "p90": pct(0.9),
        "max": vals[-1],
        "sum": sum(vals),
    }


def analyse_tenant(db, tenant: str, metas=None, window_s: int | None = None,
                   block_memo: dict | None = None) -> dict:
    """Tenant rollup (reference: tempo-cli analyse blocks): aggregate
    codec mix + compression, zone-map coverage, block age/size
    distributions, and compaction debt. `block_memo` (keyed by block
    ID) lets the periodic scanner skip re-reading immutable blocks."""
    metas = db.blocklist.metas(tenant) if metas is None else metas
    if window_s is None:
        window_s = getattr(getattr(db, "compaction_cfg", None), "window_s", 3600)
    analyses = []
    for m in metas:
        key = str(m.block_id)
        a = block_memo.get(key) if block_memo is not None else None
        if a is None:
            try:
                a = analyse_block(db, m)
            except Exception as e:  # noqa: BLE001 — one bad block must
                # not take down the fleet view; quarantine handles it
                log.warning("analyse of block %s/%s failed: %s",
                            tenant, m.block_id, e)
                continue
            if block_memo is not None:
                block_memo[key] = a
        analyses.append(a)

    supported = [a for a in analyses if a.get("supported")]
    codec_pages: dict[str, int] = {}
    codec_stored: dict[str, int] = {}
    stored = raw = rgs = rgs_with_stats = 0
    for a in supported:
        for c, n in a["codecPages"].items():
            codec_pages[c] = codec_pages.get(c, 0) + n
        for c, n in a["codecStoredBytes"].items():
            codec_stored[c] = codec_stored.get(c, 0) + n
        stored += a["storedBytes"]
        raw += a["rawBytes"]
        rgs += a["rowGroups"]
        rgs_with_stats += a["zonemap"]["rowGroupsWithStats"]
    now = time.time()
    levels: dict[int, int] = {}
    for m in metas:
        levels[m.compaction_level] = levels.get(m.compaction_level, 0) + 1
    return {
        "tenant": tenant,
        "blocks": len(metas),
        "analysedBlocks": len(supported),
        "totalBytes": sum(m.size_bytes for m in metas),
        "totalSpans": sum(m.total_spans for m in metas),
        "levels": {str(k): v for k, v in sorted(levels.items())},
        "sizeBytesDistribution": _distribution([m.size_bytes for m in metas]),
        "ageSecondsDistribution": _distribution(
            [max(0, int(now - m.end_time)) for m in metas]),
        "codecPages": codec_pages,
        "codecStoredBytes": codec_stored,
        "storedBytes": stored,
        "rawBytes": raw,
        "compressionRatio": round(stored / max(raw, 1), 4),
        "zonemap": {
            "rowGroups": rgs,
            "rowGroupsWithStats": rgs_with_stats,
            "coverageRatio": round(rgs_with_stats / max(rgs, 1), 4),
        },
        "compactionDebt": compaction_debt(supported, window_s),
    }


def fleet_summary(tenant_reports: dict) -> dict:
    """Cross-tenant aggregate with NO tenant names — the shape the
    anonymous usage-stats snapshot ships (feature/scale data only)."""
    reports = list(tenant_reports.values())
    codec_pages: dict[str, int] = {}
    for r in reports:
        for c, n in r["codecPages"].items():
            codec_pages[c] = codec_pages.get(c, 0) + n
    stored = sum(r["storedBytes"] for r in reports)
    raw = sum(r["rawBytes"] for r in reports)
    rgs = sum(r["zonemap"]["rowGroups"] for r in reports)
    covered = sum(r["zonemap"]["rowGroupsWithStats"] for r in reports)
    return {
        "tenants": len(reports),
        "blocks": sum(r["blocks"] for r in reports),
        "totalBytes": sum(r["totalBytes"] for r in reports),
        "totalSpans": sum(r["totalSpans"] for r in reports),
        "storedBytes": stored,
        "rawBytes": raw,
        "compressionRatio": round(stored / max(raw, 1), 4),
        "codecPages": codec_pages,
        "zonemapCoverageRatio": round(covered / max(rgs, 1), 4),
        "compactionDebtRowGroups": sum(
            r["compactionDebt"]["mergeRowGroups"] for r in reports),
        "compactionDebtPayoff": round(sum(
            r["compactionDebt"]["payoff"] for r in reports), 4),
    }


class StorageScanner:
    """Periodic background analytics pass over every tenant's blocklist,
    exporting the per-tenant health gauges and caching the last report
    for /status/storage and the usage-stats snapshot.

    Cost model: per-block analyses are memoized (blocks are immutable),
    so a steady-state scan reads only the indexes of NEW blocks; memo
    entries of deleted blocks are dropped each scan. One owner per
    deployment is enough — App starts it on compaction-owning roles."""

    def __init__(self, db, interval_s: float = 600.0):
        self.db = db
        self.interval_s = interval_s
        self.last: dict | None = None
        self.last_at = 0.0
        self._memo: dict[str, dict] = {}
        self._known_tenants: set = set()
        self._known_codecs: set = set()
        self._lock = threading.Lock()  # guards last/last_at
        # serializes whole scans: the background loop and HTTP-triggered
        # refreshes must not interleave on the shared block memo (a
        # lock-free analyse mutating _memo while another scan's filter
        # iterates it is a dict-changed-during-iteration crash)
        self._scan_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def scan_once(self) -> dict:
        with self._scan_lock:
            return self._scan_locked()

    def _scan_locked(self) -> dict:
        t0 = time.perf_counter()
        tenants = self.db.blocklist.tenants()
        reports: dict[str, dict] = {}
        live_blocks: set = set()
        from tempo_tpu_torch.util import usage

        for tenant in tenants:
            metas = self.db.blocklist.metas(tenant)
            live_blocks.update(str(m.block_id) for m in metas)
            # index reads of the scan are attributed like everything
            # else (kind=analytics), preserving the invariant that
            # per-tenant vectors sum to the untagged read counters
            with usage.attribute(tenant, "analytics"):
                reports[tenant] = analyse_tenant(self.db, tenant, metas=metas,
                                                 block_memo=self._memo)
        # drop memo entries of deleted blocks + gauge label sets of
        # departed tenants (retention can remove whole tenants); _memo
        # is only ever touched under _scan_lock
        self._memo = {k: v for k, v in self._memo.items() if k in live_blocks}
        gone = self._known_tenants - set(tenants)
        self._known_tenants = set(tenants)
        for t in gone:
            for g in (zonemap_coverage_gauge, debt_row_groups_gauge,
                      debt_ratio_gauge, debt_payoff_gauge,
                      compression_ratio_gauge):
                g.drop_labels(tenant=t)
        for tenant, r in reports.items():
            debt = r["compactionDebt"]
            zonemap_coverage_gauge.set(r["zonemap"]["coverageRatio"], tenant=tenant)
            debt_row_groups_gauge.set(debt["mergeRowGroups"], tenant=tenant)
            debt_ratio_gauge.set(debt["debtRatio"], tenant=tenant)
            debt_payoff_gauge.set(debt["payoff"], tenant=tenant)
            compression_ratio_gauge.set(r["compressionRatio"], tenant=tenant)
        codec_bytes: dict[str, int] = {}
        for r in reports.values():
            for c, n in r["codecStoredBytes"].items():
                codec_bytes[c] = codec_bytes.get(c, 0) + n
        for c, n in codec_bytes.items():
            storage_codec_bytes_gauge.set(n, codec=c)
        # a codec that vanished from the fleet (compaction re-encoded
        # its last pages) must not report its last value forever
        for c in self._known_codecs - set(codec_bytes):
            storage_codec_bytes_gauge.drop_labels(codec=c)
        self._known_codecs = set(codec_bytes)
        dt = time.perf_counter() - t0
        analytics_scans_total.inc()
        analytics_scan_seconds.observe(dt)
        doc = {
            "scannedAt": time.time(),
            "scanSeconds": round(dt, 3),
            "fleet": fleet_summary(reports),
            "tenants": reports,
        }
        with self._lock:
            self.last = doc
            self.last_at = time.monotonic()
        return doc

    def last_report(self) -> dict | None:
        """Last completed scan, or None — never triggers IO."""
        with self._lock:
            return self.last

    def report(self, max_age_s: float | None = None) -> dict:
        """Last scan if fresh enough, else scan now. The /status/storage
        handler's entry (max_age defaults to one interval)."""
        max_age = self.interval_s if max_age_s is None else max_age_s

        def fresh():
            with self._lock:
                last, at = self.last, self.last_at
            if last is not None and time.monotonic() - at <= max_age:
                return last
            return None

        doc = fresh()
        if doc is not None:
            return doc
        with self._scan_lock:
            # a concurrent caller may have scanned while we waited
            doc = fresh()
            return doc if doc is not None else self._scan_locked()

    def start(self) -> "StorageScanner":
        if self._thread is not None:
            return self

        def loop():
            # first scan right away (short grace for the first blocklist
            # poll): gauges/alerts must not go no-data for a whole
            # interval on every deploy
            delay = min(5.0, self.interval_s)
            while not self._stop.wait(delay):
                delay = self.interval_s
                try:
                    self.scan_once()
                except Exception:
                    log.exception("storage analytics scan failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="storage-analytics")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
