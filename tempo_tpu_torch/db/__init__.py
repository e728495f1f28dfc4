"""TempoDB — the storage engine façade.

Port of tempo_tpu/db/__init__.py on one device. TempoDB takes `device`
(CUDA unless "cpu" is passed; raises without CUDA) and hands it to the
block writer and the compactor, whose sketch plane (bloom + HLL) runs
there; search, find and TraceQL run on the host, as the reference's do
on one device. Not ported yet, and refused rather than ignored: the
mesh paths (`compaction_device_shards` > 1 or several cards, Queue 1
item 4) and the backend cache (`cache` other than "none", the cache/
slice). The config keeps the fields of the shard-partial result cache
and the storage analytics, which App refuses to switch on until their
slice (ROADMAP Queue 1 item 1.2).

Reference: tempodb/tempodb.go:69-102 (Reader/Writer/Compactor interface),
:109-258 (readerWriter: backend selection, CompleteBlock, WriteBlock,
Find with blocklist shard/time filtering + parallel block lookups,
Search/Fetch dispatch, polling + compaction + retention loops).

The engine is synchronous-by-method (poll_now / compact_once /
retain_once) with optional background threads, so tests drive cycles
deterministically like the reference's tests do, and service modules own
their own loops.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

import torch

from tempo_tpu_torch import device as _device
from tempo_tpu_torch import encoding as encoding_registry
from tempo_tpu_torch.backend import TypedBackend, make_raw_backend
from tempo_tpu_torch.config_sections import ResultCacheConfig
from tempo_tpu_torch.db.blocklist import Blocklist, Poller
from tempo_tpu_torch.db.compaction import CompactionConfig, CompactionDriver
from tempo_tpu_torch.db.pool import JobPool
from tempo_tpu_torch.db.retention import RetentionDriver
from tempo_tpu_torch.encoding.common import (
    BlockConfig,
    CompactionOptions,
    SearchRequest,
    SearchResponse,
)
from tempo_tpu_torch.model.trace import Trace, combine_traces
from tempo_tpu_torch.util import metrics, tracing

log = logging.getLogger(__name__)

orphans_swept = metrics.counter(
    "tempodb_orphan_blocks_swept_total",
    "Meta-less partial blocks (crash between data and meta.json) deleted "
    "by the startup/maintenance orphan sweep",
)


@dataclass
class DBConfig:
    backend: str = "local"  # local | mock | s3 | gcs | azure
    backend_path: str = ""
    backend_options: dict = field(default_factory=dict)  # cloud backend config kwargs
    cache: str = "none"  # none only until the cache/ slice (reference: none | memory | memcached | redis)
    cache_options: dict = field(default_factory=dict)
    cache_background_writes: bool = False
    wal_path: str = ""
    block: BlockConfig = field(default_factory=BlockConfig)
    compaction: CompactionConfig = field(default_factory=CompactionConfig)
    pool_workers: int = 8
    blocklist_poll_s: float = 300.0
    build_tenant_index: bool = False
    stale_tenant_index_s: float = 0.0
    max_spans_per_trace: int = 0
    # >1 (or 0 with more than one card attached): the sharded compaction
    # and search mesh of the multi-GPU slice, which raises
    # NotImplementedError until then; 0 on one card, or 1: one device
    compaction_device_shards: int = 0
    # failure-domain hardening (backend/faults.py taxonomy):
    # consecutive read failures before a block is quarantined (skipped by
    # queries + compaction; checksum failures count double)
    quarantine_threshold: int = 3
    # meta-less partial blocks (a crash between data.bin and meta.json)
    # are deleted by sweep_orphans once they stay meta-less this long —
    # long enough that no healthy in-flight write is still mid-block
    orphan_grace_s: float = 900.0
    # storage-health analytics scan period (db/analytics, not ported:
    # App refuses > 0; the reference's default is 600)
    analytics_scan_s: float = 0.0
    # shard-partial result cache (resultcache/, not ported: App refuses
    # enabled)
    result_cache: ResultCacheConfig = field(default_factory=ResultCacheConfig)


class TempoDB:
    def __init__(self, cfg: DBConfig, raw_backend=None, device=None):
        self.cfg = cfg
        # the sketch plane's tensors name their card: block jobs run on
        # JobPool threads, which must not rely on a current-device default
        dev = _device.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if raw_backend is None:
            options = dict(cfg.backend_options)
            if cfg.backend == "local":
                options.setdefault(
                    "path", cfg.backend_path or os.path.join(os.getcwd(), "blocks")
                )
            raw_backend = make_raw_backend(cfg.backend, options)
            if cfg.cache != "none":
                raise NotImplementedError(
                    f"tempo_tpu_torch: backend cache {cfg.cache!r} is not ported "
                    "yet (the cache/ slice); use cache='none'")
        self.backend = TypedBackend(raw_backend)
        self.blocklist = Blocklist(quarantine_threshold=cfg.quarantine_threshold)
        self._orphan_seen: dict[tuple[str, str], float] = {}
        self._orphan_lock = threading.Lock()
        self.pool = JobPool(cfg.pool_workers)
        self.poller = Poller(
            self.backend,
            build_index=cfg.build_tenant_index,
            stale_tenant_index_s=cfg.stale_tenant_index_s,
            pool=self.pool,
        )
        self.compaction_cfg = cfg.compaction
        self.compactor_driver = CompactionDriver(self, cfg.compaction)
        self.retention_driver = RetentionDriver(self)
        self._poll_thread = None
        self._stop = threading.Event()
        self.last_poll = 0.0
        self._wal = None
        self._compaction_mesh = False  # False = not yet resolved
        # per-block tag enumeration memo (blocks are immutable)
        from collections import OrderedDict

        self._tag_cache: OrderedDict = OrderedDict()
        self._tag_cache_lock = threading.Lock()

    @property
    def wal(self):
        """Lazily-created WAL manager rooted at cfg.wal_path (the
        ingester's head-block store; reference: tempodb/wal/wal.go:47)."""
        if self._wal is None:
            from tempo_tpu_torch.db.wal import WAL

            path = self.cfg.wal_path or os.path.join(os.getcwd(), "wal")
            self._wal = WAL(path, version=self.cfg.block.version)
        return self._wal

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def encoding_for(self, version: str):
        return encoding_registry.from_version(version)

    def block_failure_recorder(self, tenant: str):
        """Callback feeding the blocklist quarantine: one failed block
        read, weighted double for checksum failures (definitively the
        block's fault, where a connection reset may not be)."""
        from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage

        def record(block_id: str, e: Exception):
            self.blocklist.record_block_failure(
                tenant, block_id, f"{type(e).__name__}: {e}",
                weight=2 if isinstance(e, CorruptPage) else 1,
            )

        return record

    def guard_block(self, tenant: str, block_id: str, fn, benign: tuple = ()):
        """Run one block-scoped read job under failure-domain accounting:
        failures count toward the block's quarantine (checksum failures
        count double — definitively the block's fault), successes reset
        the streak. NotFound passes through unweighted (a block deleted
        by compaction mid-query is a benign race, not a bad block), as
        do exception types in `benign` (engine bailouts like the
        vectorized TraceQL path's Unsupported). Transient errors get a
        short in-place retry (faults.with_retries) before any of that —
        per-op retries are what let a multi-block query converge under a
        sustained backend fault rate."""
        from tempo_tpu_torch.backend.base import NotFound as _NotFound
        from tempo_tpu_torch.backend.faults import with_retries

        try:
            out = with_retries(fn)
        except _NotFound:
            raise
        except Exception as e:
            if not isinstance(e, benign):
                self.block_failure_recorder(tenant)(block_id, e)
            raise
        self.blocklist.record_block_success(tenant, block_id)
        return out

    def default_encoding(self):
        return encoding_registry.from_version(self.cfg.block.version)

    def compaction_options(self) -> CompactionOptions:
        return CompactionOptions(
            block_config=self.cfg.block,
            max_spans_per_trace=self.cfg.max_spans_per_trace,
            mesh=self.compaction_mesh(),
        )

    def compaction_mesh(self):
        """Device mesh for sharded compaction: None on one device. The
        mesh (more than one card, or compaction_device_shards > 1) is the
        multi-GPU slice and raises NotImplementedError until then."""
        if self._compaction_mesh is False:
            n = self.cfg.compaction_device_shards
            if n != 1:
                avail = torch.cuda.device_count() if self.device.type == "cuda" else 1
                want = avail if n == 0 else n
                if want > 1:
                    raise NotImplementedError(
                        f"tempo_tpu_torch: a {want}-device compaction mesh is "
                        "not ported yet (ROADMAP Queue 1 item 12); set "
                        "compaction_device_shards=1")
            self._compaction_mesh = None
        return self._compaction_mesh

    def mesh_searcher(self):
        """Sharded multi-block searcher: None on one device (a mesh
        raises in compaction_mesh)."""
        return self.compaction_mesh()

    def mesh_metrics_evaluator(self):
        """Sharded query_range evaluator: None on one device (a mesh
        raises in compaction_mesh)."""
        return self.compaction_mesh()

    # ------------------------------------------------------------------
    # writer
    # ------------------------------------------------------------------

    def write_batch(self, tenant: str, batch, block_id=None):
        """Write one trace-sorted SpanBatch as a level-0 block (the
        ingester's CompleteBlock path ends here; reference:
        tempodb.CompleteBlockWithBackend tempodb.go:213)."""
        enc = self.default_encoding()
        meta = enc.create_block([batch], tenant, self.backend, self.cfg.block,
                                block_id=block_id, device=self.device)
        if meta is not None:
            self.blocklist.update(tenant, adds=[meta])
        return meta

    def write_wal_block(self, tenant: str, wal_block, block_id=None):
        merged = wal_block.all_spans().sorted_by_trace()
        return self.write_batch(tenant, merged, block_id=block_id)

    # ------------------------------------------------------------------
    # reader
    # ------------------------------------------------------------------

    def find(self, tenant: str, trace_id: bytes,
             block_start: str = "0" * 32, block_end: str = "f" * 32,
             time_start: int = 0, time_end: int = 0) -> Trace | None:
        """Trace-by-ID across blocks (reference: tempodb.Find:272 with
        includeBlock shard-range + time filtering :494-517; self-traced
        like the reference's tempodb.go:276 span). Partial traces from
        multiple blocks are combined."""
        with tracing.span("tempodb/find", tenant=tenant):
            return self._find_traced(tenant, trace_id, block_start, block_end,
                                     time_start, time_end)

    def _find_traced(self, tenant, trace_id, block_start, block_end,
                     time_start, time_end) -> Trace | None:
        hex_id = trace_id.hex().rjust(32, "0")
        metas = [
            m for m in self.blocklist.metas(tenant)
            if m.min_id <= hex_id <= m.max_id
            and _overlaps(m, time_start, time_end)
            and _in_shard(m, block_start, block_end)
        ]

        def job(meta):
            with tracing.span("tempodb/find_block", block=str(meta.block_id)):
                blk = self.encoding_for(meta.version).open_block(
                    meta, self.backend, self.cfg.block)
                return blk.find_trace_by_id(trace_id)

        results, errors = self.pool.run_jobs(
            [lambda m=m: self.guard_block(tenant, m.block_id, lambda: job(m)) for m in metas]
        )
        fatal = _fatal(errors)
        if fatal:
            # a failed block read could hide spans of this trace; surface it
            # rather than return a silently incomplete trace (NotFound is
            # the benign deleted-by-compaction race: that data lives in
            # the compaction output, which is also in the list)
            raise fatal[0]
        return combine_traces([r for r in results if r is not None])

    def search(self, tenant: str, req: SearchRequest) -> SearchResponse:
        """Tag search across blocks overlapping the request window
        (reference: tempodb.Search:357; sharding happens above us in the
        frontend, P4). On one device the blocks are searched on JobPool
        threads with the host read path; the reference's sharded mesh
        scan (parallel/search.MeshSearcher) is the multi-GPU slice."""
        metas = [
            m for m in self.blocklist.metas(tenant)
            if _overlaps(m, req.start_seconds, req.end_seconds)
        ]
        self.mesh_searcher()  # None on one device; a mesh raises
        out = SearchResponse()

        def job(meta):
            # per-block span (pool threads inherit the worker span via
            # the copied context, so these land as its children)
            with tracing.span("tempodb/search_block", block=str(meta.block_id)) as s:
                blk = self.encoding_for(meta.version).open_block(
                    meta, self.backend, self.cfg.block)
                r = blk.search(req)
                if s is not None:
                    s.attributes["inspected_bytes"] = r.inspected_bytes
                    s.attributes["pruned_row_groups"] = r.pruned_row_groups
                return r

        seen_ids: set = set()

        def enough(r):  # early exit once UNIQUE collected hits reach the limit
            seen_ids.update(t.trace_id_hex for t in r.traces)
            return bool(req.limit) and len(seen_ids) >= req.limit

        results, errors = self.pool.run_jobs(
            [lambda m=m: self.guard_block(tenant, m.block_id, lambda: job(m)) for m in metas],
            stop_when=enough,
        )
        fatal = _fatal(errors)
        if fatal:
            # strict by design: degradation (partial results within a
            # failed-shard budget) is the FRONTEND's call, not something
            # the storage layer silently decides per block
            raise fatal[0]
        for r in results:
            out.merge(r, limit=req.limit)
        return out

    def search_multi(self, tenant: str, reqs: list) -> list:
        """N tag searches, one SearchResponse per request, in order. On
        one device there is no batched mesh scan, so this is N search()
        calls — the reference's path without a mesh."""
        return [self.search(tenant, r) for r in reqs]

    def search_tags(self, tenant: str) -> set:
        """Tag names across this tenant's blocks (parity-plus: the
        reference snapshot's SearchTags covers only ingester data)."""
        return self._tag_fanout(tenant, "tag_names")

    def search_tag_values(self, tenant: str, tag: str) -> set:
        return self._tag_fanout(tenant, "tag_values", tag)

    def _tag_fanout(self, tenant: str, method: str, *args) -> set:
        """Per-block tag enumeration with a per-block memo (blocks are
        immutable, and UIs poll these endpoints on every explore load —
        without the memo each request re-reads every block's index,
        dictionary, and tag columns from the backend)."""
        jobs = []
        for m in self.blocklist.metas(tenant):
            key = (str(m.block_id), method, args)

            def job(meta=m, key=key):
                with self._tag_cache_lock:
                    hit = self._tag_cache.get(key)
                    if hit is not None:
                        self._tag_cache.move_to_end(key)
                        return hit
                from tempo_tpu_torch.model.tags import block_tag_names, block_tag_values

                blk = self.encoding_for(meta.version).open_block(meta, self.backend, self.cfg.block)
                if method == "tag_names":
                    vals = block_tag_names(blk)
                else:
                    vals = block_tag_values(blk, *args)
                with self._tag_cache_lock:
                    self._tag_cache[key] = vals
                    while len(self._tag_cache) > 2048:
                        self._tag_cache.popitem(last=False)
                return vals

            jobs.append(job)
        results, errors = self.pool.run_jobs(jobs)
        if errors and not results:
            raise errors[0]
        for e in errors:
            # partial failure must not poison the union, but it must be
            # visible — an incomplete tag dropdown with zero signal is
            # how operators chase ghosts
            log.warning("tag enumeration skipped a block: %s", e)
        out: set = set()
        for vals in results:
            out |= vals
        return out

    def search_block(self, tenant: str, block_id: str, req: SearchRequest,
                     start_row_group: int = 0, row_groups: int = 0) -> SearchResponse:
        """Search one specific block (the querier's backend-search job
        unit, reference: modules/querier SearchBlock:432), optionally
        bounded to a row-group subrange (the serverless/page-shard unit)."""

        def run():
            with tracing.span("tempodb/search_block", block=str(block_id)):
                meta = self.backend.block_meta(tenant, block_id)
                blk = self.encoding_for(meta.version).open_block(
                    meta, self.backend, self.cfg.block)
                return blk.search(req, start_row_group=start_row_group,
                                  row_groups=row_groups)

        return self.guard_block(tenant, block_id, run)

    def fetch_candidates(self, tenant: str, spec, start_s: int = 0, end_s: int = 0,
                         stats: dict | None = None):
        """TraceQL candidate fetch across blocks; traces straddling
        blocks are combined before the engine sees them (aggregates like
        count() must observe the whole trace)."""
        metas = [m for m in self.blocklist.metas(tenant) if _overlaps(m, start_s, end_s)]

        def job(meta):
            with tracing.span("tempodb/fetch_block", block=str(meta.block_id)):
                blk = self.encoding_for(meta.version).open_block(
                    meta, self.backend, self.cfg.block)
                out = blk.fetch_candidates(spec, start_s, end_s)
                # counters returned with the result: jobs run on pool
                # threads and a shared dict bump would race
                return (out, getattr(blk, "bytes_read", 0),
                        getattr(blk, "pruned_row_groups", 0),
                        getattr(blk, "coalesced_reads", 0),
                        getattr(blk, "decoded_bytes", 0))

        results, errors = self.pool.run_jobs(
            [lambda m=m: self.guard_block(tenant, m.block_id, lambda: job(m)) for m in metas]
        )
        fatal = _fatal(errors)
        if fatal:
            raise fatal[0]
        by_id: dict[bytes, list] = {}
        for traces, bytes_read, pruned, coalesced, decoded in results:
            if stats is not None:
                stats["inspectedBytes"] = stats.get("inspectedBytes", 0) + bytes_read
                stats["prunedRowGroups"] = stats.get("prunedRowGroups", 0) + pruned
                stats["coalescedReads"] = stats.get("coalescedReads", 0) + coalesced
                stats["decodedBytes"] = stats.get("decodedBytes", 0) + decoded
            for t in traces:
                by_id.setdefault(t.trace_id, []).append(t)

        # a candidate trace may straddle blocks where only some blocks'
        # spans matched the pushdown — re-collect its full span set from
        # every overlapping block so the engine sees whole traces
        if by_id and len(metas) > 1:
            hex_ids = {tid.hex().rjust(32, "0") for tid in by_id}

            def complete(meta):
                blk = self.encoding_for(meta.version).open_block(meta, self.backend, self.cfg.block)
                return blk.collect_spans_for_ids(hex_ids)

            full, errors = self.pool.run_jobs([lambda m=m: complete(m) for m in metas])
            fatal = _fatal(errors)
            if fatal:
                raise fatal[0]
            by_id = {}
            for traces in full:
                for t in traces:
                    by_id.setdefault(t.trace_id, []).append(t)
        return [combine_traces(parts) for parts in by_id.values()]

    def traceql_search(self, tenant: str, query: str, start_s: int = 0,
                       end_s: int = 0, limit: int = 20, stats: dict | None = None):
        """Execute a TraceQL query over this tenant's blocks (reference:
        traceql.Engine.Execute bridging SearchRequest -> Fetch,
        pkg/traceql/engine.go:25).

        Span-local pipelines run on the VECTORIZED path: per row group,
        numpy column scans + segment reductions produce per-trace
        partials; partials merge across blocks (a trace may straddle
        them) before aggregate filters resolve (traceql/vector.py, the
        columnar analog of vparquet/block_traceql.go's iterator trees).
        by()/select() ride the vector path too (grouped partials /
        attached fields), and structural evaluation (parent.*,
        childCount, the spanset ops >, >>, ~, &&, ||) runs as
        parent-span-id joins within trace segments; only filters after
        by()/aggregates and pipeline-valued spanset operands take the
        exact object engine.

        stats (optional dict) accumulates per-query observability
        (reference: modules/querier/stats/stats.proto): inspectedBytes /
        inspectedTraces / inspectedBlocks."""
        from tempo_tpu_torch.traceql import execute, vector
        from tempo_tpu_torch.traceql.parser import parse

        def bump(bytes_=0, traces=0, blocks=0, decoded=0):
            if stats is not None:
                stats["inspectedBytes"] = stats.get("inspectedBytes", 0) + int(bytes_)
                stats["inspectedTraces"] = stats.get("inspectedTraces", 0) + int(traces)
                stats["inspectedBlocks"] = stats.get("inspectedBlocks", 0) + int(blocks)
                stats["decodedBytes"] = stats.get("decodedBytes", 0) + int(decoded)

        pipeline = parse(query)
        metas = [m for m in self.blocklist.metas(tenant) if _overlaps(m, start_s, end_s)]
        if vector.supports(pipeline) and all(m.version == "vtpu1" for m in metas):
            # structural pipelines (spanset ops, parent.*, childCount)
            # join parent links per batch, which is exact only when each
            # trace lives wholly in one block; the jobs then also report
            # every trace id they scanned so straddling is detected
            # EXACTLY (not guessed from id ranges) and the query re-runs
            # on the object engine, which sees combined traces
            structural = vector.needs_whole_traces(pipeline) and len(metas) > 1

            def job(meta):
                blk = self.encoding_for(meta.version).open_block(meta, self.backend, self.cfg.block)
                local: dict = {}
                n_traces = 0
                seen_tids = set()
                for view, d in blk.iter_eval_views(pipeline, start_s, end_s):
                    firsts, _ = view.trace_boundaries()
                    n_traces += len(firsts)
                    if structural:
                        tids = np.ascontiguousarray(
                            view.cols["trace_id"][firsts]).astype(">u4")
                        seen_tids.update(t.tobytes() for t in tids)
                    for tid, p in vector.evaluate_batch(pipeline, view, d).items():
                        if tid in local:
                            local[tid].merge(p)
                        else:
                            local[tid] = p
                return local, blk.bytes_read, n_traces, seen_tids, blk.decoded_bytes

            results, errors = self.pool.run_jobs(
                [lambda m=m: self.guard_block(tenant, m.block_id, lambda: job(m),
                                              benign=(vector.Unsupported,))
                 for m in metas]
            )
            straddled = False
            if structural and not _fatal(errors):
                counts: dict = {}
                for _local, _b, _n, seen, _d in results:
                    for tid in seen:
                        counts[tid] = counts.get(tid, 0) + 1
                straddled = any(c > 1 for c in counts.values())
            if any(isinstance(e, vector.Unsupported) for e in errors) or straddled:
                # data-shape bailout (mixed value types for one attr key,
                # or a trace straddling blocks under a structural query):
                # the object engine below answers exactly
                pass
            elif _fatal(errors):
                raise _fatal(errors)[0]
            else:
                partials: dict = {}
                for local, bytes_read, n_traces, _seen, decoded in results:
                    bump(bytes_=bytes_read, traces=n_traces, blocks=1, decoded=decoded)
                    for tid, p in local.items():
                        if tid in partials:
                            partials[tid].merge(p)
                        else:
                            partials[tid] = p
                return vector.finalize(pipeline, partials, limit, start_s, end_s)

        def fetch(spec, s, e):
            candidates = self.fetch_candidates(tenant, spec, s, e, stats=stats)
            bump(traces=len(candidates), blocks=len(metas))
            return candidates

        return execute(query, fetch, start_s=start_s, end_s=end_s, limit=limit)

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------

    def poll_now(self):
        metas, compacted = self.poller.do()
        self.blocklist.apply_poll_results(metas, compacted)
        self.last_poll = time.time()

    def sweep_orphans(self, grace_s: float | None = None, now: float | None = None) -> list[tuple[str, str]]:
        """Delete meta-less partial blocks — the debris of a crash
        between data/index/bloom writes and the meta.json commit (the
        meta-LAST protocol makes such blocks invisible; this reclaims
        their bytes). A block must be seen meta-less on an earlier sweep
        at least grace_s ago before it is deleted, so a healthy writer
        mid-block is never raced. Returns the (tenant, block_id) pairs
        removed. Run by the compactor's retention cycle (one owner — the
        same instance that may clear compacted blocks), or explicitly at
        startup."""
        from tempo_tpu_torch.backend.base import NotFound as _NF

        grace = self.cfg.orphan_grace_s if grace_s is None else grace_s
        now = now or time.time()
        removed: list[tuple[str, str]] = []

        def is_orphan(tenant, block_id):
            """True only when BOTH metas are definitively absent; a
            transient read error is not evidence of anything."""
            for read in (self.backend.block_meta, self.backend.compacted_block_meta):
                try:
                    read(tenant, block_id)
                    return False
                except _NF:
                    continue
                except Exception:
                    return None  # unknown: skip this cycle
            return True

        for tenant in self.backend.tenants():
            for block_id in self.backend.blocks(tenant):
                key = (tenant, block_id)
                orphan = is_orphan(tenant, block_id)
                if orphan is None:
                    continue
                if not orphan:
                    with self._orphan_lock:
                        self._orphan_seen.pop(key, None)
                    continue
                with self._orphan_lock:
                    first = self._orphan_seen.setdefault(key, now)
                if now - first < grace:
                    continue
                log.warning(
                    "orphan sweep: deleting meta-less partial block %s/%s "
                    "(meta-less for %.0fs)", tenant, block_id, now - first,
                )
                try:
                    self.backend.clear_block(tenant, block_id)
                except Exception:
                    log.exception("orphan sweep: clearing %s/%s failed", tenant, block_id)
                    continue
                with self._orphan_lock:
                    self._orphan_seen.pop(key, None)
                orphans_swept.inc(tenant=tenant)
                removed.append(key)
        return removed

    def compact_once(self, tenant: str | None = None, max_jobs: int = 0) -> int:
        if tenant is not None:
            return self.compactor_driver.compact_tenant(tenant, max_jobs=max_jobs)
        return self.compactor_driver.run_one_cycle()

    def retain_once(self, now=None):
        self.retention_driver.run_once(now=now)

    def enable_polling(self):
        if self._poll_thread:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.cfg.blocklist_poll_s):
                try:
                    self.poll_now()
                except Exception:
                    import logging

                    logging.getLogger(__name__).exception("blocklist poll failed")

        self._poll_thread = threading.Thread(target=loop, daemon=True, name="blocklist-poll")
        self._poll_thread.start()

    def shutdown(self):
        self._stop.set()
        if self._poll_thread:
            self._poll_thread.join(timeout=5)
            self._poll_thread = None


def _fatal(errors) -> list:
    """Drop the benign deleted-mid-query race (NotFound) from a job-pool
    error list; everything left must be surfaced, never swallowed."""
    from tempo_tpu_torch.backend.base import NotFound

    return [e for e in errors if not isinstance(e, NotFound)]


def _overlaps(meta, start: int, end: int) -> bool:
    if start and meta.end_time < start:
        return False
    if end and meta.start_time > end:
        return False
    return True


def _in_shard(meta, block_start: str, block_end: str) -> bool:
    """Block's [min,max] ID range intersects the queried blockID shard
    (frontend trace-by-ID sharding, reference: tracebyidsharding.go:228)."""
    return meta.max_id >= block_start and meta.min_id <= block_end
