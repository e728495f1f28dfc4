"""Querier — executes queries against ingesters (recent) + backend blocks.

Reference: modules/querier/querier.go (FindTraceByID:186 fanning to the
ring replication set then the store, SearchRecent:326, SearchBlock:432,
TraceQL delegation :469).

Port of tempo_tpu/modules/querier.py on one device: find by ID, search
(live segments and blocks), tags, TraceQL, and query_range over live
data (host accumulator) and over blocks (evaluate_block into the
accumulator of the DB's device: seg_bincount on the card), with the
compiled tier claiming simple-count plans over blocks first
(query_range_blocks, query_range_blocks_multi), and the live-tail hook
of the device tier's ingest tail (a parked WAL segment's search mask by
`ops/ingest_tail.tail_search_mask`). With the result cache on
(tempo_tpu_torch/resultcache), search, query_range and graph jobs reuse
each block's cached partial and recompute only the blocks they miss,
through the same device path as with the cache off; a query_range
block's partial comes from a standalone accumulator of its own, and the
cached tier outranks the compiled tier. With `external_endpoints`
set, each block-search job goes round-robin to a serverless endpoint
(tempo_tpu_torch/serverless.py), as in the reference. With a device
mesh (TempoDB.compaction_mesh: more than one local device) a block
batch's search runs the mesh scan (MeshSearcher.search_blocks), N
requests over one batch the batched multi-query scan
(search_block_batch_multi, search_multi), and a query_range job the
mesh bincount (MeshMetricsEvaluator) once the compiled tier declines.
The graph jobs (graph_recent, graph_blocks) sum their critical paths on
the DB's device.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from tempo_tpu_torch.backend.base import NotFound
from tempo_tpu_torch.encoding.common import SearchRequest, SearchResponse, TraceSearchMetadata
from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.model.trace import combine_traces
from tempo_tpu_torch.ops import hashing

log = logging.getLogger(__name__)


class Querier:
    def __init__(self, db, ring=None, ingester_clients: dict | None = None,
                 external_endpoints: list | None = None):
        """ingester_clients: instance_id -> object with
        find_trace_by_id(tenant, tid) and live_batches(tenant).

        external_endpoints: serverless search URLs; when set, backend
        block-search jobs are delegated round-robin (reference:
        searchExternalEndpoint querier.go:540, config
        search_external_endpoints)."""
        self.db = db
        self.ring = ring
        self.ingester_clients = ingester_clients or {}
        self.external_endpoints = list(external_endpoints or [])
        self._ext_clients = None
        self._ext_rr = 0

    # ------------------------------------------------------------------
    def _replica_clients(self, tenant: str, trace_id: bytes):
        if not self.ring or not self.ingester_clients:
            return list(self.ingester_clients.values())
        token = hashing.token_for(tenant, trace_id)
        reps = self.ring.get_replicas(token)
        return [self.ingester_clients[r.instance_id] for r in reps if r.instance_id in self.ingester_clients]

    def find_trace_by_id(self, tenant: str, trace_id: bytes, mode: str = "all",
                         block_start: str = "0" * 32, block_end: str = "f" * 32):
        """mode: ingesters | blocks | all (reference: querier.go:186 +
        the frontend's mode param, pkg/api)."""
        parts = []
        if mode in ("ingesters", "all"):
            for client in self._replica_clients(tenant, trace_id):
                try:
                    t = client.find_trace_by_id(tenant, trace_id)
                    if t is not None:
                        parts.append(t)
                except Exception:
                    log.exception("ingester find failed")
        if mode in ("blocks", "all"):
            t = self.db.find(tenant, trace_id, block_start=block_start, block_end=block_end)
            if t is not None:
                parts.append(t)
        return combine_traces(parts)

    # ------------------------------------------------------------------
    def _live_batches(self, tenant: str):
        """All not-yet-flushed columnar segments across ingesters; a
        failing ingester is skipped, not fatal."""
        from tempo_tpu_torch.encoding.vtpu.block import inspected_bytes_total
        from tempo_tpu_torch.util import usage

        out = []
        for client in self.ingester_clients.values():
            try:
                out.extend(client.live_batches(tenant))
            except Exception:
                log.exception("ingester live_batches failed")
        # live-tail scans are query cost like any block read: charge the
        # scanned bytes to the requesting tenant (counter + vector move
        # together, preserving the attribution-exactness invariant)
        scanned = sum(b.nbytes() for b in out)
        if scanned:
            usage.account_bytes(inspected_bytes_total, "inspected_bytes",
                                tenant, scanned)
        return out

    def search_recent(self, tenant: str, req: SearchRequest) -> SearchResponse:
        """Search not-yet-flushed data on all ingesters (reference:
        SearchRecent:326; ours scans live columnar segments)."""
        resp = SearchResponse()
        for batch in self._live_batches(tenant):
            resp.merge(_search_batch(batch, req), limit=req.limit)
        return resp

    def search_block_job(self, tenant: str, block_id: str, req: SearchRequest,
                         start_row_group: int = 0, row_groups: int = 0) -> SearchResponse:
        if self.external_endpoints:
            return self._search_external(tenant, block_id, req, start_row_group, row_groups)
        return self.db.search_block(tenant, block_id, req,
                                    start_row_group=start_row_group, row_groups=row_groups)

    def search_block_batch(self, tenant: str, block_ids: list, req: SearchRequest) -> SearchResponse:
        """One frontend job = a batch of blocks. With a device mesh the
        whole batch goes through the sharded scan in stacked dispatches
        (parallel/search.MeshSearcher — reference P4,
        modules/frontend/searchsharding.go:266-314); otherwise blocks
        scan serially like the reference's per-job loop. With the result
        cache on (and no external endpoints), each block's response is
        reused from (and written back to) it instead."""
        rc = self.db.result_cache
        if rc.enabled() and not self.external_endpoints:
            return self._search_block_batch_cached(tenant, block_ids, req, rc)
        searcher = self.db.mesh_searcher() if not self.external_endpoints else None
        if searcher is not None and len(block_ids) > 1:
            metas = self._batch_metas(tenant, block_ids, "search")
            if metas and all(m.version == "vtpu1" for m in metas):
                return searcher.search_blocks(
                    self._open_lazily(metas), req,
                    on_block_error=self.db.block_failure_recorder(tenant),
                    on_block_ok=self.db.block_success_recorder(tenant),
                )
        resp = SearchResponse()
        for block_id in block_ids:
            resp.merge(self.search_block_job(tenant, block_id, req), limit=req.limit)
        return resp

    def _batch_metas(self, tenant: str, block_ids: list, what: str) -> list:
        """The batch's block metas: only a definitive NotFound (deleted by
        compaction between shard planning and execution) skips a block; a
        transient meta-read error raises so the worker retries the job."""
        metas = []
        for bid in block_ids:
            try:
                metas.append(self.db.backend.block_meta(tenant, bid))
            except NotFound:
                log.warning("%s job: block %s deleted mid-query", what, bid)
        return metas

    def _open_lazily(self, metas):
        """Blocks opened as a scan reaches them: early exit skips the
        rest."""
        return (
            self.db.encoding_for(m.version).open_block(m, self.db.backend, self.db.cfg.block)
            for m in metas
        )

    def search_multi(self, tenant: str, reqs: list) -> list:
        """N concurrent searches answered together: the recent/live
        segments scan per request on the host, while the block portion
        coalesces into the batched multi-query device scan
        (TempoDB.search_multi) — one fused launch per query batch instead
        of one per query, served from the device-resident tier when the
        pages are pinned."""
        reqs = list(reqs)
        if not reqs:
            return []
        block = self.db.search_multi(tenant, reqs)
        out = []
        for req, blocks_resp in zip(reqs, block):
            r = self.search_recent(tenant, req)
            r.merge(blocks_resp, limit=req.limit)
            out.append(r)
        return out

    def search_block_batch_multi(self, tenant: str, block_ids: list,
                                 reqs: list) -> list:
        """The job-level multi-query seam: one frontend job carrying N
        requests against the same block batch. Same routing rules as
        search_block_batch; without a mesh (or with fewer than two
        requests or blocks) the requests run as sequential jobs
        (bit-identical results, N dispatches)."""
        reqs = list(reqs)
        if not reqs:
            return []
        searcher = self.db.mesh_searcher() if not self.external_endpoints else None
        if searcher is not None and len(reqs) > 1 and len(block_ids) > 1:
            metas = self._batch_metas(tenant, block_ids, "search")
            if metas and all(m.version == "vtpu1" for m in metas):
                return searcher.search_blocks_multi(
                    self._open_lazily(metas), reqs,
                    on_block_error=self.db.block_failure_recorder(tenant),
                    on_block_ok=self.db.block_success_recorder(tenant),
                )
        return [self.search_block_batch(tenant, block_ids, r) for r in reqs]

    def _search_external(self, tenant, block_id, req, start_row_group, row_groups) -> SearchResponse:
        """Delegate one block-search job to a serverless endpoint."""
        import json
        import urllib.parse

        from tempo_tpu_torch.api.params import SearchBlockRequest, build_search_block_params
        from tempo_tpu_torch.backend.httpclient import PooledHTTPClient

        if self._ext_clients is None:
            self._ext_clients = []
            for ep in self.external_endpoints:
                u = urllib.parse.urlsplit(ep)
                self._ext_clients.append(
                    (PooledHTTPClient(f"{u.scheme}://{u.netloc}"), u.path or "/")
                )
        client, path = self._ext_clients[self._ext_rr % len(self._ext_clients)]
        self._ext_rr += 1
        sbr = SearchBlockRequest(search=req, block_id=block_id,
                                 start_row_group=start_row_group, row_groups=row_groups)
        qs = urllib.parse.urlencode(build_search_block_params(sbr))
        _, body, _ = client.request(
            "GET", f"{path}?{qs}", headers={"X-Scope-OrgID": tenant}, ok=(200,)
        )
        return SearchResponse.from_dict(json.loads(body))

    def _search_block_batch_cached(self, tenant: str, block_ids: list,
                                   req: SearchRequest, rc) -> SearchResponse:
        """Per-block search with shard-partial reuse (tempo_tpu/
        resultcache): blocks are immutable and the per-block scan
        deterministic, so each block's response caches under
        (block, normalized shape + literals). A provably-empty block
        (impossible predicate or every row group zone-pruned — zero
        traces inspected, not merely zero matches) caches a negative
        veto, so repeats skip the block open entirely."""
        from tempo_tpu_torch import resultcache as rc_mod
        from tempo_tpu_torch.util import queryshape

        fp = rc_mod.fingerprint(
            queryshape.search_shape(req),
            queryshape.query_literals(req.query or ""),
            sorted((req.tags or {}).items()),
            int(req.min_duration_ns), int(req.max_duration_ns),
            int(req.start_seconds), int(req.end_seconds), int(req.limit))
        resp = SearchResponse()
        for block_id in block_ids:
            doc = rc.get(tenant, block_id, "search", fp)
            if doc is not None:
                if doc.get("neg"):
                    continue  # veto: no meta fetch, no block open
                hit = SearchResponse.from_dict(doc["w"])
                # the stored cost stats describe the COLD compute — a
                # hit did none of that work (rc.get already credited the
                # saved bytes); the result content merges unchanged
                hit.inspected_bytes = hit.decoded_bytes = 0
                hit.inspected_traces = hit.inspected_blocks = 0
                hit.pruned_row_groups = hit.coalesced_reads = 0
                resp.merge(hit, limit=req.limit)
                continue
            sub = self.db.search_block(tenant, block_id, req)
            if sub.status == "complete" and not sub.failed_shards:
                if (not sub.traces and sub.inspected_traces == 0
                        and rc.negative_enabled()):
                    rc.put_negative(tenant, block_id, "search", fp,
                                    bytes_saved=sub.inspected_bytes)
                else:
                    rc.put(tenant, block_id, "search", fp, sub.to_dict(),
                           bytes_saved=sub.inspected_bytes)
            resp.merge(sub, limit=req.limit)
        return resp

    # ------------------------------------------------------------------
    # TraceQL metrics (query_range)
    # ------------------------------------------------------------------
    def query_range_recent(self, tenant: str, query: str, start_s: int,
                           end_s: int, step_s: int, max_series: int = 64,
                           exemplars: int = 0) -> dict:
        """Metrics over not-yet-flushed ingester data: live trace
        segments AND head/completing WAL blocks (live_batches covers
        both), so the range vector's recent-time tail exists before any
        block hits the backend."""
        from tempo_tpu_torch.metrics_engine import (
            HostAccumulator,
            compile_metrics_plan,
            eval_batch,
        )

        plan = compile_metrics_plan(query, start_s, end_s, step_s,
                                    max_series=max_series, exemplars=exemplars)
        acc = HostAccumulator(plan)
        for batch in self._live_batches(tenant):
            acc.stats["inspectedSpans"] += batch.num_spans
            acc.add(eval_batch(plan, batch, batch.dictionary, acc.series), batch)
        return acc.to_wire()

    def query_range_blocks(self, tenant: str, block_ids: list, query: str,
                           start_s: int, end_s: int, step_s: int,
                           max_series: int = 64, exemplars: int = 0) -> dict:
        """One frontend metrics job = a batch of backend blocks. With a
        device mesh the whole batch reduces through the sharded bincount
        (parallel/metrics.MeshMetricsEvaluator); otherwise row groups
        fold through the accumulator of the DB's device: the CUDA
        seg_bincount on the card, the host numpy fold on the CPU — the
        same integer counts on every path."""
        from tempo_tpu_torch.metrics_engine import (
            compile_metrics_plan,
            evaluate_block,
            make_accumulator,
        )

        plan = compile_metrics_plan(query, start_s, end_s, step_s,
                                    max_series=max_series, exemplars=exemplars)
        metas = self._batch_metas(tenant, block_ids, "metrics")
        # result cache (tempo_tpu_torch/resultcache): per-block integer-add
        # partials are reusable verbatim because blocks are immutable —
        # this tier outranks the compiled tier below (which fuses blocks
        # into one launch and so produces nothing per-block-cacheable).
        # Returns None only on a series-cap overflow, where per-block
        # evaluation can diverge from the shared-table cold path —
        # exactness over economy: fall through and recompute cold.
        if self.db.result_cache.enabled():
            wire = self._query_range_blocks_cached(
                tenant, metas, plan, query, start_s, end_s, step_s,
                max_series, exemplars)
            if wire is not None:
                return wire
        # step-partial downsampling tier (standing/rules.py): a plan a
        # configured rule can answer exactly reads pre-bucketed count
        # pages row-group-wise instead of span columns — span-column
        # fetch bytes ~0, results bit-identical (legacy row groups fall
        # back to the span path inside the hybrid evaluator).
        from tempo_tpu_torch.standing import rules as sp_rules

        sp_rule = (sp_rules.match_rule(plan, sp_rules.block_rules(self.db.cfg.block))
                   if all(m.version == "vtpu1" for m in metas) else None)
        # the mesh gains nothing on partial-bearing blocks (the fold is
        # integer adds over kilobytes) — but a matched PLAN over an
        # all-legacy store must not lose the mesh path, so with a mesh
        # the first block's index is probed for an actual partial before
        # the tier claims the job
        evaluator = self.db.mesh_metrics_evaluator()
        if sp_rule is not None and evaluator is not None and metas:
            try:
                probe = self.db.encoding_for(metas[0].version).open_block(
                    metas[0], self.db.backend, self.db.cfg.block)
                if not any(sp_rules.rg_has_partial(rg, sp_rule)
                           for rg in probe.index().row_groups):
                    sp_rule = None  # legacy store: keep the device path
            except Exception:
                log.exception("step-partial probe failed; using span path")
        # compiled tier (tempo_tpu_torch/compiled): a simple-count plan
        # whose filters flatten to per-column predicates runs as ONE
        # fused program over the whole block batch, shape-cached. The
        # step-partial tier outranks it (pre-bucketed pages beat any span
        # scan); a decline falls through to the mesh evaluator or the
        # interpreter below, bit-identically.
        if sp_rule is None and all(m.version == "vtpu1" for m in metas):
            from tempo_tpu_torch import compiled

            wire = compiled.try_query_range(self.db, tenant, plan, metas)
            if wire is not None:
                return wire
        if sp_rule is None and evaluator is not None and len(metas) > 1 and all(
            m.version == "vtpu1" for m in metas
        ):
            from tempo_tpu_torch.metrics_engine import HostAccumulator

            acc = HostAccumulator(plan)
            evaluator.evaluate_blocks(
                self._open_lazily(metas), plan, acc,
                on_block_error=self.db.block_failure_recorder(tenant),
                on_block_ok=self.db.block_success_recorder(tenant),
            )
            wire = acc.to_wire()
            # the compiled tier declined (or is off): the job ran on an
            # interpreter path — insights aggregate this per query
            wire["compiledShape"] = "fallback"
            return wire
        dev = self.db.device
        acc = make_accumulator(plan, device=dev)
        for m in metas:
            # per-block sub-accumulator (shared series table), merged
            # only on success: counts have no dedupe, so a block deleted
            # mid-evaluation must contribute nothing — its spans live on
            # in the compaction output that replaced it
            sub = make_accumulator(plan, device=dev, series=acc.series)

            def run(meta=m, sub=sub):
                blk = self.db.encoding_for(meta.version).open_block(
                    meta, self.db.backend, self.db.cfg.block)
                sub.stats["inspectedBlocks"] += 1
                if sp_rule is not None:
                    sp_rules.evaluate_block_hybrid(plan, sp_rule, blk, sub)
                else:
                    evaluate_block(plan, blk, sub)
                sub.stats["inspectedBytes"] += blk.bytes_read
                sub.stats["decodedBytes"] += getattr(blk, "decoded_bytes", 0)

            try:
                self.db.guard_block(tenant, m.block_id, run)
            except NotFound:
                log.warning("metrics job: block %s deleted mid-query", m.block_id)
                continue
            acc.counts += sub.merged_counts()
            for k, v in sub.stats.items():
                acc.stats[k] = acc.stats.get(k, 0) + v
            for key, ex in sub.exemplars.items():
                have = acc.exemplars.setdefault(key, [])
                have.extend(ex[: max(0, plan.exemplars - len(have))])
        wire = acc.to_wire()
        # the compiled tier declined (or is off): the job ran on the
        # interpreter — insights aggregate this per query
        wire["compiledShape"] = "fallback"
        return wire

    def _query_range_blocks_cached(self, tenant: str, metas: list, plan,
                                   query: str, start_s: int, end_s: int,
                                   step_s: int, max_series: int,
                                   exemplars: int) -> dict | None:
        """query_range over blocks with shard-partial reuse: every block
        evaluates into a STANDALONE accumulator (own series table, on the
        DB's device: seg_bincount on the card) whose
        wire caches under (block, normalized shape + literals + window);
        block wires then fold through merge_wire — the same integer-add
        seam the frontend uses, so merge order never changes results. A
        block with zero spans inspected (dictionary-miss impossibility
        or every row group zone/window-pruned) caches a negative veto
        that skips the open entirely on repeats.

        Exactness guard: per-block series tables can overflow the
        max_series cap differently than the cold shared table. If any
        wire reports dropped series, or the merged key set exceeds the
        cap, returns None — the caller recomputes through the cold
        tiers, bit-identically, and nothing wrong was cached (wires are
        per-block facts either way)."""
        from tempo_tpu_torch import resultcache as rc_mod
        from tempo_tpu_torch.metrics_engine import (
            evaluate_block,
            make_accumulator,
            merge_wire,
            new_wire,
        )
        from tempo_tpu_torch.standing import rules as sp_rules
        from tempo_tpu_torch.util import queryshape

        rc = self.db.result_cache
        # same hybrid choice as the cold host path: the step-partial
        # evaluator falls back per row group on legacy data by itself
        sp_rule = (sp_rules.match_rule(plan,
                                       sp_rules.block_rules(self.db.cfg.block))
                   if all(m.version == "vtpu1" for m in metas) else None)
        fp = rc_mod.fingerprint(
            queryshape.metrics_shape(query),
            queryshape.query_literals(query),
            int(start_s), int(end_s), int(step_s),
            int(max_series), int(exemplars))
        wires = []
        overflow = False
        for m in metas:
            doc = rc.get(tenant, m.block_id, "metrics", fp)
            if doc is not None:
                if doc.get("neg"):
                    continue  # veto: no open, no fetch
                w = dict(doc["w"])
                # cost stats describe the cold compute (saved bytes are
                # credited by rc.get); only the correctness stat stays
                w["stats"] = {
                    "seriesDropped": int(
                        (doc["w"].get("stats") or {}).get("seriesDropped", 0))
                }
                if w["stats"]["seriesDropped"]:
                    overflow = True
                wires.append(w)
                continue
            sub = make_accumulator(plan, device=self.db.device)

            def run(meta=m, sub=sub):
                blk = self.db.encoding_for(meta.version).open_block(
                    meta, self.db.backend, self.db.cfg.block)
                sub.stats["inspectedBlocks"] += 1
                if sp_rule is not None:
                    sp_rules.evaluate_block_hybrid(plan, sp_rule, blk, sub)
                else:
                    evaluate_block(plan, blk, sub)
                sub.stats["inspectedBytes"] += blk.bytes_read
                sub.stats["decodedBytes"] += getattr(blk, "decoded_bytes", 0)

            try:
                self.db.guard_block(tenant, m.block_id, run)
            except NotFound:
                log.warning("metrics job: block %s deleted mid-query",
                            m.block_id)
                continue
            w = sub.to_wire()
            saved = int(w["stats"].get("inspectedBytes", 0))
            if w["stats"].get("seriesDropped", 0):
                overflow = True
            if (not w["series"] and not w["exemplars"]
                    and w["stats"].get("inspectedSpans", 0) == 0
                    and rc.negative_enabled()):
                rc.put_negative(tenant, m.block_id, "metrics", fp,
                                bytes_saved=saved)
            else:
                rc.put(tenant, m.block_id, "metrics", fp, w,
                       bytes_saved=saved)
            wires.append(w)
        merged = new_wire()
        for w in wires:
            merge_wire(merged, w, plan, 0)
        if overflow or len(merged["series"]) > plan.max_series:
            log.warning("result cache: series cap overflow for %r; "
                        "recomputing cold", query)
            return None
        # merged state -> to_wire form. Key order: merged["series"]
        # insertion order is first-nonzero-appearance across blocks in
        # meta order, which (under the cap guard above) equals the cold
        # shared table's first-seen slot order; bins re-sort ascending.
        # finalize_matrix sorts keys anyway — this keeps the wire itself
        # identical, not just the final matrix.
        series_out = [
            {"key": key,
             "bins": [[int(i), int(bins[i])] for i in sorted(bins)]}
            for key, bins in merged["series"].items()
        ]
        return {
            "series": series_out,
            "exemplars": [
                {"key": key, **ex}
                for key, exs in merged["exemplars"].items()
                for ex in exs
            ],
            "stats": merged["stats"],
            "compiledShape": "fallback",
        }

    def query_range_blocks_multi(self, tenant: str, block_ids: list,
                                 queries: list, start_s: int, end_s: int,
                                 step_s: int, max_series: int = 64,
                                 exemplars: int = 0) -> list:
        """N concurrent query_range requests against ONE block batch:
        lowerable same-shape plans coalesce into one fused compiled
        launch over a shared page stack; the rest run one by one.
        Results are positionally aligned and bit-identical to N
        sequential query_range_blocks calls."""
        from tempo_tpu_torch.metrics_engine import compile_metrics_plan

        queries = list(queries)
        if not queries:
            return []
        plans = [compile_metrics_plan(q, start_s, end_s, step_s,
                                      max_series=max_series,
                                      exemplars=exemplars)
                 for q in queries]
        out = [None] * len(queries)
        metas = self._batch_metas(tenant, block_ids, "metrics")
        if len(plans) > 1 and metas and all(m.version == "vtpu1"
                                            for m in metas):
            from tempo_tpu_torch import compiled

            out = compiled.try_query_range_many(self.db, tenant, plans, metas)
        for i, q in enumerate(queries):
            if out[i] is None:
                out[i] = self.query_range_blocks(
                    tenant, block_ids, q, start_s, end_s, step_s,
                    max_series=max_series, exemplars=exemplars)
        return out

    # ------------------------------------------------------------------
    # trace-graph analytics (service dependencies / critical paths)
    # ------------------------------------------------------------------
    def graph_recent(self, tenant: str, q: str, start_s: int, end_s: int,
                     want: str, by: str = "service") -> dict:
        """Graph partials over not-yet-flushed ingester data (live trace
        segments + WAL head blocks), the recent-window complement of
        graph_blocks — same disjointness contract as search_recent. The
        critical path's root sums run on the DB's device."""
        from tempo_tpu_torch import graph

        pipeline = graph.parse_root_filter(q)
        wire = (graph.new_deps_wire() if want == "deps"
                else graph.new_cp_wire(by))
        for batch in self._live_batches(tenant):
            rows = graph.batch_graph_rows(batch, pipeline, start_s, end_s)
            if rows is None:
                continue
            if want == "deps":
                graph.deps_partial(rows, batch.dictionary, wire=wire)
            else:
                graph.cp_partial(rows, batch.dictionary, by=by, wire=wire,
                                 device=self.db.device,
                                 bucket_for=self.db.cfg.block.bucket_for)
        return wire

    def graph_blocks(self, tenant: str, block_ids: list, q: str, start_s: int,
                     end_s: int, want: str, by: str = "service") -> dict:
        """One frontend graph job = a batch of backend blocks. Each block
        commits its partial only after evaluating WHOLE (the metrics-path
        contract: integer partials have no dedupe, so a block deleted
        mid-scan must contribute nothing — its spans live on in the
        compaction output that replaced it). A cached partial skips the
        block and its critical path's root sums."""
        from tempo_tpu_torch import graph

        pipeline = graph.parse_root_filter(q)
        wire = (graph.new_deps_wire() if want == "deps"
                else graph.new_cp_wire(by))
        # result cache: a block's graph partial is a pure function of
        # (block, query, window, want, by) — the same reuse contract as
        # the metrics partials (run() below already returns a standalone
        # JSON-safe wire, which is exactly the cacheable unit)
        rc = self.db.result_cache
        rc_fp = None
        if rc.enabled():
            from tempo_tpu_torch import resultcache as rc_mod
            from tempo_tpu_torch.util import queryshape

            rc_fp = rc_mod.fingerprint(
                "graph|" + queryshape.normalize_query(q or ""),
                queryshape.query_literals(q or ""),
                want, by, int(start_s), int(end_s))
        for bid in block_ids:
            if rc_fp is not None:
                doc = rc.get(tenant, bid, "graph", rc_fp)
                if doc is not None and not doc.get("neg"):
                    sub = doc["w"]
                    # cost stats describe the cold compute; the saved
                    # bytes were credited by rc.get
                    sub["stats"] = {**sub.get("stats", {}),
                                    "inspectedBlocks": 0,
                                    "inspectedBytes": 0,
                                    "decodedBytes": 0}
                    if want == "deps":
                        graph.merge_deps_wire(wire, sub)
                    else:
                        graph.merge_cp_wire(wire, sub)
                    continue
            try:
                meta = self.db.backend.block_meta(tenant, bid)
            except NotFound:
                log.warning("graph job: block %s deleted mid-query", bid)
                continue

            def run(meta=meta):
                blk = self.db.encoding_for(meta.version).open_block(
                    meta, self.db.backend, self.db.cfg.block)
                stats = {"inspectedBlocks": 1}
                rows = graph.collect_block_rows(
                    blk, pipeline, start_s, end_s, stats=stats)
                sub = (graph.new_deps_wire() if want == "deps"
                       else graph.new_cp_wire(by))
                if rows is not None:
                    if want == "deps":
                        graph.deps_partial(rows, blk.dictionary(), wire=sub)
                    else:
                        graph.cp_partial(rows, blk.dictionary(), by=by,
                                         wire=sub, device=self.db.device,
                                         bucket_for=self.db.cfg.block.bucket_for)
                stats["inspectedBytes"] = blk.bytes_read
                stats["decodedBytes"] = getattr(blk, "decoded_bytes", 0)
                sub["stats"] = {**sub["stats"], **stats}
                return sub

            try:
                sub = self.db.guard_block(tenant, bid, run)
            except NotFound:
                log.warning("graph job: block %s deleted mid-query", bid)
                continue
            if rc_fp is not None:
                rc.put(tenant, bid, "graph", rc_fp, sub,
                       bytes_saved=int(sub["stats"].get("inspectedBytes", 0)))
            if want == "deps":
                graph.merge_deps_wire(wire, sub)
            else:
                graph.merge_cp_wire(wire, sub)
        return wire

    def search_tags(self, tenant: str) -> list[str]:
        """Tag names in live ingester data AND backend blocks. The
        reference snapshot fans SearchTags to ingesters only
        (modules/querier/querier.go + instance_search.go), so flushed
        tags vanish from the endpoint; Tempo v2 fixed that with
        block-backed lookup, which this provides."""
        from tempo_tpu_torch.model.tags import batch_tag_names

        out: set[str] = set()
        for batch in self._live_batches(tenant):
            out |= batch_tag_names(batch)
        try:
            out |= self.db.search_tags(tenant)
        except Exception:
            log.exception("block tag lookup failed; serving live tags only")
        return sorted(out)

    def search_tag_values(self, tenant: str, tag: str) -> list[str]:
        from tempo_tpu_torch.model.tags import batch_tag_values

        out: set[str] = set()
        for batch in self._live_batches(tenant):
            out |= batch_tag_values(batch, tag)
        try:
            out |= self.db.search_tag_values(tenant, tag)
        except Exception:
            log.exception("block tag-value lookup failed; serving live values only")
        return sorted(out)

    def traceql(self, tenant: str, query: str, start_s=0, end_s=0, limit=20,
                stats: dict | None = None):
        results = self.db.traceql_search(tenant, query, start_s, end_s, limit, stats=stats)
        # include candidates from live ingester data
        from tempo_tpu_torch.traceql import execute

        live_traces = []
        for client in self.ingester_clients.values():
            try:
                for batch in client.live_batches(tenant):
                    from tempo_tpu_torch.model.trace import batch_to_traces

                    live_traces.extend(batch_to_traces(batch))
            except Exception:
                log.exception("ingester live_batches failed")
        if live_traces:
            by_id = {}
            for t in live_traces:
                by_id.setdefault(t.trace_id, []).append(t)
            combined = [combine_traces(v) for v in by_id.values()]
            results.extend(execute(query, lambda spec, s, e: combined, start_s=start_s, end_s=end_s, limit=limit))
            seen = set()
            uniq = []
            for r in sorted(results, key=lambda r: -r.start_time_unix_nano):
                if r.trace_id_hex not in seen:
                    seen.add(r.trace_id_hex)
                    uniq.append(r)
            results = uniq[:limit] if limit else uniq
        return results


def _search_batch(batch: SpanBatch, req: SearchRequest) -> SearchResponse:
    """Tag search over one in-memory columnar segment (numpy path —
    live segments are small)."""
    resp = SearchResponse()
    n = batch.num_spans
    if n == 0:
        return resp
    d = batch.dictionary
    # resident-tail path: a just-cut WAL segment whose columns are parked
    # on the device (ops/ingest_tail) gets its span mask computed where
    # the data sits — None means "not resident or a tag needs the
    # attribute table", and the host loop below runs unchanged. A failed
    # scan raises (the reference logs it and takes the host loop).
    if getattr(batch, "_tail_key", None) is not None:
        from tempo_tpu_torch.ops import ingest_tail

        device_mask = ingest_tail.tail_search_mask(batch, req)
        if device_mask is not None:
            if not device_mask.any():
                return resp
            return _segment_hits(batch, device_mask, req, resp)
    mask = np.ones(n, bool)
    for k, v in req.tags.items():
        v = str(v)
        if k in ("name",):
            code = d.get(v)
            mask &= (batch.cols["name"] == code) if code is not None else False
        elif k in ("service.name", "service"):
            code = d.get(v)
            mask &= (batch.cols["service"] == code) if code is not None else False
        elif k == "http.status_code":
            try:
                mask &= batch.cols["http_status"] == int(v)
            except ValueError:
                return resp
        elif k == "http.method":
            code = d.get(v)
            mask &= (batch.cols["http_method"] == code) if code is not None else False
        elif k == "http.url":
            code = d.get(v)
            mask &= (batch.cols["http_url"] == code) if code is not None else False
        else:
            kc, vc = d.get(k), d.get(v)
            if kc is None or vc is None:
                return resp
            from tempo_tpu_torch.model.columnar import VT_STR

            a = batch.attrs
            rows = (a["attr_key"] == kc) & (a["attr_vtype"] == VT_STR) & (a["attr_str"] == vc)
            ok = np.zeros(n, bool)
            ok[a["attr_span"][rows]] = True
            mask &= ok
    if req.min_duration_ns:
        mask &= batch.cols["duration_nano"] >= np.uint64(req.min_duration_ns)
    if req.max_duration_ns:
        mask &= batch.cols["duration_nano"] <= np.uint64(req.max_duration_ns)
    if not mask.any():
        return resp
    return _segment_hits(batch, mask, req, resp)


def _segment_hits(batch: SpanBatch, mask: np.ndarray, req: SearchRequest,
                  resp: SearchResponse) -> SearchResponse:
    """Masked spans -> per-trace search hits (shared by the host scan and
    the resident-tail device scan)."""
    d = batch.dictionary
    # one permutation for both the rows and the mask
    perm = batch.trace_sort_perm()
    sb = batch.select(perm)
    smask = mask[perm]
    from tempo_tpu_torch.model.columnar import hit_trace_mask, trace_segmentation

    tid = sb.cols["trace_id"]
    _, seg, firsts = trace_segmentation(tid)
    hit = hit_trace_mask(seg, smask, int(seg[-1]) + 1)
    starts = sb.cols["start_unix_nano"]
    ends = starts + sb.cols["duration_nano"]
    for t in np.flatnonzero(hit):
        lo = firsts[t]
        hi = firsts[t + 1] if t + 1 < len(firsts) else sb.num_spans
        rows = np.arange(lo, hi)
        roots = rows[(sb.cols["parent_span_id"][rows] == 0).all(axis=1)]
        root = roots[0] if len(roots) else lo
        t_start, t_end = int(starts[rows].min()), int(ends[rows].max())
        if req.start_seconds and t_end < req.start_seconds * 10**9:
            continue
        if req.end_seconds and t_start > req.end_seconds * 10**9:
            continue
        resp.traces.append(
            TraceSearchMetadata(
                trace_id_hex=fmt.id_to_hex(tid[lo]),
                root_service_name=d[int(sb.cols["service"][root])],
                root_trace_name=d[int(sb.cols["name"][root])],
                start_time_unix_nano=t_start,
                duration_ms=(t_end - t_start) // 10**6,
            )
        )
    resp.inspected_traces = int(seg[-1]) + 1
    return resp
