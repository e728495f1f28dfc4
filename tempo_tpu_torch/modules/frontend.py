"""Query frontend — shards queries into jobs, queues them, merges results.

Reference: modules/frontend (trace-by-ID sharder splitting the uuid
space uniformly tracebyidsharding.go:51-228, search sharder emitting one
job per chunk of block data searchsharding.go:69-314, retry retry.go,
span deduping deduper.go) over the fair queue (modules/frontend/v1 +
pkg/scheduler/queue).

Jobs are wire-form descriptors (modules/worker.py): the frontend never
executes anything itself. In-process, LocalWorkerPool drains the same
broker that remote queriers long-poll over HTTP, so single-binary and
microservice deployments share this exact code path — the process
boundary is the broker seam (the reference's httpgrpc boundary).

Port of tempo_tpu/modules/frontend.py: find by ID, search, query_range
and TraceQL, with the compiled tier's verdicts (its search-shape ledger
and the query_range roll-up) on the query-insights records, and the
graph endpoints (dependencies, critical path, walks).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass

from tempo_tpu_torch.encoding.common import SearchRequest, SearchResponse, TraceSearchMetadata
from tempo_tpu_torch.model.trace import combine_traces
from tempo_tpu_torch.modules.worker import JobBroker, decode_trace_result
from tempo_tpu_torch.util import insights, metrics, resource, stagetimings, tracing, usage

log = logging.getLogger(__name__)

partial_results_total = metrics.counter(
    "tempo_query_frontend_partial_results_total",
    "Queries answered with status=partial (terminal shard failures "
    "within the tenant's failed-shard budget)",
)
query_cost_hist = metrics.histogram(
    "tempo_query_frontend_estimated_bytes",
    "Per-query bytes-to-scan estimate from the block index",
    buckets=(1e6, 1e7, 1e8, 5e8, 1e9, 5e9, 1e10, 5e10),
)


def create_block_boundaries(n_shards: int) -> list[str]:
    """n_shards+1 uniform 128-bit hex boundaries (reference:
    tracebyidsharding.go:228 createBlockBoundaries)."""
    if n_shards <= 0:
        return ["0" * 32, "f" * 32]
    space = 1 << 128
    bounds = [format((space * i) // n_shards, "032x") for i in range(n_shards)]
    bounds.append("f" * 32)
    return bounds


@dataclass
class FrontendConfig:
    query_shards: int = 4
    max_retries: int = 2
    # search: one backend job per this many bytes of block data
    target_bytes_per_job: int = 100 * 1024 * 1024
    query_ingesters_until_s: int = 3600  # recent window served by ingesters
    max_duration_s: int = 0  # per-tenant via overrides wins
    job_timeout_s: float = 60.0
    # a shard still unfinished after this long gets a duplicate submitted
    # and the first completion wins (reference: hedged_requests.go:26,
    # HedgeRequestsAt ~2s); 0 disables. Duplicated partials are safe —
    # every merge path dedupes by trace/span identity.
    hedge_after_s: float = 2.0
    # graceful degradation default: fraction of a query's shards allowed
    # to fail terminally before the whole query fails; within budget,
    # search/query_range return status="partial" + failed-shard counts.
    # 0 preserves strict all-or-nothing semantics. Per-tenant override:
    # overrides.Limits.query_partial_shard_fraction (>= 0 wins).
    max_failed_shard_fraction: float = 0.0
    # -- admission / shedding -------------------------------------------
    # concurrent queries one tenant may hold (0 = unlimited); per-tenant
    # override: overrides.Limits.max_concurrent_queries (> 0 wins).
    # Excess is SHED with a retry hint, never queued — a queue of
    # already-over-cap work only grows the backlog.
    max_concurrent_queries: int = 0
    # under memory pressure, historical scans whose bytes-to-scan
    # estimate (from the block index) exceeds this are shed FIRST;
    # live-tail and recent-window queries keep flowing until the
    # inflight-bytes pool itself is full. 0 disables the class split.
    shed_historical_above_bytes: int = 1 << 30
    # -- query-insights log (util/insights): bounded ring of per-query
    # records behind /api/query-insights + the JSON slow-query log.
    # Errors/partials/slow queries always captured; healthy fast ones
    # sampled 1-in-N.
    insights_capacity: int = 512
    insights_sample_every: int = 10
    insights_slow_threshold_s: float = 2.0


class Frontend:
    def __init__(self, broker: JobBroker, db, cfg: FrontendConfig | None = None,
                 overrides=None, governor: "resource.ResourceGovernor | None" = None):
        """db: blocklist provider (TempoDB reader); the frontend needs
        block metas to shard searches (reference: frontend reads the
        tempodb.Reader blocklist, searchsharding.go:250)."""
        self.broker = broker
        self.db = db
        self.cfg = cfg or FrontendConfig()
        self.overrides = overrides
        self.governor = governor or resource.governor()
        self._adm_lock = threading.Lock()
        self._tenant_inflight: dict[str, int] = {}
        # the process-wide insight ring adopts this frontend's knobs
        # (one frontend per process owns query-path observability)
        insights.LOG.configure(
            capacity=self.cfg.insights_capacity,
            sample_every=self.cfg.insights_sample_every,
            slow_threshold_s=self.cfg.insights_slow_threshold_s,
        )

    # ------------------------------------------------------------------
    # admission: every query passes here BEFORE any job is sharded.
    # Cost is estimated from the block index (bytes-to-scan = the sizes
    # of the blocks the sharders would touch), the cheap proxy the
    # reference frontend uses for its own query-size limits. Shedding
    # priority under pressure: large HISTORICAL scans go first; live-tail
    # / recent-window / trace-by-ID queries keep flowing until the
    # inflight-bytes pool itself is full or the tenant cap is hit.
    def _concurrency_cap(self, tenant: str) -> int:
        cap = self.cfg.max_concurrent_queries
        if self.overrides is not None:
            t_cap = self.overrides.for_tenant(tenant).max_concurrent_queries
            if t_cap > 0:
                cap = t_cap
        return cap

    @contextlib.contextmanager
    def _admit(self, tenant: str, est_bytes: int, protected: bool, what: str):
        _adm_t0 = time.perf_counter()
        est_bytes = max(0, int(est_bytes))
        query_cost_hist.observe(est_bytes, kind=what)
        # the pool bounds RESIDENT bytes, and execution is chunked: at
        # most ~query_shards jobs of target_bytes_per_job are in flight
        # per query, however large the total scan. Charge admission with
        # that resident ceiling; the full est_bytes still classifies the
        # query for historical-scan shedding below.
        resident_cap = max(
            1, self.cfg.target_bytes_per_job * max(1, self.cfg.query_shards))
        charge = min(est_bytes, resident_cap)
        cap = self._concurrency_cap(tenant)
        with self._adm_lock:
            cur = self._tenant_inflight.get(tenant, 0)
            if cap and cur >= cap:
                resource.shed_total.inc(component="frontend", reason="tenant_concurrency")
                raise resource.ResourceExhausted(
                    f"tenant {tenant}: {cur} queries in flight (cap {cap}); "
                    "shed, retry shortly",
                    retry_after_s=self.governor.retry_after_s(),
                )
            self._tenant_inflight[tenant] = cur + 1
        pool = self.governor.pool("inflight_query")
        try:
            if pool.limit and charge > pool.limit:
                # retrying can never help — the query's resident demand
                # alone exceeds the whole budget. Terminal client error
                # (same contract as max_search_duration), NOT a retryable
                # shed: a 429 with a hint here would livelock clients.
                raise ValueError(
                    f"{what} needs ~{max(1, charge >> 20)} MiB resident, over "
                    f"the per-process inflight budget "
                    f"({pool.limit / (1 << 20):g} MiB); narrow the time "
                    "range or filter"
                )
            if not pool.try_add(charge):
                resource.shed_total.inc(component="frontend", reason="inflight_query_full")
                raise resource.ResourceExhausted(
                    f"frontend: inflight query bytes over budget "
                    f"({pool.used}/{pool.limit}); {what} shed",
                    retry_after_s=self.governor.retry_after_s(),
                )
            try:
                if (
                    not protected
                    and self.cfg.shed_historical_above_bytes
                    and est_bytes > self.cfg.shed_historical_above_bytes
                    and self.governor.level() >= resource.LEVEL_PRESSURE
                ):
                    resource.shed_total.inc(component="frontend", reason="historical_scan")
                    raise resource.ResourceExhausted(
                        f"frontend: shedding large historical {what} "
                        f"(~{est_bytes >> 20} MiB to scan) under memory pressure",
                        retry_after_s=self.governor.retry_after_s() * 2,
                    )
                # gates cleared: what the waterfall calls "admission"
                stagetimings.add("admission", time.perf_counter() - _adm_t0)
                yield
            finally:
                pool.sub(charge)
        finally:
            with self._adm_lock:
                left = self._tenant_inflight.get(tenant, 1) - 1
                if left <= 0:
                    # remove at zero: churned tenant IDs must not pin
                    # dict entries forever
                    self._tenant_inflight.pop(tenant, None)
                else:
                    self._tenant_inflight[tenant] = left

    # ------------------------------------------------------------------
    # error-type prefixes that are ALWAYS query-fatal (a malformed query
    # fails every shard identically — partial results would just hide it)
    _CLIENT_ERRORS = ("ParseError", "ValueError", "PermissionError", "BadRequest")
    # prefixes that must not burn retries (reference retry.go retries 5xx
    # only; worker errors travel as "Type: message" strings): client
    # errors, exceeded deadlines (the requester already gave up —
    # re-running only amplifies load), and checksum failures (the same
    # block returns the same corrupt bytes; quarantine, not retry)
    _NO_RETRY = _CLIENT_ERRORS + ("DeadlineExceeded", "CorruptPage")

    def _run_jobs(self, tenant: str, descs: list[dict]) -> tuple[list, list]:
        """Submit all descriptors; resubmit failures up to max_retries.
        A timed-out job that later completes AND gets retried can yield
        a duplicate partial; all merge paths dedupe by trace/span
        identity.

        Deadline propagation: every descriptor is stamped with one
        absolute deadline (now + job_timeout_s). Workers enter a deadline
        scope around execution so backend timeouts shrink to the
        remaining budget, and the frontend never resubmits past it — an
        exceeded deadline is terminal, not retried."""
        from tempo_tpu_torch.modules.worker import JobError

        from tempo_tpu_torch.modules.queue import TooManyRequests

        deadline_ts = time.time() + self.cfg.job_timeout_s
        # every descriptor carries (1) the absolute deadline, (2) the
        # frontend's trace context so the worker's spans join this
        # query's trace across the broker/process boundary, and (3) the
        # submit timestamp so the worker can report queue-wait in the
        # stage waterfall (wall clock: workers may be remote, but they
        # share the deployment's clock discipline)
        tp = tracing.current_traceparent()
        # the insight record learns its shard count and traceparent here
        # — every query path funnels through this submit
        insights.note(shards=len(descs), traceparent=tp)
        now_ts = time.time()
        descs = [
            {**d, "deadline": deadline_ts, "submitted_at": now_ts,
             **({"traceparent": tp} if tp else {})}
            for d in descs
        ]
        groups = []
        try:
            for d in descs:
                groups.append([self.broker.submit(tenant, d)])
        except TooManyRequests:
            # the query is failing 429 — jobs already queued must not
            # keep executing with no waiter (wasted scans exactly while
            # the system sheds for overload). Expiring their deadline
            # makes the broker drop them unexecuted at pull.
            for grp in groups:
                grp[0].desc["deadline"] = time.time() - 1
            raise
        results: list = []
        terminal_errors: list = []  # never retried, never lost
        for attempt in range(self.cfg.max_retries + 1):
            self._wait_groups(tenant, groups, timeout_s=deadline_ts - time.time())
            # classify each group exactly once — a job finishing between
            # two passes must land in exactly one bucket
            failed = []
            for grp in groups:
                done_ok = next((p for p in grp if p.event.is_set() and p.error is None), None)
                if done_ok is not None:
                    results.append(done_ok.result)
                    continue
                noretry = next(
                    (p for p in grp
                     if p.error is not None and p.error.startswith(self._NO_RETRY)),
                    None,
                )
                if noretry is not None:
                    terminal_errors.append(JobError(noretry.error))
                else:
                    failed.append(grp)
            out_of_time = time.time() >= deadline_ts
            if not failed or attempt == self.cfg.max_retries or out_of_time:
                for grp in failed:
                    p = grp[0]
                    terminal_errors.append(
                        JobError(p.error) if p.error is not None
                        else TimeoutError(f"job {p.job_id} timed out")
                    )
                self._merge_stage_wires(results)
                return results, terminal_errors
            log.warning(
                "retrying %d failed query jobs (attempt %d/%d)",
                len(failed), attempt + 1, self.cfg.max_retries,
            )
            # resubmission gets the same queue-full cleanup as the
            # initial submit: orphaned retries must not execute waiterless.
            # submitted_at is RE-stamped: a retry's queue_wait must
            # measure this enqueue, not include the failed attempt's
            # whole queue+execution time
            groups = []
            try:
                for grp in failed:
                    groups.append([self.broker.submit(
                        tenant, {**grp[0].desc, "submitted_at": time.time()})])
            except TooManyRequests:
                for g in groups:
                    g[0].desc["deadline"] = time.time() - 1
                raise
        self._merge_stage_wires(results)
        return results, terminal_errors

    @staticmethod
    def _merge_stage_wires(results: list) -> None:
        """Fold each worker's stage waterfall ("stages") and cost vector
        ("usage") riding the job results into this query's accumulators
        — the same shard-wise partial merge the search/metrics responses
        use. The merged cost vector settles under (tenant, kind) when
        the request's usage.attribute scope exits."""
        acc = stagetimings.active()
        uv = usage.active()
        for r in results:
            if acc is not None:
                acc.merge_wire(r.get("stages"))
            if uv is not None:
                uv.merge_wire(r.get("usage"))
        if uv is None:
            return
        # the query's result-cache verdict rides the insight record:
        # any recompute dominates ("store" if at least one partial was
        # written back, else plain "miss"), a fully-served query is
        # "hit", and "negative" only when vetoes alone answered it.
        # None (cache disabled / kind not cached) leaves the field off.
        snap = uv.snapshot()
        if snap.get("result_cache_misses", 0) > 0:
            verdict = ("store" if snap.get("result_cache_stores", 0) > 0
                       else "miss")
        elif snap.get("result_cache_hits", 0) > 0:
            verdict = "hit"
        elif snap.get("result_cache_negative", 0) > 0:
            verdict = "negative"
        else:
            verdict = None
        insights.note(resultCache=verdict)

    def _settle(self, tenant: str, n_shards: int, results: list, errors: list) -> int:
        """Apply the failed-shard budget to a query's terminal errors.

        Returns the failed-shard count the caller must surface as
        status="partial" (0 = complete). Raises when any error is a
        client error (every shard would fail the same way), when
        failures exceed the tenant's budget, or when NO shard produced a
        result (an all-failed "partial" is an outage, not degradation).
        """
        if not errors:
            return 0
        for e in errors:
            if str(e).startswith(self._CLIENT_ERRORS):
                raise e
        frac = self.cfg.max_failed_shard_fraction
        if self.overrides is not None:
            t_frac = self.overrides.for_tenant(tenant).query_partial_shard_fraction
            if t_frac >= 0:
                frac = t_frac
        allowed = int(frac * n_shards)
        if len(errors) > allowed or not results:
            raise errors[0]
        partial_results_total.inc(tenant=tenant)
        log.warning(
            "serving PARTIAL results for tenant %s: %d/%d shards failed "
            "terminally (budget %d): %s",
            tenant, len(errors), n_shards, allowed, errors[0],
        )
        return len(errors)

    def _wait_groups(self, tenant: str, groups: list, timeout_s: float) -> None:
        """Wait until every group has a finished member or the timeout
        passes; after cfg.hedge_after_s, unfinished groups get a
        DUPLICATE submission and the first completion wins (reference:
        the frontend's hedged-requests middleware, hedged_requests.go:26
        — tail shards ride a second worker instead of stalling the whole
        query)."""
        import time as _time

        deadline = _time.monotonic() + timeout_s
        hedge_at = (
            _time.monotonic() + self.cfg.hedge_after_s
            if self.cfg.hedge_after_s > 0
            else None
        )
        while True:
            unfinished = [g for g in groups if not any(p.event.is_set() for p in g)]
            if not unfinished:
                return
            now = _time.monotonic()
            if now >= deadline:
                return
            if hedge_at is not None and now >= hedge_at:
                for g in unfinished:
                    # hedge only jobs a worker has actually LEASED
                    # (deadline set by pull) and at most once per group —
                    # duplicating QUEUED jobs would amplify load exactly
                    # when the broker is saturated (the HTTP hedger has
                    # the same in-flight-only rule)
                    if len(g) == 1 and g[0].deadline > 0:
                        log.info("hedging slow query job %s", g[0].job_id)
                        # fresh submitted_at: the hedge's queue_wait is
                        # its own, not the original's whole lifetime
                        g.append(self.broker.submit(
                            tenant, {**g[0].desc, "submitted_at": _time.time()}))
            # bounded slice on one unfinished group's NEWEST member (the
            # hedge, when present, is the likely finisher); the loop
            # re-checks every group each tick
            slice_end = deadline if (hedge_at is None or now >= hedge_at) else min(deadline, hedge_at)
            unfinished[0][-1].event.wait(timeout=max(0.01, min(0.25, slice_end - now)))

    # ------------------------------------------------------------------
    def find_trace_by_id(self, tenant: str, trace_id: bytes):
        """Shard the blockID space + one ingester job; combine partials,
        dedupe spans (reference: newTraceByIDMiddleware frontend.go:97)."""
        with stagetimings.request() as st, usage.attribute(tenant, "find"), \
                insights.LOG.observe(tenant, "find", "trace-by-id"):
            with tracing.span("frontend/find", tenant=tenant,
                              trace=trace_id.hex()):
                out = self._find_traced(tenant, trace_id)
            st.observe("find")
            return out

    def _find_traced(self, tenant: str, trace_id: bytes):
        hex_id = trace_id.hex()
        bounds = create_block_boundaries(self.cfg.query_shards)
        descs = [{"kind": "find", "trace_id": hex_id, "mode": "ingesters"}]
        for i in range(len(bounds) - 1):
            descs.append(
                {
                    "kind": "find",
                    "trace_id": hex_id,
                    "mode": "blocks",
                    "block_start": bounds[i],
                    "block_end": bounds[i + 1],
                }
            )
        # trace-by-ID is bloom-pruned point work, the protected class:
        # zero-byte estimate = only the tenant concurrency cap applies
        with self._admit(tenant, 0, protected=True, what="find"):
            results, errors = self._run_jobs(tenant, descs)
        if errors:
            # a failed shard could hide spans of this trace; fail the whole
            # query rather than return a silently incomplete trace
            raise errors[0]
        traces = [decode_trace_result(r) for r in results]
        return combine_traces([t for t in traces if t is not None])

    # ------------------------------------------------------------------
    def search(self, tenant: str, req: SearchRequest) -> SearchResponse:
        """Ingester window job + one job per chunk of backend blocks
        (reference: searchsharding.go:266 backendRequests)."""
        with stagetimings.request() as st, usage.attribute(tenant, "search"), \
                insights.LOG.observe(tenant, "search",
                                     insights.normalize_search(req)) as rec:
            with tracing.span("frontend/search", tenant=tenant):
                out = self._search_traced(tenant, req)
            rec["status"] = out.status
            if out.failed_shards:
                rec["failedShards"] = out.failed_shards
            wire = st.to_wire()
            out.stage_seconds = wire["stageSeconds"]
            out.device_dispatches = wire["deviceDispatches"]
            st.observe("search")
            return out

    def _search_traced(self, tenant: str, req: SearchRequest) -> SearchResponse:
        if self.overrides is not None:
            max_dur = self.overrides.for_tenant(tenant).max_search_duration_s
            if max_dur and req.start_seconds and req.end_seconds:
                if req.end_seconds - req.start_seconds > max_dur:
                    raise ValueError(f"search window exceeds max_search_duration ({max_dur}s)")

        now = time.time()
        descs = []
        ing_cutoff = now - self.cfg.query_ingesters_until_s
        recent = bool(not req.end_seconds or req.end_seconds >= ing_cutoff)
        if recent:
            descs.append({"kind": "search_recent", "search": req.to_dict()})
        # the PROTECTED class is queries confined to the recent window
        # (live tail, "last 5 minutes" dashboards). Touching `now` is
        # not enough: an open-ended scan over all history also touches
        # now, and it is exactly the large scan pressure must shed first.
        protected = bool(req.start_seconds and req.start_seconds >= ing_cutoff)

        metas = [
            m for m in self.db.blocklist.metas(tenant)
            if (not req.start_seconds or m.end_time >= req.start_seconds)
            and (not req.end_seconds or m.start_time <= req.end_seconds)
        ]
        est_bytes = 0
        group, size = [], 0
        for m in metas:
            group.append(m.block_id)
            size += max(m.size_bytes, 1)
            est_bytes += max(m.size_bytes, 1)
            if size >= self.cfg.target_bytes_per_job:
                descs.append({"kind": "search_blocks", "block_ids": group, "search": req.to_dict()})
                group, size = [], 0
        if group:
            descs.append({"kind": "search_blocks", "block_ids": group, "search": req.to_dict()})

        if any(d["kind"] == "search_blocks" for d in descs):
            # the compiled tier's contribution to search is the shape
            # ledger: hit/miss counters and the per-query compiledShape
            # verdict on the insights record
            from tempo_tpu_torch import compiled
            insights.note(compiledShape=compiled.observe_search_shape(req))

        with self._admit(tenant, est_bytes, protected=protected, what="search"):
            results, errors = self._run_jobs(tenant, descs)
        failed = self._settle(tenant, len(descs), results, errors)
        out = SearchResponse()
        with stagetimings.stage("merge"):
            for r in results:
                if "response" in r:
                    out.merge(SearchResponse.from_dict(r["response"]), limit=req.limit)
        if failed:
            # degradation contract: whenever status is NOT "partial" the
            # results are bit-identical to a fault-free run; when it is,
            # failed_shards says exactly how many shards are missing
            out.status = "partial"
            out.failed_shards += failed
        return out

    # ------------------------------------------------------------------
    def query_range(self, tenant: str, query: str, start_s: int, end_s: int,
                    step_s: int, max_series: int = 64, exemplars: int = 0) -> dict:
        """TraceQL metrics over [start, end) at step resolution
        (reference: the frontend's query_range sharder — time-range
        shards over backend blocks + a recent-window job served from
        ingester live data, modules/frontend metrics middleware).

        The full range is compiled once up front (client errors fail
        before any job is sharded), then split into step-ALIGNED
        sub-windows — each worker evaluates a sub-plan whose bins map
        back into the parent grid by a pure offset, so partials merge by
        integer addition and shard boundaries can never change results.
        The recent job covers the whole window from ingester live/WAL
        segments (the not-yet-flushed tail); block jobs cover flushed
        data, the same disjointness contract the search path uses.
        """
        with stagetimings.request() as st, usage.attribute(tenant, "query_range"), \
                insights.LOG.observe(tenant, "query_range",
                                     insights.normalize_query(query)) as rec:
            with tracing.span("frontend/query_range", tenant=tenant):
                mat = self._query_range_traced(
                    tenant, query, start_s, end_s, step_s,
                    max_series=max_series, exemplars=exemplars)
            if mat.get("status") == "partial":
                rec["status"] = "partial"
                rec["failedShards"] = mat.get("failedShards", 0)
            wire = st.to_wire()
            stats = mat.setdefault("stats", {})
            stats["stageSeconds"] = wire["stageSeconds"]
            stats["deviceDispatches"] = wire["deviceDispatches"]
            st.observe("query_range")
            return mat

    def _query_range_traced(self, tenant: str, query: str, start_s: int,
                            end_s: int, step_s: int, max_series: int = 64,
                            exemplars: int = 0) -> dict:
        from tempo_tpu_torch.metrics_engine import (
            compile_metrics_plan,
            finalize_matrix,
            merge_wire,
            new_wire,
        )

        plan = compile_metrics_plan(query, start_s, end_s, step_s,
                                    max_series=max_series, exemplars=exemplars)
        common = {"q": query, "step": plan.step_s,
                  "max_series": max_series, "exemplars": exemplars}

        descs = []
        now = time.time()
        recent = plan.end_s >= now - self.cfg.query_ingesters_until_s
        if recent:
            descs.append({"kind": "metrics_recent", "start": plan.start_s,
                          "end": plan.end_s, **common})

        # step-aligned time-range shards, blocks chunked per shard by the
        # same byte budget the search sharder uses
        n_shards = max(1, min(self.cfg.query_shards, plan.n_bins))
        bins_per = -(-plan.n_bins // n_shards)  # ceil
        metas = self.db.blocklist.metas(tenant)
        est_bytes = 0
        b = 0
        while b < plan.n_bins:
            w0 = plan.start_s + b * plan.step_s
            w1 = min(plan.end_s, plan.start_s + (b + bins_per) * plan.step_s)
            b += bins_per
            group, size = [], 0
            for m in metas:
                if m.end_time < w0 or m.start_time > w1:
                    continue
                group.append(m.block_id)
                size += max(m.size_bytes, 1)
                est_bytes += max(m.size_bytes, 1)
                if size >= self.cfg.target_bytes_per_job:
                    descs.append({"kind": "metrics_blocks", "block_ids": group,
                                  "start": w0, "end": w1, **common})
                    group, size = [], 0
            if group:
                descs.append({"kind": "metrics_blocks", "block_ids": group,
                              "start": w0, "end": w1, **common})

        # protected = the whole range sits in the recent window (same
        # rule as search: touching `now` alone doesn't protect a scan)
        protected = plan.start_s >= now - self.cfg.query_ingesters_until_s
        with self._admit(tenant, est_bytes, protected=protected, what="query_range"):
            results, errors = self._run_jobs(tenant, descs)
        # a failed shard is a hole in the range vector: NEVER silently
        # wrong rates — either fail the query (over budget) or flag the
        # response partial with an exact failed-shard count
        failed = self._settle(tenant, len(descs), results, errors)
        merged = new_wire()
        shapes = []
        with stagetimings.stage("merge"):
            for r in results:
                off = (int(r.get("start", plan.start_s)) - plan.start_s) // plan.step_s
                merge_wire(merged, r.get("wire", {}), plan, bin_offset=off)
                cs = r.get("wire", {}).get("compiledShape")
                if cs:
                    shapes.append(cs)
        if shapes:
            # per-query verdict for the insights record: worst shard
            # wins (one interpreter shard means the query didn't fully
            # ride the compiled tier); recent-window jobs carry no
            # verdict — live segments aren't block work
            rank = {"hit": 0, "miss": 1, "fallback": 2}
            insights.note(compiledShape=max(shapes, key=lambda s: rank.get(s, 2)))
        if len(results) > 1 and merged["stats"].get("seriesDropped"):
            # each shard caps series in its own first-seen order, so a
            # series kept by one shard and dropped by another would read
            # as silent zero bins — same contract as a failed shard above
            raise ValueError(
                f"query exceeds max_series={max_series} on at least one "
                "shard; narrow the filter or raise max_series"
            )
        mat = finalize_matrix(plan, merged)
        if failed:
            mat["status"] = "partial"
            mat["failedShards"] = failed
            mat.setdefault("stats", {})["failedShards"] = failed
        return mat

    # ------------------------------------------------------------------
    # trace-graph analytics: /api/graph/{dependencies,critical-path,walks}
    # — a full query vertical riding the same machinery as search/
    # query_range (admission, job sharding, hedging, retry taxonomy,
    # failed-shard budget, stage waterfall, cost vector). Partials are
    # integer edge/critical-path wires (tempo_tpu_torch/graph), so the merged
    # result is bit-identical at ANY shard count.
    def graph_dependencies(self, tenant: str, q: str = "", start_s: int = 0,
                           end_s: int = 0) -> dict:
        from tempo_tpu_torch import graph

        wire, failed, stats = self._graph_fanout(
            tenant, "dependencies", "deps", q, start_s, end_s)
        doc = graph.finalize_deps(wire)
        return self._graph_doc(doc, failed, stats)

    def graph_critical_path(self, tenant: str, q: str = "", start_s: int = 0,
                            end_s: int = 0, by: str = "service") -> dict:
        from tempo_tpu_torch import graph

        if by not in graph.CP_BY:
            raise ValueError(
                f"unknown critical-path grouping {by!r} (have {graph.CP_BY})")
        wire, failed, stats = self._graph_fanout(
            tenant, "critical-path", "cp", q, start_s, end_s, by=by)
        doc = graph.finalize_cp(wire)
        return self._graph_doc(doc, failed, stats)

    def graph_walks(self, tenant: str, q: str = "", start_s: int = 0,
                    end_s: int = 0, walks: int = 32, steps: int = 6,
                    seed: int = 0, window_s: int = 0,
                    start_node: str | None = None) -> dict:
        """Temporal random walks over the aggregated edge list: the deps
        fan-out supplies the graph, then the seeded splitmix64 sampler
        replays bit-identically for the same (edges, seed) — exploration
        you can cite in an incident doc."""
        from tempo_tpu_torch import graph
        from tempo_tpu_torch.graph import walks as walks_mod

        wire, failed, stats = self._graph_fanout(
            tenant, "walks", "deps", q, start_s, end_s)
        doc = walks_mod.sample_walks(
            wire["edges"], seed=seed, walks=walks, steps=steps,
            window_s=window_s, start=start_node)
        doc["edges"] = len(wire["edges"])
        return self._graph_doc(doc, failed, stats)

    @staticmethod
    def _graph_doc(doc: dict, failed: int, stats: dict) -> dict:
        doc.setdefault("stats", {}).update(stats)
        doc["status"] = "partial" if failed else "success"
        if failed:
            doc["failedShards"] = failed
            doc["stats"]["failedShards"] = failed
        return doc

    def _graph_fanout(self, tenant: str, what: str, want: str, q: str,
                      start_s: int, end_s: int, by: str = "service"):
        """Shared fan-out for the three graph endpoints: returns the
        merged wire, the failed-shard count within budget, and the
        request's waterfall/stat rollup."""
        from tempo_tpu_torch import graph

        kind_label = what.replace("-", "_")
        with stagetimings.request() as st, usage.attribute(tenant, "graph"), \
                insights.LOG.observe(tenant, f"graph_{kind_label}",
                                     insights.normalize_query(q or "{}")) as rec:
            with tracing.span(f"frontend/graph_{kind_label}", tenant=tenant, q=q):
                wire, failed = self._graph_traced(
                    tenant, q, start_s, end_s, want, by)
            if failed:
                rec["status"] = "partial"
                rec["failedShards"] = failed
            graph.graph_queries_total.inc(kind=kind_label)
            stats = dict(wire.pop("stats", {}) or {})
            w = st.to_wire()
            stats["stageSeconds"] = w["stageSeconds"]
            stats["deviceDispatches"] = w["deviceDispatches"]
            st.observe("graph")
            return wire, failed, stats

    def _graph_traced(self, tenant: str, q: str, start_s: int, end_s: int,
                      want: str, by: str):
        from tempo_tpu_torch import graph

        # parse up front: a malformed/unsupported root filter is a
        # client error and must fail before any job is sharded
        graph.parse_root_filter(q)
        now = time.time()
        ing_cutoff = now - self.cfg.query_ingesters_until_s
        common = {"q": q, "start": start_s, "end": end_s, "want": want, "by": by}
        descs = []
        if not end_s or end_s >= ing_cutoff:
            descs.append({"kind": "graph_recent", **common})
        metas = [
            m for m in self.db.blocklist.metas(tenant)
            if (not start_s or m.end_time >= start_s)
            and (not end_s or m.start_time <= end_s)
        ]
        est_bytes = 0
        group, size = [], 0
        for m in metas:
            group.append(m.block_id)
            size += max(m.size_bytes, 1)
            est_bytes += max(m.size_bytes, 1)
            if size >= self.cfg.target_bytes_per_job:
                descs.append({"kind": "graph_blocks", "block_ids": group, **common})
                group, size = [], 0
        if group:
            descs.append({"kind": "graph_blocks", "block_ids": group, **common})

        # protected only when confined to the recent window (the search
        # rule: touching `now` alone doesn't protect a scan)
        protected = bool(start_s and start_s >= ing_cutoff)
        with self._admit(tenant, est_bytes, protected=protected, what="graph"):
            results, errors = self._run_jobs(tenant, descs)
        failed = self._settle(tenant, len(descs), results, errors)
        merged = graph.new_deps_wire() if want == "deps" else graph.new_cp_wire(by)
        merge = graph.merge_deps_wire if want == "deps" else graph.merge_cp_wire
        with stagetimings.stage("merge"):
            for r in results:
                merge(merged, r.get("wire"))
        return merged, failed

    # ------------------------------------------------------------------
    def traceql(self, tenant: str, query: str, start_s=0, end_s=0, limit=20,
                stats: dict | None = None):
        with stagetimings.request() as st, usage.attribute(tenant, "traceql"), \
                insights.LOG.observe(tenant, "traceql",
                                     insights.normalize_query(query)):
            with tracing.span("frontend/traceql", tenant=tenant, q=query):
                out = self._traceql_traced(tenant, query, start_s, end_s,
                                           limit, stats)
            if stats is not None:
                wire = st.to_wire()
                stats["stageSeconds"] = wire["stageSeconds"]
                stats["deviceDispatches"] = wire["deviceDispatches"]
            st.observe("traceql")
            return out

    def _traceql_traced(self, tenant: str, query: str, start_s=0, end_s=0,
                        limit=20, stats: dict | None = None):
        # parse up front: a malformed query is a client error and must
        # fail before any job is sharded or retried (reference: the
        # frontend's search middleware parses before enqueueing)
        from tempo_tpu_torch.traceql import parse

        parse(query)
        # cost estimate: every block overlapping the window (the traceql
        # job scans recent data + blocks itself); no window = everything
        metas = [
            m for m in self.db.blocklist.metas(tenant)
            if (not start_s or m.end_time >= start_s)
            and (not end_s or m.start_time <= end_s)
        ]
        est_bytes = sum(max(m.size_bytes, 1) for m in metas)
        # protected only when confined to the recent window (see search)
        protected = bool(
            start_s and start_s >= time.time() - self.cfg.query_ingesters_until_s
        )
        with self._admit(tenant, est_bytes, protected=protected, what="traceql"):
            results, errors = self._run_jobs(
                tenant,
                [{"kind": "traceql", "q": query, "start": start_s, "end": end_s,
                  "limit": limit}],
            )
        if errors and not results:
            raise errors[0]
        out = []
        for r in results:
            if stats is not None:
                for k, v in r.get("metrics", {}).items():
                    stats[k] = stats.get(k, 0) + int(v)
            for t in r.get("results", []):
                out.append(
                    TraceSearchMetadata(
                        trace_id_hex=t["traceID"],
                        root_service_name=t.get("rootServiceName", ""),
                        root_trace_name=t.get("rootTraceName", ""),
                        start_time_unix_nano=int(t.get("startTimeUnixNano", "0")),
                        duration_ms=t.get("durationMs", 0),
                        span_set=t.get("spanSet"),
                    )
                )
        return out
