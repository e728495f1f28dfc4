"""Frontend<->querier job protocol: descriptors, broker, pull workers.

Reference: modules/frontend/v1 (queriers connect and PULL jobs over a
gRPC Process stream, frontend.go:196; dead workers' jobs are re-enqueued)
+ modules/querier/worker (frontend_processor.go runs the inlined request
and posts the result back). Here jobs are JSON descriptors (the pkg/api
contract: every sub-request the sharders emit is expressible as plain
params), the transport is HTTP long-poll + result POST, and in-process
deployments use the same broker with local workers, so single-binary and
microservice modes run identical code paths.

Descriptor kinds:
  find           {trace_id, mode, block_start, block_end}
  search_recent  {search}
  search_blocks  {block_ids, search}
  traceql        {q, start, end, limit}
  metrics_recent {q, start, end, step, max_series, exemplars}
  metrics_blocks {block_ids, q, start, end, step, max_series, exemplars}
  graph_recent   {q, start, end, want: deps|cp, by}
  graph_blocks   {block_ids, q, start, end, want: deps|cp, by}
Results are JSON-safe dicts; traces travel as b64 OTLP protobuf;
metrics partials travel in HostAccumulator.to_wire form (sparse
per-series bin counts + exemplars + stats) tagged with the job's
window start so the frontend can offset bins into the parent grid.

Port of tempo_tpu/modules/worker.py: the broker, the in-process pool,
execute_job (every job kind) and RemoteWorker, the querier role's HTTP
long-poll of microservices mode. A job runs on the querier's TempoDB
device in either pool; its result crosses JSON as the reference's does.
"""

from __future__ import annotations

import base64
import itertools
import logging
import threading
import time
import weakref

from tempo_tpu_torch.encoding.common import SearchRequest, SearchResponse
from tempo_tpu_torch.modules.queue import RequestQueue
from tempo_tpu_torch.util import deadline, metrics, stagetimings, tracing, usage

log = logging.getLogger(__name__)

jobs_expired_total = metrics.counter(
    "tempo_query_frontend_jobs_expired_total",
    "Jobs dropped at dequeue because their deadline elapsed while queued "
    "(dead work is never executed)",
)
queue_depth_gauge = metrics.gauge(
    "tempo_query_frontend_queue_depth", "Queued jobs across live brokers"
)
queue_age_gauge = metrics.gauge(
    "tempo_query_frontend_queue_age_seconds",
    "Age of the oldest queued job across live brokers",
)
queue_tenants_gauge = metrics.gauge(
    "tempo_query_frontend_queue_tenants",
    "Tenants currently holding queued jobs (pruned on drain)",
)


# -- executing a descriptor on a querier ---------------------------------
def execute_job(querier, tenant: str, desc: dict) -> dict:
    """Run one descriptor inside its deadline scope: the frontend stamps
    every desc with an absolute `deadline` (util/deadline.py), so every
    backend read below bounds its timeouts by the remaining budget and a
    job whose requester already gave up stops consuming work.

    Observability: the desc also carries the frontend's `traceparent`
    (worker spans join the query's trace across the broker boundary)
    and `submitted_at` (queue-wait). The job runs under its OWN
    StageTimings accumulator — worker threads don't share the
    frontend's context — and the waterfall travels back in the result
    as "stages", where the frontend merges it shard-wise. Execution
    time no stage claimed lands in "other", so the buckets sum to the
    job's wall clock instead of silently under-reporting."""
    with deadline.scope(desc.get("deadline")):
        # collect (never settle) the job's cost vector: it rides the
        # result as "usage" and the FRONTEND settles the merged shards
        # under (tenant, kind) — one owner per query, no double count
        with stagetimings.request() as st, usage.collect() as uv:
            queue_wait = 0.0
            sub = desc.get("submitted_at")
            if sub:
                queue_wait = max(0.0, time.time() - float(sub))
                st.add("queue_wait", queue_wait)
            t0 = time.perf_counter()
            try:
                with tracing.remote_context(desc.get("traceparent")):
                    with tracing.span(f"worker/{desc.get('kind')}", tenant=tenant):
                        out = _execute_job(querier, tenant, desc)
            finally:
                exec_dt = time.perf_counter() - t0
                staged = st.total() - queue_wait
                st.add("other", max(0.0, exec_dt - staged))
            if isinstance(out, dict):
                out["stages"] = st.to_wire()
                out["usage"] = uv.to_wire()
            return out


def _execute_job(querier, tenant: str, desc: dict) -> dict:
    kind = desc.get("kind")
    if kind == "find":
        trace = querier.find_trace_by_id(
            tenant,
            bytes.fromhex(desc["trace_id"]),
            mode=desc.get("mode", "all"),
            block_start=desc.get("block_start", "0" * 32),
            block_end=desc.get("block_end", "f" * 32),
        )
        if trace is None:
            return {"trace_b64": None}
        from tempo_tpu_torch.receivers import otlp

        return {"trace_b64": base64.b64encode(otlp.encode_traces_request([trace])).decode()}
    if kind == "search_recent":
        req = SearchRequest.from_dict(desc["search"])
        return {"response": querier.search_recent(tenant, req).to_dict()}
    if kind == "search_blocks":
        req = SearchRequest.from_dict(desc["search"])
        resp = querier.search_block_batch(tenant, desc["block_ids"], req)
        return {"response": resp.to_dict()}
    if kind in ("metrics_recent", "metrics_blocks"):
        kw = dict(
            start_s=desc["start"], end_s=desc["end"], step_s=desc["step"],
            max_series=desc.get("max_series", 64),
            exemplars=desc.get("exemplars", 0),
        )
        if kind == "metrics_recent":
            wire = querier.query_range_recent(tenant, desc["q"], **kw)
        else:
            wire = querier.query_range_blocks(tenant, desc["block_ids"], desc["q"], **kw)
        return {"wire": wire, "start": desc["start"]}
    if kind in ("graph_recent", "graph_blocks"):
        kw = dict(
            q=desc.get("q", ""), start_s=desc.get("start", 0),
            end_s=desc.get("end", 0), want=desc.get("want", "deps"),
            by=desc.get("by", "service"),
        )
        if kind == "graph_recent":
            wire = querier.graph_recent(tenant, **kw)
        else:
            wire = querier.graph_blocks(tenant, desc["block_ids"], **kw)
        return {"wire": wire}
    if kind == "traceql":
        stats: dict = {}
        hits = querier.traceql(
            tenant, desc["q"], desc.get("start", 0), desc.get("end", 0),
            desc.get("limit", 20), stats=stats,
        )
        return {"results": [h.to_dict() for h in hits], "metrics": stats}
    raise ValueError(f"unknown job kind {kind!r}")


def decode_trace_result(result: dict):
    b64 = result.get("trace_b64")
    if not b64:
        return None
    from tempo_tpu_torch.receivers import otlp

    traces = otlp.decode_traces_request(base64.b64decode(b64))
    return traces[0] if traces else None


class JobError(Exception):
    pass


# one process-wide collector over every live broker (tests build many;
# a per-instance collector each would pile up in the registry forever)
_live_brokers: "weakref.WeakSet" = weakref.WeakSet()
_brokers_lock = threading.Lock()
_collector_registered = False


def _register_broker(broker) -> None:
    global _collector_registered
    with _brokers_lock:
        _live_brokers.add(broker)
        if _collector_registered:
            return
        _collector_registered = True

    def collect():
        with _brokers_lock:
            brokers = list(_live_brokers)
        depth = age = tenants = 0
        for b in brokers:
            depth += b.queue.depth()
            tenants += b.queue.tenant_count()
            age = max(age, b.queue.oldest_age_s())
        queue_depth_gauge.set(depth)
        queue_age_gauge.set(age)
        queue_tenants_gauge.set(tenants)

    metrics.register_collector(collect)


class _Pending:
    __slots__ = ("job_id", "tenant", "desc", "event", "result", "error", "deadline")

    def __init__(self, job_id, tenant, desc):
        self.job_id = job_id
        self.tenant = tenant
        self.desc = desc
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.deadline = 0.0


class JobBroker:
    """Frontend-side: fair queue of descriptors + in-flight tracking with
    lease timeout re-enqueue (the reference re-enqueues when a querier's
    Process stream dies, frontend v1)."""

    def __init__(self, queue: RequestQueue | None = None, lease_s: float = 30.0):
        self.queue = queue or RequestQueue()
        self.lease_s = lease_s
        self._ids = itertools.count(1)
        self._inflight: dict[str, _Pending] = {}
        self._lock = threading.Lock()
        self.expired = 0
        _register_broker(self)

    def submit(self, tenant: str, desc: dict) -> _Pending:
        p = _Pending(f"job-{next(self._ids)}", tenant, desc)
        self.queue.enqueue(tenant, p)
        return p

    def pull(self, timeout: float = 10.0):
        """Next due job -> (job_id, tenant, desc) or None. Also reaps
        expired leases back into the queue, and DROPS jobs whose
        deadline elapsed while they sat queued: the requester already
        gave up, so executing them is pure amplification — the waiter
        gets a terminal DeadlineExceeded instead (reference: the
        scheduler discards requests whose frontend context expired)."""
        self._reap()
        end = time.monotonic() + timeout
        while True:
            item = self.queue.dequeue(timeout=max(0.0, end - time.monotonic()))
            if item is None:
                return None
            _, p = item
            dl = p.desc.get("deadline")
            if dl and dl <= time.time():
                self.expired += 1
                jobs_expired_total.inc()
                p.error = (
                    f"DeadlineExceeded: job {p.job_id} expired in queue "
                    f"({time.time() - dl:.2f}s past deadline); dropped unexecuted"
                )
                p.event.set()
                if time.monotonic() >= end:
                    return None
                continue
            with self._lock:
                p.deadline = time.monotonic() + self.lease_s
                self._inflight[p.job_id] = p
            return p.job_id, p.tenant, p.desc

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def complete(self, job_id: str, result: dict | None = None, error: str | None = None) -> bool:
        with self._lock:
            p = self._inflight.pop(job_id, None)
        if p is None:
            return False  # lease expired and job was re-run elsewhere
        p.result = result
        p.error = error
        p.event.set()
        return True

    def _reap(self) -> None:
        now = time.monotonic()
        with self._lock:
            expired = [p for p in self._inflight.values() if p.deadline and p.deadline < now]
            for p in expired:
                del self._inflight[p.job_id]
        for p in expired:
            log.warning("job %s lease expired; re-enqueueing", p.job_id)
            try:
                self.queue.enqueue(p.tenant, p)
            except Exception as e:  # queue full/stopped: fail the waiter,
                # never the puller's thread (a dropped pending would
                # otherwise block its frontend for the full job timeout)
                p.error = f"requeue after lease expiry failed: {e}"
                p.event.set()

    def stop(self) -> None:
        self.queue.stop()


class LocalWorkerPool:
    """In-process pull workers (single-binary mode).

    max_retries: transient failures (backend.faults.retryable_error —
    connection-ish errors) are retried in place with a short backoff
    before the error travels back to the frontend; terminal errors
    (NotFound, CorruptPage, DeadlineExceeded, client mistakes) fail
    immediately — repeating them cannot succeed and only adds load.
    """

    def __init__(self, broker: JobBroker, querier, n_workers: int = 4,
                 max_retries: int = 2, retry_backoff_s: float = 0.05,
                 breaker=None):
        self.broker = broker
        self.querier = querier
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        # shared CircuitBreaker (util/circuit): when the backend is down
        # for everyone, attempts fail fast locally instead of hammering
        # it with n_workers * max_retries concurrent retry loops
        self.breaker = breaker
        self._stop = threading.Event()
        self.threads = [
            threading.Thread(target=self._run, daemon=True, name=f"query-worker-{i}")
            for i in range(n_workers)
        ]
        for t in self.threads:
            t.start()

    def _execute(self, tenant: str, desc: dict) -> dict:
        from tempo_tpu_torch.backend.faults import retryable_error

        # scope entered here too (execute_job re-enters, harmlessly) so
        # the retry backoff is bounded by the job's remaining deadline
        # and a between-attempts expiry is caught before wasted work
        with deadline.scope(desc.get("deadline")):
            last: Exception | None = None
            for attempt in range(self.max_retries + 1):
                try:
                    if self.breaker is not None:
                        return self.breaker.run(
                            lambda: execute_job(self.querier, tenant, desc)
                        )
                    return execute_job(self.querier, tenant, desc)
                except Exception as e:  # noqa: BLE001 — classified below
                    if not retryable_error(e) or attempt == self.max_retries:
                        raise
                    last = e
                    # shed/breaker errors carry a pacing hint; honor it
                    # in full — clipped only by the job's remaining
                    # deadline, never by the exponential-backoff cap
                    # (re-probing an open breaker faster than its reset
                    # window asked for defeats the pacing)
                    backoff = min(self.retry_backoff_s * (2 ** attempt), 1.0)
                    backoff = max(backoff, getattr(e, "retry_after_s", 0.0))
                    self._stop.wait(deadline.bound_timeout(backoff))
                    deadline.check()
            raise last  # pragma: no cover — loop always returns or raises

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self.broker.pull(timeout=0.5)
            if item is None:
                if self.broker.queue._stopped:
                    return
                continue
            job_id, tenant, desc = item
            try:
                self.broker.complete(job_id, result=self._execute(tenant, desc))
            except Exception as e:  # noqa: BLE001 — error travels to the waiter
                self.broker.complete(job_id, error=f"{type(e).__name__}: {e}")

    def stop(self) -> None:
        self._stop.set()
        self.broker.stop()
        for t in self.threads:
            t.join(timeout=2)


class RemoteWorker:
    """Querier-side: long-polls a frontend over HTTP, executes jobs on
    the local querier, posts results (reference: modules/querier/worker
    DNS-discovers frontends and opens Process streams)."""

    def __init__(self, frontend_url: str, querier, n_threads: int = 2,
                 result_post_retries: int = 2, breaker=None):
        from tempo_tpu_torch.backend.httpclient import PooledHTTPClient

        self.client = PooledHTTPClient(frontend_url, timeout_s=30.0, max_retries=0)
        self.querier = querier
        self.result_post_retries = result_post_retries
        self.breaker = breaker  # shared CircuitBreaker; see LocalWorkerPool
        self._stop = threading.Event()
        self.threads = [
            threading.Thread(target=self._run, daemon=True, name=f"remote-worker-{i}")
            for i in range(n_threads)
        ]

    def start(self) -> "RemoteWorker":
        for t in self.threads:
            t.start()
        return self

    def _run(self) -> None:
        import json

        while not self._stop.is_set():
            try:
                status, body, _ = self.client.request(
                    "POST", "/rpc/v1/worker/pull", body=b"{}", ok=(200, 204)
                )
                if status == 204 or not body:
                    continue
                job = json.loads(body)
                job_id, tenant, desc = job["job_id"], job["tenant"], job["desc"]
                try:
                    if self.breaker is not None:
                        result = self.breaker.run(
                            lambda: execute_job(self.querier, tenant, desc)
                        )
                    else:
                        result = execute_job(self.querier, tenant, desc)
                    out = {"result": result}
                except Exception as e:  # noqa: BLE001
                    out = {"error": f"{type(e).__name__}: {e}"}
                self._post_result(job_id, json.dumps(out).encode())
            except Exception as e:  # frontend down: back off and retry
                if not self._stop.is_set():
                    log.debug("worker poll failed: %s", e)
                    self._stop.wait(0.5)

    def _post_result(self, job_id: str, body: bytes) -> None:
        """POST a computed result with a few retries: one connection blip
        here would otherwise throw away a finished job — the lease would
        expire and the whole job be recomputed elsewhere, which is the
        expensive path, not the cheap one."""
        last: Exception | None = None
        for attempt in range(self.result_post_retries + 1):
            try:
                self.client.request(
                    "POST",
                    f"/rpc/v1/worker/result/{job_id}",
                    headers={"Content-Type": "application/json"},
                    body=body,
                    ok=(200, 404),  # 404: lease expired, someone else ran it
                )
                return
            except Exception as e:  # noqa: BLE001 — transport-level only
                last = e
                if attempt < self.result_post_retries and not self._stop.is_set():
                    self._stop.wait(min(0.1 * (2 ** attempt), 1.0))
        log.warning("result POST for %s failed after %d attempts: %s",
                    job_id, self.result_post_retries + 1, last)

    def stop(self) -> None:
        self._stop.set()
        for t in self.threads:
            t.join(timeout=2)
