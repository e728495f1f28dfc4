"""Ingester — live traces -> WAL head block -> complete block -> flush.

Port of tempo_tpu/modules/ingester.py, with the standing-query fold at
each cut and its read/replay seams (`standing_live_batches`,
`standing_wal_batches`, `standing_flushed_since`), and the device tier's
ingest tail: each cut parked on the tier's device under its WAL segment's
key (`ops/ingest_tail.park_cut`), the key stamped on every WAL segment
that `live_batches` and `wal_segment_batches` hand out.

Reference: modules/ingester (instance.go:98 per-tenant instance with
mutex-guarded live-trace map, CutCompleteTraces:240, CutBlockIfReady:275,
CompleteBlock:308, flush queues flush.go:124-360, WAL replay
ingester.go:328, Limiter limiter.go:22).

Array-first twist: a live trace is a list of columnar segments (what the
distributor sent), so cutting traces to the WAL is batch concatenation,
and completing a block is the engine's sorted-batch write — object trees
never appear on the write path.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.model.trace import Trace, batch_to_traces, combine_traces
from tempo_tpu_torch.util import metrics, resource, stagetimings, tracing, usage
from tempo_tpu_torch.util.flushqueues import ExclusiveQueues, FlushOp

log = logging.getLogger(__name__)

blocks_flushed = metrics.counter(
    "tempo_ingester_blocks_flushed_total", "WAL blocks completed and written to the backend"
)
blocks_dropped_metric = metrics.counter(
    "tempo_ingester_blocks_dropped_total",
    "WAL blocks dropped after repeated complete failures (DATA LOSS)",
)
live_traces_gauge = metrics.gauge(
    "tempo_ingester_live_traces", "Live traces currently held, per tenant"
)
early_cuts_total = metrics.counter(
    "tempo_ingester_pressure_cuts_total",
    "Sweeps that cut/flushed early because of memory pressure",
)
pushes_refused_total = metrics.counter(
    "tempo_ingester_pushes_refused_total",
    "Pushes refused at critical memory pressure (retryable)",
)


class TraceTooLarge(Exception):
    """Reference: instance.go:39-57 trace-too-large at push."""


class MaxLiveTraces(Exception):
    """Reference: limiter.AssertMaxTracesPerUser."""


@dataclass
class LiveTrace:
    segments: list = field(default_factory=list)  # list[SpanBatch]
    last_touch: float = 0.0
    first_touch: float = 0.0
    span_count: int = 0
    byte_count: int = 0


@dataclass
class IngesterConfig:
    max_trace_idle_s: float = 10.0
    max_block_duration_s: float = 1800.0
    max_block_bytes: int = 500 * 1024 * 1024
    complete_block_timeout_s: float = 900.0  # keep flushed blocks queryable
    flush_check_period_s: float = 10.0
    # flush-queue machinery (reference: flush.go maxCompleteAttempts,
    # flushBackoff, cfg.ConcurrentFlushes)
    concurrent_flushes: int = 4
    flush_backoff_s: float = 30.0
    max_complete_attempts: int = 3


class TenantInstance:
    def __init__(self, tenant: str, db, overrides, cfg: IngesterConfig,
                 governor: "resource.ResourceGovernor | None" = None,
                 standing=None):
        self.tenant = tenant
        self.db = db
        self.overrides = overrides
        self.cfg = cfg
        self.governor = governor or resource.governor()
        # standing-query engine (tempo_tpu_torch/standing): the cut path
        # folds each cut's delta into registered per-query accumulators
        self.standing = standing
        self.lock = threading.Lock()
        self.live: dict[bytes, LiveTrace] = {}
        self.head = db.wal.new_block(tenant)
        self.head_created = time.time()
        self.completing: list = []  # wal blocks cut from head
        self._inflight: set = set()  # block ids being completed right now
        self.flushed: list = []  # (meta, flushed_at) — cleared after timeout
        self.traces_created = 0
        self.spans_dropped_too_large = 0

    # -- push -----------------------------------------------------------
    def push_segment(self, data: bytes, now: float | None = None) -> None:
        self.push_batch(fmt.deserialize_batch(data), now=now)

    def push_batch(self, batch: SpanBatch, now: float | None = None) -> None:
        """Per-trace errors don't abort the rest of the segment: valid
        traces ingest exactly once, failures are aggregated and raised at
        the end (reference: the distributor's multierror per-trace push
        results). A retried segment may duplicate already-applied traces;
        duplicates collapse at query combine and compaction dedupe."""
        with tracing.span("ingester/append", tenant=self.tenant,
                          spans=batch.num_spans):
            self._push_batch_traced(batch, now)

    def _push_batch_traced(self, batch: SpanBatch, now: float | None = None) -> None:
        now = now or time.time()
        lim = self.overrides.for_tenant(self.tenant)
        tid = batch.cols["trace_id"]
        uniq, inverse = np.unique(tid, axis=0, return_inverse=True)
        errors: list[Exception] = []
        appended_bytes = 0
        with self.lock:
            for u in range(len(uniq)):
                rows = np.flatnonzero(inverse == u)
                key = uniq[u].astype(">u4").tobytes()
                lt = self.live.get(key)
                if lt is None:
                    if lim.max_traces_per_user and len(self.live) >= lim.max_traces_per_user:
                        errors.append(
                            MaxLiveTraces(
                                f"tenant {self.tenant}: max live traces ({lim.max_traces_per_user})"
                            )
                        )
                        continue
                    lt = LiveTrace(first_touch=now)
                    self.live[key] = lt
                    self.traces_created += 1
                sub = batch.select(rows)
                if lim.max_spans_per_trace and lt.span_count + sub.num_spans > lim.max_spans_per_trace:
                    self.spans_dropped_too_large += sub.num_spans
                    errors.append(
                        TraceTooLarge(f"trace {key.hex()} exceeds {lim.max_spans_per_trace} spans")
                    )
                    continue
                if lim.max_bytes_per_trace and lt.byte_count + sub.nbytes() > lim.max_bytes_per_trace:
                    self.spans_dropped_too_large += sub.num_spans
                    errors.append(TraceTooLarge(f"trace {key.hex()} exceeds byte limit"))
                    continue
                lt.segments.append(sub)
                lt.span_count += sub.num_spans
                lt.byte_count += sub.nbytes()
                lt.last_touch = now
                appended_bytes += sub.nbytes()
            live_traces_gauge.set(len(self.live), tenant=self.tenant)
            # charge the pool UNDER the instance lock: a concurrent cut
            # can only sub bytes it saw in self.live, and those are
            # visible only after this lock releases — so the matching
            # add always lands first and the sub clamp never discards a
            # deficit that a late add would then leak forever
            if appended_bytes:
                self.governor.pool("live_traces").add(appended_bytes)
        if errors:
            raise errors[0]

    # -- cuts -----------------------------------------------------------
    def cut_complete_traces(self, now: float | None = None, immediate: bool = False) -> int:
        """Idle traces -> head WAL block (reference: instance.go:240)."""
        with tracing.span("ingester/cut_traces", tenant=self.tenant,
                          immediate=immediate) as s:
            n = self._cut_complete_traces_traced(now, immediate)
            if s is not None:
                s.attributes["cut"] = n
            return n

    def _cut_complete_traces_traced(self, now: float | None, immediate: bool) -> int:
        now = now or time.time()
        cut = []
        with self.lock:
            for key, lt in list(self.live.items()):
                if immediate or now - lt.last_touch > self.cfg.max_trace_idle_s:
                    cut.append((key, lt))
                    del self.live[key]
        live_traces_gauge.set(len(self.live), tenant=self.tenant)
        if not cut:
            return 0
        cut_bytes = sum(lt.byte_count for _, lt in cut)
        batch = SpanBatch.concat([seg for _, lt in cut for seg in lt.segments]).sorted_by_trace()
        # append under the lock: cut_block_if_ready swaps self.head into
        # completing under it, and a completing block may already be mid
        # write_wal_block/clear() — an unlocked append can land on a block
        # that is then cleared, silently losing the cut traces (caught by
        # tests/test_race_stress.py::test_concurrent_push_cut_flush_search)
        # accounting: the traces left self.live above, so the live pool
        # gives the bytes back even if the append below fails (a failed
        # append loses the cut — a fault of its own — and leaked accounting
        # would ratchet phantom pressure until pushes are refused).
        # The wal_head pool is charged BEFORE _gov_bytes is bumped: a
        # concurrent complete/drop releasing _gov_bytes must never sub
        # bytes whose matching add hasn't landed (Pool.sub clamps at 0,
        # so a premature sub would silently discard the deficit and the
        # later add would leak forever).
        self.governor.pool("live_traces").sub(cut_bytes)
        wal_pool = self.governor.pool("wal_head")
        wal_pool.add(cut_bytes)
        try:
            with self.lock:
                self.head.append(batch)
                self.head._gov_bytes = getattr(self.head, "_gov_bytes", 0) + cut_bytes
                # WAL segment identity of this cut (block id + segment
                # index): the standing fold below carries it so a
                # concurrent rebuild that already replayed the segment
                # can dedupe the in-flight fold exactly
                seg_key = f"{self.head.block_id}:{self.head._next_seg - 1}"
        except BaseException:
            wal_pool.sub(cut_bytes)  # append failed: nothing to account
            raise
        # park the just-cut columns on the device under the WAL segment's
        # identity: the standing fold below and live-tail search then
        # evaluate where the data already sits. No tier or a zero tail
        # share parks nothing (host paths); a failure to park raises.
        tail_key = None
        tier = self._device_tier()
        if tier is not None:
            from tempo_tpu_torch.ops import ingest_tail

            tail_key = ingest_tail.park_cut(tier, self.tenant, seg_key, batch)
        batch._tail_key = tail_key
        # standing-query fold: evaluate every registered query against
        # ONLY this cut's spans — O(delta), outside the instance lock
        # (the engine serializes itself), and never fatal to the cut
        if self.standing is not None:
            self.standing.fold(self.tenant, batch, seg_key=seg_key)
        return len(cut)

    def _device_tier(self):
        from tempo_tpu_torch.encoding.vtpu import colcache

        return colcache.shared_device_tier()

    def cut_block_if_ready(self, now: float | None = None, immediate: bool = False):
        """Head block -> completing (reference: instance.go:275)."""
        now = now or time.time()
        with self.lock:
            ready = self.head.num_segments() > 0 and (
                immediate
                or now - self.head_created > self.cfg.max_block_duration_s
                or self.head.size_bytes() > self.cfg.max_block_bytes
            )
            if not ready:
                return None
            blk = self.head
            self.completing.append(blk)
            self.head = self.db.wal.new_block(self.tenant)
            self.head_created = now
            return blk

    def complete_one(self, blk, now: float | None = None):
        """One completing WAL block -> backend block; the WAL dir is
        removed only after the backend write succeeded, so there is no
        window where the data is visible nowhere (reference:
        CompleteBlock:308 + handleFlush flush.go:297; single op here
        because the write already lands in the object store).

        Claim-guarded: the synchronous drain (sweep immediate /
        flush_all) and the flush-queue workers can both reach the same
        block; whoever claims it first completes it, the other returns
        None (a double write_wal_block after clear() would overwrite the
        good backend block with an empty one)."""
        now = now or time.time()
        with self.lock:
            if blk.block_id in self._inflight or blk not in self.completing:
                return None
            self._inflight.add(blk.block_id)
        try:
            # the flush span covers merge-sort + encode + backend PUT
            # (reference: CompleteBlock's span, flush.go:298)
            with tracing.span("ingester/complete_block", tenant=self.tenant,
                              block=str(blk.block_id)):
                # flush waterfall: device page encodes inside record
                # kernel/transfer (util/devicetiming); the host remainder
                # (merge-sort, host codecs, backend PUT) lands in "other"
                with stagetimings.request() as flush_st:
                    t0 = time.perf_counter()
                    meta = self.db.write_wal_block(self.tenant, blk, block_id=blk.block_id)
                    flush_st.add("other", max(
                        0.0, time.perf_counter() - t0 - flush_st.total()))
                    flush_st.observe("flush")
        except BaseException:
            with self.lock:
                self._inflight.discard(blk.block_id)
            raise
        with self.lock:
            self._inflight.discard(blk.block_id)
            if blk in self.completing:
                self.completing.remove(blk)
            if meta is not None:
                self.flushed.append((meta, now))
        blk.clear()
        self._release_block_accounting(blk)
        if meta is not None:
            blocks_flushed.inc(tenant=self.tenant)
            # cost plane: backend PUT bytes of this tenant's flush
            usage.record(self.tenant, "ingest", flushed_bytes=meta.size_bytes)
        return meta

    def _release_block_accounting(self, blk) -> None:
        # read-and-zero under the instance lock: two releasers racing
        # (a >5s-stuck flush worker vs the shutdown drain) would both
        # read the same _gov_bytes and double-sub the PROCESS-wide pool,
        # erasing bytes other instances legitimately accounted
        with self.lock:
            n = getattr(blk, "_gov_bytes", 0)
            blk._gov_bytes = 0
        if n:
            self.governor.pool("wal_head").sub(n)

    def drop_block(self, blk) -> None:
        """Data-loss cap: after max_complete_attempts the block is
        abandoned with a loud log (reference: flush.go:254-262)."""
        log.error(
            "DROPPING wal block %s for tenant %s after repeated complete failures — "
            "its traces are lost",
            blk.block_id,
            self.tenant,
        )
        with self.lock:
            self._inflight.discard(blk.block_id)
            if blk in self.completing:
                self.completing.remove(blk)
        self._release_block_accounting(blk)
        try:
            blk.clear()
        except Exception:
            log.exception("clearing dropped block %s failed", blk.block_id)

    def complete_and_flush(self, now: float | None = None) -> list:
        """Synchronous drain of all completing blocks (deterministic
        test/shutdown path; the background path goes through the
        flush queues)."""
        now = now or time.time()
        out = []
        with self.lock:
            todo = list(self.completing)
        for blk in todo:
            try:
                meta = self.complete_one(blk, now)
                if meta is not None:
                    out.append(meta)
            except Exception:
                log.exception("complete/flush failed for %s; will retry", blk.block_id)
        return out

    def clear_flushed_blocks(self, now: float | None = None) -> int:
        now = now or time.time()
        with self.lock:
            before = len(self.flushed)
            self.flushed = [
                (m, at) for m, at in self.flushed if now - at < self.cfg.complete_block_timeout_s
            ]
            return before - len(self.flushed)

    def release_accounting(self) -> None:
        """Shutdown hygiene: give back every byte this instance accounted
        to the process pools (the governor outlives the ingester — tests
        build many apps per process and leaked accounting would read as
        phantom pressure)."""
        with self.lock:
            # once-only for the live share: a double stop() (or a stop
            # racing a late sweep) must not sub the process-wide pool
            # twice — the clamp would silently erase other instances'
            # bytes (same hazard _release_block_accounting zeroes
            # _gov_bytes against)
            released = getattr(self, "_live_released", False)
            self._live_released = True
            live = 0 if released else sum(lt.byte_count for lt in self.live.values())
            blocks = [self.head] + list(self.completing)
        if live:
            self.governor.pool("live_traces").sub(live)
        for blk in blocks:
            self._release_block_accounting(blk)

    # -- queries over not-yet-backend state ------------------------------
    def find_trace_by_id(self, trace_id: bytes) -> Trace | None:
        key = trace_id.rjust(16, b"\x00")[-16:]
        parts = []
        with self.lock:
            lt = self.live.get(key)
            segments = list(lt.segments) if lt else []
        if segments:
            parts.extend(batch_to_traces(SpanBatch.concat(segments)))
        limbs = np.frombuffer(key, dtype=">u4").astype(np.uint32)
        with self.lock:
            wal_blocks = [self.head] + list(self.completing)
        for blk in wal_blocks:
            for seg in blk.iter_batches():
                rows = np.flatnonzero((seg.cols["trace_id"] == limbs[None, :]).all(axis=1))
                if len(rows):
                    parts.extend(batch_to_traces(seg.select(rows)))
        return combine_traces(parts)

    def live_batches(self) -> list[SpanBatch]:
        """All not-yet-flushed columnar data (for SearchRecent). WAL
        segments are annotated with their device-tail key (the same
        "<block_id>:<seg>" identity the cut path parked under) so the
        querier's live-tail scan can find the resident copy."""
        from tempo_tpu_torch.ops import ingest_tail

        with self.lock:
            segs = [seg for lt in self.live.values() for seg in lt.segments]
            wal_blocks = [self.head] + list(self.completing)
        for blk in wal_blocks:
            for i, seg in blk.iter_batches_keyed():
                seg._tail_key = ingest_tail.tail_key(self.tenant, f"{blk.block_id}:{i}")
                segs.append(seg)
        return segs

    def live_only_batches(self) -> list[SpanBatch]:
        """Uncut live-trace segments ONLY (no WAL): the standing-query
        read tail. Cut spans are already in the standing accumulator —
        including the WAL here would double-count every cut."""
        with self.lock:
            return [seg for lt in self.live.values() for seg in lt.segments]

    def wal_segment_batches(self) -> list[tuple[str, SpanBatch]]:
        """(segment key, batch) for every WAL segment (head + completing)
        — the standing rebuild's replay source. Keys match the cut
        path's fold keys ("<block_id>:<seg index>") so a rebuild and an
        in-flight fold can never double-count one segment. Keys come
        from the on-disk segment numbers, so a skipped corrupt segment
        cannot shift later segments onto the wrong fold keys."""
        from tempo_tpu_torch.ops import ingest_tail

        with self.lock:
            wal_blocks = [self.head] + list(self.completing)
        out = []
        for blk in wal_blocks:
            for i, batch in blk.iter_batches_keyed():
                seg_key = f"{blk.block_id}:{i}"
                batch._tail_key = ingest_tail.tail_key(self.tenant, seg_key)
                out.append((seg_key, batch))
        return out


class Ingester:
    def __init__(self, db, overrides, cfg: IngesterConfig | None = None,
                 instance_id: str = "ingester-0",
                 governor: "resource.ResourceGovernor | None" = None,
                 standing=None):
        self.db = db
        self.overrides = overrides
        self.cfg = cfg or IngesterConfig()
        self.instance_id = instance_id
        self.governor = governor or resource.governor()
        self.standing = standing  # StandingEngine or None
        self.instances: dict[str, TenantInstance] = {}
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._loop_thread = None
        self._flush_threads: list[threading.Thread] = []
        self.flush_queues = ExclusiveQueues(self.cfg.concurrent_flushes)
        self.blocks_dropped = 0
        self.replay()

    def instance(self, tenant: str) -> TenantInstance:
        with self.lock:
            inst = self.instances.get(tenant)
            if inst is None:
                inst = TenantInstance(tenant, self.db, self.overrides, self.cfg,
                                      governor=self.governor,
                                      standing=self.standing)
                self.instances[tenant] = inst
            return inst

    # -- rpc surface -----------------------------------------------------
    def push_segment(self, tenant: str, data: bytes) -> None:
        # the hard watermark: live-trace/WAL-head pools (or RSS) over the
        # hard fraction -> refuse with a RETRYABLE ResourceExhausted that
        # carries a retry hint. The distributor surfaces it as
        # 429 + Retry-After; nothing is acknowledged, so nothing is lost.
        try:
            self.governor.check_critical("ingester", f"push for tenant {tenant}")
        except resource.ResourceExhausted:
            pushes_refused_total.inc(tenant=tenant)
            raise
        self.instance(tenant).push_segment(data)

    def find_trace_by_id(self, tenant: str, trace_id: bytes) -> Trace | None:
        with self.lock:
            inst = self.instances.get(tenant)
        return inst.find_trace_by_id(trace_id) if inst else None

    def live_batches(self, tenant: str) -> list[SpanBatch]:
        with self.lock:
            inst = self.instances.get(tenant)
        return inst.live_batches() if inst else []

    # -- standing-query seams -------------------------------------------
    def standing_live_batches(self, tenant: str) -> list[SpanBatch]:
        """Uncut live-trace tail (standing reads)."""
        with self.lock:
            inst = self.instances.get(tenant)
        return inst.live_only_batches() if inst else []

    def standing_wal_batches(self, tenant: str) -> list:
        """Keyed WAL segments (standing rebuild replay)."""
        with self.lock:
            inst = self.instances.get(tenant)
        return inst.wal_segment_batches() if inst else []

    def standing_flushed_since(self, tenant: str, t: float) -> list[str]:
        """Block ids flushed at or after t (the standing rebuild's
        flush-race detector: a block completing mid-rebuild is visible
        in neither the blocklist snapshot nor the cleared WAL)."""
        with self.lock:
            inst = self.instances.get(tenant)
        if inst is None:
            return []
        with inst.lock:
            return [str(meta.block_id) for meta, at in inst.flushed if at >= t]

    # -- lifecycle -------------------------------------------------------
    def replay(self) -> None:
        """Reattach WAL blocks found on disk as completing blocks
        (reference: replayWal ingester.go:328)."""
        for blk in self.db.wal.rescan_blocks():
            inst = self.instance(blk.tenant)
            with inst.lock:
                inst.completing.append(blk)
            log.info("replayed wal block %s for tenant %s", blk.block_id, blk.tenant)

    def sweep(self, immediate: bool = False) -> None:
        """One maintenance pass over all instances (reference:
        sweepAllInstances flush.go:144). immediate=True is the
        deterministic path: cuts everything and drains synchronously.
        The background loop instead enqueues flush ops serviced by the
        flush-queue workers (dedupe by block, retry with backoff).

        At the SOFT watermark the sweep turns aggressive across every
        tenant: idle-timeout cuts become immediate cuts, head blocks cut
        regardless of age/size, and the flush queues drain them — memory
        moves to the backend early instead of waiting for the idle
        window while pressure builds toward the hard (refuse) line."""
        under_pressure = self.governor.level() >= resource.LEVEL_PRESSURE
        if under_pressure:
            early_cuts_total.inc()
            log.warning(
                "ingester sweep cutting early: pressure level %s (%s)",
                self.governor.level_name(), self.governor.describe(),
            )
        cut_now = immediate or under_pressure
        with self.lock:
            instances = list(self.instances.values())
        # one trace per sweep: the cut/flush spans below land as its
        # children, so "why did the sweep take 4s" reads as a waterfall
        with tracing.span("ingester/sweep", instance=self.instance_id,
                          immediate=immediate, tenants=len(instances)):
            for inst in instances:
                inst.cut_complete_traces(immediate=cut_now)
                inst.cut_block_if_ready(immediate=cut_now)
                if immediate or not self._flush_threads:
                    inst.complete_and_flush()
                else:
                    self._enqueue_flush_ops(inst)
                inst.clear_flushed_blocks()

    def _enqueue_flush_ops(self, inst: TenantInstance) -> None:
        with inst.lock:
            todo = list(inst.completing)
        for blk in todo:
            self.flush_queues.enqueue(
                FlushOp(
                    at=time.time(),
                    seq=0,
                    key=f"{inst.tenant}:{blk.block_id}",
                    kind="complete",
                    payload=(inst, blk),
                )
            )

    def _flush_worker(self, queue) -> None:
        """One flush-queue loop (reference: flushLoop flush.go:185)."""
        while True:
            op = queue.dequeue()
            if op is None:
                return
            inst, blk = op.payload
            try:
                inst.complete_one(blk)
                queue.clear_key(op.key)
            except Exception:
                op.attempts += 1
                if op.attempts >= self.cfg.max_complete_attempts:
                    log.exception("complete failed %d times", op.attempts)
                    inst.drop_block(blk)
                    self.blocks_dropped += 1
                    blocks_dropped_metric.inc(tenant=inst.tenant)
                    queue.clear_key(op.key)
                else:
                    log.exception(
                        "complete failed (attempt %d/%d); backing off",
                        op.attempts,
                        self.cfg.max_complete_attempts,
                    )
                    op.at = time.time() + self.cfg.flush_backoff_s
                    queue.requeue(op)

    def flush_all(self) -> None:
        """Graceful-shutdown drain (reference: /shutdown flush.go:91)."""
        self.sweep(immediate=True)

    def start_loop(self) -> None:
        if self._loop_thread:
            return
        for i, q in enumerate(self.flush_queues.queues):
            t = threading.Thread(
                target=self._flush_worker, args=(q,), daemon=True, name=f"flush-{i}"
            )
            t.start()
            self._flush_threads.append(t)

        def loop():
            while not self._stop.wait(self.cfg.flush_check_period_s):
                try:
                    self.sweep()
                except Exception:
                    log.exception("ingester sweep failed")

        self._loop_thread = threading.Thread(target=loop, daemon=True, name="ingester-sweep")
        self._loop_thread.start()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if self._loop_thread:
            self._loop_thread.join(timeout=5)
        self.flush_queues.close()
        for t in self._flush_threads:
            t.join(timeout=5)
        self._flush_threads = []
        if flush:
            self.flush_all()
        with self.lock:
            instances = list(self.instances.values())
        for inst in instances:
            inst.release_accounting()
