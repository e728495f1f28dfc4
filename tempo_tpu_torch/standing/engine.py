"""Standing-query engine: registered query_range queries folded per cut.

Port of tempo_tpu/standing/engine.py. The fold's reduction follows the
engine's device (`device=None` means CUDA, as every entry point of the
port): on a CUDA device the cut's live slots, run-compressed, go through
the hand-written `seg_bincount` kernel (one `standing_fold` dispatch a
query and cut), on the CPU through the reference's host arm
(`np.unique`); the counts are equal either way. A failure of the card's
arm is not the reference's dirty-and-rebuild case: the query is marked
failed and its reads answer HTTP 500 (StandingFoldFailed), so a host
rebuild never stands in for a broken kernel. A cut parked on the
device by the ingest tail (`ops/ingest_tail`) folds there for a plan that
lowers onto the parked columns (one `tail_fold` launch a query and cut);
its failure marks the query failed too. With the result cache on, a
rebuild reads each stored vtpu1 block's contribution as a cached row log
that does not depend on the rebuild's window (`_rebuild_block_logged`,
`_replay_block_rows`), as the reference does.

Every dashboard refresh and alert rule re-running `query_range` is
O(re-scan); but the engine's range-vector partial is one associative
integer bincount, so a REGISTERED query can instead fold each ingest
cut's delta into a per-query standing accumulator:

    fold cost  = O(spans in this cut)     (the delta, never the window)
    read cost  = O(accumulator) + O(uncut live tail)

Mechanics per registered query: a persistent SeriesTable plus a sparse
{(series slot, absolute step bin, histogram bucket) -> count} dict on
the query's own step grid (bins are absolute — every fold agrees on the
grid without coordination). The ingester's cut path
(`TenantInstance.cut_complete_traces`) hands the freshly cut batch to
`fold()`, which reuses metrics_engine.eval_batch for slotting and the
same device/host bincount arms as query_range (timed_dispatch-wrapped,
bit-identical counts either way). Reads serve the accumulator plus the
not-yet-cut live-trace tail, so a standing read NEVER dips during
ingester handoff: the cut's delta is in the accumulator the moment the
spans leave the live map, while plain `query_range` can miss a freshly
flushed block until the next blocklist poll (up to blocklist_poll_s).

Alert rules fall out as threshold checks on the same accumulator:
`{...} | rate() > X` is a comparison against the latest complete bin,
surfaced as `tempo_tpu_standing_alert_firing{query_id}` and the
/api/metrics/standing/{id}/state document.

Replication (RF > 1): every replica's cut folds, so standing counts
reflect REPLICATED ingest — exactly what `query_range`'s recent window
reports before compaction dedupes (the vulture's metrics check
tolerates the same overcount for the same reason). A rebuild re-anchors
to deduped storage, after which folds continue replicated; deployments
that need dedup-exact standing counts should run RF=1 ingest for the
standing tenant or rebuild on a schedule. The parity invariant the
tests pin is therefore "standing read == from-scratch query_range over
the same live view", which holds at any RF.

Durability: registrations (+ alert state) snapshot to a JSON file in
the WAL dir; counts REBUILD exactly on restart from storage — stored
blocks via the step-partial tier where the query matches a downsampling
rule (span scan otherwise) plus a replay of the WAL segments the
ingester rescans — so a crash loses no standing state that the engine's
own storage still holds. The same rebuild heals a query whose folds
were shed under memory pressure (the governor sheds standing evaluation
at PRESSURE, one level before ingest refuses at CRITICAL).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass

import numpy as np

import torch

from tempo_tpu_torch import device as _device
from tempo_tpu_torch.standing import rules as rules_mod
from tempo_tpu_torch.util import metrics, resource, stagetimings, tracing, usage

log = logging.getLogger(__name__)

standing_queries_gauge = metrics.gauge(
    "tempo_tpu_standing_queries",
    "Registered standing queries, per tenant",
)
folds_total = metrics.counter(
    "tempo_tpu_standing_folds_total",
    "Per-query incremental evaluations of a cut delta",
)
fold_spans_total = metrics.counter(
    "tempo_tpu_standing_fold_spans_total",
    "Delta spans folded into standing accumulators (per-query sum)",
)
folds_shed_total = metrics.counter(
    "tempo_tpu_standing_folds_shed_total",
    "Standing evaluations shed under memory pressure (queries marked "
    "dirty; exactness restored by the next rebuild)",
)
fold_seconds_hist = metrics.histogram(
    "tempo_tpu_standing_fold_seconds",
    "Wall-clock seconds of one standing fold (all queries of one cut)",
    buckets=(0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0),
)
alert_firing_gauge = metrics.gauge(
    "tempo_tpu_standing_alert_firing",
    "1 while a standing query's alert rule is firing, by query id",
)
rebuilds_total = metrics.counter(
    "tempo_tpu_standing_rebuilds_total",
    "Standing accumulator rebuilds from storage (restart or shed-heal)",
)
deviation_firing_gauge = metrics.gauge(
    "tempo_tpu_standing_deviation_firing",
    "1 while a standing query's seasonal-deviation detector is firing "
    "for any series, by query id",
)
deviation_fires_total = metrics.counter(
    "tempo_tpu_standing_deviation_fires_total",
    "Per-series deviation transitions (not-deviating -> deviating), "
    "by query id",
)


@dataclass
class StandingConfig:
    """`standing:` config section (AppConfig.standing)."""

    enabled: bool = True
    # registrations one tenant may hold; 0 = unlimited (check_config
    # warns when left unset in multitenant clusters). Per-tenant
    # override: overrides.Limits.max_standing_queries (> 0 wins).
    max_queries_per_tenant: int = 0
    snapshot_period_s: float = 30.0
    default_window_s: int = 3600
    max_window_s: int = 30 * 86400
    # serve the uncut live-trace tail on reads (exactness vs a
    # from-scratch query_range); off = accumulator only
    recent_tail: bool = True


class UnknownStandingQuery(KeyError):
    """No registered standing query with that id (HTTP 404)."""


class StandingFoldFailed(RuntimeError):
    """The card's fold arm failed for a query: `seg_bincount` did not
    build or launch, a copy failed, or the plan's slots exceed
    `MAX_SLOTS`; or the resident tail's fold (`tail_fold`) failed. Unlike a host-side evaluation error (the query is marked
    dirty and the next read rebuilds it on the host), the query is marked
    failed: a host rebuild would serve a right answer over a broken
    kernel. Its reads and state answer HTTP 500 until a restart, whose
    rebuild from storage is exact."""


# one process-wide /metrics collector over every live engine (weakref:
# tests build many apps per process — dead engines must not be pinned
# or re-evaluated; same pattern as modules/worker's broker collector)
import weakref  # noqa: E402

_live_engines: "weakref.WeakSet" = weakref.WeakSet()
_engines_lock = threading.Lock()
_collector_registered = False


def _register_engine(engine) -> None:
    global _collector_registered
    with _engines_lock:
        _live_engines.add(engine)
        if _collector_registered:
            return
        _collector_registered = True

    def collect():
        with _engines_lock:
            engines = list(_live_engines)
        for e in engines:
            try:
                e._refresh_alerts()
            except Exception:
                log.exception("standing alert refresh failed")

    metrics.register_collector(collect)


def normalize_deviation(deviation: dict | None, step_s: int,
                        window_s: int) -> dict | None:
    """Validate + normalize a registration's `deviation` section.
    The detector compares the latest complete bin against a seasonal
    baseline folded from the SAME accumulator (the mean of the bins one,
    two, ... seasons back inside the window), so it needs the season to
    sit on the step grid and the window to hold at least one full
    baseline season besides the current one."""
    if not deviation:
        return None
    season = int(deviation.get("season", 0))
    if season <= 0 or season % step_s != 0:
        raise ValueError(
            "deviation.season must be a positive multiple of step "
            f"({step_s}s)")
    if window_s < 2 * season:
        raise ValueError(
            f"deviation needs window >= 2*season ({2 * season}s) so at "
            "least one full baseline season is retained")
    factor = float(deviation.get("factor", 2.0))
    if factor <= 1.0:
        raise ValueError("deviation.factor must be > 1.0")
    direction = deviation.get("direction", "above")
    if direction not in ("above", "below"):
        raise ValueError("deviation.direction must be 'above' or 'below'")
    return {
        "season": season,
        "factor": factor,
        "min_count": int(deviation.get("min_count", 1)),
        "direction": direction,
    }


class StandingQuery:
    def __init__(self, qid: str, tenant: str, query: str, step_s: int,
                 window_s: int, alert: dict | None, max_series: int,
                 deviation: dict | None = None):
        from tempo_tpu_torch.metrics_engine import SeriesTable, compile_metrics_plan

        self.id = qid
        self.tenant = tenant
        self.query = query
        self.step_s = int(step_s)
        self.window_s = int(window_s)
        self.alert = dict(alert) if alert else None
        self.deviation = normalize_deviation(deviation, int(step_s),
                                             int(window_s))
        self.max_series = int(max_series)
        # one-bin template: validates the query via the exact grammar /
        # planner query_range uses (client errors fail registration)
        self.template = compile_metrics_plan(
            query, 0, self.step_s, self.step_s, max_series=self.max_series)
        self.series = SeriesTable(self.max_series)
        self.counts: dict[tuple, int] = {}  # (sslot, abs_bin, bucket) -> n
        # reentrant: snapshot/state paths compose helpers that each take
        # the lock (to_doc under snapshot's per-query section)
        self.lock = threading.RLock()
        self.created_unix = time.time()
        self.folds = 0
        self.fold_spans = 0
        self.fold_seconds = 0.0
        self.sheds = 0
        self.shed_spans = 0
        self.rebuilds = 0
        self.partial_row_groups = 0  # rebuilt-from-step-partials count
        self.dirty = False
        self.failed: str | None = None  # the card's fold arm failed
        self.firing: dict = {}  # series key -> bool
        self.deviating: dict = {}  # series key -> bool
        self.deviation_fires = 0
        self.rebuilt_segs: set = set()  # WAL seg keys replayed by rebuild

    # -- helpers ---------------------------------------------------------
    def _slot_keys(self) -> dict:
        return {s: key for key, s in self.series.slots.items()}

    def to_doc(self) -> dict:
        with self.lock:
            return {
                "id": self.id,
                "query": self.query,
                "step": self.step_s,
                "window": self.window_s,
                "alert": dict(self.alert) if self.alert else None,
                "deviation": dict(self.deviation) if self.deviation else None,
                "maxSeries": self.max_series,
                "createdUnix": int(self.created_unix),
            }

    def state_doc(self) -> dict:
        with self.lock:
            return {
                **{
                    "id": self.id,
                    "query": self.query,
                    "step": self.step_s,
                    "window": self.window_s,
                    "alert": dict(self.alert) if self.alert else None,
                    "deviation": (dict(self.deviation)
                                  if self.deviation else None),
                },
                "firing": {str(k): bool(v) for k, v in self.firing.items() if v},
                "deviating": {str(k): bool(v)
                              for k, v in self.deviating.items() if v},
                "stats": {
                    "folds": self.folds,
                    "spansFolded": self.fold_spans,
                    "foldSeconds": round(self.fold_seconds, 6),
                    "sheds": self.sheds,
                    "spansShed": self.shed_spans,
                    "rebuilds": self.rebuilds,
                    "partialRowGroups": self.partial_row_groups,
                    "series": len(self.series.slots),
                    "bins": len(self.counts),
                    "dirty": self.dirty,
                    "deviationFires": self.deviation_fires,
                },
            }


class StandingEngine:
    """Process-wide registry + fold/read engine. One per process that
    owns ingesters; the ingester cut path calls fold(), the HTTP API
    calls register/list/read/state/delete."""

    def __init__(self, cfg: StandingConfig | None = None, overrides=None,
                 governor: "resource.ResourceGovernor | None" = None,
                 device=None):
        self.cfg = cfg or StandingConfig()
        # where the fold's reduction runs (CUDA unless "cpu" is asked for)
        self.device = _device.resolve(device)
        self.overrides = overrides
        self.governor = governor or resource.governor()
        self._lock = threading.Lock()  # registry
        self._fold_lock = threading.Lock()  # folds vs rebuild/read races
        self._queries: dict[str, StandingQuery] = {}
        # alert state must decay without traffic: folds re-evaluate it,
        # but once ingest stops there are no folds — refresh on every
        # /metrics scrape so a firing gauge clears when its bin empties
        # (one weakref-guarded collector process-wide: tests build many
        # engines and a collector per instance would pin them forever)
        _register_engine(self)
        self.db = None
        self.ingesters: dict = {}
        self.snapshot_path: str | None = None
        self._last_snapshot = 0.0
        self.cut_spans: dict[str, int] = {}  # tenant -> delta spans offered
        # deviation transitions queue under q.lock and drain to
        # subscribers outside any lock (the RCA trigger seam)
        self._dev_subs: list = []
        self._dev_events: list = []
        self._dev_lock = threading.Lock()

    # -- wiring ----------------------------------------------------------
    def attach(self, db=None, ingesters: dict | None = None,
               snapshot_dir: str | None = None, rebuild: bool = True) -> None:
        """Late wiring (the engine is built before the ingesters so the
        cut path can hold a stable reference). Loads the snapshot and —
        when storage is attached — rebuilds accumulators exactly."""
        self.db = db if db is not None else self.db
        if ingesters is not None:
            self.ingesters = ingesters
        if snapshot_dir:
            os.makedirs(snapshot_dir, exist_ok=True)
            self.snapshot_path = os.path.join(snapshot_dir, "standing.json")
            restored = self._restore()
            if restored and rebuild and self.db is not None:
                try:
                    self.rebuild_all()
                except Exception:
                    log.exception("standing: restart rebuild failed; "
                                  "serving snapshot counts (marked dirty)")

    # -- registry --------------------------------------------------------
    def _cap_for(self, tenant: str) -> int:
        cap = self.cfg.max_queries_per_tenant
        if self.overrides is not None:
            t_cap = getattr(self.overrides.for_tenant(tenant),
                            "max_standing_queries", 0)
            if t_cap > 0:
                cap = t_cap
        return cap

    def subscribe_deviations(self, cb) -> None:
        """Register cb(event) for per-series deviation transitions.
        Events carry kind="standing_deviation", the query id/tenant, the
        series key and the current/baseline counts. Fired outside every
        engine lock; a raising subscriber is logged, never propagated
        into the fold path."""
        self._dev_subs.append(cb)

    def register(self, tenant: str, query: str, step_s: int,
                 window_s: int = 0, alert: dict | None = None,
                 max_series: int = 64,
                 deviation: dict | None = None) -> StandingQuery:
        if step_s <= 0:
            raise ValueError("step must be positive")
        window_s = int(window_s) or self.cfg.default_window_s
        if window_s > self.cfg.max_window_s:
            raise ValueError(
                f"window {window_s}s exceeds standing.max_window_s "
                f"({self.cfg.max_window_s}s)")
        if alert:
            if alert.get("op") not in (">", "<"):
                raise ValueError("alert.op must be '>' or '<'")
            float(alert.get("value"))  # must be numeric
        cap = self._cap_for(tenant)
        with self._lock:
            held = sum(1 for q in self._queries.values() if q.tenant == tenant)
            if cap and held >= cap:
                raise resource.ResourceExhausted(
                    f"tenant {tenant}: {held} standing queries registered "
                    f"(cap {cap}); delete one first", retry_after_s=60.0)
            q = StandingQuery(f"sq-{uuid.uuid4().hex[:12]}", tenant, query,
                              step_s, window_s, alert, max_series,
                              deviation=deviation)
            # backfill: the store may already hold this window's spans —
            # a fresh accumulator would silently read as zero traffic.
            # dirty routes the first read through the exact rebuild
            # (blocks + WAL); folds cover everything cut from then on.
            q.dirty = self.db is not None
            self._queries[q.id] = q
            standing_queries_gauge.set(held + 1, tenant=tenant)
        self.maybe_snapshot(force=True)
        return q

    def get(self, tenant: str, qid: str) -> StandingQuery:
        with self._lock:
            q = self._queries.get(qid)
        if q is None or q.tenant != tenant:
            # a foreign tenant's id is indistinguishable from absent —
            # never an oracle for other tenants' registrations
            raise UnknownStandingQuery(qid)
        return q

    def _get_live(self, tenant: str, qid: str) -> StandingQuery:
        """get() for reads: a query whose card fold failed answers with
        StandingFoldFailed, never with counts that lack the lost delta."""
        q = self.get(tenant, qid)
        with q.lock:
            failed = q.failed
        if failed is not None:
            raise StandingFoldFailed(failed)
        return q

    def list(self, tenant: str) -> list[dict]:
        with self._lock:
            qs = [q for q in self._queries.values() if q.tenant == tenant]
        return [q.to_doc() for q in sorted(qs, key=lambda q: q.id)]

    def delete(self, tenant: str, qid: str) -> None:
        q = self.get(tenant, qid)
        with self._lock:
            self._queries.pop(qid, None)
            held = sum(1 for x in self._queries.values() if x.tenant == tenant)
        standing_queries_gauge.set(held, tenant=tenant)
        alert_firing_gauge.drop_labels(query_id=q.id)
        deviation_firing_gauge.drop_labels(query_id=q.id)
        self.maybe_snapshot(force=True)

    def state(self, tenant: str, qid: str) -> dict:
        """State document with the alert freshly re-evaluated — a firing
        alert must clear when its latest complete bin empties, even with
        zero ingest (no folds) since it fired."""
        q = self._get_live(tenant, qid)
        with q.lock:
            self._eval_alert(q, time.time())
            self._eval_deviation(q, time.time())
        self._flush_deviation_events()
        return q.state_doc()

    def _refresh_alerts(self) -> None:
        """Scrape-time alert refresh (see _register_engine)."""
        with self._lock:
            qs = [q for q in self._queries.values()
                  if q.alert or q.deviation]
        now = time.time()
        for q in qs:
            with q.lock:
                self._eval_alert(q, now)
                self._eval_deviation(q, now)
        self._flush_deviation_events()

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted({q.tenant for q in self._queries.values()})

    # -- fold (the ingester cut seam) ------------------------------------
    def fold(self, tenant: str, batch, seg_key: str | None = None) -> None:
        """Evaluate every registered query of `tenant` against ONLY the
        freshly cut spans and fold the deltas in. Never raises into the
        cut path."""
        try:
            self._fold_inner(tenant, batch, seg_key)
        except Exception:
            log.exception("standing fold failed for tenant %s (cut path "
                          "unaffected)", tenant)

    def _fold_inner(self, tenant: str, batch, seg_key: str | None) -> None:
        with self._lock:
            qs = [q for q in self._queries.values() if q.tenant == tenant]
        if not qs or batch.num_spans == 0:
            return
        n = batch.num_spans
        self.cut_spans[tenant] = self.cut_spans.get(tenant, 0) + n
        if self.governor.level() >= resource.LEVEL_PRESSURE:
            # shed BEFORE ingest does: standing evaluation is deferrable
            # work (a rebuild restores exactness); accepting spans is not
            for q in qs:
                with q.lock:
                    q.sheds += 1
                    q.shed_spans += n
                    q.dirty = True
            folds_shed_total.inc()
            resource.shed_total.inc(component="standing", reason="fold_pressure")
            return
        t0 = time.perf_counter()
        with usage.attribute(tenant, "standing"), stagetimings.request() as st, \
                tracing.span("standing/fold", tenant=tenant, spans=n,
                             queries=len(qs)):
            from tempo_tpu_torch.encoding.vtpu.block import inspected_bytes_total

            folded_any = False
            with self._fold_lock:
                for q in qs:
                    if seg_key is not None:
                        with q.lock:
                            if seg_key in q.rebuilt_segs:
                                # a rebuild already replayed this WAL
                                # segment; folding it again would double
                                q.rebuilt_segs.discard(seg_key)
                                continue
                    try:
                        self._fold_one(q, batch, batch.dictionary)
                    except StandingFoldFailed as e:
                        # never healed by a host rebuild: reads answer 500
                        with q.lock:
                            q.failed = str(e)
                        log.error("standing fold of %s failed on %s: %s",
                                  q.id, self.device, e)
                        continue
                    except Exception:
                        # a lost delta is an undercount the next rebuild
                        # must heal — NEVER silent, and never fatal to
                        # sibling queries or the cut path
                        with q.lock:
                            q.dirty = True
                        log.exception("standing fold of %s failed; "
                                      "marked dirty", q.id)
                        continue
                    folded_any = True
                    with q.lock:
                        q.folds += 1
                        q.fold_spans += n
                    folds_total.inc()
                    fold_spans_total.inc(n)
            if folded_any:
                # ONE charge per cut, however many queries folded: the
                # delta is scanned from memory, so the tempodb counter
                # (a storage/live-scan signal) must track the cut, not
                # multiply by registration count — the same statement
                # moves counter and cost vector (the cost plane's exactness rule);
                # per-query granularity lives in the state doc's
                # spansFolded/foldSeconds
                usage.account_bytes(inspected_bytes_total,
                                    "inspected_bytes", tenant,
                                    batch.nbytes())
            st.observe("standing")
        dt = time.perf_counter() - t0
        fold_seconds_hist.observe(dt)
        for q in qs:
            with q.lock:
                q.fold_seconds += dt / max(1, len(qs))
        self._flush_deviation_events()
        self.maybe_snapshot()

    def _fold_one(self, q: StandingQuery, batch, dictionary) -> None:
        """One query x one delta batch -> sparse count updates. Slotting
        is eval_batch itself; the reduction is the same device/host
        bincount pair query_range uses, so standing counts are
        bit-identical to a from-scratch evaluation of the same spans."""
        from tempo_tpu_torch.metrics_engine import eval_batch

        step = q.step_s
        t = batch.cols["start_unix_nano"].astype(np.int64)
        t_lo, t_hi = int(t.min()), int(t.max())
        if t_lo < 0:
            return
        now = time.time()
        floor_s = max(0, int(now - q.window_s - 2 * step))
        start = (max(t_lo // 10**9, floor_s) // step) * step
        n_bins = (t_hi // (step * 10**9)) - (start // step) + 1
        if n_bins <= 0:
            return
        if n_bins > rules_mod.WRITE_MAX_BINS:
            with q.lock:
                q.dirty = True
            return
        plan = rules_mod.window_plan(q.template, start, int(n_bins))
        # resident-tail path: when this cut's columns are parked on the
        # device (ops/ingest_tail) and the plan lowers onto them, fold
        # where the data sits — h2d is the literals, bin edges and by()
        # codes, never the columns. A miss (not resident, not lowerable)
        # takes eval_batch below, which gives the same counts; a failure
        # raises StandingFoldFailed (the reference takes the host path).
        tail_key = getattr(batch, "_tail_key", None)
        fold_plan = None
        if tail_key is not None:
            from tempo_tpu_torch.ops import ingest_tail

            fold_plan = ingest_tail.lower_fold_plan(plan)
        with q.lock:
            delta = None
            if fold_plan is not None:
                try:
                    delta = ingest_tail.resident_fold(
                        plan, fold_plan, batch, dictionary, q.series, key=tail_key)
                except Exception as e:
                    raise StandingFoldFailed(
                        f"standing query {q.id}: tail_fold on {self.device}: "
                        f"{type(e).__name__}: {e}") from e
            if delta is not None:
                for (slot, b), c in delta.items():
                    key = (slot, start // step + b, 0)
                    q.counts[key] = q.counts.get(key, 0) + c
            else:
                res = eval_batch(plan, batch, dictionary, q.series)
                live = res.slots[res.slots >= 0]
                if len(live):
                    self._apply_counts(q, plan, live, start // step)
            self._prune(q, now)
            self._eval_alert(q, now)
            self._eval_deviation(q, now)

    def _apply_counts(self, q: StandingQuery, plan, live: np.ndarray,
                      bin_offset: int) -> None:
        if self.device.type == "cuda":
            flats, counts = self._device_counts(q, plan, live)
        else:
            flats, counts = np.unique(live, return_counts=True)
        _add_flat_counts(q.counts, plan, bin_offset, flats, counts)

    def _device_counts(self, q: StandingQuery, plan, live: np.ndarray):
        """The card's arm: run-compressed slots through `seg_bincount`.
        Any failure raises StandingFoldFailed; nothing here falls back to
        the host."""
        from tempo_tpu_torch.metrics_engine.plan import MAX_SLOTS

        if plan.n_slots > MAX_SLOTS:
            raise StandingFoldFailed(
                f"standing query {q.id}: {plan.n_slots} slots exceed "
                f"MAX_SLOTS ({MAX_SLOTS})")
        from tempo_tpu_torch.ops.pallas_kernels import compress_slot_runs, seg_bincount
        from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

        try:
            slots, weights = compress_slot_runs(live)
            # slot ids are < MAX_SLOTS (2**22), so int32 holds them
            d_slots = torch.from_numpy(np.ascontiguousarray(slots, np.int32)).to(self.device)
            d_w = (None if weights is None
                   else torch.from_numpy(np.ascontiguousarray(weights, np.int32))
                   .to(self.device))
            count_transfer("standing_fold", h2d=d_slots.numel() * 4
                           + (0 if d_w is None else d_w.numel() * 4))
            vec = timed_dispatch("standing_fold", seg_bincount, d_slots, plan.n_slots,
                                 weights=d_w, device=self.device).cpu().numpy()
            count_transfer("standing_fold", d2h=vec.nbytes)
        except Exception as e:
            raise StandingFoldFailed(
                f"standing query {q.id}: seg_bincount on {self.device}: "
                f"{type(e).__name__}: {e}") from e
        nz = np.flatnonzero(vec)
        return nz, vec[nz]

    def _prune(self, q: StandingQuery, now: float) -> None:
        floor_bin = int(now - q.window_s - 2 * q.step_s) // q.step_s
        if floor_bin <= 0:
            return
        dead = [k for k in q.counts if k[1] < floor_bin]
        for k in dead:
            del q.counts[k]

    def _eval_alert(self, q: StandingQuery, now: float) -> None:
        """Threshold check on the latest COMPLETE bin's rate per series
        (`{...} | rate() > X` evaluated where the data lands). Requires
        q.lock held."""
        if not q.alert:
            return
        bin_ = int(now) // q.step_s - 1
        per_series: dict[int, int] = {}
        for (s, b, _k), c in q.counts.items():
            if b == bin_:
                per_series[s] = per_series.get(s, 0) + c
        op, value = q.alert["op"], float(q.alert["value"])
        slot_keys = q._slot_keys()
        firing_any = False
        for s, key in slot_keys.items():
            rate = per_series.get(s, 0) / q.step_s
            fire = rate > value if op == ">" else rate < value
            q.firing[key] = fire
            firing_any = firing_any or fire
        alert_firing_gauge.set(1 if firing_any else 0, query_id=q.id)

    def _eval_deviation(self, q: StandingQuery, now: float) -> None:
        """Per-series seasonal-deviation check: the latest COMPLETE bin
        against the mean of the bins one, two, ... seasons back — a
        baseline that is a pure function of the SAME associative,
        psum-mergeable accumulator the folds maintain, so it is
        bit-identical at cut boundaries and across ingester sharding for
        free (no second fold, no extra state). Requires q.lock held;
        transitions queue for subscribers, drained outside the lock by
        _flush_deviation_events()."""
        if not q.deviation:
            return
        dev = q.deviation
        step = q.step_s
        bin_ = int(now) // step - 1
        season_bins = dev["season"] // step
        # seasonal lags whose bins the prune floor still retains
        floor_bin = int(now - q.window_s - 2 * step) // step
        lags = [bin_ - k * season_bins
                for k in range(1, q.window_s // dev["season"] + 1)
                if bin_ - k * season_bins >= floor_bin]
        if not lags:
            return
        cur: dict[int, int] = {}
        base: dict[int, int] = {}
        lag_set = set(lags)
        for (s, b, _k), c in q.counts.items():
            if b == bin_:
                cur[s] = cur.get(s, 0) + c
            elif b in lag_set:
                base[s] = base.get(s, 0) + c
        factor, min_count = dev["factor"], dev["min_count"]
        above = dev["direction"] == "above"
        slot_keys = q._slot_keys()
        deviating_any = False
        for s, key in slot_keys.items():
            c = cur.get(s, 0)
            baseline = base.get(s, 0) / len(lags)
            if above:
                fire = c >= min_count and c > factor * baseline
            else:
                fire = baseline >= min_count and c * factor < baseline
            was = q.deviating.get(key, False)
            q.deviating[key] = fire
            deviating_any = deviating_any or fire
            if fire and not was:
                q.deviation_fires += 1
                deviation_fires_total.inc(query_id=q.id)
                with self._dev_lock:
                    self._dev_events.append({
                        "kind": "standing_deviation",
                        "queryId": q.id,
                        "tenant": q.tenant,
                        "query": q.query,
                        "series": str(key),
                        "bin": bin_,
                        "at": now,
                        "current": c,
                        "baseline": baseline,
                        "factor": factor,
                        "direction": dev["direction"],
                    })
        deviation_firing_gauge.set(1 if deviating_any else 0, query_id=q.id)

    def _flush_deviation_events(self) -> None:
        """Deliver queued deviation transitions to subscribers. Never
        raises (fold/cut path safety); must be called with NO engine or
        query lock held."""
        with self._dev_lock:
            events, self._dev_events = self._dev_events, []
        for event in events:
            for cb in list(self._dev_subs):
                try:
                    cb(dict(event))
                except Exception:
                    log.exception("standing deviation subscriber failed")

    # -- read ------------------------------------------------------------
    def read(self, tenant: str, qid: str, start_s: int = 0, end_s: int = 0,
             step_s: int = 0) -> dict:
        """Prometheus matrix over [start, end) served from the standing
        accumulator + the uncut live-trace tail. Defaults to the query's
        own window/step; a caller-supplied step must be a multiple of
        the standing step (the counts cannot map otherwise — 400), and
        start is aligned DOWN onto the standing grid (the Prometheus
        convention for range queries)."""
        from tempo_tpu_torch.metrics_engine import (
            HostAccumulator,
            compile_metrics_plan,
            eval_batch,
            finalize_matrix,
            merge_wire,
            new_wire,
        )

        q = self._get_live(tenant, qid)
        step = int(step_s) or q.step_s
        if step % q.step_s != 0:
            raise ValueError(
                f"read step must be a multiple of the standing step "
                f"({q.step_s}s) — the counts cannot map otherwise")
        if not end_s:
            end_s = (int(time.time()) // q.step_s + 1) * q.step_s
        if not start_s:
            start_s = end_s - q.window_s
        start_s = (int(start_s) // q.step_s) * q.step_s  # align down
        with usage.attribute(tenant, "standing"), \
                tracing.span("standing/read", tenant=tenant, query_id=qid):
            for _ in range(2):
                if not (q.dirty and self.db is not None
                        and self.governor.level() < resource.LEVEL_PRESSURE):
                    break
                try:
                    self.rebuild(q)
                except Exception:
                    log.exception("standing: lazy rebuild of %s failed", q.id)
                    break
            plan = compile_metrics_plan(q.query, start_s, end_s, step,
                                        max_series=q.max_series)
            # tail first, counts second: a cut racing this read folds
            # into counts we then copy — transient overcount at worst,
            # never a dip (the retry collapses even that in practice)
            for _attempt in range(2):
                folds0 = q.folds
                tail = self._tail_wire(q, plan, HostAccumulator, eval_batch)
                counts_wire = self._counts_wire(q, plan)
                if q.folds == folds0:
                    break
            merged = new_wire()
            merge_wire(merged, counts_wire, plan)
            if tail is not None:
                merge_wire(merged, tail, plan)
                merged["stats"]["inspectedSpans"] = tail.get(
                    "stats", {}).get("inspectedSpans", 0)
            mat = finalize_matrix(plan, merged)
            mat["stats"]["standing"] = True
            with q.lock:
                if q.dirty:
                    mat["stats"]["degraded"] = True
            return mat

    def _counts_wire(self, q: StandingQuery, plan) -> dict:
        grid_end = plan.start_s + plan.n_bins * plan.step_s
        series: dict = {}
        with q.lock:
            slot_keys = q._slot_keys()
            items = list(q.counts.items())
        for (s, b, k), c in items:
            t0 = b * q.step_s
            if not (plan.start_s <= t0 < grid_end) or k >= plan.n_buckets:
                continue
            key = slot_keys.get(s)
            pbin = (t0 - plan.start_s) // plan.step_s
            flat = pbin * plan.n_buckets + k
            dst = series.setdefault(key, {})
            dst[flat] = dst.get(flat, 0) + c
        return {"series": [
            {"key": key, "bins": [[int(f), int(c)] for f, c in sorted(bins.items())]}
            for key, bins in series.items()
        ]}

    def _tail_wire(self, q: StandingQuery, plan, HostAccumulator, eval_batch):
        """The uncut live-trace tail (spans not yet through any cut):
        evaluated fresh per read — small by construction (idle traces
        cut every max_trace_idle_s)."""
        if not self.cfg.recent_tail or not self.ingesters:
            return None
        acc = HostAccumulator(plan)
        for ing in list(self.ingesters.values()):
            try:
                for batch in ing.standing_live_batches(q.tenant):
                    acc.stats["inspectedSpans"] += batch.num_spans
                    acc.add(eval_batch(plan, batch, batch.dictionary,
                                       acc.series), batch)
            except Exception:
                log.exception("standing tail scan failed")
        return acc.to_wire()

    # -- rebuild (restart / shed-heal) -----------------------------------
    def rebuild_all(self) -> None:
        with self._lock:
            qs = list(self._queries.values())
        for q in qs:
            self.rebuild(q)

    def rebuild(self, q: StandingQuery) -> None:
        """Exact reconstruction from what storage holds: stored blocks
        overlapping the window (read through the step-partial tier when
        the query matches a downsampling rule — "the downsampling tier
        IS the restart path" — span scan otherwise) plus the ingester
        WAL segments (cut but maybe unflushed). Live traces are NOT
        replayed: their spans fold at their own cut, and reads serve
        them as the tail meanwhile."""
        from tempo_tpu_torch.metrics_engine import SeriesTable

        if self.db is None:
            return
        from tempo_tpu_torch.backend.faults import with_retries

        with tracing.span("standing/rebuild", query_id=q.id), \
                usage.attribute(q.tenant, "standing"):
            # a block can FLUSH while this rebuild runs: the blocklist
            # snapshot misses it and by the WAL scan its segments are
            # cleared — both arms blind. Detect via the ingesters'
            # flushed ledgers and retry with a fresh poll; the converse
            # interleaving (block in both the snapshot and, briefly,
            # the WAL) is deduped by skipping WAL blocks whose id the
            # snapshot already counted.
            for attempt in range(3):
                t_start = time.time()
                poll_ok = True
                try:
                    with_retries(self.db.poll_now)
                except Exception:
                    # a stale/empty blocklist means the block arm below
                    # may be incomplete — the query must STAY dirty so
                    # the next read tries again, never a silent dip
                    poll_ok = False
                    log.exception("standing rebuild: blocklist poll failed; "
                                  "query stays dirty")
                now = time.time()
                w_lo = int(now - q.window_s - 2 * q.step_s)
                metas = list(self.db.blocklist.metas(q.tenant))
                snapshot_ids = {str(m.block_id) for m in metas}
                tmp_counts: dict[tuple, int] = {}
                tmp_series = SeriesTable(q.max_series)
                n_partial_rgs, blocks_ok = self._rebuild_blocks(
                    q, metas, w_lo, tmp_counts, tmp_series)
                with self._fold_lock:
                    seg_keys: set = set()
                    wal_ok = True
                    for ing in list(self.ingesters.values()):
                        try:
                            for key, batch in ing.standing_wal_batches(q.tenant):
                                if key.rsplit(":", 1)[0] in snapshot_ids:
                                    continue  # already counted as a block
                                seg_keys.add(key)
                                wal_ok &= self._rebuild_batch(
                                    q, batch, batch.dictionary,
                                    tmp_counts, tmp_series)
                        except Exception:
                            wal_ok = False
                            log.exception("standing rebuild: wal replay failed")
                    flushed_unseen = any(
                        bid not in snapshot_ids
                        for ing in list(self.ingesters.values())
                        for bid in ing.standing_flushed_since(q.tenant, t_start)
                    )
                    if flushed_unseen and attempt < 2:
                        continue  # a flush raced both arms: re-poll
                    with q.lock:
                        q.counts = tmp_counts
                        q.series = tmp_series
                        q.firing = {}
                        q.deviating = {}
                        q.dirty = not (poll_ok and blocks_ok and wal_ok
                                       and not flushed_unseen)
                        q.rebuilds += 1
                        q.rebuilt_segs = seg_keys
                        q.partial_row_groups += n_partial_rgs
                        self._eval_alert(q, now)
                        self._eval_deviation(q, now)
                    break
            rebuilds_total.inc()
        self._flush_deviation_events()

    def _rebuild_blocks(self, q: StandingQuery, metas: list, w_lo: int,
                        tmp_counts: dict, tmp_series) -> tuple[int, bool]:
        """Stored-block arm of a rebuild; returns (row groups served
        from step partials, every block folded cleanly)."""
        n_partial = 0
        ok = True
        block_cfg = self.db.cfg.block
        rules = rules_mod.block_rules(block_cfg)
        from tempo_tpu_torch.backend.faults import with_retries

        rc = self.db.result_cache
        rc_fp = (rc_fingerprint(q) if rc.enabled() else None)
        for m in metas:
            if m.end_time < w_lo:
                continue
            try:
                def one(meta=m):
                    # result cache (tempo_tpu/resultcache): a vtpu1
                    # block's standing contribution is cached as a
                    # w_lo-INDEPENDENT row log — the window filter
                    # applies at replay, so one entry serves every
                    # rebuild regardless of when it runs
                    use_rc = (rc_fp is not None
                              and getattr(meta, "version", "") == "vtpu1")
                    if use_rc:
                        doc = rc.get(q.tenant, str(meta.block_id),
                                     "standing", rc_fp)
                        if doc is not None and not doc.get("neg"):
                            scratch: dict[tuple, int] = {}
                            n = self._replay_block_rows(
                                q, doc["w"], w_lo, scratch, tmp_series)
                            for k, c in scratch.items():
                                tmp_counts[k] = tmp_counts.get(k, 0) + c
                            return n, True
                    blk = self.db.encoding_for(meta.version).open_block(
                        meta, self.db.backend, block_cfg)
                    if use_rc:
                        # full-compute row log, committed via the SAME
                        # replay a hit takes (warm-miss ≡ hit ≡ cold)
                        log_doc, blk_ok = self._rebuild_block_logged(
                            q, blk, rules)
                        scratch = {}
                        n = self._replay_block_rows(
                            q, log_doc, w_lo, scratch, tmp_series)
                        for k, c in scratch.items():
                            tmp_counts[k] = tmp_counts.get(k, 0) + c
                        if blk_ok:
                            rc.put(q.tenant, str(meta.block_id), "standing",
                                   rc_fp, log_doc,
                                   bytes_saved=int(blk.bytes_read))
                        return n, blk_ok
                    # a block that half-folded before a transient fault
                    # must contribute nothing twice: count into a scratch
                    # dict, commit only on success
                    scratch = {}
                    n, blk_ok = self._rebuild_block(q, blk, rules, w_lo,
                                                    scratch, tmp_series)
                    for k, c in scratch.items():
                        tmp_counts[k] = tmp_counts.get(k, 0) + c
                    return n, blk_ok

                n, blk_ok = with_retries(one)
                n_partial += n
                ok = ok and blk_ok
            except Exception:
                ok = False
                log.exception("standing rebuild: block %s failed (its spans "
                              "stay absent until the next rebuild)", m.block_id)
        return n_partial, ok

    def _rebuild_block(self, q: StandingQuery, blk, rules, w_lo: int,
                       tmp_counts: dict, tmp_series) -> tuple[int, bool]:
        """One block into the temp accumulator; returns (row groups
        served from step partials, folded exactly). The step-partial
        fast path folds stored tables directly onto the standing grid
        (the rule grid refines it when steps divide); otherwise row
        groups evaluate span-wise through the same _rebuild_batch
        slotting."""
        n_partial = 0
        ok = True
        step = q.step_s
        if getattr(blk.meta, "version", "") != "vtpu1":
            # non-vtpu encodings: whole-block span iteration (legacy)
            for batch in blk.iter_trace_batches():
                ok &= self._rebuild_batch(q, batch, batch.dictionary,
                                          tmp_counts, tmp_series)
            return 0, ok
        # the query's own template IS a grid-aligned 1-bin plan (start 0,
        # the standing step), so rule matching is exactly the read path's
        rule = rules_mod.match_rule(q.template, rules)
        for rg in blk.index().row_groups:
            if rg.end_s < w_lo:
                continue
            if rule is not None and rules_mod.rg_has_partial(rg, rule):
                name = rules_mod.page_name(rule.name)
                table = blk.read_columns(rg, [name])[name]
                keys = rg.partials[rule.name]["series"]
                for row in table.reshape(-1, 4).astype(np.int64):
                    t0 = int(row[1]) * rule.step_s
                    if t0 < w_lo:
                        continue
                    s = tmp_series.slot_of(keys[int(row[0])])
                    if s < 0:
                        continue
                    key = (s, t0 // step, int(row[2]))
                    tmp_counts[key] = tmp_counts.get(key, 0) + int(row[3])
                n_partial += 1
                rules_mod.partial_row_groups_read_total.inc()
                continue
            for batch in _rg_batches(blk, rg):
                ok &= self._rebuild_batch(
                    q, batch, batch.dictionary or blk.dictionary(),
                    tmp_counts, tmp_series)
        return n_partial, ok

    def _rebuild_block_logged(self, q: StandingQuery, blk,
                              rules) -> tuple[dict, bool]:
        """One vtpu1 block -> a w_lo-independent row log for the result
        cache: every (series key, standing bin, bucket, count) the block
        can EVER contribute, tagged with the filter facts a replay needs
        (the partial row's t0; the owning row group's end_s). No window
        filter runs here — one log serves every future rebuild, filtered
        at replay exactly where the cold path filters.

        Row order is the replay-order contract: partial rows in stored
        table order, span rows in ascending local-slot order (np.unique's
        flat order) per row group — both identical to the sequence in
        which the cold path first touches each key, so replaying through
        a shared SeriesTable assigns the same slots the cold rebuild
        would (the unbounded local table below only names keys; the
        shared table's cap applies at replay)."""
        from tempo_tpu_torch.metrics_engine import SeriesTable

        rows: list = []
        prgs: list = []
        ok = True
        step = q.step_s
        local = SeriesTable(1 << 30)
        rule = rules_mod.match_rule(q.template, rules)
        for rg in blk.index().row_groups:
            rg_end = int(rg.end_s)
            if rule is not None and rules_mod.rg_has_partial(rg, rule):
                name = rules_mod.page_name(rule.name)
                table = blk.read_columns(rg, [name])[name]
                keys = rg.partials[rule.name]["series"]
                for row in table.reshape(-1, 4).astype(np.int64):
                    t0 = int(row[1]) * rule.step_s
                    rows.append([keys[int(row[0])], t0 // step, int(row[2]),
                                 int(row[3]), t0, rg_end])
                prgs.append(rg_end)
                continue
            for batch in _rg_batches(blk, rg):
                ok &= self._log_batch(q, batch,
                                      batch.dictionary or blk.dictionary(),
                                      local, rows, rg_end)
        return {"rows": rows, "prgs": prgs}, ok

    def _log_batch(self, q: StandingQuery, batch, dictionary, local_series,
                   rows: list, rg_end: int) -> bool:
        """_rebuild_batch's twin that appends loggable rows instead of
        committing counts (span rows carry t0=-1: the cold path filters
        spans per row group, never per bin)."""
        from tempo_tpu_torch.metrics_engine import eval_batch

        n = batch.num_spans
        if n == 0:
            return True
        t = batch.cols["start_unix_nano"].astype(np.int64)
        t_lo = max(0, int(t.min()) // 10**9)
        step = q.step_s
        start = (t_lo // step) * step
        n_bins = (int(t.max()) // (step * 10**9)) - (start // step) + 1
        if n_bins <= 0 or n_bins > rules_mod.WRITE_MAX_BINS:
            return False
        plan = rules_mod.window_plan(q.template, start, int(n_bins))
        res = eval_batch(plan, batch, dictionary, local_series)
        live = res.slots[res.slots >= 0]
        if not len(live):
            return True
        flats, counts = np.unique(live, return_counts=True)
        nb, nk = plan.n_bins, plan.n_buckets
        by_slot = {s: k for k, s in local_series.slots.items()}
        for f, c in zip(flats, counts):
            s = int(f) // (nb * nk)
            rem = int(f) % (nb * nk)
            rows.append([by_slot[s], start // step + rem // nk, rem % nk,
                         int(c), -1, rg_end])
        return True

    def _replay_block_rows(self, q: StandingQuery, doc: dict, w_lo: int,
                           tmp_counts: dict, tmp_series) -> int:
        """Fold a cached row log into a rebuild's temp accumulator,
        applying exactly the cold path's filters: row groups that end
        before the window are skipped whole, partial rows additionally
        filter on their own t0, and the shared series table's cap drops
        overflow keys in first-encounter order. Returns the number of
        partial-served row groups still inside the window (the
        n_partial the cold path would report)."""
        for key, qbin, bucket, count, t0, rg_end in doc.get("rows", ()):
            if rg_end < w_lo:
                continue
            if t0 >= 0 and t0 < w_lo:
                continue
            s = tmp_series.slot_of(key)
            if s < 0:
                continue
            k = (s, int(qbin), int(bucket))
            tmp_counts[k] = tmp_counts.get(k, 0) + int(count)
        return sum(1 for e in doc.get("prgs", ()) if e >= w_lo)

    def _rebuild_batch(self, q: StandingQuery, batch, dictionary,
                       tmp_counts: dict, tmp_series) -> bool:
        """Fold one replayed batch into the temp accumulator. Returns
        False — "this rebuild is NOT exact, stay dirty" — when a
        pathological time range forces the batch to be skipped (the fold
        path marks dirty in the same situation)."""
        from tempo_tpu_torch.metrics_engine import eval_batch

        n = batch.num_spans
        if n == 0:
            return True
        t = batch.cols["start_unix_nano"].astype(np.int64)
        t_lo = max(0, int(t.min()) // 10**9)
        step = q.step_s
        start = (t_lo // step) * step
        n_bins = (int(t.max()) // (step * 10**9)) - (start // step) + 1
        if n_bins <= 0 or n_bins > rules_mod.WRITE_MAX_BINS:
            return False
        plan = rules_mod.window_plan(q.template, start, int(n_bins))
        res = eval_batch(plan, batch, dictionary, tmp_series)
        live = res.slots[res.slots >= 0]
        if not len(live):
            return True
        flats, counts = np.unique(live, return_counts=True)
        _add_flat_counts(tmp_counts, plan, start // step, flats, counts)
        return True

    # -- snapshot / restore ----------------------------------------------
    def maybe_snapshot(self, force: bool = False) -> None:
        if self.snapshot_path is None:
            return
        now = time.monotonic()
        if not force and now - self._last_snapshot < self.cfg.snapshot_period_s:
            return
        self._last_snapshot = now
        try:
            self.snapshot()
        except Exception:
            log.exception("standing snapshot failed")

    def snapshot(self) -> None:
        """Registrations + alert state + (advisory) counts -> one JSON
        file in the WAL dir, atomically renamed. Counts are a warm-start
        convenience; the authoritative restart path is rebuild()."""
        if self.snapshot_path is None:
            return
        with self._lock:
            qs = list(self._queries.values())
        doc = {"queries": []}
        for q in qs:
            with q.lock:
                doc["queries"].append({
                    **q.to_doc(),
                    "tenant": q.tenant,
                    "firing": {str(k): v for k, v in q.firing.items() if v},
                    "series": [
                        key for key, _ in
                        sorted(q.series.slots.items(), key=lambda kv: kv[1])
                    ],
                    "counts": [[s, b, k, c]
                               for (s, b, k), c in q.counts.items()],
                })
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.snapshot_path)

    def _restore(self) -> bool:
        if self.snapshot_path is None or not os.path.exists(self.snapshot_path):
            return False
        try:
            with open(self.snapshot_path) as f:
                doc = json.load(f)
        except Exception:
            log.exception("standing snapshot unreadable; starting empty")
            return False
        restored = 0
        for d in doc.get("queries", []):
            try:
                q = StandingQuery(d["id"], d["tenant"], d["query"], d["step"],
                                  d["window"], d.get("alert"),
                                  d.get("maxSeries", 64),
                                  deviation=d.get("deviation"))
                for key in d.get("series", []):
                    q.series.slot_of(key)
                q.counts = {(int(s), int(b), int(k)): int(c)
                            for s, b, k, c in d.get("counts", [])}
                q.dirty = True  # snapshot counts are advisory until rebuilt
                with self._lock:
                    self._queries[q.id] = q
                restored += 1
            except Exception:
                log.exception("standing restore: query %s dropped",
                              d.get("id"))
        for tenant in self.tenants():
            with self._lock:
                held = sum(1 for q in self._queries.values()
                           if q.tenant == tenant)
            standing_queries_gauge.set(held, tenant=tenant)
        if restored:
            log.info("standing: restored %d registration(s) from snapshot",
                     restored)
        return restored > 0

    def stop(self) -> None:
        try:
            self.snapshot()
        except Exception:
            log.exception("standing: final snapshot failed")

    # -- observability ----------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            qs = list(self._queries.values())
        return {
            "queries": len(qs),
            "tenants": len({q.tenant for q in qs}),
            "cutSpans": dict(self.cut_spans),
            "foldSpans": sum(q.fold_spans for q in qs),
            "sheds": sum(q.sheds for q in qs),
        }


def _add_flat_counts(counts_dict: dict, plan, bin_offset: int,
                     flats: np.ndarray, counts: np.ndarray) -> None:
    """Add a plan's flat slot counts into a sparse accumulator keyed
    (series slot, absolute bin, bucket); `bin_offset` is the plan's first
    absolute bin."""
    nb, nk = plan.n_bins, plan.n_buckets
    sslot = flats // (nb * nk)
    rem = flats % (nb * nk)
    abs_bin = bin_offset + rem // nk
    bucket = rem % nk
    for i in range(len(flats)):
        key = (int(sslot[i]), int(abs_bin[i]), int(bucket[i]))
        counts_dict[key] = counts_dict.get(key, 0) + int(counts[i])


def rc_fingerprint(q: StandingQuery) -> str:
    """Result-cache fingerprint of a standing query's block partials:
    the raw query text (the registration identity — standing queries
    are few and operator-controlled, so no literal-stripping indirection)
    plus the grid parameters the row log's bins are computed against."""
    from tempo_tpu_torch import resultcache as rc_mod

    return rc_mod.fingerprint("standing|" + q.query, int(q.step_s),
                              int(q.max_series))


def _rg_batches(blk, rg):
    """Span rows of one row group as a SpanBatch (rebuild fallback path
    for row groups without a usable step partial)."""
    yield blk._rows_to_batch(rg, np.arange(rg.n_spans))

