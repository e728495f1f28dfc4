"""Port of tempo_tpu/rca/engine.py (host code). The walks arm calls
the port's App.graph_walks and graph/walks.rank_suspects; the `_self_`
critical-path arm reads the spans that `self_tracing` exports under
`_self_` (none with self-tracing off, its default). `python -m
tempo_tpu_torch.cli rca replay` re-runs the classifier offline.

Closed-loop auto-RCA: triggers -> evidence bundle -> typed finding.

The senses already exist — burn-rate SLO alerts (util/slo), standing
deviation detection (standing/engine), query insights (util/insights),
`_self_` critical paths and seeded temporal walks (graph/), breaker /
governor / quarantine state — but a human chains them by hand during an
incident. This engine closes the loop: a fast-burn SLO transition or a
standing-query deviation opens a bounded incident record by running the
runbook mechanically:

1. snapshot the affected tenant's interesting insights records over the
   trigger window (which query shapes, which stage dominates, exemplar
   traceparents);
2. run a `_self_` critical-path query over the window to name the slow
   stage/subsystem;
3. launch seeded temporal walks from the burning service to rank
   upstream suspect dependency edges (deterministic: the same seed over
   the same graph replays bit-identically — citable evidence);
4. pull breaker / resource-governor / quarantine / usage-ledger facts
   into the same bundle;
5. classify (rca/classify.py, pure) into a typed cause.

Triggers enqueue; ONE worker thread collects evidence (collection runs
queries — it must never run inside the SLO eval loop or the standing
fold path, both of which fire the subscriber callbacks). Every evidence
arm is independently fault-isolated: a failing collector yields an
absent key, never a lost incident. Per-trigger-key cooldown and a
bounded incident ring keep the record small under a flapping alert.

Surfaces: /api/rca (+ /api/rca/{incidentID}), `cli rca`, and the
`tempo_tpu_rca_*` metric families.
"""

from __future__ import annotations

import logging
import queue
import re
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass

from tempo_tpu_torch.rca.classify import classify as _classify
from tempo_tpu_torch.util import metrics, resource, tracing, usage
from tempo_tpu_torch.util import insights as insights_mod

log = logging.getLogger(__name__)

incidents_total = metrics.counter(
    "tempo_tpu_rca_incidents_total",
    "Incidents opened by the auto-RCA engine, by trigger kind "
    "(slo_burn | standing_deviation)",
)
attributed_total = metrics.counter(
    "tempo_tpu_rca_attributed_total",
    "Incidents attributed, by typed cause (see rca/classify.py CAUSES)",
)
suppressed_total = metrics.counter(
    "tempo_tpu_rca_suppressed_total",
    "Incidents whose cause is a known suppressible artifact "
    "(e.g. the blocklist-poll handoff dip)",
)
triggers_dropped_total = metrics.counter(
    "tempo_tpu_rca_triggers_dropped_total",
    "RCA triggers dropped by cooldown or a full trigger queue, by reason",
)
open_incidents_gauge = metrics.gauge(
    "tempo_tpu_rca_open_incidents",
    "Incident records currently held in the bounded ring",
)
time_to_attribution_hist = metrics.histogram(
    "tempo_tpu_rca_time_to_attribution_seconds",
    "Trigger-to-attributed latency of one incident (evidence collection "
    "plus classification)",
    buckets=(0.05, 0.2, 1.0, 5.0, 15.0, 60.0, 300.0),
)


@dataclass
class RCAConfig:
    """`rca:` config section (AppConfig.rca)."""

    enabled: bool = False
    # bounded incident ring: oldest records fall off
    max_incidents: int = 64
    # one incident per trigger key per cooldown — a flapping alert must
    # not flood the ring with near-identical bundles
    cooldown_s: float = 300.0
    # evidence window: how far back of the trigger the bundle looks
    window_s: float = 600.0
    # temporal-walk parameters (graph/walks.sample_walks); the seed makes
    # suspect rankings replayable
    walks: int = 64
    walk_steps: int = 6
    walk_seed: int = 0
    # insights records snapshotted into the bundle
    insights_limit: int = 20
    # pending triggers beyond this drop (counted, never blocking the
    # SLO eval loop or the standing fold path)
    queue_max: int = 16


class UnknownIncident(KeyError):
    """No incident with that id visible to the tenant (HTTP 404)."""


_SERVICE_RE = re.compile(r'resource\.service\.name\s*=\s*"([^"]*)"')
_BY_SERVICE_RE = re.compile(r'by\s*\(\s*resource\.service\.name\s*\)')


def _service_of_series(series_key: str, query: str = "") -> str | None:
    """Burning service from a standing-deviation series key. Two shapes:
    a labelled key (`resource.service.name="x"`) matches directly; a
    query grouped by resource.service.name alone stores the BARE label
    value as the key, so the whole key is the service."""
    m = _SERVICE_RE.search(series_key or "")
    if m:
        return m.group(1)
    if (series_key and _BY_SERVICE_RE.search(query or "")
            and not any(ch in series_key for ch in '=({,')):
        return series_key.strip()
    return None


def _trace_id_of_traceparent(tp: str) -> str | None:
    parts = (tp or "").split("-")
    return parts[1] if len(parts) >= 3 and len(parts[1]) == 32 else None


def _gauge_values(name: str) -> dict:
    g = metrics.REGISTRY.get(name)
    if g is None or not hasattr(g, "_values"):
        return {}
    with g._lock:
        return {labels: v for labels, v in g._values.items()}


class RCAEngine:
    """Trigger sink + evidence collector + bounded incident record."""

    def __init__(self, cfg: RCAConfig, app):
        self.cfg = cfg
        self.app = app
        self._lock = threading.Lock()
        self._incidents: deque = deque(maxlen=max(1, cfg.max_incidents))
        self._last_fire: dict[tuple, float] = {}
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, cfg.queue_max))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # window-delta baselines for cumulative signals, sampled at
        # start and re-anchored after each incident so successive
        # incidents report their OWN deltas
        self._vulture_base: dict = {}
        self._shed_base = 0.0
        self._usage_base: dict = {}
        self.rebaseline()

    # -- trigger sinks (SLO / standing subscriber callbacks) -------------
    def on_slo_burn(self, event: dict) -> None:
        """slo.SLOEngine.subscribe sink — runs on the SLO eval thread,
        so it only enqueues."""
        self._offer(("slo", event.get("slo", "")), event)

    def on_deviation(self, event: dict) -> None:
        """standing.StandingEngine.subscribe_deviations sink — runs on
        the fold/cut path, so it only enqueues."""
        self._offer(("deviation", event.get("queryId", "")), event)

    def _offer(self, key: tuple, event: dict) -> None:
        now = float(event.get("at") or time.time())
        with self._lock:
            last = self._last_fire.get(key)
            if last is not None and now - last < self.cfg.cooldown_s:
                triggers_dropped_total.inc(reason="cooldown")
                return
            self._last_fire[key] = now
        event = dict(event)
        event.setdefault("at", now)
        event["enqueuedWall"] = time.time()
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            triggers_dropped_total.inc(reason="queue_full")
            with self._lock:
                # a dropped trigger must be able to re-fire immediately
                self._last_fire.pop(key, None)

    # -- worker -----------------------------------------------------------
    def start(self) -> "RCAEngine":
        def loop():
            while not self._stop.is_set():
                try:
                    event = self._queue.get(timeout=0.5)
                except queue.Empty:
                    continue
                try:
                    self.process_trigger(event)
                except Exception:
                    log.exception("RCA trigger processing failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="rca-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- baselines --------------------------------------------------------
    def rebaseline(self) -> None:
        """(Re-)anchor the cumulative-signal baselines the next
        incident's deltas are computed against."""
        with self._lock:
            self._vulture_base = self._vulture_sample()
            self._shed_base = self._shed_sample()
            self._usage_base = usage.ACCOUNTANT.snapshot()

    @staticmethod
    def _vulture_sample() -> dict:
        return _gauge_values("tempo_vulture_error_total")

    @staticmethod
    def _shed_sample() -> float:
        return sum(_gauge_values("tempo_tpu_shed_total").values())

    # -- the loop body (also the offline-replay seam) ---------------------
    def process_trigger(self, event: dict, now: float | None = None) -> dict:
        """One trigger -> one attributed incident record. Public and
        synchronous so tests and `cli rca` drive it deterministically;
        the worker thread calls exactly this."""
        now = float(now if now is not None else event.get("at") or time.time())
        t0 = time.perf_counter()
        tenant = str(event.get("tenant") or "")
        service = (event.get("service")
                   or _service_of_series(event.get("series", ""),
                                          event.get("query", "")))
        trigger = {**event, "service": service}
        trigger.pop("enqueuedWall", None)
        with tracing.span("rca/incident", kind=event.get("kind", "")):
            evidence = self.collect_evidence(trigger, tenant, now)
            finding = _classify(evidence)
        incident = {
            "id": f"inc-{uuid.uuid4().hex[:12]}",
            "openedAt": now,
            "tenant": tenant,  # "" = global (process-level SLO trigger)
            "trigger": trigger,
            "window": evidence["window"],
            "finding": finding,
            "evidence": evidence,
        }
        incident["attributionSeconds"] = round(time.perf_counter() - t0, 6)
        incidents_total.inc(trigger=event.get("kind", "unknown"))
        attributed_total.inc(cause=finding["cause"])
        if finding["suppressed"]:
            suppressed_total.inc()
        time_to_attribution_hist.observe(incident["attributionSeconds"])
        with self._lock:
            self._incidents.append(incident)
            open_incidents_gauge.set(len(self._incidents))
        self.rebaseline()
        log.warning("RCA incident %s: cause=%s tier=%s service=%s stage=%s "
                    "(%s)", incident["id"], finding["cause"], finding["tier"],
                    finding["service"], finding["stage"], finding["details"])
        return incident

    # -- evidence collection ---------------------------------------------
    def collect_evidence(self, trigger: dict, tenant: str,
                         now: float) -> dict:
        """Every arm independently fault-isolated: a broken collector
        yields an absent/empty key, never a lost incident."""
        start_s = int(now - self.cfg.window_s)
        end_s = int(now) + 1
        evidence: dict = {
            "trigger": trigger,
            "window": {"start": start_s, "end": end_s},
        }
        service = trigger.get("service")

        try:
            evidence["vultureErrors"] = self._vulture_delta()
        except Exception:
            log.exception("RCA: vulture evidence arm failed")
        try:
            evidence["breakers"] = self._breaker_states()
        except Exception:
            log.exception("RCA: breaker evidence arm failed")
        try:
            gov = resource.governor()
            evidence["governor"] = {
                "level": gov.level(),
                "levelName": gov.level_name(),
                "shedDelta": max(0.0, self._shed_sample() - self._shed_base),
            }
        except Exception:
            log.exception("RCA: governor evidence arm failed")
        try:
            db = getattr(self.app, "db", None)
            if db is not None:
                evidence["quarantine"] = db.blocklist.quarantined_report()
        except Exception:
            log.exception("RCA: quarantine evidence arm failed")
        try:
            self._insights_arm(evidence, tenant, now)
        except Exception:
            log.exception("RCA: insights evidence arm failed")
        try:
            cp = self.app.graph_critical_path(
                start_s=start_s, end_s=end_s, by="name",
                org_id=tracing.SELF_TENANT)
            evidence["criticalPath"] = cp.get("groups", [])[:5]
        except Exception:
            log.debug("RCA: `_self_` critical-path arm unavailable",
                      exc_info=True)
        try:
            self._walks_arm(evidence, tenant, service, start_s, end_s)
        except Exception:
            log.debug("RCA: temporal-walk arm unavailable", exc_info=True)
        try:
            evidence["usageDelta"] = self._usage_delta(tenant)
        except Exception:
            log.exception("RCA: usage evidence arm failed")
        return evidence

    def _vulture_delta(self) -> list[dict]:
        cur = self._vulture_sample()
        out = []
        for labels, v in cur.items():
            delta = v - self._vulture_base.get(labels, 0.0)
            if delta > 0:
                d = dict(labels)
                out.append({"type": d.get("type", ""),
                            "tier": d.get("tier", ""), "count": delta})
        out.sort(key=lambda e: (-e["count"], e["type"], e["tier"]))
        return out

    @staticmethod
    def _breaker_states() -> dict:
        names = {0: "closed", 1: "half-open", 2: "open"}
        out = {}
        for labels, v in _gauge_values("tempo_tpu_circuit_state").items():
            name = dict(labels).get("name", "")
            out[name] = {"state": int(v), "stateName": names.get(int(v), "?")}
        return out

    def _insights_arm(self, evidence: dict, tenant: str, now: float) -> None:
        records = insights_mod.LOG.snapshot(
            tenant=tenant or None,
            limit=self.cfg.insights_limit,
            since_unix=now - self.cfg.window_s,
            reasons=("error", "partial", "slow"))
        stage_seconds: dict[str, float] = {}
        exemplars: list[str] = []
        for r in records:
            for stage, secs in (r.get("stageSeconds") or {}).items():
                stage_seconds[stage] = stage_seconds.get(stage, 0.0) + secs
            tid = _trace_id_of_traceparent(r.get("traceparent", ""))
            if tid and tid not in exemplars:
                exemplars.append(tid)
        evidence["insights"] = records
        evidence["stageSeconds"] = {k: round(v, 6)
                                    for k, v in stage_seconds.items()}
        evidence["exemplarTraceIds"] = exemplars[:10]

    def _walks_arm(self, evidence: dict, tenant: str, service: str | None,
                   start_s: int, end_s: int) -> None:
        from tempo_tpu_torch.graph.walks import rank_suspects

        kw = dict(start_s=start_s, end_s=end_s, seed=self.cfg.walk_seed,
                  walks=self.cfg.walks, steps=self.cfg.walk_steps,
                  org_id=tenant or None)
        try:
            doc = self.app.graph_walks(start_node=service, **kw)
        except ValueError:
            if service is None:
                raise
            # the burning service has no outgoing edges in the selected
            # graph (leaf, or not present) — walk the whole graph instead
            doc = self.app.graph_walks(**kw)
        evidence["walks"] = {
            "seed": doc.get("seed"),
            "edges": doc.get("edges"),
            "visits": doc.get("visits", {}),
            "edgeVisits": doc.get("edgeVisits", {}),
        }
        evidence["suspects"] = rank_suspects(doc)

    def _usage_delta(self, tenant: str) -> dict:
        cur = usage.ACCOUNTANT.snapshot()
        out: dict = {}
        scope = [tenant] if tenant else sorted(cur)
        for t in scope:
            now_totals = self._flatten_usage(cur.get(t, {}))
            base_totals = self._flatten_usage(self._usage_base.get(t, {}))
            delta = {f: round(now_totals[f] - base_totals.get(f, 0.0), 6)
                     for f in now_totals
                     if now_totals[f] - base_totals.get(f, 0.0) > 0}
            if delta:
                out[t] = delta
        return out

    @staticmethod
    def _flatten_usage(tenant_doc: dict) -> dict:
        """{kind: {field: v}} (ACCOUNTANT.snapshot form) -> {field: v}."""
        flat: dict[str, float] = {}
        for fields in tenant_doc.values():
            if not isinstance(fields, dict):
                continue
            for f, v in fields.items():
                if isinstance(v, (int, float)):
                    flat[f] = flat.get(f, 0.0) + v
        return flat

    # -- read API ---------------------------------------------------------
    def list(self, tenant: str) -> list[dict]:
        """Newest-first incident summaries visible to `tenant`: its own
        plus global (process-level) incidents."""
        with self._lock:
            incidents = list(self._incidents)
        out = []
        for inc in reversed(incidents):
            if inc["tenant"] not in ("", tenant):
                continue
            f = inc["finding"]
            out.append({
                "id": inc["id"],
                "openedAt": inc["openedAt"],
                "tenant": inc["tenant"],
                "trigger": inc["trigger"].get("kind"),
                "cause": f["cause"],
                "suppressed": f["suppressed"],
                "tier": f["tier"],
                "service": f["service"],
                "stage": f["stage"],
            })
        return out

    def get(self, incident_id: str, tenant: str) -> dict:
        with self._lock:
            for inc in self._incidents:
                if inc["id"] == incident_id and inc["tenant"] in ("", tenant):
                    return dict(inc)
        # a foreign tenant's id is indistinguishable from absent
        raise UnknownIncident(incident_id)

    def status(self) -> dict:
        with self._lock:
            n = len(self._incidents)
            suppressed = sum(1 for i in self._incidents
                             if i["finding"]["suppressed"])
        return {"incidents": n, "suppressed": suppressed,
                "queue": self._queue.qsize()}
