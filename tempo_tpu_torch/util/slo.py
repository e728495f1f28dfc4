"""Port of tempo_tpu/util/slo.py, copied as is (host code): the SLIs
read the port's own metric registry.

Burn-rate SLO engine: turn SLI counters into judgments.

PRs 9-10 made the engine measurable (stage waterfalls, cost vectors)
and the vulture (vulture.py) continuously proves read-after-write
correctness per storage tier; this module is the layer that CONSUMES
those measurements: service-level indicators defined over counters the
process already exports, evaluated as multi-window multi-burn-rate
alerts (the Google SRE workbook policy: page when the 5m AND 1h windows
both burn faster than `fast_burn`, ticket when 6h AND 3d both burn
faster than `slow_burn`), with error-budget accounting over the slow
window.

Mechanism (TiLT's lesson from PAPERS.md — stream queries compile to
incremental folds): every SLI is a pair of CUMULATIVE counters
(good, total). The engine samples them on a cadence into a bounded
ring; a window's error rate is a pure delta between two samples, so
evaluation cost is O(objectives), never O(events). Counter resets
(process restart of a scraped component, test Registry reuse) are
tolerated the same way PromQL's rate() does it: a sample that went
backwards shifts the monotone base forward instead of producing a
negative delta.

Exported state:
- gauges `tempo_tpu_slo_burn_rate{slo,window}`,
  `tempo_tpu_slo_error_budget_remaining{slo}`,
  `tempo_tpu_slo_sli_events{slo}` / `tempo_tpu_slo_sli_good_events{slo}`
  (the monotone cumulative pair — alert rules and tests can verify the
  budget math against these bit-exactly),
  `tempo_tpu_slo_burning{slo,severity}` (0/1, severity page|ticket);
- `/status/slo` (api/server.py) — the full accounting document;
- alert rules in operations/mixin/alerts.yaml consume the gauges.

SLIs are process-local: each role judges the counters it owns (the
frontend judges query availability/latency, a vulture sidecar judges
read correctness/freshness). Fleet rollups belong to Prometheus.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from dataclasses import dataclass, field

from tempo_tpu_torch.util import metrics

log = logging.getLogger(__name__)

# window name -> seconds; FAST pair pages, SLOW pair tickets
WINDOWS = (("5m", 300), ("1h", 3600), ("6h", 21600), ("3d", 259200))
WINDOW_S = dict(WINDOWS)
FAST_WINDOWS = ("5m", "1h")
SLOW_WINDOWS = ("6h", "3d")
BUDGET_WINDOW = "3d"

slo_burn_rate = metrics.gauge(
    "tempo_tpu_slo_burn_rate",
    "Error-budget burn rate per SLO and evaluation window "
    "(1.0 = spending exactly the budget; >1 = on track to exhaust it)",
)
slo_budget_remaining = metrics.gauge(
    "tempo_tpu_slo_error_budget_remaining",
    "Fraction of the error budget left over the 3d accounting window "
    "(negative = overspent)",
)
slo_events = metrics.gauge(
    "tempo_tpu_slo_sli_events",
    "Monotone cumulative SLI event count per SLO (reset-adjusted view "
    "of the raw counters the SLI is derived from)",
)
slo_good_events = metrics.gauge(
    "tempo_tpu_slo_sli_good_events",
    "Monotone cumulative good-event count per SLO (reset-adjusted)",
)
slo_burning = metrics.gauge(
    "tempo_tpu_slo_burning",
    "1 while an SLO's multi-window burn-rate condition holds, by "
    "severity (page = fast 5m+1h pair, ticket = slow 6h+3d pair)",
)


@dataclass
class SLOObjective:
    """One objective: an SLI source evaluated against a target ratio."""

    name: str
    sli: str  # key into SLI_SOURCES
    objective: float = 0.999
    # latency/freshness SLIs: an event is good when it finished within
    # this many seconds (ignored by availability-style sources)
    threshold_s: float = 0.0


@dataclass
class SLOConfig:
    """`slo:` config section."""

    enabled: bool = False
    eval_interval_s: float = 15.0
    # burn-rate thresholds (SRE workbook defaults for a 3d budget)
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    # empty = default_objectives()
    objectives: list = field(default_factory=list)


def default_objectives() -> list[SLOObjective]:
    return [
        SLOObjective("writes-available", "availability_write", 0.999),
        SLOObjective("reads-available", "availability_read", 0.999),
        SLOObjective("vulture-read", "vulture", 0.999),
        SLOObjective("freshness", "freshness", 0.99, threshold_s=10.0),
        SLOObjective("query-latency", "query_latency", 0.99, threshold_s=3.0),
    ]


# ---------------------------------------------------------------------------
# SLI sources: name -> fn(objective) -> (good, total) cumulative floats.
# All read the live registry BY NAME (never creating), so a process that
# doesn't host a family yields (0, 0) and the objective idles at 100%.
# ---------------------------------------------------------------------------

# ingest routes whose 5xx responses burn the write SLO
WRITE_ROUTES = ("/v1/traces", "/api/v2/spans", "/api/v1/spans", "/api/traces")
# query routes whose 5xx responses / latency burn the read SLOs
READ_ROUTES = ("/api/traces/{traceID}", "/api/search", "/api/search/tags",
               "/api/metrics/query_range")


def _counter_sum(name: str, pred=None) -> float:
    m = metrics.REGISTRY.get(name)
    if m is None or not hasattr(m, "_values"):
        return 0.0
    with m._lock:
        items = list(m._values.items())
    total = 0.0
    for labels, v in items:
        if pred is None or pred(dict(labels)):
            total += v
    return total


def _hist_good_total(name: str, threshold_s: float, pred=None) -> tuple[float, float]:
    """(observations <= threshold_s, observations) from a histogram's
    cumulative buckets — good = count of the smallest bucket whose upper
    bound covers the threshold (the conservative read: a threshold
    between bucket bounds rounds DOWN to the tighter bucket)."""
    h = metrics.REGISTRY.get(name)
    if h is None or not hasattr(h, "buckets"):
        return 0.0, 0.0
    idx = bisect.bisect_right(h.buckets, threshold_s) - 1
    with h._lock:
        good = total = 0.0
        for labels, counts in h._counts.items():
            if pred is not None and not pred(dict(labels)):
                continue
            n = h._totals.get(labels, 0)
            total += n
            if idx >= len(counts):
                good += n
            elif idx >= 0:
                good += counts[idx]
    return good, total


def _sli_availability_write(obj: SLOObjective) -> tuple[float, float]:
    # POST-only: GET /api/traces/{traceID} is a read route
    def in_scope(lbl: dict) -> bool:
        return lbl.get("method") == "POST" and lbl.get("route", "") in WRITE_ROUTES

    total = _counter_sum("tempo_request_duration_seconds_total", in_scope)
    bad = _counter_sum(
        "tempo_request_duration_seconds_total",
        lambda lbl: in_scope(lbl) and str(lbl.get("status_code", "")).startswith("5"),
    )
    return total - bad, total


def _sli_availability_read(obj: SLOObjective) -> tuple[float, float]:
    def in_scope(lbl: dict) -> bool:
        return lbl.get("method") == "GET" and any(
            lbl.get("route", "").startswith(r) for r in READ_ROUTES)

    total = _counter_sum("tempo_request_duration_seconds_total", in_scope)
    bad = _counter_sum(
        "tempo_request_duration_seconds_total",
        lambda lbl: in_scope(lbl) and str(lbl.get("status_code", "")).startswith("5"),
    )
    return total - bad, total


def _sli_vulture(obj: SLOObjective) -> tuple[float, float]:
    """good/total over ALL vulture checks: each executed check counts
    one event (tempo_vulture_check_total) and each failed check counts
    exactly one error class (tempo_vulture_error_total), so
    good = checks - errors. The blocklist-poll handoff dip is a typed,
    expected artifact (vulture.py classifies it `handoff_dip`) — it
    must not burn the budget, so it is excluded from bad here."""
    total = _counter_sum("tempo_vulture_check_total")
    bad = _counter_sum("tempo_vulture_error_total",
                       lambda lbl: lbl.get("type") != "handoff_dip")
    return total - min(bad, total), total


def _sli_freshness(obj: SLOObjective) -> tuple[float, float]:
    return _hist_good_total("tempo_vulture_freshness_seconds",
                            obj.threshold_s or 10.0)


def _sli_query_latency(obj: SLOObjective) -> tuple[float, float]:
    def in_scope(lbl: dict) -> bool:
        return lbl.get("method") == "GET" and any(
            lbl.get("route", "").startswith(r) for r in READ_ROUTES)

    return _hist_good_total("tempo_request_duration_seconds",
                            obj.threshold_s or 3.0, in_scope)


SLI_SOURCES = {
    "availability_write": _sli_availability_write,
    "availability_read": _sli_availability_read,
    "vulture": _sli_vulture,
    "freshness": _sli_freshness,
    "query_latency": _sli_query_latency,
}


def register_sli_source(name: str, fn) -> None:
    """Extension seam (tests, custom deployments): fn(objective) ->
    (good, total) cumulative."""
    SLI_SOURCES[name] = fn


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class _Series:
    """Reset-tolerant monotone view over one (good, total) source plus
    the bounded sample ring windows are cut from."""

    __slots__ = ("good_base", "total_base", "last_good", "last_total",
                 "samples")

    def __init__(self):
        self.good_base = 0.0
        self.total_base = 0.0
        self.last_good = 0.0
        self.last_total = 0.0
        self.samples: list[tuple[float, float, float]] = []  # (t, good, total)

    def push(self, t: float, good_raw: float, total_raw: float,
             keep_s: float, coalesce_s: float = 0.0) -> tuple[float, float]:
        # Counter-reset tolerance, keyed off TOTAL (the authoritative
        # monotone counter): a total below the previous one means the
        # underlying process restarted — fold the finished run into the
        # bases. `good` alone going backwards is NOT a reset: good is
        # DERIVED from counters read at different instants (total-bad),
        # so a check failing between the two reads shows as a transient
        # dip; folding on it would permanently inflate good past total
        # and mask real errors forever. Dips clamp instead.
        if total_raw < self.last_total:
            self.total_base += self.last_total
            self.good_base += self.last_good
        elif good_raw < self.last_good:
            good_raw = self.last_good
        self.last_good, self.last_total = good_raw, total_raw
        good = self.good_base + good_raw
        total = self.total_base + total_raw
        if (coalesce_s > 0 and self.samples
                and t - self.samples[-1][0] < coalesce_s
                and len(self.samples) > 1):
            # request-driven evaluations (a dashboard polling
            # /status/slo) must not grow the ring faster than the eval
            # cadence: near-coincident samples replace the newest one
            self.samples[-1] = (t, good, total)
        else:
            self.samples.append((t, good, total))
        cutoff = t - keep_s
        # trim, keeping one sample at/before the cutoff as the window base
        drop = 0
        while drop + 1 < len(self.samples) and self.samples[drop + 1][0] <= cutoff:
            drop += 1
        if drop:
            del self.samples[:drop]
        return good, total

    def window_delta(self, now: float, window_s: float) -> tuple[float, float]:
        """(good_delta, total_delta) between the newest sample and the
        newest sample at least window_s old (the oldest available when
        the ring is younger than the window)."""
        if not self.samples:
            return 0.0, 0.0
        cur = self.samples[-1]
        floor_t = now - window_s
        # newest sample at/before the window floor (bisect: samples are
        # time-ordered), else the oldest available
        idx = bisect.bisect_right(self.samples, (floor_t, float("inf"), float("inf")))
        base = self.samples[max(0, idx - 1)]
        return cur[1] - base[1], cur[2] - base[2]


class SLOEngine:
    """Samples every objective's SLI on a cadence and maintains the
    multi-window burn rates, budget accounting, and exported gauges."""

    def __init__(self, cfg: SLOConfig | None = None):
        self.cfg = cfg or SLOConfig()
        self.objectives: list[SLOObjective] = (
            list(self.cfg.objectives) or default_objectives())
        self._series: dict[str, _Series] = {o.name: _Series()
                                            for o in self.objectives}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_status: dict = {}
        self._last_eval_wall = 0.0
        # burn-transition subscribers (the RCA trigger seam): cb(event)
        # fired when an objective's page condition flips False -> True
        self._subs: list = []
        self._was_paging: dict[str, bool] = {}
        # ring retention: the slow window plus slack for the window base
        self._keep_s = WINDOW_S[BUDGET_WINDOW] + 4 * max(
            self.cfg.eval_interval_s, 1.0)

    # ------------------------------------------------------------------
    def evaluate(self, now: float | None = None) -> dict:
        """One sampling + evaluation pass (thread loop and tests both
        drive this; `now` is injectable for deterministic window math).
        Returns the /status/slo document."""
        now = time.time() if now is None else now
        fired: list[dict] = []
        doc: dict = {
            "enabled": True,
            "evaluatedAt": now,
            "windows": {name: s for name, s in WINDOWS},
            "fastBurnThreshold": self.cfg.fast_burn,
            "slowBurnThreshold": self.cfg.slow_burn,
            "objectives": [],
        }
        with self._lock:
            for obj in self.objectives:
                src = SLI_SOURCES.get(obj.sli)
                if src is None:
                    doc["objectives"].append({
                        "name": obj.name, "sli": obj.sli,
                        "error": f"unknown SLI source {obj.sli!r}",
                    })
                    continue
                try:
                    good_raw, total_raw = src(obj)
                except Exception as e:  # a broken SLI must not kill the loop
                    log.warning("SLI %s read failed: %s", obj.sli, e)
                    doc["objectives"].append({
                        "name": obj.name, "sli": obj.sli, "error": str(e)})
                    continue
                series = self._series[obj.name]
                good, total = series.push(
                    now, good_raw, total_raw, self._keep_s,
                    coalesce_s=self.cfg.eval_interval_s / 2)
                budget_frac = 1.0 - obj.objective
                windows: dict = {}
                burns: dict = {}
                for wname, wsec in WINDOWS:
                    dg, dt = series.window_delta(now, wsec)
                    # clamp: read skew can leave dg marginally over dt
                    err_rate = max(0.0, (dt - dg) / dt) if dt > 0 else 0.0
                    burn = err_rate / budget_frac if budget_frac > 0 else 0.0
                    burns[wname] = burn
                    windows[wname] = {
                        "goodDelta": dg, "totalDelta": dt,
                        "errorRate": err_rate, "burnRate": burn,
                    }
                    slo_burn_rate.set(burn, slo=obj.name, window=wname)
                bw = windows[BUDGET_WINDOW]
                budget_events = budget_frac * bw["totalDelta"]
                bad_events = max(0.0, bw["totalDelta"] - bw["goodDelta"])
                remaining = (1.0 - bad_events / budget_events
                             if budget_events > 0 else 1.0)
                fast = all(burns[w] > self.cfg.fast_burn for w in FAST_WINDOWS)
                slow = (burns[SLOW_WINDOWS[0]] > self.cfg.slow_burn
                        and burns[SLOW_WINDOWS[1]] > 1.0)
                slo_budget_remaining.set(remaining, slo=obj.name)
                slo_events.set(total, slo=obj.name)
                slo_good_events.set(good, slo=obj.name)
                slo_burning.set(float(fast), slo=obj.name, severity="page")
                slo_burning.set(float(slow), slo=obj.name, severity="ticket")
                doc["objectives"].append({
                    "name": obj.name,
                    "sli": obj.sli,
                    "objective": obj.objective,
                    "thresholdSeconds": obj.threshold_s,
                    "cumulative": {
                        # monotone adjusted AND raw — /status/slo must be
                        # bit-exactly reconcilable with the SLI counters
                        "good": good, "total": total,
                        "rawGood": good_raw, "rawTotal": total_raw,
                    },
                    "windows": windows,
                    "budget": {
                        "window": BUDGET_WINDOW,
                        "events": bw["totalDelta"],
                        "badEvents": bad_events,
                        "budgetEvents": budget_events,
                        "remainingRatio": remaining,
                        "spentRatio": 1.0 - remaining,
                    },
                    "burning": {"page": fast, "ticket": slow},
                })
                if fast and not self._was_paging.get(obj.name, False):
                    fired.append({
                        "kind": "slo_burn",
                        "slo": obj.name,
                        "sli": obj.sli,
                        "at": now,
                        "burns": dict(burns),
                        "errorRate": windows[FAST_WINDOWS[0]]["errorRate"],
                    })
                self._was_paging[obj.name] = fast
            self._last_status = doc
            self._last_eval_wall = time.time()
        # outside the lock: a subscriber may re-enter status()/burning()
        # or run arbitrary evidence collection; it must never be able to
        # deadlock or kill the evaluation loop
        for event in fired:
            for cb in list(self._subs):
                try:
                    cb(dict(event))
                except Exception:
                    log.exception("SLO burn subscriber failed")
        return doc

    def status(self, max_age_s: float | None = None) -> dict:
        """The /status/slo document; re-evaluates only when the cached
        one is older than max_age_s (default: the eval cadence) — a
        dashboard polling the endpoint must not drive sampling faster
        than the engine's own clock."""
        max_age = self.cfg.eval_interval_s if max_age_s is None else max_age_s
        with self._lock:
            fresh_enough = (self._last_status
                            and time.time() - self._last_eval_wall < max_age)
            if fresh_enough:
                return dict(self._last_status)
        return self.evaluate()

    def subscribe(self, cb) -> None:
        """Register cb(event) for page-burn transitions. The event dict
        carries kind="slo_burn", the objective name/sli, the evaluation
        timestamp and the per-window burn rates. Fired once per
        False->True page transition, outside the engine lock."""
        self._subs.append(cb)

    def burning(self, name: str, severity: str = "page") -> bool:
        for o in self._last_status.get("objectives", []):
            if o.get("name") == name:
                return bool(o.get("burning", {}).get(severity))
        return False

    # ------------------------------------------------------------------
    def start(self) -> "SLOEngine":
        def loop():
            while not self._stop.wait(self.cfg.eval_interval_s):
                try:
                    self.evaluate()
                except Exception:
                    log.exception("SLO evaluation failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
