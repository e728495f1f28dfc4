"""Port of tempo_tpu/vulture.py (host code): `Vulture` with the
in-process client (`InProcessClient`) on target=all and the HTTP client
(`HTTPClient`) of the `-target=vulture` sidecar.

Vulture — continuous blackbox verification across storage tiers.

Reference: cmd/tempo-vulture/main.go — a sidecar that perpetually
writes deterministic traces (seeded by timestamp, pkg/util/trace_info.go),
re-reads them, and exports error-rate metrics that production alerting
watches. `traceMetrics` (main.go:48) counts requested / requestFailed /
notFound / missingSpans / incorrectResult; those map here onto
`tempo_vulture_trace_total` (requested writes) and
`tempo_vulture_error_total{type,tier}` with
type = request_failed | notfound_byid | notfound_search | missing_spans
| incorrect_result, extended with metrics_mismatch (query_range
readback) and freshness_breach (write->readable lag over budget).

Beyond the reference, checks are AGE-TIERED: every probe timestamp is
re-verified at ages that pin each storage tier —

  fresh   still in ingester live traces (written seconds ago)
  recent  WAL / just-completed blocks (past the head-block cut)
  aged    post-compaction backend blocks (past at least one compaction
          cycle — config.check_config warns when the tier windows
          cannot outlive one)

so a failure names WHICH tier lost or mangled the data, not just that
"reads are broken". Each executed check counts into
`tempo_vulture_check_total{check,tier}`; the SLO engine (util/slo.py)
folds checks vs errors into the vulture-read SLI. A failed check logs
one structured line carrying the probe's traceparent, so one failed
check is one `_self_` trace when self-tracing is armed.

Clients are pluggable: InProcessClient drives an App directly (the
all-in-one deployment), HTTPClient drives a remote tempo_tpu_torch
server over the OTLP push + query HTTP API, byte-for-byte the way an
external vulture process would (`-target=vulture` builds exactly that
sidecar).

Known transient the prober legitimately surfaces (not a prober bug):
spans sit invisible to `query_range` for up to blocklist_poll_s right
after an ingester hands a block off — the metrics recent job scans
live/WAL only (flushed blocks would double-count) while the block jobs
see the blocklist as of the last poll. A metrics_mismatch that heals
within one poll interval is that gap; one that persists is real. The
gap is TYPED: an undercount-only mismatch on a probe still inside the
handoff grace window (handoff_grace_s; auto-derived from the app's
blocklist_poll_s in-process) records as `handoff_dip` instead of
`metrics_mismatch`, so SLO burn accounting (util/slo._sli_vulture) and
RCA incident attribution (tempo_tpu_torch/rca) can suppress it as a known
artifact — it never pollutes chaos ground truth.
STANDING-query reads (tempo_tpu_torch/standing, /api/metrics/standing) are
immune by construction — the cut's delta is already in the standing
accumulator before the block ever reaches the backend — so dashboards
and alert rules that must not see the dip should register standing
queries; the tolerance above applies only to ad-hoc query_range
(regression-pinned by tests/test_standing.py TestHandoffDip).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import threading
import time
import urllib.parse
from dataclasses import dataclass

from tempo_tpu_torch.encoding.common import SearchRequest
from tempo_tpu_torch.util import metrics, tracing
from tempo_tpu_torch.util.traceinfo import TraceInfo

log = logging.getLogger(__name__)

TIERS = ("fresh", "recent", "aged")

ERROR_TYPES = (
    "notfound_byid",
    "missing_spans",
    "incorrect_result",
    "notfound_search",
    "metrics_mismatch",
    "freshness_breach",
    "request_failed",
    # the blocklist-poll handoff gap, typed so consumers can suppress it
    # (see module docstring); never counted as a correctness failure
    "handoff_dip",
)

CHECKS = ("write", "byid", "search", "traceql", "metrics", "freshness")

vulture_traces_written = metrics.counter(
    "tempo_vulture_trace_total", "Traces written by vulture")
vulture_checks = metrics.counter(
    "tempo_vulture_check_total",
    "Vulture checks executed, by check kind "
    "(write | byid | search | traceql | metrics | freshness) and storage tier",
)
vulture_errors = metrics.counter(
    "tempo_vulture_error_total",
    "Vulture check failures by type (notfound_byid | missing_spans | "
    "incorrect_result | notfound_search | metrics_mismatch | "
    "freshness_breach | request_failed) and storage tier "
    "(fresh | recent | aged)",
)
vulture_freshness = metrics.histogram(
    "tempo_vulture_freshness_seconds",
    "Write-to-readable lag per visibility tier (fresh = trace-by-ID via "
    "ingester live data, recent = searchable via the search index path)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120),
)


@dataclass
class VultureConfig:
    """`vulture:` config section. enabled=True arms the in-process
    prober on target=all; `-target=vulture` builds a sidecar that
    pushes/queries `target` (and `query_target`, when reads go through
    a different entry — frontend vs distributor) over HTTP."""

    enabled: bool = False
    # HTTP sidecar mode: base URL writes go to; empty in-process
    target: str = ""
    # reads, when served by a different role than writes (frontend);
    # empty = same as target
    query_target: str = ""
    tenant: str = "single-tenant"
    write_backoff_s: int = 10
    read_backoff_s: int = 10
    search_backoff_s: int = 30
    metrics_backoff_s: int = 60
    retention_s: int = 14400
    # tier age boundaries: fresh = [0, recent_min_age_s), recent =
    # [recent_min_age_s, aged_min_age_s), aged = [aged_min_age_s,
    # retention_s). Aged probes must outlive one head-block cut AND one
    # compaction cycle (check_config warns otherwise).
    recent_min_age_s: int = 60
    aged_min_age_s: int = 5400
    # freshness SLI budget: write->readable lag above this is a
    # freshness_breach (and the poll gives up at 2x the budget)
    freshness_slo_s: float = 10.0
    # query_range step for the metrics readback check
    metrics_step_s: int = 5
    # handoff-dip typing window: an undercount-only metrics_mismatch on
    # a probe younger than recent_min_age_s + this grace is classified
    # `handoff_dip` (the known blocklist-poll transient, see module
    # docstring) instead of metrics_mismatch. 0 = auto: the driven app's
    # db.blocklist_poll_s when in-process, else disabled.
    handoff_grace_s: float = 0.0


class InProcessClient:
    """Drives an App in the same process (all-in-one deployment)."""

    def __init__(self, app, tenant: str | None = None):
        self.app = app
        self.tenant = tenant

    def push(self, traces) -> None:
        self.app.push_traces(traces, org_id=self.tenant)

    def query(self, trace_id: bytes):
        return self.app.find_trace(trace_id, org_id=self.tenant)

    def search(self, req: SearchRequest) -> list[str]:
        resp = self.app.search(req, org_id=self.tenant)
        return [t.trace_id_hex for t in resp.traces]

    def traceql(self, query: str, start_s: int, end_s: int,
                limit: int = 20) -> list[str]:
        hits = self.app.traceql(query, org_id=self.tenant, start_s=start_s,
                                end_s=end_s, limit=limit)
        return [t.trace_id_hex for t in hits]

    def query_range(self, query: str, start_s: int, end_s: int,
                    step_s: int) -> list[dict]:
        doc = self.app.query_range(query, start_s, end_s, step_s,
                                   org_id=self.tenant)
        return doc.get("result", [])


class HTTPClient:
    """Drives a tempo_tpu_torch server over HTTP (OTLP push + query API).

    query_url: optional separate base for the read side (a sidecar
    typically writes to the distributor and reads via the frontend)."""

    def __init__(self, base_url: str, tenant: str | None = None,
                 query_url: str | None = None):
        from tempo_tpu_torch.backend.httpclient import PooledHTTPClient

        self.client = PooledHTTPClient(base_url)
        self.query_client = (
            PooledHTTPClient(query_url) if query_url and query_url != base_url
            else self.client
        )
        self.tenant = tenant

    def _headers(self, extra=None) -> dict:
        h = dict(extra or {})
        if self.tenant:
            h["X-Scope-OrgID"] = self.tenant
        return h

    def push(self, traces) -> None:
        from tempo_tpu_torch.receivers import otlp

        self.client.request(
            "POST",
            "/v1/traces",
            headers=self._headers({"Content-Type": "application/x-protobuf"}),
            body=otlp.encode_traces_request(traces),
            ok=(200,),
        )

    def query(self, trace_id: bytes):
        from tempo_tpu_torch.backend.httpclient import HTTPError
        from tempo_tpu_torch.receivers import otlp

        try:
            _, body, _ = self.query_client.request(
                "GET",
                f"/api/traces/{trace_id.hex()}",
                headers=self._headers({"Accept": "application/protobuf"}),
                ok=(200,),
            )
        except HTTPError as e:
            if e.status == 404:
                return None
            raise
        traces = otlp.decode_traces_request(body)
        return traces[0] if traces else None

    def search(self, req: SearchRequest) -> list[str]:
        tags = " ".join(f"{k}={v}" for k, v in req.tags.items())
        qs = {"tags": tags, "limit": str(req.limit or 20)}
        if req.start_seconds:
            qs["start"] = str(req.start_seconds)
        if req.end_seconds:
            qs["end"] = str(req.end_seconds)
        _, body, _ = self.query_client.request(
            "GET",
            "/api/search?" + urllib.parse.urlencode(qs),
            headers=self._headers(),
            ok=(200,),
        )
        return [t["traceID"] for t in json.loads(body).get("traces", [])]

    def traceql(self, query: str, start_s: int, end_s: int,
                limit: int = 20) -> list[str]:
        qs = {"q": query, "limit": str(limit),
              "start": str(start_s), "end": str(end_s)}
        _, body, _ = self.query_client.request(
            "GET",
            "/api/search?" + urllib.parse.urlencode(qs),
            headers=self._headers(),
            ok=(200,),
        )
        return [t["traceID"] for t in json.loads(body).get("traces", [])]

    def query_range(self, query: str, start_s: int, end_s: int,
                    step_s: int) -> list[dict]:
        qs = {"q": query, "start": str(start_s), "end": str(end_s),
              "step": str(step_s)}
        _, body, _ = self.query_client.request(
            "GET",
            "/api/metrics/query_range?" + urllib.parse.urlencode(qs),
            headers=self._headers(),
            ok=(200,),
        )
        return json.loads(body).get("data", {}).get("result", [])


class Vulture:
    def __init__(
        self,
        client,
        cfg: VultureConfig | None = None,
        tenant: str | None = None,
        write_backoff_s: int | None = None,
        read_backoff_s: int | None = None,
        search_backoff_s: int | None = None,
        retention_s: int | None = None,
    ):
        cfg = cfg or VultureConfig()
        # explicit kwargs override the config (test and caller convenience)
        if tenant is not None:
            cfg = dataclasses.replace(cfg, tenant=tenant)
        if write_backoff_s is not None:
            cfg = dataclasses.replace(cfg, write_backoff_s=write_backoff_s)
        if read_backoff_s is not None:
            cfg = dataclasses.replace(cfg, read_backoff_s=read_backoff_s)
        if search_backoff_s is not None:
            cfg = dataclasses.replace(cfg, search_backoff_s=search_backoff_s)
        if retention_s is not None:
            cfg = dataclasses.replace(cfg, retention_s=retention_s)
        self.client = client
        self.cfg = cfg
        # handoff-dip grace: explicit config wins; in-process clients
        # auto-derive from the driven app's blocklist poll cadence
        self.handoff_grace_s = cfg.handoff_grace_s
        if not self.handoff_grace_s and hasattr(client, "app"):
            try:
                self.handoff_grace_s = float(
                    client.app.cfg.db.blocklist_poll_s)
            except Exception:
                self.handoff_grace_s = 0.0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # local mirrors of the process counters, per-instance: the
        # loadtest rig and tests read deltas without racing other
        # vultures in the same process
        self.error_counts: dict[tuple[str, str], int] = collections.Counter()
        self.check_counts: dict[tuple[str, str], int] = collections.Counter()
        self.written: collections.deque[int] = collections.deque(maxlen=4096)
        self.freshness_lags: collections.deque = collections.deque(maxlen=1024)
        # restart hygiene (reference: the vulture bounds its read window
        # by its own start time): candidates older than our first write
        # were written by NOBODY — checking them would page on phantom
        # data loss. None until the first write; a caller that wants to
        # audit a previous incarnation's probes sets this explicitly.
        self.first_write_s: int | None = None

    # convenience accessors (legacy signature compatibility)
    @property
    def tenant(self) -> str:
        return self.cfg.tenant

    @property
    def write_backoff_s(self) -> int:
        return self.cfg.write_backoff_s

    @property
    def retention_s(self) -> int:
        return self.cfg.retention_s

    # -- bookkeeping -----------------------------------------------------
    def _check(self, check: str, tier: str) -> None:
        vulture_checks.inc(check=check, tier=tier)
        self.check_counts[(check, tier)] += 1

    def _fail(self, type_: str, tier: str, check: str, info: TraceInfo | None,
              detail: str = "") -> bool:
        """Record one failed check: counter, local mirror, and ONE
        structured log line carrying the probe's traceparent (the check
        ran inside a span, so the line links straight to the `_self_`
        waterfall of the failing request)."""
        vulture_errors.inc(type=type_, tier=tier)
        self.error_counts[(type_, tier)] += 1
        cur = tracing._current_span.get()
        if cur is not None and not isinstance(cur, tracing.RemoteParent):
            cur.attributes["vulture.failed"] = type_
        rec = {
            "check": check, "type": type_, "tier": tier,
            "tenant": self.cfg.tenant,
        }
        if info is not None:
            rec["timestamp"] = info.timestamp_s
            rec["traceID"] = info.trace_id().hex()
        tp = tracing.current_traceparent()
        if tp:
            rec["traceparent"] = tp
        if detail:
            rec["detail"] = detail
        log.warning("vulture check failed: %s", json.dumps(rec, sort_keys=True))
        return False

    # -- tier geometry ---------------------------------------------------
    def tier_windows(self) -> dict[str, tuple[int, int]]:
        """tier -> (min_age_s, max_age_s): the probe ages each storage
        tier is pinned by."""
        c = self.cfg
        return {
            "fresh": (0, c.recent_min_age_s),
            "recent": (c.recent_min_age_s, c.aged_min_age_s),
            "aged": (c.aged_min_age_s, c.retention_s),
        }

    def tier_of_age(self, age_s: float) -> str:
        c = self.cfg
        if age_s < c.recent_min_age_s:
            return "fresh"
        if age_s < c.aged_min_age_s:
            return "recent"
        return "aged"

    # -- one write / one check (deterministically drivable) -------------
    def write_once(self, now_s: int | None = None) -> TraceInfo:
        now_s = int(now_s if now_s is not None else time.time())
        now_s -= now_s % self.cfg.write_backoff_s  # align to cadence
        info = TraceInfo(now_s, self.cfg.tenant)
        self._check("write", "fresh")
        try:
            with tracing.span("vulture/write", tier="fresh"):
                self.client.push([info.construct_trace()])
        except Exception as e:
            self._fail("request_failed", "fresh", "write", info, str(e))
            raise
        vulture_traces_written.inc()
        self.written.append(now_s)
        if self.first_write_s is None or now_s < self.first_write_s:
            self.first_write_s = now_s
        return info

    def _pick_readable(self, now_s: int, min_age_s: int,
                       max_age_s: int | None = None) -> TraceInfo | None:
        """Newest probe old enough to be queryable and inside both the
        tier window and retention (reference: vulture
        selectPastTimestamp). Prefers timestamps this incarnation
        ACTUALLY wrote (`self.written`) — the writer may skip cadence
        slots while blocked on a slow freshness poll or a failed push,
        and fabricating a skipped slot would read back a probe nobody
        wrote (phantom data loss). The aligned-slot fallback serves
        callers auditing a PREVIOUS incarnation's probes, which set
        first_write_s explicitly and have an empty written deque."""
        if self.first_write_s is None:
            return None  # nothing written by this incarnation yet
        newest = now_s - min_age_s
        oldest = max(now_s - self.cfg.retention_s, self.first_write_s)
        if max_age_s is not None:
            oldest = max(oldest, now_s - max_age_s)
        if newest < oldest:
            return None
        if self.written:
            eligible = [ts for ts in self.written if oldest <= ts <= newest]
            if not eligible:
                return None
            return TraceInfo(max(eligible), self.cfg.tenant)
        newest -= newest % self.cfg.write_backoff_s
        if newest < oldest:
            return None
        return TraceInfo(newest, self.cfg.tenant)

    def _pick_tier(self, now_s: int, tier: str) -> TraceInfo | None:
        min_age, max_age = self.tier_windows()[tier]
        # within the fresh tier, the probe must still be old enough for
        # one write cadence to have completed
        min_age = max(min_age, self.cfg.read_backoff_s if tier == "fresh" else min_age)
        return self._pick_readable(now_s, min_age, max_age)

    # -- checks ----------------------------------------------------------
    def check_by_id(self, now_s: int | None = None, min_age_s: int = 0,
                    tier: str | None = None, info: TraceInfo | None = None) -> bool:
        """Read the probe back by trace ID and verify span-for-span
        content. Classes: request_failed, notfound_byid, missing_spans,
        incorrect_result (all spans present by ID, but a span's name or
        start time differs from the deterministic construction)."""
        now_s = int(now_s if now_s is not None else time.time())
        if info is None:
            info = (self._pick_tier(now_s, tier) if tier
                    else self._pick_readable(now_s, min_age_s))
        if info is None:
            return True
        tier = tier or self.tier_of_age(now_s - info.timestamp_s)
        self._check("byid", tier)
        expected = info.construct_trace()
        with tracing.span("vulture/check_byid", tier=tier,
                          trace=info.trace_id().hex()):
            try:
                got = self.client.query(info.trace_id())
            except Exception as e:
                return self._fail("request_failed", tier, "byid", info, str(e))
            if got is None:
                return self._fail("notfound_byid", tier, "byid", info)
            want = {s.span_id: (s.name, s.start_unix_nano)
                    for s in expected.all_spans()}
            have = {s.span_id: (s.name, s.start_unix_nano)
                    for s in got.all_spans()}
            missing = set(want) - set(have)
            if missing:
                return self._fail(
                    "missing_spans", tier, "byid", info,
                    f"{len(missing)}/{len(want)} spans missing")
            wrong = [sid for sid, w in want.items() if have[sid] != w]
            if wrong:
                return self._fail(
                    "incorrect_result", tier, "byid", info,
                    f"{len(wrong)} spans differ from deterministic content")
        return True

    def check_search(self, now_s: int | None = None, min_age_s: int = 0,
                     tier: str | None = None, info: TraceInfo | None = None) -> bool:
        now_s = int(now_s if now_s is not None else time.time())
        if info is None:
            info = (self._pick_tier(now_s, tier) if tier
                    else self._pick_readable(now_s, min_age_s))
        if info is None:
            return True
        tier = tier or self.tier_of_age(now_s - info.timestamp_s)
        self._check("search", tier)
        expected = info.construct_trace()
        # search by the root service (always present in the written trace)
        service = expected.batches[0][0].get("service.name", "")
        req = SearchRequest(
            tags={"service": service},
            start_seconds=info.timestamp_s - 60,
            end_seconds=info.timestamp_s + 60,
            limit=0,
        )
        with tracing.span("vulture/check_search", tier=tier,
                          trace=info.trace_id().hex()):
            try:
                hits = self.client.search(req)
            except Exception as e:
                return self._fail("request_failed", tier, "search", info, str(e))
            if info.trace_id().hex() not in hits:
                return self._fail("notfound_search", tier, "search", info)
        return True

    def check_traceql(self, now_s: int | None = None,
                      tier: str | None = None,
                      info: TraceInfo | None = None) -> bool:
        """TraceQL readback: the probe's unique `vulture` attribute must
        select exactly this trace."""
        now_s = int(now_s if now_s is not None else time.time())
        if info is None:
            info = (self._pick_tier(now_s, tier) if tier
                    else self._pick_readable(now_s, 0))
        if info is None:
            return True
        tier = tier or self.tier_of_age(now_s - info.timestamp_s)
        self._check("traceql", tier)
        with tracing.span("vulture/check_traceql", tier=tier,
                          trace=info.trace_id().hex()):
            try:
                hits = self.client.traceql(
                    info.traceql_query(),
                    start_s=info.timestamp_s - 60,
                    end_s=info.timestamp_s + 60,
                )
            except Exception as e:
                return self._fail("request_failed", tier, "traceql", info, str(e))
            if info.trace_id().hex() not in hits:
                return self._fail("notfound_search", tier, "traceql", info)
        return True

    def check_metrics(self, now_s: int | None = None,
                      tier: str | None = None,
                      info: TraceInfo | None = None) -> bool:
        """query_range readback: count_over_time() over the probe's spans
        must equal the recomputable expected per-bin series."""
        now_s = int(now_s if now_s is not None else time.time())
        if info is None:
            info = (self._pick_tier(now_s, tier) if tier
                    else self._pick_readable(now_s, 0))
        if info is None:
            return True
        tier = tier or self.tier_of_age(now_s - info.timestamp_s)
        self._check("metrics", tier)
        step = max(1, self.cfg.metrics_step_s)
        start = info.timestamp_s - step
        end = info.timestamp_s + 2 * step  # probe spans live in [ts, ts+2)
        expected = info.expected_series(start, step)
        with tracing.span("vulture/check_metrics", tier=tier,
                          trace=info.trace_id().hex()):
            try:
                result = self.client.query_range(
                    info.metrics_query(), start, end, step)
            except Exception as e:
                return self._fail("request_failed", tier, "metrics", info, str(e))
            got: dict[int, int] = {}
            for series in result:
                for ts, v in series.get("values", []):
                    v = int(float(v))
                    if v:
                        got[int(ts)] = got.get(int(ts), 0) + v
            # Undercounts and out-of-place bins are failures; counts
            # ABOVE expected in the right bins are tolerated — under
            # replication each replica's flushed block contributes until
            # compaction dedupes, so exact equality would page on a
            # healthy RF>1 cluster (the by-id check still proves exact
            # span content; this check proves the metrics path sees
            # every span where it belongs).
            missing = {ts: n for ts, n in expected.items()
                       if got.get(ts, 0) < n}
            extra = {ts: n for ts, n in got.items() if ts not in expected}
            if missing or extra:
                # the known blocklist-poll handoff transient has a
                # distinctive signature: PURE undercount (a freshly
                # handed-off block invisible to the poll snapshot can
                # only hide spans, never invent them) on a probe young
                # enough that its block plausibly just left an ingester.
                # Typed, not excused: it still counts a vulture error,
                # but under a name SLO/RCA consumers suppress.
                age_s = now_s - info.timestamp_s
                if (missing and not extra and self.handoff_grace_s > 0
                        and age_s <= (self.cfg.recent_min_age_s
                                      + self.handoff_grace_s)):
                    return self._fail(
                        "handoff_dip", tier, "metrics", info,
                        f"undercount within handoff grace "
                        f"({self.handoff_grace_s:g}s): expected "
                        f"{expected}, got {got}")
                return self._fail(
                    "metrics_mismatch", tier, "metrics", info,
                    f"expected {expected}, got {got}")
        return True

    def measure_freshness(self, info: TraceInfo,
                          poll_s: float = 0.05) -> dict[str, float]:
        """Write->readable lag: how long after the write (assumed just
        issued) until the probe is (a) findable by ID — the ingester
        live-trace path, recorded under tier="fresh" — and (b) findable
        by search — the index path, tier="recent". Lag over the
        freshness SLO is a freshness_breach; the poll gives up at 2x
        the budget and records the cap."""
        budget = self.cfg.freshness_slo_s
        lags: dict[str, float] = {}
        t0 = time.perf_counter()

        def _poll(tier: str, visible) -> None:
            self._check("freshness", tier)
            while not self._stop.is_set():
                lag = time.perf_counter() - t0
                try:
                    if visible():
                        break
                except Exception:
                    pass  # transient while flushing; the cap bounds us
                if lag >= 2 * budget:
                    break
                time.sleep(poll_s)
            lag = time.perf_counter() - t0
            lags[tier] = lag
            vulture_freshness.observe(lag, tier=tier)
            self.freshness_lags.append((tier, lag))
            if lag > budget:
                self._fail("freshness_breach", tier, "freshness", info,
                           f"lag {lag:.3f}s over {budget:g}s budget")

        expected = info.construct_trace()
        service = expected.batches[0][0].get("service.name", "")
        req = SearchRequest(tags={"service": service},
                            start_seconds=info.timestamp_s - 60,
                            end_seconds=info.timestamp_s + 60, limit=0)
        with tracing.span("vulture/freshness", trace=info.trace_id().hex()):
            _poll("fresh", lambda: self.client.query(info.trace_id()) is not None)
            _poll("recent",
                  lambda: info.trace_id().hex() in self.client.search(req))
        return lags

    # -- composite passes -----------------------------------------------
    def run_checks_once(self, now_s: int | None = None,
                        tiers=TIERS, checks=("byid", "search", "traceql",
                                             "metrics")) -> dict:
        """One full verification pass: every requested check against the
        newest eligible probe of every tier (tiers with no eligible
        probe are skipped, not failed). Returns
        {(check, tier): True|False|None(skipped)}."""
        now_s = int(now_s if now_s is not None else time.time())
        fns = {"byid": self.check_by_id, "search": self.check_search,
               "traceql": self.check_traceql, "metrics": self.check_metrics}
        out: dict = {}
        for tier in tiers:
            info = self._pick_tier(now_s, tier)
            for check in checks:
                if info is None:
                    out[(check, tier)] = None
                    continue
                out[(check, tier)] = fns[check](now_s, tier=tier, info=info)
        return out

    def verify_written(self, now_s: int | None = None) -> dict:
        """Drain-time audit (the loadtest gate): every probe this
        instance wrote that is still inside retention must be found by
        ID with exact content, and be searchable. Returns per-class
        failure counts plus the number verified."""
        now_s = int(now_s if now_s is not None else time.time())
        before = dict(self.error_counts)
        verified = 0
        for ts in list(self.written):
            if now_s - ts > self.cfg.retention_s:
                continue
            info = TraceInfo(ts, self.cfg.tenant)
            tier = self.tier_of_age(now_s - ts)
            self.check_by_id(now_s, tier=tier, info=info)
            self.check_search(now_s, tier=tier, info=info)
            verified += 1
        delta: dict[str, int] = collections.Counter()
        for (type_, _tier), n in self.error_counts.items():
            d = n - before.get((type_, _tier), 0)
            if d:
                delta[type_] += d
        return {"verified": verified, "failures": dict(delta)}

    # -- loops -----------------------------------------------------------
    def start(self) -> None:
        c = self.cfg

        def writer():
            while not self._stop.wait(c.write_backoff_s):
                try:
                    info = self.write_once()
                except Exception as e:
                    log.warning("vulture write failed: %s", e)
                    continue
                self.measure_freshness(info)

        def reader():
            while not self._stop.wait(c.read_backoff_s):
                for tier in TIERS:
                    self.check_by_id(tier=tier)

        self._threads = [
            threading.Thread(target=writer, daemon=True, name="vulture-writer"),
            threading.Thread(target=reader, daemon=True, name="vulture-reader"),
        ]
        if c.search_backoff_s:
            def searcher():
                while not self._stop.wait(c.search_backoff_s):
                    for tier in TIERS:
                        self.check_search(tier=tier)
                        self.check_traceql(tier=tier)

            self._threads.append(
                threading.Thread(target=searcher, daemon=True,
                                 name="vulture-searcher"))
        if c.metrics_backoff_s:
            def metrics_loop():
                while not self._stop.wait(c.metrics_backoff_s):
                    for tier in TIERS:
                        self.check_metrics(tier=tier)

            self._threads.append(
                threading.Thread(target=metrics_loop, daemon=True,
                                 name="vulture-metrics"))
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads = []
