"""The port's incident plane against the JAX package's: the burn-rate SLO
engine (util/slo), the deterministic probe traces (util/traceinfo), the
in-process vulture, and the auto-RCA engine (rca/), with the routes
that serve them (/api/rca, /api/rca/{incidentID}, /status/rca,
/status/slo).

Held on the CPU, each on the same inputs in both packages:
- TraceInfo builds the same trace from the same (timestamp, tenant);
- `classify` gives the same finding on the same evidence bundle;
- the SLO engine's documents and gauges agree on the same counter
  inputs (a registered SLI source fed the same cumulative pairs), and
  its burn subscribers fire at the same transitions;
- the vulture's checks give the same verdicts and error classes on a
  port App and a JAX App fed the same probes;
- the reference's chaos campaign (a vulture probe, a sweep and two SLO
  evaluations under TEMPO_TPU_FAULTS=notfound=1.0,seed=7) opens exactly
  one incident in each App, cause `backend_fault` at tier `aged`, the
  records equal apart from ids and clocks; the fault-free arm opens
  none.

The metric registries are process-wide, and other test files of the
same worker may have moved the JAX package's vulture counters, so SLO
documents are compared by their window deltas and burns, never by the
raw cumulative counters. The RCA's breaker evidence lists every breaker
state in the package's registry, and other test files of the worker may
have left breakers there (the JAX package's overload tests), so the
campaign runs with each package's breaker-state gauge emptied (restored
after it): both then hold the breakers their Apps own. The RCA's insights
arm reads the process-wide query-insights log, where other test files of
the worker leave their slow and failed queries, so each test starts with
both packages' logs emptied.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tempo_tpu.api.server import TempoServer as JTempoServer
from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu import rca as jrca
from tempo_tpu.util import circuit as jcircuit
from tempo_tpu.util import insights as jinsights
from tempo_tpu.util import slo as jslo
from tempo_tpu.util import traceinfo as jtraceinfo
from tempo_tpu import vulture as jvulture
from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch import rca as trca
from tempo_tpu_torch.util import circuit as tcircuit
from tempo_tpu_torch.util import insights as tinsights
from tempo_tpu_torch.util import slo as tslo
from tempo_tpu_torch.util import traceinfo as ttraceinfo
from tempo_tpu_torch import vulture as tvulture

PKGS = ({"App": JApp, "AppConfig": JAppConfig, "DBConfig": JDBConfig, "rca": jrca,
         "slo": jslo, "vulture": jvulture, "Server": JTempoServer},
        {"App": App, "AppConfig": AppConfig, "DBConfig": DBConfig, "rca": trca,
         "slo": tslo, "vulture": tvulture, "Server": TempoServer})


@pytest.fixture(autouse=True)
def _empty_insights():
    for log in (jinsights.LOG, tinsights.LOG):
        log.clear()


def _spans(trace) -> list:
    return sorted(
        (s.trace_id, s.span_id, s.parent_span_id, s.name, s.kind, s.start_unix_nano,
         s.end_unix_nano, s.status_code, sorted(s.attributes.items()))
        for s in trace.all_spans())


# ---------------------------------------------------------------------------
# TraceInfo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ts,tenant", [(1_700_000_000, "single-tenant"), (1_700_007_210, "t2"),
                                       (1_699_999_990, "a-very-long-tenant-name"), (10, "x")])
def test_traceinfo_builds_the_same_trace(ts, tenant):
    j, t = jtraceinfo.TraceInfo(ts, tenant), ttraceinfo.TraceInfo(ts, tenant)
    assert t.seed == j.seed and t.trace_id() == j.trace_id()
    jt, tt = j.construct_trace(), t.construct_trace()
    assert tt.trace_id == jt.trace_id
    assert [sorted(r.items()) for r, _ in tt.batches] == [sorted(r.items()) for r, _ in jt.batches]
    assert _spans(tt) == _spans(jt)
    assert t.traceql_query() == j.traceql_query() and t.metrics_query() == j.metrics_query()
    assert t.expected_series(ts - 5, 5) == j.expected_series(ts - 5, 5)
    assert t.span_count() == j.span_count() > 0
    for now in (ts, ts + 9, ts + 60, ts + 7200):
        assert t.ready(now, 10, 60) == j.ready(now, 10, 60)


# ---------------------------------------------------------------------------
# classify
# ---------------------------------------------------------------------------


def _bundles() -> list[dict]:
    fixed = [
        {},
        {"vultureErrors": [{"type": "handoff_dip", "tier": "fresh", "count": 3}]},
        {"vultureErrors": [{"type": "handoff_dip", "tier": "fresh", "count": 1},
                           {"type": "request_failed", "tier": "aged", "count": 5}],
         "breakers": {"query-backend": {"state": 2, "stateName": "open"}}},
        {"quarantine": {"t": {"b1": "CorruptPage: x"}}},
        {"governor": {"level": 1, "levelName": "pressure", "shedDelta": 3.0}},
        {"governor": {"level": 0, "shedDelta": 0},
         "suspects": [{"edge": "a->b", "client": "a", "server": "b", "edgeVisits": 9},
                      {"edge": "a->c", "client": "a", "server": "c", "edgeVisits": 2}]},
        {"suspects": [{"edge": "a->b", "client": "a", "server": "b", "edgeVisits": 3},
                      {"edge": "a->c", "client": "a", "server": "c", "edgeVisits": 3}],
         "stageSeconds": {"fetch": 2.5, "decode": 2.5, "merge": 0.1}},
        {"criticalPath": [{"key": "db.query", "seconds": 3.0}]},
        {"trigger": {"service": "cart"},
         "vultureErrors": [{"type": "metrics_mismatch", "tier": "recent", "count": 1},
                           {"type": "notfound_byid", "tier": "aged", "count": 1}]},
    ]
    rng = np.random.default_rng(11)
    types = ("handoff_dip", "request_failed", "notfound_byid", "metrics_mismatch",
             "freshness_breach", "missing_spans")
    tiers = ("fresh", "recent", "aged")
    for _ in range(60):
        b: dict = {}
        if rng.random() < 0.6:
            b["vultureErrors"] = [{"type": str(rng.choice(types)), "tier": str(rng.choice(tiers)),
                                   "count": float(rng.integers(0, 4))}
                                  for _ in range(int(rng.integers(1, 4)))]
        if rng.random() < 0.3:
            b["breakers"] = {"q": {"state": int(rng.integers(0, 3))}}
        if rng.random() < 0.3:
            b["governor"] = {"level": int(rng.integers(0, 3)),
                             "shedDelta": float(rng.integers(0, 2))}
        if rng.random() < 0.4:
            b["suspects"] = [{"edge": f"s{i}->x", "client": f"s{i}", "server": "x",
                              "edgeVisits": int(rng.integers(0, 8))} for i in range(2)]
        if rng.random() < 0.4:
            b["stageSeconds"] = {s: float(rng.random()) for s in ("fetch", "scan", "merge")}
        fixed.append(b)
    return fixed


def test_classify_same_finding_on_the_same_evidence():
    assert trca.CAUSES == jrca.CAUSES
    causes = set()
    for b in _bundles():
        f = trca.classify(json.loads(json.dumps(b)))
        assert f == jrca.classify(json.loads(json.dumps(b))), b
        causes.add(f["cause"])
    assert causes == set(trca.CAUSES)


# ---------------------------------------------------------------------------
# SLO engine
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_sli():
    cells = ({"good": 0.0, "total": 0.0}, {"good": 0.0, "total": 0.0})
    for pkg, cell in zip(PKGS, cells):
        pkg["slo"].register_sli_source("parity-fake-sli", lambda obj, c=cell: (c["good"], c["total"]))
    yield cells
    for pkg in PKGS:
        del pkg["slo"].SLI_SOURCES["parity-fake-sli"]


def _gauges(slo_mod, name: str) -> dict:
    out = {}
    for gauge in (slo_mod.slo_burn_rate, slo_mod.slo_budget_remaining, slo_mod.slo_events,
                  slo_mod.slo_good_events, slo_mod.slo_burning):
        with gauge._lock:
            out[gauge.name] = sorted((k, v) for k, v in gauge._values.items()
                                     if dict(k).get("slo") == name)
    return out


def test_slo_documents_and_gauges_agree(fake_sli):
    """The same cumulative (good, total) samples, counter resets and
    dips included, give the same documents, gauges and burn events."""
    engines, events = [], ([], [])
    for pkg, ev in zip(PKGS, events):
        cfg = pkg["slo"].SLOConfig(enabled=True, eval_interval_s=1.0, objectives=[
            pkg["slo"].SLOObjective("parity", "parity-fake-sli", 0.99),
            pkg["slo"].SLOObjective("parity-missing", "no-such-sli", 0.999)])
        eng = pkg["slo"].SLOEngine(cfg)
        eng.subscribe(ev.append)
        engines.append(eng)
    rng = np.random.default_rng(4)
    good = total = 0.0
    for step in range(40):
        now = 1_000_000.0 + 150.0 * step
        if step == 25:  # a counter reset (a restarted component)
            good = total = 0.0
        n = float(rng.integers(0, 200))
        bad = float(rng.integers(0, 30)) if step % 7 in (3, 4) else float(rng.integers(0, 2))
        if 30 <= step < 37:  # an outage: a fast burn pages
            bad = n
        total += n
        good += max(0.0, n - bad)
        if step == 12:  # good read after a failing check: a transient dip
            good -= 1.0
        docs = []
        for eng, cell in zip(engines, fake_sli):
            cell.update(good=good, total=total)
            docs.append(eng.evaluate(now=now))
        assert docs[1] == docs[0], step
        assert _gauges(tslo, "parity") == _gauges(jslo, "parity")
    assert events[1] == events[0] and events[1]
    assert engines[1].burning("parity") == engines[0].burning("parity")


def test_slo_windows_and_status(fake_sli):
    docs = []
    for pkg, eng_cell in zip(PKGS, fake_sli):
        eng = pkg["slo"].SLOEngine(pkg["slo"].SLOConfig(objectives=[
            pkg["slo"].SLOObjective("parity", "parity-fake-sli", 0.99)]))
        for now, (g, t) in ((0.0, (100, 100)), (3600.0, (150, 200)), (6900.0, (250, 300)),
                            (7200.0, (255, 310))):
            eng_cell.update(good=float(g), total=float(t))
            doc = eng.evaluate(now=now)
        docs.append(doc)
        assert eng.status()["evaluatedAt"] == 7200.0  # fresh enough: cached
    w = docs[1]["objectives"][0]["windows"]
    assert docs[1] == docs[0]
    assert (w["5m"]["totalDelta"], w["1h"]["totalDelta"], w["6h"]["totalDelta"]) == (10.0, 110.0, 210.0)


def test_default_objectives_and_sources_equal():
    assert [vars(o) for o in tslo.default_objectives()] == \
        [vars(o) for o in jslo.default_objectives()]
    assert sorted(tslo.SLI_SOURCES) == sorted(jslo.SLI_SOURCES)
    assert (tslo.WINDOWS, tslo.FAST_WINDOWS, tslo.SLOW_WINDOWS, tslo.WRITE_ROUTES,
            tslo.READ_ROUTES) == (jslo.WINDOWS, jslo.FAST_WINDOWS, jslo.SLOW_WINDOWS,
                                  jslo.WRITE_ROUTES, jslo.READ_ROUTES)


def test_vulture_sli_ignores_the_handoff_dip():
    for slo_mod, vmod in ((jslo, jvulture), (tslo, tvulture)):
        obj = slo_mod.SLOObjective("vulture-read", "vulture")
        g0, t0 = slo_mod._sli_vulture(obj)
        vmod.vulture_checks.inc(check="metrics", tier="fresh")
        vmod.vulture_errors.inc(type="handoff_dip", tier="fresh")
        g1, t1 = slo_mod._sli_vulture(obj)
        vmod.vulture_checks.inc(check="metrics", tier="fresh")
        vmod.vulture_errors.inc(type="request_failed", tier="fresh")
        g2, t2 = slo_mod._sli_vulture(obj)
        assert (t1 - t0, g1 - g0, t2 - t1, g2 - g1) == (1.0, 1.0, 1.0, 0.0)


# ---------------------------------------------------------------------------
# Apps: the vulture, the chaos campaign, the routes
# ---------------------------------------------------------------------------


def _app(pkg, root, **kw):
    db = pkg["DBConfig"](backend="local", backend_path=str(root / "blocks"),
                         wal_path=str(root / "wal"), analytics_scan_s=0)
    if pkg["App"] is JApp:
        db.compaction_device_shards = 1
        return JApp(JAppConfig(db=db, generator_enabled=False, **kw))
    return App(AppConfig(db=db, generator_enabled=False, **kw), device="cpu")


def _slo_cfg(pkg):
    return pkg["slo"].SLOConfig(enabled=True, eval_interval_s=3600, objectives=[
        pkg["slo"].SLOObjective("vulture-read", "vulture", 0.999)])


def _drive(pkg, app, t0: float, now: int):
    """The reference campaign: one SLO evaluation, an aged-tier probe
    written and swept into a block, its metrics read back, and a second
    evaluation a minute later. Returns the check's verdict."""
    vmod = pkg["vulture"]
    app.slo_engine.evaluate(now=t0)
    v = vmod.Vulture(vmod.InProcessClient(app), write_backoff_s=10)
    info = v.write_once(now - 7200)
    app.sweep_all(immediate=True)
    try:
        app.db.poll_now()
    except Exception:  # noqa: BLE001 — a faulted poll is part of the campaign
        pass
    ok = v.check_metrics(now, tier="aged", info=info)
    app.slo_engine.evaluate(now=t0 + 60)
    return ok, dict(v.error_counts), dict(v.check_counts)


_CLOCKS = ("id", "openedAt", "attributionSeconds", "at", "evaluatedAt", "enqueuedWall", "ts",
           "window", "elapsedMs", "insights", "usageDelta", "cumulative")


def _norm(doc):
    """An RCA or SLO document without ids and clocks (and without the
    insight records and usage deltas, whose byte counts differ between
    the two packages' DB stacks, and the SLO's cumulative counters, which
    earlier tests of the worker moved in one package's registry)."""
    if isinstance(doc, dict):
        return {k: _norm(v) for k, v in doc.items() if k not in _CLOCKS}
    if isinstance(doc, list):
        return [_norm(v) for v in doc]
    return doc


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("faults", [True, False], ids=["notfound", "fault-free"])
def test_chaos_campaign_opens_the_same_incident(tmp_path, monkeypatch, faults):
    if faults:
        monkeypatch.setenv("TEMPO_TPU_FAULTS", "notfound=1.0,seed=7")
    for circuit in (jcircuit, tcircuit):
        monkeypatch.setattr(circuit.state_gauge, "_values", {})
    apps, servers = [], []
    try:
        for i, pkg in enumerate(PKGS):
            app = _app(pkg, tmp_path / f"a{i}", slo=_slo_cfg(pkg),
                       rca=pkg["rca"].RCAConfig(enabled=True),
                       vulture=pkg["vulture"].VultureConfig(enabled=True))
            apps.append(app)
            servers.append(pkg["Server"](app).start())
        assert isinstance(apps[1].vulture, tvulture.Vulture)
        t0, now = time.time(), int(time.time())
        drives = [_drive(pkg, app, t0, now) for pkg, app in zip(PKGS, apps)]
        assert drives[1] == drives[0]
        assert drives[1][0] is (not faults)
        incidents = []
        for app in apps:
            if not faults:
                assert app.rca._queue.qsize() == 0 and app.rca_list() == []
                assert app.rca.status() == {"incidents": 0, "suppressed": 0, "queue": 0}
                continue
            assert app.rca._queue.qsize() == 1
            event = app.rca._queue.get_nowait()
            assert (event["kind"], event["slo"]) == ("slo_burn", "vulture-read")
            incidents.append(app.rca.process_trigger(event))
        if faults:
            f = incidents[1]["finding"]
            assert (f["cause"], f["tier"], f["suppressed"]) == ("backend_fault", "aged", False)
            assert "vulture backend-path error" in f["details"]
            assert _norm(incidents[1]) == _norm(incidents[0])
        # the routes on both servers, equal apart from ids and clocks
        for path in ("/api/rca", "/status/rca", "/status/slo"):
            (js, jdoc), (ts, tdoc) = (_get(s.url, path) for s in servers)
            assert js == ts == 200 and _norm(tdoc) == _norm(jdoc), path
        if faults:
            for inc, srv in zip(incidents, servers):
                status, doc = _get(srv.url, "/api/rca/" + inc["id"])
                assert status == 200 and doc["id"] == inc["id"]
            docs = [_get(s.url, "/api/rca/" + inc["id"])[1] for s, inc in zip(servers, incidents)]
            assert _norm(docs[1]) == _norm(docs[0])
            assert _get(servers[1].url, "/api/rca/" + incidents[1]["id"] + "/x")[0] == 404
        assert _get(servers[1].url, "/api/rca/inc-000000000000")[0] == 404
        states = [app.service_states() for app in apps]
        assert {k for k in states[1] if k in ("vulture", "slo_engine", "rca")} == \
            {"vulture", "slo_engine", "rca"}
    finally:
        for s in servers:
            s.stop()
        for app in apps:
            app.shutdown()


def test_disabled_surfaces_equal(tmp_path):
    apps, servers = [], []
    try:
        for i, pkg in enumerate(PKGS):
            apps.append(_app(pkg, tmp_path / f"a{i}"))
            servers.append(pkg["Server"](apps[-1]).start())
        assert apps[1].vulture is apps[1].slo_engine is apps[1].rca is None
        for path in ("/api/rca", "/status/rca", "/status/slo", "/api/rca/inc-1"):
            (js, jdoc), (ts, tdoc) = (_get(s.url, path) for s in servers)
            assert (js, jdoc) == (ts, tdoc), path
        endpoints = [_get(s.url, "/status/endpoints")[1] for s in servers]
        for route in ("GET /api/rca", "GET /api/rca/{incidentID}", "GET /status/rca",
                      "GET /status/slo"):
            assert route in json.dumps(endpoints[1])
    finally:
        for s in servers:
            s.stop()
        for app in apps:
            app.shutdown()


def test_vulture_checks_agree(tmp_path):
    """A fresh probe read back by ID, search, TraceQL and query_range on
    both Apps: the same verdicts; a probe never written fails the same
    way on both."""
    apps = [_app(pkg, tmp_path / f"a{i}") for i, pkg in enumerate(PKGS)]
    try:
        now = int(time.time())
        now -= now % 10
        results = []
        for pkg, app in zip(PKGS, apps):
            vmod = pkg["vulture"]
            v = vmod.Vulture(vmod.InProcessClient(app),
                             cfg=vmod.VultureConfig(write_backoff_s=10, read_backoff_s=10))
            info = v.write_once(now - 30)
            res = v.run_checks_once(now, tiers=("fresh",))
            ghost = type(info)(now - 20, info.tenant)
            missing = (v.check_by_id(now, tier="fresh", info=ghost),
                       v.check_search(now, tier="fresh", info=ghost))
            app.sweep_all(immediate=True)
            app.db.poll_now()
            after = v.run_checks_once(now, tiers=("fresh",))
            audit = v.verify_written(now)
            results.append((res, missing, after, audit, dict(v.error_counts),
                            v.tier_windows(), v.tier_of_age(4000)))
        assert results[1] == results[0]
        assert all(results[1][0].values()) and results[1][1] == (False, False)
    finally:
        for app in apps:
            app.shutdown()


def test_rca_triggers_cooldown_and_tenant_scope(tmp_path):
    apps = [_app(pkg, tmp_path / f"a{i}", rca=pkg["rca"].RCAConfig(enabled=True, cooldown_s=300))
            for i, pkg in enumerate(PKGS)]
    try:
        sizes = []
        for app in apps:
            app.rca.on_slo_burn({"kind": "slo_burn", "slo": "x", "at": 1000.0})
            app.rca.on_slo_burn({"kind": "slo_burn", "slo": "x", "at": 1010.0})
            app.rca.on_slo_burn({"kind": "slo_burn", "slo": "y", "at": 1010.0})
            app.rca.on_deviation({"kind": "standing_deviation", "queryId": "sq-1",
                                  "tenant": "other", "series": 'resource.service.name="cart"',
                                  "at": 1020.0})
            app.rca.on_slo_burn({"kind": "slo_burn", "slo": "x", "at": 1400.0})
            sizes.append(app.rca._queue.qsize())
            while app.rca._queue.qsize():
                app.rca.process_trigger(app.rca._queue.get_nowait())
        assert sizes == [4, 4]
        lists = [[_norm(i) for i in app.rca_list()] for app in apps]
        assert lists[1] == lists[0] and len(lists[1]) == 3  # "other"'s is not visible
        dev = [i for i in apps[1].rca._incidents if i["trigger"]["kind"] == "standing_deviation"]
        assert dev[0]["trigger"]["service"] == "cart"
        with pytest.raises(trca.UnknownIncident):
            apps[1].rca_get(dev[0]["id"])
    finally:
        for app in apps:
            app.shutdown()
