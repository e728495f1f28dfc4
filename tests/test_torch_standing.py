"""The port's standing-query engine against the JAX package's.

Each class of tests/test_standing.py that covers the engine runs here on
both packages: their App(target=all) side by side over their own local
backends (the port with device="cpu", its fold on the host arm, as the
reference's off a TPU), fed the same seeded synth traces stamped
minutes before now, cut and flushed at the same points. At every point
the port's standing read equals the JAX package's and both equal
`query_range` over the same start, end and step; registration, state
and HTTP documents compare field for field without the wall-clock and
random fields (`id`, `createdUnix`, `foldSeconds`). Tolerance is exact:
every count is an integer sum.

The data sits 5-10 minutes before now inside a 60-minute window, so a
minute that rolls between the two packages' calls moves no prune floor.
The alert and deviation tests read the latest complete bin, so they
start early in a minute (`_settle`).

The step-partial counters of standing/rules.py
(`tempo_tpu_standing_partial_row_groups_read_total`,
`..._partial_pages_written_total`) move by the same amounts in both
registries. One `cuda` test holds the card's fold arm (`seg_bincount`)
to the host arm's counts.
"""

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from tempo_tpu.api.server import TempoServer as JTempoServer
from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.config import check_config as jcheck_config, parse_config as jparse_config
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu.encoding.vtpu import block as jblock
from tempo_tpu.model import synth as jsynth
from tempo_tpu.modules.overrides import Limits as JLimits
from tempo_tpu.standing import StandingConfig as JStandingConfig
from tempo_tpu.standing import StandingEngine as JStandingEngine
from tempo_tpu.standing import UnknownStandingQuery as JUnknown
from tempo_tpu.standing import engine as jengine
from tempo_tpu.standing import rules as jrules
from tempo_tpu.traceql import ParseError as JParseError
from tempo_tpu.util import resource as jresource
from tempo_tpu.util import usage as jusage
from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.config import check_config, parse_config
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.encoding.vtpu import block as tblock
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.modules.overrides import Limits
from tempo_tpu_torch.ops import pallas_kernels as pk
from tempo_tpu_torch.standing import StandingConfig, StandingEngine, UnknownStandingQuery
from tempo_tpu_torch.standing import engine as tengine
from tempo_tpu_torch.standing import rules as trules
from tempo_tpu_torch.traceql import ParseError
from tempo_tpu_torch.util import resource, usage
from tempo_tpu_torch.util.devicetiming import STATS

RATE_Q = "{} | rate() by (resource.service.name)"
HIST_Q = "{} | histogram_over_time(duration)"
TENANT = "single-tenant"


def _aligned_base(step: int = 60, ago_s: int = 600) -> int:
    return (int(time.time()) // step) * step - ago_s


def _settle(margin_s: float = 15.0) -> None:
    """Start early in a minute: tests that read the latest complete bin
    must not see it move between the two packages' calls."""
    left = 60 - time.time() % 60
    if left < margin_s:
        time.sleep(left + 0.05)


def _vals(mat: dict):
    """Canonical (metric, samples) set of a Prometheus matrix."""
    return sorted(
        (tuple(sorted(r["metric"].items())), tuple(map(tuple, r["values"])))
        for r in mat["result"]
    )


def _reg_doc(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in ("id", "createdUnix")}


def _state_doc(doc: dict) -> dict:
    doc = {k: v for k, v in doc.items() if k != "id"}
    doc["stats"] = {k: v for k, v in doc["stats"].items() if k != "foldSeconds"}
    return doc


def _cut_all(app, immediate=True):
    for ing in app.ingesters.values():
        for inst in list(ing.instances.values()):
            inst.cut_complete_traces(immediate=immediate)


def _flush_all(app):
    for ing in app.ingesters.values():
        for inst in list(ing.instances.values()):
            inst.cut_block_if_ready(immediate=True)
            inst.complete_and_flush()


def _crash(app):
    """Stop without the final flush: the WAL and the standing snapshot
    stay on disk as a killed process leaves them."""
    for stop in app._heartbeat_stops:
        stop.set()
    for ing in app.ingesters.values():
        ing.stop(flush=False)
    app.workers.stop()
    app.compactor.stop()
    app.db.shutdown()


class Pair:
    """The JAX package's App and the port's, over root/jax and root/port."""

    def __init__(self, root, standing=None, limits=None, **kw):
        self.root, self.standing, self.limits, self.kw = root, standing or {}, limits or {}, kw
        self.j = self.t = None
        self.open()

    def open(self, jax_root=None, port_root=None):
        jr = str(jax_root or self.root / "jax")
        tr = str(port_root or self.root / "port")
        # one device on the JAX side (its tests run an 8-device CPU mesh;
        # the port's CPU App sees one device), analytics off
        self.j = JApp(JAppConfig(
            db=JDBConfig(backend="local", backend_path=jr + "/blocks", wal_path=jr + "/wal",
                         compaction_device_shards=1, analytics_scan_s=0),
            standing=JStandingConfig(**self.standing),
            limits=JLimits(**self.limits), **self.kw))
        self.t = App(AppConfig(
            db=DBConfig(backend="local", backend_path=tr + "/blocks", wal_path=tr + "/wal",
                        compaction_device_shards=1),
            standing=StandingConfig(**self.standing), limits=Limits(**self.limits),
            **self.kw), device="cpu")

    @property
    def apps(self):
        return self.j, self.t

    def close(self):
        for app in self.apps:
            if app is not None:
                app.shutdown()
        self.j = self.t = None

    def crash(self):
        for app in self.apps:
            _crash(app)
        self.j = self.t = None

    def push(self, n, seed, spans, base_s, org=None):
        self.j.push_traces(jsynth.make_traces(n, seed=seed, spans_per_trace=spans,
                                              base_time_ns=base_s * 10**9), org_id=org)
        self.t.push_traces(synth.make_traces(n, seed=seed, spans_per_trace=spans,
                                             base_time_ns=base_s * 10**9), org_id=org)

    def cut(self):
        for app in self.apps:
            _cut_all(app)

    def flush(self, poll=True):
        for app in self.apps:
            _flush_all(app)
            if poll:
                app.db.poll_now()

    def register(self, body, org=None):
        """Register on both; the documents equal but for id and time."""
        j, t = (app.standing_register(dict(body), org_id=org) for app in self.apps)
        assert _reg_doc(j) == _reg_doc(t)
        assert t["id"].startswith("sq-")
        return j["id"], t["id"]

    def read(self, ids, start, end, org=None, step=0):
        mats = [app.standing_read(qid, org_id=org, start_s=start, end_s=end, step_s=step)
                for app, qid in zip(self.apps, ids)]
        assert _vals(mats[0]) == _vals(mats[1])
        assert mats[0]["stats"].get("degraded") == mats[1]["stats"].get("degraded")
        return _vals(mats[1])

    def query_range(self, q, start, end, step=60, org=None):
        j, t = (_vals(app.query_range(q, start, end, step, org_id=org)) for app in self.apps)
        assert j == t
        return t

    def state(self, ids, org=None):
        j, t = (app.standing_state(qid, org_id=org) for app, qid in zip(self.apps, ids))
        assert _state_doc(j) == _state_doc(t)
        return t

    def check(self, ids, q, start, end, org=None):
        """Standing reads equal on both packages and equal query_range."""
        got = self.read(ids, start, end, org=org)
        assert got == self.query_range(q, start, end, org=org)
        return got


@pytest.fixture
def make_pair(tmp_path):
    pairs = []

    def make(**kw):
        p = Pair(tmp_path / f"p{len(pairs)}", **kw)
        pairs.append(p)
        return p

    yield make
    for p in pairs:
        p.close()


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


class TestRegistration:
    def test_register_list_delete(self, make_pair):
        pair = make_pair()
        ids = pair.register({"q": RATE_Q, "step": 60})
        j, t = (app.standing_list() for app in pair.apps)
        assert [_reg_doc(d) for d in j] == [_reg_doc(d) for d in t]
        assert [d["id"] for d in t] == [ids[1]]
        assert t[0]["window"] == pair.t.cfg.standing.default_window_s == 3600
        for app, qid in zip(pair.apps, ids):
            app.standing_delete(qid)
        assert pair.j.standing_list() == pair.t.standing_list() == []

    @pytest.mark.parametrize("body,errors", [
        ({"q": "{ nonsense ===", "step": 60}, (JParseError, ParseError)),
        ({"q": "{}", "step": 60}, (JParseError, ParseError)),  # not a metrics pipeline
        ({"q": RATE_Q, "step": 0}, (ValueError, ValueError)),
        ({"q": RATE_Q, "step": 60, "window": 31 * 86400}, (ValueError, ValueError)),
        ({"q": RATE_Q, "step": 60, "alert": {"op": ">=", "value": 1}}, (ValueError, ValueError)),
        ({"q": RATE_Q, "step": 60, "window": 600, "deviation": {"season": 600}},
         (ValueError, ValueError)),
        ({"q": RATE_Q, "step": 60, "deviation": {"season": 90}}, (ValueError, ValueError)),
    ], ids=["parse", "not-metrics", "step-0", "window-over-max", "alert-op",
            "deviation-window", "deviation-season"])
    def test_bad_registration_is_client_error(self, make_pair, body, errors):
        pair = make_pair()
        msgs = []
        for app, err in zip(pair.apps, errors):
            with pytest.raises(err) as e:
                app.standing_register(body)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert pair.t.standing_list() == []

    def test_per_tenant_cap(self, make_pair):
        pair = make_pair(standing={"max_queries_per_tenant": 2})
        pair.register({"q": RATE_Q, "step": 60})
        pair.register({"q": HIST_Q, "step": 60})
        msgs = []
        for app, err in zip(pair.apps, (jresource.ResourceExhausted, resource.ResourceExhausted)):
            with pytest.raises(err) as e:
                app.standing_register({"q": RATE_Q, "step": 30})
            msgs.append((str(e.value), e.value.retry_after_s))
        assert msgs[0] == msgs[1]

    def test_limits_override_wins(self):
        engines = (JStandingEngine(JStandingConfig(max_queries_per_tenant=1)),
                   StandingEngine(StandingConfig(max_queries_per_tenant=1), device="cpu"))
        for eng, limits in zip(engines, (JLimits, Limits)):
            class Ov:
                def for_tenant(self, t, limits=limits):
                    return limits(max_standing_queries=3)

            eng.overrides = Ov()
            for _ in range(3):
                eng.register("t", RATE_Q, 60)
        for eng, err in zip(engines, (jresource.ResourceExhausted, resource.ResourceExhausted)):
            with pytest.raises(err):
                eng.register("t", RATE_Q, 60)
        assert [_reg_doc(d) for d in engines[0].list("t")] == \
            [_reg_doc(d) for d in engines[1].list("t")]

    def test_tenant_isolation(self, make_pair):
        pair = make_pair(multitenancy_enabled=True)
        ids = pair.register({"q": RATE_Q, "step": 60}, org="a")
        assert pair.j.standing_list(org_id="b") == pair.t.standing_list(org_id="b") == []
        for app, qid, err in zip(pair.apps, ids, (JUnknown, UnknownStandingQuery)):
            with pytest.raises(err):
                app.standing_state(qid, org_id="b")
            with pytest.raises(err):
                app.standing_read(qid, org_id="b")
            with pytest.raises(err):
                app.standing_delete(qid, org_id="b")
        base = _aligned_base()
        pair.push(6, 7, 3, base, org="a")
        pair.push(6, 8, 3, base, org="b")
        pair.cut()
        got = pair.check(ids, RATE_Q, base - 60, base + 120, org="a")
        assert got and got != pair.query_range(RATE_Q, base - 60, base + 120, org="b")


# ---------------------------------------------------------------------------
# fold exactness
# ---------------------------------------------------------------------------


class TestFoldExactness:
    """At every cut boundary the standing read equals a from-scratch
    query_range over the same window, on both packages."""

    @pytest.mark.parametrize("n_ingesters", [1, 2, 4])
    def test_matches_query_range_across_cut_boundaries(self, make_pair, n_ingesters):
        pair = make_pair(n_ingesters=n_ingesters)
        base = _aligned_base()
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        start, end = base - 60, base + 240
        for wave in range(3):
            pair.push(8, 100 + wave, 4, base + wave * 60)
            # boundary 1: pre-cut (tail-only for this wave)
            pair.check(ids, RATE_Q, start, end)
            pair.cut()
            # boundary 2: post-cut (the accumulator holds the delta)
            pair.check(ids, RATE_Q, start, end)
            pair.flush()
            # boundary 3: post-flush+poll
            got = pair.check(ids, RATE_Q, start, end)
        assert len(got) > 1
        pair.state(ids)

    def test_histogram_query_folds(self, make_pair):
        pair = make_pair()
        base = _aligned_base()
        ids = pair.register({"q": HIST_Q, "step": 60, "window": 3600})
        pair.push(6, 9, 5, base)
        pair.cut()
        assert pair.check(ids, HIST_Q, base - 60, base + 120)
        pair.state(ids)

    @pytest.mark.parametrize("q", [
        "{ status = error } | count_over_time() by (name)",
        "{ } | quantile_over_time(duration, 0.5, 0.99) by (resource.service.name)",
        '{ resource.service.name = "cart" } | rate()',
    ], ids=["count-by-name", "quantile-by-service", "rate-of-one-service"])
    def test_more_queries_fold(self, make_pair, q):
        pair = make_pair()
        base = _aligned_base()
        ids = pair.register({"q": q, "step": 60, "window": 3600})
        for wave in range(2):
            pair.push(10, 40 + wave, 4, base + 60 * wave)
            pair.cut()
            pair.check(ids, q, base - 60, base + 180)
        pair.flush()
        pair.check(ids, q, base - 60, base + 180)
        # a coarser read step, a multiple of the standing step
        assert pair.read(ids, base - 60, base + 180, step=120) == \
            pair.query_range(q, base - 60, base + 180, step=120)

    def test_crash_restart_rebuild(self, make_pair):
        pair = make_pair()
        base = _aligned_base()
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        pair.push(12, 3, 4, base)
        pair.cut()
        # flush SOME data to the backend, keep some in the WAL, then
        # "crash": the snapshot (registration) and the WAL dirs survive
        pair.flush(poll=False)
        pair.push(5, 4, 4, base + 60)
        pair.cut()  # the second wave stays WAL-only
        for app in pair.apps:
            app.standing.snapshot()
        start, end = base - 60, base + 180
        expect = pair.query_range(RATE_Q, start, end)
        before = pair.read(ids, start, end)
        assert before == expect
        pair.crash()
        pair.open()
        assert pair.read(ids, start, end) == expect
        st = pair.state(ids)
        assert st["stats"]["rebuilds"] >= 1 and not st["stats"]["dirty"]

    def test_replayed_wal_segment_not_double_folded(self, make_pair):
        """A cut whose fold lands after a rebuild replayed its WAL
        segment is dropped (the rebuilt_segs dedupe)."""
        pair = make_pair()
        base = _aligned_base()
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        pair.push(6, 21, 3, base)
        pair.cut()
        keys = []
        for app, qid in zip(pair.apps, ids):
            q = app.standing.get(TENANT, qid)
            app.standing.rebuild(q)
            assert q.rebuilt_segs, "rebuild saw no WAL segments"
            keys.append(next(iter(q.rebuilt_segs)))
        before = pair.read(ids, base - 60, base + 120)
        for app, key in zip(pair.apps, keys):
            batch = app.ingesters["ingester-0"].standing_wal_batches(TENANT)[0][1]
            app.standing.fold(TENANT, batch, seg_key=key)
        assert pair.read(ids, base - 60, base + 120) == before
        assert [k.split(":")[1] for k in keys] == ["0", "0"]

    def test_registration_backfills_preexisting_data(self, make_pair):
        """A query registered over a store that already holds the window
        serves it (the first read rebuilds), not zeros."""
        pair = make_pair()
        base = _aligned_base()
        pair.push(8, 87, 4, base)
        for app in pair.apps:
            app.sweep_all(immediate=True)
            app.db.poll_now()
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        got = pair.check(ids, RATE_Q, base - 60, base + 120)
        assert any(float(v) > 0 for _, values in got for _, v in values)
        st = pair.state(ids)
        assert st["stats"]["rebuilds"] == 1 and st["stats"]["partialRowGroups"] > 0

    def test_wal_seg_keys_survive_corrupt_segment(self, make_pair):
        """Fold keys are on-disk segment numbers; a corrupt earlier
        segment does not shift later segments onto other keys."""
        pair = make_pair()
        base = _aligned_base()
        pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        for wave in range(2):
            pair.push(3, 90 + wave, 3, base)
            pair.cut()
        for app in pair.apps:
            inst = app.ingesters["ingester-0"].instance(TENANT)
            segs = sorted(f for f in os.listdir(inst.head.path) if f.endswith(".seg"))
            assert len(segs) == 2
            with open(os.path.join(inst.head.path, segs[0]), "wb") as f:
                f.write(b"garbage")
            keyed = app.ingesters["ingester-0"].standing_wal_batches(TENANT)
            assert [k for k, _ in keyed] == [f"{inst.head.block_id}:1"]


# ---------------------------------------------------------------------------
# the handoff dip
# ---------------------------------------------------------------------------


def test_standing_read_immune_to_blocklist_gap(make_pair):
    """After an ingester hands a block off, query_range misses its spans
    until the next blocklist poll; the standing accumulator holds them."""
    pair = make_pair()
    base = _aligned_base()
    ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
    pair.read(ids, 0, 0)  # clears the registration's backfill
    pair.push(10, 13, 4, base)
    pair.cut()
    start, end = base - 60, base + 120
    expect = pair.query_range(RATE_Q, start, end)
    pair.flush(poll=False)
    for app in pair.apps:
        app.db.blocklist.apply_poll_results({}, {})  # the poll gap
    assert pair.query_range(RATE_Q, start, end) != expect, "no poll gap opened"
    assert pair.read(ids, start, end) == expect, "standing read dipped during handoff"
    for app in pair.apps:
        app.db.poll_now()
    assert pair.query_range(RATE_Q, start, end) == expect


# ---------------------------------------------------------------------------
# governor and usage
# ---------------------------------------------------------------------------


class TestGovernorAndUsage:
    def test_fold_sheds_at_pressure_and_rebuild_heals(self, make_pair):
        pair = make_pair()
        base = _aligned_base()
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        govs = []
        for app, mod in zip(pair.apps, (jresource, resource)):
            gov = app.standing.governor = mod.ResourceGovernor(mod.ResourceConfig())
            gov.pool("live_traces").limit = 100
            gov.pool("live_traces").add(95)  # over the soft watermark
            assert gov.level() >= mod.LEVEL_PRESSURE
            govs.append(gov)
        pair.push(6, 31, 3, base)
        pair.cut()
        st = pair.state(ids)["stats"]
        assert (st["sheds"], st["folds"], st["dirty"]) == (1, 0, True)
        for gov in govs:
            gov.pool("live_traces").sub(95)
        # pressure clears: the next read rebuilds exactly
        pair.check(ids, RATE_Q, base - 60, base + 120)
        assert not pair.state(ids)["stats"]["dirty"]

    def test_usage_metered_under_kind_standing(self, make_pair):
        pair = make_pair()
        base = _aligned_base()
        pair.register({"q": RATE_Q, "step": 60, "window": 3600})

        def charged():
            return [acc.snapshot(TENANT).get(TENANT, {}).get("standing", {})
                    .get("inspected_bytes", 0) for acc in (jusage.ACCOUNTANT, usage.ACCOUNTANT)]

        before = charged()
        pair.push(6, 33, 3, base)
        pair.cut()
        deltas = [a - b for a, b in zip(charged(), before)]
        assert deltas[0] == deltas[1] > 0

    def test_fold_spans_equals_cut_delta(self, make_pair):
        pair = make_pair()
        base = _aligned_base()
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        for wave in range(3):
            pair.push(4, 50 + wave, 3, base)
            pair.cut()
        st = pair.state(ids)["stats"]
        cuts = [app.standing.cut_spans[TENANT] for app in pair.apps]
        assert cuts[0] == cuts[1] == st["spansFolded"] + st["spansShed"] == 36

    def test_fold_usage_charged_once_per_cut(self, make_pair):
        """The inspected-bytes counter tracks the cut, not cut x
        registered queries."""
        pair = make_pair()
        base = _aligned_base()
        for q in (RATE_Q, HIST_Q, "{} | count_over_time()"):
            pair.register({"q": q, "step": 60, "window": 3600})

        def counters():
            return [sum(v for labels, v in c.series() if labels.get("tenant") == TENANT)
                    for c in (jblock.inspected_bytes_total, tblock.inspected_bytes_total)]

        before = counters()
        pair.push(5, 88, 3, base)
        inst = pair.t.ingesters["ingester-0"].instance(TENANT)
        batch_bytes = sum(lt.byte_count for lt in inst.live.values())
        pair.cut()
        charged = [a - b for a, b in zip(counters(), before)]
        assert charged[0] == charged[1]
        assert 0 < charged[1] <= batch_bytes * 1.5, (charged, batch_bytes)


# ---------------------------------------------------------------------------
# alerts and deviation
# ---------------------------------------------------------------------------


class TestAlertsAndDeviation:
    def test_threshold_fires_and_clears(self, make_pair):
        _settle()
        pair = make_pair()
        now = int(time.time())
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600,
                             "alert": {"op": ">", "value": 0.0}})
        bin_start = (now // 60 - 1) * 60  # the latest COMPLETE bin
        pair.push(5, 41, 4, bin_start)
        pair.cut()
        st = pair.state(ids)
        assert st["firing"], st
        for gauge, qid in ((jengine.alert_firing_gauge, ids[0]),
                           (tengine.alert_firing_gauge, ids[1])):
            assert [v for labels, v in gauge.series() if labels.get("query_id") == qid] == [1]
        # two steps later the latest complete bin is empty: the
        # re-evaluation (state read / scrape collector) clears it
        for app, qid, gauge in zip(pair.apps, ids, (jengine.alert_firing_gauge,
                                                     tengine.alert_firing_gauge)):
            q = app.standing.get(TENANT, qid)
            with q.lock:
                app.standing._eval_alert(q, now + 180)
            assert not any(q.firing.values())
            assert [v for labels, v in gauge.series() if labels.get("query_id") == qid] == [0]

    def test_deviation_fires_against_seasonal_baseline(self, make_pair):
        _settle()
        pair = make_pair()
        now = int(time.time())
        deviation = {"season": 600, "factor": 2.0, "min_count": 2}
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600,
                             "deviation": deviation})
        events = ([], [])
        for app, out in zip(pair.apps, events):
            app.standing.subscribe_deviations(out.append)
        latest = (now // 60 - 1) * 60
        pair.push(3, 61, 2, latest - 600)  # one season back: a small baseline
        pair.push(3, 62, 2, latest - 1200)
        pair.cut()
        pair.push(40, 63, 4, latest)  # the latest complete bin: a burst
        pair.cut()
        st = pair.state(ids)
        assert st["deviating"] and st["stats"]["deviationFires"] == len(st["deviating"])
        drop = ("queryId", "at")
        assert [{k: v for k, v in e.items() if k not in drop} for e in events[0]] == \
            [{k: v for k, v in e.items() if k not in drop} for e in events[1]]
        assert len(events[1]) == st["stats"]["deviationFires"]
        assert all(e["kind"] == "standing_deviation" and e["current"] >= 2 for e in events[1])

    def test_fold_failure_marks_query_dirty(self, make_pair, monkeypatch):
        """A fold failure marks ITS query dirty, starves no sibling and
        never reaches the cut path; the read-path rebuild heals it."""
        pair = make_pair()
        base = _aligned_base()
        bad = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        good = pair.register({"q": HIST_Q, "step": 60, "window": 3600})
        for ids in (bad, good):
            pair.read(ids, 0, 0)  # clears the registration's backfill
        origs = []
        for app, qid in zip(pair.apps, bad):
            orig = app.standing._fold_one

            def boom(q, batch, d, qid=qid, orig=orig):
                if q.id == qid:
                    raise RuntimeError("injected fold failure")
                return orig(q, batch, d)

            monkeypatch.setattr(app.standing, "_fold_one", boom)
            origs.append(orig)
        pair.push(5, 83, 3, base)
        pair.cut()  # must not raise
        assert pair.state(bad)["stats"]["dirty"]
        g = pair.state(good)["stats"]
        assert g["folds"] == 1 and not g["dirty"]
        for app, orig in zip(pair.apps, origs):
            monkeypatch.setattr(app.standing, "_fold_one", orig)
        pair.flush()
        pair.check(bad, RATE_Q, base - 60, base + 120)
        assert not pair.state(bad)["stats"]["dirty"]


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def _http(url, method, path, body=None):
    r = urllib.request.Request(url + path, method=method,
                               data=json.dumps(body).encode() if body is not None else None,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            raw = resp.read()
            return resp.status, raw
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _norm(raw: bytes):
    """A JSON body without its ids and wall-clock fields."""
    try:
        doc = json.loads(raw)
    except ValueError:
        return raw
    docs = doc.get("queries", [doc]) if isinstance(doc, dict) else []
    for d in docs if isinstance(docs, list) else [doc]:
        for k in ("id", "createdUnix"):
            d.pop(k, None)
        d.get("stats", {}).pop("foldSeconds", None)
    return doc


def test_lifecycle_over_http(make_pair):
    pair = make_pair()
    servers = [JTempoServer(pair.j).start(), TempoServer(pair.t).start()]
    try:
        def both(method, path, body=None):
            """`path`, or a (JAX, port) pair of paths, asked of both."""
            paths = path if isinstance(path, tuple) else (path, path)
            (js, jb), (ts, tb) = (_http(s.url, method, p, body) for s, p in zip(servers, paths))
            assert (js, _norm(jb)) == (ts, _norm(tb)), path
            return ts, tb

        base = _aligned_base()
        ids = []
        for s in servers:
            status, body = _http(s.url, "POST", "/api/metrics/standing",
                                 {"q": RATE_Q, "step": 60, "window": 3600})
            assert status == 200
            ids.append(json.loads(body))
        assert _norm(json.dumps(ids[0]).encode()) == _norm(json.dumps(ids[1]).encode())
        ids = tuple(d["id"] for d in ids)
        assert ids[1].startswith("sq-")
        status, body = both("GET", "/api/metrics/standing")
        assert status == 200 and len(json.loads(body)["queries"]) == 1
        pair.push(5, 61, 3, base)
        pair.cut()
        rng = f"?start={base - 60}&end={base + 120}&step=60"
        status, body = both("GET", tuple(f"/api/metrics/standing/{q}{rng}" for q in ids))
        mat = json.loads(body)
        assert status == 200 and mat["data"]["resultType"] == "matrix" and mat["data"]["result"]
        assert mat["metrics"].get("standing") is True
        qr = [json.loads(_http(s.url, "GET", f"/api/metrics/query_range?q="
                               f"{urllib.parse.quote(RATE_Q)}&start={base - 60}"
                               f"&end={base + 120}&step=60")[1]) for s in servers]
        assert _vals(qr[0]["data"]) == _vals(qr[1]["data"]) == _vals(mat["data"])
        status, body = both("GET", tuple(f"/api/metrics/standing/{q}/state" for q in ids))
        assert status == 200 and json.loads(body)["stats"]["folds"] == 1
        for path in ("/api/metrics/standing/sq-nope", "/api/metrics/standing/sq-nope/state",
                     tuple(f"/api/metrics/standing/{q}/state/x" for q in ids),
                     tuple(f"/api/metrics/standing/{q}?step=90" for q in ids),
                     tuple(f"/api/metrics/standing/{q}?start=x" for q in ids),
                     tuple(f"/api/metrics/standing/{q}?start=200&end=100" for q in ids)):
            assert both("GET", path)[0] in (400, 404)
        for body_ in ({"q": "{ bad ===", "step": 60}, {"q": RATE_Q, "step": 0}, [1, 2]):
            assert both("POST", "/api/metrics/standing", body_)[0] == 400
        assert both("PUT", "/api/metrics/standing")[0] == 405
        status, body = both("GET", "/status/standing")
        assert status == 200 and json.loads(body)["enabled"] is True
        assert json.loads(body)["cutSpans"] == {TENANT: 15}
        status, _ = both("DELETE", tuple(f"/api/metrics/standing/{q}" for q in ids))
        assert status == 204
        assert both("GET", tuple(f"/api/metrics/standing/{q}/state" for q in ids))[0] == 404
        assert both("GET", "/status/services")[0] == 200
    finally:
        for s in servers:
            s.stop()


def test_status_standing_when_disabled(make_pair):
    pair = make_pair(standing={"enabled": False})
    servers = [JTempoServer(pair.j).start(), TempoServer(pair.t).start()]
    try:
        (js, jb), (ts, tb) = (_http(s.url, "GET", "/status/standing") for s in servers)
        assert (js, json.loads(jb)) == (ts, json.loads(tb)) == (200, {"enabled": False})
        (js, jb), (ts, tb) = (_http(s.url, "GET", "/api/metrics/standing") for s in servers)
        assert js == ts == 404
    finally:
        for s in servers:
            s.stop()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("yaml_text", [
    "multitenancy_enabled: true\ningester:\n  max_block_duration_s: 30\n",
    "multitenancy_enabled: true\nstanding:\n  max_queries_per_tenant: 8\n",
    "multitenancy_enabled: true\nstanding:\n  enabled: false\n",
    "standing:\n  max_queries_per_tenant: 0\n",
    "storage:\n  trace:\n    block:\n      step_partial_rules:\n"
    "        - [huge, '{} | histogram_over_time(duration)', 1, 4096]\n",
])
def test_check_config_warnings(yaml_text):
    j, t = jparse_config(yaml_text), parse_config(yaml_text)
    jw, tw = jcheck_config(j), check_config(t)
    assert jw == tw
    want = (t.app.multitenancy_enabled and t.app.standing.enabled
            and t.app.standing.max_queries_per_tenant <= 0)
    assert any("standing.max_queries_per_tenant" in w for w in tw) == want


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------


class TestSnapshot:
    def test_snapshot_restore_roundtrip(self, make_pair):
        pair = make_pair()
        base = _aligned_base()
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600,
                             "alert": {"op": ">", "value": 5.0}})
        pair.push(5, 71, 3, base)
        pair.cut()
        before = pair.read(ids, base - 60, base + 120)
        pair.close()  # the final snapshot, after the drain's flush
        pair.open()
        docs = [app.standing_list() for app in pair.apps]
        assert [d["id"] for d in docs[1]] == [ids[1]] and [d["id"] for d in docs[0]] == [ids[0]]
        assert docs[1][0]["alert"] == {"op": ">", "value": 5.0}
        assert _reg_doc(docs[0][0]) == _reg_doc(docs[1][0])
        assert pair.read(ids, base - 60, base + 120) == before
        assert pair.state(ids)["stats"]["rebuilds"] >= 1

    def test_port_restores_a_jax_snapshot(self, make_pair, tmp_path):
        """The port opens the JAX package's backend and WAL after a crash:
        it restores the JAX-written standing.json, rebuilds from the
        JAX-written block and WAL segments, and reads the same matrices."""
        pair = make_pair()
        base = _aligned_base()
        ids = pair.register({"q": RATE_Q, "step": 60, "window": 3600})
        hist = pair.register({"q": HIST_Q, "step": 60, "window": 3600, "maxSeries": 8})
        pair.push(10, 5, 4, base)
        pair.cut()
        pair.flush(poll=False)
        pair.push(4, 6, 4, base + 60)
        pair.cut()  # WAL-only
        start, end = base - 60, base + 180
        want = {qid: pair.read(q_ids, start, end) for q_ids in (ids, hist) for qid in q_ids[:1]}
        for app in pair.apps:
            app.standing.snapshot()
        pair.crash()
        with open(tmp_path / "p0" / "jax" / "wal" / "standing.json") as f:
            jdoc = json.load(f)
        assert sorted(q["id"] for q in jdoc["queries"]) == sorted([ids[0], hist[0]])
        app = App(AppConfig(db=DBConfig(backend="local",
                                        backend_path=str(tmp_path / "p0" / "jax" / "blocks"),
                                        wal_path=str(tmp_path / "p0" / "jax" / "wal"),
                                        compaction_device_shards=1)), device="cpu")
        try:
            assert sorted(d["id"] for d in app.standing_list()) == sorted([ids[0], hist[0]])
            for qid, expect in want.items():
                assert _vals(app.standing_read(qid, start_s=start, end_s=end)) == expect
                st = app.standing_state(qid)["stats"]
                assert st["rebuilds"] >= 1 and not st["dirty"]
        finally:
            app.shutdown()


# ---------------------------------------------------------------------------
# the step-partial counters
# ---------------------------------------------------------------------------


def test_step_partial_counters_move_alike(make_pair):
    """Flushing a block under the default step rules writes partial
    pages, and a matching query_range reads row groups from them: both
    counters move by the same amounts in both packages' registries."""
    pair = make_pair()
    counters = ((jrules.partial_pages_written_total, trules.partial_pages_written_total),
                (jrules.partial_row_groups_read_total, trules.partial_row_groups_read_total))

    def values():
        return [[sum(v for _, v in c.series()) for c in pair_] for pair_ in counters]

    before = values()
    base = _aligned_base()
    pair.push(10, 17, 4, base)
    pair.cut()
    pair.flush()
    written = values()
    got = pair.query_range(RATE_Q, base - 60, base + 120)
    read = values()
    assert got
    d_written = [a - b for a, b in zip(written[0], before[0])]
    d_read = [a - b for a, b in zip(read[1], written[1])]
    assert d_written[0] == d_written[1] > 0
    assert d_read[0] == d_read[1] > 0
    exposed = _http_metrics(pair)
    assert "tempo_tpu_standing_partial_row_groups_read_total" in exposed
    assert "tempo_tpu_standing_partial_pages_written_total" in exposed


def _http_metrics(pair) -> str:
    srv = TempoServer(pair.t).start()
    try:
        return _http(srv.url, "GET", "/metrics")[1].decode()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the card's fold arm
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_fold_arm_equals_host_arm():
    """The same cuts folded by an engine on the card (seg_bincount, one
    standing_fold dispatch a query with live slots) and on the CPU
    (np.unique): equal counts and series, launches counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = _aligned_base()
    queries = (RATE_Q, HIST_Q, "{ } | quantile_over_time(duration, 0.5, 0.99)",
               '{ resource.service.name = "cart" } | count_over_time()')
    engines = {dev: StandingEngine(device=dev) for dev in ("cuda", "cpu")}
    qs = {dev: [eng.register("t", q, 60, 3600) for q in queries]
          for dev, eng in engines.items()}
    launches0 = pk.seg_bincount.launches
    dispatches0 = STATS.dispatches.get("standing_fold", 0)
    for wave in range(3):
        batch = synth.make_batch(400, 5, seed=wave, base_time_ns=(base + 60 * wave) * 10**9)
        for eng in engines.values():
            eng.fold("t", batch)
    folds = 3 * len(queries)
    assert pk.seg_bincount.launches - launches0 == folds
    assert STATS.dispatches.get("standing_fold", 0) - dispatches0 == folds
    for qc, qh in zip(qs["cuda"], qs["cpu"]):
        assert not qc.dirty and qc.folds == qh.folds == 3
        keyed = []
        for q in (qc, qh):
            key_of = {s: key for key, s in q.series.slots.items()}
            keyed.append({(key_of[s], b, k): c for (s, b, k), c in q.counts.items()})
        assert keyed[0] == keyed[1] and sum(keyed[0].values()) > 0


# ---------------------------------------------------------------------------
# a failure of the card's fold arm is never healed on the host
# ---------------------------------------------------------------------------


def _fail_card_arm(monkeypatch, engine):
    """Point `engine` at the card's arm and make it fail: a host without a
    card fails the copy to `cuda`, a host with one the injected kernel."""
    def boom(*a, **k):
        raise RuntimeError("injected seg_bincount failure")

    monkeypatch.setattr(engine, "device", torch.device("cuda"))
    monkeypatch.setattr(pk, "seg_bincount", boom)


def test_card_fold_failure_is_not_healed_over_http(tmp_path, monkeypatch):
    """A failed card fold marks its query failed, not dirty: the cut goes
    on, the read and state answer 500 before and after a flush and poll
    (no host rebuild stands in for the kernel), the query stays listed
    and deletable."""
    root = str(tmp_path)
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=root + "/blocks",
                                    wal_path=root + "/wal", compaction_device_shards=1)),
              device="cpu")
    srv = TempoServer(app).start()
    try:
        status, body = _http(srv.url, "POST", "/api/metrics/standing",
                             {"q": RATE_Q, "step": 60, "window": 3600})
        assert status == 200
        qid = json.loads(body)["id"]
        assert _http(srv.url, "GET", f"/api/metrics/standing/{qid}")[0] == 200
        q = app.standing.get(TENANT, qid)
        rebuilds0 = q.rebuilds
        _fail_card_arm(monkeypatch, app.standing)
        base = _aligned_base()
        app.push_traces(synth.make_traces(5, seed=91, spans_per_trace=3,
                                          base_time_ns=base * 10**9))
        _cut_all(app)  # must not raise
        assert q.failed and "seg_bincount on cuda" in q.failed
        assert not q.dirty and q.folds == 0
        for _ in range(2):
            for path in (f"/api/metrics/standing/{qid}", f"/api/metrics/standing/{qid}/state"):
                status, body = _http(srv.url, "GET", path)
                assert status == 500 and b"seg_bincount on cuda" in body, (path, body)
            _flush_all(app)
            app.db.poll_now()
        assert q.rebuilds == rebuilds0 and q.failed
        status, body = _http(srv.url, "GET", "/api/metrics/standing")
        assert status == 200 and [d["id"] for d in json.loads(body)["queries"]] == [qid]
        assert _http(srv.url, "DELETE", f"/api/metrics/standing/{qid}")[0] == 204
    finally:
        srv.stop()
        app.shutdown()


@pytest.mark.parametrize("dev", ["cpu", "cuda"])
def test_max_slots_on_the_card_raises(monkeypatch, dev):
    """A plan over MAX_SLOTS folds on the host arm as the reference's
    does, and fails the query on the card's arm before any launch."""
    from tempo_tpu_torch.metrics_engine import plan as plan_mod

    eng = StandingEngine(device="cpu")
    q = eng.register("t", RATE_Q, 60, 3600)
    monkeypatch.setattr(plan_mod, "MAX_SLOTS", 1)
    monkeypatch.setattr(eng, "device", torch.device(dev))
    launches0 = pk.seg_bincount.launches
    batch = synth.make_batch(40, 5, seed=3, base_time_ns=_aligned_base() * 10**9)
    eng.fold("t", batch)
    assert pk.seg_bincount.launches == launches0
    if dev == "cpu":
        assert q.failed is None and q.folds == 1 and sum(q.counts.values()) == 200
    else:
        assert "MAX_SLOTS" in q.failed and q.folds == 0 and not q.counts
        with pytest.raises(tengine.StandingFoldFailed, match="MAX_SLOTS"):
            eng.read("t", q.id)
        with pytest.raises(tengine.StandingFoldFailed):
            eng.state("t", q.id)


@pytest.mark.cuda
def test_card_fold_failure_is_not_a_healed_read():
    """On the card, a seg_bincount that raises fails its query: no dirty
    mark, no host rebuild, and the read raises instead of answering."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mp = pytest.MonkeyPatch()
    eng = StandingEngine(device="cuda")
    q = eng.register("t", RATE_Q, 60, 3600)
    try:
        _fail_card_arm(mp, eng)
        eng.fold("t", synth.make_batch(40, 5, seed=4,
                                       base_time_ns=_aligned_base() * 10**9))
    finally:
        mp.undo()
    assert "injected seg_bincount failure" in q.failed
    assert not q.dirty and q.rebuilds == 0 and not q.counts
    with pytest.raises(tengine.StandingFoldFailed, match="injected"):
        eng.read("t", q.id)
