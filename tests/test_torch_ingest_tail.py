"""The port's ingest tail (tempo_tpu_torch/ops/ingest_tail.py) against the
JAX package's (tempo_tpu/ops/ingest_tail.py), on the CPU.

The same seeded batches (each package's synth.make_batch with one seed,
then the same numpy edits: undefined and >= 2**32 values, nil by()
codes, start times on the low limb's wrap and at the bin edges, one bin
edge whose low limb sits just below 2**32) go through both packages:

- parking: each cut parks under the WAL segment's identity, with the
  same key and bytes in both tiers, and a zero tail budget or no tier
  parks nothing;
- `lower_fold_plan` gives the same lowering (or None) over a table of
  queries;
- `resident_fold` gives the JAX package's dict and series for every
  lowered shape (with and without by(), every operator, absent
  literals, a series cap that drops), which equals eval_batch's counts;
- `tail_search_mask` gives the JAX package's mask (and None where a tag
  needs the attribute table), and the querier's answer over the parked
  segment equals its host loop's;
- App level: the port's App and the JAX package's with the tail on give
  the same standing reads, the same live-tail searches and the same
  transfer accounting (h2d, avoided bytes), the reads equal query_range;
- tail entries shed first; a crash and restart loses nothing;
- where the reference falls back to the host on a failure (park, fold,
  scan), the port raises.

The port runs its plain versions (tensors on the CPU); the kernels are
held to them on the card in tests/test_torch_tail_kernels.py. Tolerance:
exact, every count an integer and every mask a boolean.
"""

import functools
import time

import numpy as np
import pytest

from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu.encoding.common import SearchRequest as JSearchRequest
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.metrics_engine import SeriesTable as JSeriesTable
from tempo_tpu.metrics_engine import compile_metrics_plan as jcompile
from tempo_tpu.model import synth as jsynth
from tempo_tpu.model.columnar import SpanBatch as JSpanBatch
from tempo_tpu.ops import ingest_tail as jtail
from tempo_tpu.util import devicetiming as jdevicetiming
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.config_sections import DeviceTierConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.encoding.common import SearchRequest
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.metrics_engine import SeriesTable, compile_metrics_plan, eval_batch
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.columnar import SpanBatch
from tempo_tpu_torch.modules import querier as tquerier
from tempo_tpu_torch.ops import ingest_tail
from tempo_tpu_torch.standing.engine import StandingFoldFailed
from tempo_tpu_torch.util import devicetiming

from test_torch_standing import _crash, _cut_all, _flush_all, _vals

STEP = 60
NB = 12  # bins of the fold window


@functools.lru_cache(maxsize=None)
def _wrap_start() -> int:
    """A start second near now whose third bin edge has a low limb just
    below 2**32: rows at that edge and one nanosecond either side cross
    the limb's wrap."""
    s = np.arange(1_760_000_000, 1_760_000_000 + 4_000_000, dtype=np.int64)
    lo = ((s + 3 * STEP) * 10**9) % (1 << 32)
    best = int(s[np.argmax(lo)])
    assert (1 << 32) - int(lo.max()) <= 4096
    return best


def _edit(cols: dict, rng, start_s: int) -> dict:
    """The same edits on either package's columns (numpy)."""
    n = len(cols["name"])
    cols = dict(cols)
    span = (NB + 2) * STEP * 10**9
    t = (start_s - STEP) * 10**9 + rng.integers(0, span, n, dtype=np.int64)
    e3 = (start_s + 3 * STEP) * 10**9
    wrap = (e3 >> 32) + 1 << 32
    pins = [e3 - 1, e3, e3 + 1, wrap - 1, wrap, wrap + 1, start_s * 10**9,
            start_s * 10**9 - 1, (start_s + NB * STEP) * 10**9, (start_s + NB * STEP) * 10**9 - 1]
    t[: len(pins)] = pins
    cols["start_unix_nano"] = t.astype(np.uint64)
    dur = rng.integers(10**5, 1 << 34, n).astype(np.uint64)
    dur[:4] = [(1 << 32) - 1, 1 << 32, (1 << 32) + 1, 5 << 32]
    cols["duration_nano"] = dur
    cols["http_status"] = rng.choice([0, 200, 404, 500, 503], n).astype(np.uint16)
    cols["http_method"] = np.where(rng.random(n) < 0.2, 0, cols["http_method"]).astype(np.uint32)
    cols["http_url"] = np.where(rng.random(n) < 0.1, 0, cols["http_url"]).astype(np.uint32)
    return cols


def _batches(seed: int, n_traces: int = 64, spans: int = 6):
    """(JAX batch, port batch) from the same seed and edits."""
    start_s = _wrap_start()
    out = []
    for mod, cls in ((jsynth, JSpanBatch), (synth, SpanBatch)):
        b = mod.make_batch(n_traces, spans, seed=seed)
        cols = _edit(b.cols, np.random.default_rng(seed + 1), start_s)
        out.append(cls(cols=cols, attrs=b.attrs, dictionary=b.dictionary))
    return out


def _tiers(tail_mb: int = 16):
    return (jcolcache.DeviceTier(64 << 20, refresh_s=3600.0,
                                 ingest_tail_budget_bytes=tail_mb << 20),
            colcache.DeviceTier(64 << 20, refresh_s=3600.0,
                                ingest_tail_budget_bytes=tail_mb << 20, device="cpu"))


# ---------------------------------------------------------------------------
# parking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_park_keys_and_bytes_equal(seed):
    jb, tb = _batches(seed)
    jt, tt = _tiers()
    jkey = jtail.park_cut(jt, "t", "blk:3", jb)
    tkey = ingest_tail.park_cut(tt, "t", "blk:3", tb)
    assert jkey == tkey == ("ingest_tail", "t", "blk:3") == ingest_tail.tail_key("t", "blk:3")
    js, ts = jt.stats(), tt.stats()
    for k in ("tail_entries", "tail_bytes", "bytes", "entries", "admissions"):
        assert js[k] == ts[k], k
    entry = tt.get(tkey)
    assert entry.meta == {"n": tb.num_spans} and set(entry.arrays) == set(ingest_tail._PARKED)
    p = ingest_tail._pow2(tb.num_spans)
    assert ts["tail_bytes"] == 4 * p * len(ingest_tail._PARKED)
    jentry = jt.get(jkey)
    for name, arr in entry.arrays.items():
        assert np.array_equal(arr.numpy().view(np.uint32), np.asarray(jentry.arrays[name])), name


def test_zero_budget_or_no_tier_parks_nothing():
    jb, tb = _batches(3)
    jt, tt = _tiers(tail_mb=0)
    assert jtail.park_cut(jt, "t", "b:0", jb) is None
    assert ingest_tail.park_cut(tt, "t", "b:0", tb) is None
    assert ingest_tail.park_cut(None, "t", "b:0", tb) is None
    assert tt.stats()["tail_entries"] == 0 == jt.stats()["tail_entries"]


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

QUERIES = [
    "{} | count_over_time()",
    "{} | rate()",
    "{} | rate() by (name)",
    "{} | rate() by (resource.service.name)",
    "{} | count_over_time() by (span.http.method)",
    "{} | count_over_time() by (span.http.url)",
    '{ resource.service.name = "cart" } | rate() by (name)',
    '{ resource.service.name != "cart" } | rate()',
    '{ resource.service.name = "nope" } | rate()',
    '{ resource.service.name != "nope" } | count_over_time() by (name)',
    '{ name = "db.query" } | count_over_time()',
    '{ name != "db.query" && span.http.method = "GET" } | rate() by (resource.service.name)',
    '{ span.http.url != "http://svc/3" } | count_over_time()',
    "{ span.http.status_code = 500 } | count_over_time()",
    "{ span.http.status_code != 200 } | count_over_time() by (span.http.method)",
    "{ span.http.status_code > 404 } | rate()",
    "{ span.http.status_code >= 500 } | count_over_time()",
    "{ span.http.status_code < 500 } | rate() by (name)",
    "{ span.http.status_code <= 404 } | count_over_time()",
    "{ span.http.status_code = 0 } | count_over_time()",
    '{ resource.service.name = "cart" && span.http.status_code >= 500 } | rate() by (name)',
    '{ resource.service.name = "cart" } | { span.http.method = "POST" } | rate()',
    # not lowered: the host path
    "{} | histogram_over_time(duration)",
    "{} | quantile_over_time(duration, 0.5)",
    '{ span.custom = "x" } | rate()',
    '{ .service.name = "api" } | rate()',
    "{} | rate() by (span.custom)",
    '{ name = "a" || name = "b" } | rate()',
    "{ span.http.status_code > 404.5 } | rate()",
    '{ name > "a" } | rate()',
    "{ duration > 1ms } | rate()",
    "{ status = error } | count_over_time()",
]


def _lowered(fp):
    return None if fp is None else (tuple(fp.preds), fp.by_col)


@pytest.mark.parametrize("q", QUERIES)
def test_lower_fold_plan_equal(q):
    start = _wrap_start()
    jfp = jtail.lower_fold_plan(jcompile(q, start, start + NB * STEP, STEP))
    tfp = ingest_tail.lower_fold_plan(compile_metrics_plan(q, start, start + NB * STEP, STEP))
    assert _lowered(jfp) == _lowered(tfp)


# ---------------------------------------------------------------------------
# resident_fold
# ---------------------------------------------------------------------------

LOWERED = [q for q in QUERIES[:22]]


def _host_counts(plan, batch, max_series: int) -> tuple[dict, dict]:
    """eval_batch's counts as {(series key, bin): count}."""
    series = SeriesTable(max_series)
    res = eval_batch(plan, batch, batch.dictionary, series)
    flats, counts = np.unique(res.slots[res.slots >= 0], return_counts=True)
    key_of = {s: k for k, s in series.slots.items()}
    nk = plan.n_buckets
    out = {}
    for f, c in zip(flats, counts):
        out[(key_of[int(f) // (plan.n_bins * nk)], int(f) % (plan.n_bins * nk) // nk)] = int(c)
    return out


@pytest.mark.parametrize("max_series", [64, 2])
@pytest.mark.parametrize("q", LOWERED)
def test_resident_fold_equal(q, max_series):
    start = _wrap_start()
    jb, tb = _batches(7)
    jt, tt = _tiers()
    jkey = jtail.park_cut(jt, "t", "b:0", jb)
    tkey = ingest_tail.park_cut(tt, "t", "b:0", tb)
    jplan = jcompile(q, start, start + NB * STEP, STEP, max_series=max_series)
    tplan = compile_metrics_plan(q, start, start + NB * STEP, STEP, max_series=max_series)
    jfp, tfp = jtail.lower_fold_plan(jplan), ingest_tail.lower_fold_plan(tplan)
    assert tfp is not None
    jseries, tseries = JSeriesTable(max_series), SeriesTable(max_series)
    want = jtail.resident_fold(jplan, jfp, jb, jb.dictionary, jseries, tier=jt, key=jkey)
    got = ingest_tail.resident_fold(tplan, tfp, tb, tb.dictionary, tseries, tier=tt, key=tkey)
    assert got == want and tseries.slots == jseries.slots
    key_of = {s: k for k, s in tseries.slots.items()}
    keyed = {(key_of[s], b): c for (s, b), c in got.items()}
    host = _host_counts(tplan, tb, max_series)
    if max_series >= 64:
        assert keyed == host
    else:  # the same series kept, in the same order, when the cap drops some
        assert keyed == {k: c for k, c in host.items() if k[0] in tseries.slots}


def test_resident_fold_misses_take_the_host_path():
    start = _wrap_start()
    _, tb = _batches(8)
    _, tt = _tiers()
    tkey = ingest_tail.park_cut(tt, "t", "b:0", tb)
    plan = compile_metrics_plan("{} | rate()", start, start + NB * STEP, STEP)
    fp = ingest_tail.lower_fold_plan(plan)
    series = SeriesTable(64)
    assert ingest_tail.resident_fold(plan, fp, tb, tb.dictionary, series, tier=tt,
                                     key=ingest_tail.tail_key("t", "b:9")) is None
    assert ingest_tail.resident_fold(plan, fp, tb.select(np.arange(5)), tb.dictionary, series,
                                     tier=tt, key=tkey) is None
    assert ingest_tail.resident_fold(plan, fp, tb, tb.dictionary, series, tier=None,
                                     key=tkey) is None
    assert series.slots == {}


def test_resident_fold_transfer_accounting_equal():
    """h2d (literals, codes, edges), resident column bytes, avoided bytes:
    the same formulas in both packages."""
    start = _wrap_start()
    q = '{ resource.service.name = "cart" } | rate() by (name)'
    jb, tb = _batches(9)
    jt, tt = _tiers()
    jkey = jtail.park_cut(jt, "t", "b:0", jb)
    tkey = ingest_tail.park_cut(tt, "t", "b:0", tb)
    jplan = jcompile(q, start, start + NB * STEP, STEP)
    tplan = compile_metrics_plan(q, start, start + NB * STEP, STEP)
    deltas = []
    for mod, tail, plan, batch, tier, key, series in (
            (jdevicetiming, jtail, jplan, jb, jt, jkey, JSeriesTable(64)),
            (devicetiming, ingest_tail, tplan, tb, tt, tkey, SeriesTable(64))):
        before = mod.transfer_report()
        tail.resident_fold(plan, tail.lower_fold_plan(plan), batch, batch.dictionary, series,
                           tier=tier, key=key)
        after = mod.transfer_report()
        deltas.append((after["byKernel"]["standing_fold"]["h2d"]
                       - before["byKernel"].get("standing_fold", {}).get("h2d", 0),
                       after["byKernel"]["standing_fold"]["resident"]
                       - before["byKernel"].get("standing_fold", {}).get("resident", 0),
                       after["avoidedByKernel"]["standing_fold"]
                       - before["avoidedByKernel"].get("standing_fold", 0)))
    assert deltas[0] == deltas[1] and 0 < deltas[1][0] < 64 << 10
    assert jt.stats()["avoided_bytes"] == tt.stats()["avoided_bytes"] > 0


# ---------------------------------------------------------------------------
# tail_search_mask
# ---------------------------------------------------------------------------

SEARCHES = [
    {},
    {"tags": {"service.name": "cart"}},
    {"tags": {"service": "cart", "name": "db.query"}},
    {"tags": {"http.method": "GET", "http.status_code": "500"}},
    {"tags": {"http.url": "http://svc/3"}},
    {"tags": {"http.status_code": "0"}},
    {"tags": {"service.name": "cart"}, "min_duration_ns": 1 << 32},
    {"tags": {"name": "db.query"}, "max_duration_ns": (1 << 32) + 1},
    {"min_duration_ns": (1 << 32) - 1, "max_duration_ns": 5 << 32},
    {"min_duration_ns": 10**9},
    # all False: an absent value, an unparsable or out-of-range status
    {"tags": {"service.name": "nope"}},
    {"tags": {"http.status_code": "abc"}},
    {"tags": {"http.status_code": str(1 << 32)}},
    # None: a tag of the attribute table
    {"tags": {"region": "v7"}},
    {"tags": {"service.name": "cart", "region": "v7"}},
]


@pytest.mark.parametrize("req", SEARCHES, ids=str)
def test_tail_search_mask_equal(req):
    jb, tb = _batches(11)
    jt, tt = _tiers()
    jb._tail_key = jtail.park_cut(jt, "t", "b:0", jb)
    tb._tail_key = ingest_tail.park_cut(tt, "t", "b:0", tb)
    want = jtail.tail_search_mask(jb, JSearchRequest(**req), tier=jt)
    got = ingest_tail.tail_search_mask(tb, SearchRequest(**req), tier=tt)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.dtype == bool and np.array_equal(got, np.asarray(want))
    # the querier over the parked segment == its host loop
    old = colcache._shared_device
    colcache._shared_device = tt
    try:
        resident = tquerier._search_batch(tb, SearchRequest(**req))
        tb._tail_key = None
        host = tquerier._search_batch(tb, SearchRequest(**req))
    finally:
        colcache._shared_device = old
    assert resident == host


def test_tail_search_mask_misses():
    _, tb = _batches(12)
    _, tt = _tiers()
    req = SearchRequest(tags={"service.name": "cart"})
    assert ingest_tail.tail_search_mask(tb, req, tier=tt) is None  # no key
    tb._tail_key = ingest_tail.tail_key("t", "b:0")
    assert ingest_tail.tail_search_mask(tb, req, tier=tt) is None  # not parked
    ingest_tail.park_cut(tt, "t", "b:0", tb.select(np.arange(7)))
    assert ingest_tail.tail_search_mask(tb, req, tier=tt) is None  # n differs


# ---------------------------------------------------------------------------
# App level: both packages with the tail on
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_tiers(monkeypatch):
    for mod in (jcolcache, colcache):
        monkeypatch.setattr(mod, "_shared_device", None)
    monkeypatch.setattr(colcache, "_tier_device", None)


def _app_pair(root, tail_mb=32):
    j = JApp(JAppConfig(
        db=JDBConfig(backend="local", backend_path=str(root / "jax/blocks"),
                     wal_path=str(root / "jax/wal"), compaction_device_shards=1,
                     analytics_scan_s=0),
        generator_enabled=False,
        device_tier=jcolcache.DeviceTierConfig(budget_mb=64, ingest_tail_budget_mb=tail_mb)))
    t = App(AppConfig(
        db=DBConfig(backend="local", backend_path=str(root / "port/blocks"),
                    wal_path=str(root / "port/wal"), compaction_device_shards=1,
                    analytics_scan_s=0),
        generator_enabled=False,
        device_tier=DeviceTierConfig(budget_mb=64, ingest_tail_budget_mb=tail_mb)),
        device="cpu")
    return j, t


STANDING = [
    "{} | rate() by (resource.service.name)",
    '{ resource.service.name = "cart" } | rate() by (name)',
    "{ span.http.status_code >= 500 } | count_over_time()",
    "{} | histogram_over_time(duration)",  # not lowered: the host fold
]


def _report(mod, kernel):
    r = mod.transfer_report()
    return (r["byKernel"].get(kernel, {}).get("h2d", 0),
            r["avoidedByKernel"].get(kernel, 0), r.get("dispatchesByKernel", {}).get(kernel, 0))


def test_app_standing_and_live_search_equal(tmp_path, fresh_tiers):
    j, t = _app_pair(tmp_path)
    try:
        base = (int(time.time()) // 60) * 60 - 600
        ids = [[app.standing_register({"q": q, "step": 60, "window": 3600})["id"]
                for q in STANDING] for app in (j, t)]
        before = [{k: _report(m, k) for k in ("standing_fold", "live_tail_scan")}
                  for m in (jdevicetiming, devicetiming)]
        for wave in range(3):
            j.push_traces(jsynth.make_traces(10, seed=20 + wave, spans_per_trace=5,
                                             base_time_ns=(base + 60 * wave) * 10**9))
            t.push_traces(synth.make_traces(10, seed=20 + wave, spans_per_trace=5,
                                            base_time_ns=(base + 60 * wave) * 10**9))
            for app in (j, t):
                _cut_all(app)
            start, end = base - 60, base + 240
            for q, jid, tid in zip(STANDING, *ids):
                jr = _vals(j.standing_read(jid, start_s=start, end_s=end))
                tr = _vals(t.standing_read(tid, start_s=start, end_s=end))
                assert jr == tr == _vals(t.query_range(q, start, end, 60)), q
        stats = [jcolcache.shared_device_tier().stats(), colcache.shared_device_tier().stats()]
        assert stats[0]["tail_entries"] == stats[1]["tail_entries"] == 3
        for req in ({"service.name": "cart"}, {"name": "db.query", "http.status_code": "500"},
                    {"service.name": "nope"}, {"region": "v7"}):
            for mn, mx in ((0, 0), (10**8, 0), (0, 5 * 10**8)):
                jr = j.search(JSearchRequest(tags=req, min_duration_ns=mn, max_duration_ns=mx))
                tr = t.search(SearchRequest(tags=req, min_duration_ns=mn, max_duration_ns=mx))
                assert [vars(x) for x in jr.traces] == [vars(x) for x in tr.traces]
                assert jr.inspected_traces == tr.inspected_traces
        after = [{k: _report(m, k) for k in ("standing_fold", "live_tail_scan")}
                 for m in (jdevicetiming, devicetiming)]
        delta = [{k: tuple(a - b for a, b in zip(af[k], bf[k])) for k in af}
                 for af, bf in zip(after, before)]
        # the same avoided bytes (the reference's host-side standing_fold
        # dispatches of the histogram query count h2d there, none here)
        assert delta[0]["live_tail_scan"][:2] == delta[1]["live_tail_scan"][:2]
        assert delta[0]["standing_fold"][1] == delta[1]["standing_fold"][1] > 0
        h2d, avoided, dispatches = delta[1]["standing_fold"]
        # three lowered queries a cut, each a few hundred bytes of h2d
        assert dispatches == 9 and h2d / dispatches < 4096
        assert delta[1]["live_tail_scan"][1] > 0 and delta[1]["live_tail_scan"][2] > 0
    finally:
        for app in (j, t):
            app.shutdown()


# ---------------------------------------------------------------------------
# shed order, crash and restart
# ---------------------------------------------------------------------------


def test_tail_sheds_before_hot_pages():
    tier = colcache.DeviceTier(1 << 30, refresh_s=3600.0, ingest_tail_budget_bytes=1 << 29,
                               device="cpu")
    tier.should_admit = lambda page_keys: True
    hot = np.arange(1024, dtype=np.uint32)
    assert tier.offer(("blk", "service", 0), "rle", {"values": hot, "lengths": hot})
    assert tier.offer(("blk", "name", 0), "rle", {"values": hot, "lengths": hot})
    _, tb = _batches(13, n_traces=8)
    for i in range(4):
        assert ingest_tail.park_cut(tier, "t", f"b:{i}", tb) == ingest_tail.tail_key("t", f"b:{i}")
    st = tier.stats()
    assert st["tail_entries"] == 4 and st["entries"] == 6
    tier.budget_bytes = 4 * hot.nbytes  # room for the two hot pages alone
    tier.shed()
    st = tier.stats()
    assert st["tail_entries"] == 0 and st["tail_bytes"] == 0 and st["entries"] == 2
    assert tier.get(("blk", "service", 0)) is not None


def test_crash_and_restart_lose_nothing(tmp_path, fresh_tiers, monkeypatch):
    """Flush with the device page encode forced on, crash before the final
    flush, restart: the WAL replay and the blocks give the standing read
    and query_range of before the crash."""
    monkeypatch.setenv("TEMPO_TPU_DEVICE_ENCODE", "1")
    q = "{} | rate() by (resource.service.name)"
    base = (int(time.time()) // 60) * 60 - 600

    def app():
        return App(AppConfig(
            db=DBConfig(backend="local", backend_path=str(tmp_path / "blocks"),
                        wal_path=str(tmp_path / "wal")),
            generator_enabled=False,
            device_tier=DeviceTierConfig(budget_mb=64, ingest_tail_budget_mb=32)), device="cpu")

    a = app()
    qid = a.standing_register({"q": q, "step": 60, "window": 3600})["id"]
    a.push_traces(synth.make_traces(12, seed=3, spans_per_trace=4, base_time_ns=base * 10**9))
    _cut_all(a)
    _flush_all(a)
    a.push_traces(synth.make_traces(5, seed=4, spans_per_trace=4,
                                    base_time_ns=(base + 60) * 10**9))
    _cut_all(a)  # the second wave stays in the WAL
    assert colcache.shared_device_tier().stats()["tail_entries"] >= 1
    a.standing.snapshot()
    start, end = base - 60, base + 180
    expect = _vals(a.query_range(q, start, end, 60))
    assert expect == _vals(a.standing_read(qid, start_s=start, end_s=end))
    _crash(a)
    b = app()
    try:
        assert _vals(b.standing_read(qid, start_s=start, end_s=end)) == expect
        assert _vals(b.query_range(q, start, end, 60)) == expect
    finally:
        b.shutdown()


# ---------------------------------------------------------------------------
# where the reference falls back to the host, the port raises
# ---------------------------------------------------------------------------


def _broken(*_a, **_k):
    raise RuntimeError("broken kernel")


def test_park_failure_raises(tmp_path, fresh_tiers, monkeypatch):
    j, t = _app_pair(tmp_path)
    try:
        monkeypatch.setattr(colcache.DeviceTier, "park_tail", _broken)
        monkeypatch.setattr(jcolcache.DeviceTier, "park_tail", _broken)
        for app, mod in ((j, jsynth), (t, synth)):
            app.push_traces(mod.make_traces(4, seed=1, spans_per_trace=3))
        _cut_all(j)  # the reference logs it and parks nothing
        with pytest.raises(RuntimeError, match="broken kernel"):
            _cut_all(t)
    finally:
        for app in (j, t):
            app.shutdown()


def test_fold_failure_marks_the_query_failed(tmp_path, fresh_tiers, monkeypatch):
    j, t = _app_pair(tmp_path)
    try:
        base = (int(time.time()) // 60) * 60 - 600
        q = "{} | rate() by (resource.service.name)"
        jid, tid = (app.standing_register({"q": q, "step": 60, "window": 3600})["id"]
                    for app in (j, t))
        monkeypatch.setattr(ingest_tail, "_tail_fold_plain", _broken)
        monkeypatch.setattr(jtail, "_fold_kernel", _broken)
        for app, mod in ((j, jsynth), (t, synth)):
            app.push_traces(mod.make_traces(6, seed=2, spans_per_trace=3,
                                            base_time_ns=base * 10**9))
            _cut_all(app)
        start, end = base - 60, base + 120
        # the reference answers from its host fold; the port's reads fail
        assert _vals(j.standing_read(jid, start_s=start, end_s=end)) \
            == _vals(j.query_range(q, start, end, 60))
        with pytest.raises(StandingFoldFailed, match="tail_fold.*broken kernel"):
            t.standing_read(tid, start_s=start, end_s=end)
    finally:
        for app in (j, t):
            app.shutdown()


def test_scan_failure_raises(monkeypatch):
    _, tb = _batches(14)
    _, tt = _tiers()
    tb._tail_key = ingest_tail.park_cut(tt, "t", "b:0", tb)
    monkeypatch.setattr(ingest_tail, "_tail_scan_plain", _broken)
    monkeypatch.setattr(colcache, "_shared_device", tt)
    with pytest.raises(RuntimeError, match="broken kernel"):
        tquerier._search_batch(tb, SearchRequest(tags={"service.name": "cart"}))
