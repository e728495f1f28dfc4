"""The port's storage analytics (tempo_tpu_torch/db/analytics.py) against
the JAX package's (tempo_tpu/db/analytics.py), on the CPU.

Both packages' TempoDB write the same seeded batches under the same block
IDs (tests/test_torch_db.py's DBPair), so the blocks are byte-equal, and
every document compares field for field: `analyse_block` of each block
(and of a block of another version: its meta facts only), `compaction_debt` over one
window of overlapping blocks and over windows of one block,
`analyse_tenant` (the clock pinned in both modules, for the age
distribution), `fleet_summary`, a whole `StorageScanner` pass and its
gauges, and `/status/storage` over HTTP on both Apps, apart from
`scannedAt` and `scanSeconds` (wall clock). The scanner starts, scans,
stops, and prunes the memo of a block that compaction removed.
Tolerance: exact.
"""

import json
import time
import types

import pytest

from tempo_tpu.db import analytics as janalytics
from tempo_tpu_torch.db import analytics
from tempo_tpu_torch.model import synth

from test_torch_app import _no_prefetch, make_pair, push_all  # noqa: F401 (fixtures)
from test_torch_db import DBPair

NOW = 1_700_005_000.0


@pytest.fixture(autouse=True)
def _pinned_clock(monkeypatch):
    for mod in (janalytics, analytics):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: NOW, perf_counter=time.perf_counter, monotonic=time.monotonic))


def _pair(tmp_path, window_s=3600):
    """Four blocks of tenant t: three in one compaction window (random
    trace IDs, so their row groups overlap), one in a later window; and
    one block of tenant u."""
    pair = DBPair(tmp_path, compaction={"window_s": window_s})
    for i in range(3):
        pair.write("t", synth.make_batch(96, 4, seed=40 + i,
                                         base_time_ns=(1_700_000_000 + 60 * i) * 10**9))
    pair.write("t", synth.make_batch(64, 4, seed=50, base_time_ns=(1_700_000_000 + 2 * window_s)
                                     * 10**9))
    pair.write("u", synth.make_batch(32, 3, seed=60))
    return pair


def _without_clock(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in ("scannedAt", "scanSeconds")}


def test_analyse_block_equal(tmp_path):
    pair = _pair(tmp_path)
    for tenant in ("t", "u"):
        jm, tm = pair.j.blocklist.metas(tenant), pair.t.blocklist.metas(tenant)
        assert [m.block_id for m in jm] == [m.block_id for m in tm]
        for a, b in zip(jm, tm):
            ja, ta = janalytics.analyse_block(pair.j, a), analytics.analyse_block(pair.t, b)
            assert ja == ta and ta["supported"] and ta["rowGroups"] >= 1
            # a TypedBackend answers the same as the DB
            assert analytics.analyse_block(pair.t.backend, b) == ta


def test_analyse_block_of_another_version(tmp_path):
    pair = _pair(tmp_path)
    (jm,), (tm,) = pair.j.blocklist.metas("u"), pair.t.blocklist.metas("u")
    jm.version = tm.version = "vrow1"
    ja, ta = janalytics.analyse_block(pair.j, jm), analytics.analyse_block(pair.t, tm)
    assert ja == ta and ta["supported"] is False and "rowGroups" not in ta


@pytest.mark.parametrize("window_s", [3600, 1])
def test_compaction_debt_and_tenant_equal(tmp_path, window_s):
    pair = _pair(tmp_path, window_s=window_s)
    for tenant in ("t", "u"):
        jr = janalytics.analyse_tenant(pair.j, tenant)
        tr = analytics.analyse_tenant(pair.t, tenant)
        assert jr == tr
    debt = analytics.analyse_tenant(pair.t, "t")["compactionDebt"]
    if window_s == 3600:  # three blocks share a window and overlap
        assert debt["windows"] and debt["mergeRowGroups"] > 0
    else:  # every block alone in its window: no debt
        assert debt["windows"] == [] and debt["mergeRowGroups"] == 0
    analyses = [analytics.analyse_block(pair.t, m) for m in pair.t.blocklist.metas("t")]
    janalyses = [janalytics.analyse_block(pair.j, m) for m in pair.j.blocklist.metas("t")]
    for w in (1, 60, 3600, 10**9):
        assert analytics.compaction_debt(analyses, w) == janalytics.compaction_debt(janalyses, w)


def test_memo_skips_blocks_already_read(tmp_path, monkeypatch):
    pair = _pair(tmp_path)
    memo: dict = {}
    first = analytics.analyse_tenant(pair.t, "t", block_memo=memo)
    assert sorted(memo) == sorted(str(m.block_id) for m in pair.t.blocklist.metas("t"))
    monkeypatch.setattr(analytics, "analyse_block", lambda *a, **k: pytest.fail("re-read"))
    assert analytics.analyse_tenant(pair.t, "t", block_memo=memo) == first


def test_scanner_pass_fleet_and_gauges_equal(tmp_path):
    pair = _pair(tmp_path)
    jdoc = janalytics.StorageScanner(pair.j).scan_once()
    tdoc = analytics.StorageScanner(pair.t).scan_once()
    assert _without_clock(jdoc) == _without_clock(tdoc)
    assert set(tdoc["tenants"]) == {"t", "u"} and tdoc["fleet"]["tenants"] == 2
    assert tdoc["fleet"] == analytics.fleet_summary(tdoc["tenants"])
    for tenant in ("t", "u"):
        for jg, tg in ((janalytics.zonemap_coverage_gauge, analytics.zonemap_coverage_gauge),
                       (janalytics.debt_row_groups_gauge, analytics.debt_row_groups_gauge),
                       (janalytics.debt_ratio_gauge, analytics.debt_ratio_gauge),
                       (janalytics.debt_payoff_gauge, analytics.debt_payoff_gauge),
                       (janalytics.compression_ratio_gauge, analytics.compression_ratio_gauge)):
            assert jg.value(tenant=tenant) == tg.value(tenant=tenant)


def test_scanner_starts_stops_and_prunes_its_memo(tmp_path):
    pair = _pair(tmp_path)
    scanner = analytics.StorageScanner(pair.t, interval_s=0.05)
    assert scanner.last_report() is None
    scanner.start()
    try:
        deadline = time.monotonic() + 30
        while scanner.last_report() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert scanner.last_report() is not None and scanner._thread.is_alive()
    finally:
        scanner.stop()
    assert scanner._thread is None
    before = set(scanner._memo)
    assert pair.t.compact_once("t") >= 1 and pair.j.compact_once("t") >= 1
    doc = scanner.report(max_age_s=0)
    live = {str(m.block_id) for tenant in ("t", "u") for m in pair.t.blocklist.metas(tenant)}
    assert set(scanner._memo) == live and before - live
    jdoc = janalytics.StorageScanner(pair.j).report(max_age_s=0)
    assert _without_clock(jdoc) == _without_clock(doc)
    # fresh enough: no new scan
    assert scanner.report() is doc


def test_status_storage_equal_over_http(make_pair):
    pair = make_pair()
    push_all(pair)
    assert pair.same("POST", "/flush")[0] == 204
    for app in (pair.japp, pair.tapp):
        app.db.poll_now()
    docs = []
    for path in ("/status/storage?refresh=1", "/status/storage"):
        (js, _, jb), (ts, _, tb) = pair.both("GET", path)
        assert js == ts == 200
        jdoc, tdoc = json.loads(jb), json.loads(tb)
        assert _without_clock(jdoc) == _without_clock(tdoc)
        docs.append(tdoc)
    assert docs[0] == docs[1]  # the second answer is the scan's, cached
    assert docs[0]["fleet"]["blocks"] == 1 and docs[0]["fleet"]["totalSpans"] > 0
