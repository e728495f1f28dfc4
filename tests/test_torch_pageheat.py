"""The port's page-heat ledger (tempo_tpu_torch/util/pageheat) against
the JAX package's (tempo_tpu/util/pageheat).

The same seeded touch stream goes through a ledger of each package, and
every report is compared field for field: the hot set and its transfer
amplification, the pinning table, the ghost-LRU what-if curve at the
default and at explicit budgets, the knee, the admission candidates and
report, the exporter's snapshot (its clock fields left out), TTL and cap
eviction, the counters' deltas and the gauges. Tolerance: exact; every
report is integers and ratios rounded the same way.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from tempo_tpu.util import pageheat as jpageheat
from tempo_tpu_torch.util import pageheat

# hot-set rows carry the seconds since a page's last touch
CLOCK = ("idleS",)


def _stream(seed: int, n: int = 400, pages: int = 40):
    """[(block, column, offset, moved, encoded)]: a skewed access stream
    over `pages` pages of 3 blocks, the hot ones re-shipped often."""
    rng = np.random.default_rng(seed)
    keys = [(f"blk-{i % 3}", ("service", "name", "duration_nano", "status")[i % 4], 64 * i)
            for i in range(pages)]
    enc = rng.integers(50, 5_000, pages)
    hot = rng.zipf(1.4, n) % pages
    out = []
    for k in hot:
        b, c, o = keys[k]
        out.append((b, c, o, int(enc[k] * rng.integers(1, 12)), int(enc[k])))
    out.append(("blk-0", "name", 9, 0, 10))  # moved 0: not recorded
    return out


def _pair(seed: int, **kw):
    j, t = jpageheat.PageHeatLedger(**kw), pageheat.PageHeatLedger(**kw)
    for b, c, o, mv, enc in _stream(seed):
        j.touch(b, c, o, mv, enc)
        t.touch(b, c, o, mv, enc)
    return j, t


def _no_clock(doc):
    if isinstance(doc, dict):
        return {k: _no_clock(v) for k, v in doc.items() if k not in CLOCK}
    if isinstance(doc, list):
        return [_no_clock(v) for v in doc]
    return doc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_stream_equal(seed):
    j, t = _pair(seed)
    assert _no_clock(j.snapshot(top=20)) == _no_clock(t.snapshot(top=20))
    assert j.access_stream() == t.access_stream()
    assert j.key_table() == t.key_table()
    assert j.mark() == t.mark()
    assert j.window_report(j.mark() // 2, top=5) == t.window_report(t.mark() // 2, top=5)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("budgets", [None, [1, 4096, 20_000, 10**6]])
def test_what_if_curve_equal(seed, budgets):
    j, t = _pair(seed)
    jr = jpageheat.what_if_report(ledger=j, budgets_bytes=budgets)
    tr = pageheat.what_if_report(ledger=t, budgets_bytes=budgets)
    assert jr == tr
    saved = [row["savedBytes"] for row in tr["curve"]]
    assert saved == sorted(saved)  # LRU is a stack algorithm


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("budget", [None, 0, 3000, 10**9])
def test_knee_and_admission_equal(seed, budget):
    j, t = _pair(seed)
    curve = jpageheat.what_if_report(ledger=j)["curve"]
    assert jpageheat.knee_budget(curve) == pageheat.knee_budget(
        pageheat.what_if_report(ledger=t)["curve"])
    assert (jpageheat.admission_report(budget_bytes=budget, ledger=j)
            == pageheat.admission_report(budget_bytes=budget, ledger=t))
    cap = 10**9 if budget is None else budget
    w = {"blk-1": 3.0, "*": 0.5}
    assert (jpageheat.admission_candidates(cap, ledger=j, min_ships=3, tenant_weights=w)
            == pageheat.admission_candidates(cap, ledger=t, min_ships=3, tenant_weights=w))


def test_knee_of_a_cold_curve_is_zero():
    for mod in (jpageheat, pageheat):
        assert mod.knee_budget([]) == 0
        assert mod.knee_budget([{"budgetBytes": 10, "savedBytes": 0}]) == 0


@pytest.mark.parametrize("max_pages", [5, 17])
def test_ttl_and_cap_eviction_equal(max_pages):
    j, t = _pair(5, max_pages=max_pages, stream_cap=64)
    assert j.evict_idle() == t.evict_idle()  # the cap: the coldest go
    assert _no_clock(j.snapshot()) == _no_clock(t.snapshot())
    assert j.key_table() == t.key_table()
    assert j.evict_idle(older_than_s=-1.0) == t.evict_idle(older_than_s=-1.0)  # the TTL: all
    assert _no_clock(j.snapshot()) == _no_clock(t.snapshot())
    assert len(t.access_stream()) == 64


def _global_pair(monkeypatch, seed):
    """Both packages' process-wide ledgers, reset and fed one stream."""
    for mod in (jpageheat, pageheat):
        monkeypatch.setattr(mod, "LEDGER", mod.PageHeatLedger())
    for b, c, o, mv, enc in _stream(seed):
        jpageheat.touch(b, c, o, mv, enc)
        pageheat.touch(b, c, o, mv, enc)


def test_counters_and_gauges_move_alike(monkeypatch):
    before = [(m.ships_total.value(), m.ship_bytes_total.value(), m.evictions_total.value())
              for m in (jpageheat, pageheat)]
    _global_pair(monkeypatch, 6)
    jpageheat.LEDGER.evict_idle(older_than_s=-1.0)
    pageheat.LEDGER.evict_idle(older_than_s=-1.0)
    after = [(m.ships_total.value(), m.ship_bytes_total.value(), m.evictions_total.value())
             for m in (jpageheat, pageheat)]
    deltas = [tuple(a - b for a, b in zip(x, y)) for x, y in zip(after, before)]
    assert deltas[0] == deltas[1] and deltas[1][0] > 0
    assert pageheat.LEDGER.lifetime_ships == deltas[1][0]
    _global_pair(monkeypatch, 7)
    for mod in (jpageheat, pageheat):
        mod._refresh_size_gauges()
        mod.what_if_report(publish_gauges=True)
    for name in ("tracked_pages_gauge", "stream_entries_gauge"):
        assert getattr(jpageheat, name).value() == getattr(pageheat, name).value() > 0
    for name in ("miss_ratio_gauge", "budget_bytes_gauge"):
        for label, _ in pageheat.BUDGET_FRACTIONS:
            assert (getattr(jpageheat, name).value(budget=label)
                    == getattr(pageheat, name).value(budget=label))
    assert pageheat.ships_total.name == "tempo_tpu_pageheat_ships_total"
    for name in ("ships_total", "ship_bytes_total", "evictions_total", "tracked_pages_gauge",
                 "stream_entries_gauge", "miss_ratio_gauge", "budget_bytes_gauge"):
        jm, tm = getattr(jpageheat, name), getattr(pageheat, name)
        assert (jm.name, jm.help) == (tm.name, tm.help)


def test_exporter_snapshot_and_offline_analysis_equal(monkeypatch, tmp_path):
    """The exporter's snapshot (tier off in both), its files on disk, and
    the offline re-simulation at explicit budgets."""
    from tempo_tpu.encoding.vtpu import colcache as jcolcache
    from tempo_tpu_torch.encoding.vtpu import colcache

    monkeypatch.setattr(jcolcache, "_shared_device", None)
    monkeypatch.setattr(colcache, "_shared_device", None)
    monkeypatch.delenv("TEMPO_TPU_DEVICE_TIER_MB", raising=False)
    _global_pair(monkeypatch, 8)
    monkeypatch.setenv("TEMPO_TPU_PAGEHEAT_EXPORT_S", "12.5")
    docs = []
    for mod, sub in ((jpageheat, "j"), (pageheat, "t")):
        ex = mod.PageHeatExporter(export_dir=str(tmp_path / sub))
        assert ex.interval_s == 12.5
        doc = ex.export_once()
        assert ex.last is doc and json.loads((tmp_path / sub / ex.SNAPSHOT_NAME).read_text())
        docs.append(doc)
    jd, td = ({k: v for k, v in d.items() if k != "exportedAt"} for d in docs)
    assert _no_clock(jd) == _no_clock(td) and td["residentTier"] == {"enabled": False}
    loaded = pageheat.load_snapshot(str(tmp_path / "t" / pageheat.PageHeatExporter.SNAPSHOT_NAME))
    for budgets in (None, [0.001, 0.01, 1]):
        ja = jpageheat.analyse_snapshot(docs[0], budgets_mb=budgets)
        ta = pageheat.analyse_snapshot(loaded, budgets_mb=budgets)
        ja.pop("exportedAt"), ta.pop("exportedAt")
        assert _no_clock(ja) == _no_clock(ta)


def test_exporter_thread_starts_and_stops():
    ex = pageheat.PageHeatExporter(interval_s=3600.0)
    assert ex.start() is ex and ex.start() is ex  # idempotent
    ex.stop()
    assert ex._thread is None
