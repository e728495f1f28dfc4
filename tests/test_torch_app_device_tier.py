"""The port's single binary with the device-resident hot tier on, against
the JAX package's, over HTTP.

Both packages' App run with `device_tier.budget_mb` > 0 (the port on
device="cpu", its tier's tensors on the CPU), behind their own
TempoServer, with the pair of tests/test_torch_app.py (one query worker,
no hedging, no prefetch, fresh shape caches), each package's page-heat
ledger fresh per test and each package's tier reset after it. Compared
field for field:

- tag searches and TraceQL searches, before the tier admits any page,
  after the admission (the admitting query) and from the resident pages;
- /status/device (its clock field `idleS` left out; of the process-wide
  `transfer` rollup, the deltas of each of the tier's own kernels), with
  the tier on and off, and its 400s;
- simple-count query_range through the compiled tier, the third dispatch
  served from the resident stack in both packages;
- the ingest tail starts, by config and by environment, with its share
  of a tier on the App's device, and a cut parks there; as does a tier
  that TEMPO_TPU_DEVICE_TIER_MB starts.

Tolerance: exact; every count and mask is an integer or a boolean.
"""

import itertools
import json
import types
import uuid

import pytest

from tempo_tpu.backend import base as jbase
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.encoding.vtpu import wal as jwal
from tempo_tpu.encoding.vtpu.colcache import DeviceTierConfig as JDeviceTierConfig
from tempo_tpu.util import devicetiming as jdevicetiming
from tempo_tpu.util import pageheat as jpageheat
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.backend import base
from tempo_tpu_torch.config_sections import DeviceTierConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.encoding.vtpu import wal
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.util import devicetiming, pageheat

from test_torch_app import (  # noqa: F401 (_no_prefetch: the pair's autouse fixture)
    SEARCHES,
    SIMPLE_COUNT,
    T0,
    AppPair,
    _no_prefetch,
    norm_query,
    push_all,
    qs,
)

# the tier's own kernels in /status/device's transfer rollup
TIER_KERNELS = ("device_tier_admit", "resident_rle_scan", "resident_dct_scan",
                "resident_dbp_scan", "compiled_metrics")


@pytest.fixture(autouse=True)
def _fresh_tier_and_ledger(monkeypatch):
    for mod in (jpageheat, pageheat):
        monkeypatch.setattr(mod, "LEDGER", mod.PageHeatLedger())
    for mod in (jcolcache, colcache):
        monkeypatch.setattr(mod, "_shared_device", None)
    monkeypatch.setattr(colcache, "_tier_device", None)
    monkeypatch.delenv("TEMPO_TPU_DEVICE_TIER_MB", raising=False)
    # the same block IDs in both Apps, in the order each names its blocks,
    # so that the ledgers' keys and the tiers' listings compare as they are
    for mods in ((jbase, jwal), (base, wal)):
        seq = itertools.count(1)
        fake = types.SimpleNamespace(uuid4=lambda seq=seq: uuid.UUID(int=next(seq)),
                                     UUID=uuid.UUID)
        for mod in mods:
            monkeypatch.setattr(mod, "uuid", fake)


@pytest.fixture
def tier_pair(tmp_path):
    pairs = []

    def make(budget_mb=64, **kw):
        p = AppPair(tmp_path / f"p{len(pairs)}",
                    jax_kw={"device_tier": JDeviceTierConfig(budget_mb=budget_mb)},
                    port_kw={"device_tier": DeviceTierConfig(budget_mb=budget_mb)}, **kw)
        pairs.append(p)
        return p

    yield make
    for p in pairs:
        p.close()


def _tiers():
    return jcolcache.shared_device_tier(), colcache.shared_device_tier()


def _admit_now():
    """Recompute both tiers' admission sets from their ledgers now (the
    tier does it itself every refresh_s)."""
    j, t = _tiers()
    j.refresh_admission(force=True)
    t.refresh_admission(force=True)
    assert j._admit_keys == t._admit_keys and t._admit_keys


def _same_tier():
    j, t = _tiers()
    assert j.stats() == t.stats()
    assert j.resident_pages() == t.resident_pages()
    return t.stats()


def _loaded(pair):
    """One flushed block in each App. With two, the order in which a
    search's block jobs run varies from run to run (in either package),
    and with it the order of the page accesses the ghost-LRU curve reads."""
    push_all(pair, seed=3)
    push_all(pair, seed=4, minute=3)
    assert pair.same("POST", "/flush")[0] == 204
    ids = [[m.block_id for m in app.db.blocklist.metas("single-tenant")]
           for app in (pair.japp, pair.tapp)]
    assert ids[0] == ids[1] and len(ids[1]) == 1


def _searches(pair):
    for params in SEARCHES:
        pair.same("GET", "/api/search" + qs(**params), norm=norm_query)


def test_searches_equal_before_and_after_admission(tier_pair):
    pair = tier_pair()
    j, t = _tiers()
    assert t is not None and t.device.type == "cpu" and t.budget_bytes == 64 << 20
    _loaded(pair)
    for _ in range(2):  # cold, then warm: the heat the admission reads
        _searches(pair)
        assert _same_tier()["entries"] == 0
    _admit_now()
    _searches(pair)  # the admitting queries
    admitted = _same_tier()
    assert admitted["admissions"] > 0 and admitted["entries"] > 0
    _searches(pair)  # served from the resident pages
    served = _same_tier()
    assert served["hits"] > admitted["hits"] and served["avoided_bytes"] > admitted["avoided_bytes"]
    assert served["admissions"] == admitted["admissions"]


def _device_doc(raw: bytes, base: dict):
    """/status/device without its clock field, its transfer rollup cut
    to the tier's own kernels as deltas from `base`: every one of them,
    zero where it moved nothing. The rollup is process-wide, so whether
    a kernel has a row at all depends on what ran before in the process
    (a JAX compiled query of another test file leaves a
    `compiled_metrics` row in the JAX package's), not on this App."""
    doc = json.loads(raw)
    for row in doc["pageHeat"]["hotSet"]:
        row.pop("idleS")
    tr = doc["transfer"]
    doc["transfer"] = {
        "byKernel": {k: {d: tr["byKernel"].get(k, {}).get(d, 0)
                         - base["byKernel"].get(k, {}).get(d, 0)
                         for d in ("h2d", "d2h", "resident")}
                     for k in TIER_KERNELS},
        "avoidedByKernel": {k: tr["avoidedByKernel"].get(k, 0)
                            - base["avoidedByKernel"].get(k, 0) for k in TIER_KERNELS},
    }
    return doc


def _same_device_page(pair, query=""):
    bases = (jdevicetiming.transfer_report(), devicetiming.transfer_report())
    (js, _, jb), (ts, _, tb) = pair.both("GET", "/status/device" + query)
    assert js == ts == 200
    jd, td = _device_doc(jb, bases[0]), _device_doc(tb, bases[1])
    assert jd == td
    return td


def test_status_device_equal_with_the_tier_on(tier_pair):
    pair = tier_pair()
    bases = (jdevicetiming.transfer_report(), devicetiming.transfer_report())
    _loaded(pair)
    _searches(pair)
    _searches(pair)
    _admit_now()
    _searches(pair)
    _searches(pair)
    (_, _, jb), (_, _, tb) = pair.both("GET", "/status/device")
    jd, td = _device_doc(jb, bases[0]), _device_doc(tb, bases[1])
    assert jd == td
    assert td["residentTier"]["enabled"] and td["residentTier"]["residentPages"]
    assert td["pageHeat"]["totalShips"] > 0 and td["whatIf"]["curve"]
    assert td["transfer"]["byKernel"]["device_tier_admit"]["h2d"] > 0
    assert sum(td["transfer"]["avoidedByKernel"].values()) > 0
    for query in ("?top=3", "?budgets_mb=0.01,1,64", "?budgets_mb=2&top=0"):
        _same_device_page(pair, query)


@pytest.mark.parametrize("query", ["?budgets_mb=x", "?budgets_mb=-1", "?budgets_mb=0",
                                   "?budgets_mb=inf", "?budgets_mb=,", "?top=x"])
def test_status_device_bad_requests_400(tier_pair, query):
    pair = tier_pair()
    assert pair.same("GET", "/status/device" + query)[0] == 400


def test_page_heat_recorded_with_the_tier_off(tier_pair):
    """The ledger records every query-path page access with the tier
    off too, as the reference's does, and /status/device says so."""
    pair = tier_pair(budget_mb=0)
    assert _tiers() == (None, None)
    _loaded(pair)
    _searches(pair)
    for q in SIMPLE_COUNT[:2]:
        pair.same("GET", "/api/metrics/query_range"
                  + qs(q=q, start=T0 - 60, end=T0 + 600, step=60), norm=norm_query)
    doc = _same_device_page(pair)
    assert doc["residentTier"] == {"enabled": False}
    assert doc["pageHeat"]["totalShips"] > 0 and doc["pageHeat"]["hotSet"]


def test_simple_count_query_range_from_resident_stacks(tier_pair):
    """The compiled tier's stacks: shipped twice (the heat), admitted at
    the third dispatch, served from the card at the fourth; the matrices
    equal throughout."""
    pair = tier_pair()
    _loaded(pair)
    bases = (jdevicetiming.transfer_report(), devicetiming.transfer_report())
    answers = {}

    def ask():
        for q in SIMPLE_COUNT:
            path = "/api/metrics/query_range" + qs(q=q, start=T0 - 60, end=T0 + 600, step=60)
            status, body = pair.same("GET", path, norm=norm_query)
            assert status == 200 and json.loads(body)["data"]["result"]
            # the matrix is the same on every ask; the read counters fall
            # as the caches and the tier warm
            data = norm_query(body)["data"]
            assert answers.setdefault(q, data) == data

    ask()
    ask()
    _admit_now()
    ask()  # the admitting dispatches
    admitted = _same_tier()
    ask()  # from the resident stacks
    served = _same_tier()
    assert served["hits"] > admitted["hits"]
    avoided = [r["avoidedByKernel"].get("compiled_metrics", 0) - b["avoidedByKernel"].get(
        "compiled_metrics", 0) for r, b in zip((jdevicetiming.transfer_report(),
                                                devicetiming.transfer_report()), bases)]
    assert avoided[0] == avoided[1] > 0
    stacks = [p for p in colcache.shared_device_tier().resident_pages(top=500)
              if p["codec"] == "compiled_stack"]
    assert stacks


@pytest.mark.parametrize("how", ["config", "env"])
def test_ingest_tail_starts_on_the_apps_device(tmp_path, monkeypatch, how):
    cfg = AppConfig(db=DBConfig(backend="local", backend_path=str(tmp_path / "b"),
                                wal_path=str(tmp_path / "w")), generator_enabled=False)
    if how == "config":
        cfg.device_tier = DeviceTierConfig(budget_mb=64, ingest_tail_budget_mb=8)
    else:
        monkeypatch.setenv("TEMPO_TPU_DEVICE_TIER_MB", "64")
        monkeypatch.setenv("TEMPO_TPU_INGEST_TAIL_MB", "8")
    app = App(cfg, device="cpu")
    try:
        tier = colcache.shared_device_tier()
        assert tier.ingest_tail_budget_bytes == 8 << 20 and tier.device == app.device
        app.push_traces(synth.make_traces(8, seed=3, spans_per_trace=4))
        for ing in app.ingesters.values():
            for inst in ing.instances.values():
                inst.cut_complete_traces(immediate=True)
        st = tier.stats()
        assert st["tail_entries"] == 1 and 0 < st["tail_bytes"] <= 8 << 20
        (row,) = [r for r in colcache.device_tier_report()["residentPages"]
                  if r.get("keyspace") == "ingest_tail"]
        assert row["codec"] == "tail" and row["tenant"] == "single-tenant"
    finally:
        app.shutdown()


def test_env_switch_starts_a_tier_on_the_apps_device(tmp_path, monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_DEVICE_TIER_MB", "16")
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=str(tmp_path / "b"),
                                    wal_path=str(tmp_path / "w"))), device="cpu")
    try:
        tier = colcache.shared_device_tier()
        assert tier.budget_bytes == 16 << 20 and tier.device.type == "cpu"
        assert colcache.device_tier_report()["enabled"]
    finally:
        app.shutdown()
