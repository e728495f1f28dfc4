"""The port's four device-timing families against the JAX package's.

tempo_tpu_device_dispatch_seconds{kernel} (histogram),
tempo_tpu_device_dispatches_total{kernel},
tempo_tpu_device_transfer_bytes_total{direction,kernel} and
tempo_tpu_device_transfer_bytes_avoided_total{kernel} must appear on
/metrics of a port App from boot with the reference's names, HELP,
TYPE, buckets and label names, and after the same workload (pushes, a
flush, query_range over the flushed block) with the same label names.
Each family moves in the statement that updates STATS and charges the
cost vector: the per-tenant transfer_bytes sum exactly to h2d + d2h,
and every series equals its STATS entry."""

import re
import urllib.request

import numpy as np
import pytest
import torch

from tempo_tpu.api.server import TempoServer as JServer
from tempo_tpu.app import App as JApp, AppConfig as JAppConfig
from tempo_tpu.db import DBConfig as JDBConfig
from tempo_tpu.model import synth as jsynth
from tempo_tpu.util import devicetiming as jdt
from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.util import devicetiming as dt
from tempo_tpu_torch.util import metrics, usage

FAMILIES = ("tempo_tpu_device_dispatch_seconds", "tempo_tpu_device_dispatches_total",
            "tempo_tpu_device_transfer_bytes_total",
            "tempo_tpu_device_transfer_bytes_avoided_total")
SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def families(text: str) -> dict:
    """family -> {"help", "type", "labels": set of label-name tuples,
    "le": sorted bucket bounds, "series": {labels: value}}."""
    out = {f: {"help": None, "type": None, "labels": set(), "le": set(), "series": {}}
           for f in FAMILIES}
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            _, kind, name, rest = line.split(" ", 3)
            if name in out:
                out[name][kind.lower()] = rest
            continue
        m = SAMPLE.match(line)
        if not m:
            continue
        name, labelstr, value = m.groups()
        fam = next((f for f in FAMILIES
                    if name in (f, f + "_bucket", f + "_sum", f + "_count")), None)
        if fam is None:
            continue
        labels = dict(LABEL.findall(labelstr or ""))
        if "le" in labels:
            out[fam]["le"].add(labels.pop("le"))
        if labels:
            out[fam]["labels"].add(tuple(sorted(labels)))
        if name == fam:
            out[fam]["series"][tuple(sorted(labels.items()))] = float(value)
    return out


def scrape(url: str) -> str:
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        return r.read().decode()


@pytest.fixture
def servers(tmp_path):
    """A port App on the CPU and a reference App, each behind its server."""
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=str(tmp_path / "p" / "blocks"),
                                    wal_path=str(tmp_path / "p" / "wal"))), device="cpu")
    japp = JApp(JAppConfig(db=JDBConfig(backend="local",
                                        backend_path=str(tmp_path / "j" / "blocks"),
                                        wal_path=str(tmp_path / "j" / "wal"),
                                        compaction_device_shards=1)))
    srv = TempoServer(app, host="127.0.0.1", port=0).start()
    jsrv = JServer(japp, host="127.0.0.1", port=0).start()
    yield (app, f"http://127.0.0.1:{srv.port}"), (japp, f"http://127.0.0.1:{jsrv.port}")
    for s, a in ((srv, app), (jsrv, japp)):
        s.stop()
        a.shutdown()


def test_families_on_metrics_from_boot(servers):
    """Before any dispatch: the same HELP and TYPE lines for all four."""
    (_, url), (_, jurl) = servers
    got, want = families(scrape(url)), families(scrape(jurl))
    for f in FAMILIES:
        assert got[f]["help"] is not None, f
        assert (got[f]["help"], got[f]["type"]) == (want[f]["help"], want[f]["type"]), f
    assert got["tempo_tpu_device_dispatch_seconds"]["type"] == "histogram"


def test_families_after_the_same_workload(servers):
    """Pushes, a flush and query_range in both Apps: the same label names
    and histogram buckets, and every port series equal to STATS."""
    (app, url), (japp, jurl) = servers
    traces = synth.make_traces(30, seed=4)
    app.push_traces(traces)
    japp.push_traces(jsynth.make_traces(30, seed=4))
    for a in (app, japp):
        a.sweep_all(immediate=True)
        a.db.poll_now()
    q = ("/api/metrics/query_range?q=%7B%20%7D%20%7C%20rate()%20by%20(resource.service.name)"
         "&start=1699999000&end=1700003600&step=60")
    for u in (url, jurl):
        with urllib.request.urlopen(u + q, timeout=120) as r:
            assert r.status == 200
    dt.timed_dispatch("parity_probe", lambda: None, device=torch.device("cpu"))
    jdt.timed_dispatch("parity_probe", lambda: None)
    for mod in (dt, jdt):
        mod.count_transfer("parity_probe", h2d=64, d2h=8, resident=32)
        mod.count_avoided("parity_probe", 128)
    got, want = families(scrape(url)), families(scrape(jurl))
    for f in FAMILIES:
        assert got[f]["labels"] == want[f]["labels"], f
        assert got[f]["le"] == want[f]["le"], f
    hist = got["tempo_tpu_device_dispatch_seconds"]
    assert len(hist["le"]) == 15 and "+Inf" in hist["le"]
    assert got["tempo_tpu_device_transfer_bytes_total"]["labels"] == {("direction", "kernel")}
    for fam, stat in (("tempo_tpu_device_dispatches_total", dt.STATS.dispatches),
                      ("tempo_tpu_device_transfer_bytes_avoided_total", dt.STATS.avoided)):
        series = {dict(k)["kernel"]: v for k, v in got[fam]["series"].items() if k}
        assert series == {k: float(v) for k, v in stat.items()}, fam
    tb = got["tempo_tpu_device_transfer_bytes_total"]["series"]
    for direction in ("h2d", "d2h", "resident"):
        series = {dict(k)["kernel"]: v for k, v in tb.items() if dict(k).get("direction") == direction}
        assert series == {k: float(v) for k, v in getattr(dt.STATS, direction).items()}
    probe = (("direction", "h2d"), ("kernel", "parity_probe"))
    assert tb[probe] == want["tempo_tpu_device_transfer_bytes_total"]["series"][probe] >= 64


@pytest.mark.parametrize("h2d,d2h,resident", [(1000, 24, 5000), (0, 0, 7), (5, 0, 0), (0, 9, 0)])
def test_exactness_contract(h2d, d2h, resident):
    """count_transfer moves the h2d/d2h series and the active vector's
    transfer_bytes together; resident and avoided bytes are no charge."""
    kernel = f"parity_exact_{h2d}_{d2h}_{resident}"
    before = dt.moved_total()
    jbefore = jdt.moved_total()
    with usage.collect() as vec:
        dt.count_transfer(kernel, h2d=h2d, d2h=d2h, resident=resident)
        dt.count_avoided(kernel, 777)
        dt.timed_dispatch(kernel, lambda: np.zeros(3), device=torch.device("cpu"))
    jdt.count_transfer(kernel, h2d=h2d, d2h=d2h, resident=resident)
    assert dt.moved_total() - before == h2d + d2h == jdt.moved_total() - jbefore
    snap = vec.snapshot()
    assert snap.get("transfer_bytes", 0) == h2d + d2h and snap["device_dispatches"] == 1
    rep = dt.transfer_report()
    assert rep["byKernel"][kernel] == {"h2d": h2d, "d2h": d2h, "resident": resident}
    assert rep["byKernel"][kernel] == jdt.transfer_report()["byKernel"][kernel]
    assert rep["avoidedByKernel"][kernel] == 777
    assert rep["totals"]["moved"] == rep["totals"]["h2d"] + rep["totals"]["d2h"]
    assert rep["totals"]["avoided"] == dt.avoided_total()
    assert sorted(rep) == sorted(jdt.transfer_report())
    assert metrics.REGISTRY.get("tempo_tpu_device_dispatches_total").total(
        kernel=kernel) == dt.STATS.dispatches[kernel] == 1


def test_per_tenant_vectors_sum_to_moved():
    """Charges settled under two tenants sum to the untagged delta."""
    before = dt.moved_total()
    seen = {}
    for tenant, n in (("t-a", 100), ("t-b", 28)):
        b0 = usage.usage_report(tenant)
        with usage.attribute(tenant, "query_range"):
            dt.count_transfer("parity_tenant", h2d=n, d2h=n // 4)
        doc = usage.usage_report(tenant)
        seen[tenant] = (doc, b0)
    assert dt.moved_total() - before == 160
    total = 0
    for doc, b0 in seen.values():
        def tb(d):
            return sum(v.get("transfer_bytes", 0) for t in d.get("tenants", {}).values()
                       for v in t.get("kinds", {}).values())
        total += tb(doc) - tb(b0)
    assert total == 160
