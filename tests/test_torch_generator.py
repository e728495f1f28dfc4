"""The port's metrics-generator against the JAX package's.

The span-metrics and service-graphs processors take the same batches in
both packages (the port's sketches on the CPU: the plain versions of
the hll_update and cm_update kernels) and give the same registry
samples, timestamps aside (the registry stamps its collect with the
wall clock), the same pairing-store counts and the same HLL and
count-min state. hll_update and cm_update are held against the JAX
jits at p in {4, 12, 18} with `valid` and weights; Ring.shuffle_shard
picks the same instances; the distributor's tee sends each generator of
a tenant's shard the same rows; and the two Apps of
tests/test_torch_app.py's AppPair, taking the same OTLP pushes, hold
equal generator series. Tolerance is exact: counts and bucket counts are
integer sums and the float sums add the same float64 values in the same
order; the cardinality estimate agrees to float32 rounding, as
tests/test_torch_ops.py holds it. The `cuda` cases hold each sketch
kernel against its plain version on the card.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.modules.distributor import Distributor as JDistributor
from tempo_tpu.modules.generator import Generator as JGenerator
from tempo_tpu.modules.generator.registry import ManagedRegistry as JRegistry
from tempo_tpu.modules.generator.servicegraphs import ServiceGraphsProcessor as JServiceGraphs
from tempo_tpu.modules.generator.spanmetrics import SpanMetricsProcessor as JSpanMetrics
from tempo_tpu.modules.overrides import Limits as JLimits, Overrides as JOverrides
from tempo_tpu.modules.ring import MemoryKV as JMemoryKV, Ring as JRing
from tempo_tpu.model import synth as jsynth
from tempo_tpu.ops import sketch as jsketch
from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.trace import batch_to_traces
from tempo_tpu_torch.modules.distributor import Distributor
from tempo_tpu_torch.modules.generator import DEFAULT_PROCESSORS, Generator
from tempo_tpu_torch.modules.generator.registry import ManagedRegistry
from tempo_tpu_torch.modules.generator.servicegraphs import ServiceGraphsProcessor
from tempo_tpu_torch.modules.generator.spanmetrics import SpanMetricsProcessor
from tempo_tpu_torch.modules.overrides import Limits, Overrides
from tempo_tpu_torch.modules.ring import MemoryKV, Ring
from tempo_tpu_torch.ops import sketch
from tempo_tpu_torch.receivers import otlp

from test_torch_app import AppPair

T0_NS = 1_700_000_000 * 10**9


def _samples(samples) -> list:
    """Registry samples as comparable tuples, without the collect's
    timestamp."""
    out = []
    for s in samples:
        ex = None if s.exemplar is None else s.exemplar.to_dict()
        out.append((s.name, s.labels, s.value, ex))
    return sorted(out, key=repr)


def _batches(seed: int, n: int = 3, graph: bool = True):
    """(JAX batches, port batches) of the same draws."""
    if graph:
        mk = [(jsynth.make_graph_batch, synth.make_graph_batch, dict(error_rate=0.2))]
    else:
        mk = [(jsynth.make_batch, synth.make_batch, {})]
    jmk, tmk, kw = mk[0]
    args = [(60, 8, dict(seed=seed * 100 + i, base_time_ns=T0_NS + i * 60 * 10**9, **kw))
            for i in range(n)]
    return [jmk(a, b, **k) for a, b, k in args], [tmk(a, b, **k) for a, b, k in args]


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("graph", [True, False], ids=["graph-batch", "batch"])
def test_spanmetrics_equal(seed, graph):
    jreg, treg = JRegistry("t"), ManagedRegistry("t")
    jp, tp = JSpanMetrics(jreg), SpanMetricsProcessor(treg)
    for jb, tb in zip(*_batches(seed, graph=graph)):
        assert jb.nbytes() == tb.nbytes()
        jp.push(jb)
        tp.push(tb)
    assert jp.spans_processed == tp.spans_processed
    assert _samples(jreg.collect()) == _samples(treg.collect())
    assert jreg.active_series() == treg.active_series()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("store", [(10.0, 10_000), (0.5, 7)], ids=["defaults", "tight-store"])
def test_servicegraphs_equal(seed, store):
    """Pairing, expiry and eviction, edge series and the sketches: the
    pushes come in halves (servers before their clients and the other
    way round), so both stores hold spans across pushes."""
    wait_s, max_items = store
    jreg, treg = JRegistry("t"), ManagedRegistry("t")
    jp = JServiceGraphs(jreg, wait_s=wait_s, max_items=max_items)
    tp = ServiceGraphsProcessor(treg, wait_s=wait_s, max_items=max_items, device="cpu")
    now = 1000.0
    for jb, tb in zip(*_batches(seed)):
        n = tb.num_spans
        order = np.random.default_rng(seed).permutation(n)
        for rows in (order[: n // 2], order[n // 2:]):
            jp.push(jb.select(np.sort(rows)), now=now)
            tp.push(tb.select(np.sort(rows)), now=now)
            now += 0.3
    assert (jp.edges_emitted, jp.expired) == (tp.edges_emitted, tp.expired)
    assert jp.edges_emitted > 0
    assert len(jp.pending_clients) == len(tp.pending_clients)
    assert len(jp.pending_servers) == len(tp.pending_servers)
    assert _samples(jreg.collect()) == _samples(treg.collect())
    assert np.array_equal(np.asarray(jp.hll).astype(np.int64), tp.hll.numpy())
    assert np.array_equal(np.asarray(jp.cm).astype(np.int64), tp.cm.numpy())
    np.testing.assert_allclose(tp.distinct_edges_estimate(), jp.distinct_edges_estimate(),
                               rtol=1e-6)


def test_failed_sketch_fold_is_not_refolded(monkeypatch):
    """A push whose sketch fold raises loses that push's sketch update;
    the next push folds only its own edge keys, so count-min counts no
    edge twice."""
    _, (tb0, tb1, _) = _batches(3)
    tp = ServiceGraphsProcessor(ManagedRegistry("t"), device="cpu")
    real = sketch.hll_update

    def failing(*args, **kw):
        raise RuntimeError("hll_update failed")

    monkeypatch.setattr(sketch, "hll_update", failing)
    with pytest.raises(RuntimeError, match="hll_update failed"):
        tp.push(tb0, now=1000.0)
    assert tp._edge_keys == [] and int(tp.cm.sum()) == 0
    monkeypatch.setattr(sketch, "hll_update", real)
    before = tp.edges_emitted
    tp.push(tb1, now=1000.5)
    # each emitted edge adds one to one cell of each of the CMPlan's rows
    assert int(tp.cm.sum()) == (tp.edges_emitted - before) * sketch.CMPlan().depth > 0


def test_generator_tenants_and_text_equal():
    """Generator over two tenants, pushed as serialized segments (the
    distributor's tee) and as batches: the same samples and Prometheus
    text, timestamps aside."""
    jg = JGenerator(JOverrides(JLimits()))
    tg = Generator(Overrides(Limits()), device="cpu")
    assert [type(p).__name__ for p in tg.instance("a").processors] == \
        ["SpanMetricsProcessor", "ServiceGraphsProcessor"]
    assert DEFAULT_PROCESSORS == ("span-metrics", "service-graphs")
    jbs, tbs = _batches(3)
    for i, (jb, tb) in enumerate(zip(jbs, tbs)):
        tenant = "ab"[i % 2]
        jg.push_batch(tenant, jb)
        tg.push_segment(tenant, fmt.serialize_batch(tb))
    for tenant in "ab":
        assert _samples(jg.collect(tenant)) == _samples(tg.collect(tenant))

    def text(g):
        return sorted(line.rsplit(" # ", 1)[0] for line in g.prometheus_text().splitlines())
    assert text(jg) == text(tg) and text(tg)


def test_generator_limits_equal():
    """An active-series cap and a processor list from the overrides."""
    lim = dict(metrics_generator_max_active_series=10,
               metrics_generator_processors=("service-graphs",))
    jg = JGenerator(JOverrides(JLimits(**lim)))
    tg = Generator(Overrides(Limits(**lim)), device="cpu")
    for jb, tb in zip(*_batches(4)):
        jg.push_batch("t", jb)
        tg.push_batch("t", tb)
    jr, tr = jg.instance("t").registry, tg.instance("t").registry
    assert jr.series_dropped == tr.series_dropped > 0
    assert _samples(jg.collect("t")) == _samples(tg.collect("t"))
    assert len(tg.instance("t").processors) == 1


# ---------------------------------------------------------------------------
# the sketch updates against the JAX jits
# ---------------------------------------------------------------------------


def _keys(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (n, 4), np.uint32)
    x[n // 2:] = x[: n - n // 2]  # repeated keys
    return x


@pytest.mark.parametrize("precision", [4, 12, 18])
@pytest.mark.parametrize("masked", [False, True])
def test_hll_state_equal(precision, masked):
    jp, p = jsketch.HLLPlan(precision), sketch.HLLPlan(precision)
    regs_j, regs_t = jsketch.hll_init(jp), sketch.hll_init(p, "cpu")
    for i in range(3):
        k = _keys(5000, precision * 10 + i)
        valid = np.random.default_rng(i).random(len(k)) > 0.3 if masked else None
        regs_j = jsketch.hll_update(regs_j, jnp.asarray(k), jp,
                                    valid=None if valid is None else jnp.asarray(valid))
        regs_t = sketch.hll_update(regs_t, torch.from_numpy(k.view(np.int32)), p,
                                   valid=None if valid is None else torch.from_numpy(valid))
    assert np.array_equal(np.asarray(regs_j).astype(np.int64), regs_t.numpy())
    np.testing.assert_allclose(float(sketch.hll_estimate(regs_t, p)),
                               float(jsketch.hll_estimate(regs_j, jp)), rtol=1e-6)


@pytest.mark.parametrize("plan", [(4, 1 << 12), (2, 1 << 4), (8, 1 << 13)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cm_state_equal(plan, weighted, masked):
    jp, p = jsketch.CMPlan(*plan), sketch.CMPlan(*plan)
    counts_j, counts_t = jsketch.cm_init(jp), sketch.cm_init(p, "cpu")
    for i in range(3):
        k = _keys(4000, i)
        rng = np.random.default_rng(100 + i)
        w = rng.integers(0, 2**32, len(k), dtype=np.uint32) if weighted else None
        valid = rng.random(len(k)) > 0.25 if masked else None
        counts_j = jsketch.cm_update(counts_j, jnp.asarray(k), jp,
                                     weights=None if w is None else jnp.asarray(w),
                                     valid=None if valid is None else jnp.asarray(valid))
        counts_t = sketch.cm_update(counts_t, torch.from_numpy(k.view(np.int32)), p,
                                    weights=None if w is None else torch.from_numpy(w.view(np.int32)),
                                    valid=None if valid is None else torch.from_numpy(valid))
    assert np.array_equal(np.asarray(counts_j).astype(np.int64), counts_t.numpy())


# ---------------------------------------------------------------------------
# shuffle sharding and the distributor's tee
# ---------------------------------------------------------------------------


def _rings(ids):
    jr, tr = JRing(JMemoryKV()), Ring(MemoryKV())
    for i, iid in enumerate(ids):
        jr.register(iid, seed=i)
        tr.register(iid, seed=i)
    return jr, tr


@pytest.mark.parametrize("size", [0, 1, 2, 3, 5, 9])
def test_shuffle_shard_equal(size):
    jr, tr = _rings([f"generator-{i}" for i in range(5)])
    for tenant in ("single-tenant", "acme", "globex", "x" * 40):
        want = [i.instance_id for i in jr.shuffle_shard(tenant, size)]
        assert [i.instance_id for i in tr.shuffle_shard(tenant, size)] == want
        assert len(want) == (5 if size <= 0 or size >= 5 else size)


class _Recorder:
    """An ingester or generator client that keeps what it was sent."""

    def __init__(self):
        self.got = []

    def push_segment(self, tenant, data):
        self.got.append((tenant, fmt.deserialize_batch(data).cols["span_id"].copy()))


@pytest.mark.parametrize("ring_size", [0, 1, 2, 3])
def test_distributor_tee_equal(ring_size):
    """The tee sends each generator of the tenant's shard (of
    metrics_generator_ring_size instances) the rows whose trace token
    falls to it, after the ingester write."""
    lim = dict(metrics_generator_ring_size=ring_size)
    gen_ids = [f"generator-{i}" for i in range(4)]
    (jring, tring), (jgring, tgring) = _rings(["ingester-0"]), _rings(gen_ids)
    sent = []
    for Dist, ring, gring, overrides in ((JDistributor, jring, jgring, JOverrides(JLimits(**lim))),
                                         (Distributor, tring, tgring, Overrides(Limits(**lim)))):
        ing = {"ingester-0": _Recorder()}
        gens = {iid: _Recorder() for iid in gen_ids}
        d = Dist(ring, ingester_clients=ing, overrides=overrides,
                 generator_ring=gring, generator_clients=gens)
        # tenant names of no other test file: the reference's distributor
        # charges process-wide usage counters per tenant
        for tenant, seed in (("tee-a", 1), ("tee-b", 2)):
            d.push_batch(tenant, synth.make_graph_batch(50, 4, seed=seed))
        sent.append({k: [(t, s.tolist()) for t, s in g.got] for k, g in gens.items()})
        assert sum(len(s) for _, s in ing["ingester-0"].got) == 400
        assert sum(len(s) for g in gens.values() for _, s in g.got) == 400
    assert sent[0] == sent[1]


# ---------------------------------------------------------------------------
# the two Apps
# ---------------------------------------------------------------------------

PB = {"Content-Type": "application/x-protobuf"}


@pytest.fixture
def gen_pair(tmp_path):
    pair = AppPair(tmp_path)
    yield pair
    pair.close()


def test_app_generator_series_equal(gen_pair):
    pair = gen_pair
    assert pair.japp.generator is not None and pair.tapp.generator is not None
    assert pair.tapp.generator.device == torch.device("cpu")
    for i in range(4):
        b = (synth.make_graph_batch(48, 8, seed=700 + i, error_rate=0.2) if i % 2 == 0
             else synth.make_batch(48, 6, seed=700 + i))
        assert pair.same("POST", "/v1/traces", otlp.encode_traces_request(batch_to_traces(b)),
                         PB)[0] == 200
    tenant = "single-tenant"
    jg, tg = pair.japp.generator, pair.tapp.generator
    assert _samples(jg.collect(tenant)) == _samples(tg.collect(tenant))
    names = {s.name for s in tg.collect(tenant)}
    assert "traces_spanmetrics_calls_total" in names
    assert "traces_service_graph_request_total" in names
    jsg, tsg = jg.instance(tenant).processors[1], tg.instance(tenant).processors[1]
    assert np.array_equal(np.asarray(jsg.hll).astype(np.int64), tsg.hll.numpy())
    assert np.array_equal(np.asarray(jsg.cm).astype(np.int64), tsg.cm.numpy())
    np.testing.assert_allclose(tsg.distinct_edges_estimate(), jsg.distinct_edges_estimate(),
                               rtol=1e-6)
    # the generator's ring page lists generator-0 on both
    status, body = pair.same("GET", "/metrics-generator/ring",
                             norm=lambda b: [{k: v for k, v in i.items() if k != "heartbeat_age_s"}
                                             for i in json.loads(b)["instances"]])
    assert status == 200 and b'"generator-0"' in body


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [4, 12, 14, 15, 18])
@pytest.mark.parametrize("n", [1, 64, 4096, (1 << 20) + 3])
@pytest.mark.parametrize("form", ["int32", "int64", "int32-offset", "masked"])
def test_hll_kernel_equals_plain(precision, n, form):
    dev = _cuda()
    p = sketch.HLLPlan(precision)
    rng = np.random.default_rng(n + precision)
    k = rng.integers(0, 2**32, (n + 1, 4), np.uint32)
    k[:4] = [[0] * 4, [0xFFFFFFFF] * 4, [0, 0xFFFFFFFF] * 2, [0xFFFFFFFF, 0] * 2][: min(4, n + 1)]
    keys = (torch.from_numpy(k.astype(np.int64)) if form == "int64"
            else torch.from_numpy(k.view(np.int32)))
    keys = keys[1:] if form == "int32-offset" else keys[:n]
    valid = torch.from_numpy(rng.random(n) > 0.4) if form == "masked" else None
    start = torch.from_numpy(rng.integers(0, 20, p.m)).to(torch.int64)
    want = sketch.hll_update(start, keys, p, valid=valid)
    before = sketch.hll_update.launches
    got = sketch.hll_update(start.to(dev), keys.to(dev), p,
                            valid=None if valid is None else valid.to(dev))
    torch.cuda.synchronize()
    assert sketch.hll_update.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(4, 1 << 12), (1, 1 << 4), (4, 1 << 14), (8, 1 << 13)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("n", [1, 64, 4096, (1 << 20) + 3])
@pytest.mark.parametrize("form", ["int32", "int64", "weighted", "masked-weighted"])
def test_cm_kernel_equals_plain(plan, n, form):
    dev = _cuda()
    p = sketch.CMPlan(*plan)
    rng = np.random.default_rng(n + plan[1])
    k = rng.integers(0, 2**32, (n, 4), np.uint32)
    k[n // 2:] = k[: n - n // 2]
    keys = torch.from_numpy(k.astype(np.int64)) if form == "int64" \
        else torch.from_numpy(k.view(np.int32))
    w = (torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).astype(np.int64))
         if "weighted" in form else None)  # sums wrap mod 2**32
    valid = torch.from_numpy(rng.random(n) > 0.3) if "masked" in form else None
    start = torch.from_numpy(rng.integers(0, 2**32, (p.depth, p.width), dtype=np.int64))
    want = sketch.cm_update(start, keys, p, weights=w, valid=valid)
    got = sketch.cm_update(start.to(dev), keys.to(dev), p,
                           weights=None if w is None else w.to(dev),
                           valid=None if valid is None else valid.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_service_graphs_on_the_card_equal_cpu():
    dev = _cuda()
    reg_c, reg_h = ManagedRegistry("t"), ManagedRegistry("t")
    pc = ServiceGraphsProcessor(reg_c, device=dev)
    ph = ServiceGraphsProcessor(reg_h, device="cpu")
    before = (sketch.hll_update.launches, sketch.cm_update.launches)
    for i in range(3):
        b = synth.make_graph_batch(512, 8, seed=40 + i)
        pc.push(b, now=10.0 + i)
        ph.push(b, now=10.0 + i)
    assert (sketch.hll_update.launches, sketch.cm_update.launches) == \
        (before[0] + 3, before[1] + 3)
    assert torch.equal(pc.hll.cpu(), ph.hll) and torch.equal(pc.cm.cpu(), ph.cm)
    assert pc.distinct_edges_estimate() == ph.distinct_edges_estimate()
    assert _samples(reg_c.collect()) == _samples(reg_h.collect())
