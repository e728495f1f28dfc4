"""The port's trace-graph plane against the JAX package's.

ops/graph (parent rank-join, self times, the root path sums' host arm,
the plain torch version of the doubling kernel, the critical path), the
graph wires (dependency and critical-path partials, merges, finalizers),
the walk sampler and the served routes /api/graph/dependencies,
/api/graph/critical-path and /api/graph/walks, each fed the same inputs
in both packages, built with numpy from a seed. The JAX device arm
(`_root_sums_limbs`, two uint32 limbs with a carry) runs jitted on the
CPU. Tolerance is exact: every sum is a uint64 or an integer count, and
the documents derive from them by the same float arithmetic.

The served routes are asked of the two Apps of tests/test_torch_app.py's
AppPair (the port on the CPU, its host arm) over the same OTLP pushes,
before and after /flush (graph_recent, then graph_blocks); the documents
compare field for field, their wall-clock stats (stageSeconds,
deviceDispatches, elapsedMs) and byte counts aside. The `cuda` cases hold
the root_path_sums kernel against its plain version on the card.
"""

import json
import urllib.parse

import numpy as np
import pytest
import torch

from tempo_tpu import graph as jgraph
from tempo_tpu.graph import walks as jwalks
from tempo_tpu.model import synth as jsynth
from tempo_tpu.model.columnar import trace_segmentation as jtrace_segmentation
from tempo_tpu.ops import graph as jops_graph
from tempo_tpu_torch import graph as tgraph
from tempo_tpu_torch.graph import walks as twalks
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.columnar import trace_segmentation
from tempo_tpu_torch.model.trace import batch_to_traces
from tempo_tpu_torch.ops import graph as ops_graph
from tempo_tpu_torch.receivers import otlp

from test_torch_app import AppPair

SEEDS = [0, 1, 2]


def _graph_rows(seed: int, n_traces: int = 120, spans: int = 9):
    """(JAX batch, port batch, parent rows, seg, firsts, durations) of one
    make_graph_batch draw, some durations past 32 bits."""
    jb = jsynth.make_graph_batch(n_traces, spans, seed=seed)
    tb = synth.make_graph_batch(n_traces, spans, seed=seed)
    rng = np.random.default_rng(seed)
    dur = tb.cols["duration_nano"].copy()
    dur[rng.integers(0, len(dur), 40)] += np.uint64(2**40)
    _, seg, firsts = trace_segmentation(tb.cols["trace_id"])
    pr = ops_graph.parent_row_join(seg, tb.cols["span_id"], tb.cols["parent_span_id"])
    return jb, tb, pr, seg, firsts, dur


def _jax_limbs(parent: np.ndarray, self_ns: np.ndarray) -> np.ndarray:
    """The reference's jitted device arm, run on the CPU."""
    s = self_ns.astype(np.uint64)
    hi = (s >> np.uint64(32)).astype(np.uint32)
    lo = (s & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out_hi, out_lo = jops_graph._root_sums_limbs(
        parent.astype(np.int32), hi, lo, rounds=jops_graph._n_rounds(len(parent)))
    return (np.asarray(out_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(out_lo)


def _plain(parent: np.ndarray, self_ns: np.ndarray) -> np.ndarray:
    """The port's plain version of the kernel, on the CPU."""
    out = ops_graph.root_path_sums(torch.from_numpy(parent.astype(np.int32)),
                                   torch.from_numpy(self_ns.astype(np.uint64).view(np.int64)))
    return out.numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# ops/graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_make_graph_batch_equal(seed):
    jb = jsynth.make_graph_batch(40, 8, seed=seed, error_rate=0.25)
    tb = synth.make_graph_batch(40, 8, seed=seed, error_rate=0.25)
    assert list(jb.dictionary) == list(tb.dictionary)
    for k in jb.cols:
        assert np.array_equal(jb.cols[k], tb.cols[k]), k
    for k in jb.attrs:
        assert np.array_equal(jb.attrs[k], tb.attrs[k]), k


@pytest.mark.parametrize("seed", SEEDS)
def test_join_self_times_and_root_sums_equal(seed):
    jb, tb, pr, seg, firsts, dur = _graph_rows(seed)
    _, jseg, jfirsts = jtrace_segmentation(jb.cols["trace_id"])
    assert np.array_equal(seg, jseg) and np.array_equal(firsts, jfirsts)
    jpr = jops_graph.parent_row_join(jseg, jb.cols["span_id"], jb.cols["parent_span_id"])
    assert np.array_equal(pr, jpr)
    self_ns = ops_graph.self_times_ns(pr, dur)
    assert np.array_equal(self_ns, jops_graph.self_times_ns(jpr, dur))
    want = jops_graph.root_path_sums_host(jpr, self_ns)
    assert np.array_equal(ops_graph.root_path_sums_host(pr, self_ns), want)
    assert np.array_equal(_plain(pr, self_ns), want)
    assert np.array_equal(_jax_limbs(pr, self_ns), want)


def test_parent_row_join_duplicates_and_self_parents():
    """Duplicate span ids resolve to the last row, a self-parenting span
    to a root, as in the reference."""
    rng = np.random.default_rng(5)
    seg = np.repeat(np.arange(40), 12)
    sid = rng.integers(1, 40, size=(len(seg), 2)).astype(np.uint32)
    par = rng.integers(0, 40, size=(len(seg), 2)).astype(np.uint32)
    assert np.array_equal(ops_graph.parent_row_join(seg, sid, par),
                          jops_graph.parent_row_join(seg, sid, par))
    assert len(ops_graph.parent_row_join(np.zeros(0, np.int64), sid[:0], par[:0])) == 0


# parent arrays that are no forest: a two-cycle, a self-loop, a longer
# cycle with a tail hanging off it, beside a plain chain
_CYCLES = np.array([-1, 0, 1, 2, 5, 4, 6, 9, 7, 8, 9], np.int64)


@pytest.mark.parametrize("wrap", [False, True], ids=["small", "u64-wrap"])
def test_root_sums_cycles_and_wrap_equal(wrap):
    """Every arm runs its rounds to the end over cycles (the host arm's
    early exit never fires) and adds mod 2**64."""
    rng = np.random.default_rng(7)
    s = rng.integers(1, 1000, len(_CYCLES)).astype(np.uint64)
    if wrap:
        s = s + np.uint64(2**63) + np.uint64(2**62)
    want = jops_graph.root_path_sums_host(_CYCLES, s)
    assert np.array_equal(ops_graph.root_path_sums_host(_CYCLES, s), want)
    assert np.array_equal(_plain(_CYCLES, s), want)
    assert np.array_equal(_jax_limbs(_CYCLES, s), want)
    if wrap:
        assert (want < s).any()  # a sum did wrap


def test_root_sums_rounds_and_empty():
    parent = np.arange(-1, 99, dtype=np.int64)  # one chain of 100
    s = np.arange(1, 101, dtype=np.uint64)
    full = jops_graph.root_path_sums_host(parent, s)
    assert np.array_equal(_plain(parent, s), full)
    # fewer rounds cover distances below 2**rounds only
    two = ops_graph.root_path_sums(torch.from_numpy(parent.astype(np.int32)),
                                   torch.from_numpy(s.view(np.int64)), rounds=2)
    assert two.numpy()[10] == int(s[7:11].sum())
    empty = ops_graph.root_path_sums(torch.zeros(0, dtype=torch.int32),
                                     torch.zeros(0, dtype=torch.int64))
    assert empty.shape == (0,)
    assert len(ops_graph.root_path_sums_device(np.zeros(0, np.int64), np.zeros(0, np.uint64),
                                               "cpu")) == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("arm", ["host", "torch"])
def test_critical_path_equal(seed, arm, monkeypatch):
    """The port's host arm and its torch arm (root_path_sums_device on
    the CPU: the plain version) against the reference's host and limb
    arms."""
    monkeypatch.delenv("TEMPO_TPU_GRAPH_DEVICE", raising=False)
    if arm == "torch":
        monkeypatch.setattr(ops_graph, "_arm", lambda device: torch.device(device))
    jb, tb, pr, seg, firsts, dur = _graph_rows(seed)
    got = ops_graph.critical_path(pr, dur, seg, firsts, device="cpu")
    for jdev in (False, True):
        want = jops_graph.critical_path(pr, dur, seg, firsts, device=jdev)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_critical_path_cycle_terminates():
    seg = np.zeros(2, np.int64)
    sid = np.array([[0, 1], [0, 2]], np.uint32)
    par = np.array([[0, 2], [0, 1]], np.uint32)  # 0 <-> 1 cycle
    pr = ops_graph.parent_row_join(seg, sid, par)
    dur = np.array([10, 10], np.uint64)
    got = ops_graph.critical_path(pr, dur, seg, np.array([0]), device="cpu")
    want = jops_graph.critical_path(pr, dur, seg, np.array([0]), device=False)
    assert got[1].any() and all(np.array_equal(g, w) for g, w in zip(got, want))


def test_graph_arm_follows_device(monkeypatch):
    """The arm follows the caller's device; TEMPO_TPU_GRAPH_DEVICE=0
    forces the host arm, and no other value moves the work."""
    monkeypatch.delenv("TEMPO_TPU_GRAPH_DEVICE", raising=False)
    assert ops_graph._arm(None) is None and ops_graph._arm("cpu") is None
    assert ops_graph._arm("cuda") == torch.device("cuda")
    monkeypatch.setenv("TEMPO_TPU_GRAPH_DEVICE", "0")
    assert ops_graph._arm("cuda") is None
    monkeypatch.setenv("TEMPO_TPU_GRAPH_DEVICE", "1")
    assert ops_graph._arm("cpu") is None and ops_graph._arm(None) is None
    assert ops_graph._arm("cuda") == torch.device("cuda")


# ---------------------------------------------------------------------------
# wires, finalizers, walks
# ---------------------------------------------------------------------------


def _cols(batch, graph_mod) -> dict:
    return {c: batch.cols[c] for c in graph_mod.GRAPH_COLUMNS}


@pytest.mark.parametrize("seed", SEEDS)
def test_deps_wires_equal(seed):
    parts = [(jsynth.make_graph_batch(60, 8, seed=seed * 10 + i, error_rate=0.3),
              synth.make_graph_batch(60, 8, seed=seed * 10 + i, error_rate=0.3))
             for i in range(3)]
    jw, tw = jgraph.new_deps_wire(), tgraph.new_deps_wire()
    for jb, tb in parts:
        jsub = jgraph.deps_partial(_cols(jb, jgraph), jb.dictionary)
        tsub = tgraph.deps_partial(_cols(tb, tgraph), tb.dictionary)
        assert jsub == tsub
        jgraph.merge_deps_wire(jw, jsub)
        tgraph.merge_deps_wire(tw, tsub)
    assert jw == tw and tw["edges"]
    assert jgraph.finalize_deps(jw) == tgraph.finalize_deps(tw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("by", ["service", "name"])
def test_cp_wires_equal(seed, by):
    jw, tw = jgraph.new_cp_wire(by), tgraph.new_cp_wire(by)
    for i in range(3):
        jb = jsynth.make_graph_batch(50, 7, seed=seed * 10 + i)
        tb = synth.make_graph_batch(50, 7, seed=seed * 10 + i)
        jsub = jgraph.cp_partial(_cols(jb, jgraph), jb.dictionary, by=by, device=False)
        tsub = tgraph.cp_partial(_cols(tb, tgraph), tb.dictionary, by=by, device="cpu")
        assert jsub == tsub
        jgraph.merge_cp_wire(jw, jsub)
        tgraph.merge_cp_wire(tw, tsub)
    assert jw == tw and jgraph.finalize_cp(jw) == tgraph.finalize_cp(tw)
    with pytest.raises(ValueError, match="unknown critical-path grouping"):
        tgraph.cp_partial(_cols(tb, tgraph), tb.dictionary, by="kind")


@pytest.mark.parametrize("q", ["", "{}", '{ resource.service.name = "cart" }',
                               "{ status = error }", "{ duration > 50ms }",
                               "{} | rate()", "{} | by(name)"])
def test_root_filter_and_batch_rows_equal(q):
    """parse_root_filter's verdicts, then batch_graph_rows over a batch
    (trace selection by filter and window) in both packages."""
    try:
        jp = jgraph.parse_root_filter(q)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tgraph.parse_root_filter(q)
        assert str(te.value) == str(e)
        return
    tp = tgraph.parse_root_filter(q)
    assert (jp is None) == (tp is None)
    jb = jsynth.make_graph_batch(80, 6, seed=4, error_rate=0.2)
    tb = synth.make_graph_batch(80, 6, seed=4, error_rate=0.2)
    t0 = 1_700_000_000
    for window in ((0, 0), (t0, t0 + 1), (t0 + 5, 0)):
        jr = jgraph.batch_graph_rows(jb, jp, *window)
        tr = tgraph.batch_graph_rows(tb, tp, *window)
        assert (jr is None) == (tr is None)
        if jr is not None:
            assert all(np.array_equal(jr[c], tr[c]) for c in jgraph.GRAPH_COLUMNS)


def test_edge_helpers_equal():
    for a, b in (("frontend", "cart"), ("x" * 300, "y"), ("", "")):
        assert np.array_equal(jgraph.edge_hash_limbs(a, b), tgraph.edge_hash_limbs(a, b))
    codes = np.array([0, 1, 2, 2, 0])
    assert np.array_equal(jgraph.spans_failed(codes), tgraph.spans_failed(codes))
    assert [tgraph.span_failed(c) for c in (0, 1, 2)] == [False, False, True]


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=42, walks=20, steps=5), dict(seed=3, window_s=10),
    dict(seed=9, start="cart"), dict(seed=1, walks=0),
])
def test_walks_equal(kw):
    b = synth.make_graph_batch(200, 8, seed=21)
    wire = tgraph.deps_partial(_cols(b, tgraph), b.dictionary)
    want = jwalks.sample_walks(wire["edges"], **kw)
    got = twalks.sample_walks(wire["edges"], **kw)
    assert got == want
    assert twalks.rank_suspects(got, exclude=("cart",), top=3) == \
        jwalks.rank_suspects(want, exclude=("cart",), top=3)
    with pytest.raises(ValueError, match="no outgoing edges"):
        twalks.sample_walks(wire["edges"], start="nowhere")


# ---------------------------------------------------------------------------
# the served routes, both Apps
# ---------------------------------------------------------------------------

PB = {"Content-Type": "application/x-protobuf"}
VOLATILE = ("stageSeconds", "deviceDispatches", "elapsedMs", "inspectedBytes", "decodedBytes")


def _norm(raw: bytes) -> dict:
    doc = json.loads(raw)
    stats = doc.get("stats") or {}
    doc["stats"] = {k: v for k, v in stats.items() if k not in VOLATILE}
    return doc


GRAPH_ROUTES = [
    "/api/graph/dependencies",
    "/api/graph/dependencies?" + urllib.parse.urlencode({"q": '{ resource.service.name = "cart" }'}),
    "/api/graph/critical-path",
    "/api/graph/critical-path?by=name",
    "/api/graph/critical-path?" + urllib.parse.urlencode({"q": "{ status = error }", "by": "name"}),
    "/api/graph/walks?seed=7",
    "/api/graph/walks?seed=3&walks=50&steps=4&window=1",
    "/api/graph/walks?from=checkout&seed=1",
]


@pytest.fixture
def graph_pair(tmp_path):
    pair = AppPair(tmp_path)
    yield pair
    pair.close()


def test_graph_routes_equal(graph_pair):
    pair = graph_pair
    for i in range(3):
        b = synth.make_graph_batch(40, 8, seed=300 + i, error_rate=0.2)
        body = otlp.encode_traces_request(batch_to_traces(b))
        assert pair.same("POST", "/v1/traces", body, PB)[0] == 200
    docs = {}
    for flushed in (False, True):
        if flushed:
            assert pair.same("POST", "/flush")[0] == 204
        for path in GRAPH_ROUTES:
            status, raw = pair.same("GET", path, norm=_norm)
            assert status == 200, path
            docs[path, flushed] = _norm(raw)
    deps = docs["/api/graph/dependencies", True]
    assert deps["status"] == "success" and deps["edges"]
    assert docs["/api/graph/critical-path", True]["traces"] == 120
    assert docs["/api/graph/walks?seed=7", True]["walks"]
    # the same edges whether the spans are live or at rest
    assert deps["edges"] == docs["/api/graph/dependencies", False]["edges"]


@pytest.mark.parametrize("path", [
    "/api/graph/dependencies?q=" + urllib.parse.quote("{} | rate()"),
    "/api/graph/critical-path?by=kind",
    "/api/graph/walks?walks=5000",
    "/api/graph/walks?steps=0",
    "/api/graph/walks?from=nowhere",
])
def test_graph_client_errors_equal(graph_pair, path):
    b = synth.make_graph_batch(10, 6, seed=5)
    graph_pair.same("POST", "/v1/traces", otlp.encode_traces_request(batch_to_traces(b)), PB)
    assert graph_pair.same("GET", path)[0] == 400


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _forest(kind: str, n: int, rng) -> np.ndarray:
    """Parent rows: chains of `depth`, a forest with roots scattered
    through it, or a forest with parent cycles."""
    if kind.startswith("chains"):
        depth = int(kind.split("-")[1])
        row = np.arange(n)
        return np.where(row % depth == 0, -1, row - 1)
    parent = np.where(rng.random(n) < 0.05, -1, rng.integers(0, n, n))
    parent = np.where(parent >= np.arange(n), -1, parent)  # parents earlier: a forest
    if kind == "cycles":
        k = rng.choice(n, min(n, 64), replace=False)
        parent[k] = k[::-1]
    return parent


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["chains-8", "chains-2048", "forest", "cycles"])
@pytest.mark.parametrize("n", [1, 7, 1 << 16, (1 << 21) - 3])
def test_root_path_sums_kernel_equals_plain(kind, n):
    dev = _cuda()
    rng = np.random.default_rng(n)
    parent = _forest(kind, n, rng).astype(np.int32)
    s = rng.integers(0, 2**63, n, dtype=np.int64)  # sums wrap mod 2**64
    p_d, s_d = torch.from_numpy(parent).to(dev), torch.from_numpy(s).to(dev)
    before = ops_graph.root_path_sums.launches
    got = ops_graph.root_path_sums(p_d, s_d)
    torch.cuda.synchronize()
    assert ops_graph.root_path_sums.launches == before + 1
    want = ops_graph.root_path_sums(torch.from_numpy(parent), torch.from_numpy(s))
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(ops_graph.root_path_sums_device(parent, s.view(np.uint64), dev),
                          want.numpy().view(np.uint64))


@pytest.mark.cuda
def test_critical_path_card_equals_host():
    dev = _cuda()
    tb = synth.make_graph_batch(4096, 9, seed=11)
    wire_card = tgraph.cp_partial(_cols(tb, tgraph), tb.dictionary, device=dev)
    wire_host = tgraph.cp_partial(_cols(tb, tgraph), tb.dictionary, device="cpu")
    assert wire_card == wire_host
