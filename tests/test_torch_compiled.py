"""The port's compiled query tier against the JAX package's.

Mirrors tests/test_compiled.py on both packages: the same seeded blocks
are written by the JAX package's TempoDB and by the port's
TempoDB(device="cpu") under the same block IDs, and every simple-count
query_range is answered by four paths whose series must be equal: each
package's compiled tier and each package's interpreter. The tier's
economy (literal or window swaps rebuild nothing, batched lanes share one
dispatch), its declines (legacy entropy blocks, unlowerable shapes), the
shape cache's governor and LRU behaviour and the config section are held
to the reference's too, count for count.

Then the kernels' arithmetic: dbp_decode_limbs against the JAX
_dbp_decode_jit, and the fused program's plain version against the JAX
build_metrics_program on the same stacked inputs (rle/dct/dbp mixes,
inverted and empty sets, t_s < start, bins past n_bins). The `cuda` tests
hold the two kernels (dbp_decode, compiled_metrics) against those plain
versions on the card and skip here. Tolerance: exact equality
everywhere; every count is an integer sum.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu import compiled as jcompiled
from tempo_tpu.compiled import cache as jcache
from tempo_tpu.compiled.program import build_metrics_program as jbuild_program
from tempo_tpu.config import check_config as jcheck_config, parse_config as jparse_config
from tempo_tpu.metrics_engine import (
    HostAccumulator as JHostAccumulator,
    compile_metrics_plan as jcompile_plan,
    evaluate_block as jevaluate_block,
)
from tempo_tpu.modules.querier import Querier as JQuerier
from tempo_tpu.ops import pallas_kernels as jpk
from tempo_tpu.util import devicetiming as jdevicetiming
from tempo_tpu_torch import compiled
from tempo_tpu_torch.compiled import cache as cache_mod
from tempo_tpu_torch.compiled import executor, program
from tempo_tpu_torch.config import check_config, parse_config
from tempo_tpu_torch.encoding.vtpu import lightweight as lw
from tempo_tpu_torch.metrics_engine import (
    HostAccumulator,
    compile_metrics_plan,
    evaluate_block,
    merge_wire,
    new_wire,
)
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.modules.querier import Querier
from tempo_tpu_torch.ops import pallas_kernels as tpk
from tempo_tpu_torch.util import devicetiming

from test_torch_db import DBPair

BASE_S = 1_700_000_000

QUERIES = [
    "{} | rate()",
    "{} | count_over_time()",
    "{ resource.service.name = `cart` } | rate()",
    "{ resource.service.name != `cart` } | rate()",
    "{ resource.service.name =~ `c.*` } | rate()",
    "{ resource.service.name !~ `c.*` } | rate()",
    "{ resource.service.name = `no-such-svc` } | rate()",
    "{ duration > 1ms } | rate()",
    "{ duration >= 1000000 } | rate()",
    "{ duration < 2ms } | count_over_time()",
    "{ duration <= 5000000 } | rate()",
    "{ resource.service.name = `cart` && duration > 100us } | rate()",
]


def _plans(q, start=BASE_S, end=BASE_S + 60, step=10):
    return (jcompile_plan(q, start, end, step), compile_metrics_plan(q, start, end, step))


def _write_corpus(pair, seed):
    """Trace-shaped blocks give dct service + dbp duration; one block
    sorted by service gives rle (long runs survive the trace sort)."""
    for i in range(3):
        ts = synth.make_traces(40, seed=seed + i, spans_per_trace=4)
        pair.write_traces("t", ts)
    b = synth.make_batch(400, 8, seed=seed + 50)
    b.cols["service"] = np.sort(b.cols["service"].copy())
    pair.write("t", b.sorted_by_trace())


def _metas(pair):
    jm = sorted(pair.j.blocklist.metas("t"), key=lambda m: str(m.block_id))
    tm = sorted(pair.t.blocklist.metas("t"), key=lambda m: str(m.block_id))
    assert [str(m.block_id) for m in jm] == [str(m.block_id) for m in tm]
    return jm, tm


def _interp(db, metas, plan, acc_cls, evaluate):
    """The interpreter reference: per-block evaluate_block folded into
    one accumulator, the querier host path's arithmetic."""
    acc = acc_cls(plan)
    for m in metas:
        blk = db.encoding_for(m.version).open_block(m, db.backend, db.cfg.block)
        acc.stats["inspectedBlocks"] += 1
        evaluate(plan, blk, acc)
    return acc.to_wire()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    pair = DBPair(tmp_path_factory.mktemp("compiled"), block={"row_group_spans": 1 << 15})
    _write_corpus(pair, seed=100)
    return pair


@pytest.fixture
def fresh_cache(monkeypatch):
    """A private ShapeCache in each package, so per-test hit/miss/compile
    accounting starts from zero on both."""
    jc, tc = jcache.ShapeCache(), cache_mod.ShapeCache()
    monkeypatch.setattr(jcache, "_shared", jc)
    monkeypatch.setattr(cache_mod, "_shared", tc)
    return jc, tc


def _dispatches():
    return (jdevicetiming.dispatch_total.total(kernel="compiled_metrics"),
            devicetiming.STATS.dispatches.get("compiled_metrics", 0))


# ---------------------------------------------------------------------------
# 1. bit identity: compiled == interpreter, on both packages
# ---------------------------------------------------------------------------


def test_corpus_spans_all_three_codecs(corpus):
    jm, tm = _metas(corpus)
    seen = []
    for db, metas in ((corpus.j, jm), (corpus.t, tm)):
        got = []
        for m in metas:
            blk = db.encoding_for(m.version).open_block(m, db.backend, db.cfg.block)
            for rg in blk.index().row_groups:
                for col in ("service", "duration_nano"):
                    enc = blk.encoded_column(rg, col)
                    payload = enc.resident_payload() if enc else None
                    got.append(None if payload is None else payload[0])
        seen.append(got)
    assert seen[0] == seen[1]
    assert {"rle", "dct", "dbp"} <= set(seen[1])


@pytest.mark.parametrize("q", QUERIES)
def test_compiled_matches_interpreter(corpus, fresh_cache, q):
    jm, tm = _metas(corpus)
    jplan, tplan = _plans(q)
    jref = _interp(corpus.j, jm, jplan, JHostAccumulator, jevaluate_block)
    tref = _interp(corpus.t, tm, tplan, HostAccumulator, evaluate_block)
    jgot = jcompiled.try_query_range(corpus.j, "t", jplan, jm)
    tgot = compiled.try_query_range(corpus.t, "t", tplan, tm)
    assert tgot is not None and jgot is not None, f"expected {q!r} to lower"
    assert tgot.pop("compiledShape") == jgot.pop("compiledShape") == "miss"
    assert tgot["series"] == jgot["series"] == tref["series"] == jref["series"]
    for k in ("inspectedBlocks", "inspectedSpans", "prunedRowGroups"):
        assert tgot["stats"][k] == jgot["stats"][k] == tref["stats"][k], k
    assert tgot["stats"] == jgot["stats"]
    assert tref["series"] or "no-such" in q or "!~" in q


def test_kill_switch_is_bit_identical_end_to_end(corpus, fresh_cache, monkeypatch):
    """TEMPO_TPU_COMPILED=0 through the querier job path: the same series
    on both packages, only the compiledShape verdict differs."""
    jm, tm = _metas(corpus)
    ids = [str(m.block_id) for m in tm]
    q = "{ resource.service.name = `cart` } | rate()"
    out = {}
    for name, qr in (("jax", JQuerier(corpus.j)), ("port", Querier(corpus.t))):
        monkeypatch.delenv("TEMPO_TPU_COMPILED", raising=False)
        on = qr.query_range_blocks("t", ids, q, BASE_S, BASE_S + 60, 10)
        monkeypatch.setenv("TEMPO_TPU_COMPILED", "0")
        off = qr.query_range_blocks("t", ids, q, BASE_S, BASE_S + 60, 10)
        assert on.pop("compiledShape") == "miss"
        assert off.pop("compiledShape") == "fallback"
        assert on["series"] == off["series"] and on["series"]
        out[name] = on["series"]
    assert out["jax"] == out["port"]


def test_legacy_entropy_blocks_fall_back_bit_identically(tmp_path, fresh_cache, monkeypatch):
    """Blocks written entirely on the entropy tier bind no unit: the
    executor's per-row-group interpreter answers, with no fused
    dispatch, on both packages."""
    monkeypatch.setenv("TEMPO_TPU_LIGHTWEIGHT", "0")
    pair = DBPair(tmp_path, block={"row_group_spans": 1 << 15})
    for i in range(2):
        pair.write_traces("t", synth.make_traces(40, seed=300 + i, spans_per_trace=4))
    jm, tm = _metas(pair)
    jplan, tplan = _plans("{ resource.service.name = `cart` } | rate()")
    tref = _interp(pair.t, tm, tplan, HostAccumulator, evaluate_block)
    d0 = _dispatches()
    jgot = jcompiled.try_query_range(pair.j, "t", jplan, jm)
    tgot = compiled.try_query_range(pair.t, "t", tplan, tm)
    assert _dispatches() == d0  # nothing bound, nothing launched
    assert tgot.pop("compiledShape") == jgot.pop("compiledShape") == "miss"
    assert tgot["series"] == jgot["series"] == tref["series"]


# ---------------------------------------------------------------------------
# 2. shard invariance: partition + merge == one shot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_merge_invariance(corpus, fresh_cache, n_shards):
    _, tm = _metas(corpus)
    _, plan = _plans("{ duration > 100us } | rate()")
    whole = compiled.try_query_range(corpus.t, "t", plan, tm)
    one_shot = new_wire()
    merge_wire(one_shot, whole, plan)
    merged = new_wire()
    for s in range(n_shards):
        w = compiled.try_query_range(corpus.t, "t", plan, tm[s::n_shards])
        assert w is not None
        merge_wire(merged, w, plan)
    assert merged["series"] == one_shot["series"] and whole["series"]


# ---------------------------------------------------------------------------
# 3. economy: literal swaps rebuild nothing; N queries, one dispatch
# ---------------------------------------------------------------------------


def test_literal_and_window_swap_hit_without_rebuild(corpus, fresh_cache):
    jm, tm = _metas(corpus)
    jc, tc = fresh_cache
    verdicts = []
    for q, start in (("{ resource.service.name = `cart` } | rate()", BASE_S),
                     ("{ resource.service.name = `frontend` } | rate()", BASE_S + 10)):
        jplan, tplan = _plans(q, start=start, end=start + 60)
        jw = jcompiled.try_query_range(corpus.j, "t", jplan, jm)
        tw = compiled.try_query_range(corpus.t, "t", tplan, tm)
        verdicts.append((jw["compiledShape"], tw["compiledShape"]))
        assert jw["series"] == tw["series"]
    assert verdicts == [("miss", "miss"), ("hit", "hit")]
    assert tc.stats() == jc.stats()
    assert tc.stats()["compiles"] >= 1 and tc.stats()["shapes"] == 1


def test_unlowerable_shape_is_remembered(corpus, fresh_cache):
    jm, tm = _metas(corpus)
    jc, tc = fresh_cache
    q = "{ span.http.status_code >= 500 } | rate()"  # int attribute: no
    for _ in range(2):
        jplan, tplan = _plans(q)
        assert jcompiled.try_query_range(corpus.j, "t", jplan, jm) is None
        assert compiled.try_query_range(corpus.t, "t", tplan, tm) is None
    assert tc.stats() == jc.stats()
    assert tc.stats()["misses"] == 1 and tc.stats()["hits"] == 1


def test_batched_queries_share_one_dispatch(corpus, fresh_cache):
    """3 same-shape lanes cost the dispatches of 1, on both packages."""
    jm, tm = _metas(corpus)
    jplan, tplan = _plans("{ resource.service.name = `cart` } | rate()")
    d0 = _dispatches()
    jref = jcompiled.try_query_range(corpus.j, "t", jplan, jm)
    tref = compiled.try_query_range(corpus.t, "t", tplan, tm)
    d1 = _dispatches()
    per_query = (d1[0] - d0[0], d1[1] - d0[1])
    assert per_query[0] == per_query[1] and 1 <= per_query[1] <= 2  # one a codec group
    qs = ["{ resource.service.name = `%s` } | rate()" % s for s in ("cart", "checkout", "frontend")]
    pairs = [_plans(q) for q in qs]
    jwires = jcompiled.try_query_range_many(corpus.j, "t", [p[0] for p in pairs], jm)
    twires = compiled.try_query_range_many(corpus.t, "t", [p[1] for p in pairs], tm)
    d2 = _dispatches()
    assert (d2[0] - d1[0], d2[1] - d1[1]) == per_query  # 3 lanes, one stacked dispatch
    assert twires[0]["series"] == tref["series"] == jref["series"]
    for (_, tplan_i), jw, tw in zip(pairs, jwires, twires):
        assert tw["series"] == jw["series"]
        assert tw["series"] == _interp(corpus.t, tm, tplan_i, HostAccumulator,
                                       evaluate_block)["series"]
        assert tw["compiledShape"] == jw["compiledShape"]


def test_batched_multi_matches_sequential(corpus, fresh_cache):
    jm, tm = _metas(corpus)
    ids = [str(m.block_id) for m in tm]
    qs = ["{ resource.service.name = `cart` } | rate()",
          "{ duration > 1ms } | rate()",
          "{ span.http.status_code >= 500 } | rate()"]  # mixed lanes
    jmany = JQuerier(corpus.j).query_range_blocks_multi("t", ids, qs, BASE_S, BASE_S + 60, 10)
    qr = Querier(corpus.t)
    tmany = qr.query_range_blocks_multi("t", ids, qs, BASE_S, BASE_S + 60, 10)
    assert [w["compiledShape"] for w in tmany] == [w["compiledShape"] for w in jmany]
    for q, jw, tw in zip(qs, jmany, tmany):
        one = qr.query_range_blocks("t", ids, q, BASE_S, BASE_S + 60, 10)
        assert tw["series"] == one["series"] == jw["series"]


# ---------------------------------------------------------------------------
# 4. safety: governor sheds, LRU cap, config section
# ---------------------------------------------------------------------------


class _Gov:
    def __init__(self, lvl=0):
        self.lvl = lvl

    def level(self):
        return self.lvl


def _loaded(mod, **kw):
    gov = _Gov()
    c = mod.ShapeCache(governor=gov, **kw)
    for i in range(8):
        c.store(f"shape-{i}", lowerable=True)
    c.program(("sig", 0), lambda sig: object())
    c.program(("sig", 1), lambda sig: object())
    return gov, c


def _both(fn):
    """fn(cache module) on both packages; their results must be equal."""
    out = [fn(jcache), fn(cache_mod)]
    assert out[0] == out[1]
    return out[1]


def test_pressure_drops_programs_first():
    def run(mod):
        gov, c = _loaded(mod)
        gov.lvl = 1
        n = c.shed()
        s = c.stats()
        c.program(("sig", 0), lambda sig: object())
        return n, s, c.stats()

    n, s, after = _both(run)
    assert s["programs"] == 0 and s["shapes"] == 2 and n == s["evictions"] == 8
    assert after["compiles"] == 3


def test_critical_clears_everything():
    def run(mod):
        gov, c = _loaded(mod)
        gov.lvl = 2
        c.shed()
        return c.stats()

    s = _both(run)
    assert s["programs"] == 0 and s["shapes"] == 0


def test_respect_governor_false_detaches():
    def run(mod):
        gov, c = _loaded(mod, respect_governor=False)
        gov.lvl = 2
        return c.shed(), c.stats()

    n, s = _both(run)
    assert n == 0 and s["programs"] == 2 and s["shapes"] == 8


def test_lru_cap_evicts_oldest_shape():
    def run(mod):
        c = mod.ShapeCache(max_shapes=2, governor=_Gov())
        for i in range(3):
            c.store(f"shape-{i}", lowerable=True)
        entry, hit = c.lookup("shape-0")
        return entry is None, hit, c.lookup("shape-2")[1], c.stats()

    gone, hit, kept, s = _both(run)
    assert gone and not hit and kept and s["evictions"] == 1


@pytest.mark.parametrize("yaml_text,warns", [
    ("multitenancy_enabled: true\n", True),
    ("multitenancy_enabled: true\ncompiled:\n  max_shapes: 512\n", False),
    ("multitenancy_enabled: true\ncompiled:\n  enabled: false\n", False),
])
def test_config_warnings(yaml_text, warns):
    # the reference also warns about its standing engine, on by default
    # there and not ported here: only the compiled tier's warnings compare
    jw = [w for w in jcheck_config(jparse_config(yaml_text)) if "compiled" in w]
    tw = check_config(parse_config(yaml_text))
    assert jw == tw
    assert any("compiled.max_shapes" in w for w in tw) == warns


def test_config_section_round_trips():
    text = "compiled:\n  enabled: true\n  max_shapes: 64\n  respect_governor: false\n"
    j, t = jparse_config(text), parse_config(text)
    assert t.app.compiled.max_shapes == j.app.compiled.max_shapes == 64
    assert t.app.compiled.respect_governor is j.app.compiled.respect_governor is False


def test_default_enabled_and_env_kill_switch(monkeypatch):
    assert parse_config("").app.compiled.enabled is True
    monkeypatch.setenv("TEMPO_TPU_COMPILED", "0")
    assert cache_mod.enabled() is False and jcache.enabled() is False


# ---------------------------------------------------------------------------
# 5. the kernels' arithmetic: plain versions against the JAX programs
# ---------------------------------------------------------------------------


def _dbp_case(rng, n, width_hint):
    """A uint64 column whose dbp page has one sub-column; its payload in
    the executor's form (words, first, width)."""
    step = {0: 0, 1: 1, 31: 1 << 29, 32: 1 << 30}.get(width_hint, 1000)
    deltas = rng.integers(-step, step + 1, n - 1) if step else np.zeros(n - 1, np.int64)
    col = (np.uint64(1 << 40) + np.concatenate([[0], np.cumsum(deltas)]).astype(np.int64)
           .astype(np.uint64))
    first, _anchors, widths, streams, m = lw.dbp_parts(lw.dbp_encode(col), col.dtype.str, col.shape)
    raw = bytes(streams[0])
    words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4")
    return col, words, int(first[0]), int(widths[0])


@pytest.mark.parametrize("n,width_hint", [(2, 5), (3, 1), (9, 0), (257, 31), (300, 32), (1000, 12)])
def test_dbp_decode_limbs_equals_jax(n, width_hint):
    rng = np.random.default_rng(n)
    col, words, first, width = _dbp_case(rng, n, width_hint)
    wp = executor._dbp_words_needed(n, width) + 1
    padded = np.zeros(max(wp, len(words)), np.uint32)
    padded[: len(words)] = words
    hi, lo = jpk.dbp_decode_limbs(jnp.asarray(padded), jnp.uint32(first >> 32),
                                  jnp.uint32(first & 0xFFFFFFFF), jnp.int32(width), n)
    ref = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    got = tpk.dbp_decode_limbs(torch.from_numpy(padded.view(np.int32))[None],
                               torch.tensor([first], dtype=torch.uint64).view(torch.int64),
                               torch.tensor([width], dtype=torch.int32), n)
    assert np.array_equal(got[0].numpy().view(np.uint64), ref)
    assert np.array_equal(ref, col)


def _random_units(rng, codecs, n_units=5, max_rows=300):
    """Units of random rows: rle runs, dct dictionaries with indices, dbp
    words of a uint64 column, and epoch seconds around BASE_S."""
    units = []
    for _ in range(n_units):
        n = int(rng.integers(2, max_rows))
        cols = []
        for codec in codecs:
            if codec == "rle":
                cuts = np.sort(rng.choice(np.arange(1, n), size=min(n - 1, int(rng.integers(0, 12))),
                                          replace=False))
                lengths = np.diff(np.concatenate([[0], cuts, [n]])).astype(np.int32)
                values = rng.integers(0, 6, len(lengths)).astype(np.uint32)
                cols.append(("rle", {"values": values, "lengths": lengths}, {"n": n}))
            elif codec == "dct":
                d = int(rng.integers(1, 9))
                values = np.sort(rng.choice(np.arange(20, dtype=np.uint32), d, replace=False))
                idx = rng.integers(0, d, n).astype(np.int32)
                cols.append(("dct", {"values": values, "idx": idx}, {"n": n}))
            else:
                col, words, first, width = _dbp_case(rng, n, int(rng.choice([0, 1, 12, 31])))
                cols.append(("dbp", {"words": words}, {"n": n, "first": first, "width": width}))
        t_s = (BASE_S - 20 + rng.integers(0, 120, n)).astype(np.uint32)
        units.append(executor._Unit(n, t_s, cols, ()))
    return units


MIXES = [
    ("rle",), ("dct",), ("dbp",), ("rle", "dct"), ("dct", "dbp"), ("rle", "dct", "dbp"),
    ("rle", "rle"),
]


@pytest.mark.parametrize("codecs", MIXES, ids=lambda c: "+".join(c))
def test_program_plain_equals_jax(codecs):
    """The fused program's plain version against the JAX program on the
    same stacked units: set columns with an inverted set, an empty set
    (NO_MATCH) and a plain one per lane; range columns with a hit-all,
    an empty and a narrow range; windows that start after some rows and
    end before others."""
    rng = np.random.default_rng(len(codecs) * 7 + len(MIXES[0]))
    units = _random_units(rng, codecs)
    n_pad = executor._pow2(max(u.n for u in units))
    colsig = tuple(("set", f"c{i}", False) if c != "dbp" else ("range", f"c{i}")
                   for i, c in enumerate(codecs))
    t_s, valid, payloads, pads = executor._stack_group(units, colsig, n_pad)
    q = 3
    tb = np.array([[BASE_S, 10], [BASE_S + 30, 7], [BASE_S - 100, 60]], np.uint32)
    nb = np.array([6, 3, 2], np.uint32)
    slot_pad = 8
    jcols, tcols, jq, tq = [], [], [], []
    for i, codec in enumerate(codecs):
        if codec == "dbp":
            lo_hi = [(0, (1 << 64) - 1), (5, 4), ((1 << 40) - 10**6, (1 << 40) + 10**6)]
            b4 = np.array([[lo >> 32, lo & 0xFFFFFFFF, hi >> 32, hi & 0xFFFFFFFF]
                           for lo, hi in lo_hi], np.uint32)
            jq.append(b4)
            tq.append(np.array(lo_hi, np.uint64))
            jcols.append(("dbp", "range", False, pads[i]))
            tcols.append(("dbp", "range", False, pads[i]))
        else:
            invert = i % 2 == 0
            sets = [np.array([1, 3], np.uint32), np.array([0xFFFFFFFF], np.uint32),
                    np.array([2, 4, 5, 21], np.uint32)]
            codes = np.stack([np.stack([s] * len(units)) for s in
                              [np.resize(x, 4) for x in sets]])  # (Q, U, 4) by repeats
            jq.append(codes)
            tq.append(codes)
            jcols.append((codec, "set", invert, 4))
            tcols.append((codec, "set", invert, 4))
    jpay = []
    for p, codec in zip(payloads, codecs):
        if codec == "dbp":
            words, first, width = p
            jpay.append((jnp.asarray(words), jnp.asarray((first >> np.uint64(32)).astype(np.uint32)),
                         jnp.asarray((first & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                         jnp.asarray(width)))
        else:
            jpay.append(tuple(jnp.asarray(a) for a in p))
    jprog = jbuild_program((tuple(jcols), n_pad, slot_pad, q))
    ref = np.asarray(jprog(jnp.asarray(t_s), jnp.asarray(valid), tuple(jpay),
                           tuple(jnp.asarray(a) for a in jq), jnp.asarray(tb), jnp.asarray(nb)))
    dev = torch.device("cpu")
    got = program.compiled_metrics(
        (tuple(tcols), n_pad, slot_pad, q), executor._tensor(t_s, dev),
        executor._tensor(valid, dev),
        tuple(tuple(executor._tensor(a, dev) for a in p) for p in payloads),
        tuple(executor._tensor(a, dev) for a in tq), executor._tensor(tb, dev),
        executor._tensor(nb, dev))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), ref.astype(np.int64))
    assert ref.sum() > 0


# ---------------------------------------------------------------------------
# 6. on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,width_hint", [(2, 5), (3, 1), (9, 0), (8193, 31), (5000, 32)])
def test_dbp_decode_kernel_equals_plain(n, width_hint):
    dev = _cuda()
    rng = np.random.default_rng(n)
    units = [_dbp_case(rng, n, width_hint) for _ in range(3)]
    wp = max(len(u[1]) for u in units)
    words = np.zeros((3, wp), np.uint32)
    for i, u in enumerate(units):
        words[i, : len(u[1])] = u[1]
    args = (torch.from_numpy(words.view(np.int32)),
            torch.tensor([u[2] for u in units], dtype=torch.uint64).view(torch.int64),
            torch.tensor([u[3] for u in units], dtype=torch.int32))
    before = tpk.dbp_decode_limbs.launches
    got = tpk.dbp_decode_limbs(*(a.to(dev) for a in args), n)
    assert tpk.dbp_decode_limbs.launches == before + 1
    assert torch.equal(got.cpu(), tpk._dbp_decode_plain(*args, n))


@pytest.mark.cuda
@pytest.mark.parametrize("codecs", MIXES, ids=lambda c: "+".join(c))
def test_compiled_metrics_kernel_equals_plain(codecs):
    dev = _cuda()
    rng = np.random.default_rng(11)
    units = _random_units(rng, codecs, n_units=7, max_rows=9000)
    n_pad = executor._pow2(max(u.n for u in units))
    colsig = tuple(("set", f"c{i}", i % 2 == 0) if c != "dbp" else ("range", f"c{i}")
                   for i, c in enumerate(codecs))
    t_s, valid, payloads, pads = executor._stack_group(units, colsig, n_pad)
    cols, qargs = [], []
    for i, codec in enumerate(codecs):
        if codec == "dbp":
            cols.append(("dbp", "range", False, pads[i]))
            qargs.append(np.array([(0, (1 << 64) - 1), ((1 << 40) - 10**5, 1 << 41)], np.uint64))
        else:
            cols.append((codec, "set", colsig[i][2], 2))
            qargs.append(np.stack([np.stack([np.array(s, np.uint32)] * len(units))
                                   for s in ([1, 3], [0xFFFFFFFF, 0xFFFFFFFF])]))
    tb = np.array([[BASE_S, 10], [BASE_S + 30, 7]], np.uint32)
    nb = np.array([6, 3], np.uint32)
    sig = (tuple(cols), n_pad, 8, 2)

    def on(d):
        return (executor._tensor(t_s, d), executor._tensor(valid, d),
                tuple(tuple(executor._tensor(a, d) for a in p) for p in payloads),
                tuple(executor._tensor(a, d) for a in qargs), executor._tensor(tb, d),
                executor._tensor(nb, d))

    before = program.compiled_metrics.launches
    got = program.compiled_metrics(sig, *on(dev))
    assert program.compiled_metrics.launches == before + 1
    assert torch.equal(got.cpu(), program.compiled_metrics(sig, *on(torch.device("cpu"))))


# ---------------------------------------------------------------------------
# 7. the tiled kernels' edges: tile boundaries, long units, carries that
#    wrap, many lanes, one bin, bins past the shared-memory budget, runs
#    across tiles, 64-code sets
# ---------------------------------------------------------------------------

TILE = 2048  # elements a block of dbp_decode and compiled_metrics (kTile in codec_kernels.cu)


def _dbp_words(col):
    """A uint64 column's dbp page of one sub-column as (words, first,
    width), with the one guard word the stream's readers expect."""
    first, _anchors, widths, streams, _n = lw.dbp_parts(lw.dbp_encode(col), col.dtype.str,
                                                        col.shape)
    raw = bytes(streams[0])
    return (np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4"), int(first[0]),
            int(widths[0]))


def _dbp_column(rng, n, width, wrap=False):
    """n uint64 values whose zigzag deltas are exactly `width` bits wide
    (0..32); with wrap (widths 2+), the column climbs through 2^64 halfway."""
    if wrap:  # non-negative deltas below 2^(width-1), one at the top
        deltas = rng.integers(0, 1 << (width - 1), n - 1)
        deltas[0] = (1 << (width - 1)) - 1
        start = np.uint64((1 << 64) - int(deltas.sum()) // 2)
    elif width == 0:
        deltas = np.zeros(n - 1, np.int64)
        start = np.uint64(1 << 40)
    else:
        top = (1 << (width - 1)) - 1
        deltas = rng.integers(-top, top + 1, n - 1) if top else rng.integers(-1, 1, n - 1)
        deltas[0] = -(1 << (width - 1)) if width > 1 else -1
        start = np.uint64(1 << 40)
    with np.errstate(over="ignore"):
        col = start + np.concatenate([[0], np.cumsum(deltas)]).astype(np.int64).astype(np.uint64)
    return col


def _edge_units(rng, codecs, ns, width=12, runs=None, d=8, dom=12, wrap=False):
    """One unit a row count in ns: rle columns of `runs` runs (random
    when None) of values in 0..dom-1, dct dictionaries of d of those
    values, dbp columns of the given delta width; t_s over two minutes
    around BASE_S."""
    units, raw = [], []
    for n in ns:
        cols, vals = [], []
        for codec in codecs:
            if codec == "rle":
                k = min(n, runs if runs is not None else int(rng.integers(1, 40)))
                cuts = np.sort(rng.choice(np.arange(1, n), k - 1, replace=False)) if k > 1 else []
                lengths = np.diff(np.concatenate([[0], cuts, [n]])).astype(np.int32)
                values = rng.integers(0, dom, len(lengths)).astype(np.uint32)
                cols.append(("rle", {"values": values, "lengths": lengths}, {"n": n}))
                vals.append(np.repeat(values, lengths).astype(np.uint64))
            elif codec == "dct":
                values = np.sort(rng.choice(np.arange(dom, dtype=np.uint32), d, replace=False))
                idx = rng.integers(0, d, n).astype(np.int32)
                cols.append(("dct", {"values": values, "idx": idx}, {"n": n}))
                vals.append(values[idx].astype(np.uint64))
            else:
                col = _dbp_column(rng, n, width, wrap)
                words, first, w = _dbp_words(col)
                assert w == width
                cols.append(("dbp", {"words": words}, {"n": n, "first": first, "width": w}))
                vals.append(col)
        t_s = (BASE_S - 20 + rng.integers(0, 120, n)).astype(np.uint32)
        units.append(executor._Unit(n, t_s, cols, ()))
        raw.append((t_s, vals))
    return units, raw


def _edge_program(units, codecs, q, sets, ranges, invert=True):
    """The stacked program inputs of units for q lanes: set columns take
    sets[lane] (K codes, the same for every unit; inverted on every other
    column when invert), range columns ranges[lane]."""
    n_pad = executor._pow2(max(u.n for u in units))
    colsig = tuple(("range", f"c{i}") if c == "dbp" else ("set", f"c{i}", invert and i % 2 == 0)
                   for i, c in enumerate(codecs))
    t_s, valid, payloads, pads = executor._stack_group(units, colsig, n_pad)
    sig_cols, qargs = [], []
    for i, codec in enumerate(codecs):
        if codec == "dbp":
            sig_cols.append(("dbp", "range", False, pads[i]))
            qargs.append(np.array(ranges[:q], np.uint64))
        else:
            k = len(sets[0])
            sig_cols.append((codec, "set", colsig[i][2], k))
            qargs.append(np.stack([np.stack([np.asarray(s, np.uint32)] * len(units))
                                   for s in sets[:q]]))
    return tuple(sig_cols), n_pad, (t_s, valid, payloads, qargs)


def _on(arrays, tb, nb, dev):
    t_s, valid, payloads, qargs = arrays
    return (executor._tensor(t_s, dev), executor._tensor(valid, dev),
            tuple(tuple(executor._tensor(a, dev) for a in p) for p in payloads),
            tuple(executor._tensor(a, dev) for a in qargs), executor._tensor(tb, dev),
            executor._tensor(nb, dev))


def _oracle(raw, codecs, sig_cols, sets, ranges, tb, nb, slot_pad):
    """Counts from the decoded columns, in numpy."""
    q = len(tb)
    want = np.zeros((q, slot_pad), np.int64)
    for ts_u, vals in raw:
        for qq in range(q):
            hit = np.ones(len(ts_u), bool)
            for i, codec in enumerate(codecs):
                if codec == "dbp":
                    lo, hi = ranges[qq]
                    hit &= (vals[i] >= np.uint64(lo)) & (vals[i] <= np.uint64(hi))
                else:
                    hit &= np.isin(vals[i], np.asarray(sets[qq], np.uint64)) != sig_cols[i][2]
            ok = hit & (ts_u >= tb[qq, 0])
            bins = (ts_u.astype(np.int64) - int(tb[qq, 0])) // int(tb[qq, 1])
            ok &= bins < min(int(nb[qq]), slot_pad)
            np.add.at(want[qq], bins[ok], 1)
    return want


_SETS64 = [list(range(0, 128, 2)), [0xFFFFFFFF] * 64, list(range(50, 114)), list(range(64))]
_SETS4 = [[1, 3, 7, 9], [0xFFFFFFFF] * 4, [2, 4, 5, 190], [10, 20, 30, 40]]
_RANGES = [(0, (1 << 64) - 1), (5, 4), ((1 << 40) - 10**6, (1 << 40) + 10**6),
           ((1 << 40) - (1 << 36), 1 << 41)]
# (name, codecs, row counts, dbp width, rle runs, Q, lane sets, windows, n_bins, slot_pad)
_WIN4 = [[BASE_S, 10], [BASE_S + 30, 7], [BASE_S - 100, 60], [BASE_S + 5, 1]]
EDGE_CASES = [
    ("tile-1", ("rle", "dct", "dbp"), [TILE - 1, 5], 12, None, 2, _SETS4, _WIN4, [6, 3], 8),
    ("tile", ("rle", "dct", "dbp"), [TILE, TILE - 3], 31, None, 2, _SETS4, _WIN4, [6, 3], 8),
    ("tile+1", ("rle", "dct", "dbp"), [TILE + 1, 2], 1, None, 2, _SETS4, _WIN4, [6, 3], 8),
    ("tiles", ("dbp", "rle"), [5 * TILE + 17, 3 * TILE, 700], 32, None, 4, _SETS4, _WIN4,
     [6, 3, 2, 100], 128),
    ("width0", ("dbp",), [3 * TILE + 1, TILE], 0, None, 1, _SETS4, _WIN4, [12], 16),
    ("rle-spans", ("rle",), [4 * TILE, 2 * TILE + 9], 12, 3, 4, _SETS4, _WIN4, [6, 3, 2, 100],
     128),
    ("rle-many", ("rle", "dct"), [3 * TILE + 100, TILE], 12, 1500, 2, _SETS4, _WIN4, [6, 3], 8),
    ("codes64", ("rle", "dct", "rle"), [2 * TILE + 3, 900], 12, 50, 4, _SETS64, _WIN4,
     [6, 3, 2, 100], 128),
    ("one-bin", ("dct", "dbp"), [2 * TILE + 3, TILE], 12, None, 1, _SETS4, [[BASE_S - 100, 600]],
     [1], 1),
    ("global-bins", ("rle", "dbp"), [3 * TILE, 333], 12, None, 1, _SETS4, [[BASE_S - 20, 1]],
     [1 << 16], 1 << 16),
    ("no-column", (), [3 * TILE + 5, TILE], 12, None, 4, _SETS4, _WIN4, [6, 3, 2, 100], 128),
]


def _edge_inputs(case, seed=0):
    name, codecs, ns, width, runs, q, sets, wins, n_bins, slot_pad = case
    rng = np.random.default_rng(seed + len(name))
    wide = len(sets[0]) == 64  # 64-code sets over 128 values, else 4 codes over 12
    units, raw = _edge_units(rng, codecs, ns, width=width, runs=runs, d=64 if wide else 8,
                             dom=128 if wide else 12)
    if name == "one-bin":  # every row of every unit in the one bin
        for un, (ts_u, _vals) in zip(units, raw):
            un.t_s[:] = BASE_S
            ts_u[:] = BASE_S
    sig_cols, n_pad, arrays = _edge_program(units, codecs, q, sets, _RANGES)
    tb = np.array(wins[:q], np.uint32)
    nb = np.array(n_bins[:q], np.uint32)
    return raw, codecs, (sig_cols, n_pad, slot_pad, q), arrays, tb, nb, sets[:q]


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: c[0])
def test_program_plain_edge_shapes_equal_oracle(case):
    """The fused program's plain version at the kernels' edge shapes
    against counts taken in numpy from the decoded columns."""
    raw, codecs, sig, arrays, tb, nb, sets = _edge_inputs(case)
    got = program.compiled_metrics(sig, *_on(arrays, tb, nb, torch.device("cpu")))
    want = _oracle(raw, codecs, sig[0], sets, _RANGES, tb, nb, sig[2])
    assert np.array_equal(got.numpy(), want) and want.sum() > 0


@pytest.mark.parametrize("case", [c for c in EDGE_CASES if c[0] in ("one-bin", "global-bins")]
                         + [("q1", ("rle", "dct", "dbp"), [700, 300], 12, None, 1, _SETS4,
                             _WIN4, [6], 8)], ids=lambda c: c[0])
def test_program_plain_equals_jax_edge_shapes(case):
    """The plain version against the JAX program at one bin, one lane and
    a slot_pad above the kernel's shared-memory budget."""
    raw, codecs, sig, arrays, tb, nb, _sets = _edge_inputs(case)
    sig_cols, n_pad, slot_pad, q = sig
    t_s, valid, payloads, qargs = arrays
    jpay, jq = [], []
    for p, qa, codec in zip(payloads, qargs, codecs):
        if codec == "dbp":
            words, first, width = p
            jpay.append((jnp.asarray(words), jnp.asarray((first >> np.uint64(32)).astype(np.uint32)),
                         jnp.asarray((first & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                         jnp.asarray(width)))
            jq.append(np.array([[lo >> 32, lo & 0xFFFFFFFF, hi >> 32, hi & 0xFFFFFFFF]
                                for lo, hi in (tuple(int(x) for x in r) for r in qa)], np.uint32))
        else:
            jpay.append(tuple(jnp.asarray(a) for a in p))
            jq.append(qa)
    jprog = jbuild_program((sig_cols, n_pad, slot_pad, q))
    ref = np.asarray(jprog(jnp.asarray(t_s), jnp.asarray(valid), tuple(jpay),
                           tuple(jnp.asarray(a) for a in jq), jnp.asarray(tb), jnp.asarray(nb)))
    got = program.compiled_metrics(sig, *_on(arrays, tb, nb, torch.device("cpu")))
    assert np.array_equal(got.numpy(), ref.astype(np.int64)) and ref.sum() > 0


def _tile(dev):
    from tempo_tpu_torch.ops import _build

    assert _build.lib().tt_dbp_tile() == TILE
    return dev


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: c[0])
def test_compiled_metrics_kernel_edge_shapes(case):
    """The fused kernel against its plain version, bit for bit, at the
    tile edges, several tiles a unit, Q=4 windows, one bin, the global
    atomic branch, rle runs across tiles and 64-code sets; at most two
    launches a dispatch."""
    dev = _tile(_cuda())
    raw, codecs, sig, arrays, tb, nb, sets = _edge_inputs(case)
    before = (program.compiled_metrics.launches, program.compiled_metrics.kernel_launches)
    got = program.compiled_metrics(sig, *_on(arrays, tb, nb, dev))
    launches = program.compiled_metrics.launches - before[0]
    kernels = program.compiled_metrics.kernel_launches - before[1]
    assert launches == 1 and 1 <= kernels <= 2
    want = program.compiled_metrics(sig, *_on(arrays, tb, nb, torch.device("cpu")))
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), _oracle(raw, codecs, sig[0], sets, _RANGES, tb, nb, sig[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("width,wrap", [(0, False), (1, False), (31, False), (32, False),
                                        (2, True), (31, True), (32, True)])
def test_compiled_metrics_kernel_long_unit(width, wrap):
    """U=1 with n=2^20 rows (512 tiles): a dbp column of each width, its
    carry wrapping 2^64 (widths of 2+ bits) or not, beside an rle column,
    four lanes."""
    dev = _tile(_cuda())
    rng = np.random.default_rng(width)
    n = 1 << 20
    units, raw = _edge_units(rng, ("dbp", "rle"), [n], width=width, runs=300, wrap=wrap)
    col = raw[0][1][0]
    ranges = [(0, (1 << 64) - 1), (int(col[n // 3]), int(col[n // 2])),
              (int(col[-1]), int(col[-1])), (int(col.min()), int(col.max()))]
    sig_cols, n_pad, arrays = _edge_program(units, ("dbp", "rle"), 4, _SETS4, ranges)
    tb = np.array(_WIN4, np.uint32)
    nb = np.array([6, 3, 2, 100], np.uint32)
    sig = (sig_cols, n_pad, 128, 4)
    got = program.compiled_metrics(sig, *_on(arrays, tb, nb, dev))
    want = program.compiled_metrics(sig, *_on(arrays, tb, nb, torch.device("cpu")))
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), _oracle(raw, ("dbp", "rle"), sig_cols, _SETS4, ranges,
                                                tb, nb, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [0, 1, 31, 32])
@pytest.mark.parametrize("n,units", [(TILE - 1, 3), (TILE, 3), (TILE + 1, 3), (5 * TILE + 7, 4),
                                     (1 << 20, 1)])
def test_dbp_decode_kernel_tiles(n, units, width):
    """dbp_decode against its plain version and the columns at the tile
    edges, several tiles a unit and one unit of 2^20 values, every width,
    one unit's carry wrapping 2^64 (widths of 2+ bits); the reduce pass
    launches only for units of more than one tile."""
    dev = _tile(_cuda())
    rng = np.random.default_rng(n + width)
    cols = [_dbp_column(rng, n, width, wrap=width >= 2 and i == 0) for i in range(units)]
    parts = [_dbp_words(c) for c in cols]
    wp = max(len(p[0]) for p in parts)
    words = np.zeros((units, wp), np.uint32)
    for i, p in enumerate(parts):
        words[i, : len(p[0])] = p[0]
    args = (torch.from_numpy(words.view(np.int32)),
            torch.tensor([p[1] for p in parts], dtype=torch.uint64).view(torch.int64),
            torch.tensor([p[2] for p in parts], dtype=torch.int32))
    before = (tpk.dbp_decode_limbs.launches, tpk.dbp_decode_limbs.kernel_launches)
    got = tpk.dbp_decode_limbs(*(a.to(dev) for a in args), n).cpu()
    assert tpk.dbp_decode_limbs.launches == before[0] + 1
    assert tpk.dbp_decode_limbs.kernel_launches == before[1] + (2 if n > TILE else 1)
    assert torch.equal(got, tpk._dbp_decode_plain(*args, n))
    assert np.array_equal(got.numpy().view(np.uint64), np.stack(cols))
