"""The device tier's batched resident scans against the per-page scans and
the JAX package.

1. resident_rle_scan_batch and resident_dbp_scan_batch (tempo_tpu_torch/
   ops/scan) over mixed page tables made from numpy seeds: each page's
   slice of the batch's buffer against the page's own resident_rle_scan /
   resident_dbp_scan and against the JAX jits _rle_in_set_resident_jit,
   _rle_between_resident_jit and _dbp_between_resident_jit
   (tempo_tpu/ops/scan.py:170-216) on the CPU. rle: empty code sets,
   codes that collide with the padding and NO_MATCH_CODE, `invert`,
   uint32 bounds at their edges, run lengths summing below, to and past
   n, a page of more runs than one 8,192-run tile, pages of n == 0 and of
   no run (the JAX jit is asked only where it takes the page: runs >= 1).
   dbp: every width from 0 to 64, uint64 bounds at their edges and
   cutting inside a limb.
2. The serving forms resident_in_set_masks / resident_range_masks over
   resident entries: each mask equal to the entry's resident_in_set_mask
   / resident_range_mask, one dispatch a codec, the transfer they count.
3. An unbounded block search with the device tier on (the port's tier on
   the CPU): the stage-1 masks of the resident pages from one batched
   scan a codec, against the per-page loop (the pre-pass switched off)
   and against the JAX package's block search over the same block:
   answers and byte counters, the tiers' counters, the avoided bytes by
   kernel and the page-heat ledgers; and again with a tier below the
   search's working set, where the loop's own admissions evict pages the
   batch already scanned.

The `cuda` tests hold the single-page and batched kernels against their
plain versions on the card and skip here. Tolerance: exact everywhere
(masks, bytes and counts).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.encoding.common import SearchRequest as JRequest
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
from tempo_tpu.encoding.vtpu.colcache import DeviceTierConfig as JDeviceTierConfig
from tempo_tpu.ops import scan as jscan
from tempo_tpu.util import devicetiming as jdevicetiming
from tempo_tpu.util import pageheat as jpageheat
from tempo_tpu.util import pipeline as jpipeline
from tempo_tpu_torch.config_sections import DeviceTierConfig
from tempo_tpu_torch.encoding.common import SearchRequest
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.ops import scan
from tempo_tpu_torch.util import devicetiming, pageheat, pipeline

from test_torch_blocks import Pair
from test_torch_search import CFG, clustered_batch

MASK = 2**64 - 1
U32 = 2**32 - 1


def _t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _rle_pages(rng):
    """[(values u32, lengths i32, n)]: lengths summing below, to and past
    n, a page of more runs than one tile, a page of n == 0 and one of no
    run. Values repeat and collide with NO_MATCH_CODE."""
    pages = []
    for edge in ("short", "exact", "long", "exact"):
        r = int(rng.integers(1, 80))
        values = rng.integers(0, 9, r).astype(np.uint32)
        values[rng.random(r) < 0.1] = U32
        lengths = rng.integers(0, 7, r).astype(np.int32)
        total = int(lengths.sum())
        if total == 0:
            lengths[-1] = 1
            total = 1
        n = {"short": total + int(rng.integers(1, 9)), "exact": total,
             "long": max(1, total - int(rng.integers(1, 9)))}[edge]
        pages.append((values, lengths, n))
    r = 9000  # more than one 8,192-run tile
    values = rng.integers(0, 9, r).astype(np.uint32)
    lengths = rng.integers(0, 4, r).astype(np.int32)
    pages.append((values, lengths, int(lengths.sum()) + 5))
    pages.append((values[:5], lengths[:5], 0))
    pages.append((values[:0], lengths[:0], 7))
    return pages


def _rle_jax(values, lengths, n, codes=None, invert=False, lo=0, hi=0):
    if codes is not None:
        return np.asarray(jscan._rle_in_set_resident_jit(values, lengths, codes, n, invert))
    return np.asarray(jscan._rle_between_resident_jit(values, lengths, np.uint32(lo),
                                                      np.uint32(hi), n))


def _rle_asks(rng):
    """Code sets (raw) with invert, then uint32 bounds at their edges."""
    out = [dict(codes=np.zeros(0, np.uint32)), dict(codes=np.zeros(0, np.uint32), invert=True)]
    for _ in range(2):
        k = int(rng.integers(1, 6))
        c = rng.integers(0, 9, k).astype(np.uint32)
        c[-1] = U32
        out += [dict(codes=c), dict(codes=c, invert=True)]
    out += [dict(lo=0, hi=U32), dict(lo=U32, hi=U32), dict(lo=3, hi=2), dict(lo=0, hi=0),
            dict(lo=2, hi=7)]
    return out


@pytest.mark.parametrize("seed", range(3))
def test_rle_batch_equals_pages_and_jax(seed):
    rng = np.random.default_rng(500 + seed)
    pages = _rle_pages(rng)
    tpages = [(_t32(v), torch.from_numpy(ln), n) for v, ln, n in pages]
    for ask in _rle_asks(rng):
        padded = scan.pad_codes_u32(ask["codes"]) if "codes" in ask else None
        kw = dict(invert=ask.get("invert", False), lo=ask.get("lo", 0), hi=ask.get("hi", 0))
        codes = None if padded is None else _t32(padded)
        buf, offs = scan.resident_rle_scan_batch(tpages, codes=codes, **kw)
        assert buf.dtype == torch.bool and len(offs) == len(pages)
        for (v, ln, n), tp, off in zip(pages, tpages, offs):
            got = buf[off:off + n]
            assert torch.equal(got, scan.resident_rle_scan(*tp, codes=codes, **kw)), ask
            if len(v) and n:
                want = _rle_jax(v, ln, n, codes=padded, **kw)
                assert np.array_equal(got.numpy(), want), (ask, len(v), n)


def _dbp_page(rng, width: int, n: int, n_words: int):
    """(words u32, first) of n values whose deltas are `width`-bit fields
    of random bits, padded with zero words to n_words."""
    nbytes = ((n - 1) * width + 7) // 8 if n else 0
    raw = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    words = np.zeros(n_words, np.uint32)
    if raw:
        words[:-(-len(raw) // 4)] = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4), "<u4")
    return words, int(rng.integers(0, 2**64, dtype=np.uint64))


def _dbp_bounds(first: int):
    return [(0, MASK), (MASK, MASK), (0, 0), (first, first + 2**33),
            ((first & ~U32) + 3, (first | U32) - 3), (first - 2**31, first + 2**20),
            (2**32 + 3, 2**63)]


def test_dbp_batch_every_width_equals_pages_and_jax():
    rng = np.random.default_rng(600)
    n = 300
    n_words = (n - 1) * 64 // 32 + 2  # width 64's words and a guard word
    pages = [(*_dbp_page(rng, w, n, n_words), w, n) for w in range(65)]
    pages += [(*_dbp_page(rng, 17, m, n_words), 17, m) for m in (0, 1, 2)]
    tpages = [(_t32(words), first, w, m) for words, first, w, m in pages]
    for lo, hi in _dbp_bounds(pages[40][1]):
        lo, hi = lo & MASK, hi & MASK
        buf, offs = scan.resident_dbp_scan_batch(tpages, lo, hi)
        bounds = np.array([lo >> 32, lo & U32, hi >> 32, hi & U32], np.uint32)
        for (words, first, w, m), tp, off in zip(pages, tpages, offs):
            got = buf[off:off + m]
            assert torch.equal(got, scan.resident_dbp_scan(*tp, lo, hi)), (w, m)
            if m:
                want = np.asarray(jscan._dbp_between_resident_jit(
                    words, np.uint32(first >> 32), np.uint32(first & U32), np.int32(w),
                    bounds, m))
                assert np.array_equal(got.numpy(), want), (w, m, lo, hi)


def _entries(rng):
    """Resident entries (CPU tensors) of both codecs and the same pages
    as JAX residents."""
    out = []
    for values, lengths, n in _rle_pages(rng)[:5]:
        out.append(("rle", {"values": values, "lengths": lengths}, {"n": n}))
    for w, m in ((13, 100), (0, 9), (64, 33), (5, 0)):
        words, first = _dbp_page(rng, w, m, (max(m, 1) * 64) // 32 + 2)
        out.append(("dbp", {"words": words}, {"n": m, "first": first, "width": w}))
    t = [colcache._Resident(c, {k: colcache.device_tensor(a, torch.device("cpu"))
                                for k, a in arrays.items()}, meta, 0) for c, arrays, meta in out]
    j = [jcolcache._Resident(c, {k: jnp.asarray(a) for k, a in arrays.items()}, meta, 0)
         for c, arrays, meta in out]
    return t, j


@pytest.mark.parametrize("seed", range(2))
def test_serving_batches_equal_per_page_and_jax(seed):
    rng = np.random.default_rng(700 + seed)
    tents, jents = _entries(rng)
    rle = [i for i, e in enumerate(tents) if e.codec == "rle"]
    codes = np.array([1, 4, U32], np.uint32)
    for invert in (False, True):
        d0 = dict(devicetiming.STATS.dispatches)
        masks = scan.resident_in_set_masks([tents[i] for i in rle], codes, invert=invert)
        assert (devicetiming.STATS.dispatches["resident_rle_scan"]
                - d0.get("resident_rle_scan", 0)) == 1
        for i, m in zip(rle, masks):
            assert m.dtype == bool
            assert np.array_equal(m, scan.resident_in_set_mask(tents[i], codes, invert=invert))
            assert np.array_equal(m, jscan.resident_in_set_mask(jents[i], codes, invert=invert))
    for lo, hi in ((1, 5), (0, 2**40), (7, 3)):
        lo, hi = np.uint64(lo), np.uint64(hi)  # as the block search passes them
        before = (dict(devicetiming.STATS.dispatches), dict(devicetiming.STATS.d2h),
                  dict(devicetiming.STATS.resident))
        masks = scan.resident_range_masks(tents, lo, hi)
        for k in ("resident_rle_scan", "resident_dbp_scan"):
            group = [e for e in tents if e.codec == k.split("_")[1]]
            assert devicetiming.STATS.dispatches[k] - before[0].get(k, 0) == 1
            assert devicetiming.STATS.resident[k] - before[2].get(k, 0) == \
                sum(e.nbytes for e in group)
            assert devicetiming.STATS.d2h[k] - before[1].get(k, 0) == \
                sum(-(-int(e.meta["n"]) // 16) * 16 for e in group)
        for t, j, m in zip(tents, jents, masks):
            assert np.array_equal(m, scan.resident_range_mask(t, lo, hi))
            assert np.array_equal(m, jscan.resident_range_mask(j, lo, hi))
    assert scan.resident_in_set_masks([], codes) == [] and scan.resident_range_masks([], 0, 1) == []


def test_batch_wrappers_refuse_and_count_no_cpu_launch():
    rng = np.random.default_rng(800)
    tents, _ = _entries(rng)
    dct = colcache._Resident("dct", {"values": _t32([1]), "idx": torch.zeros(3, dtype=torch.int32)},
                             {"n": 3}, 0)
    batches = (scan.resident_rle_scan_batch, scan.resident_dct_scan_batch,
               scan.resident_dbp_scan_batch)
    before = [b.launches for b in batches]
    masks = scan.resident_range_masks(tents + [dct], 0, 9)
    assert np.array_equal(masks[-1], scan.resident_range_mask(dct, 0, 9))
    (served,) = scan.resident_in_set_masks([dct], np.array([1]))
    assert np.array_equal(served, scan.resident_in_set_mask(dct, np.array([1])))
    assert [b.launches for b in batches] == before
    # a codec with no resident scan of its kind is refused
    with pytest.raises(ValueError, match="rle and dct entries only"):
        scan.resident_in_set_masks([e for e in tents if e.codec == "dbp"], np.array([1]))
    tail = colcache._Resident("tail", {"values": _t32([1])}, {"n": 1}, 0)
    with pytest.raises(ValueError, match="rle, dct and dbp entries only"):
        scan.resident_range_masks([tail], 0, 1)
    with pytest.raises(ValueError, match="no page"):
        scan.resident_rle_scan_batch([])
    with pytest.raises(ValueError, match="width"):
        scan.resident_dbp_scan_batch([(_t32([0, 0]), 0, 65, 2)], 0, 1)
    with pytest.raises(ValueError, match="int32"):
        scan.resident_rle_scan_batch([(_t32([1]).to(torch.int64), _t32([1]), 1)])


# ---------------------------------------------------------------------------
# the unbounded search: batched stage 1 against the per-page loop and JAX
# ---------------------------------------------------------------------------

SEARCHES = {
    "service": dict(tags={"service": "alpha"}, limit=0),
    "service gamma": dict(tags={"service": "gamma"}, limit=0),
    "multi-tag": dict(tags={"service": "beta", "name": "op-c", "http.method": "GET"}, limit=0),
    "min duration": dict(min_duration_ns=10**8, limit=0),
    "max duration": dict(max_duration_ns=10**4, limit=0),
    "duration band": dict(tags={"service": "alpha"}, min_duration_ns=5 * 10**3,
                          max_duration_ns=5 * 10**4, limit=0),
    "window and tag": dict(tags={"service": "beta"}, start_seconds=1_700_000_060, limit=0),
}
CLOCK = ("idleS",)


def _no_clock(snap: dict) -> dict:
    snap = dict(snap)
    snap["hotSet"] = [{k: v for k, v in row.items() if k not in CLOCK} for row in snap["hotSet"]]
    return snap


@pytest.fixture
def tiered(tmp_path, monkeypatch):
    """(JAX block, port block) over one byte-equal block of one id, both
    packages' device tiers on (the port's on the CPU) with fresh ledgers,
    column caches cleared, prefetch off."""
    monkeypatch.setattr(jpipeline, "overlap_enabled", lambda: False)
    monkeypatch.setattr(pipeline, "overlap_enabled", lambda: False)
    for mod in (jpageheat, pageheat):
        monkeypatch.setattr(mod, "LEDGER", mod.PageHeatLedger())
    for mod in (jcolcache, colcache):
        monkeypatch.setattr(mod, "_shared_device", None)
    monkeypatch.setattr(colcache, "_tier_device", None)
    for cache in (jcolcache.shared_cache(), colcache.shared_cache()):
        if cache is not None:
            cache.clear()
    pair = Pair(tmp_path)
    jmeta, tmeta = pair.write(clustered_batch(7), "rb", CFG)
    jcolcache.configure_device_tier(JDeviceTierConfig(budget_mb=64))
    colcache.configure_device_tier(DeviceTierConfig(budget_mb=64), device="cpu")
    yield JBlock(jmeta, pair.jb), VtpuBackendBlock(tmeta, pair.tb)
    for mod in (jcolcache, colcache):
        mod.shared_device_tier().clear()


def _pass(jblk, tblk, kw):
    """One search on both packages: the responses compared, and the
    port's tier counters and avoided bytes by kernel this search moved."""
    jt, tt = jcolcache.shared_device_tier(), colcache.shared_device_tier()
    before = tt.stats(), devicetiming.transfer_report()["avoidedByKernel"]
    jbefore = jdevicetiming.transfer_report()["avoidedByKernel"]
    j, t = jblk.search(JRequest(**kw)), tblk.search(SearchRequest(**kw))
    assert t.to_dict() == j.to_dict()
    assert [dataclasses.astuple(h) for h in t.traces] == [dataclasses.astuple(h) for h in j.traces]
    assert jt.stats() == tt.stats() and jt.resident_pages() == tt.resident_pages()
    assert _no_clock(jpageheat.LEDGER.snapshot()) == _no_clock(pageheat.LEDGER.snapshot())
    avoided = {k: v - before[1].get(k, 0)
               for k, v in devicetiming.transfer_report()["avoidedByKernel"].items()}
    javoided = {k: v - jbefore.get(k, 0)
                for k, v in jdevicetiming.transfer_report()["avoidedByKernel"].items()}
    assert {k: v for k, v in avoided.items() if v} == {k: v for k, v in javoided.items() if v}
    delta = {k: v - before[0][k] for k, v in tt.stats().items() if isinstance(v, int)}
    return t, delta, avoided


@pytest.mark.parametrize("name", list(SEARCHES))
def test_unbounded_search_batched_stage1_equals_loop_and_jax(tiered, monkeypatch, name):
    jblk, tblk = tiered
    kw = SEARCHES[name]
    for _ in range(2):  # cold twice: the ledger's heat
        _pass(jblk, tblk, kw)
    jcolcache.shared_device_tier().refresh_admission(force=True)
    colcache.shared_device_tier().refresh_admission(force=True)
    _, admitting, _ = _pass(jblk, tblk, kw)
    assert admitting["admissions"] > 0

    calls = []
    for fn in ("resident_in_set_masks", "resident_range_masks"):
        real = getattr(scan, fn)

        def spy(entries, *a, real=real, **k):
            calls.append(len(entries))
            return real(entries, *a, **k)

        monkeypatch.setattr(scan, fn, spy)
    batched, batched_delta, batched_avoided = _pass(jblk, tblk, kw)
    assert batched_delta["admissions"] == 0 and batched_delta["hits"] > 0
    assert calls and all(calls)
    monkeypatch.setattr(VtpuBackendBlock, "_resident_stage1", lambda self, *a, **k: {})
    n_calls = len(calls)
    loop, loop_delta, loop_avoided = _pass(jblk, tblk, kw)
    assert len(calls) == n_calls  # the per-page loop took no batch
    assert loop.to_dict() == batched.to_dict()
    assert loop_delta == batched_delta and loop_avoided == batched_avoided


@pytest.mark.parametrize("name", ["service", "multi-tag", "min duration", "max duration",
                                  "duration band"])
def test_batched_stage1_pages_evicted_before_their_turn_equal_loop(tiered, monkeypatch, name):
    """A tier below the search's working set: the loop's own admissions
    evict pages the batch already scanned. Such a page is served as the
    per-page loop serves it (one miss, re-admitted, one hit), never from
    the batch's mask with a phantom avoided transfer."""
    jblk, tblk = tiered
    kw = SEARCHES[name]
    for _ in range(2):
        _pass(jblk, tblk, kw)
    jt, tt = jcolcache.shared_device_tier(), colcache.shared_device_tier()
    jt.refresh_admission(force=True)
    tt.refresh_admission(force=True)
    _pass(jblk, tblk, kw)
    jt.budget_bytes = tt.budget_bytes = int(tt.stats()["bytes"] * 0.6)
    _pass(jblk, tblk, kw)  # the LRU now thrashes the same way every pass

    scanned, evicted = [], []
    for fn in ("resident_in_set_masks", "resident_range_masks"):
        real = getattr(scan, fn)

        def spy(entries, *a, real=real, **k):
            scanned.append(len(entries))
            return real(entries, *a, **k)

        monkeypatch.setattr(scan, fn, spy)
    get = tt.get

    def counting_get(key, count_miss=True):
        res = get(key, count_miss)
        if res is None and not count_miss:
            evicted.append(key)
        return res

    monkeypatch.setattr(tt, "get", counting_get)
    batched, batched_delta, batched_avoided = _pass(jblk, tblk, kw)
    assert sum(scanned) > 0 and evicted and batched_delta["evictions"] > 0
    monkeypatch.setattr(VtpuBackendBlock, "_resident_stage1", lambda self, *a, **k: {})
    loop, loop_delta, loop_avoided = _pass(jblk, tblk, kw)
    assert loop.to_dict() == batched.to_dict()
    assert loop_delta == batched_delta and loop_avoided == batched_avoided


def test_limited_search_takes_no_batch(tiered, monkeypatch):
    jblk, tblk = tiered
    kw = dict(tags={"service": "alpha"}, limit=5)
    for _ in range(2):
        _pass(jblk, tblk, kw)
    colcache.shared_device_tier().refresh_admission(force=True)
    jcolcache.shared_device_tier().refresh_admission(force=True)
    _pass(jblk, tblk, kw)
    monkeypatch.setattr(VtpuBackendBlock, "_resident_stage1",
                        lambda self, *a, **k: pytest.fail("a limited search took the batch"))
    t, delta, _ = _pass(jblk, tblk, kw)
    assert delta["hits"] > 0 and len(t.traces) == 5


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(1, 1), (7, 40), (3623, 32768), (9000, 30000), (20000, 65536),
                                 (3000, 100), (50, 70000)])
def test_rle_kernel_one_launch_equals_plain(r, n):
    dev = _cuda()
    rng = np.random.default_rng(r + n)
    values = rng.integers(0, 50, r).astype(np.uint32)
    values[::97] = U32
    lengths = rng.integers(0, 2 * max(1, n // r) + 1, r).astype(np.int32)
    big = np.arange(300, dtype=np.uint32) * 3  # above the by-value cap: one copy a call
    args = (_t32(values), torch.from_numpy(lengths))
    for kw in ({"codes": _t32(scan.pad_codes_u32(np.array([3, 7, U32, 11, 40], np.uint32)))},
               {"codes": _t32(np.array([3, 7], np.uint32)), "invert": True},
               {"codes": _t32(big)}, {"lo": 5, "hi": 30}, {"lo": 0, "hi": U32}):
        want = scan.resident_rle_scan(*args, n, **kw)
        before = scan.resident_rle_scan.kernel_launches
        got = scan.resident_rle_scan(*(a.to(dev) for a in args), n, **kw)
        torch.cuda.synchronize()
        assert scan.resident_rle_scan.kernel_launches == before + 1
        assert torch.equal(got.cpu(), want), kw


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 2049, 8193, 32768, 65536, 70000])
def test_dbp_kernel_every_width_equals_plain(n):
    dev = _cuda()
    rng = np.random.default_rng(n)
    n_words = (n - 1) * 64 // 32 + 2
    for width in range(65):
        words, first = _dbp_page(rng, width, n, n_words)
        for lo, hi in _dbp_bounds(first)[:4]:
            lo, hi = sorted((lo & MASK, hi & MASK))
            want = scan.resident_dbp_scan(_t32(words), first, width, n, lo, hi)
            before = scan.resident_dbp_scan.kernel_launches
            got = scan.resident_dbp_scan(_t32(words).to(dev), first, width, n, lo, hi)
            torch.cuda.synchronize()
            assert scan.resident_dbp_scan.kernel_launches == before + 1
            assert torch.equal(got.cpu(), want), (width, lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_batched_kernels_one_launch_equal_plain(seed):
    dev = _cuda()
    rng = np.random.default_rng(900 + seed)
    pages = _rle_pages(rng) + [(rng.integers(0, 9, 3623).astype(np.uint32),
                                np.full(3623, 9, np.int32), 32768)]
    cpu = [(_t32(v), torch.from_numpy(ln), n) for v, ln, n in pages]
    gpu = [(v.to(dev), ln.to(dev), n) for v, ln, n in cpu]
    for kw in ({"codes": _t32(scan.pad_codes_u32(np.array([1, 4, U32], np.uint32)))},
               {"codes": _t32(np.array([2], np.uint32)), "invert": True}, {"lo": 2, "hi": 6}):
        want, offs = scan.resident_rle_scan_batch(cpu, **kw)
        before = scan.resident_rle_scan_batch.kernel_launches
        got, goffs = scan.resident_rle_scan_batch(gpu, **kw)
        torch.cuda.synchronize()
        assert scan.resident_rle_scan_batch.kernel_launches == before + 1 and goffs == offs
        for (_, _, n), off in zip(pages, offs):
            assert torch.equal(got[off:off + n].cpu(), want[off:off + n]), kw
    n_words = 65536 * 2 + 2
    dpages = [(*_dbp_page(rng, w, m, n_words), w, m)
              for w, m in [(w, 300) for w in range(65)] + [(31, 65536), (7, 0), (3, 1)]]
    cpu = [(_t32(words), first, w, m) for words, first, w, m in dpages]
    gpu = [(words.to(dev), first, w, m) for words, first, w, m in cpu]
    for lo, hi in _dbp_bounds(dpages[66][1]):
        lo, hi = sorted((lo & MASK, hi & MASK))
        want, offs = scan.resident_dbp_scan_batch(cpu, lo, hi)
        before = scan.resident_dbp_scan_batch.kernel_launches
        got, _ = scan.resident_dbp_scan_batch(gpu, lo, hi)
        torch.cuda.synchronize()
        assert scan.resident_dbp_scan_batch.kernel_launches == before + 1
        for (_, _, w, m), off in zip(dpages, offs):
            assert torch.equal(got[off:off + m].cpu(), want[off:off + m]), (w, m, lo, hi)
