"""The device tier's dct scans, one page and batched, against each other and
the JAX package.

1. resident_dct_scan_batch (tempo_tpu_torch/ops/scan) over mixed page
   tables made from numpy seeds: each page's slice of the batch's buffer
   against the page's own resident_dct_scan and against the JAX jits
   _dct_in_set_resident_jit and _dct_between_resident_jit
   (tempo_tpu/ops/scan.py:186-201) on the CPU. Dictionaries of one entry
   and of n/2 entries, values equal to NO_MATCH_CODE, code sets that are
   empty, hold NO_MATCH_CODE or collide with the padding, `invert`,
   uint32 bounds at 0 and 2^32 - 1, pages of n == 0, and indices at the
   edges of jnp indexing (negative ones from the end, below -V, at and
   past V: clamped), which the JAX jit reads as the plain version does.
2. The serving forms resident_in_set_masks / resident_range_masks over
   rle, dct and dbp entries together: one dispatch a codec, each mask
   equal to the entry's own and to the JAX package's.
3. Unbounded block searches whose stage-1 column is dct-coded, with the
   device tier on (the port's on the CPU): the batched stage 1, which now
   takes the dct pages too, against the per-page loop (the pre-pass
   switched off) and against the JAX package's block search: answers,
   byte counters, the tiers' counters, the avoided bytes by kernel and
   the page-heat ledgers; and again with a tier below the search's
   working set. The fixtures are test_torch_resident_batch.py's.

The `cuda` tests hold the one-launch kernel (one launch a call, the code
set by value, above the by-value cap and on the card) and the batch
against their plain versions on the card and skip here. Tolerance: exact
everywhere (masks, bytes and counts).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.ops import scan as jscan
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.ops import scan
from tempo_tpu_torch.util import devicetiming

from test_torch_resident_batch import _dbp_page, _pass, _rle_pages, _t32, tiered  # noqa: F401

U32 = 2**32 - 1


def _dct_page(rng, v: int, n: int, edges: bool = False):
    """(dictionary u32, idx i32) of n rows over v entries, some equal to
    NO_MATCH_CODE; with `edges`, indices at jnp's edges as well."""
    dvals = rng.integers(0, 9, v).astype(np.uint32)
    dvals[rng.random(v) < 0.2] = U32
    idx = rng.integers(0, max(v, 1), n).astype(np.int32)
    if edges and n:
        picks = np.array([-1, -v, -v - 1, -(2**31), v, v + 7, 2**31 - 1], np.int32)
        at = rng.choice(n, min(n, 3 * len(picks)), replace=False)
        idx[at] = rng.choice(picks, len(at))
    return dvals, idx


def _pages(rng):
    """A mixed table: one entry, n/2 entries, jnp's index edges, pages of
    n == 0 (with and without a dictionary) and a page past one 2,048-row
    tile."""
    pages = [_dct_page(rng, 1, 37), _dct_page(rng, 60, 120), _dct_page(rng, 9, 300, edges=True),
             _dct_page(rng, 5, 0), _dct_page(rng, 0, 0), _dct_page(rng, 700, 3000, edges=True),
             _dct_page(rng, 1, 1)]
    return pages


def _asks():
    """Code sets (raw, padded as the serving forms pad them) with invert,
    then uint32 bounds at their edges."""
    out = []
    for codes in (np.zeros(0, np.uint32), np.array([U32], np.uint32),
                  np.array([3, 1, 1, U32, 7], np.uint32), np.array([2], np.uint32)):
        out += [dict(codes=codes), dict(codes=codes, invert=True)]
    out += [dict(lo=0, hi=U32), dict(lo=U32, hi=U32), dict(lo=0, hi=0), dict(lo=3, hi=2),
            dict(lo=2, hi=7)]
    return out


def _jax(dvals, idx, codes=None, invert=False, lo=0, hi=0):
    if codes is not None:
        return np.asarray(jscan._dct_in_set_resident_jit(dvals, idx, codes, invert))
    return np.asarray(jscan._dct_between_resident_jit(dvals, idx, np.uint32(lo), np.uint32(hi)))


@pytest.mark.parametrize("seed", range(3))
def test_dct_batch_equals_pages_and_jax(seed):
    rng = np.random.default_rng(1200 + seed)
    pages = _pages(rng)
    tpages = [(_t32(v), torch.from_numpy(i)) for v, i in pages]
    for ask in _asks():
        padded = scan.pad_codes_u32(ask["codes"]) if "codes" in ask else None
        kw = dict(invert=ask.get("invert", False), lo=ask.get("lo", 0), hi=ask.get("hi", 0))
        codes = None if padded is None else _t32(padded)
        buf, offs = scan.resident_dct_scan_batch(tpages, codes=codes, **kw)
        assert buf.dtype == torch.bool and len(offs) == len(pages)
        assert all(o % 16 == 0 for o in offs)
        for (v, i), tp, off in zip(pages, tpages, offs):
            got = buf[off:off + len(i)]
            assert torch.equal(got, scan.resident_dct_scan(*tp, codes=codes, **kw)), ask
            if len(i):
                want = _jax(v, i, codes=padded, **kw)
                assert np.array_equal(got.numpy(), want), (ask, len(v), len(i))


def test_dct_scan_takes_numpy_codes_as_tensor_codes():
    rng = np.random.default_rng(1300)
    v, i = _dct_page(rng, 30, 500, edges=True)
    codes = scan.pad_codes_u32(np.array([4, U32, 0], np.uint32))
    for invert in (False, True):
        want = _jax(v, i, codes=codes, invert=invert)
        for c in (codes, _t32(codes)):
            got = scan.resident_dct_scan(_t32(v), torch.from_numpy(i), codes=c, invert=invert)
            assert np.array_equal(got.numpy(), want)
            buf, offs = scan.resident_dct_scan_batch([(_t32(v), torch.from_numpy(i))], codes=c,
                                                     invert=invert)
            assert np.array_equal(buf[:len(i)].numpy(), want)


def test_dct_batch_refuses():
    with pytest.raises(ValueError, match="no page"):
        scan.resident_dct_scan_batch([])
    with pytest.raises(ValueError, match="without a dictionary"):
        scan.resident_dct_scan_batch([(_t32([]), torch.zeros(2, dtype=torch.int32))])
    with pytest.raises(ValueError, match="int32"):
        scan.resident_dct_scan_batch([(_t32([1]).to(torch.int64),
                                       torch.zeros(2, dtype=torch.int32))])


def _entries(rng):
    """Resident entries (CPU tensors) of rle, dct and dbp pages and the
    same pages as JAX residents."""
    out = []
    for values, lengths, n in _rle_pages(rng)[:4]:
        out.append(("rle", {"values": values, "lengths": lengths}, {"n": n}))
    for v, i in _pages(rng):
        if len(v):
            out.append(("dct", {"values": v, "idx": i}, {"n": len(i)}))
    for w, m in ((13, 100), (64, 33), (5, 0)):
        words, first = _dbp_page(rng, w, m, (max(m, 1) * 64) // 32 + 2)
        out.append(("dbp", {"words": words}, {"n": m, "first": first, "width": w}))
    order = rng.permutation(len(out))  # the codecs interleaved
    out = [out[k] for k in order]
    t = [colcache._Resident(c, {k: colcache.device_tensor(a, torch.device("cpu"))
                                for k, a in arrays.items()}, meta, 0) for c, arrays, meta in out]
    j = [jcolcache._Resident(c, {k: jnp.asarray(a) for k, a in arrays.items()}, meta, 0)
         for c, arrays, meta in out]
    return t, j


def _dispatches() -> dict:
    return dict(devicetiming.STATS.dispatches)


@pytest.mark.parametrize("seed", range(2))
def test_serving_forms_over_rle_dct_and_dbp(seed):
    rng = np.random.default_rng(1400 + seed)
    tents, jents = _entries(rng)
    sets = [i for i, e in enumerate(tents) if e.codec in ("rle", "dct")]
    for codes in (np.array([1, 4, U32], np.uint32), np.zeros(0, np.uint32)):
        for invert in (False, True):
            before = _dispatches()
            masks = scan.resident_in_set_masks([tents[i] for i in sets], codes, invert=invert)
            for k in ("resident_rle_scan", "resident_dct_scan"):
                assert devicetiming.STATS.dispatches[k] - before.get(k, 0) == 1
            for i, m in zip(sets, masks):
                assert m.dtype == bool and len(m) == int(tents[i].meta["n"])
                assert np.array_equal(m, scan.resident_in_set_mask(tents[i], codes, invert=invert))
                assert np.array_equal(m, jscan.resident_in_set_mask(jents[i], codes,
                                                                    invert=invert))
    for lo, hi in ((1, 5), (0, U32), (U32, U32), (0, 2**40), (7, 3)):
        lo, hi = np.uint64(lo), np.uint64(hi)  # as the block search passes them
        before = (_dispatches(), dict(devicetiming.STATS.d2h), dict(devicetiming.STATS.resident))
        masks = scan.resident_range_masks(tents, lo, hi)
        for codec in ("rle", "dct", "dbp"):
            k = f"resident_{codec}_scan"
            group = [e for e in tents if e.codec == codec]
            assert devicetiming.STATS.dispatches[k] - before[0].get(k, 0) == 1
            assert devicetiming.STATS.resident[k] - before[2].get(k, 0) == \
                sum(e.nbytes for e in group)
            assert devicetiming.STATS.d2h[k] - before[1].get(k, 0) == \
                sum(-(-int(e.meta["n"]) // 16) * 16 for e in group)
        for t, j, m in zip(tents, jents, masks):
            assert np.array_equal(m, scan.resident_range_mask(t, lo, hi))
            assert np.array_equal(m, jscan.resident_range_mask(j, lo, hi))


def test_resident_entries_keep_their_page_rows():
    rng = np.random.default_rng(1500)
    tents, _ = _entries(rng)
    for e in tents:
        a = e.arrays
        first = {"rle": a.get("values"), "dct": a.get("values"), "dbp": a.get("words")}[e.codec]
        assert e.row.dtype == np.int64 and e.row.shape == (8,)
        assert e.row[0] == first.data_ptr() and e.row[2] == first.numel()
        assert e.row[3] == int(e.meta["n"]) and e.row[6] == 0
    assert colcache._Resident("compiled_stack", {}, {}, 0).row is None


# ---------------------------------------------------------------------------
# block searches whose stage-1 column is dct-coded
# ---------------------------------------------------------------------------

DCT_SEARCHES = {
    "service gamma": dict(tags={"service": "gamma"}, limit=0),
    "service delta": dict(tags={"service": "delta"}, limit=0),
    "name op-d": dict(tags={"name": "op-d"}, limit=0),
}


def _spy_dct_batches(monkeypatch) -> list:
    """The page counts of the dct batches the searches take."""
    pages = []
    real = scan.resident_dct_scan_batch

    def spy(p, *a, **k):
        pages.append(len(p))
        return real(p, *a, **k)

    monkeypatch.setattr(scan, "resident_dct_scan_batch", spy)
    return pages


def _warm(jblk, tblk, kw):
    """Cold twice (the ledger's heat), then the admitting pass."""
    for _ in range(2):
        _pass(jblk, tblk, kw)
    jcolcache.shared_device_tier().refresh_admission(force=True)
    colcache.shared_device_tier().refresh_admission(force=True)
    _, admitting, _ = _pass(jblk, tblk, kw)
    assert admitting["admissions"] > 0


@pytest.mark.parametrize("name", list(DCT_SEARCHES))
def test_dct_stage1_batched_equals_loop_and_jax(tiered, monkeypatch, name):  # noqa: F811
    jblk, tblk = tiered
    kw = DCT_SEARCHES[name]
    _warm(jblk, tblk, kw)
    pages = _spy_dct_batches(monkeypatch)
    batched, batched_delta, batched_avoided = _pass(jblk, tblk, kw)
    assert len(pages) == 1 and pages[0] > 0  # one dct launch for the search's stage 1
    assert batched_delta["admissions"] == 0 and batched_delta["hits"] > 0
    assert batched_avoided.get("resident_dct_scan", 0) > 0
    monkeypatch.setattr(VtpuBackendBlock, "_resident_stage1", lambda self, *a, **k: {})
    loop, loop_delta, loop_avoided = _pass(jblk, tblk, kw)
    assert len(pages) == 1  # the per-page loop took no batch
    assert loop.to_dict() == batched.to_dict()
    assert loop_delta == batched_delta and loop_avoided == batched_avoided


@pytest.mark.parametrize("name", list(DCT_SEARCHES))
def test_dct_stage1_pages_evicted_before_their_turn_equal_loop(tiered, monkeypatch,  # noqa: F811
                                                               name):
    """A tier below the search's working set: the loop's admissions evict
    dct pages the batch already scanned; each is served as the loop
    serves it."""
    jblk, tblk = tiered
    kw = DCT_SEARCHES[name]
    _warm(jblk, tblk, kw)
    jt, tt = jcolcache.shared_device_tier(), colcache.shared_device_tier()
    jt.budget_bytes = tt.budget_bytes = int(tt.stats()["bytes"] * 0.6)
    _pass(jblk, tblk, kw)  # the LRU now thrashes the same way every pass
    pages = _spy_dct_batches(monkeypatch)
    batched, batched_delta, batched_avoided = _pass(jblk, tblk, kw)
    assert sum(pages) > 0 and batched_delta["evictions"] > 0
    monkeypatch.setattr(VtpuBackendBlock, "_resident_stage1", lambda self, *a, **k: {})
    loop, loop_delta, loop_avoided = _pass(jblk, tblk, kw)
    assert loop.to_dict() == batched.to_dict()
    assert loop_delta == batched_delta and loop_avoided == batched_avoided


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("v,n", [(1, 1), (1, 65536), (257, 65536), (1024, 4096), (1025, 70000),
                                 (32768, 65536), (40000, 5000), (300, 2047)])
def test_dct_kernel_one_launch_equals_plain(v, n):
    dev = _cuda()
    rng = np.random.default_rng(v + n)
    dvals = rng.integers(0, 2**32, v, dtype=np.uint64).astype(np.uint32)
    dvals[::7] = U32
    idx = rng.integers(0, v, n).astype(np.int32)
    idx[::97] = -1
    idx[1::89] = v
    codes = _t32(scan.pad_codes_u32(dvals[:5]))
    big = _t32(dvals[: min(v, 300)].repeat(-(-300 // min(v, 300)))[:300])  # above the cap
    args = (_t32(dvals), torch.from_numpy(idx))
    for kw in ({"codes": codes}, {"codes": codes, "invert": True}, {"codes": codes.to(dev)},
               {"codes": big}, {"codes": _t32([U32])}, {"lo": 2**31, "hi": U32},
               {"lo": 0, "hi": U32}):
        want = scan.resident_dct_scan(*args, **{k: (x.cpu() if torch.is_tensor(x) else x)
                                                for k, x in kw.items()})
        before = scan.resident_dct_scan.kernel_launches
        got = scan.resident_dct_scan(*(a.to(dev) for a in args), **kw)
        torch.cuda.synchronize()
        assert scan.resident_dct_scan.kernel_launches == before + 1
        assert torch.equal(got.cpu(), want), (sorted(kw), v, n)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_dct_batch_kernel_one_launch_equals_plain(seed):
    dev = _cuda()
    rng = np.random.default_rng(1600 + seed)
    small = _pages(rng) + [_dct_page(rng, 257, 65536), _dct_page(rng, 1024, 5000, edges=True)]
    # the bitset's table, then one with a dictionary a verdict a row takes
    for pages in (small, small + [_dct_page(rng, 32768, 65536, edges=True)]):
        cpu = [(_t32(v), torch.from_numpy(i)) for v, i in pages]
        gpu = [(v.to(dev), i.to(dev)) for v, i in cpu]
        for kw in ({"codes": _t32(scan.pad_codes_u32(np.array([1, 4, U32], np.uint32)))},
                   {"codes": _t32(np.array([2], np.uint32)), "invert": True},
                   {"codes": _t32(np.arange(300, dtype=np.uint32))}, {"lo": 2, "hi": 6}):
            want, offs = scan.resident_dct_scan_batch(cpu, **kw)
            before = scan.resident_dct_scan_batch.kernel_launches
            got, goffs = scan.resident_dct_scan_batch(gpu, **kw)
            torch.cuda.synchronize()
            assert scan.resident_dct_scan_batch.kernel_launches == before + 1 and goffs == offs
            for (_, i), off in zip(pages, offs):
                assert torch.equal(got[off:off + len(i)].cpu(), want[off:off + len(i)]), \
                    (sorted(kw), len(pages))
