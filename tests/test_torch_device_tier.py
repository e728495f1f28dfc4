"""The port's device-resident hot tier against the JAX package's.

1. The resident scans (tempo_tpu_torch/ops/scan: resident_rle_scan,
   resident_dct_scan, resident_dbp_scan and their serving wrappers
   resident_in_set_mask / resident_range_mask) against the JAX jitted
   programs of tempo_tpu/ops/scan.py:169-305 on the CPU, for random pages
   from a numpy seed: rle and dct in-set, inverted in-set and between,
   dbp between over widths 0, 1, 31, 32, 33 and 64 with bounds that cut
   inside a limb, codes that collide with the padding and with
   NO_MATCH_CODE, run lengths that sum below, to and past n, and n == 0.
   The masks must be bit-identical.
2. DeviceTier against the reference's DeviceTier over the same ledger,
   offers, gets, tail parks and pressure levels: admissions, evictions,
   shed order (tails first), stats() and the resident listing equal.
3. EncodedColumn.resident() over blocks written by both packages: the
   same pages admitted, the same payloads, the same masks as the host
   path, the same tier counters and avoided bytes.

The `cuda` tests hold each resident kernel against its plain version on
the card and skip here. Tolerance: exact everywhere (masks and counts).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu.encoding.common import BlockConfig as JConfig
from tempo_tpu.encoding.vtpu import colcache as jcolcache
from tempo_tpu.encoding.vtpu.block import EncodedColumn as JEncodedColumn
from tempo_tpu.encoding.vtpu.block import VtpuBackendBlock as JBlock
from tempo_tpu.encoding.vtpu.colcache import DeviceTierConfig as JDeviceTierConfig
from tempo_tpu.ops import scan as jscan
from tempo_tpu.util import devicetiming as jdevicetiming
from tempo_tpu.util import pageheat as jpageheat
from tempo_tpu_torch.config_sections import DeviceTierConfig
from tempo_tpu_torch.encoding.common import BlockConfig
from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.encoding.vtpu.block import EncodedColumn, VtpuBackendBlock
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.ops import scan
from tempo_tpu_torch.util import devicetiming, pageheat

from test_torch_blocks import Pair

MASK = 2**64 - 1


def _t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _rle_case(rng, edge: str):
    """(values u32, lengths i32, n): `edge` says whether the lengths sum
    below, to or past n. Values collide with NO_MATCH_CODE and repeat."""
    r = int(rng.integers(1, 60))
    values = rng.integers(0, 9, r).astype(np.uint32)
    values[rng.random(r) < 0.1] = 0xFFFFFFFF
    lengths = rng.integers(0, 7, r).astype(np.int32)
    total = int(lengths.sum())
    n = {"short": total + int(rng.integers(1, 9)), "exact": max(total, 1),
         "long": max(1, total - int(rng.integers(1, 9)))}[edge]
    if edge == "exact" and total == 0:
        lengths[-1] = 1
    return values, lengths, n


def _codes(rng):
    """A raw code set: empty, or with duplicates, NO_MATCH_CODE, or a
    size that pad_codes_u32 pads by repeating its first code."""
    k = int(rng.integers(0, 6))
    c = rng.integers(0, 9, k).astype(np.uint32)
    if k and rng.random() < 0.3:
        c[-1] = 0xFFFFFFFF
    return c


def _bounds(rng):
    lo, hi = sorted(int(x) for x in rng.integers(0, 10, 2))
    return lo, hi


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("edge", ["short", "exact", "long"])
def test_rle_scan_equals_jax(seed, edge):
    rng = np.random.default_rng(100 + seed)
    values, lengths, n = _rle_case(rng, edge)
    for invert in (False, True):
        codes = jscan.pad_codes_u32(_codes(rng))
        want = np.asarray(jscan._rle_in_set_resident_jit(values, lengths, codes, n, invert))
        got = scan.resident_rle_scan(_t32(values), torch.from_numpy(lengths), n,
                                     codes=_t32(codes), invert=invert)
        assert np.array_equal(want, got.numpy())
    lo, hi = _bounds(rng)
    want = np.asarray(jscan._rle_between_resident_jit(values, lengths, np.uint32(lo),
                                                      np.uint32(hi), n))
    got = scan.resident_rle_scan(_t32(values), torch.from_numpy(lengths), n, lo=lo, hi=hi)
    assert np.array_equal(want, got.numpy())


def test_rle_repeat_edges_take_the_last_run():
    """jnp.repeat's edges: rows past the runs take the last run's verdict,
    runs past n are cut, a zero-length run wins no row."""
    cases = [([1, 2], [2, 1], 5), ([1, 2, 1], [2, 0, 1], 5), ([1, 2, 1], [2, 3, 4], 4),
             ([1, 2], [2, 0], 4)]
    for v, ln, n in cases:
        v, ln = np.array(v, np.uint32), np.array(ln, np.int32)
        codes = np.array([1], np.uint32)
        want = np.asarray(jscan._rle_in_set_resident_jit(v, ln, codes, n, False))
        got = scan.resident_rle_scan(_t32(v), torch.from_numpy(ln), n, codes=_t32(codes))
        assert got.tolist() == want.tolist()


@pytest.mark.parametrize("seed", range(4))
def test_dct_scan_equals_jax(seed):
    rng = np.random.default_rng(200 + seed)
    v = int(rng.integers(1, 40))
    dvals = rng.integers(0, 9, v).astype(np.uint32)
    dvals[rng.random(v) < 0.1] = 0xFFFFFFFF
    n = int(rng.integers(1, 300))
    idx = rng.integers(0, v, n).astype(np.int32)
    for invert in (False, True):
        codes = jscan.pad_codes_u32(_codes(rng))
        want = np.asarray(jscan._dct_in_set_resident_jit(dvals, idx, codes, invert))
        got = scan.resident_dct_scan(_t32(dvals), torch.from_numpy(idx), codes=_t32(codes),
                                     invert=invert)
        assert np.array_equal(want, got.numpy())
    lo, hi = _bounds(rng)
    want = np.asarray(jscan._dct_between_resident_jit(dvals, idx, np.uint32(lo), np.uint32(hi)))
    got = scan.resident_dct_scan(_t32(dvals), torch.from_numpy(idx), lo=lo, hi=hi)
    assert np.array_equal(want, got.numpy())


def _dbp_case(rng, width: int, n: int):
    """(words u32 with the guard word, first) of a page of n values whose
    deltas are `width`-bit fields of random bits."""
    nbytes = ((n - 1) * width + 7) // 8
    raw = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    pad = (-len(raw)) % 4 + 4  # whole words + one guard word
    return np.frombuffer(raw + b"\x00" * pad, "<u4"), int(rng.integers(0, 2**62)) * 3


def _dbp_bounds(first: int):
    return [(0, MASK), (first, first + 2**33), (first - 2**31 + 5, first + 7),
            ((first & ~0xFFFFFFFF) + 3, (first | 0xFFFFFFFF) - 3), (2**32 + 3, 2**40)]


@pytest.mark.parametrize("width", [0, 1, 31, 32, 33, 64])
@pytest.mark.parametrize("n", [1, 2, 77, 3000])
def test_dbp_scan_equals_jax(width, n):
    rng = np.random.default_rng(width * 7919 + n)
    words, first = _dbp_case(rng, width, n)
    for lo, hi in _dbp_bounds(first):
        lo, hi = sorted((lo & MASK, hi & MASK))
        bounds = np.array([lo >> 32, lo & 0xFFFFFFFF, hi >> 32, hi & 0xFFFFFFFF], np.uint32)
        want = np.asarray(jscan._dbp_between_resident_jit(
            words, np.uint32(first >> 32), np.uint32(first & 0xFFFFFFFF), np.int32(width),
            bounds, n))
        got = scan.resident_dbp_scan(_t32(words), first, width, n, lo, hi)
        assert np.array_equal(want, got.numpy())


def _residents(codec: str, arrays: dict, meta: dict):
    """One page as a resident entry of each package (JAX arrays, CPU tensors)."""
    import jax.numpy as jnp

    j = jcolcache._Resident(codec, {k: jnp.asarray(a) for k, a in arrays.items()}, meta, 0)
    t = colcache._Resident(codec, {k: colcache.device_tensor(a, torch.device("cpu"))
                                   for k, a in arrays.items()}, meta, 0)
    return j, t


@pytest.mark.parametrize("seed", range(3))
def test_serving_wrappers_equal_jax(seed):
    """resident_in_set_mask / resident_range_mask end to end (code-set
    padding, bound limbs, n == 0 and the dbp in-set None), and the
    transfer they charge: the code set or bounds h2d, the mask d2h, the
    page resident."""
    rng = np.random.default_rng(300 + seed)
    values, lengths, n = _rle_case(rng, "exact")
    idx = rng.integers(0, len(values), n).astype(np.int32)
    words, first = _dbp_case(rng, 13, n)
    pages = [("rle", {"values": values, "lengths": lengths}, {"n": n}),
             ("dct", {"values": values, "idx": idx}, {"n": n}),
             ("dbp", {"words": words}, {"n": n, "first": first, "width": 13}),
             ("rle", {"values": values[:0], "lengths": lengths[:0]}, {"n": 0}),
             ("dct", {"values": values, "idx": idx[:0]}, {"n": 0})]
    codes = _codes(rng)
    for codec, arrays, meta in pages:
        j, t = _residents(codec, arrays, meta)
        for invert in (False, True):
            want = jscan.resident_in_set_mask(j, codes, invert=invert)
            got = scan.resident_in_set_mask(t, codes, invert=invert)
            assert (want is None and got is None) or np.array_equal(want, got)
        lo, hi = _bounds(rng) if codec != "dbp" else (first, first + 2**20)
        before = dict(devicetiming.STATS.h2d), dict(devicetiming.STATS.d2h)
        want = jscan.resident_range_mask(j, lo, hi)
        got = scan.resident_range_mask(t, lo, hi)
        assert np.array_equal(want, got) and got.dtype == bool
        kernel = f"resident_{codec}_scan"
        if meta["n"]:
            assert devicetiming.STATS.d2h[kernel] - before[1].get(kernel, 0) == meta["n"]
            assert (devicetiming.STATS.h2d.get(kernel, 0) - before[0].get(kernel, 0)
                    == (16 if codec == "dbp" else 0))


def test_wrappers_route_by_device_and_count_no_cpu_launch():
    before = (scan.resident_rle_scan.launches, scan.resident_dct_scan.launches,
              scan.resident_dbp_scan.launches)
    v = _t32([1, 2])
    scan.resident_rle_scan(v, torch.tensor([1, 1], dtype=torch.int32), 2, lo=0, hi=1)
    scan.resident_dct_scan(v, torch.tensor([0, 1], dtype=torch.int32), lo=0, hi=1)
    scan.resident_dbp_scan(_t32([0, 0]), 5, 1, 2, 0, 9)
    assert (scan.resident_rle_scan.launches, scan.resident_dct_scan.launches,
            scan.resident_dbp_scan.launches) == before
    with pytest.raises(ValueError):
        scan.resident_rle_scan(v.to(torch.int64), torch.tensor([1, 1], dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="without a dictionary"):
        scan.resident_dct_scan(v[:0], torch.tensor([0], dtype=torch.int32), lo=0, hi=1)


# ---------------------------------------------------------------------------
# DeviceTier against the reference's
# ---------------------------------------------------------------------------


class _Gov:
    def __init__(self):
        self.lvl = 0

    def level(self) -> int:
        return self.lvl


def _heat(monkeypatch, stream):
    for mod in (jpageheat, pageheat):
        monkeypatch.setattr(mod, "LEDGER", mod.PageHeatLedger())
    for key, moved, enc in stream:
        jpageheat.touch(*key, moved, enc)
        pageheat.touch(*key, moved, enc)


def _tiers(budget, tail=0, respect=True):
    gj, gt = _Gov(), _Gov()
    j = jcolcache.DeviceTier(budget, governor=gj, refresh_s=0.0, respect_governor=respect,
                             ingest_tail_budget_bytes=tail)
    t = colcache.DeviceTier(budget, governor=gt, refresh_s=0.0, respect_governor=respect,
                            ingest_tail_budget_bytes=tail, device="cpu")
    return (j, gj), (t, gt)


def _outcome(x):
    """A tier call's result, comparable across packages."""
    if x is None or isinstance(x, (bool, int)):
        return x
    return x.codec, x.nbytes, x.host_bytes, x.meta


def _arrays(rng, nbytes):
    k = max(1, nbytes // 8)
    return {"values": rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32),
            "lengths": rng.integers(0, 9, k).astype(np.int32)}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("respect", [True, False])
def test_device_tier_equals_reference(monkeypatch, seed, respect):
    rng = np.random.default_rng(400 + seed)
    keys = [(f"b{i % 2}", ("service", "name", "status")[i % 3], 128 * i) for i in range(12)]
    enc = {k: int(rng.integers(64, 600)) for k in keys}
    stream = [(keys[k], enc[keys[k]] * int(rng.integers(2, 6)), enc[keys[k]])
              for k in rng.zipf(1.3, 300) % len(keys)]
    _heat(monkeypatch, stream)
    (j, gj), (t, gt) = _tiers(budget=3000, tail=1200, respect=respect)
    assert j.stats() == t.stats()

    def both(fn):
        a, b = fn(j), fn(t)
        assert _outcome(a) == _outcome(b)
        assert j.stats() == t.stats()
        assert j.resident_pages() == t.resident_pages()

    for step in range(60):
        op = rng.integers(0, 6)
        key = keys[int(rng.integers(0, len(keys)))]
        if op <= 1:
            arrays = _arrays(rng, enc[key])
            both(lambda tier: tier.offer(key, "rle", arrays, {"n": 1}, host_bytes=enc[key] * 3))
        elif op == 2:
            both(lambda tier: tier.get(key))
        elif op == 3:
            lvl = int(rng.integers(0, 3))
            gj.lvl = gt.lvl = lvl
            both(lambda tier: tier.shed())
        elif op == 4:
            tkey = (colcache.TAIL_KEYSPACE, "tenant", f"seg-{step}")
            arrays = _arrays(rng, int(rng.integers(16, 700)))
            both(lambda tier: tier.park_tail(tkey, arrays, {"rows": 1}))
        else:
            nbytes = int(rng.integers(1, 99))
            both(lambda tier: tier.record_avoided(nbytes, kernel="k"))
        if step % 17 == 0:
            both(lambda tier: tier.refresh_admission(force=True))
    assert j.should_admit([keys[0]]) == t.should_admit([keys[0]])
    assert j.effective_tail_budget_bytes() == t.effective_tail_budget_bytes()
    assert t.stats()["admissions"] > 0
    j.clear(), t.clear()
    assert j.stats() == t.stats()


def test_tier_holds_tensors_on_its_device_and_counts_the_admission(monkeypatch):
    key = ("b", "service", 0)
    _heat(monkeypatch, [(key, 900, 100)] * 3)
    tier = colcache.DeviceTier(1 << 20, governor=_Gov(), device="cpu")
    before = devicetiming.STATS.h2d.get("device_tier_admit", 0)
    arrays = {"values": np.arange(5, dtype=np.uint32), "lengths": np.ones(5, np.int32)}
    assert tier.offer(key, "rle", arrays, {"n": 5})
    res = tier.get(key)
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in res.arrays.values())
    assert res.arrays["values"].dtype == torch.int32 and res.nbytes == 40
    assert devicetiming.STATS.h2d["device_tier_admit"] - before == 40


def test_configure_and_env_and_report(monkeypatch):
    """configure_device_tier / shared_device_tier / device_tier_report
    against the reference's, the env switch included."""
    for mod in (jcolcache, colcache):
        monkeypatch.setattr(mod, "_shared_device", None)
    monkeypatch.setattr(colcache, "_tier_device", None)
    monkeypatch.delenv("TEMPO_TPU_DEVICE_TIER_MB", raising=False)
    _heat(monkeypatch, [(("b", "service", 0), 900, 100)] * 3)  # both ledgers alike
    assert jcolcache.device_tier_report() == colcache.device_tier_report() == {"enabled": False}
    jt = jcolcache.configure_device_tier(JDeviceTierConfig(budget_mb=3, admit_min_ships=3))
    tt = colcache.configure_device_tier(DeviceTierConfig(budget_mb=3, admit_min_ships=3),
                                        device="cpu")
    assert tt is colcache.shared_device_tier() and tt.device.type == "cpu"
    assert jt.stats() == tt.stats() and tt.admit_min_ships == 3
    assert jcolcache.device_tier_report() == colcache.device_tier_report()
    assert colcache.configure_device_tier(DeviceTierConfig(), device="cpu") is None
    jcolcache.configure_device_tier(JDeviceTierConfig())
    monkeypatch.setenv("TEMPO_TPU_DEVICE_TIER_MB", "2")
    assert colcache.shared_device_tier().budget_bytes == jcolcache.shared_device_tier().budget_bytes
    assert colcache.shared_device_tier().device.type == "cpu"  # the last configured device
    monkeypatch.setenv("TEMPO_TPU_HBM_BYTES", "12345")
    assert colcache.hbm_headroom_bytes() == jcolcache.hbm_headroom_bytes() == 12345
    monkeypatch.setenv("TEMPO_TPU_HBM_BYTES", "x")
    assert colcache.hbm_headroom_bytes() == 0
    monkeypatch.delenv("TEMPO_TPU_HBM_BYTES")
    if not torch.cuda.is_available():
        assert colcache.hbm_headroom_bytes() == 0


# ---------------------------------------------------------------------------
# EncodedColumn.resident() over blocks written by both packages
# ---------------------------------------------------------------------------


def _blocks(tmp_path):
    pair = Pair(tmp_path)
    jmeta, tmeta = pair.write(synth.make_batch(300, 5, seed=21), "res",
                              {"row_group_spans": 512})
    return JBlock(jmeta, pair.jb, JConfig(row_group_spans=512)), \
        VtpuBackendBlock(tmeta, pair.tb, BlockConfig(row_group_spans=512))


def _columns(jblk, tblk):
    """Every 1-D lightweight page of both blocks, paired."""
    out = []
    for jrg, trg in zip(jblk.index().row_groups, tblk.index().row_groups):
        for name, pm in trg.pages.items():
            if pm.codec in ("rle", "dct", "dbp") and len(pm.shape or ()) == 1:
                out.append((JEncodedColumn(jblk, jrg, name), EncodedColumn(tblk, trg, name)))
    return out


def _ask(col, codes):
    """The column's in-set, inverted and range masks (bounds inside its
    value type: 32-bit columns compare in u32, 64-bit ones in u64)."""
    hi = 2**62 if np.dtype(col.pm.dtype).itemsize == 8 else 5
    return col.in_set_mask(codes), col.in_set_mask(codes, invert=True), col.range_mask(1, hi)


def _same(a, b):
    return (a is None and b is None) or (a is not None and b is not None and np.array_equal(a, b))


def test_encoded_column_resident_over_both_packages_blocks(tmp_path, monkeypatch):
    for mod in (jpageheat, pageheat):
        monkeypatch.setattr(mod, "LEDGER", mod.PageHeatLedger())
    for mod in (jcolcache, colcache):
        monkeypatch.setattr(mod, "_shared_device", None)
    jblk, tblk = _blocks(tmp_path)
    cols = _columns(jblk, tblk)
    assert {c.codec for _, c in cols} >= {"rle", "dbp"}
    codes = np.array([0, 1, 3], np.uint32)
    hosts = []
    for jc, tc in cols:  # tier off: the host arm, which records the heat
        for _ in range(3):
            jm, tm = _ask(jc, codes), _ask(tc, codes)
            assert all(_same(a, b) for a, b in zip(jm, tm))
        hosts.append(tm)
    assert (jpageheat.LEDGER.snapshot()["totalShips"] == pageheat.LEDGER.snapshot()["totalShips"]
            > 0)
    jt = jcolcache.configure_device_tier(JDeviceTierConfig(budget_mb=64))
    tt = colcache.configure_device_tier(DeviceTierConfig(budget_mb=64), device="cpu")
    jt.refresh_admission(force=True)
    tt.refresh_admission(force=True)
    assert jt._admit_keys == tt._admit_keys and tt._admit_keys
    avoided = jdevicetiming.avoided_total(), sum(devicetiming.STATS.avoided.values())
    for (jc, tc), host in zip(cols, hosts):
        jp, tp = jc.resident_payload(), tc.resident_payload()
        assert (jp is None) == (tp is None)
        if tp is not None:
            assert jp[0] == tp[0] and jp[2] == tp[2] and jp[3] == tp[3]
            assert sorted(jp[1]) == sorted(tp[1])
            assert all(np.array_equal(jp[1][k], tp[1][k]) for k in tp[1])
        for _ in range(2):  # admission, then a resident serve
            jm, tm = _ask(jc, codes), _ask(tc, codes)
            assert all(_same(a, b) for a, b in zip(jm, tm))
            assert all(_same(a, b) for a, b in zip(host, tm))
        assert (jc.resident() is None) == (tc.resident() is None)
    assert jt.stats() == tt.stats() and tt.stats()["entries"] > 0
    assert jt.resident_pages() == tt.resident_pages()
    assert (jdevicetiming.avoided_total() - avoided[0]
            == sum(devicetiming.STATS.avoided.values()) - avoided[1] > 0)


def test_compaction_readers_bypass_heat_and_tier(tmp_path, monkeypatch):
    for mod in (jpageheat, pageheat):
        monkeypatch.setattr(mod, "LEDGER", mod.PageHeatLedger())
    pair = Pair(tmp_path)
    _, tmeta = pair.write(synth.make_batch(50, 4, seed=22), "c", {"row_group_spans": 128})
    blk = VtpuBackendBlock(tmeta, pair.tb, BlockConfig(row_group_spans=128), column_cache=None)
    for rg in blk.index().row_groups:
        blk.read_columns(rg, list(rg.pages))
        for name, pm in rg.pages.items():
            if pm.codec in ("rle", "dct") and len(pm.shape or ()) == 1:
                col = EncodedColumn(blk, rg, name)
                col.in_set_mask(np.array([1], np.uint32))
                assert col._device_tier() is None and col.resident() is None
    assert pageheat.LEDGER.snapshot()["totalShips"] == 0


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(1, 1), (7, 40), (2048, 5000), (6000, 20000), (3000, 100)])
def test_rle_kernel_equals_plain(r, n):
    dev = _cuda()
    rng = np.random.default_rng(r + n)
    values = rng.integers(0, 50, r).astype(np.uint32)
    values[::97] = 0xFFFFFFFF
    lengths = rng.integers(0, 2 * max(1, n // r) + 1, r).astype(np.int32)
    codes = _t32(jscan.pad_codes_u32(np.array([3, 7, 0xFFFFFFFF, 11, 40], np.uint32)))
    args = (_t32(values), torch.from_numpy(lengths))
    for kw in ({"codes": codes}, {"codes": codes, "invert": True}, {"lo": 5, "hi": 30}):
        want = scan.resident_rle_scan(*args, n, **kw)
        before = scan.resident_rle_scan.launches
        got = scan.resident_rle_scan(*(a.to(dev) for a in args), n,
                                     **{k: (v.to(dev) if torch.is_tensor(v) else v)
                                        for k, v in kw.items()})
        torch.cuda.synchronize()
        assert scan.resident_rle_scan.launches == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("v,n", [(1, 1), (5, 9), (300, 70000), (4000, 2049)])
def test_dct_kernel_equals_plain(v, n):
    dev = _cuda()
    rng = np.random.default_rng(v + n)
    dvals = rng.integers(0, 2**32, v, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, v, n).astype(np.int32)
    codes = _t32(jscan.pad_codes_u32(dvals[: 3]))
    args = (_t32(dvals), torch.from_numpy(idx))
    for kw in ({"codes": codes}, {"codes": codes, "invert": True},
               {"lo": 2**31, "hi": 2**32 - 5}):
        want = scan.resident_dct_scan(*args, **kw)
        got = scan.resident_dct_scan(*(a.to(dev) for a in args),
                                     **{k: (v.to(dev) if torch.is_tensor(v) else v)
                                        for k, v in kw.items()})
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [0, 1, 31, 32, 33, 64])
@pytest.mark.parametrize("n", [1, 2, 2048, 2049, 70000])
def test_dbp_kernel_equals_plain(width, n):
    dev = _cuda()
    rng = np.random.default_rng(width * 31 + n)
    words, first = _dbp_case(rng, width, n)
    for lo, hi in _dbp_bounds(first):
        lo, hi = sorted((lo & MASK, hi & MASK))
        want = scan.resident_dbp_scan(_t32(words), first, width, n, lo, hi)
        got = scan.resident_dbp_scan(_t32(words).to(dev), first, width, n, lo, hi)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
