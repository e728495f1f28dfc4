"""The port's device page-encode arm against the JAX package's.

Mirrors tests/test_device_encode.py on both packages. With
TEMPO_TPU_DEVICE_ENCODE=1 set for both (the JAX arm then runs its jitted
kernels on the CPU, the port's wrappers their plain versions), a page
from the port's encode_page_device must equal the JAX package's
encode_page_device page and the host lightweight encoder's page, byte
for byte — header, widths, CRC and packbits padding — over every dtype,
shape and length class the write path produces, at the edges of the
power-of-two row padding. codec.encode gives the same bytes with the
switch at 0, 1 and unset; a failing kernel raises instead of falling back
to the host; and blocks written and compacted with the arm forced equal
the JAX package's. Mixed batches through encode_pages_device (one
dispatch for every page of the batch) are held page by page against the
JAX package's encode_page_device and the host encoders, the block writer
makes one batched call a row group, and a failing plain version raises
through the batched path. The `cuda` tests hold the two batched kernels
(rle_change_mask and dbp_pack) against their plain versions on the card
over mixed page tables, and a card-written block against the CPU's, and
skip here. Tolerance: exact bytes.
"""

import numpy as np
import pytest
import torch

from tempo_tpu.encoding.common import BlockConfig as JConfig, CompactionOptions as JOptions
from tempo_tpu.encoding.vtpu.compactor import VtpuCompactor as JCompactor
from tempo_tpu.ops import encode as jenc
from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
from tempo_tpu_torch.encoding.vtpu import codec
from tempo_tpu_torch.encoding.vtpu import lightweight as lw
from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.ops import encode as tenc
from tempo_tpu_torch.ops import pallas_kernels
from tempo_tpu_torch.util.devicetiming import STATS

from test_torch_blocks import Pair, assert_same_objects, cuda_device  # noqa: F401

ABSENT = np.uint32(0xFFFFFFFF)
HOST_ENC = {"rle": lw.rle_encode, "dbp": lw.dbp_encode, "dct": lw.dct_encode}
HOST_DEC = {"rle": lw.rle_decode, "dbp": lw.dbp_decode, "dct": lw.dct_decode}
CODECS = ("rle", "dbp", "dct")
LENGTHS = (2, 3, 7, 8, 9, 1000, 8193)


@pytest.fixture(autouse=True)
def _arm_forced(monkeypatch):
    monkeypatch.setenv("TEMPO_TPU_DEVICE_ENCODE", "1")


def _corpus():
    """The reference test's named cases: dictionary codes with the absent
    sentinel, u64 timestamps (limb arithmetic), every delta negative,
    2-D trace-ID limbs, constants, two rows, lengths on either side of a
    power of two, signed columns."""
    rng = np.random.default_rng(7)
    ts = (np.uint64(1_700_000_000_000_000_000)
          + np.cumsum(rng.integers(0, 1 << 20, 1000).astype(np.uint64)))
    codes = rng.integers(0, 5, 777).astype(np.uint32)
    codes[rng.random(777) < 0.1] = ABSENT
    tid = rng.integers(0, 1 << 32, (300, 4), dtype=np.uint64).astype(np.uint32)
    return [
        ("codes_with_absent", codes, CODECS),
        ("long_runs_u32", np.repeat(np.arange(9, dtype=np.uint32), 64), CODECS),
        ("timestamps_u64", ts, ("dbp", "rle")),
        ("descending_u64", ts[::-1].copy(), ("dbp",)),
        ("trace_id_2d_u32", tid, CODECS),
        ("constant_u64", np.full(257, 42, np.uint64), CODECS),
        ("two_rows", np.array([7, ABSENT], np.uint32), CODECS),
        ("pow2_exact", rng.integers(0, 3, 256).astype(np.uint32), CODECS),
        ("pow2_plus_one", rng.integers(0, 3, 257).astype(np.uint32), CODECS),
        ("status_i32", rng.integers(0, 3, 100).astype(np.int32), ("rle", "dct")),
        ("signed_i8_wrap", np.array([127, -128, 0, -1, 5, 127, -128], np.int8), CODECS),
        ("u16_wrap", np.array([65535, 0, 1, 65535, 7, 0], np.uint16), CODECS),
        ("i64_negative", np.array([-2, 3, -(1 << 29), 1 << 29, -1, -1, 0], np.int64), CODECS),
        ("u64_borrow", np.array([(1 << 32) - 3, (1 << 32) + 4, (1 << 32) - 10, (1 << 32) + (1 << 30),
                                 (1 << 32) - (1 << 30), (1 << 32) + 1], np.uint64), CODECS),
    ]


CASES = [pytest.param(arr, c, id=f"{name}-{c}") for name, arr, cs in _corpus() for c in cs]


def _pages(arr, cdc):
    """(port, JAX, host) pages, each None where that arm raised ValueError."""
    out = []
    for fn in (lambda: tenc.encode_page_device(arr, cdc, "cpu"),
               lambda: jenc.encode_page_device(arr, cdc),
               lambda: HOST_ENC[cdc](arr)):
        try:
            out.append(fn())
        except ValueError:
            out.append(None)
    return out


@pytest.mark.parametrize("arr,cdc", CASES)
def test_device_page_equals_jax_and_host(arr, cdc):
    port, jax_page, host = _pages(arr, cdc)
    assert port is not None, "the device arm declined an encodable column"
    assert port == jax_page == host
    out = HOST_DEC[cdc](port, arr.dtype.str, arr.shape)
    assert out.dtype == arr.dtype and np.array_equal(out, arr)


def _column(rng, dtype, n, k, smooth):
    info = np.iinfo(dtype)
    if smooth:  # small steps both ways: dbp earns its page
        steps = rng.integers(-40, 41, (n, k))
        base = rng.integers(max(info.min, -100), min(info.max, 100) + 1, (1, k))
        a = (base + np.cumsum(steps, axis=0)).astype(np.int64)
    else:  # a few distinct values with runs: rle and dct
        a = rng.integers(0, 4, (n, k)).repeat(2, axis=0)[:n]
    a = a.astype(dtype)
    return a[:, 0].copy() if k == 1 else a


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.int64, np.uint64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("k", [1, 3], ids=["n", "n_by_k"])
def test_dtype_and_length_grid(dtype, k):
    """u8/u16/u32/i64/u64 columns of shape (n,) and (n, k), n on either
    side of the padding boundary: the three arms agree, to the ValueError
    of a width over the cap."""
    rng = np.random.default_rng(k * 31 + np.dtype(dtype).itemsize)
    for n in LENGTHS:
        for smooth in (True, False):
            arr = _column(rng, dtype, n, k, smooth)
            for cdc in CODECS:
                port, jax_page, host = _pages(arr, cdc)
                assert port == jax_page == host, (n, smooth, cdc)


def _mixed_pages(rng, n):
    """(array, codec) pages of every codec at n rows: u8/u16/u32/i64/u64
    columns of shape (n,) and (n, 3), smooth and with runs; dbp columns of
    delta widths 0, 1, 31 and 32 and a dbp page of 20 columns; dct pages
    of index widths 0 and 1. Pages whose width the host refuses are left
    out (a batch with one raises as a whole)."""
    cols = [_column(rng, dtype, n, k, smooth)
            for dtype in (np.uint8, np.uint16, np.uint32, np.int64, np.uint64)
            for k in (1, 3) for smooth in (True, False)]
    wide = np.concatenate([[0], rng.integers(-(1 << 29), 1 << 29, n - 1)])
    wide[-1] = 1 << 29
    cols += [np.full(n, 7, np.uint64), (n - np.arange(n, dtype=np.uint32) // 2),
             np.cumsum(wide).astype(np.int64), np.cumsum(wide * 2).astype(np.int64),
             np.cumsum(rng.integers(-3, 4, (n, 20)), axis=0).astype(np.int32),
             rng.integers(0, 2, n).astype(np.uint32)]
    pages = []
    for arr in cols:
        for cdc in CODECS:
            try:
                HOST_ENC[cdc](arr)
            except ValueError:
                continue
            pages.append((arr, cdc))
    return pages


@pytest.mark.parametrize("n", [2, 3, 9, 8193])
def test_mixed_batch_equals_jax_and_host(n):
    """One batched dispatch over every codec, dtype, shape and edge width:
    each page equals the JAX package's device page and the host page."""
    pages = _mixed_pages(np.random.default_rng(n), n)
    widths = {w for a, c in pages if c == "dbp"
              for w in lw.dbp_parts(HOST_ENC[c](a), a.dtype.str, a.shape)[2]}
    assert {0, 1, 31, 32} <= widths and any(a.ndim == 2 and a.shape[1] > 16 for a, _ in pages)
    before = STATS.dispatches.get("page_encode", 0)
    got = tenc.encode_pages_device(pages, "cpu")
    assert STATS.dispatches.get("page_encode", 0) == before + 1
    for (arr, cdc), page in zip(pages, got):
        assert page == jenc.encode_page_device(arr, cdc) == HOST_ENC[cdc](arr), (arr.dtype, arr.shape, cdc)


def test_batch_of_one():
    arr = np.repeat(np.arange(7, dtype=np.uint64) * 3, 5)
    for cdc in CODECS:
        assert tenc.encode_pages_device([(arr, cdc)], "cpu") == [jenc.encode_page_device(arr, cdc)]
        assert tenc.encode_pages_device([(arr, cdc)], "cpu") == [HOST_ENC[cdc](arr)]


def test_batch_declines_what_the_host_takes():
    """Under 2 rows or a codec outside the lightweight tier: None in its
    place, the rest of the batch encoded; a batch of only those makes no
    dispatch."""
    arr = np.repeat(np.arange(5, dtype=np.uint32), 3)
    before = STATS.dispatches.get("page_encode", 0)
    assert tenc.encode_pages_device([(arr[:1], "rle"), (arr, "zstd")], "cpu") == [None, None]
    assert STATS.dispatches.get("page_encode", 0) == before
    got = tenc.encode_pages_device([(arr[:1], "dbp"), (arr, "rle"), (arr, "none")], "cpu")
    assert got == [None, lw.rle_encode(arr), None]


def test_staging_is_reused_and_grows():
    """One writer's staging over batches of growing and shrinking sizes."""
    staging = tenc.PageStaging("cpu")
    rng = np.random.default_rng(5)
    for n in (9, 70_000, 3):
        pages = [(rng.integers(0, 4, n).astype(np.uint32), c) for c in CODECS]
        assert tenc.encode_pages_device(pages, "cpu", staging) == [HOST_ENC[c](a) for a, c in pages]


def test_width_over_the_cap_raises_through_the_batch():
    pages = [(np.arange(9, dtype=np.uint32), "rle"),
             (np.array([0, 1 << 40, 0, 1 << 40], np.uint64), "dbp")]
    with pytest.raises(ValueError, match="exceeds cap"):
        tenc.encode_pages_device(pages, "cpu")


def _counting(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(tenc, name)

        def counted(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(tenc, name, counted)
    return calls


def test_writer_makes_one_batched_call_a_row_group(tmp_path, monkeypatch):
    """Each row group's lightweight pages go through one batched call:
    one plain rle_change_mask and one plain dbp_pack, one dispatch."""
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.vtpu import create

    calls = _counting(monkeypatch, ["_rle_change_plain", "_dbp_pack_plain", "encode_prepared"])
    before = STATS.dispatches.get("page_encode", 0)
    meta = create.write_block([synth.make_batch(400, 6, seed=8)], "t",
                              TypedBackend(LocalBackend(str(tmp_path))),
                              BlockConfig(row_group_spans=512), block_id="b", device="cpu")
    n_rg = meta.total_records
    assert n_rg == 5
    assert calls == {"_rle_change_plain": n_rg, "_dbp_pack_plain": n_rg, "encode_prepared": n_rg}
    assert STATS.dispatches.get("page_encode", 0) - before == n_rg


@pytest.mark.parametrize("plain", ["_rle_change_plain", "_dbp_pack_plain"])
def test_failing_plain_version_raises_through_the_batch(tmp_path, monkeypatch, plain):
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.vtpu import create

    def boom(*a, **kw):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(tenc, plain, boom)
    arr = np.array([3, 1, 2, 1, 3, 3, 9, 9, 9], np.uint32)
    with pytest.raises(RuntimeError, match="injected"):
        tenc.encode_pages_device([(arr, c) for c in CODECS], "cpu")
    with pytest.raises(RuntimeError, match="injected"):
        create.write_block([synth.make_batch(50, 4, seed=2)], "t",
                           TypedBackend(LocalBackend(str(tmp_path))), BlockConfig(), device="cpu")
    assert all(tenc.encode_fallback_total.value(codec=c) == 0 for c in CODECS)


def test_dbp_width_cap_raises_like_host():
    """A delta wider than the 32-bit cap is a contract violation on both
    arms, not a device failure."""
    arr = np.array([0, 1 << 40, 0, 1 << 40], np.uint64)
    with pytest.raises(ValueError):
        lw.dbp_encode(arr)
    with pytest.raises(ValueError):
        tenc.encode_page_device(arr, "dbp", "cpu")
    with pytest.raises(ValueError):
        codec.encode(arr, "dbp")
    assert tenc.encode_fallback_total.value(codec="dbp") == 0


def test_tiny_and_empty_columns_decline_to_host():
    for arr in (np.zeros(0, np.uint32), np.array([9], np.uint64)):
        for cdc in CODECS:
            assert tenc.encode_page_device(arr, cdc, "cpu") is None
            assert jenc.encode_page_device(arr, cdc) is None
            assert codec.encode(arr, cdc)[0] == HOST_ENC[cdc](arr)


@pytest.mark.parametrize("switch", ["0", "1", None])
def test_codec_encode_identical_across_switch(switch, monkeypatch):
    """The same bytes whatever the switch; the device counter moves only
    with the arm on."""
    if switch is None:
        monkeypatch.delenv("TEMPO_TPU_DEVICE_ENCODE")
    else:
        monkeypatch.setenv("TEMPO_TPU_DEVICE_ENCODE", switch)
    arr = np.repeat(np.arange(5, dtype=np.uint32), 50)
    for cdc in CODECS:
        before = tenc.device_encode_pages_total.value(codec=cdc)
        page, crc = codec.encode(arr, cdc, "cpu")
        assert (page, crc) == (HOST_ENC[cdc](arr), codec.zlib.crc32(arr.tobytes()))
        moved = tenc.device_encode_pages_total.value(codec=cdc) - before
        assert moved == (1 if switch == "1" else 0)


def test_unset_switch_follows_the_writers_device(monkeypatch):
    monkeypatch.delenv("TEMPO_TPU_DEVICE_ENCODE")
    assert not tenc.device_encode_enabled(None)
    assert not tenc.device_encode_enabled("cpu")
    assert tenc.device_encode_enabled("cuda")
    assert tenc.device_encode_enabled(torch.device("cuda", 0))
    monkeypatch.setenv("TEMPO_TPU_DEVICE_ENCODE", "0")
    assert not tenc.device_encode_enabled("cuda")


@pytest.mark.parametrize("cdc,plain", [("rle", "_rle_change_plain"), ("dbp", "_dbp_pack_plain"),
                                       ("dct", "_dbp_pack_plain")])
def test_kernel_failure_raises(cdc, plain, monkeypatch):
    """No host fallback: a failing kernel fails the encode, the fallback
    counter stays at 0 and no page comes back."""
    def boom(*a, **kw):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(tenc, plain, boom)
    arr = np.array([3, 1, 2, 1, 3, 3, 9, 9, 9], np.uint32)
    with pytest.raises(RuntimeError, match="injected"):
        codec.encode(arr, cdc, "cpu")
    assert tenc.encode_fallback_total.value(codec=cdc) == 0


def test_device_encoded_dbp_decodes_on_the_device_path():
    rng = np.random.default_rng(3)
    arr = np.uint64(1 << 60) + np.cumsum(rng.integers(0, 1 << 16, 500).astype(np.uint64))
    page = tenc.encode_page_device(arr, "dbp", "cpu")
    out = pallas_kernels.dbp_decode_device(page, arr.dtype.str, arr.shape, "cpu")
    assert np.array_equal(out, arr)


@pytest.mark.parametrize("seed", [3, 4])
def test_block_with_the_arm_forced_equals_jax(tmp_path, seed):
    pair = Pair(tmp_path)
    batch = synth.make_batch(400, 6, seed=seed)
    before = {c: tenc.device_encode_pages_total.value(codec=c) for c in CODECS}
    jmeta, tmeta = pair.write(batch, "b", {"row_group_spans": 512})
    assert_same_objects(*pair.objects(jmeta, tmeta))
    moved = {c: tenc.device_encode_pages_total.value(codec=c) - before[c] for c in CODECS}
    assert all(moved.values()), moved


def test_compaction_with_the_arm_forced_equals_jax(tmp_path):
    cfg = {"row_group_spans": 512}
    pair = Pair(tmp_path)
    metas = [pair.write(synth.make_batch(300, 5, seed=s), f"b{s}", cfg) for s in (21, 22)]
    jc = JCompactor(JOptions(block_config=JConfig(**cfg), zero_decode=False))
    tc = VtpuCompactor(CompactionOptions(block_config=BlockConfig(**cfg), zero_decode=False),
                       device="cpu")
    (jout,) = jc.compact([m[0] for m in metas], "t", pair.jb)
    (tout,) = tc.compact([m[1] for m in metas], "t", pair.tb)
    assert_same_objects(*pair.objects(jout, tout))


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _staged(plans):
    """A PageBatch of plans, its filled staging buffer as a CPU int32
    tensor, and a zeroed output buffer."""
    batch = tenc.PageBatch(plans)
    buf = np.zeros(batch.in_words, np.uint32)
    batch.fill(buf)
    return batch, torch.from_numpy(buf.view(np.int32)), torch.zeros(max(batch.out_words, 1),
                                                                    dtype=torch.int32)


def _launched_on(batch, data, out, device):
    """The batch's launches on `device` (the plain versions on the CPU) ->
    the output words on the CPU, and the launches each kernel made."""
    before = (tenc.rle_change_mask.launches, tenc.dbp_pack.launches)
    got = out.clone().to(device)
    batch.launch(data.to(device), got)
    return got.cpu(), (tenc.rle_change_mask.launches - before[0],
                       tenc.dbp_pack.launches - before[1])


def _limb_plan(rng, n, item_bits, widths):
    """A dbp plan of random limbs (masked to the item width) packed at
    the given widths, or a pack-mode plan (item_bits 0) of random values."""
    p = tenc.PagePlan(np.zeros(n, np.uint32), "dbp" if item_bits else "dct")
    p.item_bits = item_bits
    for w in widths:
        lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        if 0 < item_bits < 32:
            lo &= np.uint32((1 << item_bits) - 1)
        hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        p.cols.append((w, lo, hi if item_bits == 64 else None))
    return p


def _mixed_plans(rng, n):
    """Every codec's plans at n rows: rle pages of 1, 3, 4 and 8 lanes
    (some rows the absent sentinel), random limbs of every item width
    at widths 0, 1, 31 and 32, 20 dbp columns of one page, dct pages."""
    plans = []
    for k in (1, 3, 4, 8):
        a = rng.integers(0, 3, (n, k)).astype(np.uint32)
        a[rng.random(n) < 0.3] = ABSENT
        plans.append(tenc.prepare_page(a if k > 1 else a[:, 0].copy(), "rle"))
    for item_bits in (0, 8, 16, 32, 64):
        plans.append(_limb_plan(rng, n, item_bits, [0, 1, 31, 32]))
    plans.append(tenc.prepare_page(np.cumsum(rng.integers(-3, 4, (n, 20)), 0).astype(np.int32), "dbp"))
    plans.append(tenc.prepare_page(rng.integers(0, 9, n).astype(np.uint16), "dct"))
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 9, 8193])
@pytest.mark.parametrize("k", [1, 4])
def test_rle_change_mask_kernel_equals_plain(cuda_device, n, k):
    rng = np.random.default_rng(n * k)
    a = rng.integers(0, 3, (n, k)).astype(np.uint32)
    a[rng.random(n) < 0.3] = ABSENT
    plans = [tenc.prepare_page(a, "rle"), tenc.prepare_page(a[::-1].copy(), "rle")]
    batch, data, out = _staged(plans)
    got, launched = _launched_on(batch, data, out, cuda_device)
    assert launched == (1, 0)
    assert torch.equal(got, _launched_on(batch, data, out, "cpu")[0])


@pytest.mark.cuda
@pytest.mark.parametrize("item_bits", [0, 8, 16, 32, 64])
@pytest.mark.parametrize("n", [2, 3, 9, 8193])
def test_dbp_pack_kernel_equals_plain(cuda_device, item_bits, n):
    rng = np.random.default_rng(item_bits + n)
    plans = [_limb_plan(rng, n, item_bits, [0, 1, 31, 32]), _limb_plan(rng, n, item_bits, [7])]
    batch, data, out = _staged(plans)
    got, launched = _launched_on(batch, data, out, cuda_device)
    assert launched == (0, 1)
    assert torch.equal(got, _launched_on(batch, data, out, "cpu")[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 9, 2049, 8193])
def test_batched_kernels_on_mixed_tables_equal_plain(cuda_device, n):
    """Every codec, item width and edge width in one batch: one launch of
    each kernel, the same words as the plain versions."""
    batch, data, out = _staged(_mixed_plans(np.random.default_rng(n), n))
    got, launched = _launched_on(batch, data, out, cuda_device)
    assert launched == (1, 1)
    assert torch.equal(got, _launched_on(batch, data, out, "cpu")[0])


@pytest.mark.cuda
def test_wide_rle_rows_take_opted_in_shared_memory(cuda_device):
    """600 lanes a row: 32-row tiles of 77 KB, above the 48 KB default."""
    rng = np.random.default_rng(600)
    a = rng.integers(0, 2, (300, 600)).astype(np.uint32).repeat(2, axis=0)
    batch, data, out = _staged([tenc.prepare_page(a, "rle")])
    assert batch.rle_table[0, 5] == 32
    got, _ = _launched_on(batch, data, out, cuda_device)
    assert torch.equal(got, _launched_on(batch, data, out, "cpu")[0])


@pytest.mark.cuda
def test_pages_batch_on_the_card_equals_host(cuda_device):
    arrs = [(arr, c) for arr, c in ((p.values[0], p.values[1]) for p in CASES)]
    before = STATS.dispatches.get("page_encode", 0)
    got = tenc.encode_pages_device(arrs, cuda_device)
    assert STATS.dispatches.get("page_encode", 0) == before + 1
    assert got == [HOST_ENC[c](arr) for arr, c in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("arr,cdc", CASES)
def test_device_page_on_the_card_equals_host(cuda_device, arr, cdc):
    assert tenc.encode_page_device(arr, cdc, cuda_device) == HOST_ENC[cdc](arr)


@pytest.mark.cuda
def test_block_on_the_card_with_the_arm_equals_cpu(tmp_path, cuda_device, monkeypatch):
    """The card's write runs the arm (switch unset, cuda writer), the
    CPU's the host encoders: the same bytes."""
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.vtpu import create
    from test_torch_blocks import block_objects

    monkeypatch.delenv("TEMPO_TPU_DEVICE_ENCODE")
    batch = synth.make_batch(400, 6, seed=5)
    objs = []
    for dev in ("cuda", "cpu"):
        root = str(tmp_path / dev)
        before = tenc.device_encode_pages_total.value(codec="rle")
        meta = create.write_block([batch], "t", TypedBackend(LocalBackend(root)),
                                  BlockConfig(row_group_spans=512), block_id="b", device=dev)
        moved = tenc.device_encode_pages_total.value(codec="rle") - before
        assert (moved > 0) == (dev == "cuda")
        objs.append(block_objects(root, "t", meta.block_id))
    assert_same_objects(*objs)
