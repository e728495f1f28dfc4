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
the JAX package's. The `cuda` tests hold the two kernels (rle_change_mask
and dbp_pack) against their plain versions on the card, and a card-
written block against the CPU's, and skip here. Tolerance: exact bytes.
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 9, 8193])
@pytest.mark.parametrize("k", [1, 4])
def test_rle_change_mask_kernel_equals_plain(cuda_device, n, k):
    rng = np.random.default_rng(n * k)
    a = rng.integers(0, 3, (n, k)).astype(np.uint32)
    a[rng.random(n) < 0.3] = ABSENT
    up = torch.from_numpy(tenc._pad_rows(a, tenc._pow2(n)).view(np.int32))
    before = tenc.rle_change_mask.launches
    got = tenc.rle_change_mask(up.to(cuda_device))
    assert tenc.rle_change_mask.launches == before + 1
    assert torch.equal(got.cpu(), tenc._rle_change_plain(up))


@pytest.mark.cuda
@pytest.mark.parametrize("item_bits", [0, 8, 16, 32, 64])
@pytest.mark.parametrize("n", [2, 3, 9, 8193])
def test_dbp_pack_kernel_equals_plain(cuda_device, item_bits, n):
    rng = np.random.default_rng(item_bits + n)
    n_pad = tenc._pow2(n)
    lo = rng.integers(0, 1 << 32, (4, n), dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, (4, n), dtype=np.uint64).astype(np.uint32)
    if item_bits and item_bits < 32:
        lo &= np.uint32((1 << item_bits) - 1)
    lo = np.ascontiguousarray(tenc._pad_rows(lo.T, n_pad).T)
    hi = np.ascontiguousarray(tenc._pad_rows(hi.T, n_pad).T)
    widths = [0, 1, 31, 32]
    args = [torch.from_numpy(lo.view(np.int32)), torch.from_numpy(hi.view(np.int32))]
    before = tenc.dbp_pack.launches
    got = tenc.dbp_pack(*(a.to(cuda_device) for a in args), item_bits, widths)
    assert tenc.dbp_pack.launches == before + 1
    want = tenc._dbp_pack_plain(*args, item_bits, widths)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


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
