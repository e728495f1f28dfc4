"""The port's three kernels (tempo_tpu_torch.ops.pallas_kernels) against
the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; those are held
bit for bit against the JAX wrappers (Pallas in interpret mode on the
CPU, or its numpy arm) over every case of tests/test_pallas.py. The
CUDA kernels themselves run only on the card: the tests marked `cuda`
compare them with the plain versions there and skip elsewhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_kernels as jpk
from tempo_tpu_torch.ops import pallas_kernels as pk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# seg_bincount
# ---------------------------------------------------------------------------


def _slots(n, n_slots, seed, neg=True):
    rng = np.random.default_rng(seed)
    s = rng.integers(-3 if neg else 0, n_slots, n).astype(np.int32)
    s[: n // 3] = np.sort(s[: n // 3])  # runs, so compress_slot_runs has work
    return s


@pytest.mark.parametrize("n,n_slots", [(1, 128), (1000, 300), (5000, 3840), (20000, 990_720)])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_bincount_plain_matches_numpy_arm(n, n_slots, weighted):
    s = _slots(n, n_slots, n)
    w = np.random.default_rng(1).integers(1, 50, n).astype(np.int32) if weighted else None
    want = jpk.seg_bincount(s, n_slots, weights=w)  # numpy int64 arm on a CPU host
    got = pk.seg_bincount(torch.from_numpy(s), n_slots,
                          weights=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("n,n_slots,weighted", [(700, 200, True), (1024, 1000, False),
                                                (3000, 4096, True)])
def test_seg_bincount_plain_matches_pallas_interpret(n, n_slots, weighted):
    s = _slots(n, n_slots, 7)
    w = np.random.default_rng(2).integers(1, 9, n).astype(np.int32) if weighted else None
    n_pad = -(-n // 256) * 256
    s_pad = 128
    while s_pad < n_slots:
        s_pad <<= 1
    sp = np.full(n_pad, -1, np.int32)
    sp[:n] = s
    wp = np.zeros(n_pad, np.int32)
    wp[:n] = 1 if w is None else w
    want = np.asarray(jpk._bincount_call(jnp.asarray(sp), jnp.asarray(wp), s_pad, True))
    got = pk.seg_bincount(torch.from_numpy(s), n_slots,
                          weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(want[:n_slots].astype(np.int64), got.numpy())


def test_seg_bincount_drops_out_of_range_and_keeps_negative_weights():
    s = torch.tensor([-1, 0, 5, 6, 100, 5, 2**31 - 1], dtype=torch.int32)
    w = torch.tensor([9, 1, 2, 3, 4, -7, 8], dtype=torch.int32)
    got = pk.seg_bincount(s, 6, weights=w)
    assert got.tolist() == [1, 0, 0, 0, 0, -5]


def test_seg_bincount_empty_does_not_launch():
    before = pk.seg_bincount.launches
    got = pk.seg_bincount(torch.zeros(0, dtype=torch.int32), 10)
    assert got.tolist() == [0] * 10 and pk.seg_bincount.launches == before


@pytest.mark.parametrize("n_slots", [300, 990_720])
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_bincount_into_accumulates_like_separate_calls(n_slots, weighted):
    # several flushes added into one vector == the sum of separate calls
    # == the sum of the JAX numpy arm's vectors
    rng = np.random.default_rng(n_slots + weighted)
    out = torch.zeros(n_slots, dtype=torch.int64)
    separate = torch.zeros(n_slots, dtype=torch.int64)
    want = np.zeros(n_slots, np.int64)
    for i, n in enumerate((1, 777, 5000, 0, 3)):
        s = _slots(n, n_slots, 100 + i)
        w = rng.integers(-70000, 70000, n).astype(np.int32) if weighted else None
        s_t, w_t = torch.from_numpy(s), None if w is None else torch.from_numpy(w)
        pk.seg_bincount_into(out, s_t, n_slots, w_t)
        separate += pk.seg_bincount(s_t, n_slots, weights=w_t)
        if n:
            want += jpk.seg_bincount(s, n_slots, weights=w)
    assert torch.equal(out, separate)
    np.testing.assert_array_equal(want, out.numpy())


@pytest.mark.parametrize("out", [torch.zeros(9, dtype=torch.int64),
                                 torch.zeros(10, dtype=torch.int32)])
def test_seg_bincount_into_refuses_a_wrong_output(out):
    with pytest.raises(ValueError, match="out must be"):
        pk.seg_bincount_into(out, torch.tensor([1, 2], dtype=torch.int32), 10)


def test_wrappers_refuse_other_devices():
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        pk.seg_bincount(meta, 8)


def test_cpu_tensors_take_the_plain_version():
    counts = (pk.seg_bincount.launches, pk.in_set_scan.launches, pk.u64_range_scan.launches)
    pk.seg_bincount(torch.tensor([1, 1], dtype=torch.int32), 4)
    pk.in_set_scan([torch.arange(10)], [torch.tensor([3])], 1024)
    pk.u64_range_scan(torch.arange(10), 2, 5, 1024)
    assert counts == (pk.seg_bincount.launches, pk.in_set_scan.launches,
                      pk.u64_range_scan.launches)


@pytest.mark.parametrize("stream", ["runs", "no_runs", "empty", "short", "long_tail_runs"])
def test_compress_slot_runs(stream):
    rng = np.random.default_rng(3)
    s = {
        "runs": np.repeat(rng.integers(-1, 50, 400), 8),
        "no_runs": rng.integers(0, 10**6, 4000),
        "empty": np.zeros(0, np.int64),
        "short": np.array([4, 4, 4, 1, 1, -1, -1, -1]),
        "long_tail_runs": np.concatenate([rng.integers(0, 10**6, 300),
                                          np.repeat(np.arange(50), 100)]),
    }[stream].astype(np.int64)
    ws, ww = jpk.compress_slot_runs(s)
    ts, tw = pk.compress_slot_runs(s)
    np.testing.assert_array_equal(ws, ts)
    assert ws.dtype == ts.dtype
    assert (ww is None) == (tw is None)
    if ww is not None:
        np.testing.assert_array_equal(ww, tw)


# ---------------------------------------------------------------------------
# in_set_scan / u64_range_scan over the cases of tests/test_pallas.py
# ---------------------------------------------------------------------------


def _in_set_both(cols, sets_, n_pad):
    want = np.asarray(jpk.in_set_scan(cols, sets_, n_pad))
    got = pk.in_set_scan([torch.from_numpy(c) for c in cols],
                         [torch.from_numpy(s) for s in sets_], n_pad)
    assert got.dtype == torch.bool and got.shape == (n_pad,)
    np.testing.assert_array_equal(want, got.numpy())
    return got.numpy()


@pytest.mark.parametrize("n,c,s", [(1024, 1, 1), (1024, 3, 4), (2048, 2, 7), (4096, 4, 1)])
def test_in_set_scan_matches_jax(n, c, s):
    rng = np.random.default_rng(n + c + s)
    cols = [rng.integers(0, 50, n).astype(np.uint32) for _ in range(c)]
    sets_ = [rng.choice(50, size=s, replace=False).astype(np.uint32) for _ in range(c)]
    _in_set_both(cols, sets_, n)


def test_in_set_scan_partial_fill_pads_false():
    got = _in_set_both([np.zeros(700, np.uint32)], [np.array([0], np.uint32)], 1024)
    assert got[:700].all() and not got[700:].any()


def test_in_set_scan_no_match_sentinel_set():
    got = _in_set_both([np.arange(1024, dtype=np.uint32)], [np.array([jpk.NO_MATCH_CODE])], 1024)
    assert not got.any()


def test_in_set_scan_uint16_column():
    got = _in_set_both([np.full(1024, 500, np.uint16)], [np.array([500], np.uint32)], 1024)
    assert got.all()


def _mixed_columns(n, offset, seed):
    """uint32, uint16 and int64 code columns (the int64 one with -1, which
    is 0xFFFFFFFF as uint32), each a view starting `offset` rows in."""
    rng = np.random.default_rng(seed)
    full = [rng.integers(0, 40, n + offset).astype(dt) for dt in (np.uint32, np.uint16, np.int64)]
    full[2][offset: offset + 9] = -1
    return [c[offset:] for c in full]


@pytest.mark.parametrize("n,offset", [(2048, 0), (2047, 1), (1000, 3), (1, 1), (1029, 5)])
def test_in_set_scan_mixed_dtypes_views_and_ragged_n(n, offset):
    cols = _mixed_columns(n, offset, n + offset)
    sets_ = [np.array(s, np.uint32) for s in (range(0, 40, 2), range(25), [0xFFFFFFFF, *range(30)])]
    n_pad = -(-n // pk.TILE) * pk.TILE
    got = _in_set_both(cols, sets_, n_pad)
    assert 0 < got.sum() < n or n == 1
    assert not got[n:].any()


@pytest.mark.parametrize("n", [1024, 1000])
def test_in_set_scan_sentinel_value_matches_padding(n):
    # a column value 0xFFFFFFFF matches a code set padded with the same
    # sentinel inside [0, n): the JAX kernel's behaviour, kept as is
    col = np.arange(n, dtype=np.uint32)
    col[:5] = 0xFFFFFFFF
    got = _in_set_both([col], [np.array([7, 8, 9], np.uint32)], 1024)
    assert got[:5].all() and got[7:10].all() and got.sum() == 8


@pytest.mark.parametrize("lo,hi", [(0, 2**64 - 1), (10**9, 5 * 10**9), (0, 10**6), (2**40, 2**63),
                                   ((7 << 32) | 0xFFFFFFFF, 9 << 32)])
def test_u64_range_scan_matches_jax(lo, hi):
    rng = np.random.default_rng(int(lo % 97))
    v = rng.integers(0, 2**63, 2048).astype(np.uint64)
    v[:10] = [0, 1, lo, max(lo - 1, 0), lo + 1, hi, hi - 1, min(hi + 1, 2**64 - 1), 2**32, 2**32 - 1]
    want = np.asarray(jpk.u64_range_scan(v, lo, hi, 2048))
    got = pk.u64_range_scan(torch.from_numpy(v.view(np.int64)), lo, hi, 2048)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(got.numpy(), (v >= lo) & (v <= hi))
    got_u64 = pk.u64_range_scan(torch.from_numpy(v), lo, hi, 2048)
    np.testing.assert_array_equal(want, got_u64.numpy())


def test_u64_range_scan_pad_rows_masked_even_when_zero_in_range():
    v = np.full(100, 5, np.uint64)
    want = np.asarray(jpk.u64_range_scan(v, 0, 10, 1024))
    got = pk.u64_range_scan(torch.from_numpy(v.view(np.int64)), 0, 10, 1024).numpy()
    np.testing.assert_array_equal(want, got)
    assert got[:100].all() and not got[100:].any()


def test_scans_reject_unpadded_sizes():
    with pytest.raises(ValueError):
        pk.in_set_scan([torch.arange(10)], [torch.tensor([1])], 1000)
    with pytest.raises(ValueError):
        pk.u64_range_scan(torch.arange(10), 0, 1, 1000)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [3840, 990_720])
def test_seg_bincount_kernel_matches_plain(cuda_device, n_slots):
    s = torch.from_numpy(_slots(1 << 20, n_slots, 5)).to(cuda_device)
    w = torch.randint(-5, 100, (1 << 20,), dtype=torch.int32, device=cuda_device)
    for weights in (None, w):
        before = pk.seg_bincount.launches
        got = pk.seg_bincount(s, n_slots, weights=weights)
        assert pk.seg_bincount.launches == before + 1
        assert torch.equal(got, pk._seg_bincount_plain(s, n_slots, weights))


@pytest.mark.cuda
def test_scan_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(0)
    cols = [torch.from_numpy(rng.integers(0, 30, 5000).astype(np.int64)) for _ in range(3)]
    sets_ = [torch.tensor([1, 2, 3]), torch.tensor([4]), torch.tensor([5, 6, 7, 8, 9])]
    want = pk.in_set_scan(cols, sets_, 5120)
    got = pk.in_set_scan([c.to(cuda_device) for c in cols],
                         [s.to(cuda_device) for s in sets_], 5120)
    assert torch.equal(got.cpu(), want)
    v = torch.from_numpy(rng.integers(0, 2**62, 5000))
    want = pk.u64_range_scan(v, 2**40, 2**61, 5120)
    assert torch.equal(pk.u64_range_scan(v.to(cuda_device), 2**40, 2**61, 5120).cpu(), want)


# n_slots below, at and above the dense shared-memory arm's limit (49,152
# slots), 2**15 (the TPU kernel's limit), the quantile query's 990,720 and
# the plan's MAX_SLOTS
_EDGE_SLOTS = [1, (1 << 15) - 1, 1 << 15, (1 << 15) + 1, 49_151, 49_152, 49_153, 990_720, 1 << 22]


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", _EDGE_SLOTS)
@pytest.mark.parametrize("n", [1, 3, 4097, 1 << 20])
def test_seg_bincount_kernel_edge_shapes(cuda_device, n_slots, n):
    rng = np.random.default_rng(n_slots + n)
    s = torch.from_numpy(rng.integers(-3, n_slots + 3, n + 2).astype(np.int32)).to(cuda_device)
    w_np = rng.integers(-9, 10, n + 2).astype(np.int32)
    w_np[::5] = np.resize(np.array([65535, 65536, -65536, 2**31 - 1, -2**31, 70000], np.int32),
                          len(w_np[::5]))
    w = torch.from_numpy(w_np).to(cuda_device)
    dropped = torch.where(s >= 0, s + n_slots, s)
    # aligned, weighted, views at odd offsets, every row dropped
    for slots, weights in ((s[:n], None), (s[:n], w[:n]), (s[1:n + 1], w[2:n + 2]),
                           (dropped[:n], w[:n])):
        want = pk._seg_bincount_plain(slots, n_slots, weights)
        before = pk.seg_bincount.launches
        got = pk.seg_bincount(slots, n_slots, weights=weights)
        assert pk.seg_bincount.launches == before + 1
        assert torch.equal(got, want)
        pk.seg_bincount_into(got, slots, n_slots, weights)
        assert torch.equal(got, 2 * want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1 << 20, 1), ((1 << 20) - 5, 3),
                                      (1000, 1), (1, 1)])
def test_in_set_scan_kernel_misaligned_and_ragged(cuda_device, n, offset):
    # the views are taken on the card, so that they start `offset` rows
    # past an aligned allocation
    full = [torch.from_numpy(c).to(cuda_device) for c in _mixed_columns(n + offset, 0, n)]
    cols = [c[offset:] for c in full]
    sets_ = [torch.tensor(s) for s in (range(0, 40, 2), range(25), range(30))]
    n_pad = -(-n // pk.TILE) * pk.TILE
    want = pk.in_set_scan([c.cpu() for c in cols], sets_, n_pad)
    before = pk.in_set_scan.launches
    got = pk.in_set_scan(cols, sets_, n_pad)
    assert pk.in_set_scan.launches == before + 1
    assert torch.equal(got.cpu(), want)
