"""rle_cols_hit — the fused run-length decode + in-set scan — against
the JAX package's jnp program, exactly.

The plain version (the CPU route of every wrapper) is held against
rle_cols_hit and rle_cols_hit_live over seeded payloads with padding
runs (the NO_MATCH value, length 0), runs whose total falls short of n
(rows past it repeat the LAST run's verdict, even a zero-length one) and
runs that overrun n (cut), dead columns (accept all, padding rows
included) and a column value equal to the sentinel (never matches); the
wrappers fused_rle_in_set and batched_rle_in_set and the plain torch ops
rle_expand_device and unshuffle_device against theirs. The `cuda` tests
hold the kernel against the plain version on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import pallas_kernels as jpk
from tempo_tpu_torch.ops import pallas_kernels as tpk

NO_MATCH = 0xFFFFFFFF


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def _case(seed: int, C: int, RP: int, K: int, n: int):
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 6, (C, RP)).astype(np.uint32)
    values[rng.random((C, RP)) < 0.15] = NO_MATCH
    lengths = rng.integers(0, 6, (C, RP)).astype(np.int32)
    if seed % 3 == 0:
        lengths[:, -2:] = 0  # zero-length padding runs at the end
        values[:, -2:] = NO_MATCH
    if seed % 4 == 1:
        lengths[0, 0] = n + 3  # a run that overruns n
    codes = np.full((C, K), NO_MATCH, np.uint32)
    k = int(rng.integers(0, K + 1))
    codes[:, :k] = rng.integers(0, 6, (C, k))
    hit = rng.random(n) < 0.85
    live = rng.random(C) < 0.7
    return values, lengths, codes, hit, live


@pytest.mark.parametrize("seed", range(24))
def test_plain_matches_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    C, RP, K, n = int(rng.integers(1, 4)), int(rng.integers(1, 20)), int(rng.integers(1, 9)), \
        int(rng.integers(1, 70))
    values, lengths, codes, hit, live = _case(seed, C, RP, K, n)
    want = np.asarray(jpk.rle_cols_hit(jnp.asarray(values), jnp.asarray(lengths),
                                       jnp.asarray(codes), n, jnp.asarray(hit)))
    got = tpk.rle_cols_hit(_t(values), _t(lengths), _t(codes), n, _t(hit)).numpy()
    assert np.array_equal(want, got)
    want = np.asarray(jpk.rle_cols_hit_live(jnp.asarray(values), jnp.asarray(lengths),
                                            jnp.asarray(codes), jnp.asarray(live), n,
                                            jnp.asarray(hit)))
    got = tpk.rle_cols_hit_live(_t(values), _t(lengths), _t(codes), _t(live), n, _t(hit)).numpy()
    assert np.array_equal(want, got)


def test_padding_and_truncation_rules():
    # repeat([T,F,T],[2,1,0],6) = [T,T,F,T,T,T]: rows past the total take
    # the last run, even a zero-length one
    values = np.array([[1, 2, 1]], np.uint32)
    codes = np.array([[1, NO_MATCH]], np.uint32)
    for lengths, n, want in (
        ([2, 1, 0], 6, [1, 1, 0, 1, 1, 1]),
        ([2, 1, 5], 4, [1, 1, 0, 1]),  # the last run overruns n: cut
        ([5, 1, 1], 3, [1, 1, 1]),  # the first run covers every row
        ([0, 0, 0], 2, [1, 1]),  # no rows at all: the last run fills them
    ):
        lens = np.array([lengths], np.int32)
        hit = np.ones(n, bool)
        j = np.asarray(jpk.rle_cols_hit(jnp.asarray(values), jnp.asarray(lens),
                                        jnp.asarray(codes), n, jnp.asarray(hit)))
        t = tpk.rle_cols_hit(_t(values), _t(lens), _t(codes), n, _t(hit)).numpy()
        assert list(j.astype(int)) == list(t.astype(int)) == want
    # the sentinel never matches, even a value equal to it
    v = np.array([[NO_MATCH, 3]], np.uint32)
    lens = np.array([[2, 2]], np.int32)
    c = np.array([[NO_MATCH, 3]], np.uint32)
    t = tpk.rle_cols_hit(_t(v), _t(lens), _t(c), 4, torch.ones(4, dtype=torch.bool)).numpy()
    assert list(t) == [False, False, True, True]
    # a dead column accepts every row, padding rows included
    t = tpk.rle_cols_hit_live(_t(v), _t(lens), _t(c), torch.tensor([False]), 6,
                              torch.ones(6, dtype=torch.bool)).numpy()
    assert t.all()


@pytest.mark.parametrize("seed", range(4))
def test_batched_lanes_match_jax(seed):
    rng = np.random.default_rng(50 + seed)
    C, RP, K, n, Q = 3, 16, 8, 96, 8
    values, lengths, _, hit, _ = _case(seed, C, RP, K, n)
    codes = np.full((Q, C, K), NO_MATCH, np.uint32)
    codes[:, :, :3] = rng.integers(0, 6, (Q, C, 3))
    live = rng.random((Q, C)) < 0.6
    want = np.asarray(jpk._batched_rle_in_set_jit(
        jnp.asarray(values), jnp.asarray(lengths), jnp.asarray(codes), jnp.asarray(live),
        jnp.asarray(hit), n))
    got = tpk.rle_cols_hit_live(_t(values), _t(lengths), _t(codes), _t(live), n, _t(hit))
    assert got.shape == (Q, n)
    assert np.array_equal(want, got.numpy())
    via = tpk.batched_rle_in_set(values, lengths, codes, live, hit, n, device="cpu")
    assert np.array_equal(np.asarray(jpk.batched_rle_in_set(values, lengths, codes, live,
                                                            hit, n)), via)


def test_fused_units_match_jax():
    rng = np.random.default_rng(800)
    U, C, K, R, n = 3, 2, 4, 32, 256
    values = rng.integers(0, 10, (U, C, R)).astype(np.uint32)
    lengths = np.zeros((U, C, R), np.int32)
    for u in range(U):
        for c in range(C):
            lengths[u, c] = rng.multinomial(n, np.ones(R) / R)
    codes = np.full((U, C, K), NO_MATCH, np.uint32)
    codes[:, :, :2] = rng.integers(0, 10, (U, C, 2))
    want = np.asarray(jpk.fused_rle_in_set(values, lengths, codes, n))
    got = tpk.fused_rle_in_set(values, lengths, codes, n, device="cpu")
    assert got.shape == (U, n) and np.array_equal(want, got)


def test_plain_ops_match_jax():
    rng = np.random.default_rng(5)
    values = rng.integers(0, 2**32, 20, dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, 4, 20).astype(np.int32)
    for n in (0, 5, int(lengths.sum()), int(lengths.sum()) + 9):
        want = np.asarray(jpk.rle_expand_device(values, lengths, n))
        got = tpk.rle_expand_device(_t(values), _t(lengths), n).numpy()
        assert np.array_equal(want.astype(np.int64), got)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    planes = x.view(np.uint8).reshape(-1, 4).T.copy()  # blosc shuffle
    assert np.array_equal(np.asarray(jpk.unshuffle_device(planes, 4)).astype(np.int64),
                          tpk.unshuffle_device(torch.from_numpy(planes), 4).numpy())


def test_shapes_are_checked():
    v = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        tpk.rle_hit_lanes(v, None, torch.zeros((1, 1, 1, 2), dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        tpk.rle_hit_lanes(v[None], v[None, :, :2], torch.zeros((1, 1, 1, 2)), 4)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("units_lanes", [(1, 1), (1, 8), (4, 1), (2, 3)])
def test_kernel_equals_plain(seed, units_lanes):
    dev = _cuda()
    U, Q = units_lanes
    rng = np.random.default_rng(seed)
    C, RP, K = int(rng.integers(1, 5)), int(rng.choice([1, 3, 64, 1500])), int(rng.integers(1, 65))
    n = int(rng.choice([1, 100, 4097, 1 << 17]))
    values = rng.integers(0, 8, (U, C, RP)).astype(np.uint32)
    values[rng.random((U, C, RP)) < 0.1] = NO_MATCH
    lengths = rng.integers(0, max(2, 2 * n // RP), (U, C, RP)).astype(np.int32)
    lengths[..., -1] = 0
    codes = np.full((U, Q, C, K), NO_MATCH, np.uint32)
    codes[..., : max(1, K // 2)] = rng.integers(0, 8, (U, Q, C, max(1, K // 2)))
    live = rng.random((U, Q, C)) < 0.8
    hit = rng.random((U, n)) < 0.9
    for with_lengths in (True, False):
        args = [_t(values), _t(lengths) if with_lengths else None, _t(codes), n, _t(live), _t(hit)]
        if not with_lengths:
            args[3] = RP if RP < n else n
            args[5] = _t(hit[:, : args[3]])
        plain = tpk.rle_hit_lanes(*args[:4], live=args[4], hit=args[5])
        before = tpk.rle_cols_hit.launches
        got = tpk.rle_hit_lanes(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                                  for a in args[:4]),
                                live=args[4].to(dev), hit=args[5].to(dev))
        assert tpk.rle_cols_hit.launches == before + 1
        assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
def test_kernel_wrappers_on_the_card():
    dev = _cuda()
    values, lengths, codes, hit, live = _case(3, 3, 40, 16, 5000)
    plain = tpk.rle_cols_hit_live(_t(values), _t(lengths), _t(codes), _t(live), 5000, _t(hit))
    got = tpk.rle_cols_hit_live(_t(values).to(dev), _t(lengths).to(dev), _t(codes).to(dev),
                                _t(live).to(dev), 5000, _t(hit).to(dev))
    assert torch.equal(got.cpu(), plain)
    qcodes = np.stack([codes] * 8)
    out = tpk.batched_rle_in_set(values, lengths, qcodes, np.stack([live] * 8), hit, 5000,
                                 device=dev)
    assert out.shape == (8, 5000) and (out == plain.numpy()[None]).all()
