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


# ---------------------------------------------------------------------------
# the edges of the one-launch kernel's design: more runs than one staged run
# tile, more lanes than one lane word, code sets with padding between real
# and repeated codes, dead columns, a run a row with run_pad above and below
# n, several units in one call
# ---------------------------------------------------------------------------


def _lanes(rng, U, Q, C, RP, K, n, lengths="random", real=3):
    """A seeded (values, lengths, codes, live, hit) of rle_hit_lanes'
    shapes: values in 0..7 with some NO_MATCH, codes with `real` codes a
    lane and column scattered among NO_MATCH paddings (repeats allowed)."""
    values = rng.integers(0, 8, (U, C, RP)).astype(np.uint32)
    values[rng.random((U, C, RP)) < 0.1] = NO_MATCH
    if lengths == "ones":
        lens = np.ones((U, C, RP), np.int32)
    elif lengths == "zero-mixed":
        lens = rng.integers(0, 3, (U, C, RP)).astype(np.int32)  # a third zero-length
    else:
        lens = rng.integers(0, max(2, 2 * n // RP), (U, C, RP)).astype(np.int32)
    codes = np.full((U, Q, C, K), NO_MATCH, np.uint32)
    for idx in np.ndindex(U, Q, C):
        at = rng.choice(K, size=min(real, K), replace=False)
        codes[idx][at] = rng.integers(0, 8, len(at))
    live = rng.random((U, Q, C)) < 0.8
    hit = rng.random((U, n)) < 0.9
    return values, lens, codes, live, hit


def _jax_lanes(values, lengths, codes, live, hit, n):
    """The JAX package's answer of rle_hit_lanes' function: its batched
    program a unit; a run a row is runs of length 1 (jnp.repeat then pads
    with the last run and cuts at n, as the rule says)."""
    U, Q = codes.shape[:2]
    if lengths is None:
        lengths = np.ones(values.shape, np.int32)
    if live is None:
        live = np.ones(codes.shape[:3], bool)
    if hit is None:
        hit = np.ones((U, n), bool)
    return np.stack([np.asarray(jpk._batched_rle_in_set_jit(
        jnp.asarray(values[u]), jnp.asarray(lengths[u]), jnp.asarray(codes[u]),
        jnp.asarray(live[u]), jnp.asarray(hit[u]), n)) for u in range(U)])


def _torch_lanes(values, lengths, codes, live, hit, n, dev=None):
    args = [None if a is None else _t(a) for a in (values, lengths, codes, live, hit)]
    if dev is not None:
        args = [None if a is None else a.to(dev) for a in args]
    return tpk.rle_hit_lanes(args[0], args[1], args[2], n, live=args[3], hit=args[4])


# (label, U, Q, C, RP, K, n, lengths): every edge, for the CPU against JAX
# and for the card against the plain version
EDGES = [
    ("one-row runs past a tile", 1, 2, 1, 16384, 8, 16384, "ones"),
    ("zero-length runs mixed, rows past the total", 1, 1, 1, 32768, 8, 40000, "zero-mixed"),
    ("zero-length runs mixed, runs cut at n", 1, 3, 1, 32768, 8, 12000, "zero-mixed"),
    ("33 lanes", 1, 33, 2, 40, 8, 300, "random"),
    ("64 lanes", 1, 64, 2, 40, 8, 300, "random"),
    ("three columns", 2, 5, 3, 300, 16, 5000, "random"),
    ("a run a row, run_pad above n", 1, 4, 2, 700, 8, 500, None),
    ("a run a row, run_pad below n", 1, 4, 2, 300, 8, 500, None),
    ("several units", 5, 3, 2, 64, 8, 777, "random"),
]


@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_plain_matches_jax_at_the_kernel_edges(edge):
    _label, U, Q, C, RP, K, n, kind = edge
    rng = np.random.default_rng(RP + 7 * Q + n)
    values, lengths, codes, live, hit = _lanes(rng, U, Q, C, RP, K, n, kind or "ones")
    if kind is None:
        lengths = None
    want = _jax_lanes(values, lengths, codes, live, hit, n)
    got = _torch_lanes(values, lengths, codes, live, hit, n).numpy()
    assert got.shape == (U, Q, n) and np.array_equal(want, got)


@pytest.mark.parametrize("seed", range(3))
def test_plain_sentinels_between_and_repeated_codes(seed):
    rng = np.random.default_rng(300 + seed)
    U, Q, C, RP, K, n = 2, 4, 2, 50, 9, 400
    values, lengths, _codes, live, hit = _lanes(rng, U, Q, C, RP, K, n)
    values[..., ::7] = NO_MATCH  # a value equal to the padding code
    codes = np.tile(np.array([3, NO_MATCH, 3, 5, NO_MATCH, NO_MATCH, 5, 3, NO_MATCH],
                             np.uint32), (U, Q, C, 1))
    codes[:, 1] = NO_MATCH  # lane 1: only padding, no value matches
    codes[:, 2, :, 4] = rng.integers(0, 8)  # lane 2: one more code between the paddings
    want = _jax_lanes(values, lengths, codes, live, hit, n)
    assert np.array_equal(want, _torch_lanes(values, lengths, codes, live, hit, n).numpy())
    assert not want[:, 1][~np.broadcast_to(~live[:, 1].any(1, keepdims=True), (U, n))].any()


@pytest.mark.parametrize("seed", range(3))
def test_plain_three_columns_one_dead(seed):
    rng = np.random.default_rng(400 + seed)
    U, Q, C, RP, K, n = 1, 6, 3, 120, 8, 900
    values, lengths, codes, live, hit = _lanes(rng, U, Q, C, RP, K, n)
    live[:, 0, :] = True
    live[:, :, 1] = False  # column 1 dead for every lane: it accepts every row
    want = _jax_lanes(values, lengths, codes, live, hit, n)
    assert np.array_equal(want, _torch_lanes(values, lengths, codes, live, hit, n).numpy())
    # the dead column's verdicts do not matter
    other = codes.copy()
    other[:, :, 1] = NO_MATCH
    assert np.array_equal(want, _torch_lanes(values, lengths, other, live, hit, n).numpy())


@pytest.mark.parametrize("seed", range(2))
def test_plain_several_units_without_live_or_hit(seed):
    rng = np.random.default_rng(500 + seed)
    U, Q, C, RP, K, n = 6, 2, 2, 48, 4, 640
    values, lengths, codes, _live, _hit = _lanes(rng, U, Q, C, RP, K, n)
    want = _jax_lanes(values, lengths, codes, None, None, n)
    assert np.array_equal(want, _torch_lanes(values, lengths, codes, None, None, n).numpy())
    via = tpk.fused_rle_in_set(values, lengths, codes[:, 0], n, device="cpu")
    assert np.array_equal(np.asarray(jpk.fused_rle_in_set(values, lengths, codes[:, 0], n)), via)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_kernel_equals_plain_at_the_edges(edge):
    dev = _cuda()
    _label, U, Q, C, RP, K, n, kind = edge
    rng = np.random.default_rng(RP + 7 * Q + n)
    values, lengths, codes, live, hit = _lanes(rng, U, Q, C, RP, K, n, kind or "ones")
    if kind is None:
        lengths = None
    for lv, ht in ((live, hit), (None, None)):
        plain = _torch_lanes(values, lengths, codes, lv, ht, n)
        before = tpk.rle_cols_hit.launches
        got = _torch_lanes(values, lengths, codes, lv, ht, n, dev)
        assert tpk.rle_cols_hit.launches == before + 1
        assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 64, 100, 3000])
def test_kernel_equals_plain_sentinels_and_code_set_sizes(K):
    # K past 64 gathers fewer lanes a group; K = 3000 one lane a group
    dev = _cuda()
    rng = np.random.default_rng(K)
    U, Q, C, RP, n = 2, 35, 2, 200, 3000
    values, lengths, codes, live, hit = _lanes(rng, U, Q, C, RP, K, n, real=min(K, 5))
    codes[..., -1] = np.where(rng.random((U, Q, C)) < 0.5, codes[..., 0], NO_MATCH)
    values[..., ::5] = NO_MATCH
    plain = _torch_lanes(values, lengths, codes, live, hit, n)
    assert torch.equal(_torch_lanes(values, lengths, codes, live, hit, n, dev).cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4096, 5000])
def test_kernel_saturated_first_run(n):
    # a first run of 2^31 - 1 rows covers every row: the later runs' starts
    # saturate at n (an int32 sum would wrap). Held against the expectation:
    # the plain version would expand 2^31 rows.
    dev = _cuda()
    rng = np.random.default_rng(n)
    Q, RP = 4, 9000  # two staged run tiles
    values = rng.integers(0, 8, (1, 1, RP)).astype(np.uint32)
    values[0, 0, 0] = 6
    lengths = rng.integers(0, 1000, (1, 1, RP)).astype(np.int32)
    lengths[0, 0, 0] = 2**31 - 1
    codes = np.full((1, Q, 1, 8), NO_MATCH, np.uint32)
    codes[0, 0, 0, :2] = (6, 1)  # holds run 0's value
    codes[0, 1, 0, :2] = (1, 2)  # does not
    codes[0, 2, 0, :2] = (1, 2)  # does not, but the column is dead for lane 2
    codes[0, 3, 0, 0] = 6
    live = np.array([[[True], [True], [False], [True]]])
    hit = rng.random((1, n)) < 0.7
    got = _torch_lanes(values, lengths, codes, live, hit, n, dev).cpu().numpy()
    want = np.stack([hit[0], np.zeros(n, bool), hit[0], hit[0]])[None]
    assert np.array_equal(got, want)
