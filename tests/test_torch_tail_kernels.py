"""The ingest tail's hand kernels (csrc/tail_kernels.cu: `tail_fold`,
`tail_scan`) and their plain versions (tempo_tpu_torch/ops/ingest_tail.py).

On the CPU: each plain version against a numpy oracle written row by row
from the reference's definition (a row's bin is the number of edges <=
its start less one, on two u32 limbs; its by() index the number of codes
<= its code less one), the fold's descriptor (its constants by value, or
the staged layout past the descriptor's room), and the wrappers'
refusals (a column that is not 16-byte aligned among them). On the card
(`cuda`, skipped here): each kernel against its plain version, bit for
bit, over parked columns of 1 to 2**20 rows, every operator, predicates
by value and staged (more than 16), by() over 1 to 4,096 codes, 2 to
4,096 edges (private histograms and global atomics), the launch counts;
row counts at each side of a thread's and a CTA's rows, p = 8, cuts of
make_batch traces, every row passing and none, edges and codes at each
side of the by-value limit, two threads staging at once; the resident
fold on a card tier against a CPU tier's; and the device profile window,
whose trace names the kernels. This file imports no JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from tempo_tpu_torch.encoding.vtpu import colcache
from tempo_tpu_torch.metrics_engine import SeriesTable, compile_metrics_plan
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.ops import ingest_tail
from tempo_tpu_torch.util import profiling

OPS = ("=", "!=", ">", ">=", "<", "<=")


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _parked(rng, p: int, n: int, t0: int, span_ns: int) -> dict:
    """Parked columns (numpy uint32) of p rows, the first n real."""
    cols = {k: rng.integers(0, 12, p).astype(np.uint32) for k in ingest_tail._CODE_COLS}
    cols["http_status"] = rng.choice([0, 200, 404, 500, 503], p).astype(np.uint32)
    cols["kind"] = rng.integers(1, 6, p).astype(np.uint32)
    cols["status_code"] = rng.integers(0, 3, p).astype(np.uint32)
    t = (t0 + rng.integers(-span_ns // 8, span_ns + span_ns // 8, p)).astype(np.uint64)
    d = rng.integers(0, 1 << 34, p).astype(np.uint64)
    for name, v in (("start", t), ("dur", d)):
        cols[f"{name}_lo"] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        cols[f"{name}_hi"] = (v >> np.uint64(32)).astype(np.uint32)
    for c in cols.values():
        c[n:] = 0
    return cols


def _edges(t0: int, step: int, nb: int):
    e_pad = ingest_tail._pow2(nb + 2)
    e = t0 + np.arange(nb + 1, dtype=np.uint64) * np.uint64(step)
    lo, hi = np.full(e_pad, 0xFFFFFFFF, np.uint32), np.full(e_pad, 0xFFFFFFFF, np.uint32)
    lo[: nb + 1] = (e & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi[: nb + 1] = (e >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def _uvals(codes: np.ndarray) -> np.ndarray:
    u = np.unique(codes.astype(np.uint32))
    out = np.full(ingest_tail._pow2(len(u)), 0xFFFFFFFF, np.uint32)
    out[: len(u)] = u
    return out


def _tensors(cols: dict, device) -> dict:
    return {k: torch.from_numpy(v.view(np.int32).copy()).to(device) for k, v in cols.items()}


def _oracle_fold(cols, n, preds, by_col, uvals, lo, hi, nb):
    """Row by row, the reference's definition."""
    edges = [(int(h) << 32) | int(l) for l, h in zip(lo, hi)]
    b_pad = len(edges) - 1
    out = np.zeros(len(uvals) * b_pad, np.int64)
    cmp = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b, ">": lambda a, b: a > b,
           ">=": lambda a, b: a >= b, "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}
    for r in range(n):
        if not all(int(cols[c][r]) != 0 and cmp[op](int(cols[c][r]), lit) for c, op, lit in preds):
            continue
        t = (int(cols["start_hi"][r]) << 32) | int(cols["start_lo"][r])
        b = sum(e <= t for e in edges) - 1
        if not 0 <= b < nb:
            continue
        cell = b
        if by_col is not None:
            cell += (sum(int(u) <= int(cols[by_col][r]) for u in uvals) - 1) * b_pad
        out[max(cell, 0)] += 1
    return out.astype(np.int32)


FOLD_CASES = [
    ([], None),
    ([("service", "=", 3)], "name"),
    ([("service", "!=", 3), ("http_status", ">=", 500)], "http_method"),
    ([("http_status", op, 404) for op in OPS], None),
    ([("http_status", "=", 0)], None),  # a numeric "= 0" never matches
    ([("name", "!=", 0xFFFFFFFF)], "service"),  # an absent literal: every defined row
    ([("http_url", "<", 9), ("name", ">", 1)], "http_url"),
]


@pytest.mark.parametrize("case", range(len(FOLD_CASES)))
def test_fold_plain_equals_oracle(case):
    preds, by_col = FOLD_CASES[case]
    rng = np.random.default_rng(case)
    t0, step, nb = ((1 << 32) * 409_600_000) - 7 * 10**9, 10**9, 9  # edges straddle limb wraps
    cols = _parked(rng, 512, 450, t0, step * nb)
    lo, hi = _edges(t0, step, nb)
    uvals = _uvals(cols[by_col][:450]) if by_col else np.zeros(1, np.uint32)
    got = ingest_tail.tail_fold(_tensors(cols, "cpu"), 450, preds, by_col, uvals, lo, hi, nb)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _oracle_fold(cols, 450, preds, by_col, uvals, lo, hi, nb))


@pytest.mark.parametrize("eq,status,mn,mx", [
    ([], None, 0, 0),
    ([("service", 3), ("name", 5)], None, 0, 0),
    ([("http_method", 2)], 500, 0, 0),
    ([], None, (1 << 32) - 1, 0),
    ([], 200, 0, (3 << 32) + 5),
    ([("service", 1), ("name", 1), ("http_method", 1), ("http_url", 1), ("service", 1)],
     404, 1 << 20, 1 << 33),
])
def test_scan_plain_equals_oracle(eq, status, mn, mx):
    rng = np.random.default_rng(len(eq) + (status or 0))
    cols = _parked(rng, 256, 200, 10**18, 10**9)
    got = ingest_tail.tail_scan(_tensors(cols, "cpu"), 200, eq, status, mn, mx).numpy()
    dur = (cols["dur_hi"].astype(np.uint64) << np.uint64(32)) | cols["dur_lo"]
    want = np.arange(256) < 200
    for c, code in eq:
        want &= cols[c] == code
    if status is not None:
        want &= cols["http_status"] == status
    if mn:
        want &= dur >= np.uint64(mn)
    if mx:
        want &= dur <= np.uint64(mx)
    assert np.array_equal(got, want)


def test_wrappers_refuse_bad_inputs():
    cols = _tensors(_parked(np.random.default_rng(0), 64, 60, 10**18, 10**9), "cpu")
    lo, hi = _edges(10**18, 10**9, 4)
    with pytest.raises(ValueError, match="ascend"):
        ingest_tail.tail_fold(cols, 60, [], None, np.zeros(1, np.uint32), lo[::-1], hi[::-1], 4)
    with pytest.raises(ValueError, match="nb_real"):
        ingest_tail.tail_fold(cols, 60, [], None, np.zeros(1, np.uint32), lo, hi, len(lo))
    with pytest.raises(ValueError, match="equalities"):
        ingest_tail.tail_scan(cols, 60, [("service", 1)] * 6, None, 0, 0)
    with pytest.raises(ValueError, match="u32"):
        ingest_tail.tail_scan(cols, 60, [], 1 << 32, 0, 0)
    meta = {k: v.to("meta") for k, v in cols.items()}
    with pytest.raises(ValueError, match="no kernel"):
        ingest_tail.tail_scan(meta, 60, [], None, 0, 0)


@pytest.mark.parametrize("e_pad,u_pad,n_preds", [
    (8, 1, 0), (64, 8, 1), (128, 128, 16),  # by value
    (256, 8, 1), (64, 256, 2), (64, 8, 17), (2048, 4096, 3),  # staged
])
def test_fold_descriptor_by_value_and_staged_layout(e_pad, u_pad, n_preds):
    """The descriptor carries the edges (u64), the by() codes and the
    predicates by value when they fit (128 edges, 128 codes, 16
    predicates), the same values fold_consts lays out for the card;
    past that it carries none and hands back fold_consts' bytes."""
    cols = _tensors(_parked(np.random.default_rng(e_pad + u_pad), 64, 60, 10**18, 10**9), "cpu")
    lo, hi = _edges(10**18, 10**9, e_pad - 2)
    assert len(lo) == e_pad
    uvals = np.full(u_pad, 0xFFFFFFFF, np.uint32)
    uvals[: u_pad // 2 + 1] = np.arange(u_pad // 2 + 1) * 3
    names = ("service", "name", "http_status", "http_url")
    preds = [(names[j % 4], OPS[j % 6], 7 * j + 1) for j in range(n_preds)]
    edges = ingest_tail._edges_u64(lo, hi)
    counts = torch.zeros(u_pad * (e_pad - 1), dtype=torch.int32)
    desc, staged = ingest_tail.fold_descriptor(cols, 60, preds, "name", uvals, edges, e_pad - 3,
                                               counts)
    assert (desc.n, desc.e_pad, desc.u_pad, desc.n_preds, desc.nb_real) == (
        60, e_pad, u_pad, n_preds, e_pad - 3)
    assert (desc.t_lo, desc.t_hi, desc.by, desc.counts) == (
        cols["start_lo"].data_ptr(), cols["start_hi"].data_ptr(), cols["name"].data_ptr(),
        counts.data_ptr())
    assert desc.consts is None
    layout = ingest_tail.fold_consts(cols, preds, uvals, edges)
    # the staged layout: edges, codes padded to 8 bytes, 16 bytes a predicate
    code_bytes = 4 * u_pad + (4 * u_pad) % 8
    assert layout.dtype == np.uint8 and layout.nbytes == 8 * e_pad + code_bytes + 16 * n_preds
    assert np.array_equal(layout[: 8 * e_pad].view(np.uint64),
                          (hi.astype(np.uint64) << np.uint64(32)) | lo)
    assert np.array_equal(layout[8 * e_pad: 8 * e_pad + 4 * u_pad].view(np.uint32), uvals)
    words = layout[8 * e_pad + code_bytes:].view(np.uint64).reshape(-1, 2)
    want = [(cols[c].data_ptr(), lit | (ingest_tail._OP_CODES[op] << 32)) for c, op, lit in preds]
    assert [tuple(int(x) for x in w) for w in words] == want
    by_value = (e_pad <= 128 and u_pad <= 128 and n_preds <= 16)
    assert (staged is None) == by_value
    if by_value:
        assert list(desc.edges[:e_pad]) == list(layout[: 8 * e_pad].view(np.uint64))
        assert list(desc.uvals[:u_pad]) == list(uvals)
        assert [(desc.preds[j].col, desc.preds[j].lit | (desc.preds[j].op << 32))
                for j in range(n_preds)] == want
    else:
        assert np.array_equal(staged, layout)
        assert not any(desc.edges) and not any(desc.uvals)


@pytest.mark.parametrize("kernel,col", [("fold", "start_lo"), ("fold", "start_hi"),
                                        ("fold", "name"), ("fold", "service"),
                                        ("scan", "service"), ("scan", "http_method"),
                                        ("scan", "http_status"), ("scan", "dur_hi")])
def test_wrappers_refuse_unaligned_columns(kernel, col):
    """The kernels load 4 rows (16 bytes) at a time: a column that does not
    start on a 16-byte boundary is refused, on any device, never folded or
    scanned some other way."""
    cols = _tensors(_parked(np.random.default_rng(1), 64, 60, 10**18, 10**9), "cpu")
    cols[col] = torch.cat([cols[col][:1], cols[col]])[1:]  # 4 bytes past a boundary
    assert cols[col].data_ptr() % 16 == 4
    lo, hi = _edges(10**18, 10**9, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "fold":
            ingest_tail.tail_fold(cols, 60, [("service", "=", 3)], "name",
                                  _uvals(cols["name"].numpy()[:60]), lo, hi, 4)
        else:
            ingest_tail.tail_scan(cols, 60, [("http_method", 2)], 200, 1, 1 << 40)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1000, (1 << 16) + 3, 1 << 20])
@pytest.mark.parametrize("case", range(len(FOLD_CASES) + 1))
@pytest.mark.parametrize("nb", [1, 60, 2046])
def test_tail_fold_kernel_equals_plain(n, case, nb):
    dev = _cuda()
    rng = np.random.default_rng(n + case + nb)
    p = ingest_tail._pow2(n)
    t0, step = ((1 << 32) * 409_600_000) - 7 * 10**9, 10**9
    cols = _parked(rng, p, n, t0, step * nb)
    if case == len(FOLD_CASES):  # 17 predicates: the staged constants
        preds = [("http_status", op, 300) for op in (">", ">=", "!=")] * 5 + [
            ("service", "!=", 99), ("name", "<", 11)]
        by_col = "name"
    else:
        preds, by_col = FOLD_CASES[case]
    if by_col == "http_url":  # up to 4,096 by() codes
        cols["http_url"][:n] = rng.integers(0, 4096, n)
    lo, hi = _edges(t0, step, nb)
    uvals = _uvals(cols[by_col][:n]) if by_col else np.zeros(1, np.uint32)
    before = ingest_tail.tail_fold.launches
    got = ingest_tail.tail_fold(_tensors(cols, dev), n, preds, by_col, uvals, lo, hi, nb)
    torch.cuda.synchronize()
    assert ingest_tail.tail_fold.launches == before + 1 and got.device.type == "cuda"
    want = ingest_tail.tail_fold(_tensors(cols, "cpu"), n, preds, by_col, uvals, lo, hi, nb)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_tail_fold_threads_of_different_sizes():
    """Two threads launch folds whose shared memory differs (a few bytes
    against ~32 KB of edges and by() codes) at the same time: no launch may
    find the kernel's shared-memory ceiling lowered by the other's."""
    import threading

    dev = _cuda()
    t0, step = ((1 << 32) * 409_600_000) - 7 * 10**9, 10**9
    jobs = []
    for n, nb, preds, by_col in ((1000, 1, [("service", "=", 3)], None),
                                 (1 << 20, 2046, [], "http_url")):
        rng = np.random.default_rng(n)
        cols = _parked(rng, ingest_tail._pow2(n), n, t0, step * nb)
        if by_col:
            cols[by_col][:n] = rng.integers(1, 4096, n)
        lo, hi = _edges(t0, step, nb)
        uvals = _uvals(cols[by_col][:n]) if by_col else np.zeros(1, np.uint32)
        args = (n, preds, by_col, uvals, lo, hi, nb)
        want = ingest_tail.tail_fold(_tensors(cols, "cpu"), *args)
        jobs.append((_tensors(cols, dev), args, want))
    errors = []

    def run(arrays, args, want):
        try:
            for _ in range(40):
                got = ingest_tail.tail_fold(arrays, *args)
                assert torch.equal(got.cpu(), want)
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1000, (1 << 16) + 3, 1 << 20])
@pytest.mark.parametrize("eq,status,mn,mx", [
    ([], None, 0, 0),
    ([("service", 3), ("name", 5)], None, 0, 0),
    ([("http_method", 2)], 500, 0, 0),
    ([], None, (1 << 32) - 1, 0),
    ([], 200, 0, (3 << 32) + 5),
    ([("service", 1), ("name", 1), ("http_method", 1), ("http_url", 1), ("service", 1)],
     404, 1 << 20, 1 << 33),
])
def test_tail_scan_kernel_equals_plain(n, eq, status, mn, mx):
    dev = _cuda()
    rng = np.random.default_rng(n)
    p = ingest_tail._pow2(n)
    cols = _parked(rng, p, n, 10**18, 10**9)
    before = ingest_tail.tail_scan.launches
    got = ingest_tail.tail_scan(_tensors(cols, dev), n, eq, status, mn, mx)
    torch.cuda.synchronize()
    assert ingest_tail.tail_scan.launches == before + 1
    want = ingest_tail.tail_scan(_tensors(cols, "cpu"), n, eq, status, mn, mx)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [
    "{} | rate() by (name)",
    '{ resource.service.name = "cart" && span.http.status_code >= 500 } | count_over_time()',
])
def test_resident_fold_card_tier_equals_cpu_tier(q):
    dev = _cuda()
    batch = synth.make_batch(4096, 8, seed=5)
    t0 = int(batch.cols["start_unix_nano"].min()) // 10**9
    plan = compile_metrics_plan(q, t0 - 60, t0 + 600, 60)
    fp = ingest_tail.lower_fold_plan(plan)
    out = []
    for device in (dev, "cpu"):
        tier = colcache.DeviceTier(256 << 20, ingest_tail_budget_bytes=128 << 20, device=device)
        key = ingest_tail.park_cut(tier, "t", "b:0", batch)
        series = SeriesTable(64)
        out.append((ingest_tail.resident_fold(plan, fp, batch, batch.dictionary, series,
                                              tier=tier, key=key), series.slots))
    assert out[0] == out[1] and out[0][0]


@pytest.mark.cuda
def test_device_profile_window_names_the_kernels():
    dev = _cuda()
    rng = np.random.default_rng(3)
    cols = _tensors(_parked(rng, 1 << 16, 60_000, 10**18, 10**9), dev)
    lo, hi = _edges(10**18, 10**8, 10)
    import threading

    stop = threading.Event()

    def work():
        while not stop.is_set():
            ingest_tail.tail_fold(cols, 60_000, [("service", "=", 3)], None,
                                  np.zeros(1, np.uint32), lo, hi, 10)
            ingest_tail.tail_scan(cols, 60_000, [("name", 2)], None, 0, 0)
            torch.cuda.synchronize()

    t = threading.Thread(target=work)
    t.start()
    try:
        doc = profiling.capture_device_profile(0.5, device=dev)
    finally:
        stop.set()
        t.join(timeout=60)
    assert doc["supported"] is True
    with open(os.path.join(doc["dir"], profiling.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    assert any("tail_fold_kernel" in x for x in names) and any("tail_scan_kernel" in x for x in names)


# the kernels' edges at each side: a fold thread's round (16 rows) and a fold
# CTA's (4,096 rows), a multiple of a scan thread's run (4 or 8 rows); the
# row count under which a fold's grid drops below one CTA an SM on a 132-SM
# card (132 x 128); a phase 12 (a) cut
EDGE_NS = [15, 16, 17, 4095, 4096, 4097, 16_895, 16_897, 32_768]


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_NS)
@pytest.mark.parametrize("case", [0, 1, 2, 6])
def test_tail_fold_kernel_edges_equal_plain(n, case):
    dev = _cuda()
    rng = np.random.default_rng(7 * n + case)
    t0, step, nb = ((1 << 32) * 409_600_000) - 7 * 10**9, 10**9, 46
    cols = _parked(rng, ingest_tail._pow2(n), n, t0, step * nb)
    preds, by_col = FOLD_CASES[case]
    lo, hi = _edges(t0, step, nb)
    uvals = _uvals(cols[by_col][:n]) if by_col else np.zeros(1, np.uint32)
    got = ingest_tail.tail_fold(_tensors(cols, dev), n, preds, by_col, uvals, lo, hi, nb)
    want = ingest_tail.tail_fold(_tensors(cols, "cpu"), n, preds, by_col, uvals, lo, hi, nb)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 7, 8, 1023, 1025] + EDGE_NS)
@pytest.mark.parametrize("eq,status,mn,mx", [
    ([("service", 3)], None, 0, 0),
    ([("service", 1), ("name", 1)], 404, 1 << 20, 1 << 33),
])
def test_tail_scan_kernel_edges_equal_plain(n, eq, status, mn, mx):
    """n at each side of a thread's run and of a CTA's round (1,024 rows
    of 4-row runs), p = 8, and rows [n, p) written 0."""
    dev = _cuda()
    rng = np.random.default_rng(n + 11)
    cols = _parked(rng, ingest_tail._pow2(n), n, 10**18, 10**9)
    got = ingest_tail.tail_scan(_tensors(cols, dev), n, eq, status, mn, mx)
    want = ingest_tail.tail_scan(_tensors(cols, "cpu"), n, eq, status, mn, mx)
    assert got.shape == (ingest_tail._pow2(n),) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["all", "none"])
def test_tail_kernels_every_row_or_none(which):
    """Every row passing (defined columns, edges around every start, a
    duration bound every row meets) and no row passing."""
    dev = _cuda()
    n = 100_003
    rng = np.random.default_rng(5)
    t0, step, nb = 10**18, 10**9, 20
    cols = _parked(rng, ingest_tail._pow2(n), n, t0, step * nb)
    t = t0 + rng.integers(0, step * nb, n).astype(np.uint64)  # every start in a bin
    cols["start_lo"][:n] = (t & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    cols["start_hi"][:n] = (t >> np.uint64(32)).astype(np.uint32)
    lo, hi = _edges(t0, step, nb)
    lit = 1 if which == "all" else 99
    preds = [("kind", ">=" if which == "all" else "=", lit)]
    uvals = _uvals(cols["service"][:n])
    got = ingest_tail.tail_fold(_tensors(cols, dev), n, preds, "service", uvals, lo, hi, nb)
    want = ingest_tail.tail_fold(_tensors(cols, "cpu"), n, preds, "service", uvals, lo, hi, nb)
    assert torch.equal(got.cpu(), want) and int(want.sum()) == (n if which == "all" else 0)
    eq = [] if which == "all" else [("service", 99)]
    got = ingest_tail.tail_scan(_tensors(cols, dev), n, eq, None, 0, 1 << 40)
    want = ingest_tail.tail_scan(_tensors(cols, "cpu"), n, eq, None, 0, 1 << 40)
    assert torch.equal(got.cpu(), want) and int(want.sum()) == (n if which == "all" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [
    '{ resource.service.name = "cart" } | rate() by (name)',
    "{} | count_over_time() by (resource.service.name)",
    '{ span.http.status_code >= 200 } | count_over_time() by (span.http.url)',
])
def test_tail_fold_make_batch_hot_cells(q):
    """Rows from synth.make_batch, parked through park_cut: the spans of a
    trace share a service and a minute, so neighbouring rows add into the
    same cell; the card's fold == the plain version's over the same cut."""
    dev = _cuda()
    batch = synth.make_batch(4096, 8, seed=17)
    t0 = int(batch.cols["start_unix_nano"].min()) // 10**9
    plan = compile_metrics_plan(q, t0 - 60, t0 + 3600, 60)
    fp = ingest_tail.lower_fold_plan(plan)
    assert fp is not None
    args = ingest_tail.fold_args(plan, fp, batch, batch.dictionary)
    _lits, preds, _real, uvals, lo, hi = args
    out = []
    for device in (dev, "cpu"):
        tier = colcache.DeviceTier(256 << 20, ingest_tail_budget_bytes=128 << 20, device=device)
        key = ingest_tail.park_cut(tier, "t", "b:0", batch)
        arrays = tier.get(key).arrays
        out.append(ingest_tail.tail_fold(arrays, batch.num_spans, preds, fp.by_col, uvals, lo, hi,
                                         plan.n_bins).cpu())
    assert torch.equal(out[0], out[1]) and int(out[1].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n_codes", [(126, 128), (127, 128), (126, 129), (127, 129)])
def test_tail_fold_by_value_limit(nb, n_codes):
    """Edges and by() codes at each side of the descriptor's room (e_pad
    128 / 256, u_pad 128 / 256): both arms of the constants, by value and
    staged, against the plain version."""
    dev = _cuda()
    n = 50_000
    rng = np.random.default_rng(nb + n_codes)
    t0, step = 10**18, 10**8
    cols = _parked(rng, ingest_tail._pow2(n), n, t0, step * nb)
    cols["http_url"][:n] = rng.integers(1, n_codes + 1, n)
    lo, hi = _edges(t0, step, nb)
    uvals = _uvals(cols["http_url"][:n])
    assert (len(lo), len(uvals)) == (128 if nb == 126 else 256, 128 if n_codes == 128 else 256)
    preds = [("service", "!=", 3)]
    desc, staged = ingest_tail.fold_descriptor(
        _tensors(cols, "cpu"), n, preds, "http_url", uvals, ingest_tail._edges_u64(lo, hi), nb,
        torch.zeros(1, dtype=torch.int32))
    assert (staged is None) == (nb == 126 and n_codes == 128)
    got = ingest_tail.tail_fold(_tensors(cols, dev), n, preds, "http_url", uvals, lo, hi, nb)
    want = ingest_tail.tail_fold(_tensors(cols, "cpu"), n, preds, "http_url", uvals, lo, hi, nb)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_tail_fold_threads_staged_at_once():
    """Two threads fold at once, both through the staged arm (each its own
    pinned buffer) with constants of different sizes, each 40 times: every
    fold == its plain version, so no copy overwrote constants a launch
    still had to read."""
    import threading

    dev = _cuda()
    t0, step = ((1 << 32) * 409_600_000) - 7 * 10**9, 10**9
    jobs = []
    for n, nb, n_codes in ((3000, 200, 40), (1 << 18, 2046, 4000)):
        rng = np.random.default_rng(n)
        cols = _parked(rng, ingest_tail._pow2(n), n, t0, step * nb)
        cols["http_url"][:n] = rng.integers(1, n_codes + 1, n)
        lo, hi = _edges(t0, step, nb)
        uvals = _uvals(cols["http_url"][:n])
        args = (n, [("http_status", "!=", 404)], "http_url", uvals, lo, hi, nb)
        want = ingest_tail.tail_fold(_tensors(cols, "cpu"), *args)
        jobs.append((_tensors(cols, dev), args, want))
    errors = []

    def run(arrays, args, want):
        try:
            for _ in range(40):
                got = ingest_tail.tail_fold(arrays, *args)
                assert torch.equal(got.cpu(), want)
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
