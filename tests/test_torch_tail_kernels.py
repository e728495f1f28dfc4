"""The ingest tail's hand kernels (csrc/tail_kernels.cu: `tail_fold`,
`tail_scan`) and their plain versions (tempo_tpu_torch/ops/ingest_tail.py).

On the CPU: each plain version against a numpy oracle written row by row
from the reference's definition (a row's bin is the number of edges <=
its start less one, on two u32 limbs; its by() index the number of codes
<= its code less one), and the wrappers' refusals. On the card (`cuda`,
skipped here): each kernel against its plain version, bit for bit, over
parked columns of 1 to 2**20 rows, every operator, predicates by value
and through the device array (more than 16), by() over 1 to 4,096 codes,
2 to 4,096 edges (private histograms and global atomics), the launch
counts; the resident fold on a card tier against a CPU tier's; and the
device profile window, whose trace names the kernels. This file imports
no JAX.
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
    if case == len(FOLD_CASES):  # 17 predicates: the descriptor's device array
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
