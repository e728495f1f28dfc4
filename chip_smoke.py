#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tempo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure exits non-zero):

0. device: card name, count, torch/CUDA versions, nvidia-smi name and
   power limit;
1. build: nvcc builds csrc/kernels.cu (the three hand-written kernels);
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, bit for bit, and timed (CUDA events, median of 25 launches)
   beside its plain version, one PyTorch library call where there is
   one, and its memory bound;
3. compaction: the flagship step (entry.entry) at 2**22 rows, bit-equal
   between the card and the CPU;
4. metrics: three TraceQL query_range queries over 2**22 synthetic spans
   through the port's plan -> eval_batch -> accumulator -> wire ->
   matrix pipeline, equal between the card and the CPU;
5. scan: in_set_scan and u64_range_scan over the same 2**22 spans'
   columns, against a numpy oracle.

Phases 3-4 are the main path and phase 5 the scan path: each is run
with the kernels' launch counts set to 0 just before it, and every
kernel of the path must have launched. The script then prints one JSON
line of per-kernel numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result. It imports nothing of JAX or of tempo_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
BASE_S = 1_700_000_000


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median per-call device time of fn() in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import numpy as np

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.entry import entry
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import pallas_kernels as pk

    dev = torch.device("cuda")
    seed = args.seed
    kernels = {}  # name -> JSON record

    # ---------------------------------------------------------------- 0
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"phase 0 device: {name} x{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvidia-smi: {smi}", flush=True)

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s ({os.path.basename(so)})", flush=True)

    # data shared by phases 2, 4 and 5: 64 batches of 8192 traces x 8 spans,
    # one minute apart (2**22 spans)
    t0 = time.perf_counter()
    batches = [synth.make_batch(8192, 8, seed=seed * 1000 + i,
                                base_time_ns=(BASE_S + 60 * i) * 10**9)
               for i in range(64)]
    print(f"data: {sum(b.num_spans for b in batches)} spans in {len(batches)} batches "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    queries = [
        "{ } | rate() by (resource.service.name)",
        "{ status = error } | count_over_time() by (name)",
        "{ } | quantile_over_time(duration, 0.5, 0.99) by (resource.service.name)",
    ]

    def plan_of(q):
        return M.compile_metrics_plan(q, BASE_S, BASE_S + 3600, 60, max_series=64)

    # ---------------------------------------------------------------- 2
    rng = np.random.default_rng(seed)

    def seg_case(label, slots_np, n_slots, w_np, record=False):
        s_d = torch.from_numpy(slots_np).to(dev)
        w_d = None if w_np is None else torch.from_numpy(w_np).to(dev)
        got = pk.seg_bincount(s_d, n_slots, weights=w_d)
        want = pk._seg_bincount_plain(s_d, n_slots, w_d)
        check(torch.equal(got, want), f"seg_bincount {label}: kernel != plain")
        n = len(slots_np)
        if n == 0:
            print(f"phase 2 seg_bincount {label}: equal (no launch)", flush=True)
            return
        ms = cuda_ms(torch, lambda: pk._seg_bincount_cuda(s_d, n_slots, w_d))
        plain = cuda_ms(torch, lambda: pk._seg_bincount_plain(s_d, n_slots, w_d))
        live = (s_d >= 0) & (s_d < n_slots)
        s_live = s_d[live].to(torch.int64)
        w_live = None if w_d is None else w_d[live].to(torch.float64)
        lib = cuda_ms(torch, lambda: torch.bincount(s_live, weights=w_live, minlength=n_slots))
        nbytes = n * 4 * (1 if w_np is None else 2) + n_slots * 8
        bnd, by = bound_ms(nbytes, n)
        print(f"phase 2 seg_bincount {label}: equal | kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"torch.bincount {lib:.4f} ms, bound {bnd:.4f} ms ({by})", flush=True)
        if record:
            kernels["seg_bincount"] = dict(
                shape=f"N={n} n_slots={n_slots} weights={'yes' if w_np is not None else 'no'}",
                max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib)

    n22 = 1 << 22
    for n_slots in (3840, 990_720, 1 << 22):
        slots = rng.integers(-64, n_slots + 64, n22).astype(np.int32)
        w = rng.integers(1, 9, n22).astype(np.int32)
        seg_case(f"synthetic N=2^22 n_slots={n_slots} weighted", slots, n_slots, w)
        seg_case(f"synthetic N=2^22 n_slots={n_slots}", slots, n_slots, None)
    seg_case("N=0", np.zeros(0, np.int32), 3840, None)
    seg_case("N=1", np.array([7], np.int32), 3840, np.array([3], np.int32))
    # the main path's own flush inputs: 16 batches (2**20 spans) of each query
    for qi, q in enumerate(queries):
        plan = plan_of(q)
        series = M.SeriesTable(plan.max_series)
        raw = np.concatenate([M.eval_batch(plan, b, b.dictionary, series).slots
                              for b in batches[:16]])
        slots, w = pk.compress_slot_runs(raw)
        seg_case(f"main-path flush of query {qi} ({len(raw)} rows -> {len(slots)} entries, "
                 f"n_slots={plan.n_slots})", slots.astype(np.int32), plan.n_slots, w,
                 record=(qi == 2))

    C, S, n_pad = 4, 8, 1 << 20
    cols_np = [rng.integers(0, 40, n_pad).astype(np.uint32) for _ in range(C)]
    cols_np[1][:64] = 0xFFFFFFFF  # a column value equal to the code-set padding
    cols = [torch.from_numpy(c) for c in cols_np]
    sets_ = [torch.from_numpy(rng.choice(40, size=s, replace=False).astype(np.uint32))
             for s in (8, 5, 8, 3)]
    for n in (n_pad, n_pad - 777):
        dcols = [c[:n].to(dev) for c in cols]
        got = pk.in_set_scan(dcols, [s.to(dev) for s in sets_], n_pad).cpu()
        want = pk.in_set_scan([c[:n] for c in cols], sets_, n_pad)
        check(torch.equal(got, want), f"in_set_scan n={n}: kernel != plain")
    u16 = torch.from_numpy(np.full(n_pad, 500, np.uint16))
    got = pk.in_set_scan([u16.to(dev)], [torch.tensor([500]).to(dev)], n_pad).cpu()
    check(bool(got.all()), "in_set_scan uint16 column")
    got = pk.in_set_scan([torch.arange(n_pad).to(dev)],
                         [torch.tensor([int(pk.NO_MATCH_CODE)]).to(dev)], n_pad).cpu()
    check(not bool(got.any()), "in_set_scan sentinel code set")
    print("phase 2 in_set_scan: C=4 S=8 n_pad=2^20 (full and ragged), uint16, sentinel: equal",
          flush=True)

    lo_b, hi_b = (7 << 32) | 0xFFFFFFFF, (9 << 32)
    v = rng.integers(0, 12 << 32, n_pad, dtype=np.int64)
    v[:6] = [lo_b, lo_b - 1, lo_b + 1, hi_b, hi_b - 1, hi_b + 1]
    vt = torch.from_numpy(v)
    for n in (n_pad, n_pad - 333):
        got = pk.u64_range_scan(vt[:n].to(dev), lo_b, hi_b, n_pad).cpu()
        want = pk.u64_range_scan(vt[:n], lo_b, hi_b, n_pad)
        check(torch.equal(got, want), f"u64_range_scan n={n}: kernel != plain")
    print("phase 2 u64_range_scan: n_pad=2^20, bounds on the limb boundary: equal", flush=True)

    # ---------------------------------------------------------------- 3 + 4
    for k in (pk.seg_bincount, pk.in_set_scan, pk.u64_range_scan):
        k.launches = 0

    fn, ex = entry(device="cuda", n_rows=1 << 22)
    out = fn(*ex)  # first call: allocator and library warm-up
    torch.cuda.synchronize()
    step_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*ex)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    fn_cpu, ex_cpu = entry(device="cpu", n_rows=1 << 22)
    t0 = time.perf_counter()
    ref = fn_cpu(*ex_cpu)
    cpu_s = time.perf_counter() - t0
    for key in ("perm", "keep", "n_rows", "n_traces", "bloom", "hll", "cm"):
        check(torch.equal(out[key].cpu(), ref[key]), f"compaction {key}: cuda != cpu")
    print(f"phase 3 compaction: 2^22 rows, n_rows={int(out['n_rows'])} "
          f"n_traces={int(out['n_traces'])}, cuda == cpu on perm/keep/n_rows/n_traces/bloom/"
          f"hll/cm | step {statistics.median(step_s) * 1e3:.2f} ms (median of 3; "
          f"{', '.join(f'{s * 1e3:.2f}' for s in step_s)}), cpu {cpu_s * 1e3:.0f} ms", flush=True)

    def run_query(q, device):
        plan = plan_of(q)
        t0 = time.perf_counter()
        acc = M.make_accumulator(plan, device=device)
        for b in batches:
            acc.add(M.eval_batch(plan, b, b.dictionary, acc.series), b)
        merged = M.new_wire()
        M.merge_wire(merged, acc.to_wire(), plan)
        matrix = M.finalize_matrix(plan, merged)
        return matrix, time.perf_counter() - t0, acc

    query_ms = []
    for q in queries:
        before = pk.seg_bincount.launches
        got, wall, acc = run_query(q, "cuda")
        check(isinstance(acc, M.DeviceAccumulator), "cuda query did not take the device path")
        check(pk.seg_bincount.launches > before, f"{q}: seg_bincount did not launch")
        want, cpu_wall, _ = run_query(q, "cpu")
        check(got == want, f"{q}: cuda matrix != cpu matrix")
        check(len(got["result"]) > 0, f"{q}: empty result")
        query_ms.append(wall * 1e3)
        print(f"phase 4 metrics: {q} | {len(got['result'])} series, cuda == cpu | "
              f"query {wall * 1e3:.1f} ms ({acc.dispatches} seg_bincount launches), "
              f"cpu pipeline {cpu_wall * 1e3:.1f} ms", flush=True)
    kernels.setdefault("seg_bincount", {})["launches"] = pk.seg_bincount.launches
    check(pk.seg_bincount.launches > 0, "main path: seg_bincount never launched")

    # ---------------------------------------------------------------- 5
    for k in (pk.seg_bincount, pk.in_set_scan, pk.u64_range_scan):
        k.launches = 0
    cat = {k: np.concatenate([b.cols[k] for b in batches])
           for k in ("service", "name", "http_method", "http_status", "duration_nano")}
    d = batches[0].dictionary  # make_batch builds the same dictionary every time
    want_codes = [
        np.array([d.get("frontend"), d.get("cart")], np.uint32),
        np.array([d.get("db.query"), d.get("cache.get"), d.get("render")], np.uint32),
        np.array([d.get("GET"), d.get("POST")], np.uint32),
        np.array([500], np.uint32),
    ]
    n_rows = len(cat["service"])
    scan_cols = [torch.from_numpy(cat[k]).to(dev)
                 for k in ("service", "name", "http_method", "http_status")]
    scan_sets = [torch.from_numpy(c).to(dev) for c in want_codes]
    hit = pk.in_set_scan(scan_cols, scan_sets, n_rows).cpu().numpy()
    oracle = np.ones(n_rows, bool)
    for k, c in zip(("service", "name", "http_method", "http_status"), want_codes):
        oracle &= np.isin(cat[k].astype(np.uint32), c)
    check(np.array_equal(hit, oracle), "scan path: in_set_scan != numpy oracle")
    lo_ns, hi_ns = 100_000_000, 500_000_000
    dur = torch.from_numpy(cat["duration_nano"].view(np.int64)).to(dev)
    rng_hit = pk.u64_range_scan(dur, lo_ns, hi_ns, n_rows).cpu().numpy()
    check(np.array_equal(rng_hit, (cat["duration_nano"] >= lo_ns) & (cat["duration_nano"] <= hi_ns)),
          "scan path: u64_range_scan != numpy oracle")
    scan_launches = {"in_set_scan": pk.in_set_scan.launches,
                     "u64_range_scan": pk.u64_range_scan.launches}
    for k, n in scan_launches.items():
        check(n > 0, f"scan path: {k} never launched")
    print(f"phase 5 scan: {n_rows} spans, service/name/method/status in-set -> "
          f"{int(hit.sum())} rows, duration in [100ms, 500ms] -> {int(rng_hit.sum())} rows; "
          f"both equal the numpy oracle", flush=True)

    # time the scan kernels at the scan path's shapes
    mat = torch.stack([pk.u32_bits(c) for c in scan_cols])
    s_pad = 4
    codes = torch.full((4, s_pad), -1, dtype=torch.int32, device=dev)
    for c, cs in enumerate(scan_sets):
        codes[c, : cs.shape[0]] = pk.u32_bits(cs)
    check(torch.equal(pk._in_set_cuda(mat, codes, n_rows), pk._in_set_plain(mat, codes, n_rows)),
          "in_set_scan at the scan shape: kernel != plain")
    ms = cuda_ms(torch, lambda: pk._in_set_cuda(mat, codes, n_rows))
    plain = cuda_ms(torch, lambda: pk._in_set_plain(mat, codes, n_rows))

    def isin_chain():
        m = torch.isin(mat[0], codes[0])
        for c in range(1, 4):
            m &= torch.isin(mat[c], codes[c])
        return m

    lib = cuda_ms(torch, isin_chain)
    bnd, by = bound_ms(4 * n_rows * 4 + codes.numel() * 4 + n_rows, 4 * s_pad * n_rows)
    kernels["in_set_scan"] = dict(shape=f"C=4 S={s_pad} n_pad={n_rows}", max_abs_err=0, ms=ms,
                                  plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                                  launches=scan_launches["in_set_scan"])
    print(f"phase 5 in_set_scan timing: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"torch.isin chain {lib:.4f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    hi, lo = pk.range_limbs(dur, n_rows)
    bounds = (lo_ns >> 32, lo_ns & 0xFFFFFFFF, hi_ns >> 32, hi_ns & 0xFFFFFFFF)
    check(torch.equal(pk._range_cuda(hi, lo, bounds, n_rows),
                      pk._range_plain(hi, lo, bounds, n_rows)),
          "u64_range_scan at the scan shape: kernel != plain")
    ms = cuda_ms(torch, lambda: pk._range_cuda(hi, lo, bounds, n_rows))
    plain = cuda_ms(torch, lambda: pk._range_plain(hi, lo, bounds, n_rows))
    bnd, by = bound_ms(9 * n_rows, 2 * n_rows)
    kernels["u64_range_scan"] = dict(shape=f"n_pad={n_rows}", max_abs_err=0, ms=ms,
                                     plain_ms=plain, bound_ms=bnd, bound_by=by,
                                     library_ms=None, launches=scan_launches["u64_range_scan"])
    print(f"phase 5 u64_range_scan timing: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bnd:.4f} ms ({by})", flush=True)

    replaces = {
        "seg_bincount": "tempo_tpu/ops/pallas_kernels.py:194",
        "in_set_scan": "tempo_tpu/ops/pallas_kernels.py:55",
        "u64_range_scan": "tempo_tpu/ops/pallas_kernels.py:152",
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": "tempo_tpu_torch/csrc/kernels.cu",
         "replaces": replaces[k], **kernels[k]}
        for k in ("seg_bincount", "in_set_scan", "u64_range_scan")
    ], "compaction_step_ms": statistics.median(step_s) * 1e3, "query_ms": query_ms}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
