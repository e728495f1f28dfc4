#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 tools/profile_torch_port.py [--rows 4194304] [--out chiprun_out]
                                        [--windows step,query,blocks,db]

Profiles, with torch.profiler (CPU + CUDA activities), up to three
windows:

1. step: the compaction step (entry.entry at --rows rows), one warm call;
2. query: one metrics query_range, `{ } | quantile_over_time(duration,
   0.5, 0.99) by (resource.service.name)`, over --rows synthetic spans;
3. blocks: the block path of chip_smoke.py's phase 6 — two vtpu1 blocks
   of 2**20 spans (the second repeats every 8th trace of the first) are
   written on the card (the first write is a window), then one window
   compacts them with merge_path="device" and one runs the quantile
   query through evaluate_block over the output. The write and the
   compaction also print their host functions with the most own time
   (cProfile);
4. db: the storage engine — TempoDB(device="cuda") over the same two
   blocks (written through TempoDB.write_batch, outside the windows).
   One window is a cold unbounded tag search, `service=cart` (limit 0,
   column cache cleared), with its host own time (cProfile); the search
   runs on the host, as the reference's single-device search does, so
   this window alone expects no device activity: its idle share is the
   reading. A second host window finds 200 absent trace IDs through
   TempoDB.find. Then the two blocks are compacted twice, each a window with
   host own time: by VtpuCompactor directly (merge_path "auto", as
   phase 6 does) and by TempoDB.compact_once (the selector and driver
   around the same compactor).

For each window it writes a chrome trace to --out and prints, from that
trace, the wall time, the device's busy time (the union of its kernel,
copy and memset intervals), the idle share (1 - busy / wall) and the ten
device activities with the most time. Every window launches work on the
card, so a window whose trace holds no device activity is a capture fault,
not a reading: the script says so and exits 1 after the last window. Needs
a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BASE_S = 1_700_000_000


def device_busy(trace_path: str):
    """(busy us, {name: us}) from a chrome trace: the union of the
    intervals of GPU kernels, copies and memsets, and their time by name."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name: dict = {}
    for e in gpu:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy, cur = 0.0, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, by_name


EMPTY_WINDOWS: list = []  # labels of windows whose trace held no device activity


def profile_window(torch, label, fn, out_dir, host_top: int = 0, expect_device: bool = True):
    """host_top > 0 also runs fn under cProfile and prints the host
    functions with the most time of their own (numpy and the native
    codec are invisible to torch.profiler's CPU activity). A window with
    expect_device=False runs host code only: no device activity is its
    expected reading (idle share 1), not a capture fault."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    host = cProfile.Profile() if host_top else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if host is not None:
            host.enable()
        fn()
        torch.cuda.synchronize()
        if host is not None:
            host.disable()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = os.path.join(out_dir, f"trace_{label}.json")
    prof.export_chrome_trace(path)
    busy, by_name = device_busy(path)
    if not by_name and expect_device:
        EMPTY_WINDOWS.append(label)
        print(f"{label}: the trace holds no device activity (capture fault); no reading")
        return
    print(f"{label}: wall {wall_us / 1e3:.2f} ms (profiled), device busy {busy / 1e3:.2f} ms, "
          f"idle share {1 - busy / wall_us:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:9.3f} ms  {name[:110]}")
    if host is not None:
        stats = pstats.Stats(host).stats  # (file, line, fn) -> (cc, nc, tottime, cumtime, _)
        print(f"  host, own time (cProfile, all threads' calls seen from this one):")
        for (path, line, fn_name), (_, ncalls, tt, _, _) in sorted(
                stats.items(), key=lambda kv: -kv[1][2])[:host_top]:
            print(f"  {tt * 1e3:9.1f} ms  {ncalls:6d} calls  {fn_name} "
                  f"({os.path.basename(path)}:{line})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--windows", default="step,query,blocks")
    args = ap.parse_args()
    windows = set(args.windows.split(","))

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(args.out, exist_ok=True)

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.entry import entry
    from tempo_tpu_torch.ops import _build

    print(torch.cuda.get_device_name(0), "|", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.lib()

    plan = M.compile_metrics_plan(
        "{ } | quantile_over_time(duration, 0.5, 0.99) by (resource.service.name)",
        BASE_S, BASE_S + 3600, 60, max_series=64)
    if "step" in windows:
        fn, ex = entry(device="cuda", n_rows=args.rows)
        fn(*ex)  # warm-up: allocator, sort workspaces
        profile_window(torch, "compaction", lambda: fn(*ex), args.out)
    if "query" in windows:
        profile_query(torch, plan, args.rows, args.out)
    if "blocks" in windows:
        profile_blocks(torch, plan, args.out)
    if "db" in windows:
        profile_db(torch, args.out)
    if EMPTY_WINDOWS:
        print(f"profile_torch_port: no device activity captured in {EMPTY_WINDOWS}",
              file=sys.stderr)
        return 1
    return 0


def profile_query(torch, plan, rows: int, out_dir: str) -> None:
    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.model import synth

    n_batches = max(1, rows // 65536)
    batches = [synth.make_batch(8192, 8, seed=i, base_time_ns=(BASE_S + 60 * i) * 10**9)
               for i in range(n_batches)]

    def query():
        acc = M.make_accumulator(plan, device="cuda")
        for b in batches:
            acc.add(M.eval_batch(plan, b, b.dictionary, acc.series), b)
        merged = M.new_wire()
        M.merge_wire(merged, acc.to_wire(), plan)
        return M.finalize_matrix(plan, merged)

    query()  # warm-up
    profile_window(torch, "metrics_quantile", query, out_dir)


def profile_blocks(torch, plan, out_dir: str) -> None:
    import tempfile

    import numpy as np

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
    from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
    from tempo_tpu_torch.encoding.vtpu.create import write_block
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.columnar import SpanBatch

    def batches(seed0: int, n: int) -> list:
        return [synth.make_batch(8192, 8, seed=seed0 + i,
                                 base_time_ns=(BASE_S + 60 * i) * 10**9) for i in range(n)]

    cfg = BlockConfig()
    a = SpanBatch.concat(batches(100, 16)).sorted_by_trace()
    _, seg = a.trace_boundaries()
    b = SpanBatch.concat(batches(200, 14) + [a.select(np.flatnonzero(seg % 8 == 0))])
    with tempfile.TemporaryDirectory(prefix="profile_blocks_") as tmp:
        be = TypedBackend(LocalBackend(tmp))
        b = b.sorted_by_trace()
        metas = []
        profile_window(torch, "block_write",
                       lambda: metas.append(write_block([a], "p", be, cfg, device="cuda")),
                       out_dir, host_top=12)
        metas.append(write_block([b], "p", be, cfg, device="cuda"))
        out = []

        def compact():
            comp = VtpuCompactor(CompactionOptions(block_config=cfg, merge_path="device"),
                                 device="cuda")
            out.extend(comp.compact(metas, "p", be))

        profile_window(torch, "block_compaction", compact, out_dir, host_top=12)

        def query():
            acc = M.evaluate_block(plan, VtpuBackendBlock(out[0], be, cfg), device="cuda")
            merged = M.new_wire()
            M.merge_wire(merged, acc.to_wire(), plan)
            return M.finalize_matrix(plan, merged)

        query()  # warm-up
        profile_window(torch, "block_query_quantile", query, out_dir)


def profile_db(torch, out_dir: str) -> None:
    import tempfile

    import numpy as np

    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import CompactionOptions, SearchRequest
    from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
    from tempo_tpu_torch.encoding.vtpu.colcache import shared_cache
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.columnar import SpanBatch

    def batches(seed0: int, n: int) -> list:
        return [synth.make_batch(8192, 8, seed=seed0 + i,
                                 base_time_ns=(BASE_S + 60 * i) * 10**9) for i in range(n)]

    a = SpanBatch.concat(batches(100, 16)).sorted_by_trace()
    _, seg = a.trace_boundaries()
    b = SpanBatch.concat(batches(200, 14) + [a.select(np.flatnonzero(seg % 8 == 0))])
    with tempfile.TemporaryDirectory(prefix="profile_db_") as tmp:
        db = TempoDB(DBConfig(backend="local", backend_path=tmp), device="cuda")
        db.write_batch("p", a)
        db.write_batch("p", b.sorted_by_trace())
        req = SearchRequest(tags={"service": "cart"}, limit=0)
        hits = []

        def search():
            shared_cache().clear()
            hits.append(len(db.search("p", req).traces))

        search()  # warm-up: imports, thread pools
        profile_window(torch, "db_search_cold_unbounded", search, out_dir, host_top=15,
                       expect_device=False)
        print(f"  ({hits[-1]} hits over 2 blocks of 2^20 spans)")

        rng = np.random.default_rng(5)
        absent = [t.astype(">u4").tobytes()
                  for t in rng.integers(0, 2**32, (200, 4), dtype=np.uint32)]

        def find_absent():
            if any(db.find("p", tid) is not None for tid in absent):
                raise RuntimeError("profile db: a random trace ID was found")

        profile_window(torch, "db_find_200_absent", find_absent, out_dir, host_top=12,
                       expect_device=False)

        metas = db.blocklist.metas("p")
        direct = VtpuCompactor(CompactionOptions(block_config=db.cfg.block), device="cuda")
        profile_window(torch, "db_compactor_direct",
                       lambda: direct.compact(metas, "p", db.backend), out_dir, host_top=12)
        profile_window(torch, "db_compact_once", lambda: db.compact_once("p"), out_dir,
                       host_top=12)


if __name__ == "__main__":
    sys.exit(main())
