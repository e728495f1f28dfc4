#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 tools/profile_torch_port.py [--rows 4194304] [--out chiprun_out]

Profiles, with torch.profiler (CPU + CUDA activities), two windows:

1. the compaction step (entry.entry at --rows rows), one warm call;
2. one metrics query_range, `{ } | quantile_over_time(duration, 0.5,
   0.99) by (resource.service.name)`, over --rows synthetic spans.

For each window it writes a chrome trace to --out and prints, from that
trace, the wall time, the device's busy time (the union of its kernel,
copy and memset intervals), the idle share (1 - busy / wall) and the ten
device activities with the most time. Needs a CUDA device; exits 1 without one.
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


def profile_window(torch, label, fn, out_dir):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = os.path.join(out_dir, f"trace_{label}.json")
    prof.export_chrome_trace(path)
    busy, by_name = device_busy(path)
    print(f"{label}: wall {wall_us / 1e3:.2f} ms (profiled), device busy {busy / 1e3:.2f} ms, "
          f"idle share {1 - busy / wall_us:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:9.3f} ms  {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(args.out, exist_ok=True)

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.entry import entry
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.ops import _build

    print(torch.cuda.get_device_name(0), "|", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.lib()

    fn, ex = entry(device="cuda", n_rows=args.rows)
    fn(*ex)  # warm-up: allocator, sort workspaces
    profile_window(torch, "compaction", lambda: fn(*ex), args.out)

    n_batches = max(1, args.rows // 65536)
    batches = [synth.make_batch(8192, 8, seed=i, base_time_ns=(BASE_S + 60 * i) * 10**9)
               for i in range(n_batches)]
    plan = M.compile_metrics_plan(
        "{ } | quantile_over_time(duration, 0.5, 0.99) by (resource.service.name)",
        BASE_S, BASE_S + 3600, 60, max_series=64)

    def query():
        acc = M.make_accumulator(plan, device="cuda")
        for b in batches:
            acc.add(M.eval_batch(plan, b, b.dictionary, acc.series), b)
        merged = M.new_wire()
        M.merge_wire(merged, acc.to_wire(), plan)
        return M.finalize_matrix(plan, merged)

    query()  # warm-up
    profile_window(torch, "metrics_quantile", query, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
