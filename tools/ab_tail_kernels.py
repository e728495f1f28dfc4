#!/usr/bin/env python3
"""Time the ingest tail's tail_fold and tail_scan, kernels and wrappers, of
this tree against other trees' on one NVIDIA GPU, in one call.

    python3 tools/ab_tail_kernels.py --against DIR [DIR ...]
    python3 tools/ab_tail_kernels.py --sweep
    python3 tools/ab_tail_kernels.py --parts

Each DIR is another checkout of the repo (say the parent commit's, from
`git archive` unpacked into a directory that .gitignore lists). Each tree
runs in a process of its own, in the order DIR..., this tree, this tree,
DIR... reversed: it builds its kernels and parks, through its own
park_cut on a card tier, two cuts of synth.make_batch traces (8 spans a
trace) stamped over 40 minutes: 786,432 spans (chip_smoke.py phase 12
(b), p = 2**20) and 32,768 spans (one phase 12 (a) cut, p = 2**15). On
each it folds `{ resource.service.name = "cart" } | rate() by (name)`
(45 one-minute bins) and scans service.name=frontend with minDuration
100ms and maxDuration 900ms, and
- holds the wrapper's counts and mask against the plain versions on the
  card first;
- times each kernel as chip_smoke.kernel_ms times one (device time of a
  CUDA graph of launches of the C entry point, over three copies of the
  parked columns): "fold kernel" is the entry point as the tree has it,
  "fold zeroed" the counts zeroed and folded (a tree whose entry point
  leaves the zeroing to its caller gets a torch zero_ before each launch),
  "fold staged kernel" the same fold with its constants staged on the
  card (where the tree carries them by value otherwise);
- times each wrapper call (ingest_tail.tail_fold, tail_scan) as
  chip_smoke.path_ms times one;
- reads each kernel's grid and block from a torch.profiler trace of one
  wrapper call (where the profiler sees the card).
--sweep times this tree against copies of it (under _archive/, which
.gitignore lists) whose tail_kernels.cu has one launch constant changed
each (TAIL_SWEEP), this tree first and last. --parts times this tree's
fold entry point against builds of its source with one part of the fold
removed or replaced each (FOLD_PARTS: the zeroing kernel by a
cudaMemsetAsync, the binary searches, the packed rows' searches and adds,
all but the first column's loads, all but the launch), at both shapes:
what each part costs.
Prints a line a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (786_432, 32_768)
FOLD_Q = '{ resource.service.name = "cart" } | rate() by (name)'
# (label, [(text of tail_kernels.cu, its replacement)]) for --parts: the
# fold as built, then one part of it removed or replaced each
FOLD_PARTS = [
    ("as built", []),
    ("counts zeroed by cudaMemsetAsync", [(
        """  tail_zero_kernel<<<(unsigned)(zero_grid < 4LL * dev.sms ? zero_grid : 4LL * dev.sms),
                     kZeroThreads, 0, (cudaStream_t)stream>>>(d.counts, n_cells);""",
        "  cudaMemsetAsync(d.counts, 0, 4 * n_cells, (cudaStream_t)stream);")]),
    ("no binary searches", [(
        "const int bin = count_le(edges, d.e_pad, (uint64_t(t_hi) << 32) | t_lo) - 1;",
        "const int bin = (int)(t_lo & 31);"), (
        "cell += (count_le(uvals, d.u_pad, code) - 1) * (d.e_pad - 1);",
        "cell += (int)(code & 3) * (d.e_pad - 1);")]),
    ("no searches or adds of the packed rows", [(
        "    for (int i = lane; i < fill; i += 32) {",
        "    for (int i = lane; i < 0; i += 32) {")]),
    ("the first column's loads only", [(
        "    if (first.col != nullptr) {\n#pragma unroll",
        "    if (d.nb_real >= 0) {\n      uint32_t x = 0;\n"
        "      for (int k = 0; k < kFoldQuads; ++k) x ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w"
        " ^ lo[k].x ^ hi[k].y ^ by[k].z;\n"
        "      if (x == 0xFFFFFFFFu) atomicAdd(d.counts, 1);\n      return;\n    }\n"
        "    if (first.col != nullptr) {\n#pragma unroll")]),
    ("launch and zeroing only", [(
        "  if (q_begin >= q_end) return;\n  const Pred* staged",
        "  if (q_begin >= 0) return;\n  const Pred* staged")]),
]
# (label, {constant of tail_kernels.cu: value}) for --sweep
TAIL_SWEEP = [("fold threads 128", {"kFoldThreads": 128}),
              ("fold threads 512", {"kFoldThreads": 512}),
              ("fold quads 2", {"kFoldQuads": 2}), ("fold quads 8", {"kFoldQuads": 8}),
              ("fold min quads 64", {"kFoldMinQuads": 64}),
              ("scan threads 128", {"kScanThreads": 128}),
              ("scan threads 512", {"kScanThreads": 512}),
              ("scan rows 16 past the SMs' first CTAs", {"kScanRows": 16}),
              ("scan rows 4 at every size", {"kScanRows": 4}),
              ("scan rows 8 at every size", {"kScanRowsFew": 8})]


def _grids(torch, fns: dict) -> dict:
    """{label: "grid x block"} of the kernel each fn launches, from a
    torch.profiler trace of one call each; {} where it sees no kernel."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, (fn, kernel) in fns.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("cat") == "kernel" and kernel in e.get("name", ""):
                args = e.get("args", {})
                out[label] = f"{args.get('grid')} x {args.get('block')}"
    return out


def _cut(n: int, dev) -> tuple:
    """A cut of n make_batch spans stamped over the last 40 minutes, parked
    on a card tier through park_cut, and the timed fold's plan and inputs:
    (batch, tier, arrays, plan, fold plan, preds, uvals, edges_lo, edges_hi)."""
    import numpy as np

    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.metrics_engine import compile_metrics_plan
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.ops import ingest_tail

    now_min = int(time.time()) // 60 * 60
    rng = np.random.default_rng(n)
    batch = synth.make_batch(n // 8, 8, seed=1200 + n)
    batch.cols["start_unix_nano"] = ((now_min - 40 * 60) * 10**9 + rng.integers(
        0, 40 * 60 * 10**9, n)).astype(np.uint64)
    tier = colcache.DeviceTier(256 << 20, ingest_tail_budget_bytes=64 << 20, device=dev)
    arrays = tier.get(ingest_tail.park_cut(tier, "t", "ab:0", batch)).arrays
    plan = compile_metrics_plan(FOLD_Q, now_min - 45 * 60, now_min + 60, 60, max_series=64)
    fp = ingest_tail.lower_fold_plan(plan)
    _lits, preds, _real, uvals, lo, hi = ingest_tail.fold_args(plan, fp, batch, batch.dictionary)
    return batch, tier, arrays, plan, fp, preds, uvals, lo, hi


def _smoke():
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def child(tree: str) -> None:
    """Time `tree`'s kernels and wrappers; print {"label": value} as JSON."""
    sys.path.insert(0, tree)
    import torch

    from tempo_tpu_torch.ops import _build, ingest_tail

    smoke = _smoke()
    dev = torch.device("cuda")
    lib = _build.lib()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    # a tree whose fold_descriptor takes `consts` copies the constants to
    # the card and leaves the zeroing to its caller; this tree's carries
    # them by value and zeroes in its entry point
    old_api = "consts" in inspect.signature(ingest_tail.fold_descriptor).parameters
    out = {}
    for n in SHAPES:
        batch, tier, arrays, plan, fp, preds, uvals, lo, hi = _cut(n, dev)
        copies = [arrays] + [{k: v.clone() for k, v in arrays.items()} for _ in range(2)]
        nb, length = plan.n_bins, len(uvals) * (len(lo) - 1)
        fold_args = (n, preds, fp.by_col, uvals, lo, hi, nb)
        want = ingest_tail._tail_fold_plain(arrays, *fold_args)
        if not torch.equal(ingest_tail.tail_fold(arrays, *fold_args), want):
            raise SystemExit(f"{tree}: tail_fold at {n} rows: kernel != plain")
        counts = [torch.zeros(length, dtype=torch.int32, device=dev) for _ in copies]
        if old_api:
            consts = ingest_tail.fold_consts(uvals, lo, hi, dev)
            descs = [ingest_tail.fold_descriptor(a, n, preds, fp.by_col, len(uvals), len(lo), nb,
                                                 consts, c)[0] for a, c in zip(copies, counts)]
        else:
            edges = ingest_tail._edges_u64(lo, hi)
            descs = []
            for a, c in zip(copies, counts):
                desc, staged = ingest_tail.fold_descriptor(a, n, preds, fp.by_col, uvals, edges,
                                                           nb, c)
                if staged is not None:
                    raise SystemExit(f"{tree}: the timed fold's constants do not fit by value")
                descs.append(desc)

        def fold_launch(desc, c, zero):
            def go():
                if zero:
                    c.zero_()
                _build.check(lib.tt_tail_fold(ctypes.addressof(desc), stream()), "tail_fold")
            return go

        counts[0].zero_()
        fold_launch(descs[0], counts[0], False)()
        if not torch.equal(counts[0], want):
            raise SystemExit(f"{tree}: tail_fold's entry point at {n} rows != plain")
        out[f"fold kernel {n} ms"] = smoke.kernel_ms(
            torch, [fold_launch(x, c, False) for x, c in zip(descs, counts)])
        out[f"fold zeroed {n} ms"] = smoke.kernel_ms(
            torch, [fold_launch(x, c, old_api) for x, c in zip(descs, counts)])
        out[f"fold path {n} ms"] = smoke.path_ms(
            torch, lambda: ingest_tail.tail_fold(arrays, *fold_args))
        if not old_api:
            # the same fold with its constants staged on the card (the arm
            # of folds past the descriptor's room)
            staged = [torch.from_numpy(ingest_tail.fold_consts(a, preds, uvals, edges)).to(dev)
                      for a in copies]
            sdescs = [ingest_tail.fold_descriptor(a, n, preds, fp.by_col, uvals, edges, nb, c)[0]
                      for a, c in zip(copies, counts)]
            for desc, b in zip(sdescs, staged):
                desc.consts = b.data_ptr()
            fold_launch(sdescs[0], counts[0], False)()
            if not torch.equal(counts[0], want):
                raise SystemExit(f"{tree}: tail_fold staged at {n} rows != plain")
            out[f"fold staged kernel {n} ms"] = smoke.kernel_ms(
                torch, [fold_launch(x, c, False) for x, c in zip(sdescs, counts)])

        eq = [("service", batch.dictionary.get("frontend"))]
        scan_args = (n, eq, None, 100 * 10**6, 900 * 10**6)
        swant = ingest_tail._tail_scan_plain(arrays, *scan_args)
        if not torch.equal(ingest_tail.tail_scan(arrays, *scan_args), swant):
            raise SystemExit(f"{tree}: tail_scan at {n} rows: kernel != plain")
        p = arrays["service"].numel()
        outs = [torch.empty(p, dtype=torch.uint8, device=dev) for _ in copies]
        sdescs = [ingest_tail.scan_descriptor(a, *scan_args, o) for a, o in zip(copies, outs)]

        def scan_launch(desc):
            def go():
                _build.check(lib.tt_tail_scan(ctypes.addressof(desc), stream()), "tail_scan")
            return go

        scan_launch(sdescs[0])()
        if not torch.equal(outs[0].view(torch.bool), swant):
            raise SystemExit(f"{tree}: tail_scan's entry point at {n} rows != plain")
        out[f"scan kernel {n} ms"] = smoke.kernel_ms(torch, [scan_launch(x) for x in sdescs])
        out[f"scan path {n} ms"] = smoke.path_ms(
            torch, lambda: ingest_tail.tail_scan(arrays, *scan_args))
        grids = _grids(torch, {
            f"fold grid {n}": (lambda: ingest_tail.tail_fold(arrays, *fold_args),
                               "tail_fold_kernel"),
            f"scan grid {n}": (lambda: ingest_tail.tail_scan(arrays, *scan_args),
                               "tail_scan_kernel")})
        out.update(grids)
        del copies, counts, outs, descs, sdescs, tier, arrays
        torch.cuda.empty_cache()
    print(json.dumps(out))


def parts() -> None:
    """Time this tree's tail_fold entry point against builds of
    tail_kernels.cu with one part of the fold removed or replaced each
    (FOLD_PARTS), at both shapes, one line a shape. A variant that drops a
    part folds other counts, so only its time is read."""
    sys.path.insert(0, ROOT)
    import torch

    from tempo_tpu_torch.ops import _build, ingest_tail

    smoke = _smoke()
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "tempo_tpu_torch", "csrc", "tail_kernels.cu")) as f:
        text = f.read()
    out_dir = os.path.join(ROOT, "_archive", "tail_parts")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for label, subs in FOLD_PARTS:
        variant = text
        for old, new in subs:
            if old not in variant:
                raise SystemExit(f"--parts: {label}: the source has no {old!r}")
            variant = variant.replace(old, new)
        stem = os.path.join(out_dir, re.sub(r"\W+", "_", label))
        with open(f"{stem}.cu", "w") as f:
            f.write(variant)
        procs.append((label, stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{stem}.so", f"{stem}.cu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for label, stem, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"--parts: {label}: nvcc failed:\n{err}")
        lib = ctypes.CDLL(f"{stem}.so")
        lib.tt_tail_fold.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        libs[label] = lib
    for n in SHAPES:
        _batch, _tier, arrays, plan, fp, preds, uvals, lo, hi = _cut(n, dev)
        copies = [arrays] + [{k: v.clone() for k, v in arrays.items()} for _ in range(2)]
        edges = ingest_tail._edges_u64(lo, hi)
        counts = [torch.empty(len(uvals) * (len(lo) - 1), dtype=torch.int32, device=dev)
                  for _ in copies]
        descs = [ingest_tail.fold_descriptor(a, n, preds, fp.by_col, uvals, edges, plan.n_bins,
                                             c)[0] for a, c in zip(copies, counts)]
        res = []
        for label, lib in libs.items():
            def launch(desc, lib=lib, label=label):
                def go():
                    _build.check(lib.tt_tail_fold(ctypes.addressof(desc),
                                                  torch.cuda.current_stream().cuda_stream), label)
                return go
            res.append(f"{label} {smoke.kernel_ms(torch, [launch(x) for x in descs]):.5f}")
        print(f"fold parts at {n} rows (ms): " + ", ".join(res), flush=True)


def sweep_trees() -> list[tuple[str, str]]:
    """(label, tree): copies of this tree's package under _archive/tail_sweep/,
    each with one TAIL_SWEEP change to tail_kernels.cu; the kernels of the
    other sources come along already built when this tree has them."""
    out = []
    src = os.path.join(ROOT, "tempo_tpu_torch")
    for label, consts in TAIL_SWEEP:
        tree = os.path.join(ROOT, "_archive", "tail_sweep", re.sub(r"\W+", "_", label))
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(src, os.path.join(tree, "tempo_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = os.path.join(tree, "tempo_tpu_torch", "csrc", "tail_kernels.cu")
        with open(cu) as f:
            text = f.read()
        for name, value in consts.items():
            text, k = re.subn(rf"constexpr (int|bool) {name} = [^;]+;",
                              rf"constexpr \g<1> {name} = {value};", text)
            if k != 1:
                raise SystemExit(f"--sweep: {name} is not a constant of {cu}")
        with open(cu, "w") as f:
            f.write(text)
        out.append((label, tree))
    return out


def run(tree: str, label: str) -> bool:
    """Time `tree` in a process of its own and print its line."""
    got = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree], cwd=tree,
                         capture_output=True, text=True)
    if got.returncode != 0:
        print(got.stdout + got.stderr[-3000:], file=sys.stderr)
        return False
    res = json.loads(got.stdout.strip().splitlines()[-1])
    print(f"{label}: " + ", ".join(f"{k} {x:.5f}" if isinstance(x, float) else f"{k} {x}"
                                   for k, x in res.items()), flush=True)
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--against", nargs="+", help="other checkouts of the repo")
    group.add_argument("--sweep", action="store_true",
                       help="this tree against copies with a launch constant changed each")
    group.add_argument("--parts", action="store_true",
                       help="this tree's fold against builds with one part of it removed each")
    group.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    if args.parts:
        parts()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        return 0
    if args.sweep:
        # the copies are made once this tree has built its kernels
        ok = (run(ROOT, "this tree")
              and all(run(tree, label) for label, tree in sweep_trees())
              and run(ROOT, "this tree"))
    else:
        others = [os.path.abspath(d) for d in args.against]
        ok = all(run(tree, "this tree" if tree == ROOT else tree)
                 for tree in others + [ROOT, ROOT] + others[::-1])
    if not ok:
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
