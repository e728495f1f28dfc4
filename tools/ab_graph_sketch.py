#!/usr/bin/env python3
"""Time root_path_sums, hll_update, cm_update and the critical path's
dispatch of this tree against other trees' on one NVIDIA GPU, in one call.

    python3 tools/ab_graph_sketch.py --against DIR [DIR ...]
    python3 tools/ab_graph_sketch.py --sweep

Each DIR is another checkout of the repo (say the parent commit's, from
`git archive` unpacked into a directory that .gitignore lists). Each tree
runs in a process of its own, in the order DIR..., this tree, this tree,
DIR... reversed: it builds its kernels and, on inputs made from a seed,
- root_path_sums over 2**21 spans in chains of 8 and of 2,048: the
  kernel a critical path runs (the segmented one launch, given the trace
  segments, where the tree has it; else its launch a round) and the
  launch-a-round kernel, each timed as chip_smoke.kernel_ms times a
  kernel (device time of a CUDA graph of launches of the C entry point),
  and the graph_critical_path dispatch (root_path_sums_device, with the
  segments where the tree takes them) as chip_smoke.path_ms times a call;
- hll_update at p = 12: the compaction step's 2**22 int64 keys with its
  first-row mask, a block writer's flush of 8,192 int32 IDs and a
  generator push of 4,096 int32 edge keys, kernel time as above;
- cm_update at 4 x 4,096: the compaction step's keys with its
  surviving-row mask, the same with u32 weights, the same keys as sorted
  traces of 8 spans, a generator push of 4,096 edge keys of the demo's 8
  services; the step's keys at 8 x 8,192 (global atomics), and at 1 x
  16,384 and 2 x 8,192 (the same private copy at other depths): kernel
  time as above, and the wrapper's call (sketch.cm_update, its counters'
  copy and masking included) as chip_smoke.path_ms times a call.
--sweep times cm_update alone over copies of this tree (under _archive/,
which .gitignore lists) whose graph_sketch_kernels.cu has its launch
constants changed (CM_SWEEP): a CTA's threads, CTAs an SM, the cluster's
largest size and the updates a counter below which the adds go global;
this tree first and last. Every result is held against the plain version
on the card first.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SPANS = 1 << 21
REPS = 25  # dispatch times: the host's copies vary
# (label, {constant of graph_sketch_kernels.cu: value}) for --sweep
CM_SWEEP = [("threads 256", {"kCmThreads": 256}), ("threads 512", {"kCmThreads": 512}),
            ("threads 512, ctas/SM 3", {"kCmThreads": 512, "kCmCtasPerSm": 3}),
            ("threads 768", {"kCmThreads": 768}), ("ctas/SM 1", {"kCmCtasPerSm": 1}),
            ("cluster 1", {"kCmCluster": 1}), ("cluster 4", {"kCmCluster": 4}),
            ("private always", {"kCmPrivateUpdates": 0}),
            ("private from 8 a counter", {"kCmPrivateUpdates": 8})]


def child(tree: str, parts: str) -> None:
    """Time `tree`'s kernels of `parts` (rps, hll, cm); print {"label": ms}
    as JSON."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from tempo_tpu_torch.entry import entry
    from tempo_tpu_torch.graph import edge_hash_limbs
    from tempo_tpu_torch.model.synth import SERVICES
    from tempo_tpu_torch.ops import _build, merge, sketch
    from tempo_tpu_torch.ops import graph as ops_graph

    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    lib = _build.lib()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    out = {}
    n = N_SPANS
    rounds = ops_graph._n_rounds(n)
    segmented = hasattr(lib, "tt_root_path_sums_segmented")
    takes_firsts = "firsts" in inspect.signature(ops_graph.root_path_sums_device).parameters
    row = np.arange(n)
    for depth in (8, 2048) if "rps" in parts else ():
        parent = np.where(row % depth == 0, -1, row - 1)
        firsts = np.arange(0, n, depth)
        s = rng.integers(0, 2**63, n)
        p_d = torch.from_numpy(parent.astype(np.int32)).to(dev)
        s_d = torch.from_numpy(s).to(dev)
        f_d = torch.from_numpy(firsts.astype(np.int32)).to(dev)
        want = ops_graph._root_path_sums_plain(p_d, s_d, rounds)
        res = torch.empty_like(s_d)
        bufs = [torch.empty_like(p_d), torch.empty_like(s_d), torch.empty_like(p_d),
                torch.empty_like(s_d)]
        launched = ctypes.c_int32(0)

        def rounds_launch():
            _build.check(lib.tt_root_path_sums(p_d.data_ptr(), s_d.data_ptr(), n, rounds,
                                               *(b.data_ptr() for b in bufs),
                                               ctypes.byref(launched), stream()), "rps")
        rounds_launch()
        got = bufs[1] if rounds % 2 == 1 else bufs[3]
        if not torch.equal(got, want):
            raise SystemExit(f"{tree}: root_path_sums depth {depth}: kernel != plain")
        out[f"rps rounds kernel depth {depth} ms"] = smoke.kernel_ms(torch, [rounds_launch], k=8)
        if segmented:
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            scratch = torch.empty(4 * n, dtype=torch.int64, device=dev)

            def seg_launch():
                _build.check(lib.tt_root_path_sums_segmented(
                    p_d.data_ptr(), s_d.data_ptr(), f_d.data_ptr(), n, len(firsts), rounds,
                    res.data_ptr(), scratch.data_ptr(), flag.data_ptr(), ctypes.byref(launched),
                    stream()), "rps")
            seg_launch()
            if int(flag.item()) or not torch.equal(res, want):
                raise SystemExit(f"{tree}: segmented root_path_sums depth {depth} != plain")
            out[f"rps served kernel depth {depth} ms"] = smoke.kernel_ms(torch, [seg_launch], k=16)
        else:
            out[f"rps served kernel depth {depth} ms"] = out[f"rps rounds kernel depth {depth} ms"]
        kw = {"firsts": firsts} if takes_firsts else {}
        got_h = ops_graph.root_path_sums_device(parent, s.view(np.uint64), dev, **kw)
        if not np.array_equal(got_h, want.cpu().numpy().view(np.uint64)):
            raise SystemExit(f"{tree}: root_path_sums_device depth {depth} != plain")
        out[f"dispatch depth {depth} ms"] = smoke.path_ms(
            torch, lambda: ops_graph.root_path_sums_device(parent, s.view(np.uint64), dev, **kw),
            reps=REPS, warmup=2)
        del p_d, s_d, f_d, want, res, bufs

    _, (tids, sids, valid) = entry(device=dev, n_rows=1 << 22)
    plan = merge.merge_spans(tids, sids, valid)
    perm, keep = plan["perm"].to(torch.int64), plan["keep"]
    st = tids[perm].contiguous()
    first = (merge.first_occurrence_mask(st, valid[perm]) & keep).contiguous()
    del tids, sids, plan, perm
    ids = torch.from_numpy(rng.integers(0, 2**32, (8192, 4), dtype=np.uint32).view(np.int32))
    edges = torch.from_numpy(rng.integers(0, 2**32, (4096, 4), dtype=np.uint32).view(np.int32))
    hp = sketch.HLLPlan(12)
    for label, keys, v in (("compaction 2^22 int64", st, first),
                           ("flush 8192 int32", ids.to(dev), None),
                           ("push 4096 int32", edges.to(dev), None)) if "hll" in parts else ():
        want = sketch._hll_update_plain(sketch.hll_init(hp, dev), keys, hp, v)
        if not torch.equal(sketch.hll_update(sketch.hll_init(hp, dev), keys, hp, v), want):
            raise SystemExit(f"{tree}: hll_update {label}: kernel != plain")
        regs = sketch.hll_init(hp, dev)
        vb = None if v is None else v.to(torch.bool).contiguous()

        def hll_launch():
            _build.check(lib.tt_hll_update(keys.data_ptr(), 4, keys.element_size(),
                                           None if vb is None else vb.data_ptr(),
                                           keys.shape[0], hp.m, regs.data_ptr(), stream()),
                         "hll_update")
        out[f"hll {label} ms"] = smoke.kernel_ms(torch, [hll_launch])

    pairs = rng.integers(0, len(SERVICES), (4096, 2))
    push = torch.from_numpy(np.stack([edge_hash_limbs(SERVICES[a], SERVICES[b])
                                      for a, b in pairs]).view(np.int32)).to(dev)
    w32 = torch.from_numpy(rng.integers(0, 2**32, st.shape[0])).to(dev)
    sorted8 = st[torch.arange(st.shape[0], device=dev) // 8 * 8].contiguous()
    cp = sketch.CMPlan(4, 1 << 12)
    for label, keys, p, w, v in (("compaction 2^22 int64", st, cp, None, keep),
                                 ("weighted compaction", st, cp, w32, keep),
                                 ("sorted traces of 8", sorted8, cp, None, keep),
                                 ("push 4096 int32", push, cp, None, None),
                                 ("8x8192 compaction", st, sketch.CMPlan(8, 1 << 13), None,
                                  keep),
                                 # the default's 16,384 counters at other depths: what each
                                 # row of the sketch (a fmix32 and a shared add a key) costs
                                 ("1x16384 compaction", st, sketch.CMPlan(1, 1 << 14), None,
                                  keep),
                                 ("2x8192 compaction", st, sketch.CMPlan(2, 1 << 13), None,
                                  keep)) if "cm" in parts else ():
        start = sketch.cm_init(p, dev)
        want = sketch._cm_update_plain(start, keys, p, w, v)
        if not torch.equal(sketch.cm_update(start, keys, p, w, v), want):
            raise SystemExit(f"{tree}: cm_update {label}: kernel != plain")
        counts = sketch.cm_init(p, dev)
        vb = None if v is None else v.to(torch.bool).contiguous()
        wb = None if w is None else sketch.u32_bits(w).contiguous()

        def cm_launch():
            _build.check(lib.tt_cm_update(keys.data_ptr(), 4, keys.element_size(),
                                          None if wb is None else wb.data_ptr(),
                                          None if vb is None else vb.data_ptr(), keys.shape[0],
                                          p.depth, p.width, (sketch.CM_SEED * 31) & 0xFFFFFFFF,
                                          counts.data_ptr(), stream()), "cm_update")
        out[f"cm {label} ms"] = smoke.kernel_ms(torch, [cm_launch])
        out[f"cm {label} path ms"] = smoke.path_ms(
            torch, lambda: sketch.cm_update(start, keys, p, w, v), reps=REPS, warmup=2)
    print(json.dumps(out))


def sweep_trees() -> list[tuple[str, str]]:
    """(label, tree): copies of this tree's package under _archive/cm_sweep/,
    each with one CM_SWEEP change to graph_sketch_kernels.cu; the kernels
    of the other sources come along already built when this tree has them."""
    out = []
    src = os.path.join(ROOT, "tempo_tpu_torch")
    for label, consts in CM_SWEEP:
        tree = os.path.join(ROOT, "_archive", "cm_sweep", re.sub(r"\W+", "_", label))
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(src, os.path.join(tree, "tempo_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = os.path.join(tree, "tempo_tpu_torch", "csrc", "graph_sketch_kernels.cu")
        with open(cu) as f:
            text = f.read()
        for name, value in consts.items():
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            if n != 1:
                raise SystemExit(f"--sweep: {name} is not a constant of {cu}")
        with open(cu, "w") as f:
            f.write(text)
        out.append((label, tree))
    return out


def run(tree: str, parts: str, label: str) -> bool:
    """Time `tree` in a process of its own and print its line."""
    got = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                          "--parts", parts], cwd=tree, capture_output=True, text=True)
    if got.returncode != 0:
        print(got.stdout + got.stderr[-3000:], file=sys.stderr)
        return False
    ms = json.loads(got.stdout.strip().splitlines()[-1])
    print(f"{label}: " + ", ".join(f"{k} {x:.5f}" for k, x in ms.items()), flush=True)
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--against", nargs="+", help="other checkouts of the repo")
    group.add_argument("--sweep", action="store_true",
                       help="cm_update over copies of this tree with its launch constants changed")
    group.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--parts", default="rps,hll,cm", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.parts)
        return 0
    if args.sweep:
        # the copies are made once this tree has built its kernels
        ok = (run(ROOT, "cm", "this tree")
              and all(run(tree, "cm", label) for label, tree in sweep_trees())
              and run(ROOT, "cm", "this tree"))
    else:
        others = [os.path.abspath(d) for d in args.against]
        ok = all(run(tree, args.parts, "this tree" if tree == ROOT else tree)
                 for tree in others + [ROOT, ROOT] + others[::-1])
    if not ok:
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
