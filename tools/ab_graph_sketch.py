#!/usr/bin/env python3
"""Time root_path_sums, hll_update and the critical path's dispatch of
this tree against other trees' on one NVIDIA GPU, in one call.

    python3 tools/ab_graph_sketch.py --against DIR [DIR ...]

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
  generator push of 4,096 int32 edge keys, kernel time as above.
Every result is held against the plain version on the card first. Prints
a line a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SPANS = 1 << 21
REPS = 25  # dispatch times: the host's copies vary


def child(tree: str) -> None:
    """Time `tree`'s kernels; print {"label": ms} as JSON."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from tempo_tpu_torch.entry import entry
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
    for depth in (8, 2048):
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
                           ("push 4096 int32", edges.to(dev), None)):
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
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, nargs="+", help="other checkouts of the repo")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    others = [os.path.abspath(d) for d in args.against]
    for tree in others + [ROOT, ROOT] + others[::-1]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--against", *others,
                              "--child", tree], cwd=tree, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr[-3000:], file=sys.stderr)
            return 1
        got = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"{'this tree' if tree == ROOT else tree}: "
              + ", ".join(f"{k} {x:.5f}" for k, x in got.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
