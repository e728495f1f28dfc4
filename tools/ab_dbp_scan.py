#!/usr/bin/env python3
"""Time the one-page dbp scan of this tree against another tree's on one
NVIDIA GPU, in one call.

    python3 tools/ab_dbp_scan.py --against DIR

DIR is another checkout of the repo (say the parent commit's, from `git
archive` unpacked into a directory that .gitignore lists). Each tree runs
in a process of its own, in the order DIR, this tree, this tree, DIR: it
builds its kernels and calls its own ops/scan.resident_dbp_scan (the
wrapper's Python interface is the same across the scan's designs) on dbp
pages made from a seed at the shapes below: random packed words at the
width, a random first value and a range cutting the decoded values. Each
answer is held against the wrapper's plain version on the CPU, then timed
as chip_smoke.kernel_ms times a kernel (device time of a CUDA graph of 48
calls, every launch a call makes included). Prints a line a run, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (rows, delta width): one CTA; clusters of 2 to 16 CTAs at widths 31 and 8
# (chip_smoke.py phase 10's largest resident dbp page is 32,768 rows at
# width 31); the largest resident page, 65,536 rows
SHAPES = ((2048, 31), (4096, 31), (16384, 31), (32768, 8), (32768, 31), (65536, 16),
          (65536, 31))


def child(tree: str) -> None:
    """Time `tree`'s resident_dbp_scan; print {"n=.. w=..": us} as JSON."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from tempo_tpu_torch.ops import scan

    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(0)
    out = {}
    for n, w in SHAPES:
        raw = rng.integers(0, 256, ((n - 1) * w + 7) // 8, dtype=np.uint8).tobytes()
        words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4")
        words = torch.from_numpy(words.view(np.int32).copy())
        first = int(rng.integers(0, 2**62))
        lo, hi = first, first + (1 << 36)
        want = scan.resident_dbp_scan(words, first, w, n, lo, hi)
        dev = words.cuda()
        got = scan.resident_dbp_scan(dev, first, w, n, lo, hi)
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"{tree}: resident_dbp_scan n={n} width={w}: kernel != plain")
        out[f"n={n} w={w}"] = smoke.kernel_ms(
            torch, [lambda: scan.resident_dbp_scan(dev, first, w, n, lo, hi)]) * 1e3
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, help="another checkout of the repo")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    other = os.path.abspath(args.against)
    for tree in (other, ROOT, ROOT, other):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--against", other,
                              "--child", tree], cwd=tree, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr[-3000:], file=sys.stderr)
            return 1
        us = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"{'this tree' if tree == ROOT else other}: "
              + ", ".join(f"{k} {v:.3f} us" for k, v in us.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
