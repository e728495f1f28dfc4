#!/usr/bin/env python3
"""Time the dct scan and the batched scans' served paths of this tree
against other trees' on one NVIDIA GPU, in one call.

    python3 tools/ab_dct_scan.py --against DIR [DIR ...]

Each DIR is another checkout of the repo (say the parent commit's, from
`git archive` unpacked into a directory that .gitignore lists). Each tree
runs in a process of its own, in the order DIR..., this tree, this tree,
DIR... reversed: it builds its kernels and, on inputs made from a seed,
- calls its own ops/scan.resident_dct_scan (the wrapper's interface is
  the same across the scan's designs) at the shapes below, a dictionary
  of V random entries and n random indices, in-set against four codes;
  each answer is held against the wrapper's plain version on the CPU,
  then timed as chip_smoke.kernel_ms times a kernel (device time of a
  CUDA graph of 48 calls, every launch a call makes included). The code
  set goes as a CPU tensor where the tree takes it by value, else on the
  card;
- times the served paths as chip_smoke.path_ms does (CUDA events around
  one call, here the median of 101): resident_in_set_mask of one dct entry at
  phase 10's largest dct page, and resident_in_set_masks /
  resident_range_masks over 64 resident rle, dbp and dct entries of
  30,720 rows (a search's stage-1 pages; a tree that does not batch dct
  entries reports none).
Prints a line a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (dictionary entries V, rows n): phase 10's largest resident dct page
# (257, 65,536), one CTA, a dictionary of one entry, of a tile's worth, and
# the cap dct_probe puts on a page (V = n/2), and a dictionary larger than
# its page
SHAPES = ((1, 65536), (257, 2048), (257, 65536), (2048, 65536), (8192, 65536), (32768, 65536),
          (40000, 5000))
PAGES, ROWS = 64, 30720
REPS = 101  # path times: the host's noise is wide


def child(tree: str) -> None:
    """Time `tree`'s scans; print {"label": us or ms} as JSON."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.ops import scan

    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def u32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))

    out = {}
    for v, n in SHAPES:
        dvals = rng.integers(0, 2**32, v, dtype=np.uint64).astype(np.uint32)
        idx = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
        codes = u32(scan.pad_codes_u32(dvals[:3]))
        want = scan.resident_dct_scan(u32(dvals), idx, codes=codes)
        dv, di = u32(dvals).to(dev), idx.to(dev)
        try:
            got = scan.resident_dct_scan(dv, di, codes=codes)
            where = "by value"
        except ValueError:  # a tree that reads the code set on the card only
            codes = codes.to(dev)
            got = scan.resident_dct_scan(dv, di, codes=codes)
            where = "on the card"
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"{tree}: resident_dct_scan V={v} n={n}: kernel != plain")
        out[f"dct V={v} n={n} us (codes {where})"] = smoke.kernel_ms(
            torch, [lambda: scan.resident_dct_scan(dv, di, codes=codes)]) * 1e3

    def entry(codec, arrays, meta):
        return colcache._Resident(codec, {k: colcache.device_tensor(a, dev)
                                          for k, a in arrays.items()}, meta, 0)

    codes_np = np.array([1, 4, 2**32 - 1], np.uint32)
    dvals = rng.integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
    big = entry("dct", {"values": dvals, "idx": rng.integers(0, 257, 65536).astype(np.int32)},
                {"n": 65536})
    out["dct served path V=257 n=65536 ms"] = smoke.path_ms(
        torch, lambda: scan.resident_in_set_mask(big, dvals[:3]), reps=REPS)
    rle, dct, dbp = [], [], []
    for _ in range(PAGES):
        lengths = np.full(3072, ROWS // 3072, np.int32)
        rle.append(entry("rle", {"values": rng.integers(0, 9, 3072).astype(np.uint32),
                                 "lengths": lengths}, {"n": ROWS}))
        dct.append(entry("dct", {"values": rng.integers(0, 9, 257).astype(np.uint32),
                                 "idx": rng.integers(0, 257, ROWS).astype(np.int32)}, {"n": ROWS}))
        raw = rng.integers(0, 256, ((ROWS - 1) * 20 + 7) // 8, dtype=np.uint8).tobytes()
        words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4")
        dbp.append(entry("dbp", {"words": words},
                         {"n": ROWS, "first": int(rng.integers(0, 2**40)), "width": 20}))
    out[f"rle batch path {PAGES} pages ms"] = smoke.path_ms(
        torch, lambda: scan.resident_in_set_masks(rle, codes_np), reps=REPS)
    out[f"dbp batch path {PAGES} pages ms"] = smoke.path_ms(
        torch, lambda: scan.resident_range_masks(dbp, np.uint64(2**30), np.uint64(2**41)),
        reps=REPS)
    try:
        scan.resident_in_set_masks(dct, codes_np)
        out[f"dct batch path {PAGES} pages ms"] = smoke.path_ms(
            torch, lambda: scan.resident_in_set_masks(dct, codes_np), reps=REPS)
    except ValueError:  # a tree that does not batch dct entries
        out[f"dct batch path {PAGES} pages ms"] = None
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
              + ", ".join(f"{k} {'none' if x is None else format(x, '.5f')}"
                          for k, x in got.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
