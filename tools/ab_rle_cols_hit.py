#!/usr/bin/env python3
"""Time rle_cols_hit, kernel and wrapper, of this tree against another
tree's on one NVIDIA GPU, in one call.

    python3 tools/ab_rle_cols_hit.py --against DIR

DIR is another checkout of the repo (say the parent commit's, from `git
archive` unpacked into a directory that .gitignore lists). This tree first
writes a block of 2**20 spans on the card as chip_smoke.py phase 6 writes
block A (16 batches of synth.make_batch, 8,192 traces of 8 spans, a
minute apart, sorted by trace) and takes chip_smoke.py phase 17 (e)'s four
timed shapes from it (rle_timed_shapes: the first row group's service
runs at Q = 1 and Q = 8, its first 16 row groups in one call, the first
row group expanded to a run a row at run_pad 32,768). Each tree then runs
in a process of its own, in the order DIR, this tree, this tree, DIR: it
builds its kernels and, at each shape,
- holds its rle_hit_lanes on the card against the plain version on the
  CPU;
- times its C entry point tt_rle_cols_hit as chip_smoke.kernel_ms times a
  kernel (every launch a call makes; a tree whose entry point takes a
  run-starts scratch gets one allocated before);
- times its wrapper call as chip_smoke.path_ms times one;
and it times its resident_rle_scan (one launch a page, the machinery the
redesign shares) on the first row group's runs, n = 32,768, four codes.
Prints a line a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import uuid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def prepare(path: str) -> None:
    """Write block A on the card and pickle its timed shapes to `path`."""
    sys.path.insert(0, ROOT)
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.common import BlockConfig
    from tempo_tpu_torch.encoding.vtpu.create import write_block
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.columnar import SpanBatch

    smoke = _smoke()
    batches = [smoke.chain_parents(synth.make_batch(
        8192, 8, seed=100 + i, base_time_ns=(smoke.BASE_S + 60 * i) * 10**9)) for i in range(16)]
    a = SpanBatch.concat(batches).sorted_by_trace()
    with tempfile.TemporaryDirectory(prefix="ab_rle_") as tmp:
        write_block([a], "smoke", TypedBackend(LocalBackend(tmp)), BlockConfig(),
                    block_id=str(uuid.uuid4()), device="cuda")
        shapes = smoke.rle_timed_shapes(tmp)
    with open(path, "wb") as f:
        pickle.dump(shapes, f)


def child(tree: str, path: str) -> None:
    """Time `tree`'s rle_cols_hit and resident_rle_scan at the pickled
    shapes; print {"label": ms} as JSON."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from tempo_tpu_torch.ops import _build, scan
    from tempo_tpu_torch.ops import pallas_kernels as pk

    smoke = _smoke()
    dev = torch.device("cuda")
    lib = _build.lib()
    with_starts = len(_build._SIGNATURES["tt_rle_cols_hit"]) == 14
    with open(path, "rb") as f:
        shapes = pickle.load(f)

    def bits(x, to=None):
        if x is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(x.view(np.int32) if x.dtype == np.uint32 else x))
        return t if to is None else t.to(to)

    out = {}
    for key, _text, values, lengths, codes, live, hit, n in shapes:
        host = [bits(x) for x in (values, lengths, codes, live, hit)]
        dv, dl, dc, dlive, dhit = (None if x is None else x.to(dev) for x in host)
        want = pk._rle_hit_plain(*host[:3], host[3], host[4], n)
        got = pk.rle_hit_lanes(dv, dl, dc, n, live=dlive, hit=dhit)
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"{tree}: rle_cols_hit {key}: kernel != plain")
        U, C, rp = values.shape
        q, k = codes.shape[1], codes.shape[3]
        res = torch.empty((U, q, n), dtype=torch.bool, device=dev)
        starts = torch.empty((U, C, rp), dtype=torch.int64, device=dev)

        def go(dv=dv, dl=dl, dc=dc, dlive=dlive, dhit=dhit, res=res, starts=starts, U=U, C=C,
               rp=rp, q=q, k=k, n=n):
            args = [dv.data_ptr(), None if dl is None else dl.data_ptr(), U, C, rp,
                    dc.data_ptr(), k, q, None if dlive is None else dlive.data_ptr(),
                    None if dhit is None else dhit.data_ptr(), n]
            if with_starts:
                args.append(starts.data_ptr())
            _build.check(lib.tt_rle_cols_hit(*args, res.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream),
                         "rle_cols_hit")

        go()
        if not torch.equal(res.cpu(), want):
            raise SystemExit(f"{tree}: tt_rle_cols_hit {key}: != plain")
        out[f"{key} kernel"] = smoke.kernel_ms(torch, [go])
        out[f"{key} path"] = smoke.path_ms(
            torch, lambda: pk.rle_hit_lanes(dv, dl, dc, n, live=dlive, hit=dhit))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(1000):
            pk.rle_hit_lanes(dv, dl, dc, n, live=dlive, hit=dhit)
        out[f"{key} host us"] = (time.perf_counter() - t1) * 1e3
        torch.cuda.synchronize()
    # resident_rle_scan on the first unit's runs (its padding dropped)
    _key, _text, values, lengths, codes, _live, _hit, _n = shapes[0]
    real = int(np.count_nonzero(lengths[0, 0]))
    rv, rl = bits(values[0, 0, :real], dev), bits(lengths[0, 0, :real], dev)
    rc = codes[0, 0, 0][:4].copy()
    rc[2:] = values[0, 0, 2:4]
    want = scan.resident_rle_scan(rv.cpu(), rl.cpu(), 32768, rc)
    if not torch.equal(scan.resident_rle_scan(rv, rl, 32768, rc).cpu(), want):
        raise SystemExit(f"{tree}: resident_rle_scan: kernel != plain")
    out["resident_rle_scan kernel"] = smoke.kernel_ms(
        torch, [lambda: scan.resident_rle_scan(rv, rl, 32768, rc)])
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, help="another checkout of the repo")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.shapes)
        return 0
    other = os.path.abspath(args.against)
    with tempfile.TemporaryDirectory(prefix="ab_rle_shapes_") as tmp:
        path = os.path.join(tmp, "shapes.pkl")
        t0 = time.perf_counter()
        prepare(path)
        print(f"block A written on the card and its shapes taken: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for tree in (other, ROOT, ROOT, other):
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--against", other,
                                  "--child", tree, "--shapes", path], cwd=tree,
                                 capture_output=True, text=True)
            if run.returncode != 0:
                print(run.stdout + run.stderr[-3000:], file=sys.stderr)
                return 1
            ms = json.loads(run.stdout.strip().splitlines()[-1])
            print(f"{'this tree' if tree == ROOT else other}: "
                  + ", ".join(f"{k} {v:.5f}" for k, v in ms.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
