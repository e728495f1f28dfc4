#!/usr/bin/env python3
"""Time variants of dbp_decode and the compiled tier's fused program on one
NVIDIA GPU.

    python3 tools/sweep_compiled.py [--against OTHER.cu]

Builds tempo_tpu_torch/csrc/codec_kernels.cu as it is and in variants
(other tile sizes: the elements a block of both kernels), one nvcc each,
all started together, into tempo_tpu_torch/_build/sweep_compiled/. With
--against, another version of that source (the same C interface, say
the parent commit's) is built too and timed before and after the source
as it is (other, as it is, as it is, other), for an A/B in one call. The
inputs are made from a seed at the shape of the compiled tier's largest
dispatch in chip_smoke.py phase 8: U=64 row groups of 32,768 rows with an
rle column (4,096 runs a unit: a service a trace of 8 spans) and a dbp
column of durations (delta width 31), a one-hour window at 60 s steps
(slot_pad 64), and t_s either within 90 s of the window's start (a row
group's rows in one or two bins) or spread over 32 minutes (a row group
sorted by trace ID: rows in every bin); the same dispatch also with one
column or none, and with Q=4 lanes of windows one step apart. For each
case it prints the bins a row tile's in-window rows span. dbp_decode
also runs on one unit of 2**20 values. Each variant's results are held
against the plain versions first, then timed as chip_smoke.kernel_ms
times them (device time of a CUDA graph of 48 launches, every launch a
call makes included, a dispatch's zeroing of its counts too). For the
build as it is, torch.profiler splits each call's device time by kernel.
It prints one line a variant, the split, then the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = "constexpr int kTile = 2048;"
# (elements a tile, label): the first is the source as it is
VARIANTS = [(2048, "as it is"), (4096, "tile 4096")]
BASE_S = 1_700_000_000
RUNS = 4096  # rle runs a row group: a service a trace of 8 spans


def build(variants, against: str | None = None) -> dict:
    """{label: loaded library} of each variant (and of `against`)."""
    from tempo_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "tempo_tpu_torch", "csrc", "codec_kernels.cu")) as f:
        src = f.read()
    if TILE not in src:
        raise RuntimeError(f"codec_kernels.cu no longer holds {TILE!r}")
    out_dir = os.path.join(_build.BUILD_DIR, "sweep_compiled")
    os.makedirs(out_dir, exist_ok=True)
    sources = [(f"codec_{tile}", label, src.replace(TILE, f"constexpr int kTile = {tile};"))
               for tile, label in variants]
    if against:
        with open(against) as f:
            sources.append(("codec_against", "against", f.read()))
    procs = {}
    for name, label, text in sources:
        stem = os.path.join(out_dir, name)
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[label] = (stem + ".so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            if label == "as it is":
                raise RuntimeError(f"nvcc failed for {label}:\n{err}")
            print(f"{label}: does not build: "
                  f"{[x for x in err.splitlines() if 'error' in x][:2]}", flush=True)
            continue
        lib = ctypes.CDLL(so)
        for name in ("tt_dbp_tile", "tt_dbp_decode", "tt_compiled_metrics"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
        libs[label] = lib
    return libs


def inputs(torch, spread: bool, q: int, cols=("rle", "dbp"), seed: int = 0):
    """(sig, args) of one compiled dispatch on the card (see the module
    docstring), with the given columns of the two."""
    import numpy as np

    from tempo_tpu_torch.compiled import executor
    from tempo_tpu_torch.encoding.vtpu import lightweight as lw

    rng = np.random.default_rng(seed)
    n_units, n = 64, 1 << 15
    units = []
    for _ in range(n_units):
        cuts = np.sort(rng.choice(np.arange(1, n), RUNS - 1, replace=False))
        lengths = np.diff(np.concatenate([[0], cuts, [n]])).astype(np.int32)
        values = rng.integers(0, 12, RUNS).astype(np.uint32)
        dur = rng.integers(0, 1 << 30, n).astype(np.uint64)
        first, _a, widths, streams, _n = lw.dbp_parts(lw.dbp_encode(dur), "<u8", dur.shape)
        raw = bytes(streams[0])
        words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4")
        t_s = (BASE_S + rng.integers(0, 32 * 60 if spread else 90, n)).astype(np.uint32)
        units.append(executor._Unit(n, t_s, [
            ("rle", {"values": values, "lengths": lengths}, {"n": n}),
            ("dbp", {"words": words}, {"n": n, "first": int(first[0]),
                                       "width": int(widths[0])})], ()))
    keep = [i for i, c in enumerate(("rle", "dbp")) if c in cols]
    for un in units:
        un.cols = [un.cols[i] for i in keep]
    colsig = tuple((("set", "c0", True), ("range", "c1"))[i] for i in keep)
    t_s, valid, payloads, pads = executor._stack_group(units, colsig, n)
    codes = np.stack([np.stack([np.array([1, 3], np.uint32)] * n_units)] * q)
    bounds = np.array([(1 << 20, 1 << 29)] * q, np.uint64)
    tb = np.array([[BASE_S + 60 * k, 60] for k in range(q)], np.uint32)
    nb = np.array([60] * q, np.uint32)
    sig_cols = tuple((("rle", "set", True, 2), ("dbp", "range", False, pads[-1]))[i]
                     for i in keep)
    qargs = tuple((codes, bounds)[i] for i in keep)
    dev = torch.device("cuda")
    args = (executor._tensor(t_s, dev), executor._tensor(valid, dev),
            tuple(tuple(executor._tensor(a, dev) for a in p) for p in payloads),
            tuple(executor._tensor(a, dev) for a in qargs),
            executor._tensor(tb, dev), executor._tensor(nb, dev))
    return (sig_cols, n, 64, q), args


def long_unit(torch, seed: int = 1):
    """One unit of 2**20 durations (delta width 31) as dbp_decode takes it."""
    import numpy as np

    from tempo_tpu_torch.encoding.vtpu import lightweight as lw

    col = np.random.default_rng(seed).integers(0, 1 << 30, 1 << 20).astype(np.uint64)
    first, _a, widths, streams, _n = lw.dbp_parts(lw.dbp_encode(col), "<u8", col.shape)
    raw = bytes(streams[0])
    words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4")
    return (torch.from_numpy(words.view(np.int32).copy()).cuda()[None],
            torch.tensor([int(first[0])], dtype=torch.uint64).view(torch.int64).cuda(),
            torch.tensor([int(widths[0])], dtype=torch.int32).cuda(), 1 << 20)


def decode_call(torch, lib, words, first, width, n):
    """A launch closure of the variant's dbp_decode and its output."""
    from tempo_tpu_torch.ops import _build

    dec = torch.empty((words.shape[0], n), dtype=torch.int64, device=words.device)
    sums = torch.empty((words.shape[0], -(-n // lib.tt_dbp_tile())), dtype=torch.int64,
                       device=words.device)
    launched = ctypes.c_int32(0)

    def go():
        _build.check(lib.tt_dbp_decode(words.data_ptr(), words.shape[1], first.data_ptr(),
                                       width.data_ptr(), words.shape[0], n, sums.data_ptr(),
                                       dec.data_ptr(), ctypes.byref(launched),
                                       torch.cuda.current_stream().cuda_stream), "dbp_decode")
    return go, dec


def metrics_call(torch, lib, sig, args):
    """A launch closure of the variant's compiled dispatch (the zeroing of
    its counts included) and its counts; scratch is sized by the build as
    it is (variants take tiles as large or larger)."""
    from tempo_tpu_torch.compiled import program
    from tempo_tpu_torch.ops import _build

    t_s, valid, payloads, qargs, tb, nb = args
    sig_cols, n_pad, slot_pad, q = sig
    desc, scratch = program._describe(sig, t_s, payloads, qargs)
    counts = torch.zeros((q, slot_pad), dtype=torch.int64, device=t_s.device)
    launched = ctypes.c_int32(0)

    def go():
        counts.zero_()
        _build.check(lib.tt_compiled_metrics(desc.ctypes.data, len(sig_cols), t_s.data_ptr(),
                                             valid.data_ptr(), n_pad, t_s.shape[0], q,
                                             tb.data_ptr(), nb.data_ptr(), slot_pad,
                                             counts.data_ptr(), ctypes.byref(launched),
                                             torch.cuda.current_stream().cuda_stream),
                     "compiled_metrics")
    go.keep = (desc, scratch)
    return go, counts


def split_by_kernel(torch, fn, reps: int = 20) -> str:
    """Mean device time of each kernel a call of fn launches, from
    torch.profiler; 'not measured' when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        name = re.search(r"(\w+_kernel)", ev.key)
        if dev_us and name:
            parts.append(f"{name.group(1)} {dev_us / reps:.2f} us")
    return ", ".join(parts) or "not measured"


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another codec_kernels.cu to time beside it")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_compiled: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tempo_tpu_torch.compiled import program
    from tempo_tpu_torch.ops import pallas_kernels as pk

    libs = build(VARIANTS, opts.against)
    order = list(libs)
    if "against" in libs:  # other, as it is, as it is, other, then the tile variants
        order = ["against", "as it is", "as it is", "against",
                 *(k for k in libs if k not in ("against", "as it is"))]
    cases = {"spread Q=1": inputs(torch, True, 1), "spread Q=4": inputs(torch, True, 4),
             "one minute Q=1": inputs(torch, False, 1), "one minute Q=4": inputs(torch, False, 4),
             "spread Q=1 dbp only": inputs(torch, True, 1, ("dbp",)),
             "spread Q=1 rle only": inputs(torch, True, 1, ("rle",)),
             "spread Q=1 no column": inputs(torch, True, 1, ())}
    tile = libs["as it is"].tt_dbp_tile()
    for k, (s, a) in cases.items():
        spans = cs.tile_bin_spans(torch, tile, a[0], a[1], a[4], a[5], s[2])
        print(f"{k}: bins a row tile's in-window rows span (min, median, max) {spans}",
              flush=True)
    sig, args = cases["spread Q=1"]
    decodes = {"U=64 x 32768": (*args[2][1], sig[1]), "U=1 x 2^20": long_unit(torch)}
    want = {k: pk._dbp_decode_plain(*v) for k, v in decodes.items()}
    counts = {k: program._metrics_plain(s, *a) for k, (s, a) in cases.items()}
    splits = []
    for at, label in enumerate(order):
        lib = libs[label]
        split = label == "as it is" and label not in order[:at]
        cells = []
        for k, v in decodes.items():
            go, dec = decode_call(torch, lib, *v)
            go()
            if not torch.equal(dec, want[k]):
                raise RuntimeError(f"{label}: dbp_decode {k} != plain")
            cells.append(f"dbp_decode {k} {cs.kernel_ms(torch, [go]) * 1e3:.2f} us")
            if split:
                splits.append(f"dbp_decode {k}: {split_by_kernel(torch, go)}")
        for k, (s, a) in cases.items():
            go, out = metrics_call(torch, lib, s, a)
            go()
            if not torch.equal(out, counts[k]):
                raise RuntimeError(f"{label}: compiled dispatch {k} != plain")
            cells.append(f"dispatch {k} {cs.kernel_ms(torch, [go]) * 1e3:.2f} us")
            if split:
                splits.append(f"dispatch {k}: {split_by_kernel(torch, go)}")
        print(f"{label} (tile {lib.tt_dbp_tile()}) | " + " | ".join(cells), flush=True)
    for line in splits:
        print(f"split, as it is: {line}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
