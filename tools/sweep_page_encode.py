#!/usr/bin/env python3
"""Time variants of the page-encode kernels on one NVIDIA GPU.

    python3 tools/sweep_page_encode.py

Builds tempo_tpu_torch/csrc/codec_kernels.cu as it is and in variants:
other tile sizes (rle_change_mask's lanes a tile, dbp_pack's values a
tile) and dbp_pack without the pad word every 32 zigzags, which spreads
the word build's shared-memory reads over the banks. Each variant is one
nvcc, all started together, into tempo_tpu_torch/_build/sweep/. The
script writes one 2**20-span block on the card (the data of chip_smoke.py
phase 6's block A) and records the pages of each page-encode batch. Then
it times each variant's two kernels at one row group's and at one
block's pages: device time as in chip_smoke.kernel_ms, each output held
against the plain versions first. It prints one line a variant, then the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD = "__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }"
# (lanes a tile, values a tile, pad word): the first is the source as it is
VARIANTS = [(2048, 2048, True), (4096, 2048, True), (2048, 1024, True), (2048, 4096, True),
            (2048, 2048, False)]


def build(variants) -> dict:
    from tempo_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "tempo_tpu_torch", "csrc", "codec_kernels.cu")) as f:
        src = f.read()
    for text in (PAD, "constexpr int kMaxTileRows = 2048;", "constexpr int kPackValues = 2048;"):
        if text not in src:
            raise RuntimeError(f"codec_kernels.cu no longer holds {text!r}")
    out_dir = os.path.join(_build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for words, values, pad in variants:
        v = src.replace("constexpr int kMaxTileRows = 2048;", f"constexpr int kMaxTileRows = {words};")
        v = v.replace("constexpr int kPackValues = 2048;", f"constexpr int kPackValues = {values};")
        if not pad:
            v = v.replace(PAD, "__device__ __forceinline__ int padded(int i) { return i; }")
        stem = os.path.join(out_dir, f"codec_{words}_{values}_{int(pad)}")
        with open(stem + ".cu", "w") as f:
            f.write(v)
        procs[words, values, pad] = (stem + ".so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        lib = ctypes.CDLL(so)
        for name in ("tt_rle_change_mask", "tt_dbp_pack"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
        libs[key] = lib
    return libs


def recorded_batches() -> list:
    """The plans of each page-encode batch of one 2**20-span block
    written on the card."""
    import chip_smoke as cs
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.common import BlockConfig
    from tempo_tpu_torch.encoding.vtpu.create import write_block
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.columnar import SpanBatch
    from tempo_tpu_torch.ops import encode as tenc

    block = SpanBatch.concat([
        cs.chain_parents(synth.make_batch(8192, 8, seed=100 + i,
                                          base_time_ns=(cs.BASE_S + 60 * i) * 10**9))
        for i in range(16)]).sorted_by_trace()
    batches = []
    real = tenc.encode_prepared

    def recording(plans, device, staging=None):
        batches.append([p for p in plans if p is not None])
        return real(plans, device, staging)

    tenc.encode_prepared = recording
    try:
        with tempfile.TemporaryDirectory() as d:
            write_block([block], "t", TypedBackend(LocalBackend(d)), BlockConfig(), device="cuda")
    finally:
        tenc.encode_prepared = real
    return batches


def time_variant(torch, lib, plans, words: int, values: int) -> tuple[float, float]:
    """Device time (us) of the variant's two launches over `plans`."""
    import numpy as np

    import chip_smoke as cs
    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import encode as tenc

    saved = tenc.RLE_TILE_WORDS, tenc.PACK_VALUES
    tenc.RLE_TILE_WORDS, tenc.PACK_VALUES = words, values
    try:
        batch = tenc.PageBatch(plans)
    finally:
        tenc.RLE_TILE_WORDS, tenc.PACK_VALUES = saved
    buf = np.zeros(batch.in_words, np.uint32)
    batch.fill(buf)
    host = torch.from_numpy(buf.view(np.int32))
    want = torch.zeros(batch.out_words, dtype=torch.int32)
    batch.launch(host, want)
    data = host.to("cuda")
    out = torch.zeros(batch.out_words, dtype=torch.int32, device="cuda")
    rle_t, rle_tiles, dbp_t, dbp_tiles = batch.tensors(data)
    stage = max(words + batch.lanes, 33 * batch.lanes)

    def stream() -> int:  # the current stream at each launch (a graph capture's own)
        return torch.cuda.current_stream().cuda_stream

    def rle():
        _build.check(lib.tt_rle_change_mask(data.data_ptr(), rle_t.data_ptr(), rle_tiles.data_ptr(),
                                            rle_tiles.numel(), stage, out.data_ptr(), stream()),
                     "rle_change_mask")

    def pack():
        _build.check(lib.tt_dbp_pack(data.data_ptr(), dbp_t.data_ptr(), dbp_tiles.data_ptr(),
                                     dbp_tiles.numel(), out.data_ptr(), stream()), "dbp_pack")

    rle()
    pack()
    torch.cuda.synchronize()
    if not torch.equal(out.cpu(), want):
        raise RuntimeError(f"variant {words}/{values}: kernels != plain")
    return cs.kernel_ms(torch, [rle]) * 1e3, cs.kernel_ms(torch, [pack]) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_page_encode: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tempo_tpu_torch.ops import encode as tenc

    libs = build(VARIANTS)
    batches = recorded_batches()
    shapes = {"row group": batches[0], "block": [p for b in batches for p in b]}
    bounds = {}
    for label, plans in shapes.items():
        b = tenc.PageBatch(plans)
        rle_bytes = sum(int(r[1] * r[2]) * 4 + -(-int(r[1] - 1) // 32) * 4 for r in b.rle_table)
        dbp_bytes = sum(int(r[2]) * 4 * (2 if r[1] >= 0 else 1)
                        + -(-int((r[2] - 1 if r[3] else r[2]) * r[4]) // 32) * 4 for r in b.dbp_table)
        bounds[label] = (cs.bound_ms(rle_bytes + b.rle_table.nbytes, 0)[0] * 1e3,
                         cs.bound_ms(dbp_bytes + b.dbp_table.nbytes, 0)[0] * 1e3)
    for (words, values, pad), lib in libs.items():
        cells = []
        for label, plans in shapes.items():
            rle_us, pack_us = time_variant(torch, lib, plans, words, values)
            rb, pb = bounds[label]
            cells.append(f"{label}: rle_change_mask {rle_us:.2f} us ({rb / rle_us:.0%} of "
                         f"{rb:.2f}), dbp_pack {pack_us:.2f} us ({pb / pack_us:.0%} of {pb:.2f})")
        print(f"lanes a tile {words}, values a tile {values}, pad word "
              f"{'on' if pad else 'off'} | " + " | ".join(cells), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
