"""Build and load the port's CUDA kernels (csrc/kernels.cu: the three
Pallas kernels; csrc/codec_kernels.cu: the codec's page encode, the
compiled query tier, the device tier's resident scans and the fused
run-length decode + in-set scan of the mesh and batched searches;
csrc/graph_sketch_kernels.cu: the HLL and count-min updates and the
critical path's pointer doubling; csrc/tail_kernels.cu: the ingest
tail's standing fold and live-tail search mask).

nvcc compiles each source into a shared library with a plain C
interface, tagged with a hash of the source, under tempo_tpu_torch/_build/
(listed in .gitignore); the sources build in parallel, one nvcc each,
and ctypes loads them. The build runs at first use, never at import, so
the CPU tests import every module without nvcc. A failed build raises:
there is no fallback. ptxas reports each kernel's registers, static
shared memory and spills (`-Xptxas -v`); the report is kept beside each
library and read by `ptxas_report()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("kernels.cu", "codec_kernels.cu", "graph_sketch_kernels.cu", "tail_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "tt_seg_bincount": [_P, _P, _I64, _I32, _P, _P],
    "tt_in_set_scan": [ctypes.POINTER(_P), ctypes.POINTER(_I32), ctypes.c_uint32, _I32, _P,
                       _I32, _I64, _I64, _P, _P],
    "tt_u64_range_scan": [_P, _P, _U64, _U64, _I64, _I64, _P, _P],
    "tt_rle_change_mask": [_P, _P, _P, _I64, _I32, _P, _P],
    "tt_dbp_pack": [_P, _P, _P, _I64, _P, _P],
    "tt_dbp_tile": [],
    "tt_dbp_decode": [_P, _I64, _P, _P, _I32, _I64, _P, _P, ctypes.POINTER(_I32), _P],
    "tt_compiled_metrics": [_P, _I32, _P, _P, _I64, _I32, _I32, _P, _P, _I32, _P,
                            ctypes.POINTER(_I32), _P],
    "tt_resident_rle_scan": [_P, _P, _I32, _P, _I32, ctypes.c_uint32, ctypes.c_uint32, _P,
                             ctypes.POINTER(_I32), _P],
    "tt_resident_rle_scan_batch": [_P, _I32, _I64, _P, _I32, _P, _I32, ctypes.c_uint32,
                                   ctypes.c_uint32, _P, ctypes.POINTER(_I32), _P],
    "tt_resident_scan_codes": [],
    "tt_resident_dct_scan": [_P, _P, _I32, _P, _I32, ctypes.c_uint32, ctypes.c_uint32, _P,
                             ctypes.POINTER(_I32), _P],
    "tt_resident_dct_scan_batch": [_P, _I32, _I64, _I64, _P, _I32, _P, _I32, ctypes.c_uint32,
                                   ctypes.c_uint32, _P, ctypes.POINTER(_I32), _P],
    "tt_resident_dbp_scan": [_P, _U64, _U64, _P, ctypes.POINTER(_I32), _P],
    "tt_resident_dbp_scan_batch": [_P, _I32, _I64, _U64, _U64, _P, ctypes.POINTER(_I32), _P],
    "tt_hll_update": [_P, _I32, _I32, _P, _I64, _I32, _P, _P],
    "tt_cm_update": [_P, _I32, _I32, _P, _P, _I64, _I32, _I32, ctypes.c_uint32, _P, _P],
    "tt_root_path_sums": [_P, _P, _I32, _I32, _P, _P, _P, _P, ctypes.POINTER(_I32), _P],
    "tt_root_path_sums_segmented": [_P, _P, _P, _I32, _I32, _I32, _P, _P, _P,
                                    ctypes.POINTER(_I32), _P],
    # a pointer to the host descriptor, then the stream
    "tt_tail_fold": [_P, _P],
    "tt_tail_scan": [_P, _P],
    "tt_rle_cols_hit": [_P, _P, _I32, _I32, _I32, _P, _I32, _I32, _P, _P, _I64, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: str) -> tuple[str, str]:
    path = os.path.join(_PKG, "csrc", src)
    with open(path, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(src)[0]
    return path, os.path.join(BUILD_DIR, f"libtempo_{stem}_{tag}.so")


def build() -> list[str]:
    """Compile every source that has no library for its current text,
    one nvcc each, all started together; returns the library paths."""
    targets = [_target(src) for src in SOURCES]
    todo = [(src, so) for src, so in targets if not os.path.exists(so)]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = [(so, f"{so}.{os.getpid()}.tmp",
                  subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", f"{so}.{os.getpid()}.tmp", src],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
                 for src, so in todo]
        failed = []
        for so, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(so)}: nvcc failed ({proc.returncode}):\n{err}")
                continue
            with open(f"{so}.ptxas.txt", "w") as f:
                f.write(err)
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    return [so for _, so in targets]


def _kernel_name(mangled: str) -> str:
    """`_ZN<len><namespace><len><name>[ILb1ELb0EE | ILi256EE | IjLb1ELb0EE]...`
    -> `name`, `name<1,0>`, `name<256>` or `name<u32,1,0>` (j: unsigned int,
    y: unsigned long long)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    tmpl = re.match(r"I((?:[jy]|L[bi]\d+E)+)E", rest[m.end() + int(m.group(1)):])
    if not tmpl:
        return name
    args = [{"j": "u32", "y": "u64"}.get(a, a[2:-1])
            for a in re.findall(r"[jy]|L[bi]\d+E", tmpl.group(1))]
    return f"{name}<{','.join(args)}>"


def ptxas_report() -> dict:
    """{kernel: {"registers", "smem_static", "spill_stores", "spill_loads"}}
    from the ptxas report of the current build, by kernel name (template
    arguments written as <0,1> or <256>)."""
    report: dict = {}
    cur = None
    lines = []
    for so in build():
        with open(f"{so}.ptxas.txt") as f:
            lines += f.readlines()
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = report.setdefault(_kernel_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_static"] = int(sm.group(1)) if sm else 0
    return report


class _Libs:
    """The loaded kernel libraries; an entry point is looked up by name
    in each in turn."""

    def __init__(self, handles: list):
        for name, argtypes in _SIGNATURES.items():
            fn = next(getattr(h, name) for h in handles if hasattr(h, name))
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def lib() -> _Libs:
    """The loaded kernel libraries, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _Libs([ctypes.CDLL(so) for so in build()])
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")
