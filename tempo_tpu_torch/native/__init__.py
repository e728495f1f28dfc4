"""ctypes bindings for the native C++ codec library.

Port of tempo_tpu/native/__init__.py; codec.cc is the reference's source
copied as is, and the binding covers what the port calls: crc32,
zstd/zlib, the fused col_encode/col_decode and the 192-bit k-way merge.
g++ compiles it on first use into the gitignored
tempo_tpu_torch/_build/ (keyed by source and flags), never at import; ctypes
loads it. The C calls hold no Python state and release the GIL, so page
encode/decode and k-way merge planning run concurrently with device
work.

`lib()` returns the loaded binding or None when no compiler or zlib is
available; callers (encoding/vtpu/codec.py) then take the stdlib paths,
as the reference does. The build tries libzstd first: when it links,
codec "auto" resolves to zstd_shuffle, else the library is absent and
"auto" resolves to zlib. Blocks record the codec of every page.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "codec.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

_lock = threading.Lock()
_lib = None
_tried = False


class NativeError(Exception):
    pass


ERR = {-1: "destination too small", -2: "corrupt input", -3: "bad argument"}


def _check(r: int) -> int:
    if r < 0:
        raise NativeError(ERR.get(r, f"native error {r}"))
    return r


# Generic target flags: the .so carries no host-specific instructions, so a
# build made on one machine loads safely on any machine of the same
# architecture that later sees the same checkout.
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"_codec_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"  # pid-suffixed: concurrent first-use
    # builds from sibling processes must not interleave into one file
    base = ["g++", *_FLAGS, _SRC, "-o", tmp, "-lz"]
    # images without the libzstd dev symlink still carry the runtime;
    # -l:libzstd.so.1 links it directly (codec.cc declares the ABI)
    for zstd_flag in ("-lzstd", "-l:libzstd.so.1"):
        try:
            subprocess.run(base + [zstd_flag], check=True,
                           capture_output=True, timeout=120)
            break
        except Exception:
            continue
    else:
        return so if os.path.exists(so) else None  # a sibling may have won
    os.replace(tmp, so)
    # drop stale builds
    for f in os.listdir(BUILD_DIR):
        if f.startswith("_codec_") and f.endswith(".so") and f != os.path.basename(so):
            try:
                os.unlink(os.path.join(BUILD_DIR, f))
            except OSError:
                pass
    return so


class _Binding:
    def __init__(self, so_path: str):
        self.path = so_path
        self._tls = threading.local()
        lib = ctypes.CDLL(so_path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._crc32 = lib.ttpu_crc32
        self._crc32.restype = ctypes.c_uint32
        self._crc32.argtypes = [u8p, ctypes.c_size_t]
        self._zstd_bound = lib.ttpu_zstd_bound
        self._zstd_bound.restype = ctypes.c_size_t
        self._zstd_bound.argtypes = [ctypes.c_size_t]
        for name in ("zstd_compress", "zlib_compress"):
            fn = getattr(lib, f"ttpu_{name}")
            fn.restype = ctypes.c_longlong
            fn.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, ctypes.c_int]
            setattr(self, f"_{name}", fn)
        for name in ("zstd_decompress", "zlib_decompress"):
            fn = getattr(lib, f"ttpu_{name}")
            fn.restype = ctypes.c_longlong
            fn.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t]
            setattr(self, f"_{name}", fn)
        self._zlib_bound = lib.ttpu_zlib_bound
        self._zlib_bound.restype = ctypes.c_size_t
        self._zlib_bound.argtypes = [ctypes.c_size_t]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        self._cenc = lib.ttpu_col_encode
        self._cenc.restype = ctypes.c_longlong
        self._cenc.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t,
                               ctypes.c_int, ctypes.c_int, u8p,
                               ctypes.c_size_t, u32p]
        self._cdec = lib.ttpu_col_decode
        self._cdec.restype = ctypes.c_longlong
        self._cdec.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int,
                               ctypes.c_size_t, u8p, ctypes.c_size_t, u32p]
        u64pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))
        self._kway3 = lib.ttpu_kway_merge_u192
        self._kway3.restype = ctypes.c_longlong
        self._kway3.argtypes = [u64pp, u64pp, u64pp,
                                ctypes.POINTER(ctypes.c_size_t),
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_uint32),
                                ctypes.POINTER(ctypes.c_uint32),
                                u8p, ctypes.c_size_t]
        self._u8p = u8p

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _buf(b) -> tuple:
        arr = np.frombuffer(b, np.uint8) if not isinstance(b, np.ndarray) else b
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size

    def crc32(self, data: bytes) -> int:
        p, n = self._buf(data)
        return int(self._crc32(p, n))

    def compress(self, data: bytes, codec: str = "zstd", level: int = 3) -> bytes:
        p, n = self._buf(data)
        if codec == "zstd":
            cap = int(self._zstd_bound(n))
            out = np.empty(cap, np.uint8)
            r = _check(self._zstd_compress(p, n, out.ctypes.data_as(self._u8p), cap, level))
        elif codec == "zlib":
            cap = int(self._zlib_bound(n))
            out = np.empty(cap, np.uint8)
            r = _check(self._zlib_compress(p, n, out.ctypes.data_as(self._u8p), cap, level))
        else:
            raise ValueError(codec)
        return out[:r].tobytes()

    def decompress(self, data: bytes, raw_len: int, codec: str = "zstd") -> bytes:
        p, n = self._buf(data)
        out = np.empty(raw_len, np.uint8)
        fn = self._zstd_decompress if codec == "zstd" else self._zlib_decompress
        r = _check(fn(p, n, out.ctypes.data_as(self._u8p), raw_len))
        return out[:r].tobytes()

    PAGE_CODECS = {"none": 0, "zlib": 1, "zstd": 2, "zstd_shuffle": 3}

    def _scratch(self, cap: int) -> np.ndarray:
        """Per-thread reusable output buffer (page encodes run hot: a
        fresh np.empty per page costs allocation + page faults)."""
        buf = getattr(self._tls, "scratch", None)
        if buf is None or buf.size < cap:
            buf = np.empty(max(cap, 1 << 20), np.uint8)
            self._tls.scratch = buf
        return buf

    def col_encode(self, arr: np.ndarray, codec: str, level: int = 1) -> tuple[bytes, int]:
        """Fixed-width column -> (page bytes, crc of raw). ONE C call:
        crc + byte-shuffle + compression, no intermediate Python copies."""
        arr = np.ascontiguousarray(arr)
        n = arr.nbytes
        width = arr.dtype.itemsize
        cap = int(self._zstd_bound(n)) + 64
        out = self._scratch(cap)
        crc = ctypes.c_uint32(0)
        src = arr.view(np.uint8).reshape(-1) if n else np.empty(0, np.uint8)
        r = _check(self._cenc(src.ctypes.data_as(self._u8p), n, width,
                              self.PAGE_CODECS[codec], level,
                              out.ctypes.data_as(self._u8p), out.size,
                              ctypes.byref(crc)))
        return out[:r].tobytes(), int(crc.value)

    def col_decode(self, page: bytes, dtype: str, shape: tuple, codec: str) -> tuple[np.ndarray, int]:
        """Page bytes -> (array, crc of raw); decompress + unshuffle +
        crc in one C call, writing straight into the result buffer."""
        dt = np.dtype(dtype)
        out = np.empty(shape, dt)
        n = out.nbytes
        p, plen = self._buf(page)
        crc = ctypes.c_uint32(0)
        dst = out.view(np.uint8).reshape(-1) if n else np.empty(0, np.uint8)
        _check(self._cdec(p, plen, self.PAGE_CODECS[codec], dt.itemsize,
                          dst.ctypes.data_as(self._u8p), n, ctypes.byref(crc)))
        return out, int(crc.value)

    def kway_merge_u192(self, keys_hi: list[np.ndarray], keys_mid: list[np.ndarray],
                        keys_lo: list[np.ndarray]):
        """Merge k sorted u192 streams (traceID hi/lo + spanID lanes) ->
        (stream_idx, row_idx, dup_mask). Streams must each be sorted by
        (hi, mid, lo); dup flags exact 192-bit repeats of the previous key."""
        k = len(keys_hi)
        his = [np.ascontiguousarray(h, np.uint64) for h in keys_hi]
        mids = [np.ascontiguousarray(m, np.uint64) for m in keys_mid]
        los = [np.ascontiguousarray(l, np.uint64) for l in keys_lo]
        lens = (ctypes.c_size_t * k)(*[h.size for h in his])
        u64p = ctypes.POINTER(ctypes.c_uint64)
        hp = (u64p * k)(*[h.ctypes.data_as(u64p) for h in his])
        mp = (u64p * k)(*[m.ctypes.data_as(u64p) for m in mids])
        lp = (u64p * k)(*[l.ctypes.data_as(u64p) for l in los])
        total = int(sum(h.size for h in his))
        os_ = np.empty(total, np.uint32)
        orow = np.empty(total, np.uint32)
        odup = np.empty(total, np.uint8)
        r = _check(self._kway3(hp, mp, lp, lens, k,
                               os_.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                               orow.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                               odup.ctypes.data_as(self._u8p), total))
        return os_[:r], orow[:r], odup[:r].astype(bool)


def lib() -> _Binding | None:
    """The process-wide binding, building the .so on first use."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            so = _build()
            if so is not None:
                try:
                    _lib = _Binding(so)
                except OSError:
                    _lib = None
            _tried = True
    return _lib
