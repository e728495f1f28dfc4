"""Column page codec: numpy array <-> compressed bytes.

Port of tempo_tpu/encoding/vtpu/codec.py without the device
page-encode arm (tempo_tpu/ops/encode.py, a later slice of the port):
lightweight pages are encoded on the host, which the reference's
contract makes byte-identical to its device encoder's pages.

Fills the role of the reference's compression pools
(tempodb/encoding/v2/pool.go:96-405 — gzip/lz4/snappy/zstd/s2 readers
and writers) for column pages. Codecs: none, zlib (stdlib fallback),
zstd, and zstd_shuffle — zstd over byte-transposed (blosc-style
shuffled) fixed-width elements, the default when the native C++
library (tempo_tpu_torch/native, linked against system libzstd) builds: the
shuffled planes compress several times faster AND smaller for numeric
columns. The native path fuses crc + shuffle + compression into one
GIL-released C call; when g++ or libzstd is unavailable the
zlib/stdlib path keeps the format readable (zstd/zstd_shuffle pages
then require the native lib).

Every page carries a crc32 in the index so torn reads/corruption are
detected at decode time (reference: v2 pages carry CRC,
tempodb/encoding/v2/page.go).
"""

from __future__ import annotations

import contextvars
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tempo_tpu_torch import native

CODECS = ("none", "zlib", "zstd", "zstd_shuffle", "rle", "dbp", "dct")
DEFAULT_CODEC = "zstd_shuffle"
# the lightweight, device-decodable tier (encoding/vtpu/lightweight.py):
# chosen per column at write time, evaluable without row expansion
LIGHTWEIGHT_CODECS = ("rle", "dbp", "dct")


class CorruptPage(Exception):
    pass


# ---------------------------------------------------------------------------
# shared codec thread pool — page encode/decode run off the GIL (ctypes),
# so a pool turns the per-column codec loop into parallel lanes (the
# reference keeps per-codec reader/writer pools for the same reason,
# tempodb/encoding/v2/pool.go:96-405). One lane per usable core, at most
# 8; a single-core process takes the serial path.
# ---------------------------------------------------------------------------

_pool_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None


def _threads() -> int:
    try:
        # affinity-aware: a cgroup-limited process only has its cpuset
        usable = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover
        usable = os.cpu_count() or 1
    return min(8, usable)


def pool() -> ThreadPoolExecutor | None:
    """The shared codec executor, or None in single-thread mode."""
    global _pool
    n = _threads()
    if n <= 1:
        return None
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=n, thread_name_prefix="codec")
    return _pool


def map_pages(fn, items: list):
    """Run fn over items on the codec pool (ordered results); serial when
    the pool is disabled or for trivial batches. The caller's context
    variables propagate into the pool threads."""
    p = pool()
    if p is None or len(items) <= 1:
        return [fn(it) for it in items]
    ctx = contextvars.copy_context()
    return list(p.map(lambda it: ctx.copy().run(fn, it), items))


def best_codec() -> str:
    """zstd + byte-shuffle when the native lib is up, else zlib.

    The shuffle transform (one C call fused with crc + zstd) makes the
    fixed-width columns both smaller and several times faster to
    compress — see native/codec.cc ttpu_col_encode."""
    return "zstd_shuffle" if native.lib() is not None else "zlib"


def resolve_codec(codec: str) -> str:
    return best_codec() if codec == "auto" else codec


def choose_codec(name: str, arr: np.ndarray, codec: str) -> str:
    """Per-column codec choice: the lightweight tier when the data's
    run/delta structure earns it, else the resolved default. The chosen
    codec lands in PageMeta, so readers never guess."""
    from tempo_tpu_torch.encoding.vtpu import lightweight

    return lightweight.choose_codec(name, arr, resolve_codec(codec))


def encode(arr: np.ndarray, codec: str) -> tuple[bytes, int]:
    """array -> (page bytes, crc32 of uncompressed payload)."""
    if codec in LIGHTWEIGHT_CODECS:
        from tempo_tpu_torch.encoding.vtpu import lightweight

        raw_crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        enc = {"rle": lightweight.rle_encode, "dbp": lightweight.dbp_encode,
               "dct": lightweight.dct_encode}[codec]
        return enc(arr), raw_crc
    nat = native.lib()
    if nat is not None:
        if codec not in nat.PAGE_CODECS:
            raise ValueError(f"unknown codec {codec!r}")
        # single fused C call: crc + (shuffle) + compress, no tobytes copy
        return nat.col_encode(arr, codec, 1)
    raw = np.ascontiguousarray(arr).tobytes()
    if codec == "none":
        return raw, zlib.crc32(raw)
    if codec == "zlib":
        return zlib.compress(raw, 1), zlib.crc32(raw)
    if codec in ("zstd", "zstd_shuffle"):
        raise ValueError(f"{codec} codec requires the native library (g++ + libzstd)")
    raise ValueError(f"unknown codec {codec!r}")


def decode(page: bytes, dtype: str, shape: tuple, codec: str, crc: int | None = None) -> np.ndarray:
    if codec in LIGHTWEIGHT_CODECS:
        from tempo_tpu_torch.encoding.vtpu import lightweight

        dec = {"rle": lightweight.rle_decode, "dbp": lightweight.dbp_decode,
               "dct": lightweight.dct_decode}[codec]
        arr = dec(page, dtype, shape)
        if crc is not None and zlib.crc32(np.ascontiguousarray(arr).tobytes()) != crc:
            raise CorruptPage(f"crc mismatch for page ({len(page)} bytes, codec={codec})")
        return arr
    nat = native.lib()
    if nat is not None:
        if codec not in nat.PAGE_CODECS:
            raise ValueError(f"unknown codec {codec!r}")
        try:
            arr, actual_crc = nat.col_decode(page, dtype, shape, codec)
        except native.NativeError as e:
            raise CorruptPage(str(e)) from e
        if crc is not None and actual_crc != crc:
            raise CorruptPage(f"crc mismatch for page ({len(page)} bytes, codec={codec})")
        return arr
    raw_len = int(np.prod(shape)) * np.dtype(dtype).itemsize if shape else np.dtype(dtype).itemsize
    if codec == "none":
        raw = page
    elif codec == "zlib":
        try:
            raw = zlib.decompress(page)
        except zlib.error as e:  # truncated (short read) or mangled stream
            raise CorruptPage(f"zlib decode failed ({len(page)} bytes): {e}") from e
    elif codec in ("zstd", "zstd_shuffle"):
        raise ValueError(f"{codec} codec requires the native library (g++ + libzstd)")
    else:
        raise ValueError(f"unknown codec {codec!r}")
    if len(raw) != raw_len:
        # a short read of an uncompressed page, or a truncated stream
        # that still decompressed — either way the page is not the data
        # that was written
        raise CorruptPage(
            f"page payload is {len(raw)} bytes, expected {raw_len} "
            f"(dtype={dtype}, shape={shape}, codec={codec})"
        )
    actual_crc = zlib.crc32(raw)
    if crc is not None and actual_crc != crc:
        raise CorruptPage(f"crc mismatch for page ({len(page)} bytes, codec={codec})")
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
