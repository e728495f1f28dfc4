"""Vectorized hashing over 128-bit trace IDs, in PyTorch.

Port of tempo_tpu/ops/hashing.py (fnv1a_32, fmix32, hash_streams, and
the host numpy mirrors np_fnv1a_32, np_fmix32 and trace_id_to_limbs that
the block read path uses, and the ring tokens token_for / np_token_for_ids
that place traces on ingesters): the same fnv1a over the 16 big-endian bytes
of four uint32 limbs and the same murmur3 finalizer, bit for bit.

Torch's uint32 covers few operators, so every uint32 value here rides
in an int64 tensor and is masked with `& 0xFFFFFFFF` after each step
that can leave 32 bits. The FNV prime is below 2**25, so `h * prime`
stays below 2**57 and is exact in int64. The finalizer's constants are
full 32-bit values, whose products would overflow signed int64; `_mul32`
splits the constant into 16-bit halves so that every intermediate stays
below 2**49 and the wrap mod 2**32 is exact on every device.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
FNV1A_OFFSET32 = 2166136261
FNV1A_PRIME32 = 16777619


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h in [0, 2**32) held in int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK32


def fnv1a_32(limbs: torch.Tensor) -> torch.Tensor:
    """fnv1a-32 over the big-endian bytes of uint32 limbs.

    limbs: (..., L) integer tensor of uint32 values. Returns (...,) int64
    holding uint32 values.
    """
    limbs = limbs.to(torch.int64) & MASK32
    h = torch.full(limbs.shape[:-1], FNV1A_OFFSET32, dtype=torch.int64,
                   device=limbs.device)
    for i in range(limbs.shape[-1]):
        w = limbs[..., i]
        for shift in (24, 16, 8, 0):
            byte = (w >> shift) & 0xFF
            h = ((h ^ byte) * FNV1A_PRIME32) & MASK32
    return h


def fmix32(h: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3 finalizer of uint32 values (int64-held), seeded by xor."""
    h = (h.to(torch.int64) & MASK32) ^ (seed & MASK32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_streams(limbs: torch.Tensor, n: int, seed: int = 0) -> torch.Tensor:
    """n independent uint32 hash streams: (..., L) -> (n, ...) int64.
    Stream i is fmix32(fnv1a(key), seed*31 + i)."""
    base = fnv1a_32(limbs)
    return torch.stack([fmix32(base, seed * 31 + i) for i in range(n)], dim=0)


# numpy mirrors (host side: bloom shard lookup on the block read path)


def np_fnv1a_32(limbs: np.ndarray) -> np.ndarray:
    limbs = limbs.astype(np.uint32)
    h = np.full(limbs.shape[:-1], FNV1A_OFFSET32, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(limbs.shape[-1]):
            w = limbs[..., i]
            for shift in (24, 16, 8, 0):
                byte = ((w >> np.uint32(shift)) & np.uint32(0xFF)).astype(np.uint32)
                h = (h ^ byte) * np.uint32(FNV1A_PRIME32)
    return h


def np_fmix32(h: np.ndarray, seed: int = 0) -> np.ndarray:
    h = h.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h


def trace_id_to_limbs(trace_id: bytes) -> np.ndarray:
    """16-byte trace ID -> (4,) uint32 big-endian limbs."""
    tid = trace_id.rjust(16, b"\x00")[-16:]
    return np.frombuffer(tid, dtype=">u4").astype(np.uint32)


def limbs_to_trace_id(limbs: np.ndarray) -> bytes:
    return np.asarray(limbs, dtype=np.uint32).astype(">u4").tobytes()


def token_for(tenant: str, trace_id: bytes) -> int:
    """Ring token for (tenant, traceID): fnv1a over the tenant bytes then
    the ID bytes, finalized with fmix32 (the reference's ring token)."""
    h = FNV1A_OFFSET32
    for b in tenant.encode("utf-8") + trace_id:
        h = ((h ^ b) * FNV1A_PRIME32) & MASK32
    return int(np_fmix32(np.uint32(h)))


def np_token_for_ids(tenant: str, limbs: np.ndarray) -> np.ndarray:
    """Vectorized token_for over (N, 4) trace-ID limbs. Must equal
    token_for: the distributor places traces with this and the querier
    reads replicas with token_for."""
    h0 = FNV1A_OFFSET32
    for b in tenant.encode("utf-8"):
        h0 = ((h0 ^ b) * FNV1A_PRIME32) & MASK32
    limbs = limbs.astype(np.uint32)
    h = np.full(limbs.shape[:-1], h0, dtype=np.uint32)
    prime = np.uint32(FNV1A_PRIME32)
    with np.errstate(over="ignore"):
        for i in range(limbs.shape[-1]):
            w = limbs[..., i]
            for shift in (24, 16, 8, 0):
                byte = (w >> np.uint32(shift)) & np.uint32(0xFF)
                h = (h ^ byte) * prime
    return np_fmix32(h)
