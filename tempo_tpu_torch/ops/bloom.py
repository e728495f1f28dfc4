"""Sharded bloom filters, in PyTorch.

Port of tempo_tpu/ops/bloom.py (BloomPlan, plan, build, test,
test_one_shard, psum_merge, shard bytes, and the host numpy
shard_for_ids and np_test_one_shard that find-by-ID uses). Bit positions use double hashing
pos_i = (h1 + i*h2) mod bits_per_shard with h2 forced odd; the sum
wraps mod 2**32 BEFORE the `%`, exactly as the uint32 JAX arithmetic
does. Words hold 32 bits LSB first. uint32 values ride in int64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tempo_tpu_torch.ops import hashing
from tempo_tpu_torch.ops.hashing import MASK32

_WORD_BITS = 32


@dataclass(frozen=True)
class BloomPlan:
    """Geometry of a sharded bloom filter."""

    n_shards: int
    bits_per_shard: int  # multiple of 32
    k: int  # number of probe bits per item

    @property
    def total_bits(self) -> int:
        return self.n_shards * self.bits_per_shard

    @property
    def words_per_shard(self) -> int:
        return self.bits_per_shard // _WORD_BITS

    @property
    def size_bytes(self) -> int:
        return self.total_bits // 8


def plan(n_items: int, fp_rate: float, shard_size_bytes: int = 100 * 1024) -> BloomPlan:
    """Size a sharded bloom for n_items at fp_rate (m = -n ln p / ln2^2,
    k = (m/n) ln 2, shards of shard_size_bytes)."""
    n_items = max(1, n_items)
    fp_rate = min(max(fp_rate, 1e-9), 0.5)
    m = math.ceil(-n_items * math.log(fp_rate) / (math.log(2) ** 2))
    n_shards = max(1, math.ceil(m / 8 / shard_size_bytes))
    per_shard_items = math.ceil(n_items / n_shards)
    m_shard = math.ceil(-per_shard_items * math.log(fp_rate) / (math.log(2) ** 2))
    m_shard = max(_WORD_BITS, ((m_shard + _WORD_BITS - 1) // _WORD_BITS) * _WORD_BITS)
    k = min(16, max(1, round(m_shard / per_shard_items * math.log(2))))
    p = BloomPlan(n_shards=n_shards, bits_per_shard=m_shard, k=k)
    if p.total_bits >= 2**32:
        raise ValueError(f"bloom filter too large: {p.total_bits} bits")
    return p


_SEED_H1 = 0x9E3779B9
_SEED_H2 = 0x85EBCA6B


def _local_positions(token: torch.Tensor, p: BloomPlan) -> torch.Tensor:
    """Shard-local probe bit positions (k, N) from fnv tokens."""
    h1 = hashing.fmix32(token, seed=_SEED_H1)
    h2 = hashing.fmix32(token, seed=_SEED_H2) | 1
    i = torch.arange(p.k, dtype=torch.int64, device=token.device)[:, None]
    # i < 16 and h2 < 2**32: the product is exact in int64
    return ((h1[None, :] + i * h2[None, :]) & MASK32) % p.bits_per_shard


def _probe_bits(limbs: torch.Tensor, p: BloomPlan):
    """shard (N,), and k global bit positions (k, N) for each key."""
    token = hashing.fnv1a_32(limbs)
    shard = token % p.n_shards
    pos = _local_positions(token, p)
    # plan() keeps total_bits below 2**32, so no wrap here
    return shard, shard[None, :] * p.bits_per_shard + pos


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(W*32,) 0/1 -> (W,) int64 uint32 words, bit j of a word = bits[32w+j]."""
    shifts = torch.arange(_WORD_BITS, dtype=torch.int64, device=bits.device)
    return (bits.view(-1, _WORD_BITS).to(torch.int64) << shifts).sum(dim=1)


def build(limbs: torch.Tensor, p: BloomPlan, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Build the filter for a batch of IDs -> (n_shards, words_per_shard)
    int64 holding uint32 words. Invalid lanes go to one trash bit past
    the end, which is cut off before packing (JAX: mode="drop")."""
    _, global_bit = _probe_bits(limbs, p)
    if valid is not None:
        global_bit = torch.where(valid[None, :], global_bit, p.total_bits)
    bits = torch.zeros(p.total_bits + 1, dtype=torch.uint8, device=limbs.device)
    bits[global_bit.reshape(-1)] = 1
    return _pack_words(bits[: p.total_bits]).view(p.n_shards, p.words_per_shard)


def _all_probed(words_flat: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    probed = (words_flat[bit // _WORD_BITS] >> (bit % _WORD_BITS)) & 1
    return (probed == 1).all(dim=0)


def test(words: torch.Tensor, limbs: torch.Tensor, p: BloomPlan) -> torch.Tensor:
    """Membership test for a batch of IDs -> (N,) bool (no false negatives)."""
    _, global_bit = _probe_bits(limbs, p)
    return _all_probed(words.reshape(-1).to(torch.int64) & MASK32, global_bit)


def test_one_shard(shard_words: torch.Tensor, limbs: torch.Tensor, p: BloomPlan) -> torch.Tensor:
    """Test IDs against one fetched shard (shard_words: (words_per_shard,));
    bit positions are shard-local."""
    pos = _local_positions(hashing.fnv1a_32(limbs), p)
    return _all_probed(shard_words.to(torch.int64) & MASK32, pos)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """OR-merge two filters with identical plans."""
    return a | b


def psum_merge(partials: list, device=None) -> torch.Tensor:
    """OR-merge the shards' partial filters (a mesh's range axis) onto
    `device` (default: the first partial's). The JAX package psums
    per-bit 0/1 lanes and repacks them (sum > 0 is OR for bits); the
    bitwise OR of the words is the same filter by construction."""
    dev = partials[0].device if device is None else torch.device(device)
    out = partials[0].to(dev)
    for p in partials[1:]:
        out = out | p.to(dev)
    return out


def shard_for_ids(limbs: np.ndarray, p: BloomPlan) -> np.ndarray:
    """Host-side: which bloom shard object holds each ID (numpy)."""
    return (hashing.np_fnv1a_32(limbs) % np.uint32(p.n_shards)).astype(np.uint32)


def np_test_one_shard(shard_words: np.ndarray, limbs: np.ndarray, p: BloomPlan) -> np.ndarray:
    """Host mirror of test_one_shard (the find-by-ID read path tests the
    one fetched shard off the device). Positions derive exactly like
    _local_positions: same seeds, same h2|1, the sum wrapping mod 2**32."""
    token = hashing.np_fnv1a_32(limbs)
    h1 = hashing.np_fmix32(token, seed=_SEED_H1)
    h2 = hashing.np_fmix32(token, seed=_SEED_H2) | np.uint32(1)
    ok = np.ones(limbs.shape[0], dtype=bool)
    with np.errstate(over="ignore"):
        for i in range(p.k):
            pos = (h1 + np.uint32(i) * h2) % np.uint32(p.bits_per_shard)
            bit = (shard_words[pos // np.uint32(_WORD_BITS)] >> (pos % np.uint32(_WORD_BITS))) & np.uint32(1)
            ok &= bit == 1
    return ok


# serialization — one object per shard, little-endian uint32 words


def shard_to_bytes(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype="<u4").tobytes()


def shard_from_bytes(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32)
