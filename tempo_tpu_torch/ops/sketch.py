"""HyperLogLog, count-min and the fixed-bucket histogram, in PyTorch.

Port of tempo_tpu/ops/sketch.py (HLLPlan, hll_update, hll_merge,
hll_estimate, CMPlan, cm_update, cm_merge, cm_query, HistogramPlan,
np_hist_quantile). uint32 state rides in int64 tensors; count-min
counts wrap mod 2**32 like the uint32 JAX counters.

Torch has no count-leading-zeros, so `_clz32` finds the bit length with
a five-step binary search on shifts, which is exact for every uint32.
The scatter-max and scatter-add send masked lanes to one trash slot past
the end, which is cut off afterwards (JAX: mode="drop").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tempo_tpu_torch.ops import hashing
from tempo_tpu_torch.ops.hashing import MASK32

# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HLLPlan:
    precision: int = 12  # m = 2**precision registers

    def __post_init__(self):
        if not (4 <= self.precision <= 18):
            raise ValueError(f"HLL precision must be in [4,18], got {self.precision}")

    @property
    def m(self) -> int:
        return 1 << self.precision


def hll_init(p: HLLPlan, device) -> torch.Tensor:
    return torch.zeros(p.m, dtype=torch.int64, device=device)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values held in int64 (clz(0) = 32)."""
    n = torch.zeros_like(x)
    y = x
    for s in (16, 8, 4, 2, 1):
        t = y >> s
        big = t != 0
        n = n + big.to(torch.int64) * s
        y = torch.where(big, t, y)
    return 32 - (n + (y != 0).to(torch.int64))


def hll_update(regs: torch.Tensor, limbs: torch.Tensor, p: HLLPlan,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Fold a batch of keys into the register array (scatter-max)."""
    base = hashing.fnv1a_32(limbs)
    h_idx = hashing.fmix32(base, seed=0x2545F491)
    h_rho = hashing.fmix32(base, seed=0x27220A95)
    idx = h_idx & (p.m - 1)
    rho = _clz32(h_rho) + 1
    if valid is not None:
        idx = torch.where(valid, idx, p.m)
    out = torch.cat([regs.to(torch.int64), regs.new_zeros(1, dtype=torch.int64)])
    out.scatter_reduce_(0, idx, rho, reduce="amax", include_self=True)
    return out[: p.m]


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def hll_estimate(regs: torch.Tensor, p: HLLPlan) -> torch.Tensor:
    """Cardinality estimate (0-d float32), with linear-counting small-range
    fix.

    The result is the same on every device. sum(2**-r) runs in float64,
    where it is exact in any order (registers hold r <= 33, so at most
    2**18 terms span fewer than 53 bits), and is rounded to float32
    once; the zeros are an integer count; the log runs in float64 on the
    float32 ratio and is rounded once. Every other step is one IEEE
    float32 operation, as in the JAX estimate, whose float32 sum runs in
    XLA's order: the two agree wherever that sum is exact."""
    m = p.m
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    f32 = torch.float32
    inv = torch.exp2(-regs.to(torch.float64)).sum().to(f32)
    raw = torch.tensor(alpha * m * m, dtype=f32, device=regs.device) / inv
    zeros = (regs == 0).sum()
    m32 = torch.tensor(m, dtype=f32, device=regs.device)
    ratio = m32 / torch.clamp(zeros, min=1).to(f32)
    linear = m32 * torch.log(ratio.to(torch.float64)).to(f32)
    small = raw <= 2.5 * m
    return torch.where(small & (zeros > 0), linear, raw)


# ---------------------------------------------------------------------------
# count-min
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CMPlan:
    depth: int = 4
    width: int = 1 << 12  # must be a power of two (indices are masked, not mod'd)

    def __post_init__(self):
        if self.width <= 0 or self.width & (self.width - 1):
            raise ValueError(f"CM width must be a power of two, got {self.width}")
        if self.depth < 1:
            raise ValueError(f"CM depth must be >= 1, got {self.depth}")


def cm_init(p: CMPlan, device) -> torch.Tensor:
    return torch.zeros((p.depth, p.width), dtype=torch.int64, device=device)


def _cm_indices(limbs: torch.Tensor, p: CMPlan) -> torch.Tensor:
    hs = hashing.hash_streams(limbs, p.depth, seed=0x5BD1E995)
    return hs & (p.width - 1)  # (depth, N)


def cm_update(counts: torch.Tensor, limbs: torch.Tensor, p: CMPlan,
              weights: torch.Tensor | None = None,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter-add a batch of keys (optionally weighted) into the sketch."""
    idx = _cm_indices(limbs, p)  # (depth, N)
    n = limbs.shape[0]
    if weights is None:
        w = torch.ones(n, dtype=torch.int64, device=limbs.device)
    else:
        w = weights.to(torch.int64) & MASK32
    if valid is not None:
        w = torch.where(valid, w, 0)
    rows = torch.arange(p.depth, dtype=torch.int64, device=limbs.device)[:, None]
    flat = (rows * p.width + idx).reshape(-1)
    out = counts.reshape(-1).to(torch.int64).clone()
    out.index_add_(0, flat, w.expand(p.depth, n).reshape(-1))
    return (out & MASK32).view(p.depth, p.width)


def cm_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a + b) & MASK32


def cm_query(counts: torch.Tensor, limbs: torch.Tensor, p: CMPlan) -> torch.Tensor:
    """Point estimate per key: min over rows (classic CM upper bound)."""
    idx = _cm_indices(limbs, p)
    return torch.gather(counts.to(torch.int64), 1, idx).min(dim=0).values


# ---------------------------------------------------------------------------
# fixed-bucket log-scale histogram (quantile sketch) — host numpy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HistogramPlan:
    """Log-linear fixed-bucket histogram over positive values: octaves
    [2**min_exp, 2**max_exp), each split into `sub` equal sub-buckets,
    plus an underflow and an overflow bucket. Integer counts merge by
    addition."""

    min_exp: int = 10  # 2**10 ns ~ 1us: floor for duration-type values
    max_exp: int = 42  # 2**42 ns ~ 73min: ceiling
    sub: int = 8  # sub-buckets per octave

    def __post_init__(self):
        if self.max_exp <= self.min_exp:
            raise ValueError("HistogramPlan: max_exp must exceed min_exp")
        if self.sub < 1:
            raise ValueError("HistogramPlan: sub must be >= 1")

    @property
    def n_buckets(self) -> int:
        return (self.max_exp - self.min_exp) * self.sub + 2

    def np_bucket_of(self, values: np.ndarray) -> np.ndarray:
        """(N,) float/int values -> (N,) int32 bucket indices (host)."""
        v = np.asarray(values, np.float64)
        m, e = np.frexp(np.maximum(v, 1e-300))  # v = m * 2**e, m in [0.5, 1)
        octave = e - 1
        subidx = np.minimum((2.0 * m - 1.0) * self.sub, self.sub - 1).astype(np.int64)
        idx = (octave - self.min_exp) * self.sub + subidx + 1
        idx = np.where(v < float(2.0 ** self.min_exp), 0, idx)
        return np.minimum(idx, self.n_buckets - 1).astype(np.int32)

    def bucket_upper(self, idx) -> np.ndarray:
        """Upper edge of each bucket (the underflow bucket reports the
        floor, overflow the ceiling)."""
        idx = np.asarray(idx, np.int64)
        k = np.clip(idx - 1, 0, (self.max_exp - self.min_exp) * self.sub - 1)
        octave, s = k // self.sub, k % self.sub
        upper = np.exp2(self.min_exp + octave) * (1.0 + (s + 1) / self.sub)
        upper = np.where(idx <= 0, float(2.0 ** self.min_exp), upper)
        return np.where(idx >= self.n_buckets - 1, float(2.0 ** self.max_exp), upper)


def np_hist_quantile(counts: np.ndarray, qs, p: HistogramPlan) -> np.ndarray:
    """Upper edge of the first bucket whose cumulative count reaches
    ceil(q * total); NaN when the histogram is empty."""
    c = np.asarray(counts, np.int64)
    total = int(c.sum())
    qs = np.asarray(list(qs), np.float64)
    if total == 0:
        return np.full(qs.shape, np.nan)
    ranks = np.maximum(np.ceil(qs * total), 1)
    idx = np.searchsorted(np.cumsum(c), ranks)
    return p.bucket_upper(np.minimum(idx, p.n_buckets - 1))

