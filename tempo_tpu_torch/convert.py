"""Carry sketch state between the JAX package and the port.

State crosses as numpy arrays, so this module needs neither package's
device: a bloom filter, HLL registers, count-min counts or histogram
counts built by tempo_tpu arrive here as uint32 numpy arrays and leave
as the port's int64 tensors (uint32 values), and back. Plans cross as
their fields: `plan_fields` reads any plan object, and the port's plan
classes are rebuilt from those fields (`bloom_plan`, `hll_plan`,
`cm_plan`, `histogram_plan`); the JAX classes take the same keywords.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tempo_tpu_torch.ops.bloom import BloomPlan
from tempo_tpu_torch.ops.sketch import CMPlan, HistogramPlan, HLLPlan

_PLAN_FIELDS = {
    BloomPlan: ("n_shards", "bits_per_shard", "k"),
    HLLPlan: ("precision",),
    CMPlan: ("depth", "width"),
    HistogramPlan: ("min_exp", "max_exp", "sub"),
}


def plan_fields(plan) -> dict:
    """Fields of a plan object (either package's) as a plain dict."""
    if dataclasses.is_dataclass(plan):
        return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    raise TypeError(f"not a plan dataclass: {type(plan).__name__}")


def _rebuild(cls, plan):
    fields = plan_fields(plan)
    return cls(**{name: int(fields[name]) for name in _PLAN_FIELDS[cls]})


def bloom_plan(plan) -> BloomPlan:
    return _rebuild(BloomPlan, plan)


def hll_plan(plan) -> HLLPlan:
    return _rebuild(HLLPlan, plan)


def cm_plan(plan) -> CMPlan:
    return _rebuild(CMPlan, plan)


def histogram_plan(plan) -> HistogramPlan:
    return _rebuild(HistogramPlan, plan)


def u32_to_torch(a, device) -> torch.Tensor:
    """uint32 state (bloom words or shard words, HLL registers, CM
    counts, histogram counts) -> int64 tensor of the same values."""
    a = np.asarray(a)
    if a.dtype != np.uint32:
        raise TypeError(f"expected uint32 state, got {a.dtype}")
    return torch.from_numpy(a.astype(np.int64)).to(device)


def u32_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's uint32 state (int64-held) -> uint32 numpy array."""
    v = t.detach().cpu().to(torch.int64)
    if bool(((v < 0) | (v > 0xFFFFFFFF)).any()):
        raise ValueError("state holds values outside uint32")
    return v.numpy().astype(np.uint32)


def counts_to_torch(a, device) -> torch.Tensor:
    """A metrics count vector (int64 numpy) -> int64 tensor."""
    return torch.from_numpy(np.asarray(a, np.int64).copy()).to(device)


def counts_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.int64).numpy()
