"""Entry point of the port's flagship step.

entry(device=None, n_rows=1 << 13) -> (fn, example_args): the one-device
compaction+sketch pass (lexsort/dedupe merge plan, sharded bloom build,
HLL + count-min update) over a padded span batch — the port of
__graft_entry__.entry(). The example inputs are made with numpy from a
seed exactly as the JAX entry makes them, then moved to the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tempo_tpu_torch import device as _device
from tempo_tpu_torch.parallel.compaction import default_plans, local_compaction_step


def example_inputs_np(n_rows: int, seed: int = 0):
    """(tids (N,4) u32, sids (N,2) u32, valid (N,) bool) numpy arrays:
    random keys, the first 1/8 of rows duplicating the next 1/8, the
    last 1/16 invalid."""
    rng = np.random.default_rng(seed)
    tids = rng.integers(0, 2**32, (n_rows, 4), np.uint32)
    sids = rng.integers(0, 2**32, (n_rows, 2), np.uint32)
    k = n_rows // 8
    tids[:k] = tids[k : 2 * k]
    sids[:k] = sids[k : 2 * k]
    valid = np.ones(n_rows, bool)
    valid[-n_rows // 16 :] = False
    return tids, sids, valid


def example_inputs(n_rows: int, device, seed: int = 0):
    """example_inputs_np on `device`, uint32 columns as int64 tensors."""
    tids, sids, valid = example_inputs_np(n_rows, seed)
    return (torch.from_numpy(tids.astype(np.int64)).to(device),
            torch.from_numpy(sids.astype(np.int64)).to(device),
            torch.from_numpy(valid).to(device))


def entry(device=None, n_rows: int = 1 << 13):
    """(fn, example_args) for the compaction step at n_rows rows, with
    plans sized for n_rows traces. Runs on CUDA unless device="cpu"."""
    dev = _device.resolve(device)
    fn = functools.partial(local_compaction_step, plans=default_plans(n_rows))
    return fn, example_inputs(n_rows, dev)
