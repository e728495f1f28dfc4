"""The port's flagship compaction step against the JAX package's.

local_compaction_step (axis=None in JAX) over the same numpy inputs on
the CPU: perm, keep, n_rows, n_traces and the bloom, HLL and count-min
sketches must be bit-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from tempo_tpu.parallel import compaction as jcomp
from tempo_tpu_torch import convert
from tempo_tpu_torch.entry import entry, example_inputs_np
from tempo_tpu_torch.parallel import compaction

KEYS = ("perm", "keep", "n_rows", "n_traces", "total_rows", "total_traces", "bloom", "hll", "cm")


def _compare(jax_out, torch_out):
    for k in KEYS:
        a = np.asarray(jax_out[k])
        b = torch_out[k].numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=k)


def test_entry_matches_graft_entry():
    jfn, jargs = __graft_entry__.entry()
    fn, args = entry(device="cpu")
    for a, b in zip(jargs, args):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64))
    _compare(jfn(*jargs), fn(*args))


@pytest.mark.parametrize("n_rows,seed", [(1000, 1), (3 * 1024 + 17, 2)])
def test_local_compaction_step_non_power_of_two(n_rows, seed):
    tids, sids, valid = example_inputs_np(n_rows, seed)
    jplans = jcomp.default_plans(n_rows)
    plans = compaction.CompactionPlans(
        bloom=convert.bloom_plan(jplans.bloom), hll=convert.hll_plan(jplans.hll),
        cm=convert.cm_plan(jplans.cm))
    assert plans == compaction.default_plans(n_rows)
    want = jcomp.local_compaction_step(jnp.asarray(tids), jnp.asarray(sids), jnp.asarray(valid),
                                       jplans, axis=None)
    got = compaction.local_compaction_step(torch.from_numpy(tids.astype(np.int64)),
                                           torch.from_numpy(sids.astype(np.int64)),
                                           torch.from_numpy(valid), plans)
    _compare(want, got)


def test_local_compaction_step_without_valid_mask():
    tids, sids, _ = example_inputs_np(512, 3)
    jplans = jcomp.default_plans(512)
    want = jcomp.local_compaction_step(jnp.asarray(tids), jnp.asarray(sids), None, jplans, axis=None)
    got = compaction.local_compaction_step(torch.from_numpy(tids.astype(np.int64)),
                                           torch.from_numpy(sids.astype(np.int64)), None,
                                           compaction.default_plans(512))
    _compare(want, got)


def test_entry_without_device_needs_cuda():
    if torch.cuda.is_available():
        fn, args = entry()
        assert args[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
