"""The port's block compactor against the JAX package's, byte for byte.

Two overlapping blocks (the second repeats 1/8 of the first's traces,
some copies with a differing payload so that combine runs) and a third
block whose trace IDs lie above both (so its row groups relocate on the
zero-decode path) are written by each package into its own backend;
VtpuCompactor.compact must then produce identical output blocks for
every merge planner, with the zero-decode path on and off, with a span
cap per trace, and under a non-identity dictionary remap."""

import numpy as np
import pytest
import torch

from tempo_tpu.encoding.common import BlockConfig as JConfig, CompactionOptions as JOptions
from tempo_tpu.encoding.vtpu.compactor import VtpuCompactor as JCompactor
from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.columnar import CODE_COLUMNS, VT_STR, Dictionary, SpanBatch

from test_torch_blocks import Pair, assert_same_objects, cuda_device  # noqa: F401

CFG = {"row_group_spans": 512}


def _ids_below(batch: SpanBatch, high: bool) -> SpanBatch:
    """The batch with every trace ID moved into the lower (high=False)
    or upper half of the ID space, re-sorted."""
    cols = {k: v.copy() for k, v in batch.cols.items()}
    if high:
        cols["trace_id"][:, 0] |= np.uint32(0x80000000)
    else:
        cols["trace_id"][:, 0] &= np.uint32(0x7FFFFFFF)
    return SpanBatch(cols=cols, attrs=batch.attrs, dictionary=batch.dictionary).sorted_by_trace()


def _with_shifted_dictionary(batch: SpanBatch) -> SpanBatch:
    """The same spans over a dictionary with two extra leading entries,
    so a compactor's remap of this block is not the identity."""
    d = Dictionary()
    d.add("zz-extra-1")
    d.add("zz-extra-2")
    remap = batch.dictionary.remap_onto(d)
    cols = {k: (remap[v] if k in CODE_COLUMNS else v.copy()) for k, v in batch.cols.items()}
    attrs = {k: v.copy() for k, v in batch.attrs.items()}
    attrs["attr_key"] = remap[attrs["attr_key"]]
    is_str = attrs["attr_vtype"] == VT_STR
    attrs["attr_str"] = np.where(is_str, remap[attrs["attr_str"]], attrs["attr_str"]).astype(np.uint32)
    return SpanBatch(cols=cols, attrs=attrs, dictionary=d)


def _blocks(shift_dictionary: bool):
    a = _ids_below(synth.make_batch(400, 5, seed=11), high=False)
    b = _ids_below(synth.make_batch(300, 5, seed=12), high=False)
    firsts, _ = a.trace_boundaries()
    rep = a.select(np.arange(int(firsts[len(firsts) // 8])))  # 1/8 of A's traces
    rep.cols["duration_nano"][::7] += np.uint64(1000)  # some copies differ: combine
    b = SpanBatch.concat([b, rep]).sorted_by_trace()
    c = _ids_below(synth.make_batch(300, 5, seed=13), high=True)
    if shift_dictionary:
        # B merges through the streams' remap, C relocates with its
        # dictionary-coded pages remapped and re-encoded
        b, c = _with_shifted_dictionary(b), _with_shifted_dictionary(c)
    return a, b, c


def _compact_both(tmp_path, opts_kw, shift_dictionary=False, device="cpu"):
    pair = Pair(tmp_path)
    metas = [pair.write(batch, name, CFG) for batch, name in zip(_blocks(shift_dictionary), "abc")]
    jc = JCompactor(JOptions(block_config=JConfig(**CFG), **opts_kw))
    tc = VtpuCompactor(CompactionOptions(block_config=BlockConfig(**CFG), **opts_kw), device=device)
    (jout,) = jc.compact([m[0] for m in metas], "t", pair.jb)
    (tout,) = tc.compact([m[1] for m in metas], "t", pair.tb)
    assert_same_objects(*pair.objects(jout, tout))
    for k in ("spans_combined", "spans_dropped", "pages_copied_verbatim", "pages_reencoded",
              "row_groups_relocated"):
        assert getattr(tc, k) == getattr(jc, k), k
    return pair, jc, tc, tout


@pytest.mark.parametrize("zero_decode", [True, False])
@pytest.mark.parametrize("merge_path", ["numpy", "native", "device", "auto"])
def test_compaction_matches_jax(tmp_path, merge_path, zero_decode):
    pair, jc, tc, out = _compact_both(tmp_path, {"merge_path": merge_path,
                                                 "zero_decode": zero_decode})
    assert tc.spans_combined > 0
    assert (tc.row_groups_relocated > 0) == zero_decode
    if merge_path == "device":
        assert tc.device_merge_pads and all(p >= 1024 for p in tc.device_merge_pads)
    # n_traces counts the distinct traces once each
    a, b, c = _blocks(False)
    distinct = {bytes(t) for x in (a, b, c) for t in x.cols["trace_id"][x.trace_boundaries()[0]]}
    assert out.total_objects == len(distinct)
    acc = tc.sketcher
    assert acc.launches >= 1 and acc.d2h_bytes > 0


@pytest.mark.cuda
@pytest.mark.parametrize("merge_path", ["device", "auto"])
def test_compaction_on_the_card_matches_jax(tmp_path, cuda_device, merge_path):
    pair, jc, tc, out = _compact_both(tmp_path, {"merge_path": merge_path}, device="cuda")
    assert tc.sketcher.device.type == "cuda" and tc.sketcher.launches >= 1
    assert bool(tc.device_merge_pads) == (merge_path == "device")


def test_compaction_with_span_cap_matches_jax(tmp_path):
    pair, jc, tc, out = _compact_both(tmp_path, {"merge_path": "native",
                                                 "max_spans_per_trace": 3})
    assert tc.spans_dropped > 0 and tc.row_groups_relocated == 0


def test_compaction_under_dictionary_remap_matches_jax(tmp_path):
    pair, jc, tc, out = _compact_both(tmp_path, {"merge_path": "native"}, shift_dictionary=True)
    assert tc.row_groups_relocated > 0 and tc.pages_reencoded > 0
    blk = VtpuBackendBlock(out, pair.tb)
    assert blk.dictionary().entries[:3] == ["", *synth.SERVICES[:2]]
    assert "zz-extra-1" in blk.dictionary().entries


def test_compactor_refuses_mesh_and_device_payload_plane():
    """The mesh and the device payload plane are ported (their blocks are
    held in tests/test_torch_mesh_compaction.py): what is still refused
    is what the reference refuses — the device payload plane without a
    mesh, and an unknown plane (ValueError)."""
    from tempo_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError, match="requires a mesh"):
        VtpuCompactor(CompactionOptions(payload_plane="device"), device="cpu")
    with pytest.raises(ValueError, match="unknown payload_plane"):
        VtpuCompactor(CompactionOptions(payload_plane="disk"), device="cpu")
    m = pmesh.compaction_mesh(2, devices=[torch.device("cpu")] * 2)
    comp = VtpuCompactor(CompactionOptions(mesh=m, payload_plane="device"))
    assert comp.device == torch.device("cpu")  # the mesh's lead device


def test_compactor_without_device_needs_cuda():
    if torch.cuda.is_available():
        assert VtpuCompactor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VtpuCompactor()
