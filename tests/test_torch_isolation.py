"""The port stands alone: with jax and every tempo_tpu module blocked, a
fresh interpreter imports every tempo_tpu_torch module, runs the
compaction entry and one metrics query on the CPU, writes two vtpu1
blocks, finds a trace by ID, compacts the blocks and queries the output
on the CPU, drives the storage engine (TempoDB: write, find, tag search,
tag names, TraceQL search on the vectorized branch and the object
engine, WAL replay, compaction) on the CPU, and an entry point called
without a device raises when CUDA is absent."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(r"""
    import importlib, importlib.abc, pkgutil, sys

    sys.modules["jax"] = None  # any `import jax` now raises ImportError

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "tempo_tpu" or name.startswith("tempo_tpu."):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Refuse())

    import torch
    import tempo_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(tempo_tpu_torch.__path__, "tempo_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert len(names) >= 64, names
    for name, mod in sys.modules.items():
        assert mod is None or not (name == "tempo_tpu" or name.startswith("tempo_tpu.") or name == "jax"
                    or name.startswith("jax.")), name

    from tempo_tpu_torch.entry import entry
    fn, args = entry(device="cpu", n_rows=1 << 10)
    out = fn(*args)
    assert int(out["n_rows"]) > 0

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.model import synth
    plan = M.compile_metrics_plan("{ } | rate() by (resource.service.name)",
                                  1_700_000_000, 1_700_000_060, 60)
    acc = M.DeviceAccumulator(plan, device="cpu")
    b = synth.make_batch(50, 4)
    acc.add(M.eval_batch(plan, b, b.dictionary, acc.series), b)
    merged = M.new_wire()
    M.merge_wire(merged, acc.to_wire(), plan)
    assert M.finalize_matrix(plan, merged)["result"]

    import tempfile
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
    from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
    from tempo_tpu_torch.encoding.vtpu.create import write_block
    from tempo_tpu_torch.model.columnar import SpanBatch

    cfg = BlockConfig(row_group_spans=256)
    be = TypedBackend(LocalBackend(tempfile.mkdtemp()))
    b1, b2 = synth.make_batch(120, 4, seed=1), synth.make_batch(80, 4, seed=2)
    b2 = SpanBatch.concat([b2, b1.select(list(range(40)))]).sorted_by_trace()
    metas = [write_block([x], "t", be, cfg, device="cpu") for x in (b1, b2)]
    tid = b1.cols["trace_id"][0].astype(">u4").tobytes()
    assert VtpuBackendBlock(metas[0], be, cfg).find_trace_by_id(tid).trace_id == tid
    (out,) = VtpuCompactor(CompactionOptions(block_config=cfg), device="cpu").compact(metas, "t", be)
    assert out.total_objects == 200
    acc = M.evaluate_block(plan, VtpuBackendBlock(out, be, cfg), device="cpu")
    assert acc.stats["inspectedSpans"] == out.total_spans

    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import SearchRequest
    from tempo_tpu_torch.traceql import engine

    root = tempfile.mkdtemp()
    db = TempoDB(DBConfig(backend="local", backend_path=root + "/blocks", wal_path=root + "/wal",
                          block=cfg, compaction_device_shards=1), device="cpu")
    for x in (b1, b2):
        db.write_batch("t", x)
    assert db.find("t", tid).trace_id == tid
    resp = db.search("t", SearchRequest(tags={"service": "cart"}, limit=0))
    assert resp.traces and resp.inspected_blocks == 2
    assert "service.name" in db.search_tags("t") and "cart" in db.search_tag_values("t", "service.name")
    stats = {}
    assert db.traceql_search("t", '{ duration > 500ms }', limit=0, stats=stats)
    assert "prunedRowGroups" not in stats  # vectorized branch
    stats = {}
    db.traceql_search("t", '{ span.region = "v7" || span.region = "v9" }', limit=0, stats=stats)
    assert "prunedRowGroups" in stats  # mixed attribute types: the object engine
    assert engine.execute('{ name = "db.query" }', lambda spec, s, e: []) == []
    wal = db.wal.new_block("t")
    wal.append(b1)
    (replayed,) = db.wal.rescan_blocks()
    assert db.write_wal_block("t", replayed).total_spans == b1.num_spans
    assert db.compact_once("t") == 1 and len(db.blocklist.metas("t")) == 1

    if not torch.cuda.is_available():
        for call in (lambda: entry(), lambda: M.make_accumulator(plan), lambda: TempoDB(DBConfig()),
                     lambda: write_block([b1], "t", be, cfg), lambda: VtpuCompactor(),
                     lambda: M.evaluate_block(plan, VtpuBackendBlock(out, be, cfg))):
            try:
                call()
            except RuntimeError:
                pass
            else:
                raise AssertionError("ran without a device and without CUDA")
    print("isolated ok", len(names))
""")


def test_port_runs_with_jax_and_tempo_tpu_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "isolated ok" in proc.stdout


def test_no_import_of_jax_or_tempo_tpu_in_port_sources():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|tempo_tpu)(\.|\s|$)")
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tools", "profile_torch_port.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "tempo_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    bad = []
    for p in paths:
        with open(p) as f:
            bad += [f"{p}:{i}" for i, line in enumerate(f, 1) if pat.match(line)]
    assert not bad, bad
