"""The port stands alone: with jax and every tempo_tpu module blocked, a
fresh interpreter imports every tempo_tpu_torch module, runs the
compaction entry and one metrics query on the CPU, and an entry point
called without a device raises when CUDA is absent."""

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
    assert len(names) >= 20, names
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

    if not torch.cuda.is_available():
        for call in (lambda: entry(), lambda: M.make_accumulator(plan)):
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
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "tempo_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    bad = []
    for p in paths:
        with open(p) as f:
            bad += [f"{p}:{i}" for i, line in enumerate(f, 1) if pat.match(line)]
    assert not bad, bad
