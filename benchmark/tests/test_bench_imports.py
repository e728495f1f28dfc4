"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: checked by the top-level name of
each loaded module, compared whole (the program, tempo_tpu_torch, begins
with the JAX package's name)."""

import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tempo_tpu"}
PROGRAM = "tempo_tpu_torch"


def _loaded_after(code: str) -> set:
    probe = (f"import sys; sys.path.insert(0, {ROOT!r}); {code}; import json; "
             "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_every_runner_reader_and_launcher_load_no_jax():
    code = ("import glob, importlib, os; "
            "from benchmark import harness, launcher, control, recorder, faults, tracefile; "
            "[importlib.import_module('benchmark.runners.' + os.path.basename(p)[:-3]) "
            "for p in glob.glob('benchmark/runners/*.py')]; "
            "[harness._reader(os.path.basename(p)[:-3]) for p in glob.glob('benchmark/metrics/*.py')]; "
            "recorder.install(recorder.Recorder()); faults.install('alter')")
    loaded = _loaded_after(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert PROGRAM in loaded  # the recorder wraps the program's ops: the check saw it


def test_the_program_loads_no_jax():
    loaded = _loaded_after("import tempo_tpu_torch.__main__, tempo_tpu_torch.db, "
                           "tempo_tpu_torch.app")
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("from benchmark import reference, spans, datasets, traffic")
    assert not loaded & (FORBIDDEN | {PROGRAM}), loaded & (FORBIDDEN | {PROGRAM})
    assert "torch" not in loaded


def test_the_run_refuses_a_loaded_jax_module(monkeypatch):
    from benchmark import common

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert common.jax_modules() == ["jaxlib"]
