"""Without a card a run fails instead of falling back to the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def _nocard(request):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")


@pytest.mark.parametrize("workload", ["querier.metrics", "ingest-compact.pairs"])
def test_run_without_a_card_exits_nonzero_with_no_result(request, workload):
    _nocard(request)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "3000000007", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "is_available" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_a_bare_checkout_of_the_benchmark_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "querier.metrics",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
