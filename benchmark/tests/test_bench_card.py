"""On the card: a short run of each cell ends with a result line whose
`correct` is true (on the CPU these skip)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", ["querier.metrics", "ingest-compact.pairs"])
def test_a_short_run_is_correct(card, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "3000000201", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
