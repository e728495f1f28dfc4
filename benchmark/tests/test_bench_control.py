"""Each cell's control (benchmark/control.py: the reference in the
program's place with one stated guarantee broken) comes out not correct,
at a tiny size here and, on the card's machine, at the cell's own size."""

import json
import subprocess
import sys

import pytest

from benchmark import control
from conftest import ROOT

CELLS = ["querier.metrics", "ingest-compact.pairs"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_number_at_a_tiny_size(tiny_configs, workload):
    rows = control.readings(workload, 2_147_483_661, 64 if workload != CELLS[1] else 4,
                            config_dir=tiny_configs)
    assert any(v > lim for _, v, lim in rows), rows


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_number_at_the_cells_size(card, workload):
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", workload,
                          "--seeds", "3000000101,3000000103,3000000107"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200, check=True)
    docs = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(docs) == 3 and all(d["not_correct"] for d in docs), docs
