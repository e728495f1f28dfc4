"""A whole run, at a tiny size on the CPU with the card check skipped,
comes out correct, and comes out not correct with the timed path broken
underneath it by each fault that the cell can have (benchmark/faults.py):
half of the blocks' traces left out, an answer altered where the program
produces it, a compaction that leaves its blocks as they were. No cell
spans chips, so none can lose an exchange between them."""

import time

import pytest

from benchmark import harness

CASES = [
    ("querier.metrics", ""), ("querier.metrics", "half"), ("querier.metrics", "alter"),
    ("ingest-compact.pairs", ""), ("ingest-compact.pairs", "half"),
    ("ingest-compact.pairs", "alter"), ("ingest-compact.pairs", "unchanged"),
]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_run_is_correct_only_without_a_fault(tiny_configs, workload, fault):
    cell = harness.load_cell(workload, 2_147_483_659, 3, False, device="cpu", fault=fault,
                             config_dir=tiny_configs)
    cell.t_start = time.perf_counter()
    if "warmup" in cell.traffic:
        cell.traffic["warmup"]["max_s"] = 15
    if "max_units" in cell.traffic:  # a tiny unit runs in milliseconds
        cell.traffic["max_units"] = 1000
    done = harness.run(cell)
    result = done["result"]
    assert result["correct"] is (fault == ""), result["checks"]
    assert result["attempted"] > 0 and not done["jax"]
