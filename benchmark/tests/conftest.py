"""Shared fixtures of the benchmark's own tests (run them with
`python -m pytest benchmark/tests -q`; the tests marked `card` run only on
a machine with an NVIDIA card)."""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the tiny sizes the CPU tests run each configuration at
TINY = {"querier-defaults": {"traces_per_block": 1024},
        "ingester-compactor": {"traces_per_block": 256}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tiny_configs(tmp_path_factory) -> str:
    """A directory holding each configuration at TINY's sizes, under the
    relative paths BENCHMARK.json names."""
    out = tmp_path_factory.mktemp("configs")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["data"].update(TINY[c["name"]])
        path = out / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    return str(out)
