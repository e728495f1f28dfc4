"""BENCHMARK.json against the rules of its contract that a file can show:
the keys, the characters of every name and unit, and that every entry
finds its file by name under the benchmark's folder."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for e in SPEC[kind]:
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)


def test_configs():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and _line(c["source"])
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(json.load(f)["reduced"]) == set(c["reduced"])
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.fullmatch(w["traffic"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    assert {w["config"] for w in SPEC["workloads"]} == configs


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        for cell in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in SPEC["workloads"]:
        name = w["name"]
        e2e = [m for m in SPEC["end_to_end"] if name in m.get("workloads", [name])]
        layer = [m for m in SPEC["per_layer"] if name in m.get("workloads", [name])]
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2 and layer


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_check_time_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
