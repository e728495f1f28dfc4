"""Runs one cell once and prints its result line.

Everything a cell needs is found by name: the workload's entry in
BENCHMARK.json names its configuration (whose `file` is read) and its
traffic mix (`benchmark/traffic/<traffic>.json`); the mix names its
runner (`benchmark/runners/<runner>.py`, a `run(cell)` function); each
per-layer metric is read by `benchmark/metrics/<name>.py` (a `read(ctx)`
function returning a number, or None where it finds nothing to read).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass

from benchmark import common

SPEC = os.path.join(common.ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    workload: dict
    config: dict
    config_path: str
    traffic: dict
    spec: dict
    seed: int
    seconds: int
    trace: bool
    device: str = "cuda"
    fault: str = ""
    t_start: float = 0.0  # the process's start on the host clock (set-up runs from it)


def load_cell(workload: str, seed: int, seconds: int, trace: bool, spec_path: str = SPEC,
              device: str = "cuda", fault: str = "", config_dir: str | None = None) -> Cell:
    with open(spec_path) as f:
        spec = json.load(f)
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in {spec_path}")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    cfg_path = os.path.join(config_dir or common.ROOT, cfg_entry["file"])
    with open(cfg_path) as f:
        cfg = json.load(f)
    with open(os.path.join(common.ROOT, "benchmark", "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(wl, cfg, cfg_path, traffic, spec, seed, seconds, trace, device, fault)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _reader(name: str):
    path = os.path.join(common.ROOT, "benchmark", "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location("benchmark_metric_" + name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def check_device(chips: int) -> str | None:
    """None when the card the cell asks for is here, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: this benchmark runs only on the card"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards, {torch.cuda.device_count()} are here"
    return None


def run(cell: Cell) -> dict:
    """The result's fields, and the comparisons beside their limits."""
    runner = importlib.import_module("benchmark.runners." + cell.traffic["runner"])
    out = runner.run(cell)
    setup_s = out.pop("setup_s")
    metrics = {}
    if cell.trace:
        ctx = dict(out["layer"], cell=cell)
        for m in cell.spec["per_layer"]:
            if _applies(m, cell.workload["name"]):
                v = _reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.spec["end_to_end"]:
            if _applies(m, cell.workload["name"]) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {k: out["window"][k] for k in ("platform", "kind", "count", "memory_peak_bytes")}
    if cell.trace:
        tr = out["trace"] or {}
        device.update(busy_s=tr.get("busy_s", 0.0), window_s=out["window"]["window_s"])
    checks = out["checks"]
    correct = all(lim is not None and v <= lim for _, v, lim in checks)
    jax = sorted(set(out["window"].get("jax_modules", [])) | set(common.jax_modules()))
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if cell.trace and out["trace"]:
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return {"result": result, "jax": jax, "notes": out.get("notes", {}),
            "trace_fault": cell.trace and not (out["trace"] or {}).get("n_device")}


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.update(common.cache_env())
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    cell.t_start = time.perf_counter() if t_start is None else t_start
    why_not = check_device(int(cell.workload["chips"]))
    if why_not:
        print(why_not, file=sys.stderr)
        return 2
    return emit(run(cell))


def emit(done: dict) -> int:
    """Prints the notes and the comparisons on standard error and the
    result line last on standard output; refuses a run that loaded JAX
    or whose trace saw no device activity."""
    if done["jax"]:
        print(f"JAX modules were loaded: {done['jax']}; no result", file=sys.stderr)
        return 3
    if done["trace_fault"]:
        print("the traced window holds no device activity (a capture fault); no result",
              file=sys.stderr)
        return 4
    result = _finite(done["result"])
    print(json.dumps({"notes": _finite(done["notes"])})[:4000], file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
