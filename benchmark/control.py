"""The controls: the reference put in the program's place with one stated
guarantee broken, judged as a run judges the program.

    python3 benchmark/control.py --workload NAME --seeds 11,12,13

The configurations state no precision, so each control breaks one
guarantee that its configuration states, the step that would tempt a
later change:

- `querier.metrics`: a trace that both blocks hold counts once (the
  copies deduplicated), where query_range counts every stored span;
- `ingest-compact.pairs`: the compacted block keeps the copies that both
  inputs hold twice, where it keeps each span once.

Each prints, a seed a line, the numbers a run compares, beside the limits
of the cell's traffic mix. The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import datasets, harness, reference, spans  # noqa: E402
from benchmark.traffic import Mix  # noqa: E402


def _requests(cell, n: int) -> list:
    """The first n requests a run's clients take."""
    out: list = []
    for p in Mix(cell.traffic, cell.config).passes(datasets.rng(cell.seed, 200)):
        out += p
        if len(out) >= n:
            return out[:n]


def _deduplicated(blocks: list) -> list:
    """The blocks with the second's copies of the first's traces left out."""
    a, b = blocks
    ids_a = {bytes(t) for t in a["cols"]["trace_id"][spans.trace_firsts(a)]}
    keep = np.array([bytes(t) not in ids_a for t in b["cols"]["trace_id"]])
    return [a, spans.select(b, np.flatnonzero(keep))]


def metrics_control(cell, n: int) -> list:
    blocks = datasets.blocks(cell.config, cell.seed)
    true, broken = reference.RangeReference(blocks), reference.RangeReference(_deduplicated(blocks))
    gap = 0.0
    for req in _requests(cell, n):
        spec = req["spec"]
        counts = broken.counts(spec)
        vals = counts / spec["step"] if spec["func"] == "rate" else counts.astype(float)
        result = [{"values": [[spec["start"] + i * spec["step"], repr(float(v))]
                              for i, v in enumerate(vals)]}]
        gap = max(gap, reference.judge_query_range(true, spec, result))
    return [("failed_requests", 0), ("count_gap", gap)]


def compaction_control(cell, n_units: int) -> list:
    units = datasets.Units(cell.config, cell.seed)
    gap = 0
    for k in range(1, n_units + 1):
        pair = units.pair(k)
        # the control's compacted block: every input row
        kept_twice = np.concatenate(
            [np.concatenate([b["cols"]["trace_id"], b["cols"]["span_id"]], axis=1) for b in pair])
        gap += reference.key_gap(kept_twice, reference.span_keys(pair))
    return [("failed_units", 0), ("blocks_not_compacted", 0),
            ("span_count_gap", gap), ("find_mismatches", 0)]


CONTROLS = {"http_closed_loop": metrics_control, "flush_compact": compaction_control}


def readings(workload: str, seed: int, n: int, config_dir: str | None = None) -> list:
    cell = harness.load_cell(workload, seed, 0, False, config_dir=config_dir)
    fn = CONTROLS[cell.traffic["runner"]]
    limits = cell.traffic["limits"]
    return [(name, v, limits[name]) for name, v in fn(cell, n)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=256,
                   help="requests judged a seed (a query cell), or units (compaction)")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        rows = readings(args.workload, seed, args.requests)
        failed = any(v > lim for _, v, lim in rows)
        print(json.dumps({"workload": args.workload, "seed": seed, "not_correct": failed,
                          "readings": {k: {"value": v, "limit": lim} for k, v, lim in rows}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
