"""A configuration's data, made from the seed by `benchmark.spans`.

Two kinds of data spec, named by the configuration's `data.kind`:

- `pair`: two blocks, the second holding fresh traces plus every
  `copy_every`-th trace of the first (a replication factor of 2's copies);
- `pairs`: such a pair for each unit of work, unit k in an hour of its own
  (`start_s` + k hours) with trace IDs of its own. Every unit repeats one
  pair drawn from the seed under new IDs and times, so each unit is the
  same work.
"""

from __future__ import annotations

import numpy as np

from benchmark import spans


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *stream])


def _pair(data: dict, r: np.random.Generator, start_s: int) -> list:
    return spans.pair(r, data["traces_per_block"], data["spans_per_trace"], data["copy_every"],
                      start_s, data["span_s"], data["attrs_per_span"])


def blocks(cfg: dict, seed: int) -> list:
    data = cfg["data"]
    if data["kind"] != "pair":
        raise ValueError(f"blocks: data kind {data['kind']!r} is not a pair")
    return _pair(data, rng(seed, 1), data["start_s"])


class Units:
    """Unit k's pair of blocks, on demand (`pairs` data)."""

    def __init__(self, cfg: dict, seed: int):
        self.data = cfg["data"]
        if self.data["kind"] != "pairs":
            raise ValueError(f"units: data kind {self.data['kind']!r} is not pairs")
        self.seed = seed
        self.template = _pair(self.data, rng(seed, 1), self.data["start_s"])
        self.spans_per_unit = sum(len(b["cols"]["trace_id"]) for b in self.template)

    def hour(self, k: int) -> int:
        return self.data["start_s"] + k * self.data["unit_stride_s"]

    def pair(self, k: int) -> list:
        xor = rng(self.seed, 2, k).integers(0, 2**32, size=3, dtype=np.uint32)
        return [spans.shifted(b, xor, k * self.data["unit_stride_s"]) for b in self.template]
