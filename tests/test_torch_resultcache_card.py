"""The result cache on the card: a miss recomputes through the card's
kernels, a hit launches none.

A query_range miss counts each block into a standalone accumulator on
the DB's device (`seg_bincount` on the card) and a critical path's miss
sums its paths with `root_path_sums`; the hit answers from the cache and
launches neither. Every answer equals the port's CPU answer on the same
blocks. Port modules only: this file imports no JAX. It needs a card and
skips without one.
"""

from __future__ import annotations

import json

import pytest
import torch

from tempo_tpu_torch.db import DBConfig, TempoDB
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.modules.querier import Querier
from tempo_tpu_torch.ops import graph as ops_graph
from tempo_tpu_torch.ops import pallas_kernels as pk

BASE_S = 1_700_000_000
TENANT = "t"


def _db(root, device):
    return TempoDB(DBConfig(backend="local", backend_path=str(root / "blocks"),
                            wal_path=str(root / f"wal-{device}")), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("want", ["metrics", "cp"])
def test_card_hit_launches_no_kernel(tmp_path, monkeypatch, want):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cpu = _db(tmp_path, "cpu")
    for i in range(3):
        cpu.write_batch(TENANT, synth.make_graph_batch(
            256, 8, seed=700 + i, base_time_ns=(BASE_S + 60 * i) * 10**9))
    ids = [m.block_id for m in cpu.blocklist.metas(TENANT)]
    card = _db(tmp_path, "cuda")
    card.poll_now()
    kernel = pk.seg_bincount if want == "metrics" else ops_graph.root_path_sums
    q = "{ } | quantile_over_time(duration, 0.9) by (name)"

    def run(db):
        qr = Querier(db)
        if want == "metrics":
            return qr.query_range_blocks(TENANT, ids, q, BASE_S, BASE_S + 300, 10)["series"]
        w = qr.graph_blocks(TENANT, ids, "", BASE_S, BASE_S + 3600, "cp", by="name")
        return json.dumps({k: v for k, v in w.items() if k != "stats"}, sort_keys=True)

    try:
        monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", "0")
        answer = run(cpu)
        launches = []
        for env in ("0", "force", "force"):
            monkeypatch.setenv("TEMPO_TPU_RESULT_CACHE", env)
            kernel.launches = 0
            assert run(card) == answer
            launches.append(kernel.launches)
        cold, miss, hit = launches
        assert cold > 0 and miss >= len(ids) and hit == 0
    finally:
        card.shutdown()
        cpu.shutdown()
