"""Flush-plus-compaction units against the storage engine, in-process.

Set-up makes the two blocks of the mix's `max_units` units and of one warm
unit from the seed (one seeded pair under new trace IDs and a new hour for
each unit) and runs the warm unit. The window then runs units back to back
until `--seconds` have passed: a unit writes its two blocks with
`TempoDB.write_batch` and runs one `TempoDB.compact_once(tenant,
max_jobs=1)`. A window that would need more units than were made fails
the run. The rate is the spans of the completed units over the time from
the window's start to the last completion. After the window, every
unit's hour must hold one compacted block whose spans, read back from the
block, are the reference's distinct spans, and a seeded sample of trace
IDs found by ID must return exactly the reference's spans.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from benchmark import adapter, common, datasets, faults, reference, spans


def _unit(db, tenant: str, batches: list, spans_log: list) -> int:
    n = 0
    for b in batches:
        t0 = time.perf_counter()
        db.write_batch(tenant, b)
        spans_log.append(("write_batch", time.perf_counter() - t0, b.num_spans))
        n += b.num_spans
    t0 = time.perf_counter()
    jobs = db.compact_once(tenant, max_jobs=1)
    spans_log.append(("compact_once", time.perf_counter() - t0, n))
    return jobs


def _pages(db) -> dict:
    m = db.compactor_driver.metrics
    return {"verbatim": m.pages_copied_verbatim, "reencoded": m.pages_reencoded}


def run(cell) -> dict:
    import torch

    from tempo_tpu_torch.db import DBConfig, TempoDB

    cfg, tr = cell.config, cell.traffic
    tenant = cfg["tenant"]
    units = datasets.Units(cfg, cell.seed)
    batches = [[adapter.span_batch(b) for b in units.pair(k)] for k in range(tr["max_units"] + 1)]
    run_dir = tempfile.mkdtemp(prefix="bench-")
    restore = faults.install(cell.fault)
    db = TempoDB(DBConfig(backend="local", backend_path=os.path.join(run_dir, "blocks"),
                          wal_path=os.path.join(run_dir, "wal"), **cfg.get("db", {})),
                 device=cell.device)
    prof = None
    try:
        warm_jobs = _unit(db, tenant, batches[0], [])
        if warm_jobs != 1:
            raise RuntimeError(f"the warm unit ran {warm_jobs} compaction jobs, not 1")
        if cell.device == "cuda":
            torch.cuda.synchronize()
        if cell.trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        before = _pages(db)
        spans_log: list = []
        done, failed = [], 0
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        k = 1
        while time.perf_counter() < t0 + cell.seconds:
            if k > tr["max_units"]:
                raise RuntimeError(f"all {tr['max_units']} prepared units ran within the window")
            jobs = _unit(db, tenant, batches[k], spans_log)
            t1 = time.perf_counter()
            if jobs == 1:
                done.append((k, t1))
            else:
                failed += 1
            k += 1
        if cell.device == "cuda":
            torch.cuda.synchronize()
        t_last = time.perf_counter() if not done else done[-1][1]
        window_s = time.perf_counter() - t0
        trace = None
        if prof is not None:
            prof.__exit__(None, None, None)
            path = os.path.join(run_dir, "trace.json")
            prof.export_chrome_trace(path)
            from benchmark import tracefile

            trace = tracefile.reduce(path)
        window = {"window_s": window_s, "jax_modules": common.jax_modules(),
                  **common.device_info(cell.device)}
        after = _pages(db)
        del batches
        checks = _judge(cell, db, units, [u for u, _ in done], k - 1, failed)
    finally:
        db.shutdown()
        restore()
        shutil.rmtree(run_dir, ignore_errors=True)
    rate = units.spans_per_unit * len(done) / (t_last - t0) if done else 0.0
    return {
        "e2e": {tr["rate_metric"]: rate}, "setup_s": setup_s,
        "attempted": k - 1, "failed": failed, "checks": checks, "window": window,
        "trace": trace,
        "layer": {"spans": spans_log, "before": {"compaction": before},
                  "after": {"compaction": after}, "trace": trace, "window_s": window_s,
                  "calls": {}, "records": []},
        "notes": {"units": len(done), "unit_spans": units.spans_per_unit},
    }


def _judge(cell, db, units, done: list, ran: int, failed: int) -> list:
    """Each completed unit's hour holds one compacted block whose spans,
    read back from it, are the reference's distinct spans of the unit; a
    seeded sample of its traces, found by ID, has exactly the reference's
    spans."""
    limits = cell.traffic["limits"]
    tenant = cell.config["tenant"]
    firsts = [spans.trace_firsts(b) for b in units.template]
    metas = db.blocklist.metas(tenant)
    not_compacted = gap = mismatches = 0
    r = datasets.rng(cell.seed, 400)
    per_unit = max(1, cell.traffic["find_sample"] // max(1, len(done)))
    for k in range(1, ran + 1):
        lo, hi = units.hour(k), units.hour(k) + 3600
        live = [m for m in metas if lo <= m.start_time < hi]
        if k not in done:
            continue
        if len(live) != 1 or live[0].compaction_level < 1:
            not_compacted += 1
            continue
        blocks = units.pair(k)
        gap += reference.key_gap(_read_back(db, live[0]), reference.span_keys(blocks))
        for _ in range(per_unit):
            b = int(r.integers(0, 2))
            i = int(r.integers(0, len(firsts[b])))
            tid = blocks[b]["cols"]["trace_id"][firsts[b][i]]
            want = reference.trace_of(blocks, tid)
            got = db.find(tenant, tid.astype(">u4").tobytes())
            mismatches += got is None or _found(got) != want
    return [("failed_units", failed, limits["failed_units"]),
            ("blocks_not_compacted", not_compacted if done else float("inf"),
             limits["blocks_not_compacted"]),
            ("span_count_gap", gap, limits["span_count_gap"]),
            ("find_mismatches", mismatches, limits["find_mismatches"])]


def _read_back(db, meta) -> np.ndarray:
    """The (trace ID, span ID) row of every span the block holds, read
    back row group by row group."""
    blk = db.encoding_for(meta.version).open_block(meta, db.backend, db.cfg.block)
    rows = [np.concatenate([b.cols["trace_id"], b.cols["span_id"]], axis=1)
            for b in blk.iter_trace_batches()]
    return np.concatenate(rows) if rows else np.zeros((0, 6), np.uint32)


def _found(trace) -> set:
    out = set()
    for resource, rows in trace.batches:
        svc = resource.get("service.name", "")
        for s in rows:
            out.add((s.span_id.hex(), s.parent_span_id.hex(), int(s.start_unix_nano),
                     int(s.duration_nano), s.name, svc))
    return out
