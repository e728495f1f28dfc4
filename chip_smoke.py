#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tempo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure exits non-zero):

0. device: card name, count, torch/CUDA versions, nvidia-smi name and
   power limit;
1. build: nvcc builds csrc/kernels.cu (the three hand-written kernels)
   and ptxas reports each kernel's registers, static shared memory and
   spills;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, bit for bit, at the main path's shapes and at edge shapes, and
   timed two ways: kernel time (device time alone: a CUDA graph of K
   back-to-back launches of the C entry point into outputs allocated
   and zeroed before the capture, replay time / K, median of 7 replays)
   and path time (CUDA events around one whole wrapper call as the main
   path makes it, median of 25), beside its plain version and one
   PyTorch library call where there is one (both timed as path time),
   and its bound;
3. compaction: the flagship step (entry.entry) at 2**22 rows, bit-equal
   between the card and the CPU;
4. metrics: three TraceQL query_range queries over 2**22 synthetic spans
   through the port's plan -> eval_batch -> accumulator -> wire ->
   matrix pipeline, equal between the card and the CPU, with each
   query's kernel launches and device-to-host bytes;
5. scan: in_set_scan and u64_range_scan over the same 2**22 spans'
   columns, against a numpy oracle, then timed as in phase 2;
6. blocks: the vtpu1 block lifecycle at a compactor job's size. Two
   blocks of 2**20 spans (131,072 traces x 8 spans each; 1/8 of the
   second block's traces are copies of the first's) are written with
   their bloom and HLL built on the card and again on the CPU (every
   stored object byte-equal), 1,000 present and 1,000 absent trace IDs
   are found by ID in both (equal answers), the two blocks are compacted
   with the merge plan and the sketch plane on the card and on the CPU
   (byte-equal outputs, one trace per distinct ID) and with the native
   k-way merge plan (the host figure), and the phase-4 queries run
   through evaluate_block over the compacted block, card accumulator
   against CPU accumulator. Each trace's spans form a parent chain;
7. db: the storage engine. TempoDB(device="cuda") opens a local backend
   holding copies of the blocks phase 6 wrote on the card, and every
   answer is held against a numpy oracle computed from the generated
   batches: poll; find for 200 present IDs (20 of them copies held by
   both blocks) and 200 absent ones; seven tag searches (service,
   service+name, http.status_code, an attribute, a duration floor, a
   time window, a value the dictionary lacks), each at limit 20 and
   unbounded, cold (column cache cleared) then warm; tag names and
   values; four TraceQL searches, the structural one on the object
   engine because copies straddle the blocks; compact_once; the
   unbounded searches and the structural query (now on the vectorized
   branch) again over the one compacted block; the phase-4 queries over
   the DB's blocks, card against CPU; a WAL block of 2**17 spans
   appended, rescanned and completed on the card, byte-equal to
   write_batch of the same spans on the CPU.

Phases 3-4 are the main path, phase 5 the scan path, phase 6 the block
path and phase 7 the storage engine's path: each is run with the
kernels' launch counts set to 0 just before it, and every kernel of the
path must have launched. The script then prints one JSON line of
per-kernel and per-phase numbers (phase 6's under "blocks", phase 7's
under "db"), the nvidia-smi line, and last {"ok": true, "device":
{...}}. Without a CUDA
device it exits 1 and prints no result. It imports nothing of JAX or of
tempo_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import uuid

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
BASE_S = 1_700_000_000


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def path_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one whole call of fn() in ms: CUDA events around
    the call, so the host's dispatch, allocations and memsets count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(torch, launches, k: int = 48, reps: int = 7) -> float:
    """Device time of one launch in ms: each of `launches` enqueues the
    kernel alone on its own inputs (its outputs exist already), a CUDA
    graph holds k launches back to back taking them in turn, and the
    median of reps replays is divided by k. The host's enqueue, slower
    than a short kernel, stays out of the time. One launch finds its
    inputs in L2 from the launch before; several copies of inputs larger
    than L2 make every launch read them from HBM."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for launch in launches:
            launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(k):
            launches[i % len(launches)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    del graph
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block_objects(root: str, tenant: str, block_id: str, drop_id: bool = False) -> dict:
    """name -> comparable bytes of one stored block: index.json and
    dict.bin gunzipped (their gzip header holds the clock), meta.json
    without its block id when drop_id."""
    d = os.path.join(root, tenant, block_id)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            raw = f.read()
        if name in ("index.json", "dict.bin"):
            raw = gzip.decompress(raw)
        elif name == "meta.json" and drop_id:
            meta = json.loads(raw)
            meta.pop("block_id")
            raw = json.dumps(meta, sort_keys=True).encode()
        out[name] = raw
    return out


def check_same_blocks(a: dict, b: dict, what: str) -> None:
    differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    check(not differ, f"{what}: objects differ: {differ[:8]}")


def chain_parents(batch):
    """The batch with each trace's rows made a parent chain: the trace's
    first row the root, row k the child of row k-1 (make_batch draws
    unlinked parent IDs, so structural TraceQL would match nothing)."""
    import numpy as np

    from tempo_tpu_torch.model.columnar import SpanBatch

    firsts, seg = batch.trace_boundaries()
    row = np.arange(batch.num_spans)
    sid = batch.cols["span_id"]
    parent = np.where((row == firsts[seg])[:, None], 0, sid[np.maximum(row - 1, 0)])
    cols = dict(batch.cols, parent_span_id=parent.astype(np.uint32))
    return SpanBatch(cols=cols, attrs=batch.attrs, dictionary=batch.dictionary)


def blocks_phase(seed: int, queries: list, plan_of, db_root: str):
    """Phase 6, the block path: write, find by ID, compact and query
    vtpu1 blocks on the card and on the CPU. The card-written blocks A
    and B are copied into the local backend at db_root for phase 7.
    Returns (its numbers, the batches of A and B)."""
    import numpy as np

    from tempo_tpu_torch.encoding import default_encoding

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch import native
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
    from tempo_tpu_torch.encoding.vtpu import codec
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
    from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
    from tempo_tpu_torch.encoding.vtpu.create import write_block
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.columnar import SpanBatch
    from tempo_tpu_torch.model.trace import combine_traces
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.util.devicetiming import STATS

    cfg = BlockConfig()
    tenant = "smoke"
    devices = ("cuda", "cpu")
    res: dict = {"codec": codec.resolve_codec("auto")}
    print(f"phase 6 codec: 'auto' resolves to {res['codec']} (native library "
          f"{'built' if native.lib() is not None else 'absent'})", flush=True)

    # block A: 16 batches of 8192 traces x 8 spans, a minute apart, sorted
    # by trace, each trace's spans a parent chain; block B: 14 such
    # batches from other seeds plus every 8th trace of A (replication-
    # factor copies): 2**20 spans each
    t0 = time.perf_counter()

    def batches(seed0: int, n: int) -> list:
        return [chain_parents(synth.make_batch(8192, 8, seed=seed0 + i,
                                               base_time_ns=(BASE_S + 60 * i) * 10**9))
                for i in range(n)]

    a = SpanBatch.concat(batches(seed * 1000 + 100, 16)).sorted_by_trace()
    _, seg_a = a.trace_boundaries()
    b = SpanBatch.concat(batches(seed * 1000 + 200, 14)
                         + [a.select(np.flatnonzero(seg_a % 8 == 0))]).sorted_by_trace()
    ids = {k: x.cols["trace_id"][x.trace_boundaries()[0]] for k, x in (("a", a), ("b", b))}
    n_distinct = len(np.unique(np.concatenate([ids["a"], ids["b"]]), axis=0))
    check(a.num_spans == b.num_spans == 1 << 20, "phase 6 blocks are not 2**20 spans")
    print(f"phase 6 data: blocks of {a.num_spans} and {b.num_spans} spans, "
          f"{len(ids['a'])} + {len(ids['b'])} traces, {n_distinct} distinct "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_blocks_") as tmp:
        roots = {dev: os.path.join(tmp, dev) for dev in devices}
        backends = {dev: TypedBackend(LocalBackend(roots[dev])) for dev in devices}
        block_ids = {"a": str(uuid.uuid4()), "b": str(uuid.uuid4())}

        # ------------------------------------------------------------ write
        metas, write_s = {}, {}
        for dev in devices:
            for k, batch in (("a", a), ("b", b)):
                h2d0 = STATS.h2d.get("block_sketch", 0)
                d2h0 = STATS.d2h.get("block_sketch", 0)
                t0 = time.perf_counter()
                metas[dev, k] = write_block([batch], tenant, backends[dev], cfg,
                                            block_id=block_ids[k], device=dev)
                write_s[f"{dev} {k}"] = time.perf_counter() - t0
                print(f"phase 6 write {k} on {dev}: {write_s[f'{dev} {k}'] * 1e3:.0f} ms, "
                      f"{metas[dev, k].total_records} row groups, {metas[dev, k].size_bytes} B "
                      f"of pages, sketch H2D {STATS.h2d.get('block_sketch', 0) - h2d0} B, "
                      f"D2H {STATS.d2h.get('block_sketch', 0) - d2h0} B, "
                      f"est_distinct {metas[dev, k].est_distinct_traces}", flush=True)
        for k in "ab":
            check_same_blocks(block_objects(roots["cuda"], tenant, block_ids[k]),
                              block_objects(roots["cpu"], tenant, block_ids[k]),
                              f"block {k} written on cuda vs cpu")
            check(metas["cuda", k].total_objects == len(ids[k]), f"block {k}: n_traces")
        print("phase 6 write: blocks a and b byte-equal between cuda and cpu (data.bin, "
              "bloom shards, meta.json; index and dictionary gunzipped)", flush=True)
        res["write_ms"] = {k: v * 1e3 for k, v in write_s.items()}
        # phase 7's backend: the card-written objects, copied as files
        enc = default_encoding()
        db_backend = TypedBackend(LocalBackend(db_root))
        for k in "ab":
            enc.copy_block(metas["cuda", k], backends["cuda"], db_backend)

        # ------------------------------------------------------ find by ID
        rng = np.random.default_rng(seed + 99)
        present = np.concatenate([ids["a"][rng.choice(len(ids["a"]), 500, replace=False)],
                                  ids["b"][rng.choice(len(ids["b"]), 500, replace=False)]])
        known = {bytes(t) for t in np.concatenate([ids["a"], ids["b"]])}
        absent = [t for t in rng.integers(0, 2**32, (1100, 4), dtype=np.uint32)
                  if bytes(t) not in known][:1000]
        check(len(absent) == 1000, "phase 6: could not draw 1000 absent IDs")

        def find_all(dev, limbs_list):
            blks = [VtpuBackendBlock(metas[dev, k], backends[dev], cfg) for k in "ab"]
            out = []
            t0 = time.perf_counter()
            for limbs in limbs_list:
                tid = np.asarray(limbs, np.uint32).astype(">u4").tobytes()
                t = combine_traces([blk.find_trace_by_id(tid) for blk in blks])
                out.append(None if t is None else (t.trace_id, repr(t.batches)))
            return out, (time.perf_counter() - t0) / len(limbs_list) * 1e3

        found, find_ms = {}, {}
        for dev in devices:
            found[dev, "present"], find_ms[f"{dev} present"] = find_all(dev, present)
            found[dev, "absent"], find_ms[f"{dev} absent"] = find_all(dev, absent)
        for kind in ("present", "absent"):
            check(found["cuda", kind] == found["cpu", kind],
                  f"find {kind}: cuda-written blocks answer unlike cpu-written ones")
        for limbs, hit in zip(present, found["cuda", "present"]):
            check(hit is not None and hit[0] == limbs.astype(">u4").tobytes()
                  and hit[1].count("Span(") == 8, "find: a present trace was not found whole")
        check(all(hit is None for hit in found["cuda", "absent"]), "find: an absent ID was found")
        print(f"phase 6 find: 1000 present found whole, 1000 absent -> None, equal between "
              f"cuda- and cpu-written blocks | {find_ms['cuda present']:.2f} ms a present ID, "
              f"{find_ms['cuda absent']:.3f} ms an absent one (two blocks each)", flush=True)
        res["find_ms"] = find_ms

        # -------------------------------------------------------- compact
        outs, compact_s = {}, {}
        for dev, path in (("cuda", "device"), ("cpu", "device"), ("cuda", "auto")):
            comp = VtpuCompactor(CompactionOptions(block_config=cfg, merge_path=path), device=dev)
            t0 = time.perf_counter()
            (outs[dev, path],) = comp.compact([metas[dev, "a"], metas[dev, "b"]], tenant,
                                              backends[dev])
            compact_s[f"{dev} {path}"] = time.perf_counter() - t0
            out = outs[dev, path]
            check(out.total_objects == n_distinct,
                  f"compaction {dev} {path}: {out.total_objects} traces, {n_distinct} distinct")
            sk = comp.sketcher
            pads = comp.device_merge_pads
            print(f"phase 6 compact on {dev}, merge_path {path}: "
                  f"{compact_s[f'{dev} {path}'] * 1e3:.0f} ms, {out.total_spans} spans, "
                  f"{out.total_objects} traces, {comp.spans_combined} spans combined | "
                  f"{len(pads)} device merge calls (padded rows: "
                  f"{', '.join(f'{p} x{pads.count(p)}' for p in sorted(set(pads)))}) | "
                  f"sketch accumulator: {sk.launches} updates, H2D {sk.h2d_bytes} B, "
                  f"D2H {sk.d2h_bytes} B", flush=True)
            if path == "device":
                res.setdefault("device_merge_calls", {})[dev] = len(pads)
                res.setdefault("device_merge_padded_rows", {})[dev] = sum(pads)
                check(pads, f"compaction on {dev}: the merge plan never ran on the device")
            res.setdefault("sketch_bytes", {})[f"{dev} {path}"] = {
                "h2d": sk.h2d_bytes, "d2h": sk.d2h_bytes, "updates": sk.launches}
        ref = block_objects(roots["cpu"], tenant, outs["cpu", "device"].block_id, drop_id=True)
        for dev, path in (("cuda", "device"), ("cuda", "auto")):
            check_same_blocks(block_objects(roots[dev], tenant, outs[dev, path].block_id,
                                            drop_id=True), ref,
                              f"compacted block ({dev}, {path}) vs (cpu, device)")
        print("phase 6 compact: outputs byte-equal between cuda and cpu (merge_path device) "
              "and the native plan (auto)", flush=True)
        res["compact_ms"] = {k: v * 1e3 for k, v in compact_s.items()}

        # ---------------------------------------------------------- query
        out_meta, be = outs["cuda", "device"], backends["cuda"]
        res["query"] = []
        for q in queries:
            plan = plan_of(q)
            row = {"query": q}
            got = {}
            for dev in devices:
                before = pk.seg_bincount.launches
                d2h0 = STATS.d2h.get("seg_bincount", 0)
                t0 = time.perf_counter()
                acc = M.evaluate_block(plan, VtpuBackendBlock(out_meta, be, cfg), device=dev)
                merged = M.new_wire()
                M.merge_wire(merged, acc.to_wire(), plan)
                got[dev] = M.finalize_matrix(plan, merged)
                row[f"{dev}_ms"] = (time.perf_counter() - t0) * 1e3
                if dev == "cuda":
                    check(isinstance(acc, M.DeviceAccumulator), f"{q}: not the card's accumulator")
                    row["launches"] = pk.seg_bincount.launches - before
                    row["d2h_bytes"] = STATS.d2h.get("seg_bincount", 0) - d2h0
                    check(row["launches"] > 0, f"block query {q}: seg_bincount did not launch")
            check(got["cuda"] == got["cpu"], f"block query {q}: cuda matrix != cpu matrix")
            check(len(got["cuda"]["result"]) > 0, f"block query {q}: empty result")
            print(f"phase 6 query: {q} | {len(got['cuda']['result'])} series, cuda == cpu | "
                  f"{row['cuda_ms']:.1f} ms on the card ({row['launches']} seg_bincount "
                  f"launches, {row['d2h_bytes']} B device-to-host), {row['cpu_ms']:.1f} ms "
                  f"with the CPU accumulator", flush=True)
            res["query"].append(row)
    return res, (a, b)


STRUCTURAL = "{ duration > 998ms } >> { duration < 3ms }"


def trace_hex_set(tids) -> set:
    """(N, 4) uint32 trace-ID rows -> the set of their distinct hex IDs."""
    import numpy as np

    raw = np.ascontiguousarray(np.unique(tids, axis=0).astype(">u4")).tobytes()
    return {raw[i:i + 16].hex() for i in range(0, len(raw), 16)}


def db_phase(seed: int, a, b, root: str, queries: list, plan_of) -> dict:
    """Phase 7, the storage engine: TempoDB over the two blocks that phase
    6 wrote on the card (copied into root/blocks), every answer held
    against a numpy oracle computed from the generated batches. Returns
    its numbers."""
    import numpy as np

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import SearchRequest
    from tempo_tpu_torch.encoding.vtpu.colcache import shared_cache
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.columnar import VT_INT, VT_STR, SpanBatch
    from tempo_tpu_torch.ops import pallas_kernels as pk

    tenant = "smoke"
    res: dict = {}
    t_phase = time.perf_counter()
    db = TempoDB(DBConfig(backend="local", backend_path=os.path.join(root, "blocks"),
                          wal_path=os.path.join(root, "wal")), device="cuda")
    print(f"phase 7 TempoDB on {db.device}", flush=True)

    # ------------------------------------------------------------ 1. poll
    t0 = time.perf_counter()
    db.poll_now()
    metas = db.blocklist.metas(tenant)
    res["poll_ms"] = (time.perf_counter() - t0) * 1e3
    check(len(metas) == 2 and sorted(m.total_spans for m in metas) == [a.num_spans, b.num_spans],
          f"phase 7 poll: {len(metas)} blocks")
    dict_bytes = sum(os.path.getsize(os.path.join(root, "blocks", tenant, m.block_id, "dict.bin"))
                     for m in metas)
    print(f"phase 7 poll: 2 blocks ({', '.join(str(m.total_spans) for m in metas)} spans) | "
          f"{res['poll_ms']:.1f} ms", flush=True)

    # ------------------------------------------------------------ 2. find
    rng = np.random.default_rng(seed + 7)
    ids_a = a.cols["trace_id"][a.trace_boundaries()[0]]
    ids_b = b.cols["trace_id"][b.trace_boundaries()[0]]
    copies = ids_a[::8]  # every 8th trace of A is repeated in B
    present = np.concatenate([ids_a[rng.choice(len(ids_a), 80, replace=False)],
                              copies[rng.choice(len(copies), 20, replace=False)],
                              ids_b[rng.choice(len(ids_b), 100, replace=False)]])
    known = {bytes(t) for t in np.concatenate([ids_a, ids_b])}
    absent = [t for t in rng.integers(0, 2**32, (260, 4), dtype=np.uint32)
              if bytes(t) not in known][:200]
    check(len(absent) == 200, "phase 7: could not draw 200 absent IDs")
    t0 = time.perf_counter()
    for limbs in present:
        tid = limbs.astype(">u4").tobytes()
        t = db.find(tenant, tid)
        check(t is not None and t.trace_id == tid and t.span_count() == 8,
              "phase 7 find: a present trace was not found whole")
    res["find_present_ms"] = (time.perf_counter() - t0) / len(present) * 1e3
    t0 = time.perf_counter()
    for limbs in absent:
        check(db.find(tenant, limbs.astype(">u4").tobytes()) is None, "phase 7 find: absent found")
    res["find_absent_ms"] = (time.perf_counter() - t0) / len(absent) * 1e3
    tid = copies[0].astype(">u4").tobytes()
    halves = [db.encoding_for(m.version).open_block(m, db.backend, db.cfg.block)
              .find_trace_by_id(tid) for m in metas]
    check(all(h is not None and h.span_count() == 8 for h in halves),
          "phase 7 find: a copied trace is not in both blocks")
    print(f"phase 7 find: 200 present found whole (20 of them copies held by both blocks, "
          f"combined), 200 absent -> None | {res['find_present_ms']:.2f} ms a present ID, "
          f"{res['find_absent_ms']:.3f} ms an absent one", flush=True)

    # ---------------------------------------------------------- 3. search
    u = SpanBatch.concat([a, b])  # oracle data: both blocks' rows, one dictionary
    d = u.dictionary
    cols, attrs = u.cols, u.attrs
    starts, dur = cols["start_unix_nano"], cols["duration_nano"]

    def attr_mask(key, value):
        m = np.zeros(u.num_spans, bool)
        hit = ((attrs["attr_key"] == d.get(key)) & (attrs["attr_vtype"] == VT_STR)
               & (attrs["attr_str"] == d.get(value)))
        m[attrs["attr_span"][hit]] = True
        return m

    w0, w1 = BASE_S + 8 * 60, BASE_S + 16 * 60  # the later half of A's batches
    svc_cart = cols["service"] == d.get("cart")
    searches = [
        ("service=cart", dict(tags={"service": "cart"}), svc_cart),
        ("service=cart name=db.query", dict(tags={"service": "cart", "name": "db.query"}),
         svc_cart & (cols["name"] == d.get("db.query"))),
        ("http.status_code=500", dict(tags={"http.status_code": "500"}),
         cols["http_status"] == 500),
        ("region=v7", dict(tags={"region": "v7"}), attr_mask("region", "v7")),
        ("duration>=990ms", dict(min_duration_ns=990_000_000), dur >= 990_000_000),
        ("window", dict(start_seconds=w0, end_seconds=w1),
         (starts + dur >= np.uint64(w0 * 10**9)) & (starts <= np.uint64(w1 * 10**9))),
        ("service=no-such-service", dict(tags={"service": "no-such-service"}),
         np.zeros(u.num_spans, bool)),
    ]
    oracle = {label: trace_hex_set(cols["trace_id"][m]) for label, _, m in searches}

    def search(label, kw, limit):
        t0 = time.perf_counter()
        r = db.search(tenant, SearchRequest(limit=limit, **kw))
        ms = (time.perf_counter() - t0) * 1e3
        hits = [h.trace_id_hex for h in r.traces]
        want = oracle[label]
        if limit:
            check(len(hits) == min(limit, len(want)) and set(hits) <= want,
                  f"phase 7 search {label} limit {limit}: hits outside the oracle")
        else:
            check(len(hits) == len(set(hits)) and set(hits) == want,
                  f"phase 7 search {label}: {len(hits)} hits, oracle {len(want)}")
        return dict(ms=ms, hits=len(hits), inspected_bytes=r.inspected_bytes,
                    decoded_bytes=r.decoded_bytes, pruned_row_groups=r.pruned_row_groups,
                    coalesced_reads=r.coalesced_reads, inspected_traces=r.inspected_traces), r

    res["search"] = []
    for label, kw, _ in searches:
        for limit in (20, 0):
            shared_cache().clear()
            cold, r = search(label, kw, limit)
            warm, _ = search(label, kw, limit)
            if label.startswith("service=no-such"):
                # the dictionary alone answers: no index and no page is read
                check(r.traces == [] and r.decoded_bytes == 0 and r.inspected_bytes == dict_bytes,
                      f"phase 7 search {label}: read {r.inspected_bytes} B, dictionaries "
                      f"{dict_bytes} B")
            res["search"].append(dict(search=label, limit=limit, oracle=len(oracle[label]),
                                      cold=cold, warm=warm))
            print(f"phase 7 search {label} limit {limit}: {cold['hits']} hits (oracle "
                  f"{len(oracle[label])}) | cold {cold['ms']:.1f} ms, inspected "
                  f"{cold['inspected_bytes']} B, decoded {cold['decoded_bytes']} B, pruned "
                  f"{cold['pruned_row_groups']} row groups, {cold['coalesced_reads']} reads "
                  f"coalesced | warm {warm['ms']:.1f} ms, inspected {warm['inspected_bytes']} B, "
                  f"decoded {warm['decoded_bytes']} B, pruned {warm['pruned_row_groups']}, "
                  f"coalesced {warm['coalesced_reads']}", flush=True)

    # ------------------------------------------------------------ 4. tags
    t0 = time.perf_counter()
    names = db.search_tags(tenant)
    wk = {"service.name", "name", "http.method", "http.url", "http.status_code"}
    check(names == wk | {d[int(c)] for c in np.unique(attrs["attr_key"])},
          f"phase 7 search_tags: {sorted(names)}")
    statuses = db.search_tag_values(tenant, "http.status_code")
    check(statuses == {str(int(v)) for v in np.unique(cols["http_status"]) if v},
          f"phase 7 tag values http.status_code: {sorted(statuses)}")
    regions = db.search_tag_values(tenant, "region")
    rk = attrs["attr_key"] == d.get("region")
    want = {d[int(c)] for c in np.unique(attrs["attr_str"][rk & (attrs["attr_vtype"] == VT_STR)])}
    want |= {str(int(v)) for v in np.unique(attrs["attr_num"][rk & (attrs["attr_vtype"] == VT_INT)])}
    check(regions == want, "phase 7 tag values region != oracle")
    res["tags_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"phase 7 tags: {len(names)} names, {len(statuses)} http.status_code values, "
          f"{len(regions)} region values, equal to the oracle | {res['tags_ms']:.0f} ms", flush=True)

    # --------------------------------------------------------- 5. TraceQL
    def per_trace_count(mask):
        """Trace IDs whose rows hold more than one masked span, counting
        both blocks' rows: before compaction each block's partial counts
        its own copy of a repeated trace, and the partials add."""
        order = np.lexsort(cols["trace_id"].T[::-1])
        tid_sorted = cols["trace_id"][order]
        new = np.ones(len(order), bool)
        new[1:] = (tid_sorted[1:] != tid_sorted[:-1]).any(axis=1)
        counts = np.bincount(np.cumsum(new) - 1, weights=mask[order].astype(np.int64))
        return trace_hex_set(tid_sorted[new][counts > 1])

    tql = [
        ('{ resource.service.name = "cart" && duration > 100ms }', 0,
         trace_hex_set(cols["trace_id"][svc_cart & (dur > 100_000_000)])),
        ("{ span.http.status_code = 500 } | count() > 1", 0,
         per_trace_count(cols["http_status"] == 500)),
        ("{ } | by(resource.service.name)", 20, None),
        (STRUCTURAL, 0, None),
    ]

    def traceql(q, limit):
        stats: dict = {}
        t0 = time.perf_counter()
        out = db.traceql_search(tenant, q, limit=limit, stats=stats)
        ms = (time.perf_counter() - t0) * 1e3
        branch = "object engine" if "prunedRowGroups" in stats else "vectorized"
        return out, dict(ms=ms, results=len(out), branch=branch,
                         inspected_traces=stats.get("inspectedTraces", 0),
                         inspected_bytes=stats.get("inspectedBytes", 0))

    res["traceql"] = []
    structural_ids = None
    for q, limit, want in tql:
        out, row = traceql(q, limit)
        got = {r.trace_id_hex for r in out}
        if want is not None:
            check(got == want, f"phase 7 traceql {q}: {len(got)} traces, oracle {len(want)}")
        elif limit:
            check(len(out) == limit, f"phase 7 traceql {q}: {len(out)} results")
        if q == STRUCTURAL:
            check(row["branch"] == "object engine" and out,
                  f"phase 7 structural query: {row['branch']}, {len(out)} results")
            structural_ids = got
        else:
            check(row["branch"] == "vectorized", f"phase 7 traceql {q}: {row['branch']}")
        res["traceql"].append(dict(query=q, limit=limit, **row))
        print(f"phase 7 traceql {q}: {len(out)} traces{' = oracle' if want is not None else ''}, "
              f"{row['branch']} | {row['ms']:.0f} ms, {row['inspected_traces']} traces "
              f"{'fetched as candidates' if row['branch'] == 'object engine' else 'inspected'}",
              flush=True)

    # --------------------------------------------------------- 6. compact
    ccfg = db.cfg.compaction
    while len({m.end_time // ccfg.window_s for m in metas}) > 1:
        ccfg.window_s *= 2
    print(f"phase 7 compaction window_s = {ccfg.window_s} (block end times "
          f"{sorted(m.end_time for m in metas)})", flush=True)
    n_distinct = len(np.unique(np.concatenate([ids_a, ids_b]), axis=0))
    t0 = time.perf_counter()
    jobs = db.compact_once(tenant)
    res["compact_ms"] = (time.perf_counter() - t0) * 1e3
    (out_meta,) = db.blocklist.metas(tenant)
    check(jobs == 1 and out_meta.total_spans == a.num_spans + b.num_spans - copies.shape[0] * 8
          and out_meta.total_objects == n_distinct,
          f"phase 7 compaction: {jobs} jobs, {out_meta.total_spans} spans, "
          f"{out_meta.total_objects} traces")
    print(f"phase 7 compact_once: 1 job, {out_meta.total_spans} spans, {out_meta.total_objects} "
          f"traces, level {out_meta.compaction_level} | {res['compact_ms']:.0f} ms "
          f"(merge_path auto, sketch plane on {db.device})", flush=True)
    res["after_compaction"] = []
    for label, kw, _ in searches:
        shared_cache().clear()
        row, _ = search(label, kw, 0)
        res["after_compaction"].append(dict(search=label, **row))
    cold_ms = ", ".join(f"{r['ms']:.0f}" for r in res["after_compaction"])
    print(f"phase 7 after compaction: the {len(searches)} unbounded searches equal their oracles "
          f"(union of A's and B's answers) | {cold_ms} ms cold", flush=True)
    out, row = traceql(STRUCTURAL, 0)
    check(row["branch"] == "vectorized" and {r.trace_id_hex for r in out} == structural_ids,
          f"phase 7 structural query after compaction: {row['branch']}, {len(out)} results")
    res["traceql"].append(dict(query=STRUCTURAL, limit=0, after_compaction=True, **row))
    print(f"phase 7 traceql {STRUCTURAL} after compaction: {len(out)} traces, vectorized, the "
          f"object engine's traces | {row['ms']:.0f} ms", flush=True)

    # --------------------------------------------------------- 7. metrics
    res["query"] = []
    for q in queries:
        plan = plan_of(q)
        got, row = {}, {"query": q}
        for dev in ("cuda", "cpu"):
            before = pk.seg_bincount.launches
            t0 = time.perf_counter()
            merged = M.new_wire()
            for m in db.blocklist.metas(tenant):
                blk = db.encoding_for(m.version).open_block(m, db.backend, db.cfg.block)
                M.merge_wire(merged, M.evaluate_block(plan, blk, device=dev).to_wire(), plan)
            got[dev] = M.finalize_matrix(plan, merged)
            row[f"{dev}_ms"] = (time.perf_counter() - t0) * 1e3
            if dev == "cuda":
                row["launches"] = pk.seg_bincount.launches - before
                check(row["launches"] > 0, f"phase 7 query {q}: seg_bincount did not launch")
        check(got["cuda"] == got["cpu"] and got["cpu"]["result"],
              f"phase 7 query {q}: cuda matrix != cpu matrix")
        res["query"].append(row)
        print(f"phase 7 query: {q} | {len(got['cpu']['result'])} series, cuda == cpu | "
              f"{row['cuda_ms']:.1f} ms on the card ({row['launches']} seg_bincount launches), "
              f"{row['cpu_ms']:.1f} ms with the CPU accumulator", flush=True)

    # ------------------------------------------------------------- 8. WAL
    parts = [chain_parents(synth.make_batch(1024, 8, seed=seed * 1000 + 500 + i,
                                            base_time_ns=(BASE_S + 60 * i) * 10**9))
             for i in range(16)]
    wal_tenant = "smoke-wal"
    t0 = time.perf_counter()
    wal_blk = db.wal.new_block(wal_tenant)
    for p in parts:
        wal_blk.append(p)
    res["wal_append_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    (replayed,) = [w for w in db.wal.rescan_blocks() if w.block_id == wal_blk.block_id]
    res["wal_replay_ms"] = (time.perf_counter() - t0) * 1e3
    block_id = str(uuid.uuid4())
    t0 = time.perf_counter()
    wal_meta = db.write_wal_block(wal_tenant, replayed, block_id=block_id)
    res["write_wal_block_ms"] = (time.perf_counter() - t0) * 1e3
    cpu_db = TempoDB(DBConfig(backend="local", backend_path=os.path.join(root, "cpu")),
                     device="cpu")
    cpu_db.write_batch(wal_tenant, SpanBatch.concat(parts).sorted_by_trace(), block_id=block_id)
    check_same_blocks(block_objects(os.path.join(root, "blocks"), wal_tenant, block_id, True),
                      block_objects(os.path.join(root, "cpu"), wal_tenant, block_id, True),
                      "phase 7 write_wal_block vs write_batch on the cpu")
    check(wal_meta.total_spans == 1 << 17 and replayed.num_segments() == 16,
          f"phase 7 wal: {wal_meta.total_spans} spans, {replayed.num_segments()} segments")
    print(f"phase 7 wal: 16 segments of 8192 spans appended ({res['wal_append_ms']:.0f} ms), "
          f"found by rescan_blocks ({res['wal_replay_ms']:.0f} ms), replayed and completed on "
          f"{db.device} "
          f"({res['write_wal_block_ms']:.0f} ms): byte-equal to write_batch of the same "
          f"spans on the cpu", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_script = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import numpy as np

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.entry import entry
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.util.devicetiming import STATS

    dev = torch.device("cuda")
    seed = args.seed
    kernels = {}  # name -> JSON record

    # ---------------------------------------------------------------- 0
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"phase 0 device: {name} x{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvidia-smi: {smi}", flush=True)

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    so = _build.build()
    lib = _build.lib()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s ({os.path.basename(so)})", flush=True)
    ptxas = _build.ptxas_report()
    for kname, r in sorted(ptxas.items()):
        print(f"phase 1 ptxas {kname}: {r.get('registers')} registers, "
              f"{r.get('smem_static')} B static smem, spills {r.get('spill_stores')} B stored / "
              f"{r.get('spill_loads')} B loaded", flush=True)
    print("phase 1 dynamic smem: seg_bincount_kernel<weighted,0> (dense) 4 B a slot "
          "(n_slots <= 49,152: up to 196,608 B, opted in above 48 KiB), <weighted,1> (hashed) "
          "65,536 B; in_set_scan_kernel 4 B a code of its columns", flush=True)

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    # data shared by phases 2, 4 and 5: 64 batches of 8192 traces x 8 spans,
    # one minute apart (2**22 spans)
    t0 = time.perf_counter()
    batches = [synth.make_batch(8192, 8, seed=seed * 1000 + i,
                                base_time_ns=(BASE_S + 60 * i) * 10**9)
               for i in range(64)]
    print(f"data: {sum(b.num_spans for b in batches)} spans in {len(batches)} batches "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    queries = [
        "{ } | rate() by (resource.service.name)",
        "{ status = error } | count_over_time() by (name)",
        "{ } | quantile_over_time(duration, 0.5, 0.99) by (resource.service.name)",
    ]

    def plan_of(q):
        return M.compile_metrics_plan(q, BASE_S, BASE_S + 3600, 60, max_series=64)

    # ---------------------------------------------------------------- 2
    rng = np.random.default_rng(seed)

    def seg_launch(s_d, w_d, n_slots, out):
        """The C entry point alone, adding into `out`."""
        w_ptr = None if w_d is None else w_d.data_ptr()

        def go():
            _build.check(lib.tt_seg_bincount(s_d.data_ptr(), w_ptr, s_d.numel(), n_slots,
                                             out.data_ptr(), stream()), "seg_bincount")
        return go

    def seg_equal(label, s_d, n_slots, w_d):
        want = pk._seg_bincount_plain(s_d, n_slots, w_d)
        got = pk.seg_bincount(s_d, n_slots, weights=w_d)
        check(torch.equal(got, want), f"seg_bincount {label}: kernel != plain")
        pk.seg_bincount_into(got, s_d, n_slots, w_d)  # accumulates onto the first counts
        check(torch.equal(got, 2 * want), f"seg_bincount_into {label}: kernel != 2 x plain")
        return want

    seg_times = {}

    def seg_case(label, slots_np, n_slots, w_np):
        s_d = torch.from_numpy(slots_np).to(dev)
        w_d = None if w_np is None else torch.from_numpy(w_np).to(dev)
        seg_equal(label, s_d, n_slots, w_d)
        n = len(slots_np)
        out = torch.zeros(n_slots, dtype=torch.int64, device=dev)
        ms = kernel_ms(torch, [seg_launch(s_d, w_d, n_slots, out)])
        # the main path's call: the accumulator's vector already exists
        path = path_ms(torch, lambda: pk.seg_bincount_into(out, s_d, n_slots, w_d))
        plain = path_ms(torch, lambda: pk._seg_bincount_plain(s_d, n_slots, w_d))
        live = (s_d >= 0) & (s_d < n_slots)
        s_live = s_d[live].to(torch.int64)
        w_live = None if w_d is None else w_d[live].to(torch.float64)
        libms = path_ms(torch, lambda: torch.bincount(s_live, weights=w_live, minlength=n_slots))
        # the work this input needs: every row read once, and each counter
        # it touches read and written once (the kernel adds into `out`)
        touched = int(torch.unique(s_live).numel())
        nbytes = n * 4 * (1 if w_np is None else 2) + touched * 16
        bnd, by = bound_ms(nbytes, n)
        seg_times[label] = dict(
            shape=f"N={n} n_slots={n_slots} weights={'yes' if w_np is not None else 'no'} "
                  f"touched={touched}",
            max_abs_err=0, ms=ms, path_ms=path, plain_ms=plain, bound_ms=bnd, bound_by=by,
            library_ms=libms)
        print(f"phase 2 seg_bincount {label}: equal | kernel {ms:.4f} ms "
              f"({bnd / ms:.0%} of bound), path {path:.4f} ms, plain {plain:.4f} ms, "
              f"torch.bincount {libms:.4f} ms, bound {bnd:.4f} ms ({by}; {touched} slots "
              f"touched)", flush=True)

    n22 = 1 << 22
    for n_slots in (3840, 990_720, 1 << 22):
        slots = rng.integers(-64, n_slots + 64, n22).astype(np.int32)
        w = rng.integers(1, 9, n22).astype(np.int32)
        seg_case(f"synthetic N=2^22 n_slots={n_slots} weighted", slots, n_slots, w)
        seg_case(f"synthetic N=2^22 n_slots={n_slots}", slots, n_slots, None)
    # the main path's own flush inputs: 16 batches (2**20 spans) of each query
    for qi, q in enumerate(queries):
        plan = plan_of(q)
        series = M.SeriesTable(plan.max_series)
        raw = np.concatenate([M.eval_batch(plan, b, b.dictionary, series).slots
                              for b in batches[:16]])
        slots, w = pk.compress_slot_runs(raw)
        seg_case(("rate", "count", "quantile")[qi] + " flush", slots.astype(np.int32),
                 plan.n_slots, w)
        print(f"  (query {qi}: {len(raw)} rows -> {len(slots)} entries, n_slots={plan.n_slots})",
              flush=True)

    # edge shapes, kernel against plain: n_slots at and around each arm's
    # threshold, N from 1 row to 2**20, weights negative and >= 2**16,
    # every row dropped, and inputs that are views at an odd offset
    edge_slots = (1, 6143, 6144, 6145, (1 << 15) - 1, 1 << 15, (1 << 15) + 1,
                  49151, 49152, 49153, 990_720, 1 << 22)
    n_edge = 0
    big_w = np.array([65535, 65536, -65535, -65536, 2**31 - 1, -2**31, 70000, -7], np.int32)
    for n_slots in edge_slots:
        for n in (1, 3, 4097, 1 << 20):
            s_np = rng.integers(-3, n_slots + 3, n + 2).astype(np.int32)
            w_np = rng.integers(-9, 10, n + 2).astype(np.int32)
            w_np[::7] = big_w[np.arange(len(w_np[::7])) % len(big_w)]
            s_d, w_d = torch.from_numpy(s_np).to(dev), torch.from_numpy(w_np).to(dev)
            seg_equal(f"edge n_slots={n_slots} N={n}", s_d[:n], n_slots, None)
            seg_equal(f"edge n_slots={n_slots} N={n} weighted", s_d[:n], n_slots, w_d[:n])
            seg_equal(f"edge n_slots={n_slots} N={n} views +1/+2", s_d[1:n + 1], n_slots,
                      w_d[2:n + 2])
            dropped = torch.where(s_d[:n] >= 0, s_d[:n] + n_slots, s_d[:n])
            check(not bool(seg_equal(f"edge n_slots={n_slots} N={n} all dropped", dropped,
                                     n_slots, w_d[:n]).any()), "all-dropped rows counted")
            n_edge += 4
    print(f"phase 2 seg_bincount edge shapes: {n_edge} cases equal "
          f"(n_slots {', '.join(map(str, edge_slots))}; N 1, 3, 4097, 2^20)", flush=True)

    C, S, n_pad = 4, 8, 1 << 20
    cols_np = [rng.integers(0, 40, n_pad).astype(np.uint32) for _ in range(C)]
    cols_np[1][:64] = 0xFFFFFFFF  # a column value equal to the code-set padding
    cols = [torch.from_numpy(c) for c in cols_np]
    sets_ = [torch.from_numpy(rng.choice(40, size=s, replace=False).astype(np.uint32))
             for s in (8, 5, 8, 3)]

    def in_set_equal(label, cols_h, sets_h, n_pad):
        """Wrapper on the card (kernel) against the wrapper on the CPU (plain)."""
        got = pk.in_set_scan([c.to(dev) for c in cols_h], [s.to(dev) for s in sets_h],
                             n_pad).cpu()
        check(torch.equal(got, pk.in_set_scan(cols_h, sets_h, n_pad)),
              f"in_set_scan {label}: kernel != plain")
        return got

    for n in (n_pad, n_pad - 777):
        in_set_equal(f"n={n}", [c[:n] for c in cols], sets_, n_pad)
    mixed_np = [rng.integers(0, 40, n_pad + 9).astype(dt)
                for dt in (np.uint32, np.uint16, np.int64, np.int16, np.uint8, np.int32)]
    mixed_np[3][:50] = -1  # int16 -1 is 0xFFFFFFFF as uint32
    mixed = [torch.from_numpy(c) for c in mixed_np]
    mixed_sets = [torch.from_numpy(rng.choice(40, size=s, replace=False).astype(np.uint32))
                  for s in (20, 30, 25, 33, 28, 31)]
    for n in (n_pad, n_pad - 5, 1000, 1):
        for off in (0, 1, 3):
            got = in_set_equal(f"mixed dtypes n={n} offset={off}",
                               [c[off:off + n] for c in mixed], mixed_sets, n_pad)
            check(not bool(got[n:].any()), "in_set_scan rows past n")
    nine = [mixed[i % 6][i:i + 5000] for i in range(9)]
    in_set_equal("C=9", nine, [mixed_sets[i % 6] for i in range(9)], 5120)
    u16 = torch.from_numpy(np.full(n_pad, 500, np.uint16))
    check(bool(in_set_equal("uint16", [u16], [torch.tensor([500])], n_pad).all()),
          "in_set_scan uint16 column")
    check(not bool(in_set_equal("sentinel set", [torch.arange(n_pad)],
                                [torch.tensor([int(pk.NO_MATCH_CODE)])], n_pad).any()),
          "in_set_scan sentinel code set")
    print("phase 2 in_set_scan: C=4 S=8 n_pad=2^20 (full and ragged); uint32/uint16/int64/"
          "int16/uint8/int32 columns at offsets 0, 1, 3 with n = n_pad, n_pad-5, 1000, 1; C=9; "
          "uint16; sentinel: equal", flush=True)

    lo_b, hi_b = (7 << 32) | 0xFFFFFFFF, (9 << 32)
    v = rng.integers(0, 12 << 32, n_pad, dtype=np.int64)
    v[:6] = [lo_b, lo_b - 1, lo_b + 1, hi_b, hi_b - 1, hi_b + 1]
    vt = torch.from_numpy(v)
    for n in (n_pad, n_pad - 333):
        got = pk.u64_range_scan(vt[:n].to(dev), lo_b, hi_b, n_pad).cpu()
        want = pk.u64_range_scan(vt[:n], lo_b, hi_b, n_pad)
        check(torch.equal(got, want), f"u64_range_scan n={n}: kernel != plain")
    print("phase 2 u64_range_scan: n_pad=2^20, bounds on the limb boundary: equal", flush=True)

    # ---------------------------------------------------------------- 3 + 4
    for k in (pk.seg_bincount, pk.in_set_scan, pk.u64_range_scan):
        k.launches = 0

    fn, ex = entry(device="cuda", n_rows=1 << 22)
    out = fn(*ex)  # first call: allocator and library warm-up
    torch.cuda.synchronize()
    step_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*ex)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    fn_cpu, ex_cpu = entry(device="cpu", n_rows=1 << 22)
    t0 = time.perf_counter()
    ref = fn_cpu(*ex_cpu)
    cpu_s = time.perf_counter() - t0
    for key in ("perm", "keep", "n_rows", "n_traces", "bloom", "hll", "cm"):
        check(torch.equal(out[key].cpu(), ref[key]), f"compaction {key}: cuda != cpu")
    print(f"phase 3 compaction: 2^22 rows, n_rows={int(out['n_rows'])} "
          f"n_traces={int(out['n_traces'])}, cuda == cpu on perm/keep/n_rows/n_traces/bloom/"
          f"hll/cm | step {statistics.median(step_s) * 1e3:.2f} ms (median of 3; "
          f"{', '.join(f'{s * 1e3:.2f}' for s in step_s)}), cpu {cpu_s * 1e3:.0f} ms", flush=True)

    def run_query(q, device):
        plan = plan_of(q)
        t0 = time.perf_counter()
        acc = M.make_accumulator(plan, device=device)
        for b in batches:
            acc.add(M.eval_batch(plan, b, b.dictionary, acc.series), b)
        merged = M.new_wire()
        M.merge_wire(merged, acc.to_wire(), plan)
        matrix = M.finalize_matrix(plan, merged)
        return matrix, time.perf_counter() - t0, acc

    query_ms = []
    for q in queries:
        before = pk.seg_bincount.launches
        d2h_before = STATS.d2h.get("seg_bincount", 0)
        got, wall, acc = run_query(q, "cuda")
        launches = pk.seg_bincount.launches - before
        d2h = STATS.d2h.get("seg_bincount", 0) - d2h_before
        check(isinstance(acc, M.DeviceAccumulator), "cuda query did not take the device path")
        check(launches > 0, f"{q}: seg_bincount did not launch")
        want, cpu_wall, _ = run_query(q, "cpu")
        check(got == want, f"{q}: cuda matrix != cpu matrix")
        check(len(got["result"]) > 0, f"{q}: empty result")
        query_ms.append(wall * 1e3)
        print(f"phase 4 metrics: {q} | {len(got['result'])} series, cuda == cpu | "
              f"query {wall * 1e3:.1f} ms, {launches} seg_bincount launches, "
              f"{d2h} B device-to-host ({d2h / (acc.plan.n_slots * 8):g} count vectors), "
              f"cpu pipeline {cpu_wall * 1e3:.1f} ms", flush=True)
    check(pk.seg_bincount.launches > 0, "main path: seg_bincount never launched")
    kernels["seg_bincount"] = dict(seg_times["quantile flush"],
                                   launches=pk.seg_bincount.launches,
                                   flush_ms={k.split()[0]: seg_times[k]["ms"]
                                             for k in ("rate flush", "count flush",
                                                       "quantile flush")})

    # ---------------------------------------------------------------- 5
    for k in (pk.seg_bincount, pk.in_set_scan, pk.u64_range_scan):
        k.launches = 0
    cat = {k: np.concatenate([b.cols[k] for b in batches])
           for k in ("service", "name", "http_method", "http_status", "duration_nano")}
    d = batches[0].dictionary  # make_batch builds the same dictionary every time
    want_codes = [
        np.array([d.get("frontend"), d.get("cart")], np.uint32),
        np.array([d.get("db.query"), d.get("cache.get"), d.get("render")], np.uint32),
        np.array([d.get("GET"), d.get("POST")], np.uint32),
        np.array([500], np.uint32),
    ]
    n_rows = len(cat["service"])
    scan_keys = ("service", "name", "http_method", "http_status")
    scan_cols = [torch.from_numpy(cat[k]).to(dev) for k in scan_keys]
    # the codes come from the host dictionary, as a search caller has them
    scan_sets = [torch.from_numpy(c) for c in want_codes]
    hit = pk.in_set_scan(scan_cols, scan_sets, n_rows).cpu().numpy()
    oracle = np.ones(n_rows, bool)
    for k, c in zip(scan_keys, want_codes):
        oracle &= np.isin(cat[k].astype(np.uint32), c)
    check(np.array_equal(hit, oracle), "scan path: in_set_scan != numpy oracle")
    lo_ns, hi_ns = 100_000_000, 500_000_000
    dur = torch.from_numpy(cat["duration_nano"].view(np.int64)).to(dev)
    rng_hit = pk.u64_range_scan(dur, lo_ns, hi_ns, n_rows).cpu().numpy()
    check(np.array_equal(rng_hit, (cat["duration_nano"] >= lo_ns) & (cat["duration_nano"] <= hi_ns)),
          "scan path: u64_range_scan != numpy oracle")
    scan_launches = {"in_set_scan": pk.in_set_scan.launches,
                     "u64_range_scan": pk.u64_range_scan.launches}
    for k, n in scan_launches.items():
        check(n > 0, f"scan path: {k} never launched")
    print(f"phase 5 scan: {n_rows} spans, service/name/method/status in-set -> "
          f"{int(hit.sum())} rows, duration in [100ms, 500ms] -> {int(rng_hit.sum())} rows; "
          f"both equal the numpy oracle", flush=True)

    # time the scan kernels at the scan path's shapes, each launch on one of
    # three copies of the columns (> 2 x L2), as a scan over resident
    # columns finds them: in HBM
    codes = pk._code_table(scan_sets).to(dev)
    s_pad = codes.shape[1]
    widths = (ctypes.c_int32 * 4)(*(c.element_size() for c in scan_cols))
    copies = [scan_cols] + [[c.view(torch.uint8).clone().view(c.dtype) for c in scan_cols]
                            for _ in range(2)]
    in_set_outs = [torch.empty(n_rows, dtype=torch.bool, device=dev) for _ in copies]

    def in_set_launch(cols_, out_):
        ptrs = (ctypes.c_void_p * 4)(*(c.data_ptr() for c in cols_))

        def go():
            _build.check(lib.tt_in_set_scan(ptrs, widths, 0, 4, codes.data_ptr(), s_pad, n_rows,
                                            n_rows, out_.data_ptr(), stream()), "in_set_scan")
        return go

    in_set_launches = [in_set_launch(c, o) for c, o in zip(copies, in_set_outs)]
    in_set_launches[0]()
    check(np.array_equal(in_set_outs[0].cpu().numpy(), oracle),
          "in_set_scan kernel at the scan shape != numpy oracle")
    ms = kernel_ms(torch, in_set_launches)
    ms_warm = kernel_ms(torch, in_set_launches[:1])
    path = path_ms(torch, lambda: pk.in_set_scan(scan_cols, scan_sets, n_rows))
    plain = path_ms(torch, lambda: pk._in_set_plain(scan_cols, codes, n_rows))
    mat = torch.stack([pk.u32_bits(c) for c in scan_cols])

    def isin_chain():
        m = torch.isin(mat[0], codes[0])
        for c in range(1, 4):
            m &= torch.isin(mat[c], codes[c])
        return m

    libms = path_ms(torch, isin_chain)
    del copies, mat
    in_bytes = sum(c.numel() * c.element_size() for c in scan_cols)
    bnd, by = bound_ms(in_bytes + codes.numel() * 4 + n_rows, 4 * s_pad * n_rows)
    kernels["in_set_scan"] = dict(shape=f"C=4 S={s_pad} n_pad={n_rows} "
                                  f"({'/'.join(str(c.dtype).split('.')[1] for c in scan_cols)})",
                                  max_abs_err=0, ms=ms, ms_l2_warm=ms_warm, path_ms=path,
                                  plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=libms,
                                  launches=scan_launches["in_set_scan"])
    print(f"phase 5 in_set_scan timing: kernel {ms:.4f} ms ({bnd / ms:.0%} of bound; "
          f"{ms_warm:.4f} ms with its inputs in L2), path {path:.4f} ms, plain {plain:.4f} ms, "
          f"torch.isin chain {libms:.4f} ms, bound {bnd:.4f} ms ({by})", flush=True)

    bounds = (lo_ns >> 32, lo_ns & 0xFFFFFFFF, hi_ns >> 32, hi_ns & 0xFFFFFFFF)
    limbs = [pk.range_limbs(dur, n_rows) for _ in range(3)]
    range_outs = [torch.empty(n_rows, dtype=torch.bool, device=dev) for _ in limbs]

    def range_launch(hi, lo, out_):
        def go():
            _build.check(lib.tt_u64_range_scan(hi.data_ptr(), lo.data_ptr(), lo_ns, hi_ns,
                                               n_rows, n_rows, out_.data_ptr(), stream()),
                         "u64_range_scan")
        return go

    range_launches = [range_launch(hi, lo, o) for (hi, lo), o in zip(limbs, range_outs)]
    range_launches[0]()
    hi, lo = limbs[0]
    check(torch.equal(range_outs[0], pk._range_plain(hi, lo, bounds, n_rows)),
          "u64_range_scan at the scan shape: kernel != plain")
    ms = kernel_ms(torch, range_launches)
    ms_warm = kernel_ms(torch, range_launches[:1])
    path = path_ms(torch, lambda: pk.u64_range_scan(dur, lo_ns, hi_ns, n_rows))
    plain = path_ms(torch, lambda: pk._range_plain(hi, lo, bounds, n_rows))
    del limbs
    bnd, by = bound_ms(9 * n_rows, 2 * n_rows)
    kernels["u64_range_scan"] = dict(shape=f"n_pad={n_rows}", max_abs_err=0, ms=ms,
                                     ms_l2_warm=ms_warm, path_ms=path, plain_ms=plain,
                                     bound_ms=bnd, bound_by=by, library_ms=None,
                                     launches=scan_launches["u64_range_scan"])
    print(f"phase 5 u64_range_scan timing: kernel {ms:.4f} ms ({bnd / ms:.0%} of bound; "
          f"{ms_warm:.4f} ms with its inputs in L2), path {path:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bnd:.4f} ms ({by})", flush=True)

    # ---------------------------------------------------------------- 6
    for k in (pk.seg_bincount, pk.in_set_scan, pk.u64_range_scan):
        k.launches = 0
    t0 = time.perf_counter()
    before_s = t0 - t_script
    db_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_db_")
    blocks, (a, b) = blocks_phase(seed, queries, plan_of, os.path.join(db_dir.name, "blocks"))
    blocks["launches"] = {"seg_bincount": pk.seg_bincount.launches,
                          "in_set_scan": pk.in_set_scan.launches,
                          "u64_range_scan": pk.u64_range_scan.launches}
    check(pk.seg_bincount.launches > 0, "block path: seg_bincount never launched")
    blocks["phase_s"] = time.perf_counter() - t0
    blocks["phases_0_5_s"] = before_s
    kernels["seg_bincount"]["launches_block_path"] = pk.seg_bincount.launches
    print(f"phase 6 blocks: {blocks['phase_s']:.1f} s (phases 0-5: {before_s:.1f} s), "
          f"seg_bincount launched "
          f"{pk.seg_bincount.launches} times on the block path", flush=True)

    # ---------------------------------------------------------------- 7
    for k in (pk.seg_bincount, pk.in_set_scan, pk.u64_range_scan):
        k.launches = 0
    with db_dir:
        db = db_phase(seed, a, b, db_dir.name, queries, plan_of)
    db["launches"] = {"seg_bincount": pk.seg_bincount.launches,
                      "in_set_scan": pk.in_set_scan.launches,
                      "u64_range_scan": pk.u64_range_scan.launches}
    check(pk.seg_bincount.launches > 0, "storage engine path: seg_bincount never launched")
    kernels["seg_bincount"]["launches_db_path"] = pk.seg_bincount.launches
    print(f"phase 7 db: {db['phase_s']:.1f} s, seg_bincount launched "
          f"{pk.seg_bincount.launches} times on the storage engine's path", flush=True)

    replaces = {
        "seg_bincount": "tempo_tpu/ops/pallas_kernels.py:194",
        "in_set_scan": "tempo_tpu/ops/pallas_kernels.py:55",
        "u64_range_scan": "tempo_tpu/ops/pallas_kernels.py:152",
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": "tempo_tpu_torch/csrc/kernels.cu",
         "replaces": replaces[k], **kernels[k]}
        for k in ("seg_bincount", "in_set_scan", "u64_range_scan")
    ], "ptxas": ptxas, "compaction_step_ms": statistics.median(step_s) * 1e3,
        "query_ms": query_ms, "blocks": blocks, "db": db,
        "script_s": time.perf_counter() - t_script}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
