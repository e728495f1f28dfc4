#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tempo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure exits non-zero):

0. device: card name, count, torch/CUDA versions, nvidia-smi name and
   power limit;
1. build: nvcc builds csrc/kernels.cu (the three Pallas kernels' ports),
   csrc/codec_kernels.cu (the batched rle_change_mask and dbp_pack of
   the device page encode, dbp_decode of the device page decode,
   compiled_metrics of the compiled query tier and the device tier's
   resident_rle_scan, resident_dct_scan and resident_dbp_scan, each also
   batched over page tables) and csrc/graph_sketch_kernels.cu
   (hll_update and cm_update, the sketch updates of compaction, the block
   writer and the generator's service graphs, and root_path_sums, the
   critical path's pointer doubling) and csrc/tail_kernels.cu (tail_fold
   and tail_scan, the ingest tail's standing fold and live-tail search
   mask), rle_cols_hit (the fused run-length decode + in-set scan of the
   mesh and batched searches) in csrc/codec_kernels.cu, one nvcc a
   source, in parallel, and ptxas reports each
   kernel's registers,
   static shared memory and spills;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, bit for bit, at the main path's shapes and at edge shapes (the
   page-encode kernels over mixed page tables; the codec kernels also
   against the host codec and a numpy interpreter; the resident scans
   over run tiles, dictionary sizes up to n/2 at 65,536 rows and every
   dbp width 0-64, the code set by value and above the by-value cap, and
   the batched ones over mixed page tables), and timed two
   ways:
   kernel time (device time alone: a CUDA graph of K back-to-back
   launches of the C entry point into outputs allocated and zeroed
   before the capture, replay time / K, median of 7 replays) and path
   time (CUDA events around one whole wrapper call as the main path
   makes it, median of 25), beside its plain version and one PyTorch
   library call where there is one (both timed as path time), and its
   bound (rle_change_mask and dbp_pack are timed after phase 6, at one
   row group's and one block's pages of its card write, with the
   writer's whole dispatch by host clock; dbp_decode after phase 8 on
   the inputs of phase 8's largest compiled dispatch with a dbp column and
   on phase 5's page, and the compiled dispatch as a whole, all its
   launches in one graph, on those inputs and on a copy with four query
   lanes, against the bound of the fused program's work; the resident
   scans after phase 10, at the largest resident page of each codec,
   and the batched ones at one search's stage-1 pages of each codec; the
   sketch kernels at the compaction step's 2**22 keys, at a generator
   push of 4,096 edge keys and hll_update at a block writer's flush of
   8,192 IDs; root_path_sums at 2**21 spans in chains of 8 and of 2,048
   a launch a round, and given the trace segments in one launch in chains
   of 8 and of 2,048, in-trace cycles and around a trace of three tiles,
   with the graph_critical_path dispatch around each, with and without
   the segments at the chains);
3. compaction: the flagship step (entry.entry) at 2**22 rows, bit-equal
   between the card and the CPU, timed in turns with the same step whose
   HLL and count-min updates are their torch-op versions (chip_smoke's
   own copy of the step), which must be bit-equal too;
4. metrics: three TraceQL query_range queries over 2**22 synthetic spans
   through the port's plan -> eval_batch -> accumulator -> wire ->
   matrix pipeline, equal between the card and the CPU, with each
   query's kernel launches and device-to-host bytes;
5. scan: in_set_scan and u64_range_scan over the same 2**22 spans'
   columns, against a numpy oracle, then timed as in phase 2, and the
   device page decode (dbp_decode_device, which the script calls itself:
   no served path decodes dbp on the card) of one 2**20-row dbp page of
   their durations, against the column;
6. blocks: the vtpu1 block lifecycle at a compactor job's size. Two
   blocks of 2**20 spans (131,072 traces x 8 spans each; 1/8 of the
   second block's traces are copies of the first's) are written with
   their bloom and HLL built on the card, and the CPU takes both as
   copies of the card's; 250 present and 250 absent trace IDs are found
   by ID in the card's backend (the card's writes run the device page
   encode, which must have encoded rle, dbp and dct pages in one
   page-encode dispatch a row group, at most one launch of each kernel a
   dispatch), one 2**17-span block is written on the card with the
   device encode and with TEMPO_TPU_DEVICE_ENCODE=0 and on the CPU with
   the host encoders (all three byte-equal), the two blocks are
   compacted with the merge plan and the sketch plane on the card (one
   trace per distinct ID; phase 7's compact_once runs the native k-way
   plan on the card over copies of the same blocks), the 2**17-span pair
   (A's first 2**17 spans and B's) is compacted on the card and on the
   CPU (byte-equal outputs), and the phase-4 queries run
   through evaluate_block over the compacted block, card accumulator
   against CPU accumulator. Each trace's spans form a parent chain;
7. db: the storage engine. TempoDB(device="cuda") opens a local backend
   holding copies of the blocks phase 6 wrote on the card, and every
   answer is held against a numpy oracle computed from the generated
   batches: poll; find for 200 present IDs (20 of them copies held by
   both blocks) and 200 absent ones; seven tag searches (service,
   service+name, http.status_code, an attribute, a duration floor, a
   time window, a value the dictionary lacks), each at limit 20 (cold,
   column cache cleared, then warm) and unbounded (cold); tag names and
   values; four TraceQL searches, the structural one on the object
   engine because copies straddle the blocks; compact_once; the
   unbounded searches and the structural query (now on the vectorized
   branch) again over the one compacted block; the phase-4 queries over
   the DB's blocks, card against CPU; a WAL block of 2**17 spans
   appended, rescanned and completed on the card, byte-equal to
   write_batch of the same spans on the CPU;
8. app: the single binary. App(device="cuda") behind a TempoServer on
   127.0.0.1 over a fresh local backend holding a copy of phase 7's
   compacted block, driven only over HTTP: 2**17 spans pushed as 32 OTLP
   protobuf requests of 512 traces, plus one OTLP JSON and one gzip
   request, then /flush; trace by ID for 100 pushed, 100 at-rest and
   100 absent IDs (404); three tag searches at limit 20 and unbounded;
   tag names and values; two TraceQL searches; the three phase-4
   queries as query_range (against evaluate_block with the CPU
   accumulator on the same backend; seg_bincount must launch); four
   simple-count query_range queries (no by(): a set on an rle column, one
   on a dct column, inverted ones, a duration range on a dbp column),
   each twice, through the compiled tier (the same matrices;
   compiled_metrics once a codec group in at most two kernel launches, a
   prepare launch where a group has an rle column or a dbp column of more
   than one tile, then the count; dbp_decode and seg_bincount never;
   the insights record reads compiledShape miss, then hit), and
   /api/query-insights with the tier's cache stats. Every other answer
   is held against a numpy oracle;
9. standing: the standing-query engine. App(device="cuda") with the
   defaults (standing.enabled) behind a TempoServer over a fresh local
   backend; 16 query_range queries registered over
   POST /api/metrics/standing (step 60 s, window 3600 s, maxSeries 64:
   phase 4's three, phase 8's four simple counts and nine more, among
   them a histogram, a quantile, two alerts and a seasonal deviation);
   2**17 spans stamped over the 32 minutes that end 8 minutes before now
   pushed as 32 OTLP protobuf requests and cut every 8 requests, each
   cut folding into every query through seg_bincount on the card (one
   standing_fold dispatch a query with live slots, each exactly one
   launch); after each cut, and after /flush and a poll, every standing
   read equals /api/metrics/query_range over the same start, end and
   step; a StandingEngine on the CPU folding the same cut batches holds
   the same counts; a fifth cut stays in the WAL, the ingesters stop
   without a flush and a new App on the same paths rebuilds (rebuilds
   >= 1, dirty false) the same reads. No query may be dirty or have
   shed. Prints fold ms a cut, the standing_fold dispatch's ms, bytes
   each way and launches a fold, read ms beside query_range ms, the
   first-read and restart rebuild ms, and /status/standing;
10. device-tier: the device-resident hot tier on the card (1,024 MB)
   over phase 7's compacted block (TempoDB(device="cuda")): phase 8's
   four simple counts through the querier's compiled tier with the tier
   off, then three passes of phase 7's seven unbounded tag searches and
   the four counts: cold (the tier empty, the page-heat ledger
   recording; twice), admitting (after refresh_admission(force=True):
   the admission h2d) and resident (the resident scans and stacks; an
   unbounded search's stage-1 pages that the tier holds go through one
   batched launch a codec), then the resident pass's
   searches once more through the per-page loop (the batched stage 1
   off), which must give the same answers, tier hits and avoided bytes.
   Phase 10 also runs an eighth unbounded search, name=db.query, whose
   stage-1 column is dct-coded (phase 7 computes its oracle and tier-off
   answer after compaction); the seven searches' dct pages are scanned in
   stage 2 (the name column of service=cart name=db.query, 8 calls a
   pass), which stays one call a page.
   Every answer equals phase 7's numpy oracle and its tier-off answer,
   every matrix the tier-off one; a stack admitted must then be served
   from the card. Prints per pass the search ms, the tier's hits,
   avoided and admission h2d bytes, and each resident kernel's launches,
   and the resident pass's launches of each codec beside the per-page
   loop's and the calls of the design with one call a page (they must be
   fewer; dct's by the stage-1 pages its batches took, its stage-2 calls
   printed apart). The resident scans are then timed at the
   largest resident page of each codec and the batched ones at the
   resident pass's largest stage-1 batch of each codec;
11. generator and graph: a fresh App(device="cuda") with the defaults
   (the metrics-generator on) and the same App on the CPU; 2**17 spans
   of make_graph_batch traces (8 services, 8 spans a trace, 10% errors)
   pushed over HTTP as 32 OTLP protobuf requests to each, and to a card
   App with the generator off (push spans/s with and without it); the
   card's span-metrics and service-graph series against a numpy oracle
   and the CPU App's, its HLL and count-min registers and distinct-edge
   estimate against the CPU App's; /flush, one block of 2**20
   make_graph_batch spans written on the card and copied to the CPU
   App; /api/graph/dependencies, /api/graph/critical-path (by=service,
   by=name) and /api/graph/walks (seed 7) on both, equal field for field
   (wall-clock and byte stats aside), with each route's ms and the
   root_path_sums calls and kernel launches (one launch a critical-path
   call: the segmented kernel). Past 750 s before it the generator-off
   App is shed;
12. ingest tail and status planes: (a) App(device="cuda") with a
   1,024-MB device tier, 64 MB of it the ingest tail, and App(device=
   "cpu") with the tail off, each behind a TempoServer; phase 9's 16
   standing queries and four more that lower onto the parked columns
   (the lowered ones printed) registered on the card App; phase 9's 2**17
   spans pushed to both as 32 OTLP requests, cut every 8: each cut parks
   one tail entry, each lowered query folds through one tail_fold launch
   a cut and never seg_bincount, and after each cut every standing read
   equals query_range and a CPU StandingEngine's counts over the same cut
   batches; eight live-tail /api/search requests (name, service,
   http.method, http.url, status, min/max duration, an absent value, an
   attribute-table tag) equal the CPU App's, tail_scan launching once a
   parked segment (never for the last two); standing_fold and
   live_tail_scan h2d stays at a few KB a dispatch while the avoided
   bytes climb; after /flush, /status/storage?refresh=1 equals the
   port's own scan on the CPU over a copy of the backend,
   /status/profile?seconds=1 returns stacks and /status/profile/device?
   seconds=2, around a fifth cut's fold, a trace whose device events
   name the hand kernels. (b) one cut of 786,432 spans parked on the card
   through park_cut (2**20 rows, 46 MB): every lowered query through
   resident_fold on the card == the plain version == eval_batch, the
   eight masks == plain == the host loop, and both kernels timed as in
   phase 2 beside their path, plain and torch-chain times and bound;
13. the result cache, the backend cache and the incident plane: (a) a
   card App with `storage.trace.result_cache` on and `cache: memory`
   and a second card App with TEMPO_TPU_RESULT_CACHE=0, each over a copy
   of phase 6's two card-written 2**20-span blocks and phase 11's
   2**20-span graph block, asked over HTTP phase 4's three query_range
   queries, five of phase 7's seven tag searches (unbounded; the window
   one minute wide), a critical path
   and the dependency graph: a cold pass, a repeat (no seg_bincount or
   root_path_sums launch, 0 B inspected), a repeat after 2**16 spans
   pushed in 16 OTLP requests and /flushed into a third block (only it
   recomputes), and a pass of the query_range and graph requests under
   TEMPO_TPU_FAULTS=corrupt=1.0,seed=7 (every entry damaged, counted and
   recomputed); every answer bit-equal to the cache-off App's, the
   result-cache counters and the insights verdicts (store, hit, store)
   as the reference's; ms (split by request kind), launches and
   device-to-host bytes a pass printed; four standing queries over
   2**17 recent spans on a third App (the result cache's remote tier a
   loopback memcached), crashed and restarted twice: the second
   restart's rebuilds replay every block's cached row log and every read
   equals the reads before the crashes and a cache-off App's; (b) a card
   App and a CPU App with slo, rca and vulture on run the reference's
   campaign under TEMPO_TPU_FAULTS=notfound=1.0,seed=7: one incident
   each, backend_fault at tier aged, equal apart from ids and clocks;
   none fault-free; /api/rca, /api/rca/{id}, /status/rca and /status/slo
   equal on both;
14. cluster: microservices mode, every role an App(device="cuda") behind
   its own TempoServer on 127.0.0.1 and every inter-role call over HTTP
   (/rpc/v1, the ring KV at /kv/v1): 3 ingesters at replication factor
   2, a distributor serving the ring KV, a query-frontend, two queriers
   (one here, one `python -m tempo_tpu_torch -target=querier` with its
   own CUDA context), a compactor, a metrics-generator whose remote
   write goes to a loopback sink here (snappy and prompb decoded with
   the script's own lines) and a vulture sidecar; 2**17 spans of phase
   11's make_graph_batch stream (stamped in the last hour) to the
   distributor in 32 OTLP requests; through the frontend 250 present
   and 250 absent finds; ingester-1 killed, the finds again; the
   ingesters' idle cut, a tag search and phase 4's three query_range over
   the survivors' live data; /flush of the survivors; the compactor's merge of the three blocks
   into one holding each span once; the three query_range, two tag
   searches, dependencies and a critical path over it (until both
   queriers have launched seg_bincount); the remote-written series; the
   vulture's probes. Every answer equals a target=all App on the CPU
   with three in-process ingesters at RF 2 fed the same bodies; prints
   push spans/s, flush and compaction ms, p50 and max ms a request kind,
   launches a role step and the second querier's dispatches from its
   /status/device. Past SHED14_S of phases 0-13 the vulture and the
   finds after the kill are shed;
15. receivers and tees: one App(device="cuda") with multitenancy behind a
   TempoServer, the Jaeger agent on a compact and a binary UDP port, a
   Kafka receiver against a broker scripted here (Metadata, ListOffsets,
   Fetch), the gRPC server where grpcio is installed (else the same
   payloads through the port's gRPC decoders and App.push_traces; the
   line `grpc_transport: "grpcio"` or `"absent"` says which), a forwarder
   for tenant fwd to a second card App's /v1/traces, usage_report to a
   loopback sink and self_tracing on (one trace in ten); 2**16 spans of
   phase 11's make_graph_batch stream (stamped in the last hour; 2**17
   before phase 17 took its share of the budget) in
   512-span units, round robin over twelve carriers: Zipkin v2 JSON and
   v1 thrift and Jaeger thrift over HTTP, the agent's compact and binary
   datagrams (at most 65,000 B each), Kafka OTLP records uncompressed,
   gzip, snappy and, where the native library linked, zstd, and OTLP,
   Jaeger and OpenCensus over gRPC, written by the script's own encoders
   where the port has none; a target=all App on the CPU takes the same
   messages through the same decoders in the same order. The generator's
   series of both tenants, 250 present and 250 absent finds over the live
   traces, then after /flush a tag search and phase 4's three query_range
   over the flushed blocks, equal the CPU App's; the second App holds
   every forwarded span, 100 forwarded traces whole; the sink got one
   usage report with the reference's keys, under the cluster seed stored
   at SEED_KEY; a `_self_` search finds distributor/push. Prints spans/s
   a carrier, flush ms, p50 and max ms a request kind and the launches.
   Past SHED15_S of phases 0-14 the forwarder and self-tracing checks are
   shed;
16. object storage and the off-cluster readers: (a) TempoDB(device=
   "cuda") over an S3 mock here (SigV4 checked on every request, XML
   listings): two 2**17-span vtpu1 blocks of make_graph_batch traces
   (the second repeats every 8th trace of the first) written to S3 and
   to a local backend, every object byte-equal; 200 finds (100 present,
   100 absent), a tag search at limit 20 (against the oracle) and one
   narrowed to a whole answer, and phase 4's first query through
   evaluate_block (seg_bincount), each equal to a TempoDB(device="cpu")
   reading the same mock; compact_once on S3 and on local, the merged
   blocks byte-equal; one block round trip each over GCS and Azure mocks
   (the JSON API; Put Block / Put Block List). (b) two 2**14-span vrow1
   blocks written on the card and on the CPU, byte-equal (one hll_update
   launch a card write), finds and searches equal, and compact_once on
   the card (one hll_update launch; every trace once; finds equal the
   unmerged blocks') (2**14, not 2**17: the vrow1 writer and merge
   serialize one segment a trace on the host; 2**15 before phase 17 took
   its share of the budget). (c) a card App over the
   S3 mock whose querier sends its block
   jobs to a ServerlessServer over the same mock (each search == the
   querier's own), query_range through the card App == the CPU App's,
   JaegerQueryServer and the gRPC storage plugin over the card App ==
   over a CPU App (services, operations, a trace, a find), and `python
   -m tempo_tpu_torch.cli` over a copy of (a)'s local blocks (list
   blocks, query trace-id, query search, gen bloom on the card: the bloom
   objects unchanged; convert of a 2**14-span vtpu1 block to vrow1 and
   back on the card, beside (b): the final block byte-equal to the
   source), each in a process of its own. (d)
   /metrics of the card App: the four device-timing families present,
   dispatches_total and transfer_bytes_total == STATS for every kernel,
   and over (c) h2d + d2h == the tenants' transfer_bytes on /status/usage.
   Past SHED16_S of phases 0-15 the GCS and Azure round trips and the CLI
   convert are shed;
17. the mesh (parallel/mesh: a (W, R) mesh of torch devices driven from
   this one process), built over four copies of the one card (each
   shard's launches queue on it; the device list is printed), and again
   over distinct cards where the host has several: (a) the sharded
   compaction step over phase 3's 2**22 rows split by
   partition_by_id_range on a (1, 4) mesh, its bloom, HLL, count-min and
   totals == the one-device step's, both timed (median of 3, in turns);
   (b) VtpuCompactor with the compaction mesh, payload on the host and
   on the device, over a 2**17-span pair (every 8th trace of A and of B,
   so the pair spans the ID space and every shard takes rows):
   both blocks byte-equal to the one-device card merge, duplicates
   collapsed, finds whole, payload_stats; (c) MeshSearcher over phase
   6's blocks A and B on get_mesh's (2, 2) and on (1, 4): search_blocks
   and search_blocks_multi at Q 1 and 8, limit 20 and unbounded,
   shipped, then admitting and resident in a 1,024-MB device tier
   (admission forced open), every
   unbounded answer == the one-device DB's, every limited one a whole
   subset of it and equal across shapes and rounds; (d)
   MeshMetricsEvaluator over A and B for phase 4's queries and the mesh
   bincount over phase 4's 2**22 spans, bit-equal to the one-device
   accumulator; (e) rle_cols_hit against its plain version at a mesh
   search's shard shape (in-set, live, batched Q = 8, padding,
   truncation, the NO_MATCH value, several units), at the one-launch
   design's edges (more runs than a staged tile, 33 and 64 lanes, three
   columns, a run a row with run_pad above and below n, several units)
   and behind a saturated first run of 2^31 - 1 rows; one launch a call
   (count and profiler trace), its ptxas numbers, and kernel, path, plain,
   torch chain and host time a call at the shard shape at Q = 1 and 8,
   over block A's first 16 row groups in one call and at a run a row
   (run_pad 32,768); (f) TempoDB at the default compaction_device_shards = 0
   with its mesh from parallel/mesh's seam: search, search_multi, the
   querier's search_block_batch(_multi) and query_range_blocks == a
   one-device DB's, compact_once byte-equal to (b)'s one-device merge;
   the dispatch labels mesh_scan, mesh_rle_scan, batched_rle_scan and
   mesh_bincount on /metrics. Past SHED17_S of phases 0-16 (c)'s (2, 2)
   repeat is shed.

Phases 3-4 are the main path, phase 5 the scan path, phase 6 the block
path, phase 7 the storage engine's path, phase 8 the server's path and
phase 9 the standing engine's (seg_bincount at the cuts' folds and in
query_range, the page-encode kernels at its flush, compiled_metrics) and
phase 10 the device tier's (the three resident scans, compiled_metrics)
and phase 11 the generator's and the graph plane's (hll_update,
cm_update, root_path_sums, and the page-encode kernels of its flushes)
and phase 12 (a) the ingest tail's (tail_fold, tail_scan, and
seg_bincount for the queries that do not lower) and phase 13 the result
cache's (seg_bincount and root_path_sums on the cache-on App's misses,
counted over its passes alone, none on its hits, and the page-encode
kernels at its flush) and phase 14 the cluster's (seg_bincount on both
queriers, the page-encode kernels and hll_update at the ingesters' flush
and the compactor's merge, hll_update and cm_update in the generator
role at each push, root_path_sums at the critical path) and phase 15 the
receivers' (hll_update and cm_update at the generator tee's pushes,
rle_change_mask, dbp_pack and hll_update at the flush, seg_bincount at
query_range) and phase 16 the object store's (rle_change_mask, dbp_pack
and hll_update at the card's vtpu1 writes and merges, hll_update at the
vrow1 writes and merge, seg_bincount at query_range over S3 and through
the App) and phase 17 the mesh's (rle_cols_hit at every mesh search,
seg_bincount at the mesh bincount, hll_update and cm_update at the
sharded step and the mesh compactions;
the sketch kernels also run on phases 3 and 6-9: compaction, every card
block write and every push through the generator):
each is run with the kernels' launch counts set to 0 just before it,
and every kernel of the path must have launched (phases 6-8 each
rle_change_mask, dbp_pack and seg_bincount, each page-encode kernel at
most once a page-encode dispatch; phase 5 also dbp_decode, which it
calls itself through dbp_decode_device, since no served path decodes dbp
on the card; phase 8 also compiled_metrics, and never dbp_decode, which
the compiled tier fuses into its count). The script then prints
one JSON line of per-kernel and per-phase numbers (phase 6's under
"blocks", phase 7's under "db", phase 8's under "app", phase 9's under
"standing", phase 10's under "tier", phase 11's under "graph", phase
12's under "tail", phase 13's under "resultcache", phase 14's under
"cluster", with every kernel's phase-14 launches in this process under
"launches_cluster_path" and the second querier's seg_bincount and
root_path_sums under "launches_cluster_querier_1"; phase 15's under
"receivers", with every kernel's launches there under
"launches_receivers_path", and its gRPC transport under
"grpc_transport"; phase 16's under "objectstore", with every kernel's
launches there under "launches_objectstore_path"; phase 17's under
"mesh", with every kernel's launches there under "launches_mesh_path";
"shed" names the
depth a slow host cut: phase
8's interpreter runs past 420 s before it, phase 11's generator-off push
past 750 s before it, phase 13's after-push searches past 800 s before
it, phase 14's vulture and finds after the kill past SHED14_S before
it, phase 15's forwarder and self-tracing checks past SHED15_S before
it, phase 16's GCS and Azure round trips and CLI convert past SHED16_S
before it, phase 17's (2, 2) search repeat past SHED17_S before it;
phase 12 sheds nothing), the nvidia-smi
line, and last {"ok": true, "device": {...}}. Without a CUDA
device it exits 1 and prints no result. It imports nothing of JAX or of
tempo_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gzip
import json
import os
import pickle
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import uuid

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
BASE_S = 1_700_000_000


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


class JobLedger:
    """Every query job an App's frontend submits, for holding kernel
    launches to the dispatches the jobs report. The frontend hedges a job
    still running after `hedge_after_s` (a duplicate, the first completion
    wins), so on a slow host a request runs more jobs than its response
    reports, and the loser may still run after the response has come back.
    `settle` waits until every submitted job has finished, then gives the
    dispatches all jobs reported and those of one job a descriptor: what
    the response should report."""

    def __init__(self, app):
        self.pending: list = []
        self.broker = app.broker
        submit = app.broker.submit

        def recording_submit(tenant, desc):
            p = submit(tenant, desc)
            self.pending.append(p)
            return p

        app.broker.submit = recording_submit

    def idle(self, what: str, timeout_s: float = 300.0) -> None:
        """Wait until every job submitted so far has finished."""
        t_end = time.monotonic() + timeout_s
        for p in self.pending:
            check(p.event.wait(max(0.0, t_end - time.monotonic())),
                  f"{what}: query job {p.job_id} still running after {timeout_s:.0f} s")

    def start(self, what: str) -> None:
        self.idle(what)
        self.pending = []

    def settle(self, what: str) -> dict:
        self.idle(what)
        per_desc: dict = {}
        total = 0
        for p in self.pending:
            if p.result is None:  # an expired hedge, dropped unexecuted
                continue
            n = int(p.result["stages"]["deviceDispatches"])
            total += n
            key = json.dumps({k: v for k, v in p.desc.items() if k != "submitted_at"},
                             sort_keys=True, default=str)
            per_desc.setdefault(key, set()).add(n)
        check(all(len(v) == 1 for v in per_desc.values()),
              f"{what}: the copies of one hedged job report different dispatches "
              f"{[sorted(v) for v in per_desc.values() if len(v) > 1]}")
        return dict(jobs=len(self.pending), hedged=len(self.pending) - len(per_desc),
                    dispatches=total, reported=sum(min(v) for v in per_desc.values()))


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


def fmt_ms(ms) -> str:
    return "none" if ms is None else f"{ms:.4f} ms"


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block_objects(root: str, tenant: str, block_id: str, drop_id: bool = False) -> dict:
    """name -> comparable bytes of one stored block: index.json and
    dict.bin gunzipped where gzipped (their gzip header holds the clock;
    vrow1's index.json is plain), meta.json without its block id when
    drop_id."""
    d = os.path.join(root, tenant, block_id)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            raw = f.read()
        if name in ("index.json", "dict.bin") and raw[:2] == b"\x1f\x8b":
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


CODEC_KERNELS = ("rle_change_mask", "dbp_pack", "dbp_decode", "compiled_metrics")
RESIDENT_KERNELS = ("resident_rle_scan", "resident_dct_scan", "resident_dbp_scan",
                    "resident_rle_scan_batch", "resident_dct_scan_batch", "resident_dbp_scan_batch")
GRAPH_SKETCH_KERNELS = ("hll_update", "cm_update", "root_path_sums")
TAIL_KERNELS = ("tail_fold", "tail_scan")
# the resident scans' calls in phase 10's resident pass when every page
# took its own call (rle and dbp: PR 10's 2-3 kernels a call; dct: the
# per-page loop's with name=db.query, 8 of them stage 2's): what the
# batched stage 1 is held to
ONE_CALL_A_PAGE = {"rle": 128, "dct": 11, "dbp": 64}


def launch_counters():
    """name -> the wrapper whose `launches` counts that kernel's launches."""
    from tempo_tpu_torch.compiled import program
    from tempo_tpu_torch.ops import encode as tenc
    from tempo_tpu_torch.ops import graph as ops_graph
    from tempo_tpu_torch.ops import ingest_tail
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.ops import scan, sketch

    return {"seg_bincount": pk.seg_bincount, "in_set_scan": pk.in_set_scan,
            "u64_range_scan": pk.u64_range_scan, "rle_change_mask": tenc.rle_change_mask,
            "dbp_pack": tenc.dbp_pack, "dbp_decode": pk.dbp_decode_limbs,
            "compiled_metrics": program.compiled_metrics,
            **{k: getattr(scan, k) for k in RESIDENT_KERNELS},
            "hll_update": sketch.hll_update, "cm_update": sketch.cm_update,
            "root_path_sums": ops_graph.root_path_sums,
            "tail_fold": ingest_tail.tail_fold, "tail_scan": ingest_tail.tail_scan,
            "rle_cols_hit": pk.rle_cols_hit}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in launch_counters().items()}


def dbp_unit(rng, n: int, width: int):
    """A uint64 column of n rows whose dbp page has the given delta width
    (0, or 1..32), its page, and the page's (words, first, width)."""
    import numpy as np

    from tempo_tpu_torch.encoding.vtpu import lightweight as lw

    if width == 0:
        deltas = np.zeros(n - 1, np.int64)
    else:
        # zigzag widths: |d| < 2^(width-1), one delta at the top of the range
        top = (1 << (width - 1)) - 1
        deltas = rng.integers(-top, top + 1, n - 1) if top else rng.integers(-1, 1, n - 1)
        deltas[0] = -(1 << (width - 1)) if width > 1 else -1
    col = (np.int64(1 << 40) + np.concatenate([[0], np.cumsum(deltas)])).astype(np.uint64)
    page = lw.dbp_encode(col)
    first, _anchors, widths, streams, _n = lw.dbp_parts(page, col.dtype.str, col.shape)
    check(int(widths[0]) == width, f"dbp unit: width {widths[0]}, wanted {width}")
    raw = bytes(streams[0])
    words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4")
    return col, page, (words, int(first[0]), width)


def codec_kernels_check(torch, dev, rng) -> int:
    """Phase 2, the codec's kernels against their plain versions on the
    card at edge shapes (and pages and counts against the host codec and
    a numpy interpreter). Returns the number of cases."""
    import numpy as np

    from tempo_tpu_torch.compiled import executor, program
    from tempo_tpu_torch.encoding.vtpu import lightweight as lw
    from tempo_tpu_torch.ops import encode as tenc
    from tempo_tpu_torch.ops import pallas_kernels as pk

    cases = 0
    # the batched kernels against their plain versions over mixed page
    # tables: n = 2, 3, 9, 2049, 8193 rows; rle pages of 1, 3, 4, 8 and 600
    # lanes (the last opts into more than 48 KB of shared memory); dbp
    # limbs of every item width (0: pack mode) at widths 0, 1, 31, 32; a
    # dbp page of 20 columns; dct index streams
    for n in (2, 3, 9, 2049, 8193):
        for lanes in ((1, 3, 4, 8), (600,)):
            plans = []
            for k in lanes:
                a = rng.integers(0, 3, (n, k)).astype(np.uint32)
                a[rng.random(n) < 0.3] = 0xFFFFFFFF
                plans.append(tenc.prepare_page(a if k > 1 else a[:, 0].copy(), "rle"))
            if len(lanes) > 1:
                for item_bits in (0, 8, 16, 32, 64):
                    p = tenc.PagePlan(np.zeros(n, np.uint32), "dbp" if item_bits else "dct")
                    p.item_bits = item_bits
                    for w in (0, 1, 31, 32):
                        lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
                        if 0 < item_bits < 32:
                            lo &= np.uint32((1 << item_bits) - 1)
                        hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
                        p.cols.append((w, lo, hi if item_bits == 64 else None))
                    plans.append(p)
                plans.append(tenc.prepare_page(
                    np.cumsum(rng.integers(-3, 4, (n, 20)), 0).astype(np.int32), "dbp"))
                plans.append(tenc.prepare_page(rng.integers(0, 9, n).astype(np.uint16), "dct"))
            batch = tenc.PageBatch(plans)
            buf = np.zeros(batch.in_words, np.uint32)
            batch.fill(buf)
            data = torch.from_numpy(buf.view(np.int32))
            want = torch.zeros(max(batch.out_words, 1), dtype=torch.int32)
            batch.launch(data, want)
            got = torch.zeros_like(want).to(dev)
            batch.launch(data.to(dev), got)
            check(torch.equal(got.cpu(), want),
                  f"batched rle_change_mask/dbp_pack n={n} lanes={lanes}: kernel != plain")
            cases += 1
    # whole pages on the card against the host encoders: items of 1/2/4/8
    # bytes with negative deltas and 64-bit borrows, 2-D limbs, dct with
    # one distinct value (width 0) and with 2^k
    ts = np.uint64(1 << 60) + np.cumsum(rng.integers(0, 1 << 20, 8193).astype(np.uint64))
    pages = [
        np.array([127, -128, 0, -1, 5, 127, -128, 3, 3], np.int8),
        np.array([65535, 0, 1, 65535, 7, 0, 9], np.uint16),
        rng.integers(-50, 50, 8193).astype(np.int32),
        ts, ts[::-1].copy(),
        np.array([(1 << 32) - 3, (1 << 32) + 4, (1 << 32) - 10, (1 << 32) + (1 << 30),
                  (1 << 32) - (1 << 30), (1 << 32) + 1], np.uint64),
        np.full(9, 7, np.uint32),
        rng.integers(0, 8, 8193).astype(np.uint32), rng.integers(0, 1 << 10, 3).astype(np.uint32),
        rng.integers(0, 1 << 32, (2, 4), dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 3, (9, 4)).astype(np.uint32),
    ]
    host = {"rle": lw.rle_encode, "dbp": lw.dbp_encode, "dct": lw.dct_encode}
    batch_pages = []
    for arr in pages:
        for cdc in ("rle", "dbp", "dct"):
            try:
                want = host[cdc](arr)
                batch_pages.append((arr, cdc))
            except ValueError:
                want = None
            try:
                got = tenc.encode_page_device(arr, cdc, dev)
            except ValueError:
                got = None
            check(got == want, f"{cdc} page of {arr.dtype} {arr.shape} on the card != host page")
            cases += 1
    # the same pages as one batch: one dispatch, each page the host's
    check(tenc.encode_pages_device(batch_pages, dev) == [host[c](a) for a, c in batch_pages],
          "a batch of pages on the card != the host pages")
    cases += 1
    # dbp_decode: n = 2, 3, 9, a tile's 2048 +- 1, 8193 at widths 0, 1, 31,
    # 32, against the host decoder (a page a unit) and the plain version
    # (stacked units)
    for n in (2, 3, 9, 2047, 2049, 8193):
        units = [dbp_unit(rng, n, w) for w in (0, 1, 31, 32)]
        for col, page, _ in units:
            check(np.array_equal(pk.dbp_decode_device(page, col.dtype.str, col.shape, dev), col),
                  f"dbp_decode n={n}: != lightweight.dbp_decode")
        wp = max(len(u[2][0]) for u in units)
        words = np.zeros((len(units), wp), np.uint32)
        for i, u in enumerate(units):
            words[i, : len(u[2][0])] = u[2][0]
        args = (torch.from_numpy(words.view(np.int32)),
                torch.tensor([u[2][1] for u in units], dtype=torch.uint64).view(torch.int64),
                torch.tensor([u[2][2] for u in units], dtype=torch.int32))
        got = pk.dbp_decode_limbs(*(x.to(dev) for x in args), n).cpu()
        check(torch.equal(got, pk._dbp_decode_plain(*args, n)), f"dbp_decode n={n}: kernel != plain")
        check(np.array_equal(got.numpy().view(np.uint64), np.stack([u[0] for u in units])),
              f"dbp_decode n={n}: != the columns")
        cases += 1
    # compiled_metrics: rle/dct/dbp mixes, an inverted set, an empty set
    # (NO_MATCH), windows that start after some rows and bins past n_bins,
    # against the plain version and a numpy interpreter over the columns
    start0 = BASE_S
    for codecs in (("rle",), ("dct",), ("dbp",), ("rle", "dct"), ("dct", "dbp"),
                   ("rle", "dct", "dbp"), ("rle", "rle")):
        units, raw = [], []
        for _ in range(7):
            n = int(rng.integers(2, 9000))
            cols, vals = [], []
            for codec in codecs:
                if codec == "rle":
                    cuts = np.sort(rng.choice(np.arange(1, n), min(n - 1, int(rng.integers(0, 40))),
                                              replace=False))
                    lengths = np.diff(np.concatenate([[0], cuts, [n]])).astype(np.int32)
                    values = rng.integers(0, 6, len(lengths)).astype(np.uint32)
                    cols.append(("rle", {"values": values, "lengths": lengths}, {"n": n}))
                    vals.append(np.repeat(values, lengths).astype(np.uint64))
                elif codec == "dct":
                    d = int(rng.integers(1, 9))
                    values = np.sort(rng.choice(np.arange(20, dtype=np.uint32), d, replace=False))
                    idx = rng.integers(0, d, n).astype(np.int32)
                    cols.append(("dct", {"values": values, "idx": idx}, {"n": n}))
                    vals.append(values[idx].astype(np.uint64))
                else:
                    col, page, (words, first, width) = dbp_unit(rng, n, int(rng.choice([0, 1, 12, 31])))
                    cols.append(("dbp", {"words": words}, {"n": n, "first": first, "width": width}))
                    vals.append(lw.dbp_decode(page, col.dtype.str, col.shape))
            t_s = (start0 - 20 + rng.integers(0, 120, n)).astype(np.uint32)
            units.append(executor._Unit(n, t_s, cols, ()))
            raw.append((t_s, vals))
        n_pad = executor._pow2(max(u.n for u in units))
        colsig = tuple(("range", f"c{i}") if c == "dbp" else ("set", f"c{i}", i % 2 == 0)
                       for i, c in enumerate(codecs))
        t_s, valid, payloads, pads = executor._stack_group(units, colsig, n_pad)
        sets = [np.array([1, 3, 3, 3], np.uint32), np.full(4, 0xFFFFFFFF, np.uint32),
                np.array([2, 4, 5, 19], np.uint32)]
        ranges = [(0, (1 << 64) - 1), (5, 4), ((1 << 40) - 10**6, (1 << 40) + 10**6)]
        sig_cols, qargs = [], []
        for i, codec in enumerate(codecs):
            if codec == "dbp":
                sig_cols.append(("dbp", "range", False, pads[i]))
                qargs.append(np.array(ranges, np.uint64))
            else:
                sig_cols.append((codec, "set", colsig[i][2], 4))
                qargs.append(np.stack([np.stack([s] * len(units)) for s in sets]))
        tb = np.array([[start0, 10], [start0 + 30, 7], [start0 - 100, 60]], np.uint32)
        nb = np.array([6, 3, 2], np.uint32)
        sig = (tuple(sig_cols), n_pad, 8, 3)

        def on(d):
            return (executor._tensor(t_s, d), executor._tensor(valid, d),
                    tuple(tuple(executor._tensor(a, d) for a in p) for p in payloads),
                    tuple(executor._tensor(a, d) for a in qargs), executor._tensor(tb, d),
                    executor._tensor(nb, d))

        got = program.compiled_metrics(sig, *on(dev)).cpu()
        check(torch.equal(got, program.compiled_metrics(sig, *on(torch.device("cpu")))),
              f"compiled_metrics {'+'.join(codecs)}: kernel != plain")
        want = np.zeros((3, 8), np.int64)
        for ts_u, vals in raw:
            for q in range(3):
                hit = np.ones(len(ts_u), bool)
                for i, codec in enumerate(codecs):
                    if codec == "dbp":
                        lo, hi = ranges[q]
                        hit &= (vals[i] >= np.uint64(lo)) & (vals[i] <= np.uint64(hi))
                    else:
                        hit &= np.isin(vals[i], sets[q].astype(np.uint64)) != colsig[i][2]
                ok = hit & (ts_u >= tb[q, 0])
                bins = (ts_u.astype(np.int64) - int(tb[q, 0])) // int(tb[q, 1])
                ok &= bins < nb[q]
                np.add.at(want[q], bins[ok], 1)
        check(np.array_equal(got.numpy(), want) and want.any(),
              f"compiled_metrics {'+'.join(codecs)}: != the numpy interpreter over decoded columns")
        cases += 1
    return cases


def time_encode_kernels(torch, dev, recorded: list, lib, stream) -> dict:
    """rle_change_mask and dbp_pack at the shapes phase 6's card write of
    block A gave them: one row group's lightweight pages (the writer's
    first batch; `recorded` holds each batch's plans) and one block's
    (every batch of that write laid out as one). Each is timed as the
    other kernels are (device time, wrapper path time, plain version on
    the card, bound; for rle_change_mask the per-page torch expression
    `(a[1:] != a[:-1]).any(1)` over the batch's pages as the library
    line), and the writer's whole dispatch is timed by host clock: the
    `page_encode` dispatch (copy in, both launches, copy out, stream
    wait: timed_dispatch's wall) and encode_prepared around it (layout,
    staging fill and page assembly on the codec pool too)."""
    import numpy as np

    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import encode as tenc
    from tempo_tpu_torch.util.devicetiming import STATS

    shapes = {"row_group": [p for p in recorded[0] if p is not None],
              "block": [p for plans in recorded for p in plans if p is not None]}
    staging = tenc.PageStaging(dev)
    out = {"rle_change_mask": {}, "dbp_pack": {}}
    for label, plans in shapes.items():
        reps = 25 if label == "row_group" else 5
        batch = tenc.PageBatch(plans)
        buf = np.zeros(batch.in_words, np.uint32)
        batch.fill(buf)
        data_h = torch.from_numpy(buf.view(np.int32))
        want = torch.zeros(batch.out_words, dtype=torch.int32)
        batch.launch(data_h, want)
        data = data_h.to(dev)
        res = torch.zeros(batch.out_words, dtype=torch.int32, device=dev)
        batch.launch(data, res)
        check(torch.equal(res.cpu(), want), f"encode kernels at one {label}'s pages: kernel != plain")
        rle_t, rle_tiles, dbp_t, dbp_tiles = batch.tensors(data)

        def rle_launch():
            _build.check(lib.tt_rle_change_mask(data.data_ptr(), rle_t.data_ptr(),
                                                rle_tiles.data_ptr(), rle_tiles.numel(),
                                                tenc._rle_stage_words(batch.lanes), res.data_ptr(),
                                                stream()), "rle_change_mask")

        def pack_launch():
            _build.check(lib.tt_dbp_pack(data.data_ptr(), dbp_t.data_ptr(), dbp_tiles.data_ptr(),
                                         dbp_tiles.numel(), res.data_ptr(), stream()), "dbp_pack")

        views = [data[int(r[0]): int(r[0]) + int(r[1] * r[2])].view(int(r[1]), int(r[2]))
                 for r in batch.rle_table]
        rle_in = sum(int(r[1] * r[2]) * 4 for r in batch.rle_table)
        rle_out = sum(-(-int(r[1] - 1) // 32) * 4 for r in batch.rle_table)
        bnd, by = bound_ms(rle_in + batch.rle_table.nbytes + rle_out,
                           sum(int(r[1] * r[2]) for r in batch.rle_table))
        out["rle_change_mask"][label] = dict(
            shape=f"{len(views)} pages, {sum(int(r[1]) for r in batch.rle_table)} rows, "
                  f"{rle_in} B of lanes ({rle_tiles.numel()} tiles of about "
                  f"{tenc.RLE_TILE_WORDS * 4} B)",
            max_abs_err=0, ms=kernel_ms(torch, [rle_launch]),
            path_ms=path_ms(torch, lambda: tenc.rle_change_mask(data, rle_t, rle_tiles, res,
                                                                batch.lanes), reps=reps),
            plain_ms=path_ms(torch, lambda: tenc._rle_change_plain(data, rle_t, res), reps=reps),
            bound_ms=bnd, bound_by=by,
            library_ms=path_ms(torch, lambda: [(a[1:] != a[:-1]).any(1) for a in views], reps=reps))
        dbp_in = sum(int(r[2]) * 4 * (2 if r[1] >= 0 else 1) for r in batch.dbp_table)
        values = sum(int(r[2] - 1 if r[3] else r[2]) for r in batch.dbp_table)
        dbp_out = sum(-(-int((r[2] - 1 if r[3] else r[2]) * r[4]) // 32) * 4 for r in batch.dbp_table)
        bnd, by = bound_ms(dbp_in + batch.dbp_table.nbytes + dbp_out, 12 * values)
        out["dbp_pack"][label] = dict(
            shape=f"{len(batch.dbp_cols)} columns ({sum(1 for r in batch.dbp_table if r[3] == 0)} "
                  f"dct index streams), {values} values, {dbp_in} B in, {dbp_out} B out "
                  f"({dbp_tiles.numel()} tiles of {tenc.PACK_VALUES} values)",
            max_abs_err=0, ms=kernel_ms(torch, [pack_launch]),
            path_ms=path_ms(torch, lambda: tenc.dbp_pack(data, dbp_t, dbp_tiles, res), reps=reps),
            plain_ms=path_ms(torch, lambda: tenc._dbp_pack_plain(data, dbp_t, res), reps=reps),
            bound_ms=bnd, bound_by=by, library_ms=None)
        # the writer's dispatch of these pages, by host clock
        walls, dispatch = [], []
        for _ in range(reps + 2):
            s0 = STATS.seconds.get("page_encode", 0.0)
            t0 = time.perf_counter()
            tenc.encode_prepared(plans, dev, staging)
            walls.append((time.perf_counter() - t0) * 1e3)
            dispatch.append((STATS.seconds["page_encode"] - s0) * 1e3)
        for k in out:
            out[k][label].update(dispatch_ms=statistics.median(dispatch[2:]),
                                 encode_ms=statistics.median(walls[2:]))
        del data, res
    return out


def tile_bin_spans(torch, tile: int, t_s, valid, tb, nb, slot_pad: int) -> tuple:
    """The bins a row tile's in-window rows span (last - first + 1) over
    every (lane, unit, tile of `tile` rows) with a valid row in the lane's
    window, binned as the count kernel bins them: (min, median, max), or
    (0, 0.0, 0) when no tile has one. t_s and tb hold uint32 bits."""
    n_units, n_pad = t_s.shape
    pad = -n_pad % tile
    ts = torch.nn.functional.pad(t_s.to(torch.int64) & 0xFFFFFFFF, (0, pad))
    ok = torch.nn.functional.pad(valid.bool(), (0, pad))
    ts, ok = ts.view(n_units, -1, tile), ok.view(n_units, -1, tile)
    spans = []
    for (start, step), n_bins in zip((tb.to(torch.int64) & 0xFFFFFFFF).tolist(), nb.tolist()):
        rel = ts - start
        inwin = ok & (rel >= 0) & (rel < min(int(n_bins), slot_pad) * step)
        b = torch.div(rel, step, rounding_mode="floor")
        hi = torch.where(inwin, b, torch.full_like(b, -1)).amax(-1)
        lo = torch.where(inwin, b, torch.full_like(b, 1 << 40)).amin(-1)
        spans.append((hi - lo + 1)[hi >= 0])
    s = torch.cat(spans).double()
    if s.numel() == 0:
        return 0, 0.0, 0
    return int(s.min()), float(s.median()), int(s.max())


def time_compiled_kernels(torch, recorded: dict, long_dbp: tuple, lib, stream) -> dict:
    """dbp_decode and the compiled dispatch at the shapes the main path
    gave them. dbp_decode at phase 8's largest dispatch with a dbp column
    (its U units of n_pad rows, on their own inputs still on the card) and
    at phase 5's page-decode shape (one unit of 2^20 values: long_dbp =
    (words, first, width, n)). The compiled dispatch as a whole (every
    launch it makes, in one graph) at the same phase-8 dispatch and at a
    copy of it with Q=4 lanes of shifted windows. The dispatch's bound is
    the work of the fused program whatever implements it: each input read
    once (t_s, valid, the words the dbp deltas occupy, rle runs, dct
    dictionaries and indices, codes, bounds), the counts written once, no
    decoded column."""
    from tempo_tpu_torch.compiled import program
    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import pallas_kernels as pk

    def decode_case(words, first, width, n):
        n_units, wp = words.shape
        dec = torch.empty((n_units, n), dtype=torch.int64, device=words.device)
        sums = torch.empty((n_units, -(-n // lib.tt_dbp_tile())), dtype=torch.int64,
                           device=words.device)
        launched = ctypes.c_int32(0)

        def launch():
            _build.check(lib.tt_dbp_decode(words.data_ptr(), wp, first.data_ptr(),
                                           width.data_ptr(), n_units, n, sums.data_ptr(),
                                           dec.data_ptr(), ctypes.byref(launched), stream()),
                         "dbp_decode")

        launch()
        check(torch.equal(dec, pk._dbp_decode_plain(words, first, width, n)),
              f"dbp_decode U={n_units} n={n}: kernel != plain")
        # the library line: torch.cumsum over the unpacked deltas
        deltas = torch.diff(dec, dim=1, prepend=torch.zeros_like(dec[:, :1]))
        # the bound of the decode alone: the words array as stored, first and width, the output
        bnd, by = bound_ms(words.numel() * 4 + n_units * 12 + dec.numel() * 8, 12 * dec.numel())
        return dict(
            shape=f"U={n_units} units x n={n}, {wp} words a unit, widths "
                  f"{sorted(set(width.tolist()))[:4]}", max_abs_err=0,
            ms=kernel_ms(torch, [launch]), kernels_a_call=launched.value,
            path_ms=path_ms(torch, lambda: pk.dbp_decode_limbs(words, first, width, n)),
            plain_ms=path_ms(torch, lambda: pk._dbp_decode_plain(words, first, width, n)),
            bound_ms=bnd, bound_by=by,
            library_ms=path_ms(torch, lambda: torch.cumsum(deltas, dim=1)))

    sig, args = recorded["sig"], recorded["args"]
    t_s, valid, payloads, qargs, tb, nb = args
    sig_cols, n_pad, slot_pad, q = sig
    c_dbp = next(c for c, col in enumerate(sig_cols) if col[0] == "dbp")
    out = {"dbp_decode": decode_case(*payloads[c_dbp], n_pad)}
    out["dbp_decode"]["long_unit"] = decode_case(*long_dbp)

    def dispatch_case(sig, args):
        t_s, valid, payloads, qargs, tb, nb = args
        sig_cols, n_pad, slot_pad, q = sig
        n_units = t_s.shape[0]
        desc, scratch = program._describe(sig, t_s, payloads, qargs)
        counts = torch.zeros((q, slot_pad), dtype=torch.int64, device=t_s.device)
        launched = ctypes.c_int32(0)

        def launch():  # the dispatch's launches: its counts zeroed, then its kernels
            counts.zero_()
            _build.check(lib.tt_compiled_metrics(desc.ctypes.data, len(sig_cols), t_s.data_ptr(),
                                                 valid.data_ptr(), n_pad, n_units, q,
                                                 tb.data_ptr(), nb.data_ptr(), slot_pad,
                                                 counts.data_ptr(), ctypes.byref(launched),
                                                 stream()), "compiled_metrics")

        launch()
        check(torch.equal(counts, program._metrics_plain(sig, *args)),
              f"compiled_metrics Q={q} at phase 8's shape: kernel != plain")
        ms = kernel_ms(torch, [launch])
        rows = t_s.numel()
        nbytes = rows * 5 + q * slot_pad * 8 + tb.numel() * 4 + nb.numel() * 4
        for (codec, _kind, _inv, _pad), payload, qa in zip(sig_cols, payloads, qargs):
            nbytes += qa.numel() * qa.element_size()
            if codec == "dbp":
                words, first, width = payload
                nbytes += sum(((n_pad - 1) * int(w) + 31) // 32 * 4 for w in width.tolist())
                nbytes += n_units * 12
            else:
                nbytes += sum(x.numel() * x.element_size() for x in payload)
        n_dbp = sum(1 for c in sig_cols if c[0] == "dbp")
        bnd, by = bound_ms(nbytes, rows * (4 + 12 * n_dbp + q * (2 + 2 * len(sig_cols))))
        res = dict(
            shape=f"Q={q} U={n_units} n_pad={n_pad} columns {'+'.join(c[0] for c in sig_cols)} "
                  f"slot_pad={slot_pad}", max_abs_err=0, ms=ms,
            kernels_a_dispatch=launched.value,
            path_ms=path_ms(torch, lambda: program.compiled_metrics(sig, *args)),
            plain_ms=path_ms(torch, lambda: program._metrics_plain(sig, *args)),
            bound_ms=bnd, bound_by=by, bound_bytes=nbytes, library_ms=None,
            tile_bins=tile_bin_spans(torch, lib.tt_dbp_tile(), t_s, valid, tb, nb, slot_pad))
        del scratch
        return res

    out["compiled_metrics"] = dispatch_case(sig, args)
    # Q=4: the same units, each lane's window one step later than the last
    q4 = 4
    step = int(tb[0, 1])
    tb4 = torch.stack([tb[0] + torch.tensor([k * step, 0], dtype=tb.dtype, device=tb.device)
                       for k in range(q4)])
    nb4 = nb[:1].repeat(q4)
    qargs4 = tuple(qa[:1].repeat(q4, *([1] * (qa.dim() - 1))).contiguous() for qa in qargs)
    out["compiled_metrics"]["q4"] = dispatch_case(
        (sig_cols, n_pad, slot_pad, q4), (t_s, valid, payloads, qargs4, tb4.contiguous(), nb4))
    return out


def blocks_phase(seed: int, queries: list, plan_of, db_root: str, encode_batches: list):
    """Phase 6, the block path: write, find by ID, compact and query
    vtpu1 blocks on the card and on the CPU. The card-written blocks A
    and B are copied into the local backend at db_root for phase 7; the
    plans of each page-encode batch of A's card write are appended to
    encode_batches. Returns (its numbers, the batches of A and B)."""
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
    from tempo_tpu_torch.ops import encode as tenc
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.util.devicetiming import STATS

    LIGHT = ("rle", "dbp", "dct")
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
        # the card's writes run the device page-encode arm (the switch
        # unset follows the writer's device), the CPU's the host encoders
        metas, write_s = {}, {}
        real_prepared = tenc.encode_prepared

        def recording(plans, device, staging=None):
            encode_batches.append(list(plans))
            return real_prepared(plans, device, staging)

        # the card writes A and B; the CPU writes the first 2**17 spans of
        # A (held against the card's write of the same spans in the encode
        # arm below), and takes A and B as copies of the card's blocks
        small = a.select(np.arange(1 << 17))
        block_ids["small"] = str(uuid.uuid4())
        writes = {"cuda": (("a", a), ("b", b)), "cpu": (("small", small),)}
        for dev in devices:
            pages0 = {c: tenc.device_encode_pages_total.value(codec=c) for c in LIGHT}
            k1, k2 = tenc.rle_change_mask.launches, tenc.dbp_pack.launches
            d0 = STATS.dispatches.get("page_encode", 0)
            for k, batch in writes[dev]:
                h2d0 = STATS.h2d.get("block_sketch", 0)
                d2h0 = STATS.d2h.get("block_sketch", 0)
                if (dev, k) == ("cuda", "a"):
                    tenc.encode_prepared = recording
                t0 = time.perf_counter()
                try:
                    metas[dev, k] = write_block([batch], tenant, backends[dev], cfg,
                                                block_id=block_ids[k], device=dev)
                finally:
                    tenc.encode_prepared = real_prepared
                write_s[f"{dev} {k}"] = time.perf_counter() - t0
                print(f"phase 6 write {k} on {dev}: {write_s[f'{dev} {k}'] * 1e3:.0f} ms, "
                      f"{metas[dev, k].total_records} row groups, {metas[dev, k].size_bytes} B "
                      f"of pages, sketch H2D {STATS.h2d.get('block_sketch', 0) - h2d0} B, "
                      f"D2H {STATS.d2h.get('block_sketch', 0) - d2h0} B, "
                      f"est_distinct {metas[dev, k].est_distinct_traces}", flush=True)
            pages = {c: tenc.device_encode_pages_total.value(codec=c) - pages0[c] for c in LIGHT}
            launched = (tenc.rle_change_mask.launches - k1, tenc.dbp_pack.launches - k2)
            dispatches = STATS.dispatches.get("page_encode", 0) - d0
            rgs = sum(metas[dev, k].total_records for k, _ in writes[dev])
            check(all(pages.values()) if dev == "cuda" else not any(pages.values()),
                  f"phase 6 write on {dev}: device-encoded pages {pages}")
            check(dispatches == (rgs if dev == "cuda" else 0) and max(launched) <= dispatches,
                  f"phase 6 write on {dev}: {dispatches} page-encode dispatches, launches "
                  f"{launched}, for {rgs} row groups")
            res.setdefault("device_encode_pages", {})[dev] = pages
            res.setdefault("write_launches", {})[dev] = {
                "rle_change_mask": launched[0], "dbp_pack": launched[1],
                "page_encode_dispatches": dispatches, "row_groups": rgs}
            print(f"phase 6 write on {dev}: device page encode {'on' if dev == 'cuda' else 'off'} | "
                  f"pages encoded on the card {pages}, rle_change_mask {launched[0]} / dbp_pack "
                  f"{launched[1]} launches in {dispatches} page-encode dispatches for {rgs} row "
                  f"groups ({launched[0] / rgs:.2f} / {launched[1] / rgs:.2f} launches a row "
                  f"group)", flush=True)
        print(f"phase 6 write walls: card (device encode) {write_s['cuda a']:.2f} / "
              f"{write_s['cuda b']:.2f} s, cpu (host encode) {write_s['cpu small']:.2f} s "
              "(2^17 spans)", flush=True)
        for k in "ab":
            check(metas["cuda", k].total_objects == len(ids[k]), f"block {k}: n_traces")
        res["write_ms"] = {k: v * 1e3 for k, v in write_s.items()}
        # the 2**17-span block written twice on the card, with the device
        # encode and with TEMPO_TPU_DEVICE_ENCODE=0 (the host encoders),
        # and once on the CPU (above)
        arm = {}
        for label, env in (("device encode", None), ("host encode", "0")):
            if env is not None:
                os.environ["TEMPO_TPU_DEVICE_ENCODE"] = env
            try:
                sid = block_ids["small"] if env is None else str(uuid.uuid4())
                t0 = time.perf_counter()
                meta = write_block([small], tenant, backends["cuda"], cfg, block_id=sid,
                                   device="cuda")
                arm[label] = (time.perf_counter() - t0, sid)
                if env is None:
                    metas["cuda", "small"] = meta
            finally:
                os.environ.pop("TEMPO_TPU_DEVICE_ENCODE", None)
        check_same_blocks(block_objects(roots["cuda"], tenant, arm["device encode"][1], True),
                          block_objects(roots["cuda"], tenant, arm["host encode"][1], True),
                          "2**17-span block: device encode vs host encode on the card")
        check_same_blocks(block_objects(roots["cuda"], tenant, block_ids["small"]),
                          block_objects(roots["cpu"], tenant, block_ids["small"]),
                          "2**17-span block written on cuda vs cpu")
        print("phase 6 write: a 2^17-span block byte-equal between cuda and cpu (data.bin, "
              "bloom shards, meta.json; index and dictionary gunzipped); blocks a and b reach "
              "the cpu backend as copies of the card's", flush=True)
        res["arm_2e17_ms"] = {k: v[0] * 1e3 for k, v in arm.items()}
        print(f"phase 6 encode arm: a 2^17-span block written on the card in "
              f"{arm['device encode'][0] * 1e3:.0f} ms with the device encode, "
              f"{arm['host encode'][0] * 1e3:.0f} ms with TEMPO_TPU_DEVICE_ENCODE=0: byte-equal",
              flush=True)
        enc = default_encoding()
        # phase 7's backend: the card-written objects, copied as files
        db_backend = TypedBackend(LocalBackend(db_root))
        for k in "ab":
            enc.copy_block(metas["cuda", k], backends["cuda"], db_backend)

        # ------------------------------------------------------ find by ID
        rng = np.random.default_rng(seed + 99)
        present = np.concatenate([ids["a"][rng.choice(len(ids["a"]), 125, replace=False)],
                                  ids["b"][rng.choice(len(ids["b"]), 125, replace=False)]])
        known = {bytes(t) for t in np.concatenate([ids["a"], ids["b"]])}
        absent = [t for t in rng.integers(0, 2**32, (300, 4), dtype=np.uint32)
                  if bytes(t) not in known][:250]
        check(len(absent) == 250, "phase 6: could not draw 250 absent IDs")

        def find_all(dev, limbs_list):
            blks = [VtpuBackendBlock(metas[dev, k], backends[dev], cfg) for k in "ab"]
            out = []
            t0 = time.perf_counter()
            for limbs in limbs_list:
                tid = np.asarray(limbs, np.uint32).astype(">u4").tobytes()
                t = combine_traces([blk.find_trace_by_id(tid) for blk in blks])
                out.append(None if t is None else (t.trace_id, repr(t.batches)))
            return out, (time.perf_counter() - t0) / len(limbs_list) * 1e3

        # (the card's answers alone are held against the generated traces)
        found, find_ms = {}, {}
        found["cuda", "present"], find_ms["cuda present"] = find_all("cuda", present)
        found["cuda", "absent"], find_ms["cuda absent"] = find_all("cuda", absent)
        for limbs, hit in zip(present, found["cuda", "present"]):
            check(hit is not None and hit[0] == limbs.astype(">u4").tobytes()
                  and hit[1].count("Span(") == 8, "find: a present trace was not found whole")
        check(all(hit is None for hit in found["cuda", "absent"]), "find: an absent ID was found")
        print(f"phase 6 find: 250 present found whole, 250 absent -> None in the card-written "
              f"blocks | {find_ms['cuda present']:.2f} ms a present ID, "
              f"{find_ms['cuda absent']:.3f} ms an absent one (two blocks each)", flush=True)
        res["find_ms"] = find_ms

        # -------------------------------------------------------- compact
        outs, compact_s = {}, {}
        # the card merges A and B (phase 7's compact_once runs merge_path
        # auto on the card over copies of the same two blocks); the card
        # and the CPU both merge the 2**17-span pair (A's first 2**17
        # spans and B's, which share B's copies of A's first traces), byte-
        # equal: the CPU's merge of A and B took 46-54 s of the script's
        # budget
        small_b = b.select(np.arange(1 << 17))
        block_ids["small b"] = str(uuid.uuid4())
        for dev in devices:
            metas[dev, "small b"] = write_block([small_b], tenant, backends[dev], cfg,
                                                block_id=block_ids["small b"], device=dev)
        pair_traces = {
            "full": n_distinct,
            "small": len(np.unique(np.concatenate([small.cols["trace_id"],
                                                   small_b.cols["trace_id"]]), axis=0))}
        for dev, pair, (x, y) in (("cuda", "full", ("a", "b")),
                                  ("cuda", "small", ("small", "small b")),
                                  ("cpu", "small", ("small", "small b"))):
            path = "device"
            pages0 = {c: tenc.device_encode_pages_total.value(codec=c) for c in LIGHT}
            k1, k2 = tenc.rle_change_mask.launches, tenc.dbp_pack.launches
            d0 = STATS.dispatches.get("page_encode", 0)
            comp = VtpuCompactor(CompactionOptions(block_config=cfg, merge_path=path), device=dev)
            t0 = time.perf_counter()
            (outs[dev, pair],) = comp.compact([metas[dev, x], metas[dev, y]], tenant,
                                              backends[dev])
            compact_s[f"{dev} {pair}"] = time.perf_counter() - t0
            out = outs[dev, pair]
            check(out.total_objects == pair_traces[pair],
                  f"compaction {dev} {pair}: {out.total_objects} traces, "
                  f"{pair_traces[pair]} distinct")
            sk = comp.sketcher
            pads = comp.device_merge_pads
            print(f"phase 6 compact {'A and B' if pair == 'full' else 'the 2^17 pair'} on "
                  f"{dev}, merge_path {path}: "
                  f"{compact_s[f'{dev} {pair}'] * 1e3:.0f} ms, {out.total_spans} spans, "
                  f"{out.total_objects} traces, {comp.spans_combined} spans combined | "
                  f"{len(pads)} device merge calls (padded rows: "
                  f"{', '.join(f'{p} x{pads.count(p)}' for p in sorted(set(pads)))}) | "
                  f"sketch accumulator: {sk.launches} updates, H2D {sk.h2d_bytes} B, "
                  f"D2H {sk.d2h_bytes} B | pages encoded on the card "
                  f"{ {c: tenc.device_encode_pages_total.value(codec=c) - pages0[c] for c in LIGHT} }"
                  f", rle_change_mask {tenc.rle_change_mask.launches - k1} / dbp_pack "
                  f"{tenc.dbp_pack.launches - k2} launches in "
                  f"{STATS.dispatches.get('page_encode', 0) - d0} page-encode dispatches for "
                  f"{out.total_records} row groups written", flush=True)
            check(STATS.dispatches.get("page_encode", 0) - d0 <= out.total_records,
                  f"compaction {dev} {pair}: more page-encode dispatches than row groups")
            res.setdefault("device_merge_calls", {})[f"{dev} {pair}"] = len(pads)
            res.setdefault("device_merge_padded_rows", {})[f"{dev} {pair}"] = sum(pads)
            check(pads, f"compaction on {dev}: the merge plan never ran on the device")
            res.setdefault("sketch_bytes", {})[f"{dev} {pair}"] = {
                "h2d": sk.h2d_bytes, "d2h": sk.d2h_bytes, "updates": sk.launches}
        check_same_blocks(block_objects(roots["cuda"], tenant, outs["cuda", "small"].block_id,
                                        drop_id=True),
                          block_objects(roots["cpu"], tenant, outs["cpu", "small"].block_id,
                                        drop_id=True),
                          "compacted 2^17 pair (cuda, device) vs (cpu, device)")
        print("phase 6 compact: the 2^17 pair's outputs byte-equal between cuda and cpu "
              "(merge_path device)", flush=True)
        res["compact_ms"] = {k: v * 1e3 for k, v in compact_s.items()}

        # ---------------------------------------------------------- query
        out_meta, be = outs["cuda", "full"], backends["cuda"]
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


def _dbp_words(np, rng, width: int, n: int, n_words: int = 0):
    """(words u32 with the guard word, padded with zeros to n_words, first)
    of n values whose deltas are width-bit fields of random bits."""
    raw = rng.integers(0, 256, ((n - 1) * width + 7) // 8 if n else 0, dtype=np.uint8).tobytes()
    words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4")
    if n_words > len(words):
        words = np.concatenate([words, np.zeros(n_words - len(words), np.uint32)])
    return words, int(rng.integers(0, 2**63))


# integer operations a key for the sketch kernels' bounds: fnv1a over 16
# bytes (shift, mask, xor, multiply a byte), 9 a fmix32, the index mask and
# the update; count-min takes a fmix32, a mask and an add for each row
HASH_OPS = 16 * 4
HLL_OPS = HASH_OPS + 2 * 9 + 4
CM_OPS_A_ROW = 12


def torch_op_step(tids, sids, valid, plans) -> dict:
    """parallel/compaction.local_compaction_step with the HLL and
    count-min updates as their plain torch versions (the step before the
    sketch kernels), for the A/B of phase 3 in one call."""
    import torch

    from tempo_tpu_torch.ops import bloom, merge, sketch

    plan = merge.merge_spans(tids, sids, valid)
    perm, keep = plan["perm"].to(torch.int64), plan["keep"]
    st = tids[perm]
    trace_first = merge.first_occurrence_mask(
        st.to(torch.int64), valid[perm] if valid is not None else None) & keep
    words = bloom.build(st, plans.bloom, valid=trace_first)
    regs = sketch._hll_update_plain(sketch.hll_init(plans.hll, st.device), st, plans.hll,
                                    valid=trace_first)
    counts = sketch._cm_update_plain(sketch.cm_init(plans.cm, st.device), st, plans.cm,
                                     valid=keep)
    return {"perm": plan["perm"], "keep": keep, "n_rows": plan["n_rows"],
            "n_traces": plan["n_traces"], "bloom": words, "hll": regs, "cm": counts}


def graph_sketch_kernels_check(torch, dev, rng, lib, stream) -> tuple[int, dict]:
    """Phase 2: hll_update, cm_update and root_path_sums on the card
    against their plain versions on the card, bit for bit, and timed.
    The sketches at the compaction step's shape (2**22 trace-ID rows of
    the entry's inputs in merge order, int64 limbs, `valid` the step's
    masks: each trace's first surviving row for HLL, every surviving row
    for count-min), with u32 weights, at p = 4 and p = 18 (global atomics),
    a count-min of 8 x 8,192 (global atomics), the step's keys as sorted
    traces of 8 spans and with every row invalid for count-min, at the
    block writer's shape (2**17 int32 IDs) and at two generator pushes (64
    and 4,096 edge keys of the demo's services; count-min also at 1, 31,
    33, 257 and 4,096 keys with weights near 2**32) and a block writer's
    flush (8,192 and 8,193 IDs); the root sums over 2**21 spans a launch
    a round, as chains of depth 8 and 2,048, a forest with roots scattered through it
    and one with parent cycles, and given the trace segments (one launch
    over whole traces, and its pinned dispatch) as trace_forests makes
    them. Returns (cases held, timing records)."""
    import numpy as np

    from tempo_tpu_torch.entry import entry
    from tempo_tpu_torch.graph import edge_hash_limbs
    from tempo_tpu_torch.model.synth import SERVICES
    from tempo_tpu_torch.ops import _build, merge, sketch
    from tempo_tpu_torch.ops import graph as ops_graph
    from tempo_tpu_torch.ops.hashing import MASK32
    from tempo_tpu_torch.ops.pallas_kernels import u32_bits

    n_cases = 0
    recs = {}

    _, (tids, sids, valid) = entry(device=dev, n_rows=1 << 22)
    plan = merge.merge_spans(tids, sids, valid)
    perm, keep = plan["perm"].to(torch.int64), plan["keep"]
    st = tids[perm].contiguous()
    first = (merge.first_occurrence_mask(st, valid[perm]) & keep).contiguous()
    del tids, sids, plan, perm
    pairs = rng.integers(0, len(SERVICES), (4096, 2))
    edges = torch.from_numpy(np.stack([edge_hash_limbs(SERVICES[a], SERVICES[b])
                                       for a, b in pairs]).view(np.int32)).to(dev)
    writer_ids = torch.from_numpy(
        rng.integers(0, 2**32, (1 << 17, 4), dtype=np.uint32).view(np.int32)).to(dev)

    def hll_case(label, keys, p, v):
        want = sketch._hll_update_plain(sketch.hll_init(p, dev), keys, p, v)
        got = sketch.hll_update(sketch.hll_init(p, dev), keys, p, v)
        check(torch.equal(got, want), f"hll_update {label}: kernel != plain")

    def cm_case(label, keys, p, w, v):
        start = torch.from_numpy(rng.integers(0, 2**32, (p.depth, p.width))).to(dev)
        want = sketch._cm_update_plain(start, keys, p, w, v)
        got = sketch.cm_update(start, keys, p, w, v)
        check(torch.equal(got, want), f"cm_update {label}: kernel != plain")

    hp, cp = sketch.HLLPlan(12), sketch.CMPlan(4, 1 << 12)
    w32 = torch.from_numpy(rng.integers(0, 2**32, st.shape[0])).to(dev)
    for label, keys, v in (("compaction 2^22 int64", st, first), ("compaction all rows", st, None),
                           ("writer 2^17 int32", writer_ids, None), ("push 64", edges[:64], None),
                           ("push 4096", edges, None), ("one key", edges[:1], None),
                           ("flush 8192 int32", writer_ids[:8192], None),
                           ("flush 8193 int32", writer_ids[:8193], None)):
        # every row of the 2^22 at the shared-memory and the global size
        for prec in (12, 18) if v is None and keys is st else (4, 12, 14, 15, 18):
            hll_case(f"{label} p={prec}", keys, sketch.HLLPlan(prec), v)
            n_cases += 1
    # the step's keys as sorted traces of 8 spans (a warp's lanes add to
    # the same counters), weights near 2**32 (their sums wrap)
    sorted8 = st[torch.arange(st.shape[0], device=dev) // 8 * 8].contiguous()
    near = torch.from_numpy(rng.integers(2**32 - 2**20, 2**32, 4096)).to(dev)
    cm_inputs = [("compaction 2^22 int64", st, None, keep),
                 ("compaction weighted", st, w32, keep),
                 ("sorted traces of 8", sorted8, None, keep),
                 ("every row invalid", st, None, torch.zeros_like(keep)),
                 ("push 64", edges[:64], None, None), ("push 4096", edges, None, None),
                 ("push 4096 weights near 2^32", edges, near, None),
                 ("writer 2^17 int32", writer_ids, None, None)]
    cm_inputs += [(f"push n={k} weights near 2^32", edges[:k], near[:k], None)
                  for k in (1, 31, 33, 257)]
    for label, keys, w, v in cm_inputs:
        for p in (cp, sketch.CMPlan(1, 1 << 4), sketch.CMPlan(8, 1 << 13)):
            cm_case(f"{label} {p.depth}x{p.width}", keys, p, w, v)
            n_cases += 1

    def sketch_record(kind, label, keys, p, v, w=None):
        """kernel / path / plain / library times and the bound at one shape."""
        n = keys.shape[0]
        limb_bytes = keys.element_size()
        n_valid = n if v is None else int(v.sum())
        vb = None if v is None else v.to(torch.bool).contiguous()
        wb = None if w is None else u32_bits(w).contiguous()
        if kind == "hll":
            out = sketch.hll_init(p, dev)

            def launch():
                _build.check(lib.tt_hll_update(keys.data_ptr(), 4, limb_bytes,
                                               None if vb is None else vb.data_ptr(), n, p.m,
                                               out.data_ptr(), stream()), "hll_update")
            path = path_ms(torch, lambda: sketch.hll_update(out, keys, p, v))
            plain = path_ms(torch, lambda: sketch._hll_update_plain(out, keys, p, v))
            # one scatter-max of the ranks by register (the hashing done
            # before: the library call computes the fold, not the hashes)
            base = sketch.hashing.fnv1a_32(keys)
            idx = sketch.hashing.fmix32(base, 0x2545F491) & (p.m - 1)
            rho = sketch._clz32(sketch.hashing.fmix32(base, 0x27220A95)) + 1
            if v is not None:
                idx, rho = idx[v], rho[v]
            regs = torch.zeros(p.m, dtype=torch.int64, device=dev)
            lib_ms = path_ms(torch, lambda: regs.scatter_reduce_(0, idx, rho, "amax"))
            # the function reads the keys of the valid rows only (the
            # kernel tests the mask before it hashes; an int64 row is one
            # 32-byte sector), the mask once and the registers in and out
            nbytes = n_valid * 4 * limb_bytes + (0 if v is None else n) + 2 * p.m * 8
            ops = n_valid * HLL_OPS
            counters = p.m
        else:
            out = sketch.cm_init(p, dev)

            def launch():
                _build.check(lib.tt_cm_update(keys.data_ptr(), 4, limb_bytes,
                                              None if wb is None else wb.data_ptr(),
                                              None if vb is None else vb.data_ptr(), n, p.depth,
                                              p.width, (sketch.CM_SEED * 31) & MASK32,
                                              out.data_ptr(), stream()), "cm_update")
            path = path_ms(torch, lambda: sketch.cm_update(out, keys, p, w, v))
            plain = path_ms(torch, lambda: sketch._cm_update_plain(out, keys, p, w, v))
            # one index_add_ of the weights by counter (the hashing done before)
            cells = (torch.arange(p.depth, device=dev)[:, None] * p.width
                     + sketch._cm_indices(keys, p)).reshape(-1)
            ones = torch.ones(cells.shape[0], dtype=torch.int64, device=dev)
            flat = torch.zeros(p.depth * p.width, dtype=torch.int64, device=dev)
            lib_ms = path_ms(torch, lambda: flat.index_add_(0, cells, ones))
            # keys and weights of the valid rows only, as for HLL
            nbytes = (n_valid * 4 * limb_bytes + (0 if v is None else n)
                      + (0 if w is None else 4 * n_valid) + 2 * p.depth * p.width * 8)
            ops = n_valid * (HASH_OPS + p.depth * CM_OPS_A_ROW)
            counters = p.depth * p.width
        ms = kernel_ms(torch, [launch])
        bnd, by = bound_ms(nbytes, ops)
        rec = dict(shape=f"{label}: N={n} ({n_valid} valid), {limb_bytes}-byte limbs, "
                         f"{counters} counters", max_abs_err=0, ms=ms, path_ms=path,
                   plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib_ms)
        recs.setdefault(f"{kind}_update", {})[label] = rec
        print(f"phase 2 {kind}_update {label}: equal | kernel {ms:.5f} ms ({bnd / ms:.0%} of "
              f"bound), path {path:.4f} ms, plain {plain:.4f} ms, library {lib_ms:.4f} ms "
              f"({'scatter_reduce_ amax' if kind == 'hll' else 'index_add_'} of the hashed "
              f"keys), bound {bnd:.5f} ms ({by}; {rec['shape']})", flush=True)

    sketch_record("hll", "compaction", st, hp, first)
    sketch_record("hll", "generator push", edges, hp, None)
    sketch_record("hll", "block-writer flush", writer_ids[:8192].contiguous(), hp, None)
    sketch_record("hll", "p=18 compaction", st, sketch.HLLPlan(18), first)
    sketch_record("cm", "compaction", st, cp, keep)
    sketch_record("cm", "generator push", edges, cp, None)
    sketch_record("cm", "weighted compaction", st, cp, keep, w32)
    sketch_record("cm", "sorted traces of 8", sorted8, cp, keep)
    sketch_record("cm", "8x8192 compaction", st, sketch.CMPlan(8, 1 << 13), keep)
    del st, first, keep, w32, sorted8

    # ---- root_path_sums over 2**21 spans
    n = 1 << 21
    row = np.arange(n)
    forest = np.where(rng.random(n) < 0.02, -1, rng.integers(0, n, n))
    forest = np.where(forest >= row, -1, forest)
    cycles = forest.copy()
    k = rng.choice(n, 4096, replace=False)
    cycles[k] = k[::-1]
    shapes = {"chains depth 8": np.where(row % 8 == 0, -1, row - 1),
              "chains depth 2048": np.where(row % 2048 == 0, -1, row - 1),
              "forest": forest, "cycles": cycles}
    rounds = ops_graph._n_rounds(n)
    for label, parent in shapes.items():
        s = rng.integers(0, 2**63, n)
        p_d = torch.from_numpy(parent.astype(np.int32)).to(dev)
        s_d = torch.from_numpy(s).to(dev)
        want = ops_graph._root_path_sums_plain(p_d, s_d, rounds)
        got = ops_graph.root_path_sums(p_d, s_d)
        check(torch.equal(got, want), f"root_path_sums {label}: kernel != plain")
        if label == "cycles":  # the numpy host arm takes seconds at 2^21
            host = ops_graph.root_path_sums_host(parent, s.view(np.uint64))
            check(np.array_equal(got.cpu().numpy().view(np.uint64), host),
                  f"root_path_sums {label}: kernel != the host arm")
        n_cases += 1
        if not label.startswith("chains"):
            continue
        bufs = [torch.empty_like(p_d), torch.empty_like(s_d), torch.empty_like(p_d),
                torch.empty_like(s_d)]
        launched = ctypes.c_int32(0)

        def launch():
            _build.check(lib.tt_root_path_sums(p_d.data_ptr(), s_d.data_ptr(), n, rounds,
                                               *(b.data_ptr() for b in bufs),
                                               ctypes.byref(launched), stream()),
                         "root_path_sums")
        ms = kernel_ms(torch, [launch], k=8)
        path = path_ms(torch, lambda: ops_graph.root_path_sums(p_d, s_d), reps=9)
        plain = path_ms(torch, lambda: ops_graph._root_path_sums_plain(p_d, s_d, rounds), reps=5)
        dispatch = path_ms(torch, lambda: ops_graph.root_path_sums_device(
            parent, s.view(np.uint64), dev), reps=5, warmup=1)
        # the rounds this input needs: the host arm's, which stop once every
        # pointer is -1 (the kernel runs all `rounds`, as the JAX arm does)
        depth = int(label.split()[-1])
        needed = int(np.ceil(np.log2(depth))) + 1
        bnd, by = bound_ms(20 * n, n * needed * 4)
        recs.setdefault("root_path_sums", {})[label] = dict(
            shape=f"n={n}, {label}, {rounds} rounds ({launched.value} launches a call; "
                  f"{needed} needed)", max_abs_err=0, ms=ms, path_ms=path, plain_ms=plain,
            dispatch_ms=dispatch, bound_ms=bnd, bound_by=by, library_ms=None,
            kernels_a_call=launched.value)
        print(f"phase 2 root_path_sums {label}: equal | kernel {ms:.4f} ms ({bnd / ms:.1%} of "
              f"bound, {launched.value} launches a call), path {path:.4f} ms, plain {plain:.4f} "
              f"ms, the graph_critical_path dispatch (copies in and out) {dispatch:.4f} ms, "
              f"library none (no one torch call does pointer doubling), bound {bnd:.5f} ms "
              f"({by}; 20 B a span)", flush=True)

    # ---- root_path_sums given the trace segments: one launch over whole traces
    tile = 8192  # the rows a CTA holds in shared memory (kRpsTile)
    for label, (parent, firsts, needed) in trace_forests(np, n, rng, tile).items():
        s = rng.integers(0, 2**63, n)
        p_d = torch.from_numpy(parent.astype(np.int32)).to(dev)
        s_d = torch.from_numpy(s).to(dev)
        f_d = torch.from_numpy(firsts.astype(np.int32)).to(dev)
        want = ops_graph._root_path_sums_plain(p_d, s_d, rounds)
        got = ops_graph.root_path_sums(p_d, s_d, firsts=f_d)
        check(torch.equal(got, want), f"root_path_sums {label}: segmented kernel != plain")
        got_h = ops_graph.root_path_sums_device(parent, s.view(np.uint64), dev, firsts=firsts)
        check(np.array_equal(got_h, want.cpu().numpy().view(np.uint64)),
              f"root_path_sums {label}: the pinned dispatch != plain")
        n_cases += 2
        out = torch.empty_like(s_d)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        scratch = torch.empty(4 * n, dtype=torch.int64, device=dev)
        launched = ctypes.c_int32(0)

        def launch():
            _build.check(lib.tt_root_path_sums_segmented(
                p_d.data_ptr(), s_d.data_ptr(), f_d.data_ptr(), n, len(firsts), rounds,
                out.data_ptr(), scratch.data_ptr(), flag.data_ptr(), ctypes.byref(launched),
                stream()), "root_path_sums")
        ms = kernel_ms(torch, [launch], k=16)
        check(int(flag.item()) == 0 and torch.equal(out, want),
              f"root_path_sums {label}: the timed launches != plain")
        path = path_ms(torch, lambda: ops_graph.root_path_sums(p_d, s_d, firsts=f_d), reps=9)
        plain = path_ms(torch, lambda: ops_graph._root_path_sums_plain(p_d, s_d, rounds), reps=5)
        dispatch = path_ms(torch, lambda: ops_graph.root_path_sums_device(
            parent, s.view(np.uint64), dev, firsts=firsts), reps=9, warmup=2)
        before = (path_ms(torch, lambda: ops_graph.root_path_sums_device(
            parent, s.view(np.uint64), dev), reps=5, warmup=1)
                  if label.startswith("traces chains") else None)
        # parents and self times in, the sums out, and the int32 trace starts
        bnd, by = bound_ms(20 * n + 4 * len(firsts), n * needed * 4)
        recs.setdefault("root_path_sums", {})[label] = dict(
            shape=f"n={n}, {label}, {len(firsts)} traces, up to {rounds} rounds ({needed} "
                  f"needed), firsts given", max_abs_err=0, ms=ms, path_ms=path,
            plain_ms=plain, dispatch_ms=dispatch, dispatch_ms_without_firsts=before,
            bound_ms=bnd, bound_by=by, library_ms=None, kernels_a_call=launched.value)
        print(f"phase 2 root_path_sums {label} (firsts given): equal | kernel {ms:.5f} ms "
              f"({bnd / ms:.1%} of bound, {launched.value} launch a call), path {path:.4f} ms, "
              f"plain {plain:.4f} ms, the graph_critical_path dispatch {dispatch:.4f} ms "
              f"(pinned, one copy each way)"
              + ("" if before is None else f", without firsts {before:.4f} ms (pageable copies, "
                 f"{rounds} launches)")
              + f", library none, bound {bnd:.5f} ms ({by}; 20 B a span, 4 B a trace)",
              flush=True)
    return n_cases, recs


def trace_forests(np, n: int, rng, tile: int) -> dict:
    """label -> (parent rows, firsts, rounds needed) of n trace-sorted spans,
    every parent inside its own trace: chains of 8 and of 2,048, random
    in-trace forests (1 to 300 spans a trace, parents before or after the
    child) with two-cycles inside traces, and chains of 8 around one
    trace of three tiles, a chain through its rows in random order."""
    from tempo_tpu_torch.ops import graph as ops_graph

    row = np.arange(n)
    out = {}
    for depth in (8, 2048):
        out[f"traces chains depth {depth}"] = (
            np.where(row % depth == 0, -1, row - 1), np.arange(0, n, depth),
            int(np.ceil(np.log2(depth))) + 1)
    sizes = rng.integers(1, 301, n // 2)
    firsts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    firsts = firsts[firsts < n]
    ends = np.append(firsts[1:], n)
    seg = np.repeat(np.arange(len(firsts)), ends - firsts)
    lo, size = firsts[seg], (ends - firsts)[seg]
    order = np.lexsort((rng.random(n), seg))  # each trace's rows in random order
    k = row - lo
    parent = np.full(n, -1, np.int64)
    parent[order] = np.where(k > 0, order[lo + (rng.random(n) * k).astype(np.int64)], -1)
    a = rng.choice(n, n // 64, replace=False)
    a = a[size[a] >= 2]
    b = lo[a] + (a - lo[a] + 1 + rng.integers(0, 1 << 30, len(a)) % (size[a] - 1)) % size[a]
    parent[a], parent[b] = b, a
    out["traces in-trace cycles"] = (parent, firsts, ops_graph._n_rounds(n))
    big, at = 3 * tile, (n // 2) & ~7  # both multiples of 8: the chains after it line up
    parent = np.where(row % 8 == 0, -1, row - 1)
    order = at + rng.permutation(big)
    parent[order] = np.append(-1, order[:-1])
    firsts = np.concatenate([np.arange(0, at, 8), [at], np.arange(at + big, n, 8)])
    out["traces over the tile"] = (parent, firsts, int(np.ceil(np.log2(big))) + 1)
    return out


def resident_kernels_check(torch, dev, rng) -> int:
    """Phase 2: the resident scans on the card against their plain versions
    on the CPU, bit for bit: rle at 1 to 3 of its 8,192-run tiles with run
    lengths summing below, to and past n (zero-length runs, values equal
    to NO_MATCH_CODE, the code-set padding; the code set by value, and
    above the by-value cap in device memory); dct at 1 to 40,000
    dictionary entries and at n/2 of 65,536 rows (the bitset up to 1,024
    entries, a verdict a row above; in-set with the code set by value from the
    CPU, above the by-value cap and on the card, inverted, between over
    the top half of u32; indices at jnp's edges); dbp at every width 0-64
    at 1 to 70,000 rows (one CTA, clusters
    of 256- and of 512-thread CTAs, shares of one and of two row tiles),
    with bounds that cut inside a limb; then the batched rle, dct and dbp
    scans over mixed page tables (pages of no run and of n == 0, a page
    of more than one run tile, dictionaries of 1 to 32,768 entries, every
    dbp width, a 65,536-row page and a 70,000-row one). Returns the cases
    held."""
    import numpy as np

    from tempo_tpu_torch.ops import scan

    def u32(a):
        return torch.from_numpy(np.array(a, np.uint32).view(np.int32))

    def same(label, fn, *args, **kw):
        want = fn(*args, **kw)
        got = fn(*(a.to(dev) if torch.is_tensor(a) else a for a in args), **kw)
        check(torch.equal(got.cpu(), want), f"{fn.__name__} {label}: kernel != plain")

    n_cases = 0
    big = u32(np.arange(300, dtype=np.uint32) * 7)  # over the by-value cap
    for r, per_run in ((1, 5), (7, 3), (2048, 2), (8193, 1), (20000, 3)):
        values = rng.integers(0, 60, r).astype(np.uint32)
        values[::13] = 0xFFFFFFFF
        lengths = rng.integers(0, 2 * per_run + 1, r).astype(np.int32)
        total = int(lengths.sum())
        codes = u32(scan.pad_codes_u32(np.array([3, 9, 0xFFFFFFFF, 40, 41], np.uint32)))
        for n in sorted({1, max(1, total - 7), max(1, total), total + 9}):
            args = (u32(values), torch.from_numpy(lengths), n)
            same(f"R={r} n={n} in", scan.resident_rle_scan, *args, codes=codes)
            same(f"R={r} n={n} not in", scan.resident_rle_scan, *args, codes=codes, invert=True)
            same(f"R={r} n={n} in 300", scan.resident_rle_scan, *args, codes=big)
            same(f"R={r} n={n} between", scan.resident_rle_scan, *args, lo=7, hi=2**32 - 2)
            n_cases += 4
    def dct_page(v, n):
        """(dictionary, idx) of n rows over v entries, a few indices at
        jnp's edges (negative from the end, below -v, at and past v)."""
        dvals = rng.integers(0, 2**32, v, dtype=np.uint64).astype(np.uint32)
        dvals[::11] = 0xFFFFFFFF
        idx = rng.integers(0, max(v, 1), n).astype(np.int32)
        edges = np.array([-1, -v, -v - 1, v, v + 5], np.int32)
        idx[::101] = edges[np.arange(len(idx[::101])) % len(edges)]
        return u32(dvals), torch.from_numpy(idx)

    for v, n in ((1, 1), (9, 4097), (257, 65536), (300, 70_000), (1024, 4096), (1025, 4096),
                 (2048, 65536), (32768, 65536), (40_000, 5000)):
        dvals, idx = dct_page(v, n)
        codes = u32(scan.pad_codes_u32(dvals[:3].numpy().view(np.uint32)))  # by value
        for kw in ({"codes": codes}, {"codes": codes, "invert": True}, {"codes": big},
                   {"codes": codes.to(dev)}, {"lo": 2**31, "hi": 2**32 - 1}):
            want = scan.resident_dct_scan(dvals, idx, **{k: x.cpu() if torch.is_tensor(x)
                                                          else x for k, x in kw.items()})
            got = scan.resident_dct_scan(dvals.to(dev), idx.to(dev), **kw)
            check(torch.equal(got.cpu(), want),
                  f"resident_dct_scan V={v} n={n} {sorted(kw)}: kernel != plain")
            n_cases += 1
    for width in range(65):
        for n in (1, 2, 8193, 16385, 40000, 70000):
            words, first = _dbp_words(np, rng, width, n)
            words = u32(words)
            for lo, hi in ((0, 2**64 - 1), (first, first + 2**33),
                           ((first & ~0xFFFFFFFF) + 3, (first | 0xFFFFFFFF) - 3)):
                lo, hi = sorted((lo % 2**64, hi % 2**64))
                want = scan.resident_dbp_scan(words, first, width, n, lo, hi)
                got = scan.resident_dbp_scan(words.to(dev), first, width, n, lo, hi)
                check(torch.equal(got.cpu(), want),
                      f"resident_dbp_scan width={width} n={n}: kernel != plain")
                n_cases += 1
    # the batched scans over mixed page tables
    pages = []
    for r, n_of in ((5, lambda t: t + 3), (60, lambda t: t), (40, lambda t: max(1, t - 5)),
                    (20000, lambda t: t + 1), (3, lambda t: 0), (0, lambda t: 9),
                    (3623, lambda t: 32768)):
        values = rng.integers(0, 9, r).astype(np.uint32)
        lengths = rng.integers(0, 5, r).astype(np.int32)
        pages.append((u32(values), torch.from_numpy(lengths), n_of(int(lengths.sum()))))
    gpu = [(v.to(dev), ln.to(dev), n) for v, ln, n in pages]
    for kw in ({"codes": u32(scan.pad_codes_u32(np.array([1, 4, 0xFFFFFFFF], np.uint32)))},
               {"codes": u32(np.array([2], np.uint32)), "invert": True},
               {"codes": big}, {"lo": 2, "hi": 6}):
        want, offs = scan.resident_rle_scan_batch(pages, **kw)
        got, goffs = scan.resident_rle_scan_batch(gpu, **kw)
        got = got.cpu()  # each page's mask; the padding between them is not written
        check(goffs == offs and all(torch.equal(got[o:o + n], want[o:o + n])
                                    for (_, _, n), o in zip(pages, offs)),
              f"resident_rle_scan_batch {sorted(kw)}: kernel != plain")
        n_cases += 1
    small = [dct_page(v, n) for v, n in ((1, 37), (257, 65536), (5, 0), (60, 120), (700, 3000),
                                         (1, 1), (9, 4097))]
    # the bitset's table, then one with a dictionary a verdict a row takes
    for cpages in (small, small + [dct_page(32768, 65536)]):
        gpu = [(v.to(dev), i.to(dev)) for v, i in cpages]
        for kw in ({"codes": u32(scan.pad_codes_u32(np.array([1, 4, 0xFFFFFFFF], np.uint32)))},
                   {"codes": u32(np.array([2], np.uint32)), "invert": True},
                   {"codes": big}, {"lo": 2**31, "hi": 2**32 - 1}):
            want, offs = scan.resident_dct_scan_batch(cpages, **kw)
            got, goffs = scan.resident_dct_scan_batch(gpu, **kw)
            got = got.cpu()
            check(goffs == offs and all(torch.equal(got[o:o + i.numel()], want[o:o + i.numel()])
                                        for (_, i), o in zip(cpages, offs)),
                  f"resident_dct_scan_batch {sorted(kw)} ({len(cpages)} pages): kernel != plain")
            n_cases += 1
    dpages = []
    for width, n in [(w, 300) for w in range(65)] + [(31, 65536), (17, 70000), (9, 0), (5, 1)]:
        words, first = _dbp_words(np, rng, width, n)
        dpages.append((u32(words), first, width, n))
    gpu = [(w.to(dev), f, width, n) for w, f, width, n in dpages]
    first = dpages[66][1]
    for lo, hi in ((0, 2**64 - 1), (first, first + 2**33), (2**64 - 1, 2**64 - 1),
                   ((first & ~0xFFFFFFFF) + 3, (first | 0xFFFFFFFF) - 3)):
        lo, hi = sorted((lo % 2**64, hi % 2**64))
        want, offs = scan.resident_dbp_scan_batch(dpages, lo, hi)
        got = scan.resident_dbp_scan_batch(gpu, lo, hi)[0].cpu()
        check(all(torch.equal(got[o:o + p[3]], want[o:o + p[3]]) for p, o in zip(dpages, offs)),
              f"resident_dbp_scan_batch [{lo}, {hi}]: kernel != plain")
        n_cases += 1
    return n_cases


def tier_phase(root: str, inputs: dict, compacted_block_id: str, plan_of,
               device: str = "cuda") -> dict:
    """Phase 10, the device-resident hot tier. TempoDB(device="cuda") over
    phase 7's compacted block. Phase 8's four simple-count query_range
    queries run first with the tier off, through the querier's compiled
    tier. Then the tier is configured on the card (1,024 MB; `device` is
    "cpu" only in a rehearsal without a card) and three
    passes each run phase 7's seven unbounded tag searches and the four
    queries: cold (the tier empty, the page-heat ledger recording; the
    searches and the queries twice), admitting (after refresh_admission(force=True): the
    pages and stacks inside the what-if knee go to the card as the
    queries reach them) and resident (served by the resident scans and
    the resident stacks). Every search answer equals phase 7's numpy
    oracle and its tier-off answer over the same block, every matrix the
    tier-off one; a stack admitted in the admitting pass must be served
    from the card in the resident pass. Returns its numbers; res["tier"]
    is the configured tier, for the kernel timing."""
    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.config_sections import DeviceTierConfig
    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import SearchRequest
    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.modules.querier import Querier
    from tempo_tpu_torch.ops import scan
    from tempo_tpu_torch.util import pageheat
    from tempo_tpu_torch.util.devicetiming import STATS

    tenant = "smoke"
    res: dict = {"passes": [], "compiled": []}
    t_phase = time.perf_counter()
    db = TempoDB(DBConfig(backend="local", backend_path=os.path.join(root, "blocks"),
                          wal_path=os.path.join(root, "wal-tier")), device=device)
    db.poll_now()
    metas = db.blocklist.metas(tenant)
    check([m.block_id for m in metas] == [compacted_block_id],
          f"phase 10: blocks {[m.block_id for m in metas]}, wanted phase 7's compacted block")
    querier = Querier(db)
    ids = [m.block_id for m in metas]

    def matrix(q):
        """One simple-count query_range job over the block, through the
        querier's compiled tier: (matrix, ms)."""
        plan = plan_of(q)
        t0 = time.perf_counter()
        wire = querier.query_range_blocks(tenant, ids, q, plan.start_s, plan.end_s, plan.step_s)
        ms = (time.perf_counter() - t0) * 1e3
        check(wire.get("compiledShape") in ("hit", "miss"),
              f"phase 10 {q}: the compiled tier did not take it ({wire.get('compiledShape')})")
        merged = M.new_wire()
        M.merge_wire(merged, wire, plan)
        return M.finalize_matrix(plan, merged)["result"], ms

    check(colcache.configure_device_tier(None, device=device) is None, "phase 10: tier on")
    want = {}
    for q in SIMPLE_COUNT:
        want[q], ms = matrix(q)
        check(want[q], f"phase 10 {q}: empty matrix")
        res["compiled"].append(dict(query=q, run="tier off", ms=ms))

    pageheat.LEDGER.reset()
    tier = colcache.configure_device_tier(DeviceTierConfig(budget_mb=1024), device=device)
    check(tier is colcache.shared_device_tier() and tier.device.type == device,
          f"phase 10: the tier is not on {device}")
    # the admission set changes only at the admitting pass's forced refresh:
    # a timed one (every refresh_s) would admit pages inside a cold pass
    # slower than refresh_s, or between the resident pass and its per-page
    # loop, which then would not see the same residents
    tier.refresh_s = float("inf")
    colcache.shared_cache().clear()
    print(f"phase 10 tier: DeviceTier on {tier.device}, {tier.budget_bytes >> 20} MB, over "
          f"block {compacted_block_id} ({metas[0].total_spans} spans)", flush=True)

    def counts():
        st = tier.stats()
        return dict(hits=st["hits"], avoided_bytes=st["avoided_bytes"],
                    admissions=st["admissions"], entries=st["entries"],
                    admission_h2d_bytes=STATS.h2d.get("device_tier_admit", 0),
                    stack_avoided_bytes=STATS.avoided.get("compiled_metrics", 0),
                    compiled_dispatches=STATS.dispatches.get("compiled_metrics", 0),
                    **{k: getattr(scan, k).launches for k in RESIDENT_KERNELS})

    def searches(name, reps=1):
        """Phase 7's unbounded searches, each answer held to its oracle and
        its tier-off answer: (rows, the counters they moved)."""
        before = counts()
        rows = []
        for label, kw in inputs["searches"] * reps:
            t0 = time.perf_counter()
            r = db.search(tenant, SearchRequest(limit=0, **kw))
            ms = (time.perf_counter() - t0) * 1e3
            hits = {h.trace_id_hex for h in r.traces}
            check(len(hits) == len(r.traces) and hits == inputs["oracle"][label]
                  and hits == inputs["tier_off"][label],
                  f"phase 10 {name} search {label}: {len(hits)} hits, oracle "
                  f"{len(inputs['oracle'][label])}, tier off {len(inputs['tier_off'][label])}")
            rows.append(dict(search=label, ms=ms, hits=len(hits)))
        after = counts()
        return rows, {k: after[k] - before[k] for k in after}

    # the resident pass's batched stage 1: the largest batch of each codec,
    # for the kernels' timing at one search's stage-1 pages, and the pages
    # of each codec its batches took
    batches: dict = {}
    stage1_pages = {"rle": 0, "dct": 0, "dbp": 0}
    spied = {fn: getattr(scan, fn) for fn in ("resident_in_set_masks", "resident_range_masks")}

    def spy(fn):
        def call(entries, *args, **kw):
            for codec in stage1_pages:
                group = [e for e in entries if e.codec == codec]
                stage1_pages[codec] += len(group)
                if len(group) > len(batches.get(codec, ((),))[0]):
                    batches[codec] = (group, fn, args, kw)
            return spied[fn](entries, *args, **kw)
        return call

    admitted_stacks = set()
    for name in ("cold", "admitting", "resident"):
        if name == "admitting":
            tier.refresh_admission(force=True)
            with tier._lock:
                res["admission_set_pages"] = len(tier._admit_keys)
                res["admission_budget_bytes"] = tier._admit_budget
        before = counts()
        # the cold pass twice: the ledger admits a page once it has
        # shipped twice (admit_min_ships), and a dbp page ships once a pass
        if name == "resident":
            for fn in spied:
                setattr(scan, fn, spy(fn))
        try:
            rows, _ = searches(name, 2 if name == "cold" else 1)
        finally:
            for fn, real in spied.items():
                setattr(scan, fn, real)
        searched = counts()
        for rep in range(2 if name == "cold" else 1):
            for q in SIMPLE_COUNT:
                b = counts()
                got, ms = matrix(q)
                check(got == want[q], f"phase 10 {name} {q}: matrix != the tier-off matrix")
                a = counts()
                row = dict(query=q, run=name, ms=ms,
                           dispatches=a["compiled_dispatches"] - b["compiled_dispatches"],
                           admissions=a["admissions"] - b["admissions"],
                           stack_avoided_bytes=a["stack_avoided_bytes"] - b["stack_avoided_bytes"])
                check(row["dispatches"] > 0, f"phase 10 {name} {q}: compiled_metrics idle")
                if name == "admitting" and row["admissions"]:
                    admitted_stacks.add(q)
                if name == "resident" and q in admitted_stacks:
                    check(row["admissions"] == 0 and row["stack_avoided_bytes"] > 0,
                          f"phase 10 {q}: an admitted stack not served from the card ({row})")
                row["resident"] = row["stack_avoided_bytes"] > 0
                res["compiled"].append(row)
        after = counts()
        search_delta = {k: searched[k] - before[k] for k in after}
        res["passes"].append(dict(
            name=name, search_ms=sum(r["ms"] for r in rows), searches=rows,
            search_counts=search_delta,
            query_counts={k: after[k] - searched[k] for k in after}, entries=after["entries"]))
        each = ", ".join("%.0f" % r["ms"] for r in rows)
        print(f"phase 10 {name} pass: {len(rows)} unbounded searches = oracle = tier off | "
              f"{sum(r['ms'] for r in rows):.0f} ms ({each}) | tier hits "
              f"{search_delta['hits']}, avoided {search_delta['avoided_bytes']} B, admissions "
              f"{search_delta['admissions']} ({search_delta['admission_h2d_bytes']} B h2d), "
              f"{after['entries']} resident | launches "
              + ", ".join(f"{k} {search_delta[k]}" for k in RESIDENT_KERNELS), flush=True)
        for row in res["compiled"][-4:]:
            print(f"phase 10 {name} query_range: {row['query']} | matrix = tier off | "
                  f"{row['ms']:.1f} ms, {row['dispatches']} compiled_metrics dispatches, "
                  f"{row['admissions']} stack admissions, {row['stack_avoided_bytes']} B of "
                  f"stack h2d avoided", flush=True)
    # the resident pass once more through the per-page loop (the batched
    # stage 1 off): the same answers, the same tier hits and avoided bytes
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock

    real_stage1 = VtpuBackendBlock._resident_stage1
    VtpuBackendBlock._resident_stage1 = lambda self, *a, **k: {}
    try:
        loop_rows, loop = searches("per-page loop")
    finally:
        VtpuBackendBlock._resident_stage1 = real_stage1
    batched = res["passes"][-1]["search_counts"]
    for k in ("hits", "avoided_bytes", "admissions", "admission_h2d_bytes"):
        check(loop[k] == batched[k],
              f"phase 10: the batched search's {k} {batched[k]} != the per-page loop's {loop[k]}")
    check(all(loop[f"resident_{c}_scan_batch"] == 0 for c in stage1_pages),
          "phase 10: the per-page loop took a batch")
    res["per_page_loop"] = dict(search_ms=sum(r["ms"] for r in loop_rows), searches=loop_rows,
                                search_counts=loop)
    launches = {c: (batched[f"resident_{c}_scan"] + batched[f"resident_{c}_scan_batch"],
                    loop[f"resident_{c}_scan"]) for c in stage1_pages}
    res["resident_pass_launches"] = {
        c: dict(batched=b, per_page_loop=p, one_call_a_page=ONE_CALL_A_PAGE[c],
                stage1_pages_batched=stage1_pages[c],
                # the calls a page left in the batched pass: stage 2's
                stage2_calls=batched[f"resident_{c}_scan"])
        for c, (b, p) in launches.items()}
    print(f"phase 10 per-page loop: the {len(loop_rows)} searches again with the batched stage "
          f"1 off: answers = oracle = tier off, tier hits {loop['hits']} and avoided "
          f"{loop['avoided_bytes']} B = the batched pass's | "
          f"{sum(r['ms'] for r in loop_rows):.0f} ms against "
          f"{res['passes'][-1]['search_ms']:.0f} ms batched",
          flush=True)
    for c, (b, p) in launches.items():
        print(f"phase 10 resident pass {c} launches: {b} with the batched stage 1 "
              f"({batched[f'resident_{c}_scan_batch']} batched over {stage1_pages[c]} stage-1 "
              f"pages + {batched[f'resident_{c}_scan']} a page, from stage 2), {p} through the "
              f"per-page loop, beside the {ONE_CALL_A_PAGE[c]} of one call a page", flush=True)
        check(b < p and b < ONE_CALL_A_PAGE[c],
              f"phase 10: {b} resident {c} launches batched, {p} through the per-page loop, "
              f"{ONE_CALL_A_PAGE[c]} one call a page")
        # a batched page saves its call, stage 2 keeps one call a page
        check(p - b == stage1_pages[c] - batched[f"resident_{c}_scan_batch"],
              f"phase 10: {c}: the loop's {p} calls less the batched pass's {b} launches != "
              f"{stage1_pages[c]} stage-1 pages less their batches")
    check(set(batches) == set(stage1_pages),
          f"phase 10: the resident pass batched only {sorted(batches)}")
    res["batches"] = batches
    cold, admitting, resident = (p["search_counts"] for p in res["passes"])
    check(cold["admissions"] == 0 and res["passes"][0]["entries"] == 0
          and all(cold[k] == 0 for k in RESIDENT_KERNELS),
          "phase 10 cold pass: the tier admitted or scanned before its admission set")
    check(admitting["admissions"] > 0 and admitting["admission_h2d_bytes"] > 0,
          "phase 10 admitting pass: no page admitted")
    check(resident["admissions"] == 0 and resident["hits"] > 0 and resident["avoided_bytes"] > 0
          and resident["admission_h2d_bytes"] == 0, f"phase 10 resident pass: {resident}")
    check(admitted_stacks, "phase 10: no compiled stack admitted")
    res["stacks_resident"] = sorted(admitted_stacks)
    res["stats"] = tier.stats()
    res["codecs_resident"] = sorted({r["codec"] for r in tier.resident_pages(top=1 << 20)})
    res["phase_s"] = time.perf_counter() - t_phase
    res["tier"] = tier
    db.shutdown()
    return res


def time_resident_kernels(torch, tier, batches, lib, stream) -> dict:
    """The resident scans at the largest resident page of each codec that
    phase 10 left on the card, and the batched rle and dbp scans at the
    resident pass's largest stage-1 batch of each codec (the pages of one
    search): kernel against plain there (in-set, inverted and between for
    rle and dct; a range cutting the page's values for dbp), then timed as
    in phase 2 (kernel by CUDA graph of the C entry point, path by the
    served call: resident_*_mask with its code set and the mask's copy
    home, resident_in_set_masks / resident_range_masks for a batch; the
    plain version on the card, the library chain, the bound: the pages'
    arrays and the code set read once, the masks written once, one
    compare a code and run or entry, a few operations a dbp row)."""
    import numpy as np

    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.ops import scan

    largest = {}
    for res in list(tier._lru.values()):
        if res.codec in ("rle", "dct", "dbp") and res.nbytes > getattr(
                largest.get(res.codec), "nbytes", -1):
            largest[res.codec] = res
    check(set(largest) == {"rle", "dct", "dbp"},
          f"phase 10: resident codecs {sorted(largest)}, wanted rle, dct and dbp")
    out = {}
    dev = tier.device

    def graph_ms(entry, fn_args, n):
        mask = torch.empty(n, dtype=torch.bool, device=dev)
        launched = ctypes.c_int32(0)

        def launch():
            _build.check(getattr(lib, entry)(*fn_args, mask.data_ptr(), ctypes.byref(launched),
                                             stream()), entry)
        launch()
        return mask, kernel_ms(torch, [launch]), launched.value

    def u64_bits(x):
        return x - 2**64 if x >= 2**63 else x

    # rle: the run values' three most common as the code set, by value
    res = largest["rle"]
    v, ln, n = res.arrays["values"], res.arrays["lengths"], int(res.meta["n"])
    r = v.numel()
    vals, cnt = torch.unique(v, return_counts=True)
    codes_np = scan.pad_codes_u32(vals[torch.argsort(cnt, descending=True)][:3].cpu().numpy()
                                  .view(np.uint32))
    codes = torch.from_numpy(codes_np.view(np.int32))
    codes_d = codes.to(dev)
    for kw in ({"codes": codes}, {"codes": codes, "invert": True}, {"lo": 1, "hi": 2**31}):
        check(torch.equal(scan.resident_rle_scan(v, ln, n, **kw),
                          scan._rle_scan_plain(v, ln, n, codes_d if "codes" in kw else None,
                                               kw.get("invert", False), kw.get("lo", 0),
                                               kw.get("hi", 0))),
              f"resident_rle_scan at the largest rle page {sorted(kw)}: kernel != plain")
    plain_mask = scan._rle_scan_plain(v, ln, n, codes_d, False, 0, 0)
    page = (ctypes.c_int64 * 8)(v.data_ptr(), ln.data_ptr(), r, n, 0, 0, 0, 0)
    rle_args = (page, codes.data_ptr(), codes.numel(), None, 0, 0, 0)
    mask, ms, kl = graph_ms("tt_resident_rle_scan", rle_args, n)
    check(torch.equal(mask, plain_mask), "resident_rle_scan graph launch != plain")
    v64 = v.to(torch.int64) & 0xFFFFFFFF
    c64 = codes_d.to(torch.int64) & 0xFFFFFFFF
    ln64 = ln.to(torch.int64)
    bnd, by = bound_ms(8 * r + 4 * codes.numel() + n, r * codes.numel() + n)
    out["resident_rle_scan"] = dict(
        shape=f"R={r} runs, n={n} rows, K={codes.numel()} codes (in-set)", max_abs_err=0, ms=ms,
        kernels_a_call=kl,
        path_ms=path_ms(torch, lambda: scan.resident_in_set_mask(res, codes_np)),
        plain_ms=path_ms(torch, lambda: scan._rle_scan_plain(v, ln, n, codes_d, False, 0, 0)),
        bound_ms=bnd, bound_by=by,
        library_ms=path_ms(torch, lambda: torch.repeat_interleave(torch.isin(v64, c64), ln64,
                                                                  output_size=n)))

    # dct: the dictionary's first three entries as the code set, by value
    res_d = largest["dct"]
    dv, idx, n_d = res_d.arrays["values"], res_d.arrays["idx"], int(res_d.meta["n"])
    codes_dct_np = scan.pad_codes_u32(dv[:3].cpu().numpy().view(np.uint32))
    codes_dct_h = torch.from_numpy(codes_dct_np.view(np.int32))
    codes_dct = codes_dct_h.to(dev)
    for kw in ({"codes": codes_dct_h}, {"codes": codes_dct_h, "invert": True},
               {"lo": 1, "hi": 2**31}):
        check(torch.equal(scan.resident_dct_scan(dv, idx, **kw),
                          scan._dct_scan_plain(dv, idx, codes_dct if "codes" in kw else None,
                                               kw.get("invert", False), kw.get("lo", 0),
                                               kw.get("hi", 0))),
              f"resident_dct_scan at the largest dct page {sorted(kw)}: kernel != plain")
    page_d = (ctypes.c_int64 * 8)(dv.data_ptr(), idx.data_ptr(), dv.numel(), n_d, 0, 0, 0, 0)
    mask, ms, kl = graph_ms("tt_resident_dct_scan", (page_d, codes_dct_h.data_ptr(),
                                                     codes_dct_h.numel(), None, 0, 0, 0), n_d)
    check(torch.equal(mask, scan._dct_scan_plain(dv, idx, codes_dct, False, 0, 0)),
          "resident_dct_scan graph launch != plain")
    dv64 = dv.to(torch.int64) & 0xFFFFFFFF
    cd64 = codes_dct.to(torch.int64) & 0xFFFFFFFF
    idx64 = idx.to(torch.int64)
    bnd, by = bound_ms(4 * dv.numel() + 4 * n_d + 4 * codes_dct.numel() + n_d,
                       dv.numel() * codes_dct.numel() + n_d)
    out["resident_dct_scan"] = dict(
        shape=f"V={dv.numel()} entries, n={n_d} rows, K={codes_dct.numel()} codes (in-set)",
        max_abs_err=0, ms=ms, kernels_a_call=kl,
        path_ms=path_ms(torch, lambda: scan.resident_in_set_mask(res_d, codes_dct_np)),
        plain_ms=path_ms(torch, lambda: scan._dct_scan_plain(dv, idx, codes_dct, False, 0, 0)),
        bound_ms=bnd, bound_by=by,
        library_ms=path_ms(torch, lambda: torch.isin(dv64, cd64)[idx64]))

    def dbp_plain(words, first, width, n_, lo, hi):
        f, w = scan._dbp_first_width(first, width, words.device)
        return scan._dbp_scan_plain(words, f, w, n_, lo, hi)

    def dbp_deltas(words, first, width, n_):
        """The page's values' steps, its first value as the first: one
        cumsum gives the values back (as int64, mod 2^64)."""
        f, w = scan._dbp_first_width(first, width, words.device)
        dec = pk._dbp_decode_plain(words[None, :], f, w, n_)[0]
        return dec, torch.diff(dec, prepend=torch.zeros(1, dtype=torch.int64, device=dev))

    res_b = largest["dbp"]
    words, n_b = res_b.arrays["words"], int(res_b.meta["n"])
    first, width = int(res_b.meta["first"]), int(res_b.meta["width"])
    dec, e = dbp_deltas(words, first, width, n_b)
    mid = int(dec.median())  # a range that cuts the page's values
    lo, hi = mid % 2**64, (mid + (1 << 33)) % 2**64
    want = dbp_plain(words, first, width, n_b, lo, hi)
    check(torch.equal(scan.resident_dbp_scan(words, first, width, n_b, lo, hi), want),
          "resident_dbp_scan at the largest dbp page: kernel != plain")
    page_b = (ctypes.c_int64 * 8)(words.data_ptr(), 0, words.numel(), n_b, u64_bits(first),
                                  width, 0, 0)
    mask, ms, kl = graph_ms("tt_resident_dbp_scan", (page_b, lo, hi), n_b)
    check(torch.equal(mask, want), "resident_dbp_scan graph launch != plain")
    bnd, by = bound_ms(4 * words.numel() + n_b, 4 * n_b)
    out["resident_dbp_scan"] = dict(
        shape=f"n={n_b} rows, width {width}, {words.numel()} words", max_abs_err=0, ms=ms,
        kernels_a_call=kl,
        path_ms=path_ms(torch, lambda: scan.resident_range_mask(res_b, lo, hi)),
        plain_ms=path_ms(torch, lambda: dbp_plain(words, first, width, n_b, lo, hi)),
        bound_ms=bnd, bound_by=by,
        # torch.cumsum over the unpacked deltas, then the compare (the
        # values as signed: this page's values lie below 2^63)
        library_ms=path_ms(torch, lambda: (lambda c: (c >= lo) & (c <= hi))(
            torch.cumsum(e, 0))))

    # the batched scans at the resident pass's largest stage-1 batch
    for codec, (group, fn, args, kw) in sorted(batches.items()):
        ns = [int(g.meta["n"]) for g in group]
        offs, total = scan._offsets(ns)
        rows = np.stack([g.row for g in group])  # the tier's page-table rows
        rows[:, 6] = offs
        offs = offs.tolist()
        if codec in ("rle", "dct"):  # a code set by value, or uint32 bounds
            if fn == "resident_in_set_masks":
                padded = scan.pad_codes_u32(args[0])
                bcodes = torch.from_numpy(padded.view(np.int32))
                invert = bool(kw.get("invert", False))
                plain_kw = dict(codes=bcodes.to(dev), invert=invert)
                c_args = (bcodes.data_ptr(), bcodes.numel(), None, 1 if invert else 0, 0, 0)
                k_codes = bcodes.numel()
                c_cat = plain_kw["codes"].to(torch.int64) & 0xFFFFFFFF
            else:
                blo, bhi = int(np.uint32(args[0])), int(np.uint32(args[1]))
                plain_kw = dict(lo=blo, hi=bhi)
                c_args = (None, 0, None, 2, blo, bhi)
                k_codes = 1
        if codec == "dct":
            pages = [(g.arrays["values"], g.arrays["idx"]) for g in group]
            v_all = sum(p[0].numel() for p in pages)
            plain = lambda: scan._dct_scan_batch_plain(  # noqa: E731
                pages, plain_kw.get("codes"), plain_kw.get("invert", False),
                plain_kw.get("lo", 0), plain_kw.get("hi", 0))
            nbytes = 4 * v_all + 4 * k_codes + 5 * sum(ns)
            ops = v_all * k_codes + sum(ns)
            # torch.isin over the concatenated dictionaries, then one gather
            # by the indices shifted to each page's dictionary (jnp's edges
            # clamped first)
            dv_cat = torch.cat([p[0] for p in pages]).to(torch.int64) & 0xFFFFFFFF
            base = np.cumsum([0] + [p[0].numel() for p in pages[:-1]])
            gidx = torch.cat([torch.where(p[1] < 0, p[1].to(torch.int64) + p[0].numel(),
                                          p[1].to(torch.int64)).clamp(0, p[0].numel() - 1) + int(b)
                              for p, b in zip(pages, base)])
            if fn == "resident_in_set_masks":
                library = lambda: torch.isin(dv_cat, c_cat)[gidx]  # noqa: E731
            else:
                library = lambda: ((dv_cat >= blo) & (dv_cat <= bhi))[gidx]  # noqa: E731
            entry = "tt_resident_dct_scan_batch"
            c_args = (max(p[0].numel() for p in pages),) + c_args
        elif codec == "rle":
            pages = [(g.arrays["values"], g.arrays["lengths"], nn) for g, nn in zip(group, ns)]
            plain = lambda: scan._rle_scan_batch_plain(  # noqa: E731
                pages, plain_kw.get("codes"), plain_kw.get("invert", False),
                plain_kw.get("lo", 0), plain_kw.get("hi", 0))
            r_all = sum(p[0].numel() for p in pages)
            nbytes, ops = 8 * r_all + 4 * k_codes + sum(ns), r_all * k_codes + sum(ns)
            v_cat = torch.cat([p[0] for p in pages]).to(torch.int64) & 0xFFFFFFFF
            ln_cat = torch.cat([p[1] for p in pages]).to(torch.int64)
            exact = all(int(p[1].sum()) == p[2] for p in pages)
            if fn == "resident_in_set_masks":
                hit = lambda: torch.isin(v_cat, c_cat)  # noqa: E731
            else:
                hit = lambda: (v_cat >= blo) & (v_cat <= bhi)  # noqa: E731
            library = (lambda: torch.repeat_interleave(hit(), ln_cat, output_size=sum(ns))) \
                if exact else None
            entry = "tt_resident_rle_scan_batch"
        else:
            blo, bhi = int(args[0]) & (2**64 - 1), int(args[1]) & (2**64 - 1)
            pages = [(g.arrays["words"], int(g.meta["first"]), int(g.meta["width"]), nn)
                     for g, nn in zip(group, ns)]
            c_args = (blo, bhi)
            plain = lambda: scan._dbp_scan_batch_plain(pages, blo, bhi)  # noqa: E731
            nbytes = sum(4 * p[0].numel() + p[3] for p in pages)
            ops = 4 * sum(ns)
            # one cumsum over every page's steps, each page's first step
            # taking it from the page before's last value to its first
            steps, last = [], 0
            for p in pages:
                dec_p, e_p = dbp_deltas(*p)
                if p[3]:
                    e_p = e_p.clone()
                    e_p[0] = dec_p[0] - last
                    last = dec_p[-1]
                    steps.append(e_p)
            e_cat = torch.cat(steps)
            # the values as signed: these pages' values lie below 2^63, so
            # a bound above is the same as 2^63 - 1
            signed = blo < 2**63 and all(int(dbp_deltas(*p)[0].min()) >= 0 for p in pages if p[3])
            chi = min(bhi, 2**63 - 1)
            library = (lambda: (lambda c: (c >= blo) & (c <= chi))(torch.cumsum(e_cat, 0))) \
                if signed else None
            entry = "tt_resident_dbp_scan_batch"
        table = torch.from_numpy(rows).to(dev)
        want, _ = plain()
        full = (table.data_ptr(), len(rows), max(ns)) + c_args
        got = getattr(scan, fn)(group, *args, **kw)
        check(all(np.array_equal(m, want[o:o + nn].cpu().numpy())
                  for m, o, nn in zip(got, offs, ns)),
              f"{entry}: the served batch != plain")
        bmask, bms, bkl = graph_ms(entry, full, total)
        check(all(torch.equal(bmask[o:o + nn], want[o:o + nn]) for o, nn in zip(offs, ns)),
              f"{entry} graph launch != plain")
        rec = dict(shape=f"{len(group)} {codec} pages of one search's stage 1, {sum(ns)} rows"
                   + (f", {sum(p[0].numel() for p in pages)} runs" if codec == "rle" else "")
                   + (f", {v_all} dictionary entries" if codec == "dct" else ""),
                   pages=len(group), max_abs_err=0, ms=bms, kernels_a_call=bkl,
                   ms_a_page=bms / len(group),
                   path_ms=path_ms(torch, lambda: getattr(scan, fn)(group, *args, **kw)),
                   plain_ms=path_ms(torch, plain), library_ms=None)
        if library is not None:
            rec["library_ms"] = path_ms(torch, library)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
        out[entry[3:-6] + "_batch"] = rec
    return out


def trace_hex_set(tids) -> set:
    """(N, 4) uint32 trace-ID rows -> the set of their distinct hex IDs."""
    import numpy as np

    raw = np.ascontiguousarray(np.unique(tids, axis=0).astype(">u4")).tobytes()
    return {raw[i:i + 16].hex() for i in range(0, len(raw), 16)}


def db_phase(seed: int, a, b, root: str, queries: list, plan_of) -> dict:
    """Phase 7, the storage engine: TempoDB over the two blocks that phase
    6 wrote on the card (copied into root/blocks), every answer held
    against a numpy oracle computed from the generated batches; a
    search at limit 20 is repeated warm, an unbounded one is not (its
    warm repeat was timing only). Returns its numbers."""
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
            warm = None if limit == 0 else search(label, kw, limit)[0]
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
                  "coalesced | " + ("warm: not repeated" if warm is None else
                                    f"warm {warm['ms']:.1f} ms, inspected "
                                    f"{warm['inspected_bytes']} B, decoded "
                                    f"{warm['decoded_bytes']} B, pruned "
                                    f"{warm['pruned_row_groups']}, coalesced "
                                    f"{warm['coalesced_reads']}"), flush=True)

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
        # by() over one service's spans: grouping every span of both
        # blocks took a fifth of the phase
        ('{ resource.service.name = "cart" } | by(name)', 20, None),
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
    tier_off = {}  # phase 10 holds the tier's answers to these
    # phase 10's eighth search: its stage-1 column (name) is dct-coded
    searches.append(("name=db.query", dict(tags={"name": "db.query"}),
                     cols["name"] == d.get("db.query")))
    oracle["name=db.query"] = trace_hex_set(cols["trace_id"][searches[-1][2]])
    for label, kw, _ in searches:
        shared_cache().clear()
        row, r = search(label, kw, 0)
        tier_off[label] = {h.trace_id_hex for h in r.traces}
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
    res["compacted_block_id"] = out_meta.block_id
    res["tier_inputs"] = dict(searches=[(label, kw) for label, kw, _ in searches],
                              oracle=oracle, tier_off=tier_off)
    return res


SIMPLE_COUNT = [  # query_range without by(): the compiled tier's queries
    '{ resource.service.name = "cart" } | rate()',
    '{ name = "db.query" } | count_over_time()',
    '{ resource.service.name != "cart" && duration > 100ms } | rate()',
    '{ span.http.method !~ "G.*" } | count_over_time()',
]


def app_phase(seed: int, a, b, root: str, at_rest_block: str, queries: list, plan_of,
              recorded: dict, shed: bool = False) -> dict:
    """Phase 8, the single binary: App(device="cuda") behind a TempoServer
    on 127.0.0.1 over a fresh local backend holding a copy of phase 7's
    compacted block, driven only over HTTP. Every answer is held against
    a numpy oracle, or against the storage engine called directly on the
    same backend (query_range: evaluate_block with the CPU accumulator).
    `shed` drops the simple counts' runs through the interpreter (their
    latency beside the tier's: a slow host's depth cut). Returns its
    numbers."""
    import http.client
    import shutil

    import numpy as np

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.columnar import VT_INT, VT_STR, SpanBatch
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.modules.overrides import Limits
    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.compiled import executor, program
    from tempo_tpu_torch.compiled.lower import lower_metrics_plan
    from tempo_tpu_torch.receivers import otlp
    from tempo_tpu_torch.util import insights
    from tempo_tpu_torch.util.devicetiming import STATS

    tenant = "smoke"
    res: dict = {"requests": {}}
    counters = launch_counters()

    def recording_build(sig):
        """The tier's program, recording each dispatch's codec mix and
        the inputs of the largest one with a dbp column (timed after the
        phase at these shapes)."""
        prog = program.build_metrics_program(sig)

        def rec(*args):
            mix = tuple(c[0] for c in sig[0])
            recorded["mixes"].append(mix)
            recorded["n_pads"].append(sig[1])
            if "dbp" in mix and args[0].numel() > recorded.get("rows", -1):
                recorded.update(rows=args[0].numel(), sig=sig, args=args)
            return prog(*args)
        return rec

    recorded["mixes"], recorded["n_pads"] = [], []
    tile = _build.lib().tt_dbp_tile()
    executor.build_metrics_program = recording_build
    t_phase = time.perf_counter()
    app_root = os.path.join(root, "app")
    shutil.copytree(os.path.join(root, "blocks", tenant, at_rest_block),
                    os.path.join(app_root, "blocks", tenant, at_rest_block))
    # the push holds 17,408 traces live until /flush: above the default
    # cap of 10,000 live traces a tenant
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=os.path.join(app_root, "blocks"),
                                    wal_path=os.path.join(app_root, "wal")),
                        limits=Limits(max_traces_per_user=1 << 16),
                        multitenancy_enabled=True), device="cuda")
    server = TempoServer(app, host="127.0.0.1", port=0).start()
    ledger = JobLedger(app)
    try:
        check(app.device.type == "cuda" and app.querier.db.device == app.device
              and all(i.db.device == app.device for i in app.ingesters.values()),
              f"phase 8: the server runs on {app.device}")
        app.db.poll_now()  # the server's first blocklist poll finds the block at rest
        (rest_meta,) = app.db.blocklist.metas(tenant)
        check(rest_meta.block_id == at_rest_block, "phase 8: the block at rest is not polled")
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)

        def http(kind, method, path, body=None, headers=None):
            t0 = time.perf_counter()
            conn.request(method, path, body=body,
                         headers={"X-Scope-OrgID": tenant, **(headers or {})})
            r = conn.getresponse()
            out = r.read()
            res["requests"].setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
            return r.status, out

        print(f"phase 8 server: {server.url} on {app.device}, {rest_meta.total_spans} spans "
              "at rest", flush=True)

        # ------------------------------------------------------------ push
        # one attribute a span: a span's OTLP attributes are a map, so a
        # key make_batch drew twice for one span would arrive once
        pushed = [chain_parents(synth.make_batch(512, 8, seed=seed * 1000 + 800 + i,
                                                 base_time_ns=(BASE_S + 60 * (40 + i // 2)) * 10**9,
                                                 n_attrs_per_span=1))
                  for i in range(34)]
        bodies = [("pb", otlp.encode_traces_request(batch_to_traces(p))) for p in pushed[:32]]
        bodies.append(("json", json.dumps(otlp.encode_traces_json(batch_to_traces(pushed[32])))
                       .encode()))
        bodies.append(("gzip", gzip.compress(otlp.encode_traces_request(batch_to_traces(pushed[33])))))
        headers = {"pb": {"Content-Type": "application/x-protobuf"},
                   "json": {"Content-Type": "application/json"},
                   "gzip": {"Content-Type": "application/x-protobuf", "Content-Encoding": "gzip"}}
        t0 = time.perf_counter()
        for enc, body in bodies:
            status, _ = http("push", "POST", "/v1/traces", body, headers[enc])
            check(status == 200, f"phase 8 push ({enc}): HTTP {status}")
        res["push_s"] = time.perf_counter() - t0
        n_pushed = sum(p.num_spans for p in pushed)
        res["push_spans_per_s"] = n_pushed / res["push_s"]
        t0 = time.perf_counter()
        status, _ = http("flush", "POST", "/flush")
        res["flush_ms"] = (time.perf_counter() - t0) * 1e3
        metas = app.db.blocklist.metas(tenant)
        check(status == 204 and len(metas) == 2
              and sum(m.total_spans for m in metas) == rest_meta.total_spans + n_pushed,
              f"phase 8 flush: HTTP {status}, {len(metas)} blocks")
        print(f"phase 8 push: {n_pushed} spans in {len(bodies)} OTLP requests (32 protobuf of 512 "
              f"traces, 1 JSON, 1 gzip) | {res['push_s']:.2f} s, {res['push_spans_per_s']:.0f} "
              f"spans/s | flush {res['flush_ms']:.0f} ms -> a block of {n_pushed} spans beside "
              f"the one at rest", flush=True)

        # ------------------------------------------------------------ find
        u = SpanBatch.concat([a, b] + pushed)  # the oracle's data, one dictionary
        d, cols, attrs = u.dictionary, u.cols, u.attrs
        rng = np.random.default_rng(seed + 8)
        ids_p = np.concatenate([p.cols["trace_id"][p.trace_boundaries()[0]] for p in pushed])
        ids_r = np.concatenate([x.cols["trace_id"][x.trace_boundaries()[0]] for x in (a, b)])
        known = {bytes(t) for t in np.concatenate([ids_p, ids_r])}
        absent = [t for t in rng.integers(0, 2**32, (130, 4), dtype=np.uint32)
                  if bytes(t) not in known][:100]
        check(len(absent) == 100, "phase 8: could not draw 100 absent IDs")
        span_ids = {}  # trace ID -> its span IDs, pushed and at rest
        for p in [a, b] + pushed:
            for t, sid in zip(p.cols["trace_id"], p.cols["span_id"]):
                span_ids.setdefault(bytes(t.astype(">u4")).hex(), set()).add(
                    bytes(sid.astype(">u4")).hex())
        for kind, ids in (("find pushed", ids_p[rng.choice(len(ids_p), 100, replace=False)]),
                          ("find at rest", ids_r[rng.choice(len(ids_r), 100, replace=False)])):
            for limbs in ids:
                hexid = bytes(limbs.astype(">u4")).hex()
                status, body = http(kind, "GET", f"/api/traces/{hexid}")
                check(status == 200, f"phase 8 {kind}: HTTP {status}")
                spans = [sp for rs in json.loads(body)["resourceSpans"]
                         for ss in rs["scopeSpans"] for sp in ss["spans"]]
                check(len(spans) == 8 and all(sp["traceId"] == hexid for sp in spans),
                      f"phase 8 {kind}: {len(spans)} spans")
                check({sp["spanId"] for sp in spans} == span_ids[hexid],
                      f"phase 8 {kind}: span IDs differ from the written ones")
        for limbs in absent:
            status, _ = http("find absent", "GET", f"/api/traces/{bytes(limbs.astype('>u4')).hex()}")
            check(status == 404, f"phase 8 find absent: HTTP {status}")
        print("phase 8 find: 100 pushed IDs and 100 at-rest IDs found whole (the written span "
              "IDs), 100 absent -> 404", flush=True)

        # ---------------------------------------------------------- search
        def attr_mask(key, value):
            m = np.zeros(u.num_spans, bool)
            hit = ((attrs["attr_key"] == d.get(key)) & (attrs["attr_vtype"] == VT_STR)
                   & (attrs["attr_str"] == d.get(value)))
            m[attrs["attr_span"][hit]] = True
            return m

        unbounded = 10**7  # the API takes a positive limit; this one exceeds every answer
        dur = cols["duration_nano"]
        searches = [("service.name=cart", cols["service"] == d.get("cart")),
                    ("http.status_code=500", cols["http_status"] == 500),
                    ("region=v7", attr_mask("region", "v7"))]
        for tags, mask in searches:
            want = trace_hex_set(cols["trace_id"][mask])
            for limit in (20, unbounded):
                kind = "search limit 20" if limit == 20 else "search unbounded"
                status, body = http(kind, "GET", "/api/search?" + urllib.parse.urlencode(
                    {"tags": tags, "limit": limit}))
                hits = [t["traceID"] for t in json.loads(body)["traces"]]
                check(status == 200 and set(hits) <= want
                      and len(hits) == len(set(hits)) == min(limit, len(want)),
                      f"phase 8 search {tags} limit {limit}: {len(hits)} hits, oracle {len(want)}")
        names = set(json.loads(http("tags", "GET", "/api/search/tags")[1])["tagNames"])
        wk = {"service.name", "name", "http.method", "http.url", "http.status_code"}
        check(names == wk | {d[int(c)] for c in np.unique(attrs["attr_key"])},
              f"phase 8 search tags: {sorted(names)}")
        regions = set(json.loads(http("tag values", "GET", "/api/search/tag/region/values")[1])
                      ["tagValues"])
        rk = attrs["attr_key"] == d.get("region")
        want = {d[int(c)] for c in np.unique(attrs["attr_str"][rk & (attrs["attr_vtype"] == VT_STR)])}
        want |= {str(int(v)) for v in np.unique(attrs["attr_num"][rk & (attrs["attr_vtype"] == VT_INT)])}
        check(regions == want, "phase 8 tag values region != oracle")
        tql = [('{ resource.service.name = "cart" && duration > 100ms }',
                (cols["service"] == d.get("cart")) & (dur > 100_000_000)),
               ("{ duration >= 990ms }", dur >= 990_000_000)]
        for q, mask in tql:
            status, body = http("traceql", "GET", "/api/search?" + urllib.parse.urlencode(
                {"q": q, "limit": unbounded}))
            got = {t["traceID"] for t in json.loads(body)["traces"]}
            check(status == 200 and got == trace_hex_set(cols["trace_id"][mask]),
                  f"phase 8 traceql {q}: {len(got)} traces")
        print(f"phase 8 search: 3 tag searches at limit 20 and unbounded, tags ({len(names)}), "
              f"region values ({len(regions)}) and 2 TraceQL searches equal their oracles",
              flush=True)

        # ------------------------------------------------------ query_range
        res["query_range"] = []
        for q in queries:
            plan = plan_of(q)
            ledger.start(f"phase 8 query_range {q}")
            before, d2h = pk.seg_bincount.launches, STATS.d2h.get("seg_bincount", 0)
            status, body = http("query_range", "GET", "/api/metrics/query_range?"
                                + urllib.parse.urlencode({"q": q, "start": plan.start_s,
                                                          "end": plan.end_s, "step": plan.step_s,
                                                          "maxSeries": plan.max_series}))
            jobs = ledger.settle(f"phase 8 query_range {q}")
            launches = pk.seg_bincount.launches - before
            d2h = STATS.d2h.get("seg_bincount", 0) - d2h
            check(status == 200 and launches > 0 and launches == jobs["dispatches"],
                  f"phase 8 query_range {q}: HTTP {status}, {launches} seg_bincount launches, "
                  f"the jobs report {jobs}")
            merged = M.new_wire()
            for m in app.db.blocklist.metas(tenant):
                blk = app.db.encoding_for(m.version).open_block(m, app.db.backend, app.db.cfg.block)
                M.merge_wire(merged, M.evaluate_block(plan, blk, device="cpu").to_wire(), plan)
            want = M.finalize_matrix(plan, merged)
            doc = json.loads(body)
            got = doc["data"]
            check(got["result"] == want["result"] and want["result"],
                  f"phase 8 query_range {q}: the HTTP matrix != evaluate_block on the cpu")
            # a hedged job's losing copy launches too; the response
            # reports the dispatches of one copy a job
            check(doc["metrics"]["deviceDispatches"] == jobs["reported"],
                  f"phase 8 query_range {q}: the response reports "
                  f"{doc['metrics']['deviceDispatches']} device dispatches, {launches} launched, "
                  f"the jobs report {jobs}")
            res["query_range"].append(dict(query=q, ms=res["requests"]["query_range"][-1],
                                           launches=launches, d2h_bytes=d2h,
                                           hedged_jobs=jobs["hedged"]))
            print(f"phase 8 query_range: {q} | {len(got['result'])} series = evaluate_block on "
                  f"the cpu | {res['requests']['query_range'][-1]:.1f} ms, {launches} "
                  f"seg_bincount launches (= the dispatches its {jobs['jobs']} jobs report, "
                  f"{jobs['hedged']} hedged; the response's deviceDispatches "
                  f"{doc['metrics']['deviceDispatches']}), {d2h} B device-to-host", flush=True)

        # ------------------------------------- simple-count query_range
        # the compiled tier: one fused dispatch (compiled_metrics: at most a
        # prepare and a count launch) per codec group of a job, dbp_decode
        # and seg_bincount never; each query twice,
        # its insights record reading miss, then hit
        insights.LOG.configure(sample_every=1)
        res["compiled"] = []
        mixes_seen = set()
        for q in SIMPLE_COUNT:
            plan = plan_of(q)
            check(lower_metrics_plan(plan) is not None, f"phase 8 {q}: does not lower")
            merged = M.new_wire()
            for m in app.db.blocklist.metas(tenant):
                blk = app.db.encoding_for(m.version).open_block(m, app.db.backend, app.db.cfg.block)
                M.merge_wire(merged, M.evaluate_block(plan, blk, device="cpu").to_wire(), plan)
            want = M.finalize_matrix(plan, merged)
            for rep, verdict in ((1, "miss"), (2, "hit")):
                ledger.start(f"phase 8 compiled {q}")
                before = {k: fn.launches for k, fn in counters.items()}
                kernels_before = program.compiled_metrics.kernel_launches
                n_mix = len(recorded["mixes"])
                status, body = http("query_range compiled", "GET", "/api/metrics/query_range?"
                                    + urllib.parse.urlencode({"q": q, "start": plan.start_s,
                                                              "end": plan.end_s,
                                                              "step": plan.step_s}))
                ms = res["requests"]["query_range compiled"][-1]
                jobs = ledger.settle(f"phase 8 compiled {q}")
                launched = {k: fn.launches - before[k] for k, fn in counters.items()}
                doc = json.loads(body)
                mixes = recorded["mixes"][n_mix:]
                mixes_seen |= {c for mix in mixes for c in mix}
                check(status == 200 and doc["data"]["result"] == want["result"] and want["result"],
                      f"phase 8 compiled {q}: HTTP {status}, matrix != evaluate_block on the cpu")
                check(launched["seg_bincount"] == 0 and launched["compiled_metrics"] > 0
                      and launched["compiled_metrics"] == len(mixes) == jobs["dispatches"]
                      and doc["metrics"]["deviceDispatches"] == jobs["reported"],
                      f"phase 8 compiled {q}: launches {launched}, {len(mixes)} dispatches, "
                      f"deviceDispatches {doc['metrics']['deviceDispatches']}, "
                      f"the jobs report {jobs}")
                # each dispatch: a prepare launch when it has an rle column
                # or a dbp column of more than one tile, then the count
                # launch; the dbp decode is fused in, so no dbp_decode launch
                kernel_launches = program.compiled_metrics.kernel_launches - kernels_before
                want_kernels = sum(1 + int("rle" in mix or ("dbp" in mix and n_pad > tile))
                                   for mix, n_pad in zip(mixes, recorded["n_pads"][n_mix:]))
                check(kernel_launches == want_kernels and kernel_launches <= 2 * len(mixes)
                      and launched["dbp_decode"] == 0,
                      f"phase 8 compiled {q}: {kernel_launches} compiled_metrics kernel launches "
                      f"for {len(mixes)} dispatches (wanted {want_kernels}), "
                      f"{launched['dbp_decode']} dbp_decode launches")
                rec = json.loads(http("query insights", "GET", "/api/query-insights?limit=1")[1])
                shape = rec["insights"][0].get("compiledShape")
                check(rec["insights"][0]["kind"] == "query_range" and shape == verdict,
                      f"phase 8 compiled {q} #{rep}: compiledShape {shape}, wanted {verdict}")
                res["compiled"].append(dict(query=q, rep=rep, ms=ms, compiled_shape=shape,
                                            dispatches=len(mixes), mixes=sorted(set(mixes)),
                                            launches={k: launched[k] for k in
                                                      ("compiled_metrics", "dbp_decode")},
                                            kernel_launches=kernel_launches,
                                            hedged_jobs=jobs["hedged"], result=want["result"]))
                print(f"phase 8 query_range compiled #{rep}: {q} | {len(doc['data']['result'])} "
                      f"series = evaluate_block on the cpu | {ms:.1f} ms, compiledShape {shape}, "
                      f"{len(mixes)} dispatches (codec groups "
                      f"{', '.join('+'.join(m) for m in sorted(set(mixes)))}), compiled_metrics "
                      f"{launched['compiled_metrics']} dispatches in {kernel_launches} kernel "
                      f"launches / dbp_decode {launched['dbp_decode']} / seg_bincount 0 launches"
                      f" | {jobs['jobs']} jobs, {jobs['hedged']} hedged", flush=True)
        # the same queries through the interpreter (the tier switched off),
        # for the latency beside the tier's
        for q in () if shed else SIMPLE_COUNT:
            ledger.start(f"phase 8 {q} with TEMPO_TPU_COMPILED=0")
            os.environ["TEMPO_TPU_COMPILED"] = "0"
            try:
                before = {k: fn.launches for k, fn in counters.items()}
                plan = plan_of(q)
                status, body = http("query_range interpreter", "GET", "/api/metrics/query_range?"
                                    + urllib.parse.urlencode({"q": q, "start": plan.start_s,
                                                              "end": plan.end_s,
                                                              "step": plan.step_s}))
                # a hedge's losing copy reads the switch when it runs
                jobs = ledger.settle(f"phase 8 {q} with TEMPO_TPU_COMPILED=0")
            finally:
                del os.environ["TEMPO_TPU_COMPILED"]
            ms = res["requests"]["query_range interpreter"][-1]
            launched = {k: fn.launches - before[k] for k, fn in counters.items()}
            want = next(r for r in res["compiled"] if r["query"] == q)["result"]
            rec = json.loads(http("query insights", "GET", "/api/query-insights?limit=1")[1])
            check(status == 200 and json.loads(body)["data"]["result"] == want
                  and launched["compiled_metrics"] == 0
                  and launched["seg_bincount"] == jobs["dispatches"] > 0
                  and rec["insights"][0].get("compiledShape") == "fallback",
                  f"phase 8 {q} with TEMPO_TPU_COMPILED=0: HTTP {status}, launches {launched}")
            res["compiled"].append(dict(query=q, rep="interpreter", ms=ms,
                                        compiled_shape="fallback",
                                        launches={"seg_bincount": launched["seg_bincount"]}))
            print(f"phase 8 query_range interpreter (TEMPO_TPU_COMPILED=0): {q} | the same matrix | "
                  f"{ms:.1f} ms, {launched['seg_bincount']} seg_bincount launches", flush=True)
        for r in res["compiled"]:
            r.pop("result", None)
        check({"rle", "dct", "dbp"} <= mixes_seen,
              f"phase 8 compiled: the launch groups' codecs {sorted(mixes_seen)} miss one of "
              "rle, dct, dbp")
        status, body = http("query insights", "GET", "/api/query-insights")
        stats = json.loads(body)["compiled"]
        check(status == 200 and stats["shapes"] >= len(SIMPLE_COUNT) and stats["programs"] > 0,
              f"phase 8 /api/query-insights: HTTP {status}, compiled {stats}")
        res["compiled_stats"] = stats
        print(f"phase 8 /api/query-insights: HTTP 200, compiled {stats}", flush=True)
        conn.close()
    finally:
        executor.build_metrics_program = program.build_metrics_program
        server.stop()
        app.shutdown()
    res["requests"] = {k: dict(n=len(v), p50_ms=statistics.median(v), max_ms=max(v))
                       for k, v in res["requests"].items()}
    for k, v in res["requests"].items():
        print(f"phase 8 {k}: {v['n']} requests | p50 {v['p50_ms']:.2f} ms, max {v['max_ms']:.2f} ms",
              flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# phase 9's registrations: phase 4's three, phase 8's four simple counts,
# and nine more (a histogram, a quantile, two alerts, a seasonal deviation)
STANDING_EXTRA = [
    ("{ } | histogram_over_time(duration)", None, None),
    ("{ } | quantile_over_time(duration, 0.9) by (name)", None, None),
    ("{ status = error } | rate() by (resource.service.name)", {"op": ">", "value": 0.5}, None),
    # a dead-man alert: fires while the latest complete minute is empty
    ("{ span.http.status_code = 500 } | count_over_time()", {"op": "<", "value": 1}, None),
    ("{ } | count_over_time() by (name)", None, {"season": 1800, "factor": 2.0}),
    ("{ duration > 100ms } | rate() by (span.http.method)", None, None),
    ('{ span.http.method = "GET" } | rate() by (name)', None, None),
    ('{ name = "db.query" } | histogram_over_time(duration) by (resource.service.name)',
     None, None),
    ('{ resource.service.name = "cart" || resource.service.name = "ads" } | count_over_time() '
     "by (span.http.method)", None, None),
]


def _matrix_key(result: list) -> list:
    """A Prometheus matrix's series in an order that does not depend on
    which series a table met first."""
    return sorted((json.dumps(r["metric"], sort_keys=True), r["values"]) for r in result)


def standing_phase(seed: int, root: str, queries: list) -> dict:
    """Phase 9, the standing-query engine: App(device="cuda") with the
    defaults (the engine on) behind a TempoServer on 127.0.0.1 over a
    fresh local backend. 16 queries are registered over HTTP; 2**17 spans
    stamped over the 32 minutes that end 8 minutes before now are pushed
    as 32 OTLP protobuf requests and cut every 8 requests (4 cuts of 2**15
    spans), each cut folding into every query through seg_bincount on the
    card. After each cut, and after /flush and a poll, every standing read
    equals query_range over the same start, end and step; the same cut
    batches folded by a StandingEngine on the CPU give the same counts; a
    fifth cut stays in the WAL, the process "crashes" (ingesters stopped
    without a flush) and a new App on the same paths rebuilds the same
    reads. Returns its numbers."""
    from http.client import HTTPConnection

    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.compiled import cache as compiled_cache
    from tempo_tpu_torch.db import DBConfig
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.receivers import otlp
    from tempo_tpu_torch.standing import StandingEngine
    from tempo_tpu_torch.util.devicetiming import STATS

    # the process-wide shape cache still holds phase 8's programs, each
    # wrapped by that phase's dispatch recorder
    compiled_cache.shape_cache().clear()
    tenant = "single-tenant"
    t_phase = time.perf_counter()
    res: dict = {"requests": {}}
    now_min = int(time.time()) // 60 * 60
    start, end, step = now_min - 45 * 60, now_min + 60, 60
    regs = ([(q, None, None) for q in queries] + [(q, None, None) for q in SIMPLE_COUNT]
            + STANDING_EXTRA)
    cfg = AppConfig(db=DBConfig(backend="local", backend_path=os.path.join(root, "blocks"),
                                wal_path=os.path.join(root, "wal")))

    # every rebuild timed (the registrations' first reads, the restart's)
    rebuild_ms: list = []
    orig_rebuild = StandingEngine.rebuild

    def timed_rebuild(self, q):
        t0 = time.perf_counter()
        try:
            return orig_rebuild(self, q)
        finally:
            rebuild_ms.append((time.perf_counter() - t0) * 1e3)

    StandingEngine.rebuild = timed_rebuild
    try:
        app = App(cfg, device="cuda")
        eng = app.standing
        check(eng is not None and eng.device == app.device and app.device.type == "cuda",
              f"phase 9: the standing engine runs on {eng and eng.device}")
        # per fold (one a cut): its wall and the cut batch it folded; per
        # standing_fold dispatch: its seconds, bytes and seg_bincount launches
        folds: list = []
        applies: list = []
        orig_fold, orig_apply = eng.fold, eng._apply_counts

        def fold(t, batch, seg_key=None):
            t0 = time.perf_counter()
            orig_fold(t, batch, seg_key=seg_key)
            folds.append(dict(ms=(time.perf_counter() - t0) * 1e3, batch=batch, spans=batch.num_spans))

        def fold_totals():
            return (STATS.dispatches.get("standing_fold", 0), STATS.seconds.get("standing_fold", 0.0),
                    STATS.h2d.get("standing_fold", 0), STATS.d2h.get("standing_fold", 0),
                    pk.seg_bincount.launches)

        def apply_counts(q, plan, live, bin_offset):
            before = fold_totals()
            orig_apply(q, plan, live, bin_offset)
            d = [a - b for a, b in zip(fold_totals(), before)]
            applies.append(dict(dispatches=d[0], ms=d[1] * 1e3, h2d=d[2], d2h=d[3], launches=d[4],
                                rows=len(live), n_slots=plan.n_slots))

        eng.fold, eng._apply_counts = fold, apply_counts
        server = TempoServer(app, host="127.0.0.1", port=0).start()
        ledger = JobLedger(app)
        conn = HTTPConnection("127.0.0.1", server.port, timeout=600)

        def http(kind, method, path, body=None, headers=None, c=None):
            c = c or conn
            t0 = time.perf_counter()
            c.request(method, path, body=body, headers=headers or {})
            r = c.getresponse()
            out = r.read()
            res["requests"].setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
            return r.status, out

        # ------------------------------------------------------ register
        ids = []
        for q, alert, deviation in regs:
            body = {"q": q, "step": step, "window": 3600, "maxSeries": 64}
            if alert:
                body["alert"] = alert
            if deviation:
                body["deviation"] = deviation
            status, out = http("register", "POST", "/api/metrics/standing", json.dumps(body).encode(),
                               {"Content-Type": "application/json"})
            check(status == 200, f"phase 9 register {q}: HTTP {status} {out[:200]!r}")
            ids.append(json.loads(out)["id"])
        status, out = http("list", "GET", "/api/metrics/standing")
        check(status == 200 and sorted(d["id"] for d in json.loads(out)["queries"]) == sorted(ids),
              "phase 9: the listing misses a registration")
        # the first reads: a registration with storage attached starts
        # dirty, so each first read rebuilds (an empty store here)
        n_rb = len(rebuild_ms)
        for qid in ids:
            status, _ = http("first read", "GET", f"/api/metrics/standing/{qid}")
            check(status == 200, f"phase 9 first read {qid}: HTTP {status}")
        res["first_read_rebuild_ms"] = rebuild_ms[n_rb:]
        check(len(res["first_read_rebuild_ms"]) == len(ids),
              f"phase 9: {len(res['first_read_rebuild_ms'])} first-read rebuilds for {len(ids)} "
              "registrations")
        print(f"phase 9 standing: {len(ids)} queries registered over HTTP on {app.device} "
              f"(step 60 s, window 3600 s, maxSeries 64; 2 alerts, 1 deviation of season 1800 s) "
              f"| first-read rebuilds p50 {statistics.median(res['first_read_rebuild_ms']):.1f} ms, "
              f"max {max(res['first_read_rebuild_ms']):.1f} ms", flush=True)

        def read_all(label, c=None, compare=True):
            """Every standing read; held against query_range over the
            same start, end and step when `compare`."""
            out = {}
            window = {"start": start, "end": end, "step": step}
            for qid, (q, _, _) in zip(ids, regs):
                status, body = http("standing read", "GET", f"/api/metrics/standing/{qid}?"
                                    + urllib.parse.urlencode(window), c=c)
                # a failed card fold answers 500 (no host rebuild stands in)
                check(status == 200, f"phase 9 {label} standing read {q}: HTTP {status}, "
                      f"{body[:300]!r}")
                doc = json.loads(body)
                check(doc["metrics"].get("standing") is True and not doc["metrics"].get("degraded"),
                      f"phase 9 {label} standing read {q}: {doc.get('metrics')}")
                out[qid] = _matrix_key(doc["data"]["result"])
                if compare:
                    status, body = http("query_range", "GET", "/api/metrics/query_range?"
                                        + urllib.parse.urlencode(dict(window, q=q)), c=c)
                    check(status == 200 and out[qid] == _matrix_key(json.loads(body)["data"]["result"]),
                          f"phase 9 {label}: standing read {q} != query_range")
            return out

        # --------------------------------------------------- push and cut
        bodies = []
        for i in range(36):  # 32 requests in cuts 1-4, 4 in the fifth
            minute = now_min - 40 * 60 + 60 * i if i < 32 else now_min - 7 * 60 + 60 * (i - 32)
            batch = chain_parents(synth.make_batch(512, 8, seed=seed * 1000 + 900 + i,
                                                   base_time_ns=minute * 10**9, n_attrs_per_span=1))
            bodies.append(otlp.encode_traces_request(batch_to_traces(batch)))
        pb = {"Content-Type": "application/x-protobuf"}
        disp0 = STATS.dispatches.get("standing_fold", 0)
        cut_launches = []
        reads = {}
        for c in range(5):
            for body in bodies[8 * c: 8 * c + 8]:
                status, _ = http("push", "POST", "/v1/traces", body, pb)
                check(status == 200, f"phase 9 push: HTTP {status}")
            # a hedged query_range job of the reads before may still be
            # running: its seg_bincount launches must not count as the cut's
            ledger.start(f"phase 9 cut {c + 1}")
            n_apply, launches0 = len(applies), pk.seg_bincount.launches
            for ing in app.ingesters.values():
                for inst in list(ing.instances.values()):
                    inst.cut_complete_traces(immediate=True)
            launched = pk.seg_bincount.launches - launches0
            cut_applies = applies[n_apply:]
            check(launched == len(cut_applies) > 0
                  and all(a["dispatches"] == a["launches"] == 1 for a in cut_applies),
                  f"phase 9 cut {c + 1}: {launched} seg_bincount launches for {len(cut_applies)} "
                  "folds with live slots")
            cut_launches.append(launched)
            reads[c] = read_all(f"cut {c + 1}")
            print(f"phase 9 cut {c + 1}: {folds[-1]['spans']} spans folded into {len(ids)} queries "
                  f"in {folds[-1]['ms']:.1f} ms ({launched} standing_fold dispatches = seg_bincount "
                  f"launches) | {len(ids)} standing reads == query_range", flush=True)
            if c == 3:
                # the card's counts against a CPU engine folding the same cuts
                cpu = StandingEngine(device="cpu")
                cpu_qs = [cpu.register(tenant, q, step, 3600, alert=alert, max_series=64,
                                       deviation=deviation) for q, alert, deviation in regs]
                for f in folds:
                    cpu.fold(tenant, f["batch"])
                for qid, cq in zip(ids, cpu_qs):
                    gq = eng.get(tenant, qid)
                    keyed = []
                    for q_ in (gq, cq):
                        key_of = {s_: k for k, s_ in q_.series.slots.items()}
                        keyed.append({(key_of[s_], b, k): n for (s_, b, k), n in q_.counts.items()})
                    check(keyed[0] == keyed[1] and keyed[0],
                          f"phase 9: card counts of {gq.query} != the CPU engine's")
                res["cpu_engine_equal"] = len(ids)
                print(f"phase 9 cpu engine: the 4 cut batches folded by StandingEngine(device='cpu') "
                      f"give the card engine's counts for all {len(ids)} queries", flush=True)
                status, _ = http("flush", "POST", "/flush")
                check(status == 204, f"phase 9 flush: HTTP {status}")
                app.db.poll_now()
                check(len(app.db.blocklist.metas(tenant)) == 1, "phase 9: no block after /flush")
                reads["flushed"] = read_all("after /flush and a poll")
                check(reads["flushed"] == reads[3], "phase 9: reads moved across the flush")
                print(f"phase 9 flush: 1 block of {app.db.blocklist.metas(tenant)[0].total_spans} "
                      f"spans | {len(ids)} standing reads == query_range == the reads before",
                      flush=True)
        for f in folds:
            f.pop("batch")
        states = {}
        for qid in ids:
            status, body = http("state", "GET", f"/api/metrics/standing/{qid}/state")
            states[qid] = json.loads(body)
            st = states[qid]["stats"]
            check(status == 200 and not st["dirty"] and st["sheds"] == 0 and st["folds"] == 5,
                  f"phase 9 state {qid}: HTTP {status}, {st}")
        fold_dispatches = STATS.dispatches.get("standing_fold", 0) - disp0
        check(fold_dispatches == len(applies) == sum(cut_launches),
              f"phase 9: {fold_dispatches} standing_fold dispatches, {len(applies)} folds with live "
              f"slots, {sum(cut_launches)} seg_bincount launches at the cuts")
        status, body = http("status", "GET", "/status/standing")
        res["status_standing"] = json.loads(body)
        check(status == 200 and res["status_standing"]["enabled"]
              and res["status_standing"]["sheds"] == 0
              and res["status_standing"]["foldSpans"] == len(ids) * sum(f["spans"] for f in folds),
              f"phase 9 /status/standing: {res['status_standing']}")
        firing = sum(bool(states[qid]["firing"]) for qid in ids)
        deviating = sum(bool(states[qid]["deviating"]) for qid in ids)
        before_crash = reads[4]

        # ------------------------------------------------ crash, restart
        conn.close()
        server.stop()
        for stop in app._heartbeat_stops:
            stop.set()
        for ing in app.ingesters.values():
            ing.stop(flush=False)  # the fifth cut stays in the WAL
        app.workers.stop()
        app.compactor.stop()
        app.db.shutdown()
        n_rb = len(rebuild_ms)
        t0 = time.perf_counter()
        app = App(cfg, device="cuda")
        res["restart_ms"] = (time.perf_counter() - t0) * 1e3
        res["restart_rebuild_ms"] = rebuild_ms[n_rb:]
        server = TempoServer(app, host="127.0.0.1", port=0).start()
        conn2 = HTTPConnection("127.0.0.1", server.port, timeout=600)
        try:
            after = read_all("after the restart", c=conn2, compare=False)
            check(after == before_crash, "phase 9: reads after the restart != reads before the crash")
            for qid in ids:
                status, body = http("state", "GET", f"/api/metrics/standing/{qid}/state", c=conn2)
                st = json.loads(body)["stats"]
                check(status == 200 and st["rebuilds"] >= 1 and not st["dirty"],
                      f"phase 9 restart state {qid}: {st}")
        finally:
            conn2.close()
            server.stop()
            app.shutdown()
    finally:
        StandingEngine.rebuild = orig_rebuild
    check(len(res["restart_rebuild_ms"]) == len(ids),
          f"phase 9: {len(res['restart_rebuild_ms'])} rebuilds at the restart")
    print(f"phase 9 restart: a fifth cut of {folds[-1]['spans']} spans left in the WAL, ingesters "
          f"stopped without a flush, a new App on the same paths ({res['restart_ms']:.0f} ms, "
          f"{len(ids)} rebuilds: p50 {statistics.median(res['restart_rebuild_ms']):.1f} ms, max "
          f"{max(res['restart_rebuild_ms']):.1f} ms) | {len(ids)} reads == the reads before the "
          "crash, rebuilds >= 1, dirty false", flush=True)

    fold_ms = [f["ms"] for f in folds]
    res.update(
        folds=len(folds), fold_spans=[f["spans"] for f in folds],
        fold_ms_p50=statistics.median(fold_ms[:4]), fold_ms_max=max(fold_ms[:4]),
        fold_ms_all=fold_ms,
        dispatches=len(applies), dispatch_ms_p50=statistics.median(a["ms"] for a in applies),
        dispatch_ms_max=max(a["ms"] for a in applies),
        dispatch_ms_sum=sum(a["ms"] for a in applies),
        launches_a_fold=statistics.mean(a["launches"] for a in applies),
        h2d_bytes_a_fold=statistics.mean(a["h2d"] for a in applies),
        d2h_bytes_a_fold=statistics.mean(a["d2h"] for a in applies),
        rows_a_fold=statistics.median(a["rows"] for a in applies),
        n_slots_a_fold=statistics.median(a["n_slots"] for a in applies),
        firing=firing, deviating=deviating)
    reqs = {k: dict(n=len(v), p50_ms=statistics.median(v), max_ms=max(v))
            for k, v in res["requests"].items()}
    res["requests"] = reqs
    print(f"phase 9 folds: {res['folds']} cuts x {len(ids)} queries, fold ms a cut (all "
          f"{len(ids)} queries; cuts 1-4) p50 {res['fold_ms_p50']:.1f}, max {res['fold_ms_max']:.1f} "
          f"| {res['dispatches']} standing_fold dispatches, p50 {res['dispatch_ms_p50']:.3f} ms "
          f"(max {res['dispatch_ms_max']:.3f}, all {res['dispatch_ms_sum']:.1f} of the folds' "
          f"{sum(fold_ms):.1f} ms; a dispatch synchronises the device), "
          f"{res['launches_a_fold']:g} seg_bincount launch, {res['h2d_bytes_a_fold']:.0f} B "
          f"host-to-device and {res['d2h_bytes_a_fold']:.0f} B device-to-host a fold (median "
          f"{res['rows_a_fold']:.0f} live rows, {res['n_slots_a_fold']:.0f} slots) | "
          f"alerts firing {firing}, deviating {deviating}", flush=True)
    print(f"phase 9 reads: standing read p50 {reqs['standing read']['p50_ms']:.2f} ms (max "
          f"{reqs['standing read']['max_ms']:.2f}, n {reqs['standing read']['n']}) beside "
          f"query_range p50 {reqs['query_range']['p50_ms']:.2f} ms (max "
          f"{reqs['query_range']['max_ms']:.2f}, n {reqs['query_range']['n']}) over the same "
          f"{(end - start) // 60} bins | push p50 {reqs['push']['p50_ms']:.1f} ms a request",
          flush=True)
    print(f"phase 9 /status/standing: {json.dumps(res['status_standing'])}", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def _graph_norm(raw: bytes) -> dict:
    """A /api/graph/* document without its wall-clock and byte stats."""
    doc = json.loads(raw)
    doc["stats"] = {k: v for k, v in (doc.get("stats") or {}).items()
                    if k not in ("stageSeconds", "deviceDispatches", "elapsedMs",
                                 "inspectedBytes", "decodedBytes")}
    return doc


def _generator_oracle(batches: list) -> dict:
    """(metric name, labels) -> (count, bucket counts, sum) of the
    span-metrics and service-graph series that the generator must hold
    after taking `batches`, computed with numpy and a dict of span IDs,
    independently of modules/generator."""
    import numpy as np

    from tempo_tpu_torch.modules.generator import servicegraphs as sg
    from tempo_tpu_torch.modules.generator import spanmetrics as sm

    out: dict = {}

    def add(name, labels, bounds, secs):
        secs = np.asarray(secs, np.float64)
        b = np.bincount(np.searchsorted(np.asarray(bounds), secs, side="left"),
                        minlength=len(bounds) + 1)
        have = out.setdefault((name, labels), [0, np.zeros(len(bounds) + 1, np.int64), 0.0])
        have[0] += len(secs)
        have[1] += b
        have[2] += float(secs.sum())

    for batch in batches:
        c, d = batch.cols, batch.dictionary
        secs = c["duration_nano"].astype(np.float64) / 1e9
        keys = np.stack([c["service"], c["name"], c["kind"].astype(np.uint32),
                         c["status_code"].astype(np.uint32)], axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        for g, (svc, name, kind, status) in enumerate(uniq):
            labels = (("service", d[int(svc)]), ("span_name", d[int(name)]),
                      ("span_kind", sm.KIND_NAMES[int(kind)]),
                      ("status_code", sm.STATUS_NAMES[int(status)]))
            add(sm.LATENCY, labels, sm.DEFAULT_BOUNDS, secs[inv.ravel() == g])
        by_id = {(c["trace_id"][r].tobytes(), c["span_id"][r].tobytes()): r
                 for r in range(batch.num_spans)}
        for r in np.flatnonzero(c["kind"] == 2):  # SERVER
            p = by_id.get((c["trace_id"][r].tobytes(), c["parent_span_id"][r].tobytes()))
            if p is None or c["kind"][p] != 3 or c["service"][p] == c["service"][r]:
                continue
            labels = (("client", d[int(c["service"][p])]), ("server", d[int(c["service"][r])]))
            add(sg.REQ_SECONDS, labels, sg.DEFAULT_BOUNDS, [secs[r]])
            if c["status_code"][r] == 2:
                add(sg.REQ_FAILED, labels, [], [0.0])
    return out


def graph_phase(seed: int, root: str, shed: bool = False, keep: str | None = None) -> dict:
    """Phase 11, the metrics-generator and the graph plane at full width:
    a fresh App(device="cuda") with the defaults (the generator on; the
    live-trace cap raised for the 16,384 traces of the push), and beside
    it the same App on the CPU, behind TempoServers on 127.0.0.1. 2**17
    spans of make_graph_batch traces (8 services, 8 spans a trace, 10%
    errors) are pushed over HTTP as 32 OTLP protobuf requests to each,
    and to a card App with the generator off for the push rate without
    it (`shed` drops that App: a slow host's depth cut). The card's
    generator series must equal a numpy oracle over the same spans and
    the CPU App's series, its service-graph sketches and distinct-edge
    estimate the CPU App's. Then /flush, one block of 2**20
    make_graph_batch spans written into the card App's backend and
    copied into the CPU App's, and /api/graph/dependencies,
    /api/graph/critical-path (by=service and by=name) and
    /api/graph/walks (seed 7) asked of both: the documents equal field
    for field (wall-clock and byte stats aside), the edge and trace
    totals equal the generator's construction. `keep`: a blocks root that
    gets a copy of the 2**20-span block (phase 13's graph block). Returns
    its numbers."""
    import http.client
    import shutil

    import numpy as np

    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.modules.generator import servicegraphs as sg
    from tempo_tpu_torch.modules.generator import spanmetrics as sm
    from tempo_tpu_torch.modules.overrides import Limits
    from tempo_tpu_torch.ops import graph as ops_graph
    from tempo_tpu_torch.ops import sketch
    from tempo_tpu_torch.receivers import otlp

    tenant = "single-tenant"
    t_phase = time.perf_counter()
    res: dict = {"requests": {}}
    pushed = [synth.make_graph_batch(512, 8, seed=seed * 1000 + 1100 + i, error_rate=0.1)
              for i in range(32)]
    bodies = [otlp.encode_traces_request(batch_to_traces(b)) for b in pushed]
    n_pushed = sum(b.num_spans for b in pushed)
    n_push_traces = 512 * len(pushed)

    def make(sub, device, **kw):
        app = App(AppConfig(db=DBConfig(backend="local",
                                        backend_path=os.path.join(root, sub, "blocks"),
                                        wal_path=os.path.join(root, sub, "wal")),
                            limits=Limits(max_traces_per_user=1 << 16), **kw), device=device)
        server = TempoServer(app, host="127.0.0.1", port=0).start()
        return app, server, http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)

    def request(conn, kind, method, path, body=None, headers=None):
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        out = r.read()
        res["requests"].setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        return r.status, out

    def push_all(conn, kind):
        t0 = time.perf_counter()
        for body in bodies:
            status, _ = request(conn, kind, "POST", "/v1/traces", body,
                             {"Content-Type": "application/x-protobuf"})
            check(status == 200, f"phase 11 {kind}: HTTP {status}")
        return time.perf_counter() - t0

    apps = {}
    try:
        apps["card"] = make("card", "cuda")
        apps["cpu"] = make("cpu", "cpu")
        card, cpu = apps["card"][0], apps["cpu"][0]
        ledger = JobLedger(card)
        check(card.generator is not None and card.generator.device.type == "cuda",
              "phase 11: the card App runs no generator on the card")
        status, body = request(apps["card"][2], "ring", "GET", "/metrics-generator/ring")
        check(status == 200 and [i["id"] for i in json.loads(body)["instances"]]
              == ["generator-0"], f"phase 11 /metrics-generator/ring: {body[:200]!r}")

        # ------------------------------------------------------------ push
        l0 = (sketch.hll_update.launches, sketch.cm_update.launches)
        res["push_s"] = push_all(apps["card"][2], "push")
        res["push_sketch_launches"] = {"hll_update": sketch.hll_update.launches - l0[0],
                                       "cm_update": sketch.cm_update.launches - l0[1]}
        res["push_spans_per_s"] = n_pushed / res["push_s"]
        check(all(v == len(bodies) for v in res["push_sketch_launches"].values()),
              f"phase 11 push: sketch launches {res['push_sketch_launches']}, one each a push")
        if shed:
            res["push_spans_per_s_generator_off"] = None
        else:
            apps["off"] = make("off", "cuda", generator_enabled=False)
            res["push_s_generator_off"] = push_all(apps["off"][2], "push, generator off")
            res["push_spans_per_s_generator_off"] = n_pushed / res["push_s_generator_off"]
            off = apps.pop("off")
            off[2].close()
            off[1].stop()
            off[0].shutdown()
        push_all(apps["cpu"][2], "push, cpu")
        print(f"phase 11 push: {n_pushed} spans ({n_push_traces} make_graph_batch traces) in "
              f"{len(bodies)} OTLP requests | card App {res['push_spans_per_s']:.0f} spans/s "
              f"with the generator ({res['push_sketch_launches']} sketch launches), "
              + ("generator off: shed" if shed else
                 f"{res['push_spans_per_s_generator_off']:.0f} spans/s with it off (same bodies, "
                 "same call)"), flush=True)

        # ------------------------------------------------ generator series
        def series(app):
            inst = app.generator.instance(tenant)
            return {(s.name, s.labels): s.value for s in inst.registry.collect()}, inst
        (cs, cinst), (hs, hinst) = series(card), series(cpu)
        expired = {k: v for k, v in cs.items() if k[0] == sg.EXPIRED_TOTAL}
        cs_det = {k: v for k, v in cs.items() if k[0] != sg.EXPIRED_TOTAL}
        hs_det = {k: v for k, v in hs.items() if k[0] != sg.EXPIRED_TOTAL}
        check(cs_det == hs_det, "phase 11: the card's generator series != the CPU App's")
        csg, hsg = cinst.processors[1], hinst.processors[1]
        check(csg.hll.device.type == "cuda" and torch_equal(csg.hll, hsg.hll)
              and torch_equal(csg.cm, hsg.cm), "phase 11: the card's sketches != the CPU App's")
        est = (csg.distinct_edges_estimate(), hsg.distinct_edges_estimate())
        check(est[0] == est[1], f"phase 11: distinct_edges_estimate card {est[0]} != cpu {est[1]}")
        unpaired = int(sum(expired.values())) + len(csg.pending_clients) + len(csg.pending_servers)
        check(unpaired == 2 * n_push_traces,
              f"phase 11: {unpaired} unpaired spans, not each trace's root server and last client")
        oracle = _generator_oracle(pushed)
        n_checked = 0
        for (name, labels), (count, buckets, total) in oracle.items():
            if name == sg.REQ_FAILED:
                check(cs.get((name, labels)) == count, f"phase 11: {name} {labels}")
                n_checked += 1
                continue
            bounds = sg.DEFAULT_BOUNDS if name == sg.REQ_SECONDS else sm.DEFAULT_BOUNDS
            cum = np.cumsum(buckets)
            for i, b in enumerate(bounds):
                check(cs.get((f"{name}_bucket", labels + (("le", str(b)),))) == cum[i],
                      f"phase 11: {name} bucket le={b} {labels}")
            check(cs.get((f"{name}_bucket", labels + (("le", "+Inf"),))) == count
                  and cs.get((f"{name}_count", labels)) == count
                  and abs(cs.get((f"{name}_sum", labels)) - total) <= 1e-9 * max(1.0, total),
                  f"phase 11: {name} count/sum {labels}")
            if name == sg.REQ_SECONDS:
                check(cs.get((sg.REQ_TOTAL, labels)) == count, f"phase 11: {sg.REQ_TOTAL} {labels}")
            else:
                check(cs.get(("traces_spanmetrics_calls_total", labels)) == count,
                      f"phase 11: calls_total {labels}")
            n_checked += 1
        res["generator"] = dict(series=len(cs), series_checked=n_checked,
                                distinct_edges_estimate=est[0],
                                edges_emitted=csg.edges_emitted, unpaired=unpaired)
        print(f"phase 11 generator: {len(cs)} series ({n_checked} span-metrics and service-graph "
              f"families checked against a numpy oracle over the pushed spans; every series but "
              f"the expiry split == the CPU App's), {csg.edges_emitted} edges, HLL and count-min "
              f"on the card == the CPU App's, distinct_edges_estimate {est[0]:.4f} == CPU; "
              f"{unpaired} unpaired spans (root servers and last clients)", flush=True)

        # --------------------------------------------- flush, a 2**20 block
        for k in ("card", "cpu"):
            status, _ = request(apps[k][2], f"flush {k}", "POST", "/flush")
            check(status == 204, f"phase 11 flush {k}: HTTP {status}")
        big = synth.make_graph_batch(1 << 17, 8, seed=seed * 1000 + 1200, error_rate=0.1)
        t0 = time.perf_counter()
        meta = card.db.write_batch(tenant, big, block_id=str(uuid.UUID(int=seed + 11)))
        res["block_write_ms"] = (time.perf_counter() - t0) * 1e3
        for dst in [os.path.join(root, "cpu", "blocks")] + ([keep] if keep else []):
            shutil.copytree(os.path.join(root, "card", "blocks", tenant, meta.block_id),
                            os.path.join(dst, tenant, meta.block_id))
        cpu.db.poll_now()
        card.db.poll_now()
        metas = [sorted(m.total_spans for m in a.db.blocklist.metas(tenant)) for a in (card, cpu)]
        check(metas[0] == metas[1] and sum(metas[0]) == n_pushed + big.num_spans,
              f"phase 11: blocks {metas}")
        n_traces = n_push_traces + (1 << 17)
        print(f"phase 11 blocks: /flush (a {n_pushed}-span block each) and one block of "
              f"{big.num_spans} spans written on the card in {res['block_write_ms']:.0f} ms, "
              f"copied to the CPU App", flush=True)

        # -------------------------------------------------- graph routes
        routes = [("dependencies", "/api/graph/dependencies"),
                  ("critical-path", "/api/graph/critical-path?by=service"),
                  ("critical-path by name", "/api/graph/critical-path?by=name"),
                  ("walks", "/api/graph/walks?seed=7&walks=64&steps=8")]
        res["routes"] = {}
        for label, path in routes:
            # a hedged job of the request before may still be running: its
            # launches must not count as this request's
            ledger.start(f"phase 11 {label}")
            r0 = ops_graph.root_path_sums.launches
            k0 = ops_graph.root_path_sums.kernel_launches
            status, body = request(apps["card"][2], label, "GET", path)
            jobs = ledger.settle(f"phase 11 {label}")
            launched = ops_graph.root_path_sums.launches - r0
            status_c, body_c = request(apps["cpu"][2], label + " (cpu)", "GET", path)
            check(status == status_c == 200, f"phase 11 {label}: HTTP {status} / {status_c}")
            doc, doc_c = _graph_norm(body), _graph_norm(body_c)
            check(doc == doc_c, f"phase 11 {label}: the card's document != the CPU App's")
            raw = json.loads(body)
            res["routes"][label] = dict(ms=res["requests"][label][-1],
                                        cpu_ms=res["requests"][label + " (cpu)"][-1],
                                        root_path_sums_launches=launched,
                                        kernel_launches=ops_graph.root_path_sums.kernel_launches - k0,
                                        device_dispatches=raw["stats"].get("deviceDispatches"),
                                        jobs=jobs["jobs"], hedged=jobs["hedged"])
            # one graph_critical_path dispatch, one root_path_sums call, a
            # block of a critical-path job (hedged copies included); none
            # in the dependency and walk jobs
            check(launched == jobs["dispatches"]
                  and raw["stats"].get("deviceDispatches") == jobs["reported"],
                  f"phase 11 {label}: {launched} root_path_sums calls, the jobs report "
                  f"{jobs}, the response {raw['stats'].get('deviceDispatches')}")
            if label.startswith("critical-path"):
                # each call is the segmented kernel's one launch
                check(doc["traces"] == n_traces and launched >= 2
                      and res["routes"][label]["kernel_launches"] == launched
                      and json.loads(body_c)["stats"].get("deviceDispatches", 0) == 0,
                      f"phase 11 {label}: {doc['traces']} traces, {launched} root_path_sums "
                      f"calls, {res['routes'][label]['kernel_launches']} kernel launches")
            elif label == "dependencies":
                check(sum(e["count"] for e in doc["edges"]) == 3 * n_traces
                      and doc["unpairedSpans"] == 2 * n_traces,
                      f"phase 11 dependencies: {sum(e['count'] for e in doc['edges'])} edges, "
                      f"{doc['unpairedSpans']} unpaired")
            else:
                check(len(doc["walks"]) == 64 and doc["edges"] > 0, "phase 11 walks")
            print(f"phase 11 {path}: card == CPU App | card {res['routes'][label]['ms']:.0f} ms, "
                  f"CPU {res['routes'][label]['cpu_ms']:.0f} ms, {launched} root_path_sums calls "
                  f"({res['routes'][label]['kernel_launches']} kernel launches; {jobs['jobs']} jobs, "
                  f"{jobs['hedged']} hedged)", flush=True)
    finally:
        for app, server, conn in apps.values():
            conn.close()
            server.stop()
            app.shutdown()
    reqs = {k: dict(n=len(v), p50_ms=statistics.median(v), max_ms=max(v))
            for k, v in res["requests"].items()}
    res["requests"] = reqs
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.cpu(), b.cpu()))


# lowered standing queries phase 12 adds to phase 9's sixteen
TAIL_EXTRA = [
    '{ resource.service.name = "cart" } | rate() by (name)',
    "{ span.http.status_code >= 500 } | count_over_time()",
    '{ name != "db.query" && span.http.method = "GET" } | rate() by (resource.service.name)',
    '{ span.http.url != "http://svc/3" } | count_over_time() by (span.http.method)',
]
# phase 12's live-tail searches: (tags, minDuration, maxDuration, tail_scan launches a
# resident segment); an absent value answers empty before any launch, an
# attribute-table tag takes the host loop
TAIL_SEARCHES = [
    ({"name": "db.query"}, None, None, 1),
    ({"service.name": "cart"}, None, None, 1),
    ({"service.name": "cart", "http.method": "GET"}, None, None, 1),
    ({"http.url": "http://svc/3"}, None, None, 1),
    ({"http.status_code": "500"}, None, None, 1),
    ({"service.name": "frontend"}, "100ms", "900ms", 1),
    ({"service.name": "nope"}, None, None, 0),
    ({"region": "v7"}, None, None, 0),
]


def _search_key(raw: bytes) -> tuple:
    """A search response's hits (sorted) and inspected traces."""
    doc = json.loads(raw)
    hits = sorted(json.dumps(t, sort_keys=True) for t in doc["traces"])
    return hits, doc["metrics"].get("inspectedTraces")


def _host_tail_mask(np, batch, tags: dict, mn: int, mx: int):
    """The querier's host loop over one segment's dedicated columns, for
    the masks of phase 12 (b); None for a tag of the attribute table."""
    cols, d = batch.cols, batch.dictionary
    where = {"name": "name", "service.name": "service", "service": "service",
             "http.method": "http_method", "http.url": "http_url"}
    mask = np.ones(batch.num_spans, bool)
    for k, v in tags.items():
        if k == "http.status_code":
            mask &= cols["http_status"] == int(v)
        elif k in where:
            code = d.get(v)
            mask &= (cols[where[k]] == code) if code is not None else False
        else:
            return None
    if mn:
        mask &= cols["duration_nano"] >= np.uint64(mn)
    if mx:
        mask &= cols["duration_nano"] <= np.uint64(mx)
    return mask


def _without_clock(doc: dict) -> dict:
    """A /status/storage document without its wall-clock fields; each
    tenant's block ages (now less end time) apart, returned beside it."""
    doc = {k: v for k, v in doc.items() if k not in ("scannedAt", "scanSeconds")}
    tenants = {t: dict(r) for t, r in doc["tenants"].items()}
    ages = {t: r.pop("ageSecondsDistribution") for t, r in tenants.items()}
    return dict(doc, tenants=tenants), ages


def tail_phase(seed: int, root: str, queries: list, device: str = "cuda",
               n_requests: int = 32) -> dict:
    """Phase 12 (a), the ingest tail and the status planes over HTTP.
    App(device) with a 1,024-MB device tier whose ingest-tail share is 64
    MB, and App(device="cpu") with the tail off, each behind a TempoServer
    over its own local backend. Phase 9's 16 standing queries and four
    more that lower onto the parked columns are registered on the card
    App; phase 9's 2**17 spans go to both as 32 OTLP requests, cut every
    8. Each cut parks one tail entry; each lowered query folds through one
    tail_fold launch a cut and never seg_bincount (whose launches at a cut
    are the other queries' folds); after each cut every standing read
    equals query_range on the same App, and a CPU StandingEngine folding
    the same cut batches holds the same counts. Eight live-tail searches
    before /flush equal the CPU App's (tail_scan launches once a resident
    segment, never for an absent value or an attribute-table tag), the
    standing_fold and live_tail_scan h2d stays at a few KB a dispatch
    while their avoided bytes climb; after /flush, /status/storage?
    refresh=1 equals the port's own analysis on the CPU over a copy of
    the backend; /status/profile returns stacks; /status/profile/device,
    taken around a fifth cut's fold, returns a trace whose device events
    name the hand kernels. The CPU App's cuts park nothing (its
    instances see no tier: the tier is process-wide and the card App's).
    Returns its numbers."""
    import copy
    import shutil
    import threading
    from http.client import HTTPConnection

    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.compiled import cache as compiled_cache
    from tempo_tpu_torch.config_sections import DeviceTierConfig
    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.db.analytics import StorageScanner
    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.metrics_engine import compile_metrics_plan
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.ops import ingest_tail
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.receivers import otlp
    from tempo_tpu_torch.standing import StandingEngine
    from tempo_tpu_torch.util import profiling
    from tempo_tpu_torch.util.devicetiming import STATS

    compiled_cache.shape_cache().clear()
    tenant = "single-tenant"
    t_phase = time.perf_counter()
    res: dict = {"requests": {}}
    now_min = int(time.time()) // 60 * 60
    start, end, step = now_min - 45 * 60, now_min + 60, 60
    regs = ([(q, None, None) for q in queries] + [(q, None, None) for q in SIMPLE_COUNT]
            + STANDING_EXTRA + [(q, None, None) for q in TAIL_EXTRA])
    lowered = [ingest_tail.lower_fold_plan(compile_metrics_plan(q, start, end, step))
               is not None for q, _, _ in regs]
    res["lowered"] = [q for (q, _, _), low in zip(regs, lowered) if low]
    check(all(lowered[-len(TAIL_EXTRA):]), "phase 12: a query of TAIL_EXTRA does not lower")

    def db_cfg(name):
        return DBConfig(backend="local", backend_path=os.path.join(root, name, "blocks"),
                        wal_path=os.path.join(root, name, "wal"))

    # the CPU App first: App start installs the process-wide tier, the card's last
    cpu_app = App(AppConfig(db=db_cfg("cpu")), device="cpu")
    app = App(AppConfig(db=db_cfg("card"), device_tier=DeviceTierConfig(
        budget_mb=1024, ingest_tail_budget_mb=64)), device=device)
    tier = colcache.shared_device_tier()
    check(tier is not None and tier.device == app.device
          and tier.ingest_tail_budget_bytes == 64 << 20,
          f"phase 12: the tier {tier and tier.stats()} is not the card App's")
    servers = [TempoServer(a, host="127.0.0.1", port=0).start() for a in (app, cpu_app)]
    conns = [HTTPConnection("127.0.0.1", s.port, timeout=600) for s in servers]
    eng = app.standing
    ledger = JobLedger(app)
    cpu_eng = StandingEngine(device="cpu")
    applies: list = []
    folded: list = []
    orig_apply, orig_fold = eng._apply_counts, eng.fold

    def apply_counts(q, plan, live, bin_offset):
        applies.append((q.id, len(live)))
        orig_apply(q, plan, live, bin_offset)

    def fold(t, batch, seg_key=None):
        t0 = time.perf_counter()
        orig_fold(t, batch, seg_key=seg_key)
        folded.append(dict(ms=(time.perf_counter() - t0) * 1e3, spans=batch.num_spans,
                           key=batch._tail_key))
        # the same cut on the CPU engine, without its tail key: the host fold
        plain = copy.copy(batch)
        plain._tail_key = None
        cpu_eng.fold(t, plain)

    eng._apply_counts, eng.fold = apply_counts, fold
    # each resident fold's bytes (the other queries' seg_bincount folds
    # ship their slots under the same standing_fold name)
    tail_folds: list = []
    orig_resident = ingest_tail.resident_fold

    def resident_fold(*a, **k):
        before = (STATS.h2d.get("standing_fold", 0), STATS.d2h.get("standing_fold", 0),
                  STATS.seconds.get("standing_fold", 0.0))
        out = orig_resident(*a, **k)
        if out is not None:
            tail_folds.append((STATS.h2d.get("standing_fold", 0) - before[0],
                               STATS.d2h.get("standing_fold", 0) - before[1],
                               (STATS.seconds.get("standing_fold", 0.0) - before[2]) * 1e3))
        return out

    ingest_tail.resident_fold = resident_fold

    def http(kind, method, path, body=None, headers=None, c=0):
        t0 = time.perf_counter()
        conns[c].request(method, path, body=body, headers=headers or {})
        r = conns[c].getresponse()
        out = r.read()
        res["requests"].setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        return r.status, out

    def cut_cpu():
        for ing in cpu_app.ingesters.values():
            for inst in list(ing.instances.values()):
                inst._device_tier = lambda: None
                inst.cut_complete_traces(immediate=True)

    try:
        ids = []
        for q, alert, deviation in regs:
            body = {"q": q, "step": step, "window": 3600, "maxSeries": 64}
            if alert:
                body["alert"] = alert
            if deviation:
                body["deviation"] = deviation
            status, out = http("register", "POST", "/api/metrics/standing",
                               json.dumps(body).encode(), {"Content-Type": "application/json"})
            check(status == 200, f"phase 12 register {q}: HTTP {status} {out[:200]!r}")
            ids.append(json.loads(out)["id"])
        cpu_qs = [cpu_eng.register(tenant, q, step, 3600, alert=alert, max_series=64,
                                   deviation=deviation) for q, alert, deviation in regs]
        for qid in ids:  # the first reads rebuild (an empty store)
            check(http("first read", "GET", f"/api/metrics/standing/{qid}")[0] == 200,
                  f"phase 12 first read {qid}")
        low_ids = {qid for qid, low in zip(ids, lowered) if low}
        print(f"phase 12 tail: App(device={device!r}) with a 1,024-MB device tier, 64 MB of "
              f"it the ingest tail, beside App(device='cpu') with the tail off | {len(ids)} "
              f"standing queries, {len(low_ids)} lower onto the parked columns: "
              f"{res['lowered']}", flush=True)

        def read_all(label):
            window = {"start": start, "end": end, "step": step}
            for qid, (q, _, _) in zip(ids, regs):
                status, body = http("standing read", "GET", f"/api/metrics/standing/{qid}?"
                                    + urllib.parse.urlencode(window))
                check(status == 200, f"phase 12 {label} standing read {q}: HTTP {status}, "
                      f"{body[:300]!r}")
                got = _matrix_key(json.loads(body)["data"]["result"])
                status, body = http("query_range", "GET", "/api/metrics/query_range?"
                                    + urllib.parse.urlencode(dict(window, q=q)))
                check(status == 200 and got == _matrix_key(json.loads(body)["data"]["result"]),
                      f"phase 12 {label}: standing read {q} != query_range")
            for qid, cq in zip(ids, cpu_qs):
                gq = eng.get(tenant, qid)
                keyed = []
                for q_ in (gq, cq):
                    key_of = {s_: k for k, s_ in q_.series.slots.items()}
                    keyed.append({(key_of[s_], b, k): n for (s_, b, k), n in q_.counts.items()})
                check(keyed[0] == keyed[1],
                      f"phase 12 {label}: card counts of {gq.query} != the CPU engine's")

        bodies = []
        for i in range(n_requests + 4):  # 4 cuts of n_requests / 4, then a fifth cut
            minute = (now_min - 40 * 60 + 60 * i if i < n_requests
                      else now_min - 7 * 60 + 60 * (i - n_requests))
            batch = chain_parents(synth.make_batch(512, 8, seed=seed * 1000 + 900 + i,
                                                   base_time_ns=minute * 10**9, n_attrs_per_span=1))
            bodies.append(otlp.encode_traces_request(batch_to_traces(batch)))
        pb = {"Content-Type": "application/x-protobuf"}
        per_cut = n_requests // 4
        res["cuts"] = []
        h2d0 = {k: STATS.h2d.get(k, 0) for k in ("standing_fold", "live_tail_scan")}
        d0 = {k: STATS.dispatches.get(k, 0) for k in ("standing_fold", "live_tail_scan")}
        avoided = [STATS.avoided.get("standing_fold", 0)]
        for c in range(4):
            for body in bodies[per_cut * c: per_cut * (c + 1)]:
                for i in (0, 1):
                    status, _ = http("push", "POST", "/v1/traces", body, pb, c=i)
                    check(status == 200, f"phase 12 push: HTTP {status}")
            ledger.start(f"phase 12 cut {c + 1}")
            entries0 = tier.stats()["tail_entries"]
            n_apply, l0 = len(applies), (ingest_tail.tail_fold.launches, pk.seg_bincount.launches)
            n_resident = len(tail_folds)
            for ing in app.ingesters.values():
                for inst in list(ing.instances.values()):
                    inst.cut_complete_traces(immediate=True)
            launched = (ingest_tail.tail_fold.launches - l0[0], pk.seg_bincount.launches - l0[1])
            cut_cpu()
            cut_applies = applies[n_apply:]
            check(tier.stats()["tail_entries"] == entries0 + 1 and folded[-1]["key"] is not None,
                  f"phase 12 cut {c + 1}: the cut did not park ({tier.stats()})")
            check(launched[0] == len(low_ids), f"phase 12 cut {c + 1}: {launched[0]} tail_fold "
                  f"launches for {len(low_ids)} lowered queries")
            check(not any(qid in low_ids for qid, _ in cut_applies),
                  f"phase 12 cut {c + 1}: a lowered query folded through seg_bincount")
            check(launched[1] == sum(1 for _, rows in cut_applies if rows),
                  f"phase 12 cut {c + 1}: {launched[1]} seg_bincount launches for "
                  f"{len(cut_applies)} host folds")
            avoided.append(STATS.avoided.get("standing_fold", 0))
            check(avoided[-1] > avoided[-2], f"phase 12 cut {c + 1}: no standing_fold bytes avoided")
            read_all(f"cut {c + 1}")
            # the lowered folds' standing_fold dispatches (tail_fold), by host clock
            lowered_ms = sum(ms for _, _, ms in tail_folds[n_resident:])
            res["cuts"].append(dict(spans=folded[-1]["spans"], fold_ms=folded[-1]["ms"],
                                    lowered_dispatch_ms=lowered_ms,
                                    tail_fold=launched[0], seg_bincount=launched[1]))
            print(f"phase 12 cut {c + 1}: {folded[-1]['spans']} spans parked "
                  f"({tier.stats()['tail_bytes']} B of tails resident) and folded into "
                  f"{len(ids)} queries in {folded[-1]['ms']:.1f} ms, of it "
                  f"{lowered_ms:.2f} ms in the {launched[0]} lowered folds' standing_fold "
                  f"dispatches: {launched[0]} tail_fold launches (the lowered queries), "
                  f"{launched[1]} seg_bincount (the rest) | {len(ids)} standing reads == "
                  f"query_range == the CPU engine's counts", flush=True)
        # live-tail searches, card App (the tail) against the CPU App (host loop)
        res["searches"] = []
        for tags, mn, mx, per_seg in TAIL_SEARCHES:
            params = {"tags": " ".join(f"{k}={v}" for k, v in tags.items()), "limit": 100_000}
            if mn:
                params["minDuration"] = mn
            if mx:
                params["maxDuration"] = mx
            path = "/api/search?" + urllib.parse.urlencode(params)
            ledger.start("phase 12 search")
            s0 = (ingest_tail.tail_scan.launches, STATS.avoided.get("live_tail_scan", 0))
            got = [http("live-tail search", "GET", path, c=i) for i in (0, 1)]
            ledger.idle("phase 12 search")
            scans = ingest_tail.tail_scan.launches - s0[0]
            check(got[0][0] == got[1][0] == 200, f"phase 12 search {tags}: HTTP "
                  f"{got[0][0]} / {got[1][0]}")
            card, cpu = _search_key(got[0][1]), _search_key(got[1][1])
            check(card == cpu, f"phase 12 search {tags} {mn} {mx}: the card App != the CPU App")
            # one launch a parked segment a copy of the recent job (a slow
            # host's hedged copy scans again)
            check(scans == 0 if per_seg == 0 else scans >= 4 and scans % 4 == 0,
                  f"phase 12 search {tags}: {scans} tail_scan launches over 4 parked segments")
            res["searches"].append(dict(tags=tags, min=mn, max=mx, hits=len(card[0]),
                                        tail_scan=scans, ms=res["requests"]["live-tail search"][-2],
                                        avoided=STATS.avoided.get("live_tail_scan", 0) - s0[1]))
        print("phase 12 live-tail searches: " + "; ".join(
            f"{s['tags']}{' ' + str(s['min']) if s['min'] else ''}"
            f"{' ' + str(s['max']) if s['max'] else ''} -> {s['hits']} traces, {s['tail_scan']} "
            f"tail_scan, {s['ms']:.1f} ms" for s in res["searches"])
            + " | each == the CPU App (tail off)", flush=True)
        n_disp = STATS.dispatches.get("live_tail_scan", 0) - d0["live_tail_scan"]
        res["live_tail_scan_dispatches"] = n_disp
        res["live_tail_scan_h2d_a_dispatch"] = ((STATS.h2d.get("live_tail_scan", 0)
                                                 - h2d0["live_tail_scan"]) / max(1, n_disp))
        res["live_tail_scan_avoided"] = STATS.avoided.get("live_tail_scan", 0)
        res["tail_folds"] = len(tail_folds)
        res["tail_fold_h2d_max"] = max(h for h, _, _ in tail_folds)
        res["tail_fold_d2h_max"] = max(d_ for _, d_, _ in tail_folds)
        res["standing_fold_h2d_a_dispatch"] = ((STATS.h2d.get("standing_fold", 0)
                                                - h2d0["standing_fold"])
                                               / max(1, STATS.dispatches.get("standing_fold", 0)
                                                     - d0["standing_fold"]))
        res["standing_fold_avoided_by_cut"] = avoided
        check(len(tail_folds) == 4 * len(low_ids) and res["tail_fold_h2d_max"] < 16 << 10
              and n_disp > 0 and res["live_tail_scan_h2d_a_dispatch"] < 16 << 10,
              f"phase 12: {len(tail_folds)} resident folds, {res['tail_fold_h2d_max']} B h2d at "
              f"most; live_tail_scan {res['live_tail_scan_h2d_a_dispatch']:.0f} B a dispatch")
        print(f"phase 12 transfer: {len(tail_folds)} resident folds (tail_fold), "
              f"{res['tail_fold_h2d_max']} B h2d and {res['tail_fold_d2h_max']} B d2h each at "
              f"most (every standing_fold dispatch, the seg_bincount folds' slots included: "
              f"{res['standing_fold_h2d_a_dispatch']:.0f} B h2d on average), standing_fold "
              f"bytes avoided {avoided} after cuts 0-4 | live_tail_scan {n_disp} dispatches, "
              f"{res['live_tail_scan_h2d_a_dispatch']:.0f} B h2d a dispatch, "
              f"{res['live_tail_scan_avoided']} B avoided", flush=True)

        # /flush, then /status/storage against the port's own scan on the CPU
        status, _ = http("flush", "POST", "/flush")
        check(status == 204, f"phase 12 flush: HTTP {status}")
        app.db.poll_now()
        status, body = http("status storage", "GET", "/status/storage?refresh=1")
        check(status == 200, f"phase 12 /status/storage: HTTP {status}")
        served, served_ages = _without_clock(json.loads(body))
        shutil.copytree(os.path.join(root, "card", "blocks"), os.path.join(root, "copy", "blocks"))
        cdb = TempoDB(db_cfg("copy"), device="cpu")
        try:
            cdb.poll_now()
            mine, my_ages = _without_clock(StorageScanner(cdb).scan_once())
        finally:
            cdb.shutdown()
        check(served == mine and served["fleet"]["blocks"] >= 1,
              "phase 12: /status/storage != the CPU scan of a copy of the backend")
        check(all(abs(served_ages[t][k] - my_ages[t][k]) <= 2 for t in my_ages
                  for k in my_ages[t] if k not in ("count", "sum")),
              f"phase 12: block ages {served_ages} vs {my_ages}")
        res["storage"] = served["fleet"]
        print(f"phase 12 /status/storage?refresh=1 == the port's scan on the CPU over a copy of "
              f"the backend: {json.dumps(served['fleet'])}", flush=True)
        status, body = http("status profile", "GET", "/status/profile?seconds=1")
        check(status == 200 and b"## hottest frames" in body and b"thread-samples" in body,
              f"phase 12 /status/profile: HTTP {status}")
        # the device window around a fifth cut's fold. The process's first
        # window spends seconds starting CUPTI before it records (8.3 s on
        # the H100 machine), so a first short window takes that cost
        status, body = http("status profile device (first)", "GET",
                            "/status/profile/device?seconds=0.1")
        check(status == 200 and json.loads(body)["supported"] is True,
              f"phase 12 first /status/profile/device: HTTP {status} {body[:300]!r}")
        res["profile_device_first_ms"] = res["requests"]["status profile device (first)"][-1]
        window: dict = {}

        def capture():
            c = HTTPConnection("127.0.0.1", servers[0].port, timeout=600)
            try:
                c.request("GET", "/status/profile/device?seconds=2")
                r = c.getresponse()
                window["status"], window["body"] = r.status, r.read()
            finally:
                c.close()

        for body in bodies[n_requests:]:
            check(http("push", "POST", "/v1/traces", body, pb)[0] == 200, "phase 12 push 5")
        th = threading.Thread(target=capture)
        th.start()
        time.sleep(0.5)
        l0 = ingest_tail.tail_fold.launches
        for ing in app.ingesters.values():
            for inst in list(ing.instances.values()):
                inst.cut_complete_traces(immediate=True)
        th.join(timeout=120)
        check(not th.is_alive() and window.get("status") == 200,
              f"phase 12 /status/profile/device: {window.get('status')}")
        doc = json.loads(window["body"])
        check(doc["supported"] is True and profiling.TRACE_FILE in doc["files"]
              and "transferLedger" in doc, f"phase 12 /status/profile/device: {doc}")
        with open(os.path.join(doc["dir"], profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
        ours = [k for k in kernels if any(s in k for s in (
            "tail_fold_kernel", "tail_scan_kernel", "seg_bincount", "hll_update", "cm_update",
            "rle_change_mask", "dbp_pack", "compiled_", "resident_", "root_path"))]
        check(ingest_tail.tail_fold.launches > l0 and any("tail_fold_kernel" in k for k in ours),
              f"phase 12: the device window names no tail_fold_kernel ({kernels[:20]})")
        res["profile_kernels"] = ours
        res["profile_device_events"] = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"phase 12 /status/profile/device?seconds=2 around a fifth cut's fold: "
              f"supported, {len(events)} trace events, {res['profile_device_events']} kernel "
              f"events; the hand kernels named: {ours} (the process's first window, 0.1 s: "
              f"{res['profile_device_first_ms']:.0f} ms) | /status/profile?seconds=1: stacks",
              flush=True)
    finally:
        eng._apply_counts, eng.fold = orig_apply, orig_fold
        ingest_tail.resident_fold = orig_resident
        for c in conns:
            c.close()
        for s in servers:
            s.stop()
        for a in (app, cpu_app):
            a.shutdown()
        colcache.configure_device_tier(None, device=device)
    reqs = {k: dict(n=len(v), p50_ms=statistics.median(v), max_ms=max(v))
            for k, v in res["requests"].items()}
    res["requests"] = reqs
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def u32_bytes_read(torch, col, rows) -> int:
    """The bytes a kernel fetches of the u32 column `col` when it loads only
    the rows where the bool tensor `rows` (over col's first rows) holds: 32 B
    for each 32-byte sector, from the column's own address, that holds one
    such row."""
    lead = torch.zeros((col.data_ptr() % 32) // 4, dtype=torch.bool, device=rows.device)
    m = torch.cat([lead, rows])
    m = torch.cat([m, m.new_zeros(-m.numel() % 8)])
    return 32 * int(m.view(-1, 8).any(1).sum())


def tail_full_width(torch, dev, lib, stream, seed: int, lowered: list) -> dict:
    """Phase 12 (b): one cut of 786,432 spans (the largest the reference
    sizes the tail for under the default 256-MB live pool: ~33 MB at 44 B
    a span) parked through park_cut on the card, 2**20 rows padded. Every
    lowered query through resident_fold on the card == on a CPU tier (the
    plain version) == eval_batch (the host path); the eight masks of
    TAIL_SEARCHES on the card == on the CPU tier == the host loop. Then
    both kernels timed at one fold and one scan of this cut: device time
    alone (a CUDA graph of 48 launches over three copies of the parked
    columns, median of 7), path time (the wrapper), the plain version on
    the card, the torch chain (searchsorted + bincount for the fold, the
    elementwise compares for the scan) and the bound; the same at one
    phase 12 (a) cut's size (32,768 spans, under each record's "shapes").
    Returns the two kernels' records."""
    import numpy as np

    from tempo_tpu_torch.encoding.common import SearchRequest
    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.metrics_engine import SeriesTable, compile_metrics_plan, eval_batch
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.ops import ingest_tail

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 1200)
    n_spans = 786_432
    now_min = int(time.time()) // 60 * 60
    batch = synth.make_batch(n_spans // 8, 8, seed=seed * 1000 + 1200)
    batch.cols["start_unix_nano"] = ((now_min - 40 * 60) * 10**9 + rng.integers(
        0, 40 * 60 * 10**9, n_spans)).astype(np.uint64)
    tiers = [colcache.DeviceTier(256 << 20, ingest_tail_budget_bytes=64 << 20, device=d)
             for d in (dev, "cpu")]
    keys = [ingest_tail.park_cut(t, "single-tenant", "full:0", batch) for t in tiers]
    check(None not in keys and tiers[0].stats()["tail_bytes"] == 44 << 20,
          f"phase 12 (b): the cut did not park whole ({tiers[0].stats()})")
    start, end, step = now_min - 45 * 60, now_min + 60, 60
    d = batch.dictionary
    for q in lowered:
        plan = compile_metrics_plan(q, start, end, step, max_series=64)
        fp = ingest_tail.lower_fold_plan(plan)
        out = []
        for tier, key in zip(tiers, keys):
            series = SeriesTable(64)
            got = ingest_tail.resident_fold(plan, fp, batch, d, series, tier=tier, key=key)
            key_of = {s: k for k, s in series.slots.items()}
            out.append({(key_of[s], b): c for (s, b), c in got.items()})
        series = SeriesTable(64)
        r = eval_batch(plan, batch, d, series)
        flats, counts = np.unique(r.slots[r.slots >= 0], return_counts=True)
        key_of = {s: k for k, s in series.slots.items()}
        host = {(key_of[int(f) // plan.n_bins], int(f) % plan.n_bins): int(c)
                for f, c in zip(flats, counts)}
        check(out[0] == out[1] == host and host, f"phase 12 (b) {q}: card / plain / host differ")
    for tags, mn, mx, _ in TAIL_SEARCHES:
        mn_ns = int(float(mn[:-2]) * 10**6) if mn else 0
        mx_ns = int(float(mx[:-2]) * 10**6) if mx else 0
        batch._tail_key = keys[0]
        req = SearchRequest(tags=tags, min_duration_ns=mn_ns, max_duration_ns=mx_ns)
        masks = [ingest_tail.tail_search_mask(batch, req, tier=t) for t in tiers]
        want = _host_tail_mask(np, batch, tags, mn_ns, mx_ns)
        check(all((m is None) == (want is None) for m in masks)
              and (want is None or all(np.array_equal(m, want) for m in masks)),
              f"phase 12 (b) mask {tags}: card / plain / host differ")
    check_s = time.perf_counter() - t0
    print(f"phase 12 (b): one cut of {n_spans} spans parked on the card "
          f"({tiers[0].stats()['tail_bytes']} B, 2^20 rows) | {len(lowered)} lowered queries "
          f"through resident_fold on the card == the plain version (a CPU tier) == eval_batch; "
          f"{len(TAIL_SEARCHES)} masks == plain == the host loop ({check_s:.1f} s)", flush=True)

    recs = time_tail_kernels(torch, dev, lib, stream, tiers[0].get(keys[0]).arrays, batch,
                             (start, end, step))
    # one phase 12 (a) cut's size: 32,768 spans, parked the same way
    cut = synth.make_batch(4096, 8, seed=seed * 1000 + 1201)
    cut.cols["start_unix_nano"] = ((now_min - 40 * 60) * 10**9 + rng.integers(
        0, 40 * 60 * 10**9, cut.num_spans)).astype(np.uint64)
    cut_tier = colcache.DeviceTier(256 << 20, ingest_tail_budget_bytes=64 << 20, device=dev)
    cut_key = ingest_tail.park_cut(cut_tier, "single-tenant", "cut:0", cut)
    check(cut_key is not None, "phase 12 (b): the 32,768-span cut did not park")
    for k, r in time_tail_kernels(torch, dev, lib, stream, cut_tier.get(cut_key).arrays, cut,
                                  (start, end, step)).items():
        recs[k]["shapes"] = {f"cut of {cut.num_spans}": r}
    del tiers, cut_tier
    recs["tail_fold"]["phase_b_s"] = time.perf_counter() - t0
    return recs


def time_tail_kernels(torch, dev, lib, stream, arrays: dict, batch, window: tuple) -> dict:
    """Both tail kernels timed at one fold (TAIL_EXTRA[0] over `window`) and
    one scan (service.name=frontend, 100ms-900ms) of the cut `batch`
    parked as `arrays` on the card: device time alone (a CUDA graph of 48
    launches of the C entry point over three copies of the parked columns,
    median of 7; the fold's entry point zeroes its counts), path time (the
    wrapper), the plain version on the card, the torch chain
    (searchsorted + bincount for the fold, the elementwise compares for the
    scan) and the bound, with bytes from u32_bytes_read. Each is held
    against the plain version and the chain first. Returns the two
    kernels' records."""
    import ctypes

    import numpy as np

    from tempo_tpu_torch.metrics_engine import compile_metrics_plan
    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import ingest_tail

    n_spans, d = batch.num_spans, batch.dictionary
    p = arrays["service"].numel()
    copies = [arrays] + [{k: v.clone() for k, v in arrays.items()} for _ in range(2)]
    recs = {}

    # the fold: the first TAIL_EXTRA query at this cut
    q = TAIL_EXTRA[0]
    plan = compile_metrics_plan(q, *window, max_series=64)
    fp = ingest_tail.lower_fold_plan(plan)
    _lits, preds, uvals_real, uvals, lo, hi = ingest_tail.fold_args(plan, fp, batch, d)
    nb = plan.n_bins
    edges_u64 = ingest_tail._edges_u64(lo, hi)
    counts = [torch.zeros(len(uvals) * (len(lo) - 1), dtype=torch.int32, device=dev)
              for _ in copies]
    descs = []
    for a, c in zip(copies, counts):
        desc, staged = ingest_tail.fold_descriptor(a, n_spans, preds, fp.by_col, uvals, edges_u64,
                                                   nb, c)
        check(staged is None, "tail_fold: the timed fold's constants do not fit by value")
        descs.append(desc)

    def fold_launch(desc):
        def go():
            _build.check(lib.tt_tail_fold(ctypes.addressof(desc), stream()), "tail_fold")
        return go

    want = ingest_tail.tail_fold(arrays, n_spans, preds, fp.by_col, uvals, lo, hi, nb)
    counts[0].fill_(-1)  # the entry point zeroes them
    fold_launch(descs[0])()
    check(torch.equal(counts[0], want), "tail_fold at the full-width shape: the C entry != wrapper")
    ms = kernel_ms(torch, [fold_launch(x) for x in descs])
    path = path_ms(torch, lambda: ingest_tail.tail_fold(arrays, n_spans, preds, fp.by_col, uvals,
                                                        lo, hi, nb))
    plain = path_ms(torch, lambda: ingest_tail._tail_fold_plain(arrays, n_spans, preds, fp.by_col,
                                                                uvals, lo, hi, nb), reps=5)
    check(torch.equal(ingest_tail._tail_fold_plain(arrays, n_spans, preds, fp.by_col, uvals, lo,
                                                   hi, nb), want),
          f"tail_fold at {n_spans} rows: kernel != plain")
    # the torch chain: the predicates, searchsorted over the edges and the
    # by() codes, one bincount
    m32 = 0xFFFFFFFF
    u = {k: v.to(torch.int64) & m32 for k, v in arrays.items()}
    t_ns = (u["start_hi"] << 32) | u["start_lo"]
    edges = torch.from_numpy(((hi[: nb + 1].astype(np.int64) << 32)
                              | lo[: nb + 1].astype(np.int64))).to(dev)
    uv = torch.from_numpy(uvals.astype(np.int64)).to(dev)
    rows = torch.arange(p, device=dev)
    b_pad, length = len(lo) - 1, len(uvals) * (len(lo) - 1)

    def chain():
        m = rows < n_spans
        for col, op, lit in preds:
            m = m & (u[col] == lit if op == "=" else u[col] != lit) & (u[col] != 0)
        b = torch.searchsorted(edges, t_ns, right=True) - 1
        idx = torch.searchsorted(uv, u[fp.by_col], right=True) - 1
        flat = torch.where(m & (b >= 0) & (b < nb), idx * b_pad + b, length)
        return torch.bincount(flat, minlength=length + 1)[:length]

    check(torch.equal(chain().to(torch.int32), want), "tail_fold: the torch chain != the kernel")
    lib_ms = path_ms(torch, chain)
    # the bound counts what this cut's rows make the kernel fetch: a
    # predicate's column at the sectors of the rows that passed the ones
    # before it, the time limbs at the rows that passed them all, the by()
    # column at those whose bin is in range; the constants and the counts
    log2 = lambda x: max(1, int(x).bit_length() - 1)  # noqa: E731
    keep = torch.ones(n_spans, dtype=torch.bool, device=dev)
    nbytes, ops = edges_u64.nbytes + uvals.nbytes + 4 * length, 0
    for col, op, lit in preds:
        nbytes += u32_bytes_read(torch, arrays[col], keep)
        ops += 2 * int(keep.sum())
        c = u[col][:n_spans]
        keep = keep & ingest_tail._CMP[op](c, lit) & (c != 0)
    nbytes += sum(u32_bytes_read(torch, arrays[k], keep) for k in ("start_lo", "start_hi"))
    b = torch.searchsorted(edges, t_ns[:n_spans], right=True) - 1
    binned = keep & (b >= 0) & (b < nb)
    nbytes += u32_bytes_read(torch, arrays[fp.by_col], binned)
    ops += int(keep.sum()) * (2 * log2(len(lo)) + 4) + int(binned.sum()) * (2 * log2(len(uvals)) + 2)
    bnd, by = bound_ms(nbytes, ops)
    fold_rows = int(binned.sum())
    recs["tail_fold"] = dict(
        shape=f"{q}: n={n_spans} (p={p}), {len(preds)} predicates, by {fp.by_col} over "
              f"{len(uvals_real)} codes (u_pad {len(uvals)}), {nb} bins (e_pad {len(lo)}); "
              f"{fold_rows} rows counted, {nbytes} B fetched",
        max_abs_err=0, ms=ms, path_ms=path, plain_ms=plain, bound_ms=bnd, bound_by=by,
        library_ms=lib_ms)

    # the scan: service + duration bounds
    mn_ns, mx_ns = 100 * 10**6, 900 * 10**6
    eq = [("service", d.get("frontend"))]
    outs = [torch.empty(p, dtype=torch.uint8, device=dev) for _ in copies]
    sdescs = [ingest_tail.scan_descriptor(a, n_spans, eq, None, mn_ns, mx_ns, o)
              for a, o in zip(copies, outs)]

    def scan_launch(desc):
        def go():
            _build.check(lib.tt_tail_scan(ctypes.addressof(desc), stream()), "tail_scan")
        return go

    swant = ingest_tail.tail_scan(arrays, n_spans, eq, None, mn_ns, mx_ns)
    scan_launch(sdescs[0])()
    check(torch.equal(outs[0].view(torch.bool), swant)
          and torch.equal(ingest_tail._tail_scan_plain(arrays, n_spans, eq, None, mn_ns, mx_ns),
                          swant), f"tail_scan at {n_spans} rows: kernel != plain")
    sms = kernel_ms(torch, [scan_launch(x) for x in sdescs])
    spath = path_ms(torch, lambda: ingest_tail.tail_scan(arrays, n_spans, eq, None, mn_ns, mx_ns))
    splain = path_ms(torch, lambda: ingest_tail._tail_scan_plain(arrays, n_spans, eq, None, mn_ns,
                                                                 mx_ns))
    dur = (u["dur_hi"] << 32) | u["dur_lo"]

    def scan_chain():
        return (rows < n_spans) & (u["service"] == eq[0][1]) & (dur >= mn_ns) & (dur <= mx_ns)

    check(torch.equal(scan_chain(), swant), "tail_scan: the elementwise chain != the kernel")
    slib = path_ms(torch, scan_chain)
    # the service column in full, the duration limbs at the sectors of
    # the rows it passes, the p-byte mask
    svc = u["service"][:n_spans] == eq[0][1]
    sbytes = 4 * n_spans + p + sum(u32_bytes_read(torch, arrays[k], svc)
                                   for k in ("dur_lo", "dur_hi"))
    sbnd, sby = bound_ms(sbytes, 2 * n_spans + 6 * int(svc.sum()))
    recs["tail_scan"] = dict(
        shape=f"service.name=frontend minDuration=100ms maxDuration=900ms: n={n_spans} (p={p}); "
              f"{int(svc.sum())} rows of the service, {sbytes} B fetched",
        max_abs_err=0, ms=sms, path_ms=spath, plain_ms=splain, bound_ms=sbnd, bound_by=sby,
        library_ms=slib)
    del copies, counts, outs
    for k, r in recs.items():
        print(f"phase 12 (b) {k} timing ({r['shape']}): kernel {r['ms']:.5f} ms "
              f"({r['bound_ms'] / r['ms']:.0%} of bound), path {r['path_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])}, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    return recs


class LoopbackMemcached:
    """A memcached text-protocol server on 127.0.0.1 in this process (set
    and get only): the remote tier that outlives an App's crash, as a
    deployment's memcached does."""

    def __init__(self):
        import socket
        import threading

        self.data: dict = {}
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        import threading

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        f = conn.makefile("rb")
        try:
            while True:
                line = f.readline()
                if not line:
                    return
                parts = line.split()
                if parts[0] == b"set":
                    val = f.read(int(parts[4]))
                    f.read(2)
                    self.data[parts[1]] = val
                    conn.sendall(b"STORED\r\n")
                elif parts[0] == b"get":
                    out = bytearray()
                    for k in parts[1:]:
                        v = self.data.get(k)
                        if v is not None:
                            out += b"VALUE %s 0 %d\r\n%s\r\n" % (k, len(v), v)
                    conn.sendall(bytes(out) + b"END\r\n")
        except OSError:
            return
        finally:
            conn.close()

    def close(self):
        self.sock.close()


# phase 13's seven unbounded tag searches: phase 7's, over HTTP
# five of phase 7's seven unbounded searches (phases 7, 8 and 10 hold all
# seven against the oracle): the two with the largest answers
# (service=cart, http.status_code=500) are left out and the window is
# one minute of A's, so a pass's searches cost seconds, not tens of them
RC_SEARCHES = [
    ("service=cart name=db.query", {"tags": "service=cart name=db.query"}),
    ("region=v7", {"tags": "region=v7"}),
    ("duration>=990ms", {"minDuration": "990ms"}),
    ("window", {"start": BASE_S + 8 * 60, "end": BASE_S + 9 * 60}),
    ("service=no-such-service", {"tags": "service=no-such-service"}),
]
# past this many seconds of phases 0-12, phase 13 sheds its after-push
# searches: the worst phases 0-12 recorded (909.5 s, a slow host) plus
# phase 13 with that shed stay well inside the 1,200-s limit
SHED13_S = 800
RC_GRAPH = [("dependencies", "/api/graph/dependencies"),
            ("critical-path", "/api/graph/critical-path?by=service")]
# phase 13's standing queries: four of phase 9's, two served from
# step-partial rows and two from span rows
RC_STANDING = ["{ } | rate() by (resource.service.name)",
               "{ status = error } | count_over_time() by (name)",
               "{ } | histogram_over_time(duration)",
               "{ } | quantile_over_time(duration, 0.9) by (name)"]


def resultcache_phase(seed: int, root: str, queries: list, plan_of, shed: bool = False) -> dict:
    """Phase 13 (a), the result cache and the backend cache at full width:
    root/src/blocks holds copies of phase 6's two card-written 2**20-span
    blocks (tenant smoke) and of phase 11's 2**20-span make_graph_batch
    block (tenant single-tenant). A card App with the result cache on
    and `cache: memory`, and a second card App over another copy with
    TEMPO_TPU_RESULT_CACHE=0 around its requests, both with hedging off
    and every query's insights recorded, are asked over HTTP phase 4's
    three query_range queries, phase 7's seven tag searches (unbounded),
    one /api/graph/critical-path and one /api/graph/dependencies, in
    passes: cold (each block recomputed through the card and stored),
    repeat (every block a hit: no seg_bincount or root_path_sums launch,
    inspectedBytes 0), after 2**16 spans pushed as 16 OTLP requests and
    /flushed into a third block (the old blocks hit, the new one
    recomputes), and the query_range and graph requests once more under
    TEMPO_TPU_FAULTS=corrupt=1.0,seed=7 (every fetched entry damaged,
    detected and recomputed; damaged search entries are held against
    the JAX package in tests/test_torch_resultcache.py). Every answer is
    bit-equal to the cache-off App's; the result-cache counters and
    /api/query-insights's verdicts move as the reference's do. Then four
    standing queries on a third App (cache: memcached on a loopback
    server) over 2**17 recent spans, crashed and restarted twice: the
    second restart's rebuilds replay the stored row logs, and every read
    equals the first rebuild's and a cache-off App's. `shed` (a slow
    host's depth cut) drops the seven searches from both Apps' after-push
    passes, a repeat of the repeat pass's search hits and the cold
    pass's search misses. Returns its numbers, with the launches of the
    cache-on App's passes (`launches_path`) apart from the cache-off
    App's (`launches_control`)."""
    import http.client

    from tempo_tpu_torch import resultcache as rc_mod
    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig
    from tempo_tpu_torch.encoding.vtpu.colcache import shared_cache
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.modules.frontend import FrontendConfig
    from tempo_tpu_torch.modules.overrides import Limits
    from tempo_tpu_torch.receivers import otlp
    from tempo_tpu_torch.resultcache import ResultCacheConfig
    from tempo_tpu_torch.util.devicetiming import STATS

    t_phase = time.perf_counter()
    res: dict = {"passes": {}}
    smoke, gtenant = "smoke", "single-tenant"
    kinds = rc_mod.RC_KINDS

    def counts() -> dict:
        return {kind: {name: c.value(kind=kind) for name, c in (
            ("hits", rc_mod.rc_hits), ("misses", rc_mod.rc_misses),
            ("negative", rc_mod.rc_negative), ("stores", rc_mod.rc_stores),
            ("corrupt", rc_mod.rc_corrupt), ("bytes_saved", rc_mod.rc_bytes_saved))}
            for kind in kinds}

    def delta(after: dict, before: dict) -> dict:
        return {k: {n: after[k][n] - before[k][n] for n in after[k]} for k in after}

    def make_app(name: str, cache_on: bool):
        app_root = os.path.join(root, name)
        shutil.copytree(os.path.join(root, "src", "blocks"), os.path.join(app_root, "blocks"))
        app = App(AppConfig(
            db=DBConfig(backend="local", backend_path=os.path.join(app_root, "blocks"),
                        wal_path=os.path.join(app_root, "wal"), cache="memory",
                        # both tiers sized for the unbounded searches'
                        # partials (~100 MB of JSON over the two blocks;
                        # each tier's default is 64 MB)
                        cache_options={"max_bytes": 1 << 30},
                        result_cache=ResultCacheConfig(enabled=cache_on, max_bytes=1 << 30)),
            # every query recorded in the insights ring, none logged as slow
            frontend=FrontendConfig(hedge_after_s=0, insights_sample_every=1,
                                    insights_slow_threshold_s=3600.0),
            limits=Limits(max_traces_per_user=1 << 16), multitenancy_enabled=True,
            generator_enabled=False), device="cuda")
        server = TempoServer(app, host="127.0.0.1", port=0).start()
        app.db.poll_now()
        return app, server, http.client.HTTPConnection("127.0.0.1", server.port, timeout=900)

    apps = {"on": make_app("on", True), "off": make_app("off", False)}
    on_app = apps["on"][0]
    check(on_app.device.type == "cuda" and on_app.db.result_cache.enabled()
          and type(on_app.db.backend.raw).__name__ == "CachedBackend",
          f"phase 13: the cache-on App runs on {on_app.device}")
    check(not apps["off"][0].db.result_cache.enabled(), "phase 13: the cache-off App caches")
    n_blocks = {t: len(on_app.db.blocklist.metas(t)) for t in (smoke, gtenant)}
    check(n_blocks == {smoke: 2, gtenant: 1}, f"phase 13: blocks {n_blocks}")

    def request(which: str, method: str, path: str, tenant: str, body=None, headers=None):
        conn = apps[which][2]
        # the cache-off App's requests run with the kill switch set
        if which == "off":
            os.environ["TEMPO_TPU_RESULT_CACHE"] = "0"
        try:
            conn.request(method, path, body=body,
                         headers={"X-Scope-OrgID": tenant, **(headers or {})})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            os.environ.pop("TEMPO_TPU_RESULT_CACHE", None)

    def ask_all(which: str, searches: bool = True) -> tuple[dict, dict, dict]:
        """Every request of a pass: (answers, the bytes each reports
        inspected, the ms each took from the request to its parsed
        answer)."""
        answers, inspected, ms = {}, {}, {}
        for q in queries:
            plan = plan_of(q)
            t0 = time.perf_counter()
            status, body = request(which, "GET", "/api/metrics/query_range?" + urllib.parse.urlencode(
                {"q": q, "start": plan.start_s, "end": plan.end_s, "step": plan.step_s,
                 "maxSeries": plan.max_series}), smoke)
            doc = json.loads(body)
            ms["qr " + q] = (time.perf_counter() - t0) * 1e3
            check(status == 200 and doc["data"]["result"], f"phase 13 {which} query_range {q}: "
                  f"HTTP {status}")
            answers["qr " + q] = doc["data"]["result"]
            inspected["qr " + q] = int(doc["metrics"].get("inspectedBytes", 0))
        for label, params in RC_SEARCHES if searches else ():
            t0 = time.perf_counter()
            status, body = request(which, "GET", "/api/search?" + urllib.parse.urlencode(
                {**params, "limit": 10**7}), smoke)
            doc = json.loads(body)
            ms["search " + label] = (time.perf_counter() - t0) * 1e3
            check(status == 200, f"phase 13 {which} search {label}: HTTP {status}")
            answers["search " + label] = doc["traces"]
            inspected["search " + label] = int(doc["metrics"].get("inspectedBytes", 0))
        for label, path in RC_GRAPH:
            t0 = time.perf_counter()
            status, body = request(which, "GET", path, gtenant)
            doc = json.loads(body)
            ms[label] = (time.perf_counter() - t0) * 1e3
            check(status == 200, f"phase 13 {which} {label}: HTTP {status}")
            # the answer without its cost stats (a hit inspects nothing)
            answers[label] = {k: v for k, v in doc.items() if k != "stats"}
            inspected[label] = int(doc["stats"].get("inspectedBytes", 0))
        return answers, inspected, ms

    def run_pass(which: str, label: str, searches: bool = True) -> dict:
        # the host column cache is process-wide: emptied before every
        # pass, so each App's recompute reads its blocks from its backend
        shared_cache().clear()
        l0 = read_launches()
        d0 = sum(STATS.d2h.values())
        c0 = counts()
        t0 = time.perf_counter()
        answers, inspected, req_ms = ask_all(which, searches)
        launches = {k: n - l0[k] for k, n in read_launches().items()}
        rec = dict(ms=(time.perf_counter() - t0) * 1e3,
                   split_ms={kind: sum(v for k, v in req_ms.items() if k.startswith(pre))
                             for kind, pre in (("query_range", "qr "), ("search", "search "),
                                               ("graph", ("dependencies", "critical-path")))},
                   request_ms=req_ms, launches=launches,
                   seg_bincount=launches["seg_bincount"],
                   root_path_sums=launches["root_path_sums"],
                   d2h_bytes=sum(STATS.d2h.values()) - d0, rc=delta(counts(), c0),
                   inspected_bytes=sum(inspected.values()))
        res["passes"][f"{which} {label}"] = rec
        print(f"phase 13 pass {which} {label}: {rec['ms']:.0f} ms ("
              + ", ".join(f"{k} {v:.0f}" for k, v in rec["split_ms"].items())
              + f"), seg_bincount "
              f"{rec['seg_bincount']} / root_path_sums {rec['root_path_sums']} launches, "
              f"{rec['d2h_bytes']} B device-to-host, {rec['inspected_bytes']} B inspected | "
              "result cache " + ", ".join(
                  f"{k} " + "/".join(f"{int(v)}" for v in rec["rc"][k].values())
                  for k in ("search", "metrics", "graph"))
              + " (hits/misses/negative/stores/corrupt/bytes saved)", flush=True)
        return answers, inspected, rec

    def same(a: dict, b: dict, what: str) -> None:
        for k in b:
            check(a[k] == b[k], f"phase 13 {what}: {k} differs from the cache-off App's")

    def lookups() -> dict:
        """A pass's result-cache lookups by kind: one a block a request
        asks about (a search with a window only the blocks it overlaps)."""
        metas = on_app.db.blocklist.metas(smoke)
        n = {"metrics": 0, "search": 0,
             "graph": len(RC_GRAPH) * len(on_app.db.blocklist.metas(gtenant))}
        for q in queries:
            # the frontend's step-aligned time shards, each a job over the
            # blocks it overlaps (the fingerprint holds the shard's window)
            plan = plan_of(q)
            per = -(-plan.n_bins // max(1, min(on_app.frontend.cfg.query_shards, plan.n_bins)))
            for b in range(0, plan.n_bins, per):
                w0 = plan.start_s + b * plan.step_s
                w1 = min(plan.end_s, w0 + per * plan.step_s)
                n["metrics"] += sum(1 for m in metas if m.end_time >= w0 and m.start_time <= w1)
        for _, params in RC_SEARCHES:
            lo, hi = params.get("start", 0), params.get("end", 0)
            n["search"] += sum(1 for m in metas if not lo or (m.end_time >= lo
                                                              and m.start_time <= hi))
        return n

    def insights_verdicts() -> list:
        status, body = request("on", "GET", "/api/query-insights?limit=1000", smoke)
        recs = [r for r in json.loads(body)["insights"]
                if r.get("kind") == "query_range" and r.get("resultCache")]
        return [r["resultCache"] for r in sorted(recs, key=lambda r: r.get("ts", 0))]

    try:
        # ------------------------------------------------ cold and repeat
        want, _, off_rec = run_pass("off", "before the push")
        check(off_rec["seg_bincount"] > 0 and off_rec["root_path_sums"] > 0
              and all(v == 0 for k in kinds for v in off_rec["rc"][k].values()),
              "phase 13: the cache-off App did not recompute, or touched the result cache")
        cold, cold_inspected, rec = run_pass("on", "cold")
        same(cold, want, "cold pass")
        check(rec["seg_bincount"] > 0 and rec["root_path_sums"] > 0,
              f"phase 13 cold pass: {rec['seg_bincount']} seg_bincount, "
              f"{rec['root_path_sums']} root_path_sums launches")
        before_push = lookups()
        for kind, n in before_push.items():
            r = rec["rc"][kind]
            check(r["misses"] == n and r["stores"] == n and r["hits"] == 0,
                  f"phase 13 cold pass {kind}: {r} for {n} lookups")
        hit, hit_inspected, rec = run_pass("on", "repeat")
        same(hit, want, "repeat pass")
        check(rec["seg_bincount"] == 0 and rec["root_path_sums"] == 0,
              f"phase 13 repeat pass: {rec['seg_bincount']} seg_bincount, "
              f"{rec['root_path_sums']} root_path_sums launches")
        check(all(v == 0 for v in hit_inspected.values()),
              f"phase 13 repeat pass: inspected bytes {hit_inspected}")
        for kind, n in before_push.items():
            r = rec["rc"][kind]
            saved = sum(v for k, v in cold_inspected.items()
                        if k.split(" ")[0] == {"metrics": "qr", "search": "search"}.get(kind, k))
            if kind == "graph":
                saved = sum(cold_inspected[k] for k, _ in RC_GRAPH)
            check(r["hits"] + r["negative"] == n and r["misses"] == 0 and r["stores"] == 0
                  and r["bytes_saved"] == saved,
                  f"phase 13 repeat pass {kind}: {r} for {n} lookups, {saved} B inspected cold")

        # ------------------------------------------------ push, repeat
        pushed = [chain_parents(synth.make_batch(512, 8, seed=seed * 1000 + 1300 + i,
                                                 base_time_ns=(BASE_S + 60 * (40 + i // 2)) * 10**9,
                                                 n_attrs_per_span=1))
                  for i in range(16)]
        old_ids = {m.block_id for m in on_app.db.blocklist.metas(smoke)}
        t0 = time.perf_counter()
        for p in pushed:
            status, _ = request("on", "POST", "/v1/traces", smoke,
                                otlp.encode_traces_request(batch_to_traces(p)),
                                {"Content-Type": "application/x-protobuf"})
            check(status == 200, f"phase 13 push: HTTP {status}")
        status, _ = request("on", "POST", "/flush", smoke)
        res["push_s"] = time.perf_counter() - t0
        (new_meta,) = [m for m in on_app.db.blocklist.metas(smoke) if m.block_id not in old_ids]
        n_pushed = sum(p.num_spans for p in pushed)
        check(status == 204 and new_meta.total_spans == n_pushed,
              f"phase 13 flush: HTTP {status}, {new_meta.total_spans} spans flushed")
        # the cache-off App's copy of the backend gets the flushed block
        shutil.copytree(os.path.join(root, "on", "blocks", smoke, new_meta.block_id),
                        os.path.join(root, "off", "blocks", smoke, new_meta.block_id))
        apps["off"][0].db.poll_now()
        check(len(apps["off"][0].db.blocklist.metas(smoke)) == 3, "phase 13: the copied block")
        print(f"phase 13 push: {n_pushed} spans in {len(pushed)} OTLP requests, /flush -> a third "
              "block "
              f"({res['push_s']:.1f} s, {n_pushed / res['push_s']:.0f} spans/s), copied into the "
              "cache-off App's backend", flush=True)
        want2, _, _ = run_pass("off", "after the push", searches=not shed)
        push, _, rec = run_pass("on", "after the push", searches=not shed)
        same(push, want2, "after-push pass")
        check(rec["seg_bincount"] > 0 and rec["root_path_sums"] == 0,
              f"phase 13 after-push pass: {rec['seg_bincount']} seg_bincount, "
              f"{rec['root_path_sums']} root_path_sums launches")
        after_push = lookups()
        for kind, n in after_push.items():
            r = rec["rc"][kind]
            if shed and kind == "search":
                check(all(v == 0 for v in r.values()), f"phase 13 after-push pass {kind}: {r}")
                continue
            new = n - before_push[kind]
            check(r["hits"] + r["negative"] == n - new and r["misses"] == new
                  and r["stores"] == new, f"phase 13 after-push pass {kind}: {r}")
        verdicts = insights_verdicts()
        check(verdicts[:3 * len(queries)] == ["store"] * len(queries) + ["hit"] * len(queries)
              + ["store"] * len(queries),
              f"phase 13: /api/query-insights verdicts {verdicts}")
        res["verdicts"] = verdicts

        # ------------------------------------------------ damaged entries
        os.environ["TEMPO_TPU_FAULTS"] = "corrupt=1.0,seed=7"
        try:
            damaged, _, rec = run_pass("on", "under TEMPO_TPU_FAULTS=corrupt=1.0,seed=7",
                                       searches=False)
        finally:
            del os.environ["TEMPO_TPU_FAULTS"]
        same({k: want2[k] for k in damaged}, damaged, "corrupt pass")
        check(rec["seg_bincount"] > 0 and rec["root_path_sums"] > 0,
              "phase 13 corrupt pass: the damaged entries were not recomputed on the card")
        for kind, n in after_push.items():
            r = rec["rc"][kind]
            n = 0 if kind == "search" else n
            check(r["corrupt"] == n and r["misses"] == n and r["hits"] == 0,
                  f"phase 13 corrupt pass {kind}: {r} for {n} lookups")
        print(f"phase 13 (a): every answer of the four passes == the cache-off App's; "
              f"query_range verdicts {verdicts[:4 * len(queries)]}", flush=True)
    finally:
        os.environ.pop("TEMPO_TPU_RESULT_CACHE", None)
        for app, server, conn in apps.values():
            conn.close()
            server.stop()
            app.shutdown()

    for which in ("on", "off"):
        res["launches_path" if which == "on" else "launches_control"] = {
            k: sum(rec["launches"][k] for label, rec in res["passes"].items()
                   if label.split(" ")[0] == which) for k in launch_counters()}
    res["standing"] = _standing_restarts(seed, root)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def _standing_restarts(seed: int, root: str) -> dict:
    """Phase 13's standing part: 2**17 spans stamped over the 32 minutes
    that end 8 minutes before now, flushed into blocks; four standing
    queries registered (their rebuilds log each block's rows into the
    result cache on a loopback memcached); the App crashed (ingesters
    stopped without a flush) and restarted on the same paths twice; the
    second restart's rebuilds replay every block's row log (hits, no
    miss), and every read equals the reads before the crash and a
    cache-off App's over a copy of the backend."""
    from tempo_tpu_torch import resultcache as rc_mod
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.modules.overrides import Limits
    from tempo_tpu_torch.resultcache import ResultCacheConfig

    mc = LoopbackMemcached()
    out: dict = {}
    now_min = int(time.time()) // 60 * 60
    start, end = now_min - 45 * 60, now_min - 7 * 60

    def cfg(path: str, cache_on: bool):
        return AppConfig(db=DBConfig(
            backend="local", backend_path=os.path.join(path, "blocks"),
            wal_path=os.path.join(path, "wal"), cache="memcached",
            cache_options={"addresses": [mc.addr]},
            result_cache=ResultCacheConfig(enabled=cache_on)), generator_enabled=False,
            # 16,384 traces live until the flush: above the default cap
            limits=Limits(max_traces_per_user=1 << 16))

    def reads(app, ids) -> list:
        return [app.standing_read(qid, start_s=start, end_s=end)["result"] for qid in ids]

    def crash(app):
        for stop in app._heartbeat_stops:
            stop.set()
        for ing in app.ingesters.values():
            ing.stop(flush=False)
        app.workers.stop()
        app.compactor.stop()
        app.db.shutdown()

    path = os.path.join(root, "standing")
    t0 = time.perf_counter()
    try:
        app = App(cfg(path, True), device="cuda")
        for i in range(32):
            base = now_min - (40 - i) * 60
            app.push_spans(chain_parents(synth.make_batch(
                512, 8, seed=seed * 1000 + 1400 + i, base_time_ns=base * 10**9)))
        for ing in app.ingesters.values():
            ing.flush_all()
        app.db.poll_now()
        n_blocks = len(app.db.blocklist.metas("single-tenant"))
        check(n_blocks >= 1, "phase 13 standing: no block flushed")
        ids = [app.standing_register({"q": q, "step": 60, "window": 3600})["id"]
               for q in RC_STANDING]
        first = reads(app, ids)
        check(all(first), "phase 13 standing: an empty read")
        out["push_and_register_s"] = time.perf_counter() - t0
        rebuilds = []
        for k in range(2):
            crash(app)
            c0 = {n: c.value(kind="standing") for n, c in (("hits", rc_mod.rc_hits),
                                                          ("misses", rc_mod.rc_misses))}
            t1 = time.perf_counter()
            app = App(cfg(path, True), device="cuda")
            ms = (time.perf_counter() - t1) * 1e3
            got = reads(app, ids)
            d = {n: c.value(kind="standing") - c0[n] for n, c in (("hits", rc_mod.rc_hits),
                                                                 ("misses", rc_mod.rc_misses))}
            rebuilds.append(dict(restart_ms=ms, **d))
            check(got == first, f"phase 13 standing restart {k + 1}: reads != before the crash")
        check(rebuilds[1]["misses"] == 0 and rebuilds[1]["hits"] == n_blocks * len(ids),
              f"phase 13 standing: the second restart's rebuilds {rebuilds[1]}, "
              f"{n_blocks} blocks x {len(ids)} queries")
        app.shutdown()
        # the cache-off App: a copy of the blocks and of the registrations
        off_path = os.path.join(root, "standing_off")
        shutil.copytree(os.path.join(path, "blocks"), os.path.join(off_path, "blocks"))
        os.makedirs(os.path.join(off_path, "wal"))
        shutil.copy(os.path.join(path, "wal", "standing.json"),
                    os.path.join(off_path, "wal", "standing.json"))
        os.environ["TEMPO_TPU_RESULT_CACHE"] = "0"
        try:
            off = App(cfg(off_path, False), device="cuda")
            got_off = reads(off, ids)
            off.shutdown()
        finally:
            del os.environ["TEMPO_TPU_RESULT_CACHE"]
        check(got_off == first, "phase 13 standing: the cache-off App's reads differ")
    finally:
        mc.close()
    out.update(blocks=n_blocks, queries=len(ids), rebuilds=rebuilds,
               phase_s=time.perf_counter() - t0)
    print(f"phase 13 standing: {len(ids)} standing queries over {n_blocks} blocks of recent "
          f"spans; crash and restart x2 ({rebuilds[0]['restart_ms']:.0f} / "
          f"{rebuilds[1]['restart_ms']:.0f} ms, standing row logs hit/missed "
          f"{rebuilds[0]['hits']}/{rebuilds[0]['misses']} then {rebuilds[1]['hits']}/"
          f"{rebuilds[1]['misses']}); every read == the reads before the crashes == a cache-off "
          f"App's", flush=True)
    return out


def incident_phase(root: str) -> dict:
    """Phase 13 (b), the incident plane: a card App and a CPU App, each
    with slo (the vulture-read objective), rca and vulture enabled, run
    the reference's campaign (one SLO evaluation, an aged-tier vulture
    probe written and swept into a block, its metrics read back, a
    second evaluation a minute later) under TEMPO_TPU_FAULTS=notfound=
    1.0,seed=7: each opens exactly one incident, cause backend_fault at
    tier aged, the records equal apart from ids and clocks; the
    fault-free arm opens none; /api/rca, /api/rca/{id}, /status/rca and
    /status/slo answer the same on both Apps' servers. The metric
    registry is the process's, so the second App is built after the
    first App's campaign (its engines' baselines then start there) and
    /status/slo is compared without its cumulative raw counts."""
    import urllib.request

    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig
    from tempo_tpu_torch.rca import RCAConfig
    from tempo_tpu_torch.util.slo import SLOConfig, SLOObjective
    from tempo_tpu_torch.vulture import InProcessClient, Vulture, VultureConfig

    t_phase = time.perf_counter()
    clocks = ("id", "openedAt", "attributionSeconds", "at", "evaluatedAt", "enqueuedWall",
              "ts", "window", "elapsedMs", "insights", "usageDelta", "cumulative")

    def norm(doc):
        if isinstance(doc, dict):
            return {k: norm(v) for k, v in doc.items() if k not in clocks}
        if isinstance(doc, list):
            return [norm(v) for v in doc]
        return doc

    def get(url, path):
        with urllib.request.urlopen(url + path, timeout=300) as r:
            return r.status, json.loads(r.read())

    out: dict = {}
    labels = ("card", "host")
    for arm in ("notfound", "fault-free"):
        if arm == "notfound":
            os.environ["TEMPO_TPU_FAULTS"] = "notfound=1.0,seed=7"
        apps, servers, drives, incidents = {}, {}, {}, {}
        now = int(time.time())
        try:
            for label, dev in zip(labels, ("cuda", "cpu")):
                path = os.path.join(root, f"{arm}-{label}")
                app = apps[label] = App(AppConfig(
                    db=DBConfig(backend="local", backend_path=os.path.join(path, "blocks"),
                                wal_path=os.path.join(path, "wal"), analytics_scan_s=0),
                    generator_enabled=False,
                    slo=SLOConfig(enabled=True, eval_interval_s=3600,
                                  objectives=[SLOObjective("vulture-read", "vulture", 0.999)]),
                    rca=RCAConfig(enabled=True), vulture=VultureConfig(enabled=True)),
                    device=dev)
                servers[label] = TempoServer(app, host="127.0.0.1", port=0).start()
                check(app.device.type == dev and app.vulture is not None
                      and app.rca is not None and app.slo_engine is not None,
                      f"phase 13 {label}: the incident plane is off")
                t0 = time.time()
                app.slo_engine.evaluate(now=t0)
                v = Vulture(InProcessClient(app), write_backoff_s=10)
                info = v.write_once(now - 7200)
                app.sweep_all(immediate=True)
                try:
                    app.db.poll_now()
                except Exception:  # noqa: BLE001 — a faulted poll is part of the campaign
                    pass
                ok = v.check_metrics(now, tier="aged", info=info)
                app.slo_engine.evaluate(now=t0 + 60)
                drives[label] = (ok, dict(v.error_counts))
                n = app.rca._queue.qsize()
                if arm == "notfound":
                    check(n == 1, f"phase 13 {arm} {label}: {n} triggers")
                    incidents[label] = app.rca.process_trigger(app.rca._queue.get_nowait())
                else:
                    check(n == 0 and app.rca_list() == [],
                          f"phase 13 {arm} {label}: {n} triggers")
            check(drives["card"] == drives["host"] and drives["card"][0] is (arm != "notfound"),
                  f"phase 13 {arm}: the vulture's verdicts {drives}")
            if arm == "notfound":
                f = incidents["card"]["finding"]
                check((f["cause"], f["tier"], f["suppressed"]) == ("backend_fault", "aged", False),
                      f"phase 13 incident: {f}")
                check(norm(incidents["card"]) == norm(incidents["host"]),
                      "phase 13: the card App's incident != the CPU App's")
                out["finding"] = f
            for p in ["/api/rca", "/status/rca", "/status/slo"] + (
                    ["/api/rca/{id}"] if arm == "notfound" else []):
                docs = {}
                for label, srv in servers.items():
                    q = p.replace("{id}", incidents.get(label, {}).get("id", ""))
                    status, docs[label] = get(srv.url, q)
                    check(status == 200, f"phase 13 {arm} {label} {q}: HTTP {status}")
                check(norm(docs["card"]) == norm(docs["host"]),
                      f"phase 13 {arm} {p}: the card App's document != the CPU App's")
            out[arm] = dict(incidents=len(incidents), vulture_errors={
                f"{kind} {tier}": n for (kind, tier), n in drives["card"][1].items()})
        finally:
            os.environ.pop("TEMPO_TPU_FAULTS", None)
            for srv in servers.values():
                srv.stop()
            for app in apps.values():
                app.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 13 (b) incidents: under notfound=1.0,seed=7 one incident on each App, cause "
          f"{out['finding']['cause']} at tier {out['finding']['tier']} ({out['finding']['details']})"
          f", card == CPU; the fault-free arm opens none; /api/rca, /api/rca/{{id}}, /status/rca "
          f"and /status/slo equal on both ({out['phase_s']:.1f} s)", flush=True)
    return out


# --------------------------------------------------------------- phase 14
# past this many seconds of phases 0-13, phase 14 sheds its vulture
# probes and its second round of finds (after the kill): the phase took
# 66.1 s unshed alone on the card, and phases 0-13 979.8 s on the slowest
# host recorded, so an unshed phase there (~85 s) still ends the script
# under 1,100 s
SHED14_S = 1000
# phase 14's finds a round, present and absent each: a find through the
# frontend is 13 HTTP exchanges in one interpreter (5 jobs, each a pull
# and a result POST, and the ingesters' RPC), ~28 ms a find on a slow host
# with 8 in flight (2,000 took 55.5 s on the card's host), so 1,000 of
# each a round would not fit the phase's 90 s
N_FIND = 250


def _snappy_block(data: bytes) -> bytes:
    """The snappy block format, decoded here with its own few lines (the
    sink checks the port's encoder, so it does not use the port's
    decoder): a varint length, then literals and copies."""
    want, pos, shift = 0, 0, 0
    while True:
        b = data[pos]
        pos += 1
        want |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            break
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind, n = tag & 3, tag >> 2
        if kind == 0:
            if n >= 60:
                n, pos = int.from_bytes(data[pos:pos + n - 59], "little"), pos + n - 59
            out += data[pos:pos + n + 1]
            pos += n + 1
            continue
        if kind == 1:
            length, off = (n & 7) + 4, ((tag >> 5) << 8) | data[pos]
            pos += 1
        else:
            width = 2 if kind == 2 else 4
            length, off = n + 1, int.from_bytes(data[pos:pos + width], "little")
            pos += width
        for _ in range(length):
            out.append(out[-off])
    check(len(out) == want, f"snappy: {len(out)} bytes, header says {want}")
    return bytes(out)


def _pb_fields(buf: bytes):
    """(field, wire type, value) of one protobuf message: varints,
    fixed64 as its 8 bytes, length-delimited as bytes."""
    pos = 0
    while pos < len(buf):
        key, shift = 0, 0
        while True:
            b = buf[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                break
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, shift = 0, 0
            while True:
                b = buf[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if b < 0x80:
                    break
        elif wt == 1:
            v, pos = buf[pos:pos + 8], pos + 8
        elif wt == 2:
            n, shift = 0, 0
            while True:
                b = buf[pos]
                pos += 1
                n |= (b & 0x7F) << shift
                shift += 7
                if b < 0x80:
                    break
            v, pos = buf[pos:pos + n], pos + n
        else:
            raise SmokeFailure(f"protobuf wire type {wt}")
        yield field, wt, v


def _write_request_series(payload: bytes) -> dict:
    """prompb.WriteRequest -> {(name, labels without __name__): value}."""
    import struct

    out = {}
    for f, _, ts in _pb_fields(payload):
        check(f == 1, f"WriteRequest field {f}")
        labels, value = [], None
        for f2, _, v2 in _pb_fields(ts):
            if f2 == 1:
                kv = {f3: v3.decode() for f3, _, v3 in _pb_fields(v2)}
                labels.append((kv[1], kv[2]))
            elif f2 == 2:
                for f3, _, v3 in _pb_fields(v2):
                    if f3 == 1:
                        value = struct.unpack("<d", v3)[0]
        check(labels[0][0] == "__name__", f"WriteRequest labels {labels[:2]}")
        out[labels[0][1], tuple(labels[1:])] = value
    return out


class RemoteWriteSink:
    """A loopback Prometheus remote-write receiver: records each POST's
    headers and decodes its body (snappy, then prompb) with the few lines
    above."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sink = self
        self.posts: list = []

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                sink.posts.append((self.path, dict(self.headers), body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def series(self) -> dict:
        out = {}
        for path, headers, body in self.posts:
            check(path == "/api/v1/write" and headers.get("Content-Encoding") == "snappy"
                  and headers.get("X-Prometheus-Remote-Write-Version") == "0.1.0",
                  f"remote write POST {path} {headers}")
            out.update(_write_request_series(_snappy_block(body)))
        return out

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cluster_phase(seed: int, root: str, queries: list, shed: bool = False) -> dict:
    """Phase 14, microservices mode on the card: the upstream e2e's
    topology (TestMicroservicesWithKVStores) plus the other roles, each an
    App(device="cuda") behind its own TempoServer on 127.0.0.1 and every
    inter-role call over HTTP: 3 ingesters at replication factor 2, a
    distributor serving the ring KV (ring_kv_url: local; the others point
    at it), a query-frontend, two queriers (one here, one a `python -m
    tempo_tpu_torch -target=querier` process with its own CUDA context),
    a compactor, a metrics-generator whose remote write goes to a
    loopback sink here, and a vulture sidecar. The oracle is a target=all
    App on the CPU with 3 in-process ingesters at RF 2 (the same ring
    tokens, so the same replica sets), fed the same OTLP bodies and
    killed the same way. 32 pushes of 512 make_graph_batch traces of 8
    spans (phase 11's stream, 2**17 spans, stamped in the last hour) go
    to the distributor; then through the frontend: finds of N_FIND
    present and N_FIND absent IDs; ingester-1 killed and the finds again
    (`shed` drops this round and the vulture); the ingesters' idle cut; a
    tag search and phase 4's three query_range over the live data;
    /flush of the two survivors; the compactor merges the three blocks
    (the RF copies deduplicated: every span once); the three query_range,
    two tag searches, dependencies and a critical path over the blocks
    (repeated until both queriers have launched seg_bincount); the
    vulture's probes. Every answer equals the oracle's: traces span for
    span, search results field by field, matrices, graph documents, and
    the remote-written series the oracle generator's (the expiry counter
    aside, as in phase 11). Returns its numbers."""
    import concurrent.futures
    import http.client
    import threading

    import numpy as np

    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.modules.frontend import FrontendConfig
    from tempo_tpu_torch.modules.generator import servicegraphs as sg
    from tempo_tpu_torch.modules.generator.storage import RemoteWriteConfig
    from tempo_tpu_torch.modules.ingester import IngesterConfig
    from tempo_tpu_torch.modules.overrides import Limits
    from tempo_tpu_torch.receivers import otlp
    from tempo_tpu_torch.vulture import VultureConfig

    tenant = "single-tenant"
    t_phase = time.perf_counter()
    res: dict = {"requests": {}, "launches": {}, "querier_b_dispatches": {}, "stage_s": {}}
    now_min = int(time.time()) // 60 * 60
    t_data = now_min - 40 * 60
    pushed = [synth.make_graph_batch(512, 8, seed=seed * 1000 + 1400 + i,
                                     base_time_ns=(t_data + 60 * (i // 2)) * 10**9,
                                     error_rate=0.1)
              for i in range(32)]
    traces = [t for b in pushed for t in batch_to_traces(b)]
    bodies = [otlp.encode_traces_request(batch_to_traces(b)) for b in pushed]
    n_spans = sum(b.num_spans for b in pushed)
    by_id = {t.trace_id: t for t in traces}
    rng = np.random.default_rng(seed + 14)
    present = [traces[i].trace_id for i in rng.choice(len(traces), N_FIND, replace=False)]
    absent = [bytes(x) for x in rng.integers(0, 2**32, (N_FIND + 50, 4), dtype=np.uint32)
              .astype(">u4").view(np.uint8).reshape(-1, 16)]
    absent = [x for x in absent if x not in by_id][:N_FIND]
    window = dict(start=t_data - 300, end=now_min, step=60)
    searches = [("service.name=cart", {"tags": "service.name=cart", "limit": 10**6}),
                ("status=500 minDuration=40ms", {"tags": "http.status_code=500",
                                                 "minDuration": "40ms", "limit": 10**6})]

    def cfg(target, name, **kw):
        sub = os.path.join(root, name)
        return AppConfig(
            target=target, instance_id=name, replication_factor=2, query_workers=2,
            db=DBConfig(backend="local", backend_path=os.path.join(root, "blocks"),
                        wal_path=os.path.join(sub, "wal"), blocklist_poll_s=3600.0,
                        analytics_scan_s=0),
            ingester=IngesterConfig(max_trace_idle_s=3600.0, flush_check_period_s=3600.0),
            frontend=FrontendConfig(hedge_after_s=0),
            limits=Limits(max_traces_per_user=1 << 16), **kw)

    nodes: dict = {}  # name -> (app, server)
    conns: dict = {}
    procs: list = []
    sink = RemoteWriteSink()

    def start(name, target, **kw):
        app = App(cfg(target, name, **kw), device="cuda")
        srv = TempoServer(app, host="127.0.0.1", port=0).start()
        if app.ring is not None and target == "ingester":
            app.ring.register(name, addr=srv.url)  # advertise the port it got
        if target == "metrics-generator":
            app.generator_ring.register(name, addr=srv.url)
        app.start_loops()
        nodes[name] = (app, srv)
        return app, srv

    def stop(name):
        app, srv = nodes.pop(name)
        srv.stop()
        app.shutdown()

    def request(url, kind, method, path, body=None, headers=None, timed=True):
        """One request on this thread's keep-alive connection to `url`."""
        key = (url, threading.get_ident())
        conn = conns.get(key)
        if conn is None:
            host, port = url.rsplit("/", 1)[-1].split(":")
            conn = conns[key] = http.client.HTTPConnection(host, int(port), timeout=600)
        t0 = time.perf_counter()
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            out = r.read()
        except OSError:
            conns.pop(key).close()
            raise
        if timed:
            res["requests"].setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        return r.status, out

    def launches_since(l0):
        return {k: n - l0[k] for k, n in read_launches().items() if n - l0[k]}

    def querier_b_dispatches():
        status, body = request(qb_url, "status", "GET", "/status/device", timed=False)
        check(status == 200, f"phase 14 querier-1 /status/device: HTTP {status}")
        return json.loads(body)["transfer"]["dispatchesByKernel"]

    def norm_trace(raw):
        """A trace's spans as sorted (resource, scope, span) records: the
        parts of a trace combine in the order its replicas answer."""
        out = []
        for rs in otlp.encode_traces_json(otlp.decode_traces_request(raw))["resourceSpans"]:
            res_ = json.dumps(rs.get("resource", {}), sort_keys=True)
            for ss in rs.get("scopeSpans", []):
                scope = json.dumps(ss.get("scope", {}), sort_keys=True)
                out += [(res_, scope, json.dumps(sp, sort_keys=True))
                        for sp in ss.get("spans", [])]
        return sorted(out)

    oracle = None
    oracle_srv = None
    qb_log = None
    try:
        # the second querier starts first: its interpreter, torch and CUDA
        # context come up while the rest of the cluster does
        qb_port = _free_port()
        qb_url = f"http://127.0.0.1:{qb_port}"
        dist, dist_srv = start("distributor-0", "distributor", ring_kv_url="local")
        kv = dist_srv.url
        qb_dir = os.path.join(root, "querier-1")
        os.makedirs(qb_dir, exist_ok=True)
        fe, fe_srv = start("frontend-0", "query-frontend")
        fe.rpc.pull_timeout_s = 2.0  # teardown waits out one long-poll at most
        with open(os.path.join(qb_dir, "tempo.yaml"), "w") as f:
            f.write(f"target: querier\ninstance_id: querier-1\nreplication_factor: 2\n"
                    f"query_workers: 2\nring_kv_url: {kv}\nfrontend_address: {fe_srv.url}\n"
                    f"server:\n  http_listen_address: 127.0.0.1\n  http_listen_port: {qb_port}\n"
                    f"  log_level: warn\nstorage:\n  trace:\n    backend: local\n"
                    f"    backend_path: {root}/blocks\n    wal_path: {qb_dir}/wal\n"
                    f"    analytics_scan_s: 0\n")
        qb_log = open(os.path.join(qb_dir, "log.txt"), "w")
        here = os.path.dirname(os.path.abspath(__file__))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tempo_tpu_torch", "-config.file",
             os.path.join(qb_dir, "tempo.yaml")],
            cwd=here, env=dict(os.environ, PYTHONPATH=here), stdout=qb_log, stderr=qb_log))
        for i in range(3):
            start(f"ingester-{i}", "ingester", ring_kv_url=kv)
        gen, gen_srv = start("generator-0", "metrics-generator", ring_kv_url=kv,
                             remote_write=RemoteWriteConfig(
                                 endpoint=sink.url, wal_dir=os.path.join(root, "rw"),
                                 send_interval_s=3600.0))
        qa, qa_srv = start("querier-0", "querier", ring_kv_url=kv, frontend_address=fe_srv.url)
        comp, _ = start("compactor-0", "compactor")
        check(all(app.device.type == "cuda" for app, _ in nodes.values()),
              f"phase 14: roles on {[str(a.device) for a, _ in nodes.values()]}")
        oracle = App(AppConfig(
            n_ingesters=3, replication_factor=2,
            db=DBConfig(backend="local", backend_path=os.path.join(root, "oracle", "blocks"),
                        wal_path=os.path.join(root, "oracle", "wal"), blocklist_poll_s=3600.0,
                        analytics_scan_s=0),
            ingester=IngesterConfig(max_trace_idle_s=3600.0, flush_check_period_s=3600.0),
            frontend=FrontendConfig(hedge_after_s=0),
            limits=Limits(max_traces_per_user=1 << 16)), device="cpu")
        oracle_srv = TempoServer(oracle, host="127.0.0.1", port=0).start()
        # every role on the ring it needs before the first push; querier-1
        # (its interpreter, torch and CUDA context) joins while the cluster
        # takes the push and the finds, and is waited for before the reads
        # over the blocks
        t_end = time.monotonic() + 120
        while True:
            ring = {i.instance_id: i.addr for i in dist.ring.instances()}
            gring = {i.instance_id: i.addr for i in dist.generator_ring.instances()}
            if all(ring.get(f"ingester-{i}") for i in range(3)) and gring.get("generator-0"):
                break
            check(time.monotonic() < t_end, f"phase 14: ring {ring}, generator ring {gring}")
            time.sleep(0.05)
        res["start_s"] = time.perf_counter() - t_phase
        print(f"phase 14 cluster: distributor (ring KV), 3 ingesters at RF 2, frontend, "
              f"querier-0 here, querier-1 in its own process (pid {procs[0].pid}), compactor, "
              f"metrics-generator (remote write to {sink.url}), every role on the card; "
              f"up in {res['start_s']:.1f} s", flush=True)

        # ---------------------------------------------------------- push
        l0 = read_launches()
        t0 = time.perf_counter()
        for body in bodies:
            status, _ = request(dist_srv.url, "push", "POST", "/v1/traces", body,
                                {"Content-Type": "application/x-protobuf"})
            check(status == 200, f"phase 14 push: HTTP {status}")
        res["push_s"] = time.perf_counter() - t0
        res["push_spans_per_s"] = n_spans / res["push_s"]
        res["launches"]["push"] = launches_since(l0)
        t0 = time.perf_counter()
        for body in bodies:
            status, _ = request(oracle_srv.url, "oracle push", "POST", "/v1/traces", body,
                                {"Content-Type": "application/x-protobuf"}, timed=False)
            check(status == 200, f"phase 14 oracle push: HTTP {status}")
        res["stage_s"]["oracle push"] = time.perf_counter() - t0
        print(f"phase 14 push: {n_spans} spans ({len(traces)} make_graph_batch traces) in "
              f"{len(bodies)} OTLP requests to the distributor: {res['push_spans_per_s']:.0f} "
              f"spans/s | launches {res['launches']['push']}", flush=True)

        # -------------------------------------------------- reads, live
        def finds(label):
            """Every present and absent ID through the frontend over HTTP,
            8 at a time, each answer == the oracle App's (asked in
            process: it is not under test) span for span."""
            def one(tid):
                st, body = request(fe_srv.url, f"find {label}", "GET", f"/api/traces/{tid.hex()}",
                                   headers={"Accept": "application/protobuf"})
                return tid, st, body, oracle.find_trace(tid)

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                for tid, st, body, want in ex.map(one, present + absent):
                    if tid in by_id:
                        check(st == 200 and want is not None
                              and norm_trace(body) == norm_trace(otlp.encode_traces_request([want]))
                              and want.span_count() == by_id[tid].span_count(),
                              f"phase 14 find {label} {tid.hex()}: HTTP {st}")
                    else:
                        check(st == 404 and want is None, f"phase 14 find {label} absent: {st}")
            res["stage_s"][f"finds {label}"] = time.perf_counter() - t0

        def same(kind, path, norm):
            st, body = request(fe_srv.url, kind, "GET", path)
            ost, obody = request(oracle_srv.url, "oracle", "GET", path, timed=False)
            check(st == ost == 200, f"phase 14 {path}: HTTP {st} / {ost}")
            got = norm(body)
            check(got == norm(obody), f"phase 14 {path}: != the oracle's")
            return got

        def search_traces(raw):
            """The results field by field, in trace ID order (the live
            segments of the replicas arrive in ring order)."""
            return sorted(json.loads(raw)["traces"], key=lambda t: t["traceID"])

        def matrix(raw):
            doc = json.loads(raw)
            check(doc["status"] == "success", f"phase 14 query_range: {doc.get('status')}")
            return doc["data"]["result"]

        def qr_path(q):
            return "/api/metrics/query_range?" + urllib.parse.urlencode(dict(q=q, **window))

        def reads(label, search_list):
            out = {}
            for name, params in search_list:
                out[name] = len(same("search", "/api/search?" + urllib.parse.urlencode(params),
                                     search_traces))
            for q in queries:
                out[q] = len(same("query_range", qr_path(q), matrix))
            return out

        finds("live")
        print(f"phase 14 finds: {N_FIND} present IDs found whole and {N_FIND} absent -> 404, "
              f"span for span the oracle's ({res['stage_s']['finds live']:.1f} s)", flush=True)

        # ------------------------------------------------------ the kill
        # the role flushes on its way out into a block no other role has
        # polled; the oracle's in-process ingesters share one blocklist, so
        # its ingester-1 stops without a flush (every trace keeps a replica
        # on ingester-0 or ingester-2 at RF 2)
        stop("ingester-1")
        oracle.ring.unregister("ingester-1")
        oracle.ingesters.pop("ingester-1").stop(flush=False)
        t_end = time.monotonic() + 120
        while True:  # both queriers' rings (KV watches) lose ingester-1
            rings = [{i.instance_id for i in qa.ring.instances()}]
            try:
                st, body = request(qb_url, "status", "GET", "/ingester/ring", timed=False)
                rings.append({i["id"] for i in json.loads(body)["instances"]})
            except OSError:  # querier-1 still starting: it reads the ring when up
                pass
            if all(r == {"ingester-0", "ingester-2"} for r in rings):
                break
            check(time.monotonic() < t_end, f"phase 14 kill: rings {rings}")
            time.sleep(0.05)
        if shed:
            res["stage_s"]["finds after the kill"] = None
        else:
            finds("after the kill")
        print("phase 14 kill: ingester-1 stopped (its role flushes on the way out); "
              + ("the second round of finds shed" if shed else
                 f"every find again == the oracle's "
                 f"({res['stage_s']['finds after the kill']:.1f} s)"), flush=True)

        # the ingesters' idle cut, run now on both sides (their loops would
        # run it max_trace_idle_s after the push): every live trace into
        # the head block's segment, which /rpc/v1/ingester/live then ships
        # as one segment a cut instead of one a trace
        t0 = time.perf_counter()
        for ing in [app.ingesters[n] for n, (app, _) in nodes.items()
                    if n.startswith("ingester-")] + list(oracle.ingesters.values()):
            ing.instance(tenant).cut_complete_traces(immediate=True)
        res["cut_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        live = reads("live", searches[:1])
        res["stage_s"]["reads live"] = time.perf_counter() - t0
        print(f"phase 14 live reads: a tag search and the three query_range over the "
              f"survivors' live data == the oracle's ({live}; the cut {res['cut_ms']:.0f} ms)",
              flush=True)

        # ---------------------------------------------- flush, compact
        l0 = read_launches()
        t0 = time.perf_counter()
        for name in ("ingester-0", "ingester-2"):
            st, _ = request(nodes[name][1].url, "flush", "POST", "/flush")
            check(st == 204, f"phase 14 /flush {name}: HTTP {st}")
        res["flush_ms"] = (time.perf_counter() - t0) * 1e3
        res["launches"]["flush"] = launches_since(l0)
        t0 = time.perf_counter()
        oracle.sweep_all(immediate=True)
        res["stage_s"]["oracle flush"] = time.perf_counter() - t0
        # the compactor role's own 30-s cycle shares the window widened
        # below: stopped, it cannot merge the same blocks beside the
        # explicit compact_once (both then mark the inputs compacted)
        comp.compactor.stop()
        for db, n_blocks in ((comp.db, 3), (oracle.db, 2)):
            db.poll_now()
            metas = db.blocklist.metas(tenant)
            check(len(metas) == n_blocks and (n_blocks == 2 or sum(
                m.total_spans for m in metas) == 2 * n_spans),
                  f"phase 14 flush: {len(metas)} blocks, {sum(m.total_spans for m in metas)} "
                  f"spans (RF 2 copies of {n_spans})")
            ccfg = db.cfg.compaction
            while len({m.end_time // ccfg.window_s for m in metas}) > 1:
                ccfg.window_s *= 2
        l0 = read_launches()
        t0 = time.perf_counter()
        jobs = comp.db.compact_once(tenant)
        res["compact_ms"] = (time.perf_counter() - t0) * 1e3
        res["launches"]["compact"] = launches_since(l0)
        t0 = time.perf_counter()
        check(oracle.db.compact_once(tenant) == jobs == 1, f"phase 14 compaction: {jobs} jobs")
        res["stage_s"]["oracle compaction"] = time.perf_counter() - t0
        for db in (comp.db, oracle.db, fe.db, qa.db):
            db.poll_now()
        (out_meta,) = comp.db.blocklist.metas(tenant)
        (oracle_meta,) = oracle.db.blocklist.metas(tenant)
        check(out_meta.total_spans == oracle_meta.total_spans == n_spans
              and out_meta.total_objects == oracle_meta.total_objects == len(traces),
              f"phase 14 compaction: {out_meta.total_spans} spans, {out_meta.total_objects} "
              f"traces; wanted each of {n_spans} spans once")
        print(f"phase 14 flush and compaction: the two survivors flushed in "
              f"{res['flush_ms']:.0f} ms (launches {res['launches']['flush']}); the compactor "
              f"merged the three blocks ({2 * n_spans} spans, every span twice) into one of "
              f"{out_meta.total_spans} spans, {out_meta.total_objects} traces in "
              f"{res['compact_ms']:.0f} ms (launches {res['launches']['compact']}), as the "
              f"oracle's", flush=True)

        # ----------------------------------------------- reads, blocks
        t_end = time.monotonic() + 120
        while True:
            try:
                if request(qb_url, "status", "GET", "/ready", timed=False)[0] == 200:
                    break
            except OSError:
                pass
            check(procs[0].poll() is None and time.monotonic() < t_end,
                  f"phase 14: querier-1 not up (exit {procs[0].poll()})")
            time.sleep(0.1)
        qb0 = querier_b_dispatches()
        t0 = time.perf_counter()
        l0 = read_launches()
        both = {}
        for rnd in range(8):
            blocks = reads("blocks", searches)
            for name, path in (("dependencies", "/api/graph/dependencies"),
                               ("critical-path", "/api/graph/critical-path?by=service")):
                p = f"{path}{'&' if '?' in path else '?'}" + urllib.parse.urlencode(
                    dict(start=window["start"], end=window["end"]))
                blocks[name] = same(name, p, _graph_norm)
            qb = querier_b_dispatches()
            both = {"querier-0 seg_bincount": read_launches()["seg_bincount"] - l0["seg_bincount"],
                    "querier-1 seg_bincount": qb.get("seg_bincount", 0)
                    - qb0.get("seg_bincount", 0)}
            if all(both.values()):
                break
        res["rounds"] = rnd + 1
        res["stage_s"]["reads blocks"] = time.perf_counter() - t0
        res["launches"]["queries"] = launches_since(l0)
        res["querier_b_dispatches"] = {k: v - qb0.get(k, 0) for k, v in qb.items()
                                       if v - qb0.get(k, 0)}
        check(all(both.values()), f"phase 14: seg_bincount on both queriers {both}")
        check(res["launches"]["queries"].get("root_path_sums", 0)
              + res["querier_b_dispatches"].get("graph_critical_path", 0) > 0,
              "phase 14: no critical path ran on the card")
        deps = blocks["dependencies"]
        print(f"phase 14 blocks: two tag searches, the three query_range, dependencies and a "
              f"critical path over the compacted block == the oracle's, {res['rounds']} "
              f"round(s) until both queriers ran a metrics job | querier-0 launches "
              f"{res['launches']['queries']}, querier-1 (/status/device) dispatches "
              f"{res['querier_b_dispatches']} | {len(deps.get('edges', []))} edges", flush=True)

        # ------------------------------------------------ remote write
        t0 = time.perf_counter()
        check(gen.remote_write_storage.collect_and_send(gen.generator) >= 1,
              "phase 14: the generator shipped nothing")
        res["remote_write_ms"] = (time.perf_counter() - t0) * 1e3
        got = sink.series()
        want = {(s.name, s.labels): s.value
                for s in oracle.generator.instance(tenant).registry.collect()}
        got = {k: v for k, v in got.items() if k[0] != sg.EXPIRED_TOTAL}
        want = {k: v for k, v in want.items() if k[0] != sg.EXPIRED_TOTAL}
        check(got == want and got, f"phase 14 remote write: {len(got)} series, the oracle "
              f"generator's {len(want)}")
        res["remote_write_series"] = len(got)
        print(f"phase 14 remote write: {len(sink.posts)} POST(s) to the sink, {len(got)} "
              f"series (snappy and prompb decoded here) == the oracle generator's "
              f"({res['remote_write_ms']:.0f} ms)", flush=True)

        # ------------------------------------------------------ vulture
        if shed:
            res["vulture"] = "shed"
        else:
            vcfg = cfg("vulture", "vulture-0")
            vcfg.vulture = VultureConfig(target=dist_srv.url, query_target=fe_srv.url)
            vapp = App(vcfg, device="cuda")
            try:
                v = vapp.vulture
                now = int(time.time())
                infos = [v.write_once(now - 30 + i) for i in range(3)]
                ok = [v.check_by_id(now, tier="fresh", info=i) for i in infos]
                ok += [v.check_search(now, tier="fresh", info=i) for i in infos]
                ok.append(v.check_traceql(now, tier="fresh", info=infos[-1]))
                check(all(ok) and not v.error_counts,
                      f"phase 14 vulture: {ok}, errors {dict(v.error_counts)}")
                res["vulture"] = {"probes": len(infos), "checks": len(ok), "errors": 0}
            finally:
                vapp.shutdown()
        print(f"phase 14 vulture sidecar (HTTPClient, target=vulture): {res['vulture']}",
              flush=True)
    finally:
        t_down = time.perf_counter()
        # the frontend first (its queriers' long-polls end at once), the
        # distributor last (it serves the ring KV the others leave)
        for name in ("frontend-0", "querier-0"):
            if name in nodes:
                stop(name)
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for name in sorted(nodes, key=lambda n: n.startswith("distributor")):
            stop(name)
        if qb_log is not None:
            qb_log.close()
        if procs:
            res["querier_b_exit"] = procs[0].returncode
        if oracle_srv is not None:
            oracle_srv.stop()
        if oracle is not None:
            oracle.shutdown()
        sink.close()
        for conn in conns.values():
            conn.close()
        res["stage_s"]["teardown"] = time.perf_counter() - t_down
    check(res.get("querier_b_exit") == 0, f"phase 14: querier-1 exited {res.get('querier_b_exit')}")
    res["ms"] = {k: dict(p50=statistics.median(v), max=max(v), n=len(v))
                 for k, v in res.pop("requests").items()}
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# phase 15: the other receivers and the ingest tees
# ---------------------------------------------------------------------------

# past this many seconds of phases 0-14, phase 15 sheds its forwarder and
# self-tracing checks (never a receiver)
SHED15_S = 1060
RX_TENANT, FWD_TENANT = "rx", "fwd"
# the keys of a usage report (tempo_tpu/usagestats.py Reporter.build_report)
USAGE_REPORT_KEYS = ("clusterID", "createdAt", "interval", "target", "version", "os",
                     "metrics", "timestamp")
_KIND_NAME = {2: "server", 3: "client", 4: "producer", 5: "consumer"}


def _u64(b: bytes) -> int:
    return int.from_bytes(b.rjust(8, b"\x00")[-8:], "big")


def _i64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def _tag_str(v) -> str:
    return v.hex() if isinstance(v, bytes) else str(v)


def _resource_groups(traces) -> list:
    """(resource, spans) of a unit's traces, one group a distinct resource
    in first-seen order: the unit a Jaeger Batch or an OpenCensus request
    carries (each holds one process or node)."""
    groups: dict = {}
    for t in traces:
        for res, spans in t.batches:
            key = json.dumps(res, sort_keys=True, default=str)
            groups.setdefault(key, (res, []))[1].extend(spans)
    return list(groups.values())


def zipkin_v2_json(traces) -> bytes:
    """POST /api/v2/spans body: Zipkin v2 JSON (times in microseconds,
    tags as strings, the resource's service as localEndpoint)."""
    kinds = {2: "SERVER", 3: "CLIENT", 4: "PRODUCER", 5: "CONSUMER"}
    out = []
    for t in traces:
        for res, spans in t.batches:
            for s in spans:
                z = {"traceId": s.trace_id.hex(), "id": s.span_id.hex(), "name": s.name,
                     "timestamp": s.start_unix_nano // 1000,
                     "duration": s.duration_nano // 1000,
                     "localEndpoint": {"serviceName": str(res.get("service.name", ""))}}
                if any(s.parent_span_id):
                    z["parentId"] = s.parent_span_id.hex()
                if s.kind in kinds:
                    z["kind"] = kinds[s.kind]
                tags = {k: _tag_str(v) for k, v in s.attributes.items()}
                if s.status_code == 2:
                    tags["error"] = "true"
                if tags:
                    z["tags"] = tags
                out.append(z)
    return json.dumps(out).encode()


class ThriftOut:
    """The Thrift binary protocol's writers that the carriers need."""

    def __init__(self):
        self.b = bytearray()

    def field(self, ttype: int, fid: int) -> None:
        self.b += bytes([ttype]) + fid.to_bytes(2, "big", signed=True)

    def i32(self, fid: int, v: int) -> None:
        self.field(8, fid)
        self.b += v.to_bytes(4, "big", signed=True)

    def i64(self, fid: int, v: int) -> None:
        self.field(10, fid)
        self.b += _i64(v & (2**64 - 1)).to_bytes(8, "big", signed=True)

    def double(self, fid: int, v: float) -> None:
        self.field(4, fid)
        self.b += struct.pack(">d", v)

    def boolean(self, fid: int, v: bool) -> None:
        self.field(2, fid)
        self.b.append(1 if v else 0)

    def binary(self, fid: int, v) -> None:
        raw = v.encode() if isinstance(v, str) else bytes(v)
        self.field(11, fid)
        self.b += len(raw).to_bytes(4, "big") + raw

    def list_begin(self, fid: int, etype: int, n: int) -> None:
        self.field(15, fid)
        self.b += bytes([etype]) + n.to_bytes(4, "big")

    def struct_begin(self, fid: int) -> None:
        self.field(12, fid)

    def stop(self) -> None:
        self.b.append(0)


def _zipkin_endpoint(w: ThriftOut, fid: int, service: str) -> None:
    w.struct_begin(fid)
    w.i32(1, 0x7F000001)
    w.field(6, 2)
    w.b += (0).to_bytes(2, "big")
    w.binary(3, service)
    w.stop()


def zipkin_v1_thrift(traces) -> bytes:
    """POST /api/v1/spans body (application/x-thrift): a Thrift-binary
    list of zipkincore Spans. A client span carries cs/cr annotations, a
    server span sr/ss, both on the service's endpoint; tags are STRING
    binary annotations on the same endpoint (a span with neither gets an
    `lc` annotation naming its service)."""
    w = ThriftOut()
    spans = [(str(res.get("service.name", "")), s) for t in traces for res, ss in t.batches
             for s in ss]
    w.b += bytes([12]) + len(spans).to_bytes(4, "big")
    for svc, s in spans:
        start_us, dur_us = s.start_unix_nano // 1000, s.duration_nano // 1000
        w.i64(1, _u64(s.trace_id[8:]))
        w.binary(3, s.name)
        w.i64(4, _u64(s.span_id))
        if any(s.parent_span_id):
            w.i64(5, _u64(s.parent_span_id))
        annos = {3: ("cs", "cr"), 2: ("sr", "ss")}.get(s.kind, ())
        if annos:
            w.list_begin(6, 12, 2)
            for ts, value in zip((start_us, start_us + dur_us), annos):
                w.i64(1, ts)
                w.binary(2, value)
                _zipkin_endpoint(w, 3, svc)
                w.stop()
        tags = {k: _tag_str(v) for k, v in s.attributes.items()}
        if s.status_code == 2:
            tags["error"] = "true"
        if not tags and not annos:
            tags = {"lc": svc}
        if tags:
            w.list_begin(8, 12, len(tags))
            for k, v in tags.items():
                w.binary(1, k)
                w.binary(2, v)
                w.i32(3, 6)  # STRING
                _zipkin_endpoint(w, 4, svc)
                w.stop()
        w.i64(10, start_us)
        w.i64(11, dur_us)
        w.i64(12, _u64(s.trace_id[:8]))
        w.stop()
    return bytes(w.b)


def _jaeger_tag(w: ThriftOut, key: str, v) -> None:
    """jaeger.thrift Tag {1 key, 2 vType, 3 vStr | 4 vDouble | 5 vBool |
    6 vLong | 7 vBinary}."""
    w.binary(1, key)
    if isinstance(v, bool):
        w.i32(2, 2)
        w.boolean(5, v)
    elif isinstance(v, int) and -(1 << 63) <= v < 1 << 63:
        w.i32(2, 3)
        w.i64(6, v)
    elif isinstance(v, float):
        w.i32(2, 1)
        w.double(4, v)
    elif isinstance(v, bytes):
        w.i32(2, 4)
        w.binary(7, v)
    else:
        w.i32(2, 0)
        w.binary(3, str(v))
    w.stop()


def _span_tags(s) -> dict:
    """A span's attributes plus the tags that carry its kind and error
    status in Jaeger's models."""
    tags = dict(s.attributes)
    if s.kind in _KIND_NAME:
        tags["span.kind"] = _KIND_NAME[s.kind]
    if s.status_code == 2:
        tags["error"] = True
    return tags


def jaeger_thrift_batch(res: dict, spans) -> bytes:
    """A jaeger.thrift Batch in the binary protocol: the POST /api/traces
    body, and the argument of the binary agent's emitBatch."""
    w = ThriftOut()
    w.struct_begin(1)  # Process
    w.binary(1, str(res.get("service.name", "")))
    ptags = {k: v for k, v in res.items() if k != "service.name"}
    if ptags:
        w.list_begin(2, 12, len(ptags))
        for k, v in ptags.items():
            _jaeger_tag(w, k, v)
    w.stop()
    w.list_begin(2, 12, len(spans))
    for s in spans:
        w.i64(1, _u64(s.trace_id[8:]))
        w.i64(2, _u64(s.trace_id[:8]))
        w.i64(3, _u64(s.span_id))
        w.i64(4, _u64(s.parent_span_id or b""))
        w.binary(5, s.name)
        w.i32(7, 1)  # flags: sampled
        w.i64(8, s.start_unix_nano // 1000)
        w.i64(9, s.duration_nano // 1000)
        tags = _span_tags(s)
        if tags:
            w.list_begin(10, 12, len(tags))
            for k, v in tags.items():
                _jaeger_tag(w, k, v)
        w.stop()
    w.stop()
    return bytes(w.b)


def jaeger_agent_binary(res: dict, spans, seqid: int = 0) -> bytes:
    """One binary-protocol Agent.emitBatch datagram (a jaeger client's
    packet to the agent's port 6832): the strict message header, then
    the args struct {1: Batch}."""
    name = b"emitBatch"
    return ((0x80010004).to_bytes(4, "big") + len(name).to_bytes(4, "big") + name
            + seqid.to_bytes(4, "big", signed=True) + bytes([12, 0, 1])
            + jaeger_thrift_batch(res, spans) + b"\x00")


def jaeger_post_spans(res: dict, spans) -> bytes:
    """jaeger.api_v2 PostSpansRequest {1: Batch {1: Process, 2: Span*}}
    (model.proto), the body of CollectorService/PostSpans."""
    from tempo_tpu_torch.receivers import protowire as pw

    def kv(key, v) -> bytes:
        out = bytearray()
        pw.put_str_field(out, 1, key)
        if isinstance(v, bool):
            pw.put_varint_field(out, 2, 1)
            pw.put_varint_field(out, 4, int(v))
        elif isinstance(v, int) and -(1 << 63) <= v < 1 << 63:
            pw.put_varint_field(out, 2, 2)
            pw.put_varint_field(out, 5, v & (2**64 - 1))
        elif isinstance(v, float):
            pw.put_varint_field(out, 2, 3)
            pw.put_double_field(out, 6, v)
        elif isinstance(v, bytes):
            pw.put_varint_field(out, 2, 4)
            pw.put_bytes_field(out, 7, v)
        else:
            pw.put_str_field(out, 3, str(v))
        return bytes(out)

    def ts(ns: int) -> bytes:
        out = bytearray()
        pw.put_varint_field(out, 1, ns // 10**9)
        pw.put_varint_field(out, 2, ns % 10**9)
        return bytes(out)

    process = bytearray()
    pw.put_str_field(process, 1, str(res.get("service.name", "")))
    for k, v in res.items():
        if k != "service.name":
            pw.put_bytes_field(process, 2, kv(k, v))
    batch = bytearray()
    pw.put_bytes_field(batch, 1, bytes(process))
    for s in spans:
        sp = bytearray()
        pw.put_bytes_field(sp, 1, s.trace_id)
        pw.put_bytes_field(sp, 2, s.span_id)
        pw.put_str_field(sp, 3, s.name)
        if any(s.parent_span_id or b""):
            ref = bytearray()
            pw.put_bytes_field(ref, 1, s.trace_id)
            pw.put_bytes_field(ref, 2, s.parent_span_id)
            pw.put_bytes_field(sp, 4, bytes(ref))  # ref_type CHILD_OF (0) omitted
        pw.put_bytes_field(sp, 6, ts(s.start_unix_nano))
        pw.put_bytes_field(sp, 7, ts(s.duration_nano))
        for k, v in _span_tags(s).items():
            pw.put_bytes_field(sp, 8, kv(k, v))
        pw.put_bytes_field(batch, 2, bytes(sp))
    req = bytearray()
    pw.put_bytes_field(req, 1, bytes(batch))
    return bytes(req)


def opencensus_export(res: dict, spans) -> bytes:
    """opencensus.proto.agent.trace.v1 ExportTraceServiceRequest {1 node,
    2 spans, 3 resource}: the node names the service, the resource's other
    attributes ride as string labels; a server span is kind 1, a client
    span 2; an error span carries status code 2."""
    from tempo_tpu_torch.receivers import protowire as pw

    def sub(build) -> bytes:
        out = bytearray()
        build(out)
        return bytes(out)

    def truncatable(v: str) -> bytes:
        return sub(lambda o: pw.put_str_field(o, 1, v))

    def ts(ns: int) -> bytes:
        return sub(lambda o: (pw.put_varint_field(o, 1, ns // 10**9),
                                 pw.put_varint_field(o, 2, ns % 10**9)))

    def attr_value(v) -> bytes:
        out = bytearray()
        if isinstance(v, bool):
            pw.put_varint_field(out, 3, int(v))
        elif isinstance(v, int) and -(1 << 63) <= v < 1 << 63:
            pw.put_varint_field(out, 2, v & (2**64 - 1))
        elif isinstance(v, float):
            pw.put_double_field(out, 4, v)
        else:
            pw.put_bytes_field(out, 1, truncatable(_tag_str(v)))
        return bytes(out)

    req = bytearray()
    svc_info = sub(lambda o: pw.put_str_field(o, 1, str(res.get("service.name", ""))))
    pw.put_bytes_field(req, 1, sub(lambda o: pw.put_bytes_field(o, 3, svc_info)))
    for s in spans:
        sp = bytearray()
        pw.put_bytes_field(sp, 1, s.trace_id)
        pw.put_bytes_field(sp, 2, s.span_id)
        if any(s.parent_span_id or b""):
            pw.put_bytes_field(sp, 3, s.parent_span_id)
        pw.put_bytes_field(sp, 4, truncatable(s.name))
        pw.put_bytes_field(sp, 5, ts(s.start_unix_nano))
        pw.put_bytes_field(sp, 6, ts(s.start_unix_nano + s.duration_nano))
        if s.attributes:
            amap = bytearray()
            for k, v in s.attributes.items():
                entry = bytearray()
                pw.put_str_field(entry, 1, k)
                pw.put_bytes_field(entry, 2, attr_value(v))
                pw.put_bytes_field(amap, 1, bytes(entry))
            pw.put_bytes_field(sp, 7, bytes(amap))
        if s.status_code == 2:
            pw.put_bytes_field(sp, 11, sub(lambda o: pw.put_varint_field(o, 1, 2)))
        if s.kind in (2, 3):
            pw.put_varint_field(sp, 14, 1 if s.kind == 2 else 2)
        pw.put_bytes_field(req, 2, bytes(sp))
    labels = {k: v for k, v in res.items() if k != "service.name"}
    if labels:
        resource = bytearray()
        for k, v in labels.items():
            entry = bytearray()
            pw.put_str_field(entry, 1, k)
            pw.put_str_field(entry, 2, _tag_str(v))
            pw.put_bytes_field(resource, 2, bytes(entry))
        pw.put_bytes_field(req, 3, bytes(resource))
    return bytes(req)


class ScriptedBroker:
    """A one-broker Kafka cluster in the script's own lines, speaking what
    the port's KafkaReceiver asks without a consumer group: Metadata v1,
    ListOffsets v1 and Fetch v4 over partition 0 of one topic. produce()
    appends one magic-2 record batch (the port's encoder); a fetch with
    nothing past its offset waits up to the request's max_wait_ms, as a
    broker does, instead of answering at once."""

    def __init__(self, topic: str = "traces"):
        import socket
        import threading

        self.topic = topic
        self.batches: list = []  # (base offset, records, batch bytes)
        self.next_offset = 0
        self.fetches = 0
        self.closed = False
        self.cond = threading.Condition()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self._conns: list = []
        threading.Thread(target=self._accept, daemon=True).start()

    def produce(self, values: list, codec: int = 0) -> None:
        from tempo_tpu_torch.receivers import kafka

        with self.cond:
            raw = kafka.encode_record_batch(self.next_offset, values, codec=codec)
            self.batches.append((self.next_offset, len(values), raw))
            self.next_offset += len(values)
            self.cond.notify_all()

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()
        self.sock.close()
        for c in self._conns:
            c.close()

    def _accept(self) -> None:
        import threading

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    @staticmethod
    def _str(s) -> bytes:
        if s is None:
            return (-1).to_bytes(2, "big", signed=True)
        raw = s.encode()
        return len(raw).to_bytes(2, "big") + raw

    def _serve(self, conn) -> None:
        def read(n: int):
            buf = bytearray()
            while len(buf) < n:
                chunk = conn.recv(n - len(buf))
                if not chunk:
                    return None
                buf += chunk
            return bytes(buf)

        try:
            while True:
                head = read(4)
                msg = None if head is None else read(struct.unpack(">i", head)[0])
                if msg is None:
                    return
                api, _ver, corr, n = struct.unpack_from(">hhih", msg, 0)
                body = msg[10 + max(n, 0):]
                if api == 3:
                    out = self._metadata()
                elif api == 2:
                    out = self._list_offsets()
                elif api == 1:
                    out = self._fetch(body)
                else:
                    return
                resp = struct.pack(">i", corr) + out
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        except OSError:
            return

    def _metadata(self) -> bytes:
        host, port = self.addr.rsplit(":", 1)
        return (struct.pack(">ii", 1, 0) + self._str(host) + struct.pack(">i", int(port))
                + self._str(None) + struct.pack(">ii", 0, 1) + struct.pack(">h", 0)
                + self._str(self.topic) + b"\x00"
                + struct.pack(">ihiiiiii", 1, 0, 0, 0, 1, 0, 1, 0))

    def _list_offsets(self) -> bytes:
        earliest = self.batches[0][0] if self.batches else self.next_offset
        return (struct.pack(">i", 1) + self._str(self.topic)
                + struct.pack(">iihqq", 1, 0, 0, -1, earliest))

    def _fetch(self, body: bytes) -> bytes:
        _replica, max_wait_ms = struct.unpack_from(">ii", body, 0)
        pos = 17
        (n_topics,) = struct.unpack_from(">i", body, pos)
        (n,) = struct.unpack_from(">h", body, pos + 4)
        pos += 6 + n
        _n_parts, part, offset, max_bytes = struct.unpack_from(">iiqi", body, pos)
        deadline = time.monotonic() + max_wait_ms / 1e3
        with self.cond:
            self.fetches += 1
            while self.next_offset <= offset and not self.closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self.cond.wait(left)
            data = bytearray()
            for base, count, raw in self.batches:
                if base + count > offset and (not data or len(data) + len(raw) <= max_bytes):
                    data += raw
            hw = self.next_offset
        return (struct.pack(">ii", 0, n_topics) + self._str(self.topic)
                + struct.pack(">iihqqi", 1, part, 0, hw, hw, 0)
                + struct.pack(">i", len(data)) + bytes(data))


class UsageSink:
    """A loopback stats sink recording each POST (path, JSON body)."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sink = self
        self.posts: list = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                sink.posts.append((self.path, json.loads(body)))
                self.send_response(204)
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# the carriers, in the order phase 15 feeds them; each unit of 512 spans
# goes to one, round robin
HTTP_CARRIERS = ("zipkin-v2-json", "zipkin-v1-thrift", "jaeger-thrift-http")
UDP_CARRIERS = ("jaeger-agent-compact", "jaeger-agent-binary")
KAFKA_CARRIERS = ("kafka-none", "kafka-gzip", "kafka-snappy", "kafka-zstd")
GRPC_CARRIERS = ("grpc-otlp", "grpc-jaeger", "grpc-opencensus")
MAX_DATAGRAM = 65_000


def _split_datagrams(encode, res: dict, spans: list) -> list:
    """One datagram a resource group, halved until each fits the Jaeger
    client's 65,000-byte limit."""
    buf = encode(res, spans)
    if len(buf) <= MAX_DATAGRAM or len(spans) == 1:
        return [buf]
    half = len(spans) // 2
    return _split_datagrams(encode, res, spans[:half]) + _split_datagrams(encode, res, spans[half:])


def carrier_messages(carrier: str, traces: list) -> list:
    """The messages that carry one unit of traces on `carrier`: (transport,
    target, content type or codec, payload). A Jaeger Batch and an
    OpenCensus request hold one process each, so those carriers send one
    message a resource group (an OpenCensus unit as one stream)."""
    from tempo_tpu_torch import receivers
    from tempo_tpu_torch.receivers import grpc_server, jaeger, kafka, otlp

    thrift = "application/x-thrift"
    if carrier == "zipkin-v2-json":
        return [("http", receivers.ZIPKIN_PATH, "application/json", zipkin_v2_json(traces))]
    if carrier == "zipkin-v1-thrift":
        return [("http", receivers.ZIPKIN_V1_PATH, thrift, zipkin_v1_thrift(traces))]
    groups = _resource_groups(traces)
    if carrier == "jaeger-thrift-http":
        return [("http", receivers.JAEGER_THRIFT_PATH, thrift, jaeger_thrift_batch(res, spans))
                for res, spans in groups]
    if carrier in UDP_CARRIERS:
        if carrier == "jaeger-agent-compact":
            def encode(res, spans):
                ptags = {k: v for k, v in res.items() if k != "service.name"}
                return jaeger.encode_agent_batch_compact(str(res.get("service.name", "")),
                                                         spans, process_tags=ptags)
        else:
            encode = jaeger_agent_binary
        return [("udp", carrier, None, d) for res, spans in groups
                for d in _split_datagrams(encode, res, spans)]
    if carrier in KAFKA_CARRIERS:
        codec = {"kafka-none": kafka.CODEC_NONE, "kafka-gzip": kafka.CODEC_GZIP,
                 "kafka-snappy": kafka.CODEC_SNAPPY, "kafka-zstd": kafka.CODEC_ZSTD}[carrier]
        return [("kafka", carrier, codec, otlp.encode_traces_request(traces))]
    if carrier == "grpc-otlp":
        return [("grpc", grpc_server.OTLP_EXPORT_METHOD, None, otlp.encode_traces_request(traces))]
    if carrier == "grpc-jaeger":
        return [("grpc", grpc_server.JAEGER_POST_SPANS_METHOD, None, jaeger_post_spans(res, spans))
                for res, spans in groups]
    if carrier == "grpc-opencensus":
        return [("grpc-stream", grpc_server.OPENCENSUS_EXPORT_METHOD, None,
                 [opencensus_export(res, spans) for res, spans in groups])]
    raise SmokeFailure(f"no carrier {carrier!r}")


def decode_message(msg) -> list:
    """The traces a receiver pushes for one message, by the port's
    decoders (an OpenCensus stream: one push a message, concatenated)."""
    from tempo_tpu_torch import receivers
    from tempo_tpu_torch.receivers import grpc_server, jaeger, opencensus, otlp

    transport, target, ctype, payload = msg
    if transport == "http":
        return [receivers.decode_http(target, ctype, payload)]
    if transport == "udp":
        return [jaeger.decode_agent_datagram(payload)]
    if transport == "kafka" or target == grpc_server.OTLP_EXPORT_METHOD:
        return [otlp.decode_traces_request(payload)]
    if target == grpc_server.JAEGER_POST_SPANS_METHOD:
        return [grpc_server.decode_post_spans_request(payload)]
    return [opencensus.decode_export_request(p) for p in payload]


def _norm_trace(raw_otlp: bytes) -> list:
    """A trace's spans as sorted (resource, scope, span) JSON records."""
    from tempo_tpu_torch.receivers import otlp

    out = []
    for rs in otlp.encode_traces_json(otlp.decode_traces_request(raw_otlp))["resourceSpans"]:
        res_ = json.dumps(rs.get("resource", {}), sort_keys=True)
        for ss in rs.get("scopeSpans", []):
            scope = json.dumps(ss.get("scope", {}), sort_keys=True)
            out += [(res_, scope, json.dumps(sp, sort_keys=True)) for sp in ss.get("spans", [])]
    return sorted(out)


def _generator_series(app, tenant: str) -> dict:
    """A tenant's generator series, the expiry and eviction counter aside
    (its split depends on the wall clock between pushes)."""
    from tempo_tpu_torch.modules.generator import servicegraphs as sg

    return {(s.name, s.labels): s.value for s in app.generator.instance(tenant).registry.collect()
            if s.name != sg.EXPIRED_TOTAL}


def receivers_phase(seed: int, root: str, queries: list, shed: bool = False) -> dict:
    """Phase 15, the other receivers and the ingest tees on the card. One
    App(device="cuda") with target all and multitenancy, behind a TempoServer,
    with the Jaeger agent on a compact and a binary UDP port, a Kafka
    receiver against ScriptedBroker, the gRPC server where grpcio is
    installed (else the same payloads through the port's gRPC decoders and
    App.push_traces), a forwarder for tenant `fwd` to a second App's
    /v1/traces, usage_report to UsageSink and self_tracing on (`shed`
    drops the forwarder, its App and self-tracing). 16 make_graph_batch
    batches of 512 traces x 8 spans (2**16 spans of phase 11's stream,
    stamped in the last hour) go as 512-span units,
    round robin over the carriers, one after another (tenant `fwd` on
    the second unit of every four of an HTTP or gRPC carrier, `rx` on the rest); a
    target=all App on the CPU takes the same messages through the same
    decoders in the same order. Then /flush; 250 present and 250 absent
    finds, a tag search, phase 4's three query_range over the flushed
    blocks and the generator's series, each equal to the CPU App's; the
    forwarded traces found whole on the second App; one usage report with
    the reference's keys under the cluster seed; a `_self_` search for
    distributor/push. Returns its numbers."""
    import http.client
    import importlib.util
    import socket
    import threading

    import numpy as np

    from tempo_tpu_torch import native, usagestats
    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.trace import batch_to_traces
    from tempo_tpu_torch.modules.forwarder import ForwarderConfig
    from tempo_tpu_torch.modules.frontend import FrontendConfig
    from tempo_tpu_torch.modules.ingester import IngesterConfig
    from tempo_tpu_torch.modules.overrides import Limits
    from tempo_tpu_torch.receivers import otlp
    from tempo_tpu_torch.receivers.kafka import KafkaReceiver
    from tempo_tpu_torch.receivers.udp import UDPAgentServer
    from tempo_tpu_torch.usagestats import UsageStatsConfig
    from tempo_tpu_torch.util import tracing

    t_phase = time.perf_counter()
    grpc_transport = "grpcio" if importlib.util.find_spec("grpc") is not None else "absent"
    carriers = list(HTTP_CARRIERS + UDP_CARRIERS + KAFKA_CARRIERS + GRPC_CARRIERS)
    if native.lib() is None:
        carriers.remove("kafka-zstd")  # a zstd batch needs the native library, as in the reference
    res: dict = {"grpc_transport": grpc_transport, "carriers": {}, "requests": {},
                 "stage_s": {}, "shed": shed}
    print(f"phase 15 receivers: grpc_transport {grpc_transport}, {len(carriers)} carriers "
          f"({', '.join(carriers)})", flush=True)

    # ------------------------------------------------------------- data
    t0 = time.perf_counter()
    now_min = int(time.time()) // 60 * 60
    t_data = now_min - 40 * 60
    units, by_id = [], {}
    for i in range(16):
        traces = batch_to_traces(synth.make_graph_batch(
            512, 8, seed=seed * 1000 + 1500 + i,
            base_time_ns=(t_data + 60 * (i // 2)) * 10**9, error_rate=0.1))
        units += [traces[j:j + 64] for j in range(0, len(traces), 64)]
    plan = []  # (carrier, tenant, messages, spans)
    seen: dict = {}
    for u, traces in enumerate(units):
        carrier = carriers[u % len(carriers)]
        k = seen[carrier] = seen.get(carrier, -1) + 1
        tenant = FWD_TENANT if (carrier in HTTP_CARRIERS + GRPC_CARRIERS and k % 4 == 1) \
            else RX_TENANT
        for t in traces:
            by_id[t.trace_id] = (tenant, t)
        plan.append((carrier, tenant, carrier_messages(carrier, traces),
                     sum(t.span_count() for t in traces)))
    plan.sort(key=lambda p: carriers.index(p[0]))  # carrier by carrier, units in order
    n_spans = sum(p[3] for p in plan)
    res["stage_s"]["data and encode"] = time.perf_counter() - t0
    res["spans"] = n_spans
    print(f"phase 15 data: {n_spans} spans ({len(by_id)} make_graph_batch traces) in "
          f"{len(plan)} units of 512 spans, {sum(len(p[2]) for p in plan)} messages, encoded in "
          f"{res['stage_s']['data and encode']:.1f} s", flush=True)

    limits = Limits(max_traces_per_user=1 << 16, ingestion_rate_limit_bytes=1 << 40,
                    ingestion_burst_size_bytes=1 << 40)

    def cfg(name: str, **kw) -> AppConfig:
        sub = os.path.join(root, name)
        return AppConfig(
            multitenancy_enabled=True, query_workers=2,
            db=DBConfig(backend="local", backend_path=os.path.join(sub, "blocks"),
                        wal_path=os.path.join(sub, "wal"), blocklist_poll_s=3600.0,
                        analytics_scan_s=0),
            ingester=IngesterConfig(max_trace_idle_s=3600.0, flush_check_period_s=3600.0),
            frontend=FrontendConfig(hedge_after_s=0), limits=limits, **kw)

    conns: dict = {}

    def request(url, kind, method, path, body=None, headers=None, timed=True):
        key = (url, threading.get_ident())
        conn = conns.get(key)
        if conn is None:
            host, port = url.rsplit("/", 1)[-1].split(":")
            conn = conns[key] = http.client.HTTPConnection(host, int(port), timeout=600)
        t0 = time.perf_counter()
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            out = r.read()
        except OSError:
            conns.pop(key).close()
            raise
        if timed:
            res["requests"].setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        return r.status, out

    apps: list = []
    servers: list = []
    receivers_up: list = []
    broker = ScriptedBroker()
    sink = UsageSink()
    second = second_srv = channel = None
    try:
        # ------------------------------------------------------ the Apps
        t0 = time.perf_counter()
        extra = {}
        if not shed:
            second = App(cfg("forward-target"), device="cuda")
            apps.append(second)
            second_srv = TempoServer(second, host="127.0.0.1", port=0).start()
            servers.append(second_srv)
            overrides = os.path.join(root, "overrides.yaml")
            with open(overrides, "w") as f:
                f.write(f"overrides:\n  {FWD_TENANT}:\n    forwarders: [card-b]\n"
                        f"    max_traces_per_user: {1 << 16}\n"
                        f"    ingestion_rate_limit_bytes: {1 << 40}\n"
                        f"    ingestion_burst_size_bytes: {1 << 40}\n")
            extra = dict(forwarders=[ForwarderConfig(name="card-b", endpoint=second_srv.url)],
                         overrides_path=overrides,
                         # one trace in ten: every request of the phase traces
                         # itself, and a find's spans would triple its cost
                         self_tracing=tracing.SelfTracingConfig(enabled=True,
                                                                sample_ratio=0.1))
        app = App(cfg("card", usage_stats=UsageStatsConfig(
            enabled=True, endpoint=sink.url, report_interval_s=3600.0), **extra), device="cuda")
        apps.append(app)
        srv = TempoServer(app, host="127.0.0.1", port=0).start()
        servers.append(srv)
        app.start_loops()
        oracle = App(cfg("cpu"), device="cpu")
        apps.append(oracle)
        oracle_srv = TempoServer(oracle, host="127.0.0.1", port=0).start()
        servers.append(oracle_srv)
        check(app.device.type == "cuda" and (second is None or second.device.type == "cuda"),
              f"phase 15: Apps on {app.device} and {None if second is None else second.device}")
        check(app.can_push_spans() == shed, "phase 15: a forwarder must force the object path")
        udp = UDPAgentServer(app.push_traces, host="127.0.0.1", compact_port=0, binary_port=0,
                             org_id=RX_TENANT).start()
        receivers_up.append(udp)
        kafka_rx = KafkaReceiver(app.push_traces, [broker.addr], broker.topic,
                                 org_id=RX_TENANT).start()
        receivers_up.append(kafka_rx)
        grpc_mod = None
        if grpc_transport == "grpcio":
            import grpc as grpc_mod

            from tempo_tpu_torch.receivers.grpc_server import TraceGrpcServer

            grpc_srv = TraceGrpcServer(app.push_traces, host="127.0.0.1", port=0).start()
            receivers_up.append(grpc_srv)
            channel = grpc_mod.insecure_channel(f"127.0.0.1:{grpc_srv.port}")
        res["start_s"] = time.perf_counter() - t0
        print(f"phase 15 up: the App on {app.device} (HTTP {srv.url}, Jaeger agent UDP compact "
              f":{udp.compact_port} binary :{udp.binary_port}, Kafka {broker.addr}"
              + (f", gRPC :{grpc_srv.port}" if channel is not None else "")
              + ("" if shed else f"; forwarder to {second_srv.url}, self_tracing on")
              + f"; usage_report to {sink.url}), the CPU App, in {res['start_s']:.1f} s",
              flush=True)

        # ------------------------------------------------------- the feed
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        udp_ports = {"jaeger-agent-compact": udp.compact_port,
                     "jaeger-agent-binary": udp.binary_port}

        def wait_for(cond, what: str, timeout_s: float = 60.0) -> None:
            t_end = time.monotonic() + timeout_s
            while not cond():
                check(time.monotonic() < t_end, f"phase 15: timed out waiting for {what}")
                time.sleep(0.0005)

        def send_card(carrier: str, tenant: str, msg) -> None:
            transport, target, ctype, payload = msg
            if transport == "http":
                status, body = request(srv.url, carrier, "POST", target, payload,
                                       {"Content-Type": ctype, "X-Scope-OrgID": tenant})
                check(status == 202, f"phase 15 {carrier}: HTTP {status} {body[:200]!r}")
            elif transport == "udp":
                # one datagram in flight: loopback drops a burst past the
                # socket's buffer, so each waits for the receiver's count
                t0 = time.perf_counter()
                n0 = udp.batches + udp.errors
                sock.sendto(payload, ("127.0.0.1", udp_ports[target]))
                wait_for(lambda: udp.batches + udp.errors > n0, f"{carrier} datagram")
                res["requests"].setdefault(carrier, []).append((time.perf_counter() - t0) * 1e3)
            elif channel is not None:
                md = (("x-scope-orgid", tenant),)
                t0 = time.perf_counter()
                if transport == "grpc":
                    channel.unary_unary(target)(payload, metadata=md, timeout=120)
                else:
                    replies = list(channel.stream_stream(target)(iter(payload), metadata=md,
                                                                 timeout=120))
                    check(len(replies) == len(payload), f"phase 15 {carrier}: {len(replies)} "
                          f"replies to {len(payload)} messages")
                res["requests"].setdefault(carrier, []).append((time.perf_counter() - t0) * 1e3)
            else:
                # no grpcio: the server's own decoders, then its push
                t0 = time.perf_counter()
                for traces in decode_message(msg):
                    if traces:
                        app.push_traces(traces, org_id=tenant)
                res["requests"].setdefault(carrier, []).append((time.perf_counter() - t0) * 1e3)

        for carrier in carriers:
            mine = [p for p in plan if p[0] == carrier]
            spans = sum(p[3] for p in mine)
            t0 = time.perf_counter()
            if carrier in KAFKA_CARRIERS:
                want = kafka_rx.records + len(mine)
                for _, _, msgs, _ in mine:
                    ((_, _, codec, payload),) = msgs
                    broker.produce([payload], codec=codec)
                wait_for(lambda: kafka_rx.records >= want, f"{carrier} records", 120.0)
                check(kafka_rx.errors == 0, f"phase 15 {carrier}: {kafka_rx.errors} errors")
            else:
                for _, tenant, msgs, _ in mine:
                    for msg in msgs:
                        send_card(carrier, tenant, msg)
            secs = time.perf_counter() - t0
            check(udp.errors == 0, f"phase 15 {carrier}: {udp.errors} datagrams rejected")
            t0 = time.perf_counter()
            for _, tenant, msgs, _ in mine:
                for msg in msgs:
                    for traces in decode_message(msg):
                        if traces:
                            oracle.push_traces(traces, org_id=tenant)
            res["carriers"][carrier] = dict(units=len(mine), messages=sum(len(p[2]) for p in mine),
                                            spans=spans, s=secs, spans_per_s=spans / secs,
                                            cpu_s=time.perf_counter() - t0)
            print(f"phase 15 {carrier}: {spans} spans in {len(mine)} units, "
                  f"{res['carriers'][carrier]['messages']} messages -> {spans / secs:.0f} spans/s "
                  f"on the card App ({secs:.2f} s; the CPU App's decode and push "
                  f"{res['carriers'][carrier]['cpu_s']:.2f} s)", flush=True)
        sock.close()
        check(udp.spans == sum(p[3] for p in plan if p[0] in UDP_CARRIERS),
              f"phase 15: the agent counted {udp.spans} spans")

        # ------------------------------------- generator, finds and flush
        for tenant in (RX_TENANT, FWD_TENANT):
            got, want = _generator_series(app, tenant), _generator_series(oracle, tenant)
            check(got == want and got, f"phase 15 generator {tenant}: {len(got)} series, the "
                  f"CPU App's {len(want)}")
            res.setdefault("generator_series", {})[tenant] = len(got)
        # the finds read the live traces, one at a time (the two Apps share
        # this interpreter: more in flight only contend for it)
        rng = np.random.default_rng(seed + 15)
        ids = list(by_id)
        present = [ids[i] for i in rng.choice(len(ids), 250, replace=False)]
        absent = [bytes(x) for x in rng.integers(0, 2**32, (300, 4), dtype=np.uint32)
                  .astype(">u4").view(np.uint8).reshape(-1, 16)]
        absent = [x for x in absent if x not in by_id][:250]
        t0 = time.perf_counter()
        for tid in present + absent:
            tenant = by_id[tid][0] if tid in by_id else RX_TENANT
            st, body = request(srv.url, "find", "GET", f"/api/traces/{tid.hex()}",
                               headers={"Accept": "application/protobuf", "X-Scope-OrgID": tenant})
            want = oracle.find_trace(tid, org_id=tenant)
            if tid in by_id:
                check(st == 200 and want is not None
                      and _norm_trace(body) == _norm_trace(otlp.encode_traces_request([want]))
                      and want.span_count() == by_id[tid][1].span_count(),
                      f"phase 15 find {tid.hex()}: HTTP {st}")
            else:
                check(st == 404 and want is None, f"phase 15 find absent: HTTP {st}")
        res["stage_s"]["finds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        st, _ = request(srv.url, "flush", "POST", "/flush")
        res["flush_ms"] = (time.perf_counter() - t0) * 1e3
        ost, _ = request(oracle_srv.url, "flush", "POST", "/flush", timed=False)
        check(st == ost == 204, f"phase 15 /flush: HTTP {st} / {ost}")
        for a in (app, oracle):
            a.db.poll_now()
        print(f"phase 15 generator and finds: {res['generator_series']} series a tenant == the "
              f"CPU App's; 250 present IDs found whole and 250 absent -> 404 over the live "
              f"traces ({res['stage_s']['finds']:.1f} s) | /flush {res['flush_ms']:.0f} ms",
              flush=True)

        def same(kind, path, norm, tenant=RX_TENANT):
            hdr = {"X-Scope-OrgID": tenant}
            st, body = request(srv.url, kind, "GET", path, headers=hdr)
            ost, obody = request(oracle_srv.url, "cpu", "GET", path, headers=hdr, timed=False)
            check(st == ost == 200, f"phase 15 {path}: HTTP {st} / {ost}")
            got = norm(body)
            check(got == norm(obody), f"phase 15 {path}: != the CPU App's")
            return got

        def matrix(raw):
            doc = json.loads(raw)
            check(doc["status"] == "success", f"phase 15 query_range: {doc.get('status')}")
            return doc["data"]["result"]

        hits = same("search", "/api/search?" + urllib.parse.urlencode(
            {"tags": "service.name=cart", "limit": 10**6}),
            lambda raw: sorted(json.loads(raw)["traces"], key=lambda t: t["traceID"]))
        check(hits, "phase 15 search: no hit")
        window = dict(start=t_data - 300, end=now_min, step=60)
        series = {}
        for q in queries:
            series[q] = len(same("query_range", "/api/metrics/query_range?"
                                 + urllib.parse.urlencode(dict(q=q, **window)), matrix))
            check(series[q], f"phase 15 query_range {q}: no series")
        print(f"phase 15 reads: service.name=cart ({len(hits)} traces) and the three "
              f"query_range ({series} series) over the flushed blocks == the CPU App's",
              flush=True)

        # ----------------------------------------------------- the tees
        if not shed:
            fwd = [(tid, t) for tid, (tenant, t) in by_id.items() if tenant == FWD_TENANT]
            fwd_spans = sum(t.span_count() for _, t in fwd)

            def received() -> float:
                inst = second.generator.instance(FWD_TENANT) if second.generator else None
                return 0.0 if inst is None else sum(
                    s.value for s in inst.registry.collect()
                    if s.name == "traces_spanmetrics_calls_total")

            t0 = time.perf_counter()
            wait_for(lambda: received() >= fwd_spans, "the forwarded spans", 120.0)
            check(received() == fwd_spans, f"phase 15 forwarder: {received()} spans at the "
                  f"second App, {fwd_spans} sent")
            wait_s = time.perf_counter() - t0
            # every span arrived (the span-metrics calls above); 100 traces
            # found whole, each == the CPU App's
            for tid, t in fwd[:: max(1, len(fwd) // 100)]:
                got = second.find_trace(tid, org_id=FWD_TENANT)
                want = oracle.find_trace(tid, org_id=FWD_TENANT)
                check(got is not None and got.span_count() == t.span_count()
                      and _norm_trace(otlp.encode_traces_request([got]))
                      == _norm_trace(otlp.encode_traces_request([want])),
                      f"phase 15 forwarder: {tid.hex()} not whole, or not the CPU App's")
            res["forwarded"] = dict(traces=len(fwd), spans=fwd_spans, wait_s=wait_s,
                                    s=time.perf_counter() - t0)
            print(f"phase 15 forwarder: the {fwd_spans} spans of tenant {FWD_TENANT}'s "
                  f"{len(fwd)} traces at the second App, every 1 in {max(1, len(fwd) // 100)} "
                  f"found whole == the CPU App's ({wait_s:.1f} s until the last arrived, "
                  f"{res['forwarded']['s']:.1f} s in all)", flush=True)

            st, body = request(srv.url, "self search", "GET", "/api/search?"
                               + urllib.parse.urlencode({"tags": "name=distributor/push",
                                                         "limit": 20}),
                               headers={"X-Scope-OrgID": tracing.SELF_TENANT})
            self_hits = json.loads(body)["traces"] if st == 200 else []
            check(st == 200 and self_hits, f"phase 15 self-tracing: HTTP {st}, "
                  f"{len(self_hits)} traces")
            exp = app._self_exporter
            res["self_tracing"] = dict(
                hits=len(self_hits), exported=exp.exported_total.value(),
                dropped={r: exp.dropped_total.value(reason=r)
                         for r in ("sampled", "rate_limited", "pressure", "push_failed")})
            print(f"phase 15 self-tracing: {len(self_hits)} `_self_` traces with a "
                  f"distributor/push span | {res['self_tracing']}", flush=True)
        else:
            res["forwarded"] = res["self_tracing"] = "shed"

        check(app.usage_reporter.send_report(), "phase 15 usage_report: the send failed")
        check(len(sink.posts) == 1 and sink.posts[0][0] == "/usage-stats",
              f"phase 15 usage_report: {[p for p, _ in sink.posts]}")
        report = sink.posts[0][1]
        seed_path = os.path.join(root, "card", "blocks", usagestats.SEED_KEY)
        with open(seed_path) as f:
            seed_doc = json.load(f)
        check(sorted(report) == sorted(USAGE_REPORT_KEYS)
              and report["clusterID"] == seed_doc["UID"],
              f"phase 15 usage_report: keys {sorted(report)}, seed {seed_doc}")
        st, body = request(srv.url, "status", "GET", "/status/usage-stats", timed=False)
        check(st == 200 and json.loads(body)["clusterID"] == seed_doc["UID"],
              f"phase 15 /status/usage-stats: HTTP {st}")
        res["usage_report"] = dict(keys=sorted(report), metrics=len(report["metrics"]))
        print(f"phase 15 usage_report: one report at the sink, keys {sorted(report)}, "
              f"{len(report['metrics'])} metrics, the cluster seed at {usagestats.SEED_KEY}",
              flush=True)
    finally:
        t_down = time.perf_counter()
        if channel is not None:
            channel.close()
        for rx in reversed(receivers_up):
            rx.stop()
        for s in servers:
            s.stop()
        for a in reversed(apps):
            a.shutdown()
        broker.close()
        sink.close()
        for conn in conns.values():
            conn.close()
        res["stage_s"]["teardown"] = time.perf_counter() - t_down
    res["ms"] = {k: dict(p50=statistics.median(v), max=max(v), n=len(v))
                 for k, v in res.pop("requests").items()}
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------- 16
# object storage: in-process mocks of the three wire dialects the cloud
# backends speak (S3 path-style with SigV4 and XML listings, the GCS JSON
# API, Azure blob REST with Put Block / Put Block List). Each records
# every request it takes (method, path, headers, body), so two clients
# can be held to the same bytes on the wire.


class ObjectStoreMock:
    """One object store behind a ThreadingHTTPServer on 127.0.0.1.
    dialect: "s3" (checks each request's SigV4 signature against
    S3_SECRET and answers 403 on a mismatch), "gcs" or "azure". The
    objects live in `objects` (key -> bytes); Azure's staged blocks in
    `staged`. `requests` logs every request; `log=False` stops it (a
    phase's reads would hold every page twice)."""

    def __init__(self, dialect: str, log: bool = True):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.dialect = dialect
        self.objects: dict = {}
        self.staged: dict = {}
        self.requests: list = []
        self.log = log
        self.lock = threading.Lock()
        store = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _handle(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(n) if n else b""
                if store.log:
                    with store.lock:
                        store.requests.append((self.command, self.path,
                                               sorted(self.headers.items()), body))
                code, out, ctype = getattr(store, f"_{store.dialect}")(
                    self.command, self.path, self.headers, body)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            do_GET = do_PUT = do_POST = do_DELETE = _handle

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._srv.daemon_threads = True
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)

    def reset(self) -> None:
        with self.lock:
            self.objects.clear()
            self.staged.clear()
            self.requests.clear()

    # -- shared pieces ----------------------------------------------------
    def _listing(self, prefix: str, delimiter: str) -> tuple[list, list]:
        dirs, keys = set(), []
        with self.lock:
            names = sorted(self.objects)
        for k in names:
            if not k.startswith(prefix):
                continue
            rest = k[len(prefix):]
            if delimiter and delimiter in rest:
                dirs.add(prefix + rest.split(delimiter, 1)[0] + delimiter)
            else:
                keys.append(k)
        return sorted(dirs), keys

    def _get(self, key: str, headers) -> tuple:
        with self.lock:
            data = self.objects.get(key)
        if data is None:
            return 404, b"", "application/octet-stream"
        rng = headers.get("Range") or headers.get("x-ms-range")
        if rng and rng.startswith("bytes="):
            lo, hi = (int(x) for x in rng[len("bytes="):].split("-"))
            return 206, data[lo:hi + 1], "application/octet-stream"
        return 200, data, "application/octet-stream"

    def _delete(self, key: str, ok: int) -> tuple:
        with self.lock:
            existed = self.objects.pop(key, None)
        return (ok if existed is not None else 404), b"", "application/octet-stream"

    # -- S3 ----------------------------------------------------------------
    def _sigv4_ok(self, method: str, path: str, query: str, headers, body: bytes) -> bool:
        """Recompute the request's AWS Signature Version 4 (header form)
        from what arrived and S3_SECRET."""
        import hashlib
        import hmac

        auth = headers.get("Authorization", "")
        if not auth.startswith(f"AWS4-HMAC-SHA256 Credential={S3_ACCESS}/"):
            return False
        fields = dict(p.strip().split("=", 1) for p in auth[len("AWS4-HMAC-SHA256 "):].split(","))
        scope = fields["Credential"].split("/", 1)[1]
        payload = hashlib.sha256(body).hexdigest()
        if headers.get("x-amz-content-sha256") != payload:
            return False

        def enc(s: str, safe: str) -> str:
            return urllib.parse.quote(s, safe=safe + "-_.~")

        signed = fields["SignedHeaders"].split(";")
        canon_q = "&".join(f"{enc(k, '')}={enc(v, '')}"
                           for k, v in sorted(urllib.parse.parse_qsl(query, keep_blank_values=True)))
        canon_h = "".join(f"{h}:{headers.get(h, '')}\n" for h in signed)
        creq = "\n".join([method, enc(path, "/"), canon_q, canon_h, ";".join(signed), payload])
        date = headers.get("x-amz-date", "")
        sts = "\n".join(["AWS4-HMAC-SHA256", date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
        key = ("AWS4" + S3_SECRET).encode()
        for part in scope.split("/"):
            key = hmac.new(key, part.encode(), hashlib.sha256).digest()
        return hmac.compare_digest(hmac.new(key, sts.encode(), hashlib.sha256).hexdigest(),
                                   fields["Signature"])

    def _s3(self, method, raw_path, headers, body):
        import xml.sax.saxutils as sx

        u = urllib.parse.urlsplit(raw_path)
        if not self._sigv4_ok(method, u.path, u.query, headers, body):
            return 403, b"<Error><Code>SignatureDoesNotMatch</Code></Error>", "application/xml"
        parts = urllib.parse.unquote(u.path).lstrip("/").split("/", 1)
        key = parts[1] if len(parts) > 1 else ""
        qs = dict(urllib.parse.parse_qsl(u.query))
        if method == "PUT":
            with self.lock:
                self.objects[key] = body
            return 200, b"", "application/xml"
        if method == "DELETE":
            return self._delete(key, 204)
        if "list-type" in qs:
            dirs, keys = self._listing(qs.get("prefix", ""), qs.get("delimiter", ""))
            xml = "<?xml version='1.0'?><ListBucketResult><IsTruncated>false</IsTruncated>"
            xml += "".join(f"<CommonPrefixes><Prefix>{sx.escape(d)}</Prefix></CommonPrefixes>"
                           for d in dirs)
            xml += "".join(f"<Contents><Key>{sx.escape(k)}</Key></Contents>" for k in keys)
            return 200, (xml + "</ListBucketResult>").encode(), "application/xml"
        return self._get(key, headers)

    # -- GCS ---------------------------------------------------------------
    def _gcs(self, method, raw_path, headers, body):
        u = urllib.parse.urlsplit(raw_path)
        qs = dict(urllib.parse.parse_qsl(u.query))
        path = urllib.parse.unquote(u.path)
        if method == "POST":
            if not u.path.startswith("/upload/storage/v1/b/"):
                return 404, b"{}", "application/json"
            with self.lock:
                self.objects[qs["name"]] = body
            return 200, json.dumps({"name": qs["name"]}).encode(), "application/json"
        if method == "GET" and path.rstrip("/").endswith("/o"):
            dirs, keys = self._listing(qs.get("prefix", ""), qs.get("delimiter", ""))
            doc = {"prefixes": dirs, "items": [{"name": k} for k in keys]}
            return 200, json.dumps(doc).encode(), "application/json"
        key = path.split("/o/", 1)[1]
        if method == "DELETE":
            return self._delete(key, 204)
        return self._get(key, headers)

    # -- Azure -------------------------------------------------------------
    def _azure(self, method, raw_path, headers, body):
        import re
        import xml.sax.saxutils as sx

        u = urllib.parse.urlsplit(raw_path)
        qs = dict(urllib.parse.parse_qsl(u.query))
        # /<account>/<container>[/<blob...>]
        parts = urllib.parse.unquote(u.path).lstrip("/").split("/", 2)
        key = parts[2] if len(parts) > 2 else ""
        if method == "PUT":
            with self.lock:
                if qs.get("comp") == "block":
                    self.staged.setdefault(key, {})[qs["blockid"]] = body
                elif qs.get("comp") == "blocklist":
                    ids = re.findall(r"<(?:Uncommitted|Latest)>([^<]+)</", body.decode())
                    staged = self.staged.pop(key, {})
                    self.objects[key] = b"".join(staged[i] for i in ids)
                else:
                    self.objects[key] = body
            return 201, b"", "application/xml"
        if method == "DELETE":
            return self._delete(key, 202)
        if qs.get("comp") == "list":
            dirs, keys = self._listing(qs.get("prefix", ""), qs.get("delimiter", ""))
            xml = "<?xml version='1.0'?><EnumerationResults><Blobs>"
            xml += "".join(f"<BlobPrefix><Name>{sx.escape(d)}</Name></BlobPrefix>" for d in dirs)
            xml += "".join(f"<Blob><Name>{sx.escape(k)}</Name></Blob>" for k in keys)
            return 200, (xml + "</Blobs><NextMarker/></EnumerationResults>").encode(), \
                "application/xml"
        return self._get(key, headers)


S3_ACCESS, S3_SECRET = "smoke-access", "smoke-secret"


def store_options(mock: ObjectStoreMock) -> dict:
    """backend_options of the port's (and the reference's) cloud backend
    for one mock: its DBConfig.backend_options."""
    if mock.dialect == "s3":
        return dict(bucket="tempo", endpoint=mock.url, access_key=S3_ACCESS,
                    secret_key=S3_SECRET)
    if mock.dialect == "gcs":
        return dict(bucket_name="tempo", endpoint=mock.url, token="smoke-token")
    return dict(storage_account_name="devstoreaccount1", storage_account_key="a2V5",
                container_name="tempo", endpoint=mock.url + "/devstoreaccount1")


SHED16_S = 900
DEVICE_FAMILIES = ("tempo_tpu_device_dispatch_seconds", "tempo_tpu_device_dispatches_total",
                   "tempo_tpu_device_transfer_bytes_total",
                   "tempo_tpu_device_transfer_bytes_avoided_total")


def metric_series(text: str, family: str) -> dict:
    """{frozenset of (label, value): value} of one counter family in a
    Prometheus text exposition."""
    import re

    out = {}
    for line in text.splitlines():
        m = re.match(rf"^{family}(?:\{{(.*)\}})? (\S+)$", line)
        if m:
            labels = frozenset(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"', m.group(1) or ""))
            out[labels] = float(m.group(2))
    return out


def _p50_max(ms: list) -> dict:
    return {"p50": statistics.median(ms), "max": max(ms), "n": len(ms)}


def stored_objects(blocks_root: str, tenant: str, block_id: str, drop_id: bool = False) -> dict:
    """name -> the bytes of one block's objects under a local backend's
    root, meta.json without its block id when drop_id."""
    d = os.path.join(blocks_root, tenant, block_id)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    if drop_id:
        meta = json.loads(out["meta.json"])
        meta.pop("block_id")
        out["meta.json"] = json.dumps(meta, sort_keys=True).encode()
    return out


def objectstore_phase(seed: int, root: str, queries: list, plan_of, shed: bool = False) -> dict:
    """Phase 16, object storage and the off-cluster readers. (a)
    TempoDB(device="cuda") over the S3 mock (SigV4 checked on every
    request): two 2**17-span vtpu1 blocks of make_graph_batch traces (the
    second repeats every 8th trace of the first), each written to S3 and
    to a local backend on the card (every object byte-equal), 200 finds
    (100 present, 100 absent), a tag search at limit 20 and phase 4's
    first query over the S3 blocks (seg_bincount), each equal to a
    TempoDB(device="cpu") reading the same mock, and compact_once on S3
    and local (the merged blocks byte-equal); one block round trip each
    over the GCS and Azure mocks (`shed` drops them). (b) two 2**14-span
    vrow1 blocks written on the card and on the CPU (byte-equal; one
    hll_update launch a card write), finds and a search equal, and
    compact_once on the card (every trace once, finds equal to the
    unmerged blocks'). (c) a card App over the S3 mock (multitenancy: the
    blocks' tenant) with its querier's external_endpoints set to a
    ServerlessServer over the same mock: each search equals the same
    search with the endpoints unset; JaegerQueryServer and the gRPC
    storage plugin (where grpcio is installed) over the card App and a
    CPU App on the same objects answer alike; `python -m
    tempo_tpu_torch.cli` over a copy of (a)'s local blocks: list blocks,
    query trace-id, query search, gen bloom on the card (the bloom
    objects unchanged) and, unless `shed`, convert of a 2**14-span vtpu1
    block to vrow1 and back, beside (b) (the final block byte-equal to the
    source).
    (d) /metrics of the card App: the four device families present, each
    kernel's dispatches_total == STATS.dispatches, and over (c)'s
    requests the h2d + d2h delta == the delta of the tenants'
    transfer_bytes on /status/usage. Returns its numbers."""
    import http.client
    import types

    import numpy as np

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.api.server import TempoServer
    from tempo_tpu_torch.app import App, AppConfig
    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest
    from tempo_tpu_torch.jaeger_query import JaegerQueryBridge, JaegerQueryServer
    from tempo_tpu_torch.model import synth
    from tempo_tpu_torch.model.columnar import SpanBatch
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.ops import sketch
    from tempo_tpu_torch.receivers import otlp
    from tempo_tpu_torch.serverless import SearchBlockHandler, ServerlessServer
    from tempo_tpu_torch.util import devicetiming

    tenant = "smoke"
    t_phase = time.perf_counter()
    res: dict = {"write_ms": {}, "ms": {}, "cli_s": {}, "shed": shed}
    # every record of a vrow1 block gzips the dictionary with the clock:
    # one instant for the whole phase, so card and CPU writes compare
    gzip_time = gzip.time
    gzip.time = types.SimpleNamespace(time=lambda: BASE_S)
    mocks: list = []
    closers: list = []
    try:
        def two_blocks(n_traces: int, s: int):
            """(a, b): b repeats every 8th trace of a, both trace-sorted."""
            a = synth.make_graph_batch(n_traces, 8, seed=s, error_rate=0.1).sorted_by_trace()
            firsts, seg = a.trace_boundaries()
            rep = a.select(np.flatnonzero(np.isin(seg, np.arange(0, len(firsts), 8))))
            b = SpanBatch.concat([synth.make_graph_batch(n_traces - n_traces // 8, 8, seed=s + 1,
                                                         error_rate=0.1), rep]).sorted_by_trace()
            return a, b

        def trace_ids(batch) -> np.ndarray:
            return batch.cols["trace_id"][batch.trace_boundaries()[0]]

        def tid_bytes(row) -> bytes:
            return np.asarray(row, np.uint32).astype(">u4").tobytes()

        def same_trace(x, y) -> bool:
            if x is None or y is None:
                return x is None and y is None
            return otlp.encode_traces_request([x]) == otlp.encode_traces_request([y])

        def top_duration(batches, k: int, service: str | None = None) -> int:
            """The k-th longest root span over the batches' distinct traces
            (those with a span of `service`, when given): a min_duration
            that leaves a search about k traces, so its answer is whole at
            any limit above that and compares exactly (a limited search
            that stops early keeps the traces its threads reached
            first)."""
            keep = None if service is None else with_service(batches, service)
            tids, durs = [], []
            for bt in batches:
                root = np.all(bt.cols["parent_span_id"] == 0, axis=1)
                tids.append(bt.cols["trace_id"][root])
                durs.append(bt.cols["duration_nano"][root])
            tids, durs = np.concatenate(tids), np.concatenate(durs)
            _, first = np.unique(tids, axis=0, return_index=True)
            if keep is not None:
                first = np.array([i for i in first if tid_bytes(tids[i]).hex() in keep])
            return int(np.sort(durs[first])[-k])

        def with_service(batches, service: str) -> set:
            out = set()
            for bt in batches:
                code = bt.dictionary.entries.index(service)
                out |= {tid_bytes(r).hex() for r in bt.cols["trace_id"][bt.cols["service"] == code]}
            return out

        def same_hits(x, y) -> bool:
            return [t.to_dict() for t in x.traces] == [t.to_dict() for t in y.traces]

        def mock_objects(mock, block_id: str) -> dict:
            pre = f"{tenant}/{block_id}/"
            with mock.lock:
                return {k[len(pre):]: v for k, v in mock.objects.items() if k.startswith(pre)}

        cli_runs: dict = {}  # command -> (thread, {"rc", "out", "err", "s"})

        def cli(name: str, *argv, path=os.path.join(root, "cli", "blocks")) -> None:
            """Start `python -m tempo_tpu_torch.cli --path path *argv` and a
            thread that waits for it and keeps its exit code, output and
            seconds from start to exit."""
            t0 = time.perf_counter()
            # one intra-op thread: the commands run beside the phase's
            # host-bound work and need no parallel CPU kernels
            proc = subprocess.Popen([sys.executable, "-m", "tempo_tpu_torch.cli", "--path", path,
                                     *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
                                    env=dict(os.environ, OMP_NUM_THREADS="1"))
            done: dict = {}

            def wait():
                done["out"], done["err"] = proc.communicate(timeout=600)
                done["rc"], done["s"] = proc.returncode, time.perf_counter() - t0

            thread = threading.Thread(target=wait, daemon=True)
            thread.start()
            cli_runs[name] = (thread, done)

        def cli_result(name: str) -> str:
            thread, done = cli_runs[name]
            thread.join(timeout=600)
            check(done.get("rc") == 0, f"phase 16 (c): cli {name} exited {done.get('rc')}: "
                  f"{done.get('err', '')[-2000:]}")
            res["cli_s"][name] = done["s"]
            return done["out"]

        # ------------------------------------------------------------ (a)
        a, b = two_blocks(1 << 14, seed * 1000 + 1600)
        check(a.num_spans == b.num_spans == 1 << 17, "phase 16: the (a) blocks' size")
        ids = [f"00000000-0000-4000-8000-0000000016{i:02d}" for i in range(2)]
        s3 = ObjectStoreMock("s3", log=False)
        mocks.append(s3)
        opts = store_options(s3)
        local_root = os.path.join(root, "local", "blocks")
        db_s3 = TempoDB(DBConfig(backend="s3", backend_options=opts,
                                 wal_path=os.path.join(root, "s3wal")), device="cuda")
        db_loc = TempoDB(DBConfig(backend="local", backend_path=local_root,
                                  wal_path=os.path.join(root, "local", "wal")), device="cuda")
        db_cpu = TempoDB(DBConfig(backend="s3", backend_options=opts,
                                  wal_path=os.path.join(root, "cpuwal")), device="cpu")
        for label, db in (("s3", db_s3), ("local", db_loc)):
            res["write_ms"][f"vtpu1 {label}"] = []
            for bid, batch in zip(ids, (a, b)):
                t0 = time.perf_counter()
                db.write_batch(tenant, batch, block_id=bid)
                res["write_ms"][f"vtpu1 {label}"].append((time.perf_counter() - t0) * 1e3)
        for bid in ids:
            got, want = mock_objects(s3, bid), stored_objects(local_root, tenant, bid)
            check(got == want, f"phase 16 (a): S3 objects of {bid} != the local write's "
                  f"({sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))})")
        res["s3_objects"] = len(s3.objects)
        res["s3_bytes"] = sum(len(v) for v in s3.objects.values())
        cli_root = os.path.join(root, "cli")
        shutil.copytree(local_root, os.path.join(cli_root, "blocks"))
        for db in (db_s3, db_cpu):
            db.poll_now()
            check(len(db.blocklist.metas(tenant)) == 2, "phase 16 (a): poll over S3")
        ta, tb = trace_ids(a), trace_ids(b)
        rng = np.random.default_rng(seed + 16)
        present = [tid_bytes(r) for r in ta[rng.choice(len(ta), 50, replace=False)]] + \
            [tid_bytes(r) for r in tb[rng.choice(len(tb), 50, replace=False)]]
        absent = [tid_bytes(r) for r in rng.integers(0, 2**32, size=(100, 4), dtype=np.uint32)]
        find_ms, n_found = [], 0
        for tid in present + absent:
            t0 = time.perf_counter()
            got = db_s3.find(tenant, tid)
            find_ms.append((time.perf_counter() - t0) * 1e3)
            check(same_trace(got, db_cpu.find(tenant, tid)),
                  f"phase 16 (a): find {tid.hex()} over S3, card != cpu")
            n_found += got is not None
        check(n_found == 100, f"phase 16 (a): {n_found} of 100 present traces found over S3")
        res["ms"]["find over S3"] = _p50_max(find_ms)
        svc = a.dictionary.entries[int(a.cols["service"][0])]
        req = SearchRequest(tags={"service": svc}, limit=20)
        t0 = time.perf_counter()
        got = db_s3.search(tenant, req)
        res["ms"]["search over S3"] = _p50_max([(time.perf_counter() - t0) * 1e3])
        check(len(got.traces) == 20 and {t.trace_id_hex.zfill(32) for t in got.traces}
              <= with_service((a, b), svc), "phase 16 (a): search over S3 != the oracle")
        whole = SearchRequest(tags={"service": svc},
                              min_duration_ns=top_duration((a, b), 8, svc), limit=20)
        got = db_s3.search(tenant, whole)
        check(got.traces and same_hits(got, db_cpu.search(tenant, whole)),
              "phase 16 (a): search over S3, card != cpu")
        plan = plan_of(queries[0])
        mats = {}
        for dev, db in (("cuda", db_s3), ("cpu", db_cpu)):
            before = pk.seg_bincount.launches
            t0 = time.perf_counter()
            merged = M.new_wire()
            for m in db.blocklist.metas(tenant):
                blk = db.encoding_for(m.version).open_block(m, db.backend, db.cfg.block)
                M.merge_wire(merged, M.evaluate_block(plan, blk, device=dev).to_wire(), plan)
            mats[dev] = M.finalize_matrix(plan, merged)
            res["ms"][f"query_range over S3 {dev}"] = _p50_max([(time.perf_counter() - t0) * 1e3])
            if dev == "cuda":
                check(pk.seg_bincount.launches > before,
                      "phase 16 (a): query_range over S3 launched no seg_bincount")
        check(mats["cuda"] == mats["cpu"] and mats["cpu"]["result"],
              "phase 16 (a): query_range over S3, cuda matrix != cpu matrix")
        merged_ids = {}
        for label, db in (("s3", db_s3), ("local", db_loc)):
            t0 = time.perf_counter()
            check(db.compact_once(tenant), f"phase 16 (a): compact_once on {label} did nothing")
            res["ms"][f"compact_once {label}"] = _p50_max([(time.perf_counter() - t0) * 1e3])
            db.poll_now()
            (m,) = db.blocklist.metas(tenant)
            check(m.total_objects == len(ta) + len(tb) - len(ta) // 8,
                  f"phase 16 (a): {label} merge holds {m.total_objects} traces")
            merged_ids[label] = m.block_id
        got = mock_objects(s3, merged_ids["s3"])
        want = stored_objects(local_root, tenant, merged_ids["local"])
        for objs, bid in ((got, merged_ids["s3"]), (want, merged_ids["local"])):
            meta = json.loads(objs["meta.json"])
            check(meta.pop("block_id") == bid, "phase 16 (a): merged meta's id")
            objs["meta.json"] = json.dumps(meta, sort_keys=True).encode()
        check(got == want, "phase 16 (a): the S3 merge != the local merge")
        db_cpu.poll_now()
        for tid in present[:10]:
            check(same_trace(db_s3.find(tenant, tid), db_cpu.find(tenant, tid)),
                  "phase 16 (a): find after the merge, card != cpu")
        print(f"phase 16 (a) S3: 2 x {a.num_spans} spans written, {res['s3_objects']} objects "
              f"({res['s3_bytes']} B) == the local writes; 200 finds p50 "
              f"{res['ms']['find over S3']['p50']:.2f} ms max {res['ms']['find over S3']['max']:.2f}"
              f" ms; search, query_range and the merge == the CPU / local", flush=True)
        res["round_trips"] = {}
        for dialect in () if shed else ("gcs", "azure"):
            mock = ObjectStoreMock(dialect, log=False)
            mocks.append(mock)
            db = TempoDB(DBConfig(backend=dialect, backend_options=store_options(mock),
                                  wal_path=os.path.join(root, f"{dialect}wal")), device="cuda")
            t0 = time.perf_counter()
            db.write_batch(tenant, a, block_id=ids[0])
            ms = (time.perf_counter() - t0) * 1e3
            check(mock_objects(mock, ids[0]) == stored_objects(os.path.join(cli_root, "blocks"),
                                                               tenant, ids[0]),
                  f"phase 16 (a): {dialect} objects != the local write's")
            db.poll_now()
            found = [db.find(tenant, tid) for tid in present[:10] + absent[:10]]
            want = [db_loc.find(tenant, tid) for tid in present[:10] + absent[:10]]
            check(all(same_trace(x, y) for x, y in zip(found, want)),
                  f"phase 16 (a): finds over {dialect} != local")
            res["round_trips"][dialect] = dict(write_ms=ms, objects=len(mock.objects))
            if dialect == "azure":
                check(not mock.staged, "phase 16 (a): azure blocks left uncommitted")
        print(f"phase 16 (a) GCS and Azure round trips: {res['round_trips'] or 'shed'}", flush=True)

        # ------------------------------------------------------------ (b)
        c, d = two_blocks(1 << 11, seed * 1000 + 1700)
        vids = [f"00000000-0000-4000-8000-0000000017{i:02d}" for i in range(2)]
        if not shed:
            # the CLI's convert chain runs beside (b): one process at a time
            conv_root = os.path.join(root, "cli-convert", "blocks")
            src_id = "00000000-0000-4000-8000-000000001800"
            conv = TempoDB(DBConfig(backend="local", backend_path=conv_root,
                                    wal_path=os.path.join(root, "cli-convert", "wal")),
                           device="cuda")
            conv.write_batch(tenant, c, block_id=src_id)
            cli("convert to vrow1", "convert", tenant, src_id, "--to", "vrow1",
                "--device", "cuda", path=conv_root)
        vroots, vdbs = {}, {}
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            vroots[side] = os.path.join(root, f"vrow-{side}", "blocks")
            vdbs[side] = TempoDB(DBConfig(backend="local", backend_path=vroots[side],
                                          wal_path=os.path.join(root, f"vrow-{side}", "wal"),
                                          block=BlockConfig(version="vrow1")), device=dev)
        hll0 = sketch.hll_update.launches
        for side in ("card", "cpu"):
            res["write_ms"][f"vrow1 {side}"] = []
            for bid, batch in zip(vids, (c, d)):
                t0 = time.perf_counter()
                meta = vdbs[side].write_batch(tenant, batch, block_id=bid)
                res["write_ms"][f"vrow1 {side}"].append((time.perf_counter() - t0) * 1e3)
                check(meta.version == "vrow1", "phase 16 (b): not a vrow1 block")
            if side == "card":
                res["hll_update_vrow_writes"] = sketch.hll_update.launches - hll0
                check(res["hll_update_vrow_writes"] == 2,
                      f"phase 16 (b): {res['hll_update_vrow_writes']} hll_update launches for 2 "
                      "card writes")
        for bid in vids:
            check(stored_objects(vroots["card"], tenant, bid)
                  == stored_objects(vroots["cpu"], tenant, bid),
                  f"phase 16 (b): vrow1 block {bid} card != cpu")
        for db in vdbs.values():
            db.poll_now()
        tc, td = trace_ids(c), trace_ids(d)
        vpresent = [tid_bytes(r) for r in tc[rng.choice(len(tc), 50, replace=False)]]
        vms = []
        for tid in vpresent + absent[:50]:
            t0 = time.perf_counter()
            got = vdbs["card"].find(tenant, tid)
            vms.append((time.perf_counter() - t0) * 1e3)
            check(same_trace(got, vdbs["cpu"].find(tenant, tid)) and
                  (got is not None) == (tid in vpresent), "phase 16 (b): vrow1 find card != cpu")
        res["ms"]["find vrow1"] = _p50_max(vms)
        vsvc = c.dictionary.entries[int(c.cols["service"][0])]
        got = vdbs["card"].search(tenant, SearchRequest(tags={"service": vsvc}, limit=20))
        check(len(got.traces) == 20 and {t.trace_id_hex.zfill(32) for t in got.traces}
              <= with_service((c, d), vsvc), "phase 16 (b): vrow1 search != the oracle")
        vreq = SearchRequest(tags={"service": vsvc},
                             min_duration_ns=top_duration((c, d), 8, vsvc), limit=20)
        got = vdbs["card"].search(tenant, vreq)
        check(got.traces and same_hits(got, vdbs["cpu"].search(tenant, vreq)),
              "phase 16 (b): vrow1 search card != cpu")
        # the merge on the card alone: its bytes against the reference's
        # are the CPU tests' (tests/test_torch_vrow.py); here every trace
        # once, and finds against the CPU's unmerged blocks
        hll0 = sketch.hll_update.launches
        t0 = time.perf_counter()
        check(vdbs["card"].compact_once(tenant), "phase 16 (b): vrow1 compact_once on the card")
        res["ms"]["compact_once vrow1 card"] = _p50_max([(time.perf_counter() - t0) * 1e3])
        check(sketch.hll_update.launches - hll0 == 1, "phase 16 (b): the card's "
              "vrow1 merge launched hll_update other than once")
        vdbs["card"].poll_now()
        (m,) = vdbs["card"].blocklist.metas(tenant)
        check(m.total_objects == len(tc) + len(td) - len(tc) // 8
              and m.total_spans == c.num_spans + d.num_spans - (len(tc) // 8) * 8,
              "phase 16 (b): vrow1 merge trace and span counts")
        both = tc[::8][:10]  # traces of c that d repeats
        for tid in [tid_bytes(r) for r in both] + vpresent[:10] + \
                [tid_bytes(r) for r in td[:10]] + absent[:10]:
            check(same_trace(vdbs["card"].find(tenant, tid), vdbs["cpu"].find(tenant, tid)),
                  "phase 16 (b): a find after the vrow1 merge != the unmerged blocks'")
        print(f"phase 16 (b) vrow1: 2 x {c.num_spans} spans, card writes "
              f"{res['write_ms']['vrow1 card']} ms, CPU writes {res['write_ms']['vrow1 cpu']} ms, "
              f"byte-equal; finds p50 {res['ms']['find vrow1']['p50']:.2f} ms; the card's merge "
              f"{res['ms']['compact_once vrow1 card']['p50']:.0f} ms, every trace once, finds == "
              "the unmerged blocks'", flush=True)
        if not shed:
            vrow_id = re.findall(r"-> (\S+) \(vrow1\)", cli_result("convert to vrow1"))[0]
            cli("convert to vtpu1", "convert", tenant, vrow_id, "--to", "vtpu1",
                "--device", "cuda", path=conv_root)

        # ------------------------------------------------------------ (c)
        bloom_root = os.path.join(root, "cli-bloom", "blocks")
        shutil.copytree(os.path.join(cli_root, "blocks"), bloom_root)
        blooms = {k: v for k, v in stored_objects(bloom_root, tenant, ids[1]).items()
                  if k.startswith("bloom")}
        one = present[0].hex()
        cli("list blocks", "list", "blocks", tenant)
        cli("query trace-id", "query", "trace-id", tenant, one)
        cli("query search", "query", "search", tenant, "--tags", f"service.name={svc}",
            "--limit", "20")
        cli("gen bloom", "gen", "bloom", tenant, ids[1], "--device", "cuda", path=bloom_root)

        def make_app(side: str, dev: str):
            app = App(AppConfig(multitenancy_enabled=True, generator_enabled=False,
                                db=DBConfig(backend="s3", backend_options=opts,
                                            wal_path=os.path.join(root, f"app-{side}", "wal"))),
                      device=dev)
            app.db.poll_now()
            return app

        app, app_cpu = make_app("card", "cuda"), make_app("cpu", "cpu")
        closers += [app.shutdown, app_cpu.shutdown]
        server = TempoServer(app, host="127.0.0.1", port=0).start()
        closers.insert(0, server.stop)
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)

        def usage_transfer() -> float:
            conn.request("GET", "/status/usage")
            r = conn.getresponse()
            doc = json.loads(r.read())
            return sum(v.get("transfer_bytes", 0) for t in doc["tenants"].values()
                       for v in t["kinds"].values())

        moved0, charged0 = devicetiming.moved_total(), usage_transfer()
        sls = ServerlessServer(SearchBlockHandler("s3", opts)).start()
        closers.insert(0, sls.stop)
        svcs = sorted({a.dictionary.entries[int(x)] for x in np.unique(a.cols["service"])})
        reqs = [SearchRequest(tags={"service": s}, min_duration_ns=top_duration((a, b), 12, s),
                              limit=20) for s in svcs[:3]] + \
            [SearchRequest(min_duration_ns=top_duration((a, b), 6), limit=20)]
        ext_ms, direct_ms = [], []
        for r in reqs:
            app.querier.external_endpoints = [sls.url + "/"]
            app.querier._ext_clients = None
            t0 = time.perf_counter()
            via = app.search(r, org_id=tenant)
            ext_ms.append((time.perf_counter() - t0) * 1e3)
            app.querier.external_endpoints = []
            t0 = time.perf_counter()
            direct = app.search(r, org_id=tenant)
            direct_ms.append((time.perf_counter() - t0) * 1e3)
            check(via.traces and same_hits(via, direct),
                  f"phase 16 (c): serverless search {r.tags} != the querier's")
        check(app.querier._ext_rr >= len(reqs), "phase 16 (c): no job went to the endpoint")
        # a query_range through each App: the card's seg_bincount moves
        # bytes under the tenant's attribution
        launches0 = pk.seg_bincount.launches
        t0 = time.perf_counter()
        mat = app.query_range(queries[0], BASE_S, BASE_S + 3600, 60, org_id=tenant)
        res["ms"]["query_range App"] = _p50_max([(time.perf_counter() - t0) * 1e3])
        want = app_cpu.query_range(queries[0], BASE_S, BASE_S + 3600, 60, org_id=tenant)
        check(mat["result"] and mat["result"] == want["result"],
              "phase 16 (c): the card App's query_range != the CPU App's")
        check(pk.seg_bincount.launches > launches0,
              "phase 16 (c): the App's query_range launched no seg_bincount")
        res["ms"]["search serverless"] = _p50_max(ext_ms)
        res["ms"]["search direct"] = _p50_max(direct_ms)
        print(f"phase 16 (c) serverless: {len(reqs)} searches == the querier's, p50 "
              f"{res['ms']['search serverless']['p50']:.1f} ms through the endpoint "
              f"({app.querier._ext_rr} jobs), {res['ms']['search direct']['p50']:.1f} ms direct",
              flush=True)
        # Jaeger over HTTP
        jsrv = {dev: JaegerQueryServer(JaegerQueryBridge(x, tenant=tenant)).start()
                for dev, x in (("cuda", app), ("cpu", app_cpu))}
        closers[:0] = [s.stop for s in jsrv.values()]
        routes = {"services": "/api/services",
                  "operations": f"/api/services/{svc}/operations",
                  "trace": f"/api/traces/{one}",
                  "find": f"/api/traces?minDuration={top_duration((a, b), 4)}&limit=20"}
        for name, path in routes.items():
            bodies = {}
            for dev, s in jsrv.items():
                host, port = s.url.rsplit(":", 1)
                jc = http.client.HTTPConnection("127.0.0.1", int(port), timeout=600)
                t0 = time.perf_counter()
                jc.request("GET", path)
                resp = jc.getresponse()
                bodies[dev] = (resp.status, json.loads(resp.read()))
                if dev == "cuda":
                    res["ms"][f"jaeger {name}"] = _p50_max([(time.perf_counter() - t0) * 1e3])
                jc.close()
            check(bodies["cuda"] == bodies["cpu"] and bodies["cuda"][0] == 200
                  and bodies["cuda"][1]["data"], f"phase 16 (c): Jaeger {name} card != cpu")
        # Jaeger gRPC storage plugin
        try:
            import grpc
        except ImportError:
            grpc = None
        res["jaeger_grpc"] = "absent" if grpc is None else "grpcio"
        if grpc is not None:
            from tempo_tpu_torch import jaeger_plugin as jp
            from tempo_tpu_torch.receivers.protowire import (
                put_bytes_field,
                put_str_field,
                put_varint_field,
            )

            get = bytearray()
            put_bytes_field(get, 1, present[0])
            dur = bytearray()
            put_varint_field(dur, 1, top_duration((a, b), 4) // 10**9)
            put_varint_field(dur, 2, top_duration((a, b), 4) % 10**9)
            q = bytearray()
            put_bytes_field(q, 6, bytes(dur))  # duration_min
            put_varint_field(q, 8, 20)  # limit
            find = bytearray()
            put_bytes_field(find, 1, bytes(q))
            ident = lambda x: x  # noqa: E731
            calls = (("GetServices", jp.GET_SERVICES, b"", False),
                     ("GetOperations", jp.GET_OPERATIONS, b"", False),
                     ("GetTrace", jp.GET_TRACE, bytes(get), True),
                     ("FindTraces", jp.FIND_TRACES, bytes(find), True))
            answers = {}
            for dev, x in (("cuda", app), ("cpu", app_cpu)):
                plug = jp.JaegerStoragePluginServer(JaegerQueryBridge(x, tenant=tenant)).start()
                ch = grpc.insecure_channel(f"127.0.0.1:{plug.port}")
                try:
                    for name, method, body, stream in calls:
                        t0 = time.perf_counter()
                        if stream:
                            out = list(ch.unary_stream(method, request_serializer=ident,
                                                       response_deserializer=ident)(body,
                                                                                    timeout=600))
                        else:
                            out = ch.unary_unary(method, request_serializer=ident,
                                                 response_deserializer=ident)(body, timeout=600)
                        if dev == "cuda":
                            res["ms"][f"jaeger grpc {name}"] = _p50_max(
                                [(time.perf_counter() - t0) * 1e3])
                        answers.setdefault(name, {})[dev] = out
                finally:
                    ch.close()
                    plug.stop()
            for name, by_dev in answers.items():
                check(by_dev["cuda"] == by_dev["cpu"] and by_dev["cuda"],
                      f"phase 16 (c): Jaeger gRPC {name} card != cpu")
        moved1, charged1 = devicetiming.moved_total(), usage_transfer()
        print(f"phase 16 (c) Jaeger: HTTP {', '.join(routes)} and gRPC ({res['jaeger_grpc']}) "
              "== the CPU App's | "
              + ", ".join(f"{k} {v['p50']:.1f} ms" for k, v in res["ms"].items()
                          if k.startswith("jaeger")), flush=True)

        # ------------------------------------------------------------ (d)
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        text = r.read().decode()
        for fam in DEVICE_FAMILIES:
            check(f"# TYPE {fam} " in text, f"phase 16 (d): {fam} missing from /metrics")
        dispatches = {dict(k).get("kernel"): v
                      for k, v in metric_series(text, "tempo_tpu_device_dispatches_total").items()
                      if k}
        stats = {k: float(v) for k, v in dict(devicetiming.STATS.dispatches).items()}
        check(dispatches == stats, f"phase 16 (d): dispatches_total {dispatches} != STATS {stats}")
        tb = metric_series(text, "tempo_tpu_device_transfer_bytes_total")
        for direction in ("h2d", "d2h"):
            exposed = {dict(k)["kernel"]: v for k, v in tb.items()
                       if dict(k).get("direction") == direction}
            stats = {k: float(v) for k, v in dict(getattr(devicetiming.STATS, direction)).items()}
            check(exposed == stats, f"phase 16 (d): transfer_bytes_total {direction} != STATS")
        res["exactness"] = dict(moved=moved1 - moved0, charged=charged1 - charged0)
        check(moved1 > moved0, "phase 16 (d): (c) moved no device bytes")
        check(moved1 - moved0 == charged1 - charged0,
              f"phase 16 (d): h2d + d2h moved {moved1 - moved0} B over (c) but the tenants' "
              f"transfer_bytes moved {charged1 - charged0} B")
        res["device_kernels"] = sorted(dispatches)
        print(f"phase 16 (d) /metrics: the four device families present, dispatches_total == "
              f"STATS for {len(dispatches)} kernel labels ({', '.join(sorted(dispatches))}); over "
              f"(c) h2d + d2h {moved1 - moved0:.0f} B == the tenants' transfer_bytes "
              f"{charged1 - charged0:.0f} B", flush=True)
        conn.close()

        # ------------------------------------------------------- (c) CLI
        outs = {name: cli_result(name) for name in cli_runs if name != "convert to vrow1"}
        check(all(i in outs["list blocks"] for i in ids), "phase 16 (c): cli list blocks")
        want = otlp.encode_traces_json([db_loc.find(tenant, present[0])])
        check(json.loads(outs["query trace-id"]) == json.loads(json.dumps(want)),
              "phase 16 (c): cli query trace-id != TempoDB.find")
        hits = [json.loads(x) for x in outs["query search"].splitlines()]
        check(len(hits) == 20 and all(h["traceID"].zfill(32) in with_service((a, b), svc)
                                      for h in hits), "phase 16 (c): cli query search")
        check({k: v for k, v in stored_objects(bloom_root, tenant, ids[1]).items()
               if k.startswith("bloom")} == blooms,
              "phase 16 (c): cli gen bloom on the card != the written blooms")
        if not shed:
            back_id = re.findall(r"-> (\S+) \(vtpu1\)", outs["convert to vtpu1"])[0]
            check(block_objects(conv_root, tenant, back_id, drop_id=True)
                  == block_objects(conv_root, tenant, src_id, drop_id=True),
                  "phase 16 (c): cli convert vtpu1 -> vrow1 -> vtpu1 != the source block")
        print("phase 16 (c) cli: " + ", ".join(f"{k} {v:.1f} s" for k, v in res["cli_s"].items())
              + " (each a process from start to exit; the converts beside (b), the others "
              "beside (c)'s readers)", flush=True)
    finally:
        gzip.time = gzip_time
        for fn in closers:
            fn()
        for m in mocks:
            m.stop()
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# phase 17: the mesh
# ---------------------------------------------------------------------------

SHED17_S = 1040
MESH_KERNELS = ("rle_cols_hit", "seg_bincount", "hll_update", "cm_update")
MESH_LABELS = ("mesh_scan", "mesh_rle_scan", "batched_rle_scan", "mesh_bincount")
# phase 17 (c)'s searches: the service column is rle (the run road), name
# dct (an expanded column: the tag-scan road); each narrowed by duration
MESH_SEARCHES = [
    ("service=cart", dict(tags={"service": "cart"}, min_duration_ns=990_000_000)),
    ("service=frontend name=db.query", dict(tags={"service": "frontend", "name": "db.query"},
                                           min_duration_ns=900_000_000)),
]
MESH_SERVICES = ("frontend", "cart", "checkout", "currency", "shipping", "payment", "email", "ads")


# the kernels each step of phase 17 must launch in its mesh calls: the
# sharded sketches in (a) and in both mesh compactions of (b), the run road
# in (c), the per-shard bincount in (d)
MESH_STEP_KERNELS = {"a": ("hll_update", "cm_update"), "b": ("hll_update", "cm_update"),
                     "c": ("rle_cols_hit",), "d": ("seg_bincount",)}


def check_mesh_launches(res: dict, what: str) -> None:
    for k in MESH_KERNELS:
        check(res["launches"][k] > 0, f"{what}: {k} never launched")
    for step_label, names in MESH_STEP_KERNELS.items():
        for k in names:
            check(res["launches_by_step"].get(step_label, {}).get(k, 0) > 0,
                  f"{what}: {k} never launched in phase 17 ({step_label})'s mesh calls")


def _hits(resp) -> list:
    """A search answer's traces, each with every field, in one order."""
    import dataclasses

    return sorted(dataclasses.astuple(h) for h in resp.traces)


def mesh_phase(seed: int, root: str, a, b, src_blocks: str, queries: list, plan_of,
               batches: list, step=None, devices=None, dev: str = "cuda",
               step_rows: int = 1 << 22, pair_spans: int = 1 << 17, shed: bool = False) -> dict:
    """Phase 17, the mesh. Every mesh is built over `devices` (default four
    copies of the one card: each shard's launches queue on it; a list of
    distinct cards meshes them). (a) the sharded compaction step over
    phase 3's rows split by partition_by_id_range on a (1, 4) mesh: the
    bloom, HLL, count-min and totals equal the one-device step's (`step`
    = (fn, inputs, out) of phase 3, or built here), both timed by host
    clock around a synchronised call, median of 3, in turns. (b)
    VtpuCompactor with a compaction mesh, payload on the host and on the
    device, over a 2**17-span pair written here (every 8th trace of A and
    of B): both blocks byte-equal to the one-device card merge; duplicates
    collapsed, finds, payload_stats. (c) MeshSearcher over src_blocks (a
    local backend holding phase 6's card-written A and B): search_blocks
    and search_blocks_multi at Q 1 and 8, limit 20 and unbounded, on
    get_mesh's (2, 2) and on (1, 4), shipped, then admitting and resident
    in a 1,024-MB device tier (admission forced open); every unbounded answer equal to the
    one-device DB's, every limited one a whole subset of it. (d)
    MeshMetricsEvaluator over src_blocks for phase 4's queries, counts
    bit-equal to the one-device accumulator, and the mesh bincount over
    `batches`' slots (phase 4's spans) against the one-device accumulator.
    (f) TempoDB over the pair with the mesh from parallel/mesh's seam
    (local_devices patched to `devices`): search, search_multi, the
    querier's search_block_batch(_multi) and query_range_blocks equal to
    a one-device DB's, compact_once byte-equal to (b)'s one-device merge.
    Past `shed` (2, 2)'s repeat of (c) is shed. The launch counts are set
    to 0 just before each mesh call and read just after it; the one-device
    runs the mesh is held against run outside those windows. Returns its
    numbers, the launches on the mesh path summed (`launches`) and by step
    (`launches_by_step`)."""
    import numpy as np
    import torch

    from tempo_tpu_torch import metrics_engine as M
    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.config_sections import DeviceTierConfig
    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions, SearchRequest
    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
    from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
    from tempo_tpu_torch.encoding.vtpu.create import write_block
    from tempo_tpu_torch.entry import entry
    from tempo_tpu_torch.modules.querier import Querier
    from tempo_tpu_torch.ops import pallas_kernels as pk
    from tempo_tpu_torch.parallel import compaction as pcomp
    from tempo_tpu_torch.parallel import mesh as pmesh
    from tempo_tpu_torch.parallel.metrics import MeshMetricsEvaluator, make_sharded_bincount
    from tempo_tpu_torch.parallel.search import MeshSearcher
    from tempo_tpu_torch.util import metrics as umetrics

    t_phase = time.perf_counter()
    card = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    devices = [torch.device(d) for d in (devices or [card] * 4)]
    tenant = "smoke"
    cfg = BlockConfig()
    res: dict = {"devices": [str(d) for d in devices], "ms": {}, "shed": shed}
    print(f"phase 17 mesh: {torch.cuda.device_count() if dev == 'cuda' else 0} card(s); "
          f"meshes over {res['devices']}", flush=True)

    def sync():
        for d in set(devices) | {card}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    launches: dict = {}
    by_step: dict = {}

    @contextlib.contextmanager
    def on_mesh(step_label):
        """One window of the mesh path: counts from 0 before, read after."""
        reset_launches()
        yield
        for k, v in read_launches().items():
            launches[k] = launches.get(k, 0) + v
            if v:
                step_counts = by_step.setdefault(step_label, {})
                step_counts[k] = step_counts.get(k, 0) + v

    # ------------------------------------------------------------ (a)
    t0 = time.perf_counter()
    if step is None:
        fn, ex = entry(device=dev, n_rows=step_rows)
        out = fn(*ex)
    else:
        fn, ex, out = step
    plans = fn.keywords["plans"]
    valid = ex[2].cpu().numpy()
    tids = ex[0].cpu().numpy().astype(np.uint32)[valid]
    sids = ex[1].cpu().numpy().astype(np.uint32)[valid]
    m14 = pmesh.compaction_mesh(4, devices=devices)
    t4, s4, v4, _ = pcomp.partition_by_id_range(tids, sids, 4)
    cap = t4.shape[1]
    # the shards' rows staged on the mesh's lead device once, as phase 3's
    # step finds its rows on the card
    staged = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(devices[0])
              for x in (t4.reshape(1, 4, cap, 4), s4.reshape(1, 4, cap, 2), v4.reshape(1, 4, cap))]
    mstep = pcomp.make_sharded_compactor(m14, plans)

    def mesh_call():
        with on_mesh("a"):
            return mstep(*staged, *pcomp.init_sketch_accumulators(m14, plans))

    _, accs = mesh_call()
    for key, got in (("bloom", accs["bloom"][0]), ("hll", accs["hll"][0]), ("cm", accs["cm"][0]),
                     ("n_rows", accs["total_rows"][0]), ("n_traces", accs["total_traces"][0])):
        check(torch.equal(got.cpu().to(torch.int64), out[key].cpu().to(torch.int64)),
              f"phase 17 (a): the mesh step's {key} != the one-device step's")
    times = {"mesh": [], "one": []}
    for which in "momoom":
        sync()
        t1 = time.perf_counter()
        if which == "m":
            mesh_call()
        else:
            fn(*ex)
        sync()
        times["mesh" if which == "m" else "one"].append(time.perf_counter() - t1)
    res["step"] = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    res["step_all_ms"] = {k: [x * 1e3 for x in v] for k, v in times.items()}
    del staged
    print(f"phase 17 (a) sharded step: {len(tids)} rows over a (1, 4) mesh ({cap} rows a shard): "
          f"bloom, hll, cm, total_rows {int(accs['total_rows'][0])}, total_traces "
          f"{int(accs['total_traces'][0])} == the one-device step's | mesh "
          f"{res['step']['mesh']:.2f} ms, one device {res['step']['one']:.2f} ms (median of 3, "
          f"in turns) | {time.perf_counter() - t0:.1f} s", flush=True)

    # ------------------------------------------------------------ (b)
    t0 = time.perf_counter()
    pair_root = os.path.join(root, "pair")
    be = TypedBackend(LocalBackend(pair_root))
    # every 8th trace of A and of B: pairs spanning the whole ID space (a
    # block's first 2**17 spans hold its lowest IDs, which one shard of
    # partition_by_id_range would take alone); A's every 8th trace is the
    # set B repeats, so the pair shares traces
    small, small_b = (x.select(np.flatnonzero(x.trace_boundaries()[1] % 8 == 0)[:pair_spans])
                      for x in (a, b))
    metas = [write_block([x], tenant, be, cfg, block_id=str(uuid.uuid4()), device=dev)
             for x in (small, small_b)]
    distinct = len(np.unique(np.concatenate([small.cols["trace_id"], small_b.cols["trace_id"]]),
                             axis=0))
    outs, comps, cms = {}, {}, {}
    for label, kw in (("one device", {}),
                      ("mesh, host payload", {"mesh": m14}),
                      ("mesh, device payload", {"mesh": m14, "payload_plane": "device"})):
        comp = comps[label] = VtpuCompactor(CompactionOptions(block_config=cfg, **kw), device=dev)
        with on_mesh("b") if kw else contextlib.nullcontext():
            t1 = time.perf_counter()
            (outs[label],) = comp.compact(metas, tenant, be)
            cms[label] = (time.perf_counter() - t1) * 1e3
        check(outs[label].total_objects == distinct,
              f"phase 17 (b) {label}: {outs[label].total_objects} traces, {distinct} distinct")
    ref = block_objects(pair_root, tenant, outs["one device"].block_id, drop_id=True)
    for label in ("mesh, host payload", "mesh, device payload"):
        check_same_blocks(block_objects(pair_root, tenant, outs[label].block_id, drop_id=True),
                          ref, f"phase 17 (b) {label} vs one device")
    st = comps["mesh, device payload"].payload_stats
    od = outs["mesh, device payload"]
    check(st["d2h_flushes"] <= od.total_records + 1 and st["kept_rows"] == od.total_spans,
          f"phase 17 (b): payload_stats {st}")
    blk = VtpuBackendBlock(od, be, cfg)
    firsts = small.trace_boundaries()[0]
    for limbs in small.cols["trace_id"][firsts[:: max(1, len(firsts) // 20)]]:
        t = blk.find_trace_by_id(limbs.astype(">u4").tobytes())
        check(t is not None and t.span_count() == 8, "phase 17 (b): a trace not found whole")
    res["compact_ms"] = cms
    res["payload_stats"] = {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in st.items()}
    res["sharded_stats"] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                            for k, v in comps["mesh, host payload"].payload_stats.items()}
    print(f"phase 17 (b) VtpuCompactor: the {pair_spans}-span pair, {distinct} distinct traces: "
          "mesh host payload and mesh device payload blocks byte-equal to the one-device card "
          f"merge; finds whole | ms {', '.join(f'{k} {v:.0f}' for k, v in cms.items())} | device "
          f"plane: {st['d2h_flushes']} flushes, {st['kept_rows']} kept rows, {st['dropped_rows']} "
          f"dropped, {st['tiles']} tiles | {time.perf_counter() - t0:.1f} s", flush=True)

    # ------------------------------------------------------------ (c)
    t0 = time.perf_counter()
    src_be = TypedBackend(LocalBackend(src_blocks))
    one_db = TempoDB(DBConfig(backend="local", backend_path=src_blocks,
                              compaction_device_shards=1), device=dev)
    one_db.poll_now()
    src_metas = one_db.blocklist.metas(tenant)
    check(len(src_metas) == 2, f"phase 17 (c): {len(src_metas)} source blocks")

    def src_blocks_iter():
        return (VtpuBackendBlock(m, src_be, cfg) for m in src_metas)

    reqs = [(label, SearchRequest(**kw)) for label, kw in MESH_SEARCHES]
    multi = [SearchRequest(tags={"service": s}, min_duration_ns=995_000_000)
             for s in MESH_SERVICES]
    want = {label: _hits(one_db.search(tenant, SearchRequest(limit=0, **kw)))
            for label, kw in MESH_SEARCHES}
    want_multi = [_hits(one_db.search(tenant, SearchRequest(limit=0, tags=r.tags,
                                                            min_duration_ns=r.min_duration_ns)))
                  for r in multi]
    one_db.shutdown()
    check(all(want.values()) and all(want_multi), "phase 17 (c): an empty one-device answer")

    def held(got, whole, limit, what):
        hits = _hits(got)
        if limit:
            check(len(hits) == min(limit, len(whole)) and set(hits) <= set(whole),
                  f"phase 17 (c) {what}: not a whole subset of the one-device answer")
        else:
            check(hits == whole, f"phase 17 (c) {what}: != the one-device answer")
        return hits

    shapes = [("(1, 4)", m14)] if shed else [("(2, 2)", pmesh.get_mesh(4, devices=devices)),
                                             ("(1, 4)", m14)]
    limited: dict = {}
    res["search_ms"] = {}
    tier = None
    for rnd in ("shipped", "admitting", "resident"):
        if rnd == "admitting":
            tier = colcache.configure_device_tier(DeviceTierConfig(budget_mb=1024), device=dev)
            # admission forced open, as the tier's own tests force it: the
            # page-heat policy (phase 10's) ranks the searches' decoded
            # metadata pages above the service runs a stack needs, and a
            # stack is admitted only when every page of it is
            tier.should_admit = lambda page_keys: True
        for shape_label, mesh in shapes:
            searcher = MeshSearcher(mesh, cfg.bucket_for)
            for limit in (20, 0):
                for label, r in reqs:
                    colcache.shared_cache().clear()
                    rq = SearchRequest(tags=r.tags, min_duration_ns=r.min_duration_ns, limit=limit)
                    with on_mesh("c"):
                        t1 = time.perf_counter()
                        got = searcher.search_blocks(src_blocks_iter(), rq)
                        res["search_ms"][f"{rnd} {shape_label} {label} limit {limit}"] = \
                            (time.perf_counter() - t1) * 1e3
                    hits = held(got, want[label], limit, f"{rnd} {shape_label} {label}")
                    if limit:  # the same chunks at every 4-shard shape and round
                        check(limited.setdefault(label, hits) == hits,
                              f"phase 17 (c) {label} limit 20: answers differ across runs")
                for q in (1, 8):
                    rq = [SearchRequest(tags=r.tags, min_duration_ns=r.min_duration_ns,
                                        limit=limit) for r in multi[:q]]
                    colcache.shared_cache().clear()
                    with on_mesh("c"):
                        t1 = time.perf_counter()
                        gots = searcher.search_blocks_multi(src_blocks_iter(), rq)
                        res["search_ms"][f"{rnd} {shape_label} multi Q={q} limit {limit}"] = \
                            (time.perf_counter() - t1) * 1e3
                    for i, got in enumerate(gots):
                        held(got, want_multi[i], limit, f"{rnd} {shape_label} multi Q={q} #{i}")
        if tier is not None:
            res.setdefault("tier", {})[rnd] = tier.stats()
    check(tier.hits > 0, "phase 17 (c): no stack was served resident")
    check(any(k[0] == "mesh_stack" for k in tier._lru), "phase 17 (c): no resident mesh stack")
    res["tier_avoided_bytes"] = tier.avoided_bytes
    colcache.configure_device_tier(None, device=dev)
    print(f"phase 17 (c) MeshSearcher over 2 x {src_metas[0].total_spans} spans on "
          f"{', '.join(s for s, _ in shapes)}: {len(reqs)} searches and multi Q=1/8 at limit 20 "
          "and unbounded, shipped, admitting and resident == the one-device DB (limited: a whole "
          f"subset, equal across shapes and rounds) | tier {res['tier']['resident']}, avoided "
          f"{tier.avoided_bytes} B | {time.perf_counter() - t0:.1f} s", flush=True)

    # ------------------------------------------------------------ (d)
    t0 = time.perf_counter()
    res["metrics"] = []
    for q in queries:
        plan = plan_of(q)
        one = M.make_accumulator(plan, device=dev)
        for m in src_metas:
            M.evaluate_block(plan, VtpuBackendBlock(m, src_be, cfg), one)
        acc = M.HostAccumulator(plan)
        ev = MeshMetricsEvaluator(m14, cfg.bucket_for)
        with on_mesh("d"):
            t1 = time.perf_counter()
            ev.evaluate_blocks(src_blocks_iter(), plan, acc)
            ms = (time.perf_counter() - t1) * 1e3
        check(np.array_equal(acc.counts, one.merged_counts()),
              f"phase 17 (d) {q}: mesh counts != the one-device accumulator's")
        check(acc.to_wire()["series"] == one.to_wire()["series"] and acc.counts.any(),
              f"phase 17 (d) {q}: wire differs or empty")
        res["metrics"].append({"query": q, "ms": ms, **ev.last_stats})
    # the mesh bincount over phase 4's spans, a batch a shard
    plan = plan_of(queries[-1])
    one = M.make_accumulator(plan, device=dev)
    run = make_sharded_bincount(m14, plan.n_slots)
    total = np.zeros(plan.n_slots, np.int64)
    for i in range(0, len(batches), 4):
        group = []
        for bt in batches[i:i + 4]:
            r = M.eval_batch(plan, bt, bt.dictionary, one.series)
            one.add(r)
            s, w = pk.compress_slot_runs(r.slots[r.slots >= 0])
            group.append((s, np.ones(len(s), np.int32) if w is None else w))
        pad = max(len(s) for s, _ in group)
        sl = np.full((4, pad), -1, np.int32)
        wl = np.zeros((4, pad), np.int32)
        for j, (s, w) in enumerate(group):
            sl[j, :len(s)], wl[j, :len(s)] = s, w
        with on_mesh("d"):
            total += run(sl.reshape(1, 4, pad), wl.reshape(1, 4, pad)).sum(axis=0)
    check(np.array_equal(total, one.merged_counts()) and total.any(),
          "phase 17 (d): the mesh bincount over phase 4's spans != the one-device accumulator")
    res["metrics_spans"] = sum(bt.num_spans for bt in batches)
    eval_ms = ", ".join(f"{r['ms']:.0f}" for r in res["metrics"])
    print(f"phase 17 (d) MeshMetricsEvaluator: {len(queries)} queries over the 2 blocks == the "
          f"one-device accumulator ({eval_ms} ms; "
          f"{[r['dispatches'] for r in res['metrics']]} dispatches); the mesh bincount over "
          f"{res['metrics_spans']} spans of phase 4 == it | {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ------------------------------------------------------------ (f)
    t0 = time.perf_counter()
    # the default compaction_device_shards = 0 takes every device the seam
    # reports; here the seam reports the phase's device list
    seam = pmesh.local_devices
    pmesh.local_devices = lambda device: list(devices)
    try:
        mdb = TempoDB(DBConfig(backend="local", backend_path=pair_root), device=dev)
        mesh_f = mdb.compaction_mesh()
    finally:
        pmesh.local_devices = seam
    one_db = TempoDB(DBConfig(backend="local", backend_path=pair_root,
                              compaction_device_shards=1), device=dev)
    try:
        check(mesh_f is not None and mesh_f.size == len(devices),
              "phase 17 (f): the DB built no mesh through the seam")
        for d in (mdb, one_db):
            d.blocklist.update(tenant, adds=metas)
        ids = [m.block_id for m in metas]
        mq, oq = Querier(mdb), Querier(one_db)
        f_reqs = [SearchRequest(limit=0, **kw) for _, kw in MESH_SEARCHES] + \
            [SearchRequest(tags={"service": s}, min_duration_ns=990_000_000, limit=0)
             for s in MESH_SERVICES[:3]]
        for r in f_reqs:
            w = _hits(one_db.search(tenant, r))
            with on_mesh("f"):
                got_db = mdb.search(tenant, r)
                got_q = mq.search_block_batch(tenant, ids, r)
            check(_hits(got_db) == w, f"phase 17 (f) db.search {r.tags}")
            check(_hits(got_q) == w, f"phase 17 (f) search_block_batch {r.tags}")
        with on_mesh("f"):
            gots_db = mdb.search_multi(tenant, f_reqs)
            gots_q = mq.search_block_batch_multi(tenant, ids, f_reqs)
        for got, r in zip(gots_db, f_reqs):
            check(_hits(got) == _hits(one_db.search(tenant, r)), "phase 17 (f) search_multi")
        for got, r in zip(gots_q, f_reqs):
            check(_hits(got) == _hits(oq.search_block_batch(tenant, ids, r)),
                  "phase 17 (f) search_block_batch_multi")
        for q in queries[1:]:  # the compiled tier or a step-partial rule takes none of these
            with on_mesh("f"):
                t1 = time.perf_counter()
                got = mq.query_range_blocks(tenant, ids, q, BASE_S, BASE_S + 3600, 60)
                res["ms"][f"query_range {q}"] = (time.perf_counter() - t1) * 1e3
            want_w = oq.query_range_blocks(tenant, ids, q, BASE_S, BASE_S + 3600, 60)
            check(got["series"] == want_w["series"] and got["series"],
                  f"phase 17 (f) query_range_blocks {q}")
        with on_mesh("f"):
            t1 = time.perf_counter()
            n_compacted = mdb.compact_once(tenant)
            res["ms"]["compact_once"] = (time.perf_counter() - t1) * 1e3
        check(n_compacted == 1, "phase 17 (f): compact_once")
        (merged,) = mdb.blocklist.metas(tenant)
        check_same_blocks(block_objects(pair_root, tenant, merged.block_id, drop_id=True), ref,
                          "phase 17 (f) compact_once over the mesh vs (b)'s one-device merge")
    finally:
        mdb.shutdown()
        one_db.shutdown()
    text = umetrics.expose()
    series = metric_series(text, "tempo_tpu_device_dispatches_total")
    labels = {dict(k).get("kernel"): v for k, v in series.items()}
    for k in MESH_LABELS:
        check(labels.get(k, 0) > 0, f"phase 17: /metrics has no dispatches of {k}")
    res["dispatches"] = {k: labels[k] for k in MESH_LABELS}
    print(f"phase 17 (f) TempoDB through the seam ({mesh_f.shape}): search, "
          "search_multi, search_block_batch(_multi), query_range_blocks == a one-device DB; "
          f"compact_once byte-equal to (b) | /metrics dispatches {res['dispatches']} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    res["launches"] = launches
    res["launches_by_step"] = by_step
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# (label, U, Q, C, RP, K, n, lengths) of phase 17 (e)'s edge cases, as
# tests/test_torch_rle_cols_hit.py's EDGES: more runs than one staged run
# tile, more lanes than one lane word, three columns, a run a row (lengths
# None) with run_pad above and below n, several units
RLE_EDGES = [
    ("one-row runs past a tile", 1, 2, 1, 16384, 8, 16384, "ones"),
    ("zero-length runs mixed, rows past the total", 1, 1, 1, 32768, 8, 40000, "zero-mixed"),
    ("zero-length runs mixed, runs cut at n", 1, 3, 1, 32768, 8, 12000, "zero-mixed"),
    ("33 lanes", 1, 33, 2, 40, 8, 300, "random"),
    ("64 lanes", 1, 64, 2, 40, 8, 300, "random"),
    ("three columns", 2, 5, 3, 300, 16, 5000, "random"),
    ("a run a row, run_pad above n", 1, 4, 2, 700, 8, 500, None),
    ("a run a row, run_pad below n", 1, 4, 2, 300, 8, 500, None),
    ("several units", 5, 3, 2, 64, 8, 777, "random"),
]


def rle_lanes_case(rng, U, Q, C, RP, K, n, lengths):
    """A seeded (values, lengths or None, codes, live, hit) of
    rle_hit_lanes' shapes: values in 0..7 with some NO_MATCH, three codes a
    lane and column scattered among NO_MATCH paddings."""
    import numpy as np

    values = rng.integers(0, 8, (U, C, RP)).astype(np.uint32)
    values[rng.random((U, C, RP)) < 0.1] = 0xFFFFFFFF
    if lengths is None:
        lens = None
    elif lengths == "ones":
        lens = np.ones((U, C, RP), np.int32)
    elif lengths == "zero-mixed":
        lens = rng.integers(0, 3, (U, C, RP)).astype(np.int32)
    else:
        lens = rng.integers(0, max(2, 2 * n // RP), (U, C, RP)).astype(np.int32)
    codes = np.full((U, Q, C, K), 0xFFFFFFFF, np.uint32)
    for idx in np.ndindex(U, Q, C):
        at = rng.choice(K, size=min(3, K), replace=False)
        codes[idx][at] = rng.integers(0, 8, len(at))
    return values, lens, codes, rng.random((U, Q, C)) < 0.8, rng.random((U, n)) < 0.9


def kernels_in_trace(torch, fn) -> list:
    """The names of the kernels fn() launches, from a torch.profiler trace
    of one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def rle_timed_shapes(src_blocks: str) -> list:
    """Phase 17 (e)'s four timed shapes of rle_cols_hit, from the first
    block of tenant smoke under src_blocks (block A): [(key, text, values,
    lengths or None, codes, live or None, hit or None, n)], uint32 values
    and codes, 64 codes a lane with the first of MESH_SERVICES' codes real.
    "Q=1": the first row group's service runs padded to a power of two,
    n = its bucket, hit its valid rows (a mesh shard's unit); "Q=8": the
    same unit at 8 lanes of 1-8 services, the last lane's column dead (a
    batched dispatch); "U=16": the first 16 row groups' service runs in one
    call, no hit (fused_rle_in_set's batch); "run a row": the first row
    group's column expanded to 32,768 rows, a run a row (the mesh tag
    scan)."""
    import numpy as np

    from tempo_tpu_torch.backend import LocalBackend, TypedBackend
    from tempo_tpu_torch.db import DBConfig, TempoDB
    from tempo_tpu_torch.encoding.common import BlockConfig
    from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock

    cfg = BlockConfig()
    db = TempoDB(DBConfig(backend="local", backend_path=src_blocks, compaction_device_shards=1),
                 device="cpu")
    db.poll_now()
    meta = db.blocklist.metas("smoke")[0]
    db.shutdown()
    blk = VtpuBackendBlock(meta, TypedBackend(LocalBackend(src_blocks)), cfg)
    rgs = blk.index().row_groups[:16]
    runs = [blk.encoded_column(g, "service").runs() for g in rgs]
    K = 64
    d = blk.dictionary()
    svc = [d.get(s) for s in MESH_SERVICES]

    def stack(units):
        rp = 1 << (max(8, max(len(x[1]) for x in units)) - 1).bit_length()
        values = np.full((len(units), 1, rp), 0xFFFFFFFF, np.uint32)
        lengths = np.zeros((len(units), 1, rp), np.int32)
        for i, (v, ln) in enumerate(units):
            values[i, 0, :len(v)], lengths[i, 0, :len(ln)] = v, ln
        return values, lengths, rp

    values, lengths, rp = stack(runs[:1])
    n = cfg.bucket_for(rgs[0].n_spans)
    codes1 = np.full((1, 1, 1, K), 0xFFFFFFFF, np.uint32)
    codes1[0, 0, 0, :2] = svc[:2]
    codes8 = np.full((1, 8, 1, K), 0xFFFFFFFF, np.uint32)
    for q in range(8):
        codes8[0, q, 0, : q + 1] = svc[: q + 1]
    live8 = np.ones((1, 8, 1), bool)
    live8[0, 7, 0] = False  # a dead column: every row
    valid = np.zeros((1, n), bool)
    valid[0, : rgs[0].n_spans] = True
    values16, lengths16, rp16 = stack(runs)
    n16 = max(cfg.bucket_for(g.n_spans) for g in rgs)
    v0, l0 = runs[0]
    rows = np.repeat(np.asarray(v0, np.uint32), np.asarray(l0, np.int64))[:32768]
    row_vals = np.concatenate([rows, np.full(32768 - len(rows), v0[-1], np.uint32)])
    row_valid = np.zeros((1, 32768), bool)
    row_valid[0, : rgs[0].n_spans] = True
    unit = f"U=1 C=1 runs={len(l0)} (run_pad {rp}) K={K} n={n}"
    return [
        ("Q=1", f"{unit} Q=1", values, lengths, codes1, None, valid, n),
        ("Q=8", f"{unit} Q=8", values, lengths, codes8, live8, valid, n),
        ("U=16", f"U={len(rgs)} (block A's first row groups) C=1 runs="
         f"{sum(len(x[1]) for x in runs)} (run_pad {rp16}) K={K} n={n16} Q=1, no hit",
         values16, lengths16, np.repeat(codes1, len(rgs), axis=0), None, None, n16),
        ("run a row", f"U=1 C=1 a run a row (run_pad 32768) K={K} n=32768 Q=1",
         row_vals[None, None], None, codes1, None, row_valid, 32768),
    ]


def rle_trace_child(path: str) -> None:
    """The kernels one rle_hit_lanes call launches at each of the timed
    shapes pickled at `path`, each from a torch.profiler trace of one call
    after a warm one; prints {key: [kernel names]} as JSON. rle_kernel_check
    runs it in a process of its own: there the profiler sees the card,
    where a window that an App's thread ran earlier in the smoke's process
    may leave a later one in the main thread without device events."""
    import numpy as np
    import torch

    from tempo_tpu_torch.ops import pallas_kernels as pk

    with open(path, "rb") as f:
        shapes = pickle.load(f)
    out = {}
    for key, _text, values, lengths, codes, live, hit, n in shapes:
        args = [None if x is None else torch.from_numpy(np.ascontiguousarray(
            x.view(np.int32) if x.dtype == np.uint32 else x)).cuda()
            for x in (values, lengths, codes, live, hit)]

        def call(args=args, n=n):
            return pk.rle_hit_lanes(args[0], args[1], args[2], n, live=args[3], hit=args[4])

        call()
        torch.cuda.synchronize()
        out[key] = kernels_in_trace(torch, call)
    print(json.dumps(out))


def rle_kernel_check(torch, dev, lib, stream, src_blocks: str, rng) -> dict:
    """Phase 17 (e): rle_cols_hit against its plain version at a mesh
    search's shard shape (block A's first row group's service runs,
    padded to a power of two, n = its bucket) in-set, live and batched at
    Q = 8, over padding (zero-length NO_MATCH runs; runs short of n) and
    truncation (runs past n), at the one-launch design's edges (RLE_EDGES)
    and, held against run 0's verdict, behind a first run of 2^31 - 1 rows;
    then, at four shapes (the shard's unit at Q = 1 and Q = 8, block A's
    first 16 row groups in one call as fused_rle_in_set batches them, and
    the first row group's column expanded to a run a row at run_pad 32,768
    as the mesh tag scan takes it), one call is one launch (the wrapper's
    count and a torch.profiler trace) and kernel, path, plain, the torch
    chain and the wrapper's host time a call are timed."""
    import numpy as np

    from tempo_tpu_torch.ops import _build
    from tempo_tpu_torch.ops import pallas_kernels as pk

    shapes = rle_timed_shapes(src_blocks)
    _, _, values, lengths, codes1, _, valid, n = shapes[0]
    codes8, live8 = shapes[1][4], shapes[1][5]
    rp, K = values.shape[2], codes1.shape[3]
    n_real = int(np.count_nonzero(lengths))  # the unit's runs before its padding
    res: dict = {"cases": 0}

    def tt(x):
        return None if x is None else torch.from_numpy(
            x.astype(np.int64) if x.dtype == np.uint32 else x)

    def case(values_, lengths_, codes_, live_, hit_, n_, label, want=None):
        args = [tt(x) for x in (values_, lengths_, codes_, live_, hit_)]
        if want is None:
            want = pk.rle_hit_lanes(args[0], args[1], args[2], n_, live=args[3], hit=args[4])
        before = pk.rle_cols_hit.launches
        got = pk.rle_hit_lanes(*(None if x is None else x.to(dev) for x in args[:3]), n_,
                               live=None if args[3] is None else args[3].to(dev),
                               hit=None if args[4] is None else args[4].to(dev))
        check(pk.rle_cols_hit.launches == before + 1,
              f"phase 17 (e) rle_cols_hit {label}: not one launch a call")
        pk.rle_cols_hit.launches = before  # the comparison's launches are not the path's
        check(torch.equal(got.cpu(), want), f"phase 17 (e) rle_cols_hit {label}: kernel != plain")
        res["cases"] += 1
        return got

    case(values, lengths, codes1, None, valid, n, "in-set")
    case(values, lengths, codes8, live8, valid, n, "batched Q=8 with live")
    case(values, None, codes1, None, None, rp, "a run a row")
    short = lengths.copy()
    short[0, 0, :n_real // 2] = 0  # zero-length runs: rows past the total
    case(values, short, codes8, live8, None, n, "padding")
    long_ = lengths.copy()
    long_[0, 0, 0] = n + 5  # the first run overruns n: every later one is cut
    case(values, long_, codes8, live8, valid, n, "truncation")
    sent = values.copy()
    sent[0, 0, 1] = 0xFFFFFFFF
    case(sent, lengths, codes8, live8, valid, n, "a NO_MATCH value")
    for u, q, c in ((3, 2, 2), (2, 8, 3)):
        vv = rng.integers(0, 8, (u, c, 300)).astype(np.uint32)
        ll = rng.integers(0, 40, (u, c, 300)).astype(np.int32)
        cc = np.full((u, q, c, 16), 0xFFFFFFFF, np.uint32)
        cc[..., :3] = rng.integers(0, 8, (u, q, c, 3))
        case(vv, ll, cc, rng.random((u, q, c)) < 0.7, rng.random((u, 5000)) < 0.9, 5000,
             f"units {u} lanes {q} columns {c}")
    for label, U, Q, C, RP, KK, nn, kind in RLE_EDGES:
        vv, ll, cc, lv, ht = rle_lanes_case(np.random.default_rng(RP + 7 * Q + nn), U, Q, C, RP,
                                            KK, nn, kind)
        case(vv, ll, cc, lv, ht, nn, label)
        case(vv, ll, cc, None, None, nn, f"{label}, no live or hit")
    # a first run of 2^31 - 1 rows covers every row: the later runs' starts
    # saturate at n; held against run 0's verdict (the plain version would
    # expand 2^31 rows)
    sat_v = rng.integers(0, 8, (1, 1, 9000)).astype(np.uint32)
    sat_v[0, 0, 0] = 6
    sat_l = rng.integers(0, 1000, (1, 1, 9000)).astype(np.int32)
    sat_l[0, 0, 0] = 2**31 - 1
    sat_c = np.full((1, 3, 1, 8), 0xFFFFFFFF, np.uint32)
    sat_c[0, 0, 0, :2], sat_c[0, 1, 0, :2], sat_c[0, 2, 0, :2] = (6, 1), (1, 2), (1, 2)
    sat_live = np.array([[[True], [True], [False]]])
    sat_hit = rng.random((1, 5000)) < 0.7
    sat_want = torch.from_numpy(np.stack([sat_hit[0], np.zeros(5000, bool), sat_hit[0]])[None])
    case(sat_v, sat_l, sat_c, sat_live, sat_hit, 5000, "a saturated first run", want=sat_want)

    r = _build.ptxas_report().get("rle_cols_hit_kernel", {})
    res["ptxas"] = r
    print(f"phase 17 (e) rle_cols_hit_kernel: {r.get('registers')} registers, "
          f"{r.get('smem_static')} B static smem, spills {r.get('spill_stores')} B stored / "
          f"{r.get('spill_loads')} B loaded; dynamic smem 8 B a run of its tile (up to 8,192: "
          "values and lengths) + 8 B a (lane, code) of its lane group (32 x 64 codes: "
          "16,384 B); each thread's 16 rows' lane words in registers", flush=True)

    # one launch a call in a torch.profiler trace, in a process of its own
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rle_") as d:
        path = os.path.join(d, "shapes.pkl")
        with open(path, "wb") as f:
            pickle.dump(shapes, f)
        got = subprocess.run(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
             f"chip_smoke.rle_trace_child({path!r})"],
            cwd=here, capture_output=True, text=True, timeout=300)
    check(got.returncode == 0, f"phase 17 (e) the traced calls failed: {got.stderr[-2000:]}")
    traced = json.loads(got.stdout.strip().splitlines()[-1])
    for key, shape, vals_, lens_, codes_, live_, hit_, n_ in shapes:
        U, q = codes_.shape[:2]
        rp_ = vals_.shape[2]
        case(vals_, lens_, codes_, live_, hit_, n_, f"timed shape {key}")
        # the uint32 inputs as the bits of int32 tensors, as the path holds them
        dv, dl, dc, dlive, dhit = (
            None if x is None else torch.from_numpy(
                np.ascontiguousarray(x.view(np.int32) if x.dtype == np.uint32 else x)).to(dev)
            for x in (vals_, lens_, codes_, live_, hit_))
        out = torch.empty((U, q, n_), dtype=torch.bool, device=dev)

        def go(out=out, dv=dv, dl=dl, dc=dc, dlive=dlive, dhit=dhit, U=U, q=q, rp_=rp_, n_=n_):
            _build.check(lib.tt_rle_cols_hit(
                dv.data_ptr(), None if dl is None else dl.data_ptr(), U, 1, rp_,
                dc.data_ptr(), K, q, None if dlive is None else dlive.data_ptr(),
                None if dhit is None else dhit.data_ptr(), n_, out.data_ptr(), stream()),
                "rle_cols_hit")

        def path(dv=dv, dl=dl, dc=dc, dlive=dlive, dhit=dhit, n_=n_):
            return pk.rle_hit_lanes(dv, dl, dc, n_, live=dlive, hit=dhit)

        go()
        check(torch.equal(out, path()), f"phase 17 (e) {key}: the C entry point != the wrapper")
        before = pk.rle_cols_hit.launches
        names = traced[key]
        check(len(names) == 1 and "rle_cols_hit_kernel" in names[0],
              f"phase 17 (e) {key}: a call's kernels in a torch.profiler trace are {names}")
        ms = kernel_ms(torch, [go])
        path_t = path_ms(torch, path)
        plain = path_ms(torch, lambda: pk._rle_hit_plain(dv, dl, dc, dlive, dhit, n_))
        # host time a call, 1,000 calls with no synchronise: the wrapper
        # call, and the C entry point alone (the ctypes call and the launch)
        host = {}
        for label, fn in (("path", path), ("entry", go)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(1000):
                fn()
            host[label] = (time.perf_counter() - t1) * 1e3  # ms for 1,000 calls = us a call
            torch.cuda.synchronize()
        host_us = host["path"]
        pk.rle_cols_hit.launches = before  # the comparison's launches are not the path's
        cs = [[dc[u, j, 0][dc[u, j, 0] != -1] for j in range(q)] for u in range(U)]
        if dl is None:
            def chain():
                return [torch.isin(dv[u, 0], cs[u][j]) for u in range(U) for j in range(q)]
        else:
            totals = [int(x) for x in lens_[:, 0].sum(1)]

            def chain():
                return [torch.repeat_interleave(torch.isin(dv[u, 0], cs[u][j]), dl[u, 0],
                                                output_size=totals[u])
                        for u in range(U) for j in range(q)]

        libms = path_ms(torch, chain)
        # values and lengths read once, each lane's codes and the valid mask
        # once, the masks written once; the function needs one in-set test a
        # run and lane (a compare per code, over the runs that hold rows)
        # and one AND a row and lane as the verdicts expand
        nbytes = U * (rp_ * (4 if lens_ is None else 8) + q * K * 4 + q * n_)
        nbytes += 0 if hit_ is None else U * n_
        n_runs = min(rp_, n_) if lens_ is None else int((lens_ > 0).sum())
        bnd, by = bound_ms(nbytes, q * (n_runs * K + U * n_))
        res[key] = dict(shape=shape, max_abs_err=0, ms=ms, path_ms=path_t, plain_ms=plain,
                        bound_ms=bnd, bound_by=by, library_ms=libms, host_us_a_call=host_us,
                        entry_host_us_a_call=host["entry"], kernels_a_call=len(names))
        print(f"phase 17 (e) rle_cols_hit {key} ({shape}): kernel {ms:.5f} ms "
              f"({bnd / ms:.2%} of bound), one launch a call (count and trace), path "
              f"{path_t:.4f} ms, host {host_us:.2f} us a call (1,000 calls, no synchronise; "
              f"the C entry point alone {host['entry']:.2f}), "
              f"plain {plain:.4f} ms, torch.isin{'' if dl is None else ' + repeat_interleave'} "
              f"chain {libms:.4f} ms, bound {bnd:.7f} ms ({by})", flush=True)
    print(f"phase 17 (e) rle_cols_hit: {res['cases']} cases == plain (in-set, batched Q=8 with a "
          "dead column, a run a row, padding, truncation, a NO_MATCH value, several units, "
          f"{len(RLE_EDGES)} edges with and without live and hit, a saturated first run, the "
          "four timed shapes)", flush=True)
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
    from tempo_tpu_torch.encoding.vtpu import lightweight as lw
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
    libs = _build.build()
    lib = _build.lib()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(os.path.basename(x) for x in libs)}; one nvcc a source, in parallel)",
          flush=True)
    ptxas = _build.ptxas_report()
    for kname, r in sorted(ptxas.items()):
        print(f"phase 1 ptxas {kname}: {r.get('registers')} registers, "
              f"{r.get('smem_static')} B static smem, spills {r.get('spill_stores')} B stored / "
              f"{r.get('spill_loads')} B loaded", flush=True)
    print("phase 1 dynamic smem: seg_bincount_kernel<weighted,0> (dense) 4 B a slot "
          "(n_slots <= 49,152: up to 196,608 B, opted in above 48 KiB), <weighted,1> (hashed) "
          "65,536 B; in_set_scan_kernel 4 B a code of its columns; compiled_count_kernel "
          "its tile's staged dbp words, masks and rle runs, and 4 B a bin a query lane where "
          "that fits 227 KB (else none: global atomics); resident_rle_kernel 65,536 B (a "
          "tile of 8,192 runs' values and lengths), resident_dbp_kernel none (its deltas stay "
          "in registers), rle_cols_hit_kernel 8 B a run of its tile (up to 8,192) and 8 B a "
          "(lane, code) of a lane group", flush=True)

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

    t0 = time.perf_counter()
    n_codec = codec_kernels_check(torch, dev, rng)
    print(f"phase 2 codec kernels: {n_codec} cases equal ({time.perf_counter() - t0:.1f} s): "
          "batched rle_change_mask + dbp_pack over mixed page tables (n 2/3/9/2049/8193; rle "
          "1/3/4/8 lanes and 600 lanes; dbp items 0(pack)/8/16/32/64 bits x widths 0/1/31/32, "
          "20 columns of a page; dct) == plain; rle/dbp/dct pages on the card == host pages, "
          "singly and as one batch (1/2/4/8-byte items, negative deltas, 64-bit borrows, dct "
          "d=1 and 2^k); dbp_decode "
          "n 2/3/9/2047/2049/8193 x widths 0/1/31/32 == lightweight.dbp_decode and plain; "
          "compiled_metrics over 7 rle/dct/dbp mixes (inverted and empty sets, t_s < start, "
          "bins >= n_bins) == plain == a numpy interpreter over the decoded columns", flush=True)

    t0 = time.perf_counter()
    n_resident = resident_kernels_check(torch, dev, rng)
    print(f"phase 2 resident scans: {n_resident} cases equal ({time.perf_counter() - t0:.1f} s): "
          "resident_rle_scan at 1 to 3 run tiles, lengths summing below, to and past n (zero-"
          "length runs, NO_MATCH_CODE values), in-set (by value and 300 codes in device "
          "memory) / inverted / between; resident_dct_scan at 1 to 40,000 entries and n/2 of "
          "65,536 rows (codes by value, above the cap, on the card; jnp's index edges); "
          "resident_dbp_scan at every width 0-64 at 1 to 70,000 rows, bounds inside a limb; "
          "the batched rle, dct and dbp scans over mixed page tables (no run, n = 0, 20,000 "
          "runs, 1 to 32,768 entries, every width, 65,536 and 70,000 rows) == plain (timed in "
          "phase 10)", flush=True)

    t0 = time.perf_counter()
    n_graph_sketch, graph_sketch_times = graph_sketch_kernels_check(torch, dev, rng, lib, stream)
    graph_sketch_s = time.perf_counter() - t0
    print(f"phase 2 graph and sketch kernels: {n_graph_sketch} cases equal "
          f"({graph_sketch_s:.1f} s): hll_update at p 4/12/14/15/18 (shared-memory "
          "registers to p = 14, global atomics above; p 12/18 over every row) over the "
          "compaction step's 2^22 int64 keys (valid: each trace's first surviving row), 2^17 "
          "int32 block-writer IDs, a flush's 8,192 and 8,193, 1, 64 and 4,096 edge keys; "
          "cm_update at 4x4096, 1x16 and 8x8192 (global atomics) over the step's keys (valid: "
          "every surviving row; with u32 weights; as sorted traces of 8; every row invalid), "
          "the writer's IDs, 64 and 4,096 edge keys, and 1, 31, 33, 257 and 4,096 with "
          "weights near 2^32 whose sums wrap; "
          "root_path_sums over 2^21 spans (chains of 8 and 2,048, a forest, parent cycles; the "
          "cycles also == the host arm) a launch a round, and given the trace segments in one "
          "launch (chains of 8 and 2,048, in-trace cycles, a trace of three tiles; the pinned "
          "dispatch too) == plain", flush=True)

    # ---------------------------------------------------------------- 3 + 4
    reset_launches()

    fn, ex = entry(device="cuda", n_rows=1 << 22)
    plans = fn.keywords["plans"]
    out = fn(*ex)  # first call: allocator and library warm-up
    plain_out = torch_op_step(*ex, plans)
    torch.cuda.synchronize()
    step_s, plain_step_s = [], []
    # the step with the sketch kernels and the torch-op step before them,
    # in turns: torch ops, kernels, kernels, torch ops, ...
    for which in "pkkppk":
        t0 = time.perf_counter()
        if which == "k":
            out = fn(*ex)
        else:
            plain_out = torch_op_step(*ex, plans)
        torch.cuda.synchronize()
        (step_s if which == "k" else plain_step_s).append(time.perf_counter() - t0)
    fn_cpu, ex_cpu = entry(device="cpu", n_rows=1 << 22)
    t0 = time.perf_counter()
    ref = fn_cpu(*ex_cpu)
    cpu_s = time.perf_counter() - t0
    for key in ("perm", "keep", "n_rows", "n_traces", "bloom", "hll", "cm"):
        check(torch.equal(out[key].cpu(), ref[key]), f"compaction {key}: cuda != cpu")
        check(torch.equal(plain_out[key].cpu(), ref[key]),
              f"compaction {key}: the torch-op step != cpu")
    lc = launch_counters()
    step_launches = {k: lc[k].launches for k in ("hll_update", "cm_update")}
    check(all(v > 0 for v in step_launches.values()),
          f"compaction: the sketch kernels did not launch ({step_launches})")
    print(f"phase 3 compaction: 2^22 rows, n_rows={int(out['n_rows'])} "
          f"n_traces={int(out['n_traces'])}, cuda == cpu on perm/keep/n_rows/n_traces/bloom/"
          f"hll/cm (the step with the sketch kernels and the torch-op step) | step "
          f"{statistics.median(step_s) * 1e3:.2f} ms with the sketch kernels (median of 3; "
          f"{', '.join(f'{s * 1e3:.2f}' for s in step_s)}), "
          f"{statistics.median(plain_step_s) * 1e3:.2f} ms with their torch-op versions ("
          f"{', '.join(f'{s * 1e3:.2f}' for s in plain_step_s)}; same call, in turns), "
          f"cpu {cpu_s * 1e3:.0f} ms | sketch launches {step_launches}", flush=True)

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
    reset_launches()
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
    # the device page decode, called here directly (no served path calls it:
    # the device tier's resident_dbp_scan decodes in its own launch): the
    # first 2^20 spans' durations as one dbp page (width 31), decoded on the
    # card
    n_long = 1 << 20
    long_col = cat["duration_nano"][:n_long]
    long_page = lw.dbp_encode(long_col)
    kernels_before = pk.dbp_decode_limbs.kernel_launches
    decoded = pk.dbp_decode_device(long_page, long_col.dtype.str, long_col.shape, dev)
    check(np.array_equal(decoded, long_col), "scan path: dbp_decode_device != the column")
    scan_launches = {"in_set_scan": pk.in_set_scan.launches,
                     "u64_range_scan": pk.u64_range_scan.launches,
                     "dbp_decode": pk.dbp_decode_limbs.launches}
    for k, n in scan_launches.items():
        check(n > 0, f"scan path: {k} never launched")
    first, _anchors, widths, streams, _n = lw.dbp_parts(long_page, long_col.dtype.str,
                                                        long_col.shape)
    raw = bytes(streams[0])
    long_words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 4), "<u4")
    long_dbp = (torch.from_numpy(long_words.view(np.int32).copy()).to(dev)[None, :],
                torch.tensor([int(first[0])], dtype=torch.uint64).view(torch.int64).to(dev),
                torch.tensor([widths[0]], dtype=torch.int32, device=dev), n_long)
    print(f"phase 5 scan: {n_rows} spans, service/name/method/status in-set -> "
          f"{int(hit.sum())} rows, duration in [100ms, 500ms] -> {int(rng_hit.sum())} rows; "
          f"both equal the numpy oracle; chip_smoke's own dbp_decode_device call (no served "
          f"path decodes dbp): a {n_long}-row dbp page of durations (width "
          f"{widths[0]}) decoded on the card == the column ({scan_launches['dbp_decode']} "
          f"dbp_decode call, {pk.dbp_decode_limbs.kernel_launches - kernels_before} kernel "
          f"launches)", flush=True)

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
    # no one torch call compares over uint64 (torch has no unsigned 64-bit
    # compare): the nearest is a chain of two int64 compares and an AND,
    # right here since every duration lies below 2^63
    check(torch.equal((dur >= lo_ns) & (dur <= hi_ns), range_outs[0]),
          "u64_range_scan: the int64 compare chain != the kernel")
    chain = path_ms(torch, lambda: (dur >= lo_ns) & (dur <= hi_ns))
    bnd, by = bound_ms(9 * n_rows, 2 * n_rows)
    kernels["u64_range_scan"] = dict(shape=f"n_pad={n_rows}", max_abs_err=0, ms=ms,
                                     ms_l2_warm=ms_warm, path_ms=path, plain_ms=plain,
                                     bound_ms=bnd, bound_by=by, library_ms=None,
                                     library_chain_ms=chain,
                                     launches=scan_launches["u64_range_scan"])
    print(f"phase 5 u64_range_scan timing: kernel {ms:.4f} ms ({bnd / ms:.0%} of bound; "
          f"{ms_warm:.4f} ms with its inputs in L2), path {path:.4f} ms, plain {plain:.4f} ms, "
          f"int64 compare chain {chain:.4f} ms (no one torch call), bound {bnd:.4f} ms ({by})",
          flush=True)

    # ---------------------------------------------------------------- 6
    # the block path: seg_bincount (queries) and the page-encode kernels
    # (the card's writes and compactions)
    block_kernels = ("seg_bincount", "rle_change_mask", "dbp_pack", "hll_update")
    reset_launches()
    t0 = time.perf_counter()
    before_s = t0 - t_script
    db_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_db_")
    encode_batches: list = []  # the plans of each page-encode batch of block A's card write
    d0 = STATS.dispatches.get("page_encode", 0)
    blocks, (a, b) = blocks_phase(seed, queries, plan_of, os.path.join(db_dir.name, "blocks"),
                                  encode_batches)
    blocks["launches"] = read_launches()
    blocks["page_encode_dispatches"] = STATS.dispatches.get("page_encode", 0) - d0
    # phase 13's backend: copies of the two card-written blocks, taken
    # before phase 7 compacts them
    rc_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_rc_")
    shutil.copytree(os.path.join(db_dir.name, "blocks"), os.path.join(rc_dir.name, "src", "blocks"))
    # and phase 17's: the same two blocks
    mesh_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    shutil.copytree(os.path.join(db_dir.name, "blocks"), os.path.join(mesh_dir.name, "src"))
    for k in block_kernels:
        check(blocks["launches"][k] > 0, f"block path: {k} never launched")
    blocks["phase_s"] = time.perf_counter() - t0
    blocks["phases_0_5_s"] = before_s
    print(f"phase 6 blocks: {blocks['phase_s']:.1f} s (phases 0-5: {before_s:.1f} s), launches "
          f"on the block path: {blocks['launches']}, {blocks['page_encode_dispatches']} "
          f"page-encode dispatches", flush=True)
    # the page-encode kernels at one row group's and one block's pages
    t0 = time.perf_counter()
    for kname, recs in time_encode_kernels(torch, dev, encode_batches, lib, stream).items():
        kernels[kname] = dict(recs["row_group"], block=recs["block"])
        for label, rec in recs.items():
            print(f"phase 6 {kname} timing at one {label.replace('_', ' ')}'s pages "
                  f"({rec['shape']}): kernel {rec['ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.0%} "
                  f"of bound), path {rec['path_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                  f"library {fmt_ms(rec['library_ms'])}, bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}) | the writer's dispatch {rec['dispatch_ms']:.3f} ms "
                  f"(copies, launches, stream wait), encode_prepared {rec['encode_ms']:.3f} ms",
                  flush=True)
    encode_batches.clear()
    blocks["encode_timing_s"] = time.perf_counter() - t0

    # ---------------------------------------------------------------- 7
    reset_launches()
    recorded: dict = {}
    # db_dir holds phase 7's compacted block until phase 10
    d0 = STATS.dispatches.get("page_encode", 0)
    phases_0_6_s = time.perf_counter() - t_script
    print(f"phase 7: phases 0-6 took {phases_0_6_s:.1f} s", flush=True)
    db = db_phase(seed, a, b, db_dir.name, queries, plan_of)
    sheds = []
    tier_inputs = db.pop("tier_inputs")
    compacted_block_id = db.pop("compacted_block_id")
    db["launches"] = read_launches()
    db["page_encode_dispatches"] = STATS.dispatches.get("page_encode", 0) - d0
    for k in block_kernels:
        check(db["launches"][k] > 0, f"storage engine path: {k} never launched")
    for k in ("rle_change_mask", "dbp_pack"):
        check(db["launches"][k] <= db["page_encode_dispatches"],
              f"storage engine path: {k} launched more than once a page-encode dispatch")
    print(f"phase 7 db: {db['phase_s']:.1f} s, launches on the storage engine's path: "
          f"{db['launches']}, {db['page_encode_dispatches']} page-encode dispatches",
          flush=True)

    # ------------------------------------------------------------ 8
    # a slow host sheds phase 8's interpreter runs of the simple counts
    # (their latency beside the tier's): phases 8-10 take about 150 s,
    # so past 420 s here the script would pass 600 s
    elapsed = time.perf_counter() - t_script
    if elapsed > 420:
        sheds.append("phase 8 simple counts through the interpreter")
    print(f"phase 8 depth: phases 0-7 took {elapsed:.1f} s -> "
          + ("the interpreter runs shed" if elapsed > 420 else "nothing shed"), flush=True)
    reset_launches()
    d0 = STATS.dispatches.get("page_encode", 0)
    app = app_phase(seed, a, b, db_dir.name, compacted_block_id, queries, plan_of,
                    recorded, shed=elapsed > 420)
    app["launches"] = read_launches()
    app["page_encode_dispatches"] = STATS.dispatches.get("page_encode", 0) - d0
    # (the generator takes every push, but make_batch's traces stay in one
    # service each: they pair no service-graph edge, so the sketch kernels
    # launch here for the flush's block sketch only; phase 11 drives them)
    for k in block_kernels + ("compiled_metrics",):
        check(app["launches"][k] > 0, f"server path: {k} never launched")
    # the compiled tier fuses the dbp decode: dbp_decode is on the scan path only
    check(app["launches"]["dbp_decode"] == 0, "server path: dbp_decode launched")
    for k in ("rle_change_mask", "dbp_pack"):
        check(app["launches"][k] <= app["page_encode_dispatches"],
              f"server path: {k} launched more than once a page-encode dispatch")
    print(f"phase 8 app: {app['phase_s']:.1f} s, launches on the server's path: "
          f"{app['launches']}, {app['page_encode_dispatches']} page-encode dispatches", flush=True)
    for k in ("seg_bincount", "rle_change_mask", "dbp_pack"):
        kernels[k]["launches_block_path"] = blocks["launches"][k]
        kernels[k]["launches_db_path"] = db["launches"][k]
        kernels[k]["launches_app_path"] = app["launches"][k]
    for k in ("rle_change_mask", "dbp_pack"):
        kernels[k]["launches"] = blocks["launches"][k]

    # dbp_decode and the compiled dispatch at the shapes phases 5 and 8 gave them
    for kname, rec in time_compiled_kernels(torch, recorded, long_dbp, lib, stream).items():
        kernels[kname] = dict(rec, launches=scan_launches["dbp_decode"] if kname == "dbp_decode"
                              else app["launches"][kname])
        for label, r in (("", rec), (" one long unit", rec.get("long_unit")),
                         (" Q=4", rec.get("q4"))):
            if r is None:
                continue
            launches = r.get("kernels_a_call", r.get("kernels_a_dispatch"))
            where = ("phase 8" if kname == "compiled_metrics"
                     else "off the served paths, chip_smoke's own call:")
            print(f"{where} {kname}{label} timing ({r['shape']}): kernel {r['ms']:.5f} ms "
                  f"({r['bound_ms'] / r['ms']:.0%} of bound, {launches} kernel launches), "
                  f"path {r['path_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{fmt_ms(r['library_ms'])}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
                  + (" | bins a row tile's in-window rows span (min, median, max): "
                     f"{r['tile_bins']}" if "tile_bins" in r else ""), flush=True)
    kernels["dbp_decode"]["launches_app_path"] = app["launches"]["dbp_decode"]
    recorded.clear()
    del long_dbp

    # ---------------------------------------------------------------- 9
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_standing_") as standing_root:
        standing = standing_phase(seed, standing_root, queries)
    standing["launches"] = read_launches()
    standing_kernels = ("seg_bincount", "rle_change_mask", "dbp_pack", "compiled_metrics",
                        "hll_update")
    for k in standing_kernels:
        check(standing["launches"][k] > 0, f"standing path: {k} never launched")
    check(standing["launches"]["seg_bincount"] >= standing["dispatches"],
          "standing path: fewer seg_bincount launches than standing_fold dispatches")
    print(f"phase 9 standing: {standing['phase_s']:.1f} s, launches on the standing path: "
          f"{standing['launches']} ({standing['dispatches']} of seg_bincount's at the cuts' "
          "folds, the rest query_range's)", flush=True)
    for k in ("seg_bincount", "rle_change_mask", "dbp_pack", "compiled_metrics"):
        kernels[k]["launches_standing_path"] = standing["launches"][k]

    # ---------------------------------------------------------------- 10
    reset_launches()
    tier = tier_phase(db_dir.name, tier_inputs, compacted_block_id, plan_of)
    tier["launches"] = read_launches()
    for k in RESIDENT_KERNELS + ("compiled_metrics",):
        check(tier["launches"][k] > 0, f"device tier path: {k} never launched")
    print(f"phase 10 device tier: {tier['phase_s']:.1f} s, launches on the tier's path: "
          f"{tier['launches']}, stacks served from the card for "
          f"{len(tier['stacks_resident'])} of {len(SIMPLE_COUNT)} queries, codecs resident "
          f"{tier['codecs_resident']}, tier {tier['stats']}", flush=True)
    timed = time_resident_kernels(torch, tier.pop("tier"), tier.pop("batches"), lib, stream)
    for kname, rec in timed.items():
        kernels[kname] = dict(rec, launches=tier["launches"][kname])
        where = ("one search's stage-1 pages" if kname.endswith("_batch")
                 else "the largest resident page")
        print(f"phase 10 {kname} timing at {where} ({rec['shape']}): kernel "
              f"{rec['ms']:.5f} ms ({rec['bound_ms'] / rec['ms']:.1%} of bound, "
              f"{rec['kernels_a_call']} kernel launches"
              + (f", {rec['ms_a_page'] * 1e3:.3f} us a page" if "ms_a_page" in rec else "")
              + f"), path {rec['path_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
              f"{fmt_ms(rec['library_ms'])}, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})",
              flush=True)
    kernels["compiled_metrics"]["launches_tier_path"] = tier["launches"]["compiled_metrics"]
    from tempo_tpu_torch.encoding.vtpu import colcache

    colcache.configure_device_tier(None, device="cuda")
    db_dir.cleanup()

    # ---------------------------------------------------------------- 11
    # a slow host sheds phase 11's generator-off App (its push rate only):
    # phases 11-12 take about 250 s, so past 750 s here the script would
    # pass 1,000 s
    elapsed = time.perf_counter() - t_script
    shed11 = elapsed > 750
    if shed11:
        sheds.append("phase 11 push with the generator off")
    print(f"phase 11 depth: phases 0-10 took {elapsed:.1f} s -> "
          + ("the generator-off push shed" if shed11 else "nothing shed"), flush=True)
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as graph_root:
        graph = graph_phase(seed, graph_root, shed=shed11,
                            keep=os.path.join(rc_dir.name, "src", "blocks"))
    graph["launches"] = read_launches()
    for k in GRAPH_SKETCH_KERNELS + ("rle_change_mask", "dbp_pack"):
        check(graph["launches"][k] > 0, f"generator and graph path: {k} never launched")
    print(f"phase 11 generator and graph: {graph['phase_s']:.1f} s, launches on the path: "
          f"{graph['launches']}", flush=True)
    for k in GRAPH_SKETCH_KERNELS:
        rec = graph_sketch_times[k]
        main_rec = rec["traces chains depth 8" if k == "root_path_sums" else "compaction"]
        kernels[k] = dict(main_rec, launches=graph["launches"][k],
                          shapes={label: r for label, r in rec.items()})
    for k in ("hll_update", "cm_update"):
        kernels[k]["launches_compaction_step"] = step_launches[k]
        for phase_name, ph in (("block", blocks), ("db", db), ("app", app),
                               ("standing", standing)):
            kernels[k][f"launches_{phase_name}_path"] = ph["launches"][k]

    # ---------------------------------------------------------------- 12
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tail_") as tail_root:
        tail = tail_phase(seed, tail_root, queries)
    tail["launches"] = read_launches()
    for k in TAIL_KERNELS + ("seg_bincount",):
        check(tail["launches"][k] > 0, f"ingest tail path: {k} never launched")
    print(f"phase 12 ingest tail and status planes: {tail['phase_s']:.1f} s, launches on the "
          f"path: {tail['launches']}", flush=True)
    for k, rec in tail_full_width(torch, dev, lib, stream, seed, tail["lowered"]).items():
        kernels[k] = dict(rec, launches=tail["launches"][k])
    kernels["seg_bincount"]["launches_tail_path"] = tail["launches"]["seg_bincount"]

    # ---------------------------------------------------------------- 13
    # a slow host sheds both Apps' after-push searches (repeats of the
    # repeat pass's hits and the cold pass's misses; SHED13_S)
    elapsed = time.perf_counter() - t_script
    shed13 = elapsed > SHED13_S
    if shed13:
        sheds.append("phase 13 searches of the after-push passes")
    print(f"phase 13 depth: phases 0-12 took {elapsed:.1f} s -> "
          + ("the after-push searches shed" if shed13 else "nothing shed"), flush=True)
    reset_launches()
    rc = resultcache_phase(seed, rc_dir.name, queries, plan_of, shed=shed13)
    rc["launches"] = read_launches()
    rc_dir.cleanup()
    # the cache-on App's misses launch the query kernels; the phase's
    # flushes the page-encode kernels
    for k in ("seg_bincount", "root_path_sums"):
        check(rc["launches_path"][k] > 0, f"result cache path: {k} never launched")
    for k in ("rle_change_mask", "dbp_pack"):
        check(rc["launches"][k] > 0, f"result cache path: {k} never launched")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_incident_") as incident_root:
        rc["incident"] = incident_phase(incident_root)
    print(f"phase 13 result cache, backend cache and incident plane: {rc['phase_s']:.1f} s "
          f"+ {rc['incident']['phase_s']:.1f} s, launches of the cache-on App's passes: "
          f"{rc['launches_path']}, of the cache-off App's: {rc['launches_control']}, of the "
          f"whole phase: {rc['launches']}", flush=True)
    for k in ("seg_bincount", "root_path_sums"):
        kernels[k]["launches_resultcache_path"] = rc["launches_path"][k]
        kernels[k]["launches_resultcache_control"] = rc["launches_control"][k]

    # ---------------------------------------------------------------- 14
    # a slow host sheds phase 14's vulture probes and its finds after the
    # kill (SHED14_S)
    elapsed = time.perf_counter() - t_script
    shed14 = elapsed > SHED14_S
    if shed14:
        sheds.append("phase 14 vulture probes and finds after the kill")
    print(f"phase 14 depth: phases 0-13 took {elapsed:.1f} s -> "
          + ("the vulture and the finds after the kill shed" if shed14 else "nothing shed"),
          flush=True)
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as cluster_root:
        cluster = cluster_phase(seed, cluster_root, queries, shed=shed14)
    cluster["launches_total"] = read_launches()
    # querier-0's seg_bincount, the ingesters' flush and the compactor's
    # page encode and block sketch, the generator's service graphs; the
    # critical path on either querier (checked in the phase)
    for k in ("seg_bincount", "rle_change_mask", "dbp_pack", "hll_update", "cm_update"):
        check(cluster["launches_total"][k] > 0, f"cluster path: {k} never launched")
    for kind, m in cluster["ms"].items():
        print(f"phase 14 {kind}: p50 {m['p50']:.1f} ms, max {m['max']:.1f} ms over {m['n']} "
              "requests", flush=True)
    print(f"phase 14 cluster: {cluster['phase_s']:.1f} s | push {cluster['push_spans_per_s']:.0f} "
          f"spans/s, flush {cluster['flush_ms']:.0f} ms, compaction {cluster['compact_ms']:.0f} "
          f"ms | launches a role step {cluster['launches']}, querier-1's dispatches "
          f"{cluster['querier_b_dispatches']} | launches on the path {cluster['launches_total']}",
          flush=True)

    # ---------------------------------------------------------------- 15
    # a slow host sheds phase 15's forwarder and self-tracing checks
    # (SHED15_S); its receivers always run
    elapsed = time.perf_counter() - t_script
    shed15 = elapsed > SHED15_S
    if shed15:
        sheds.append("phase 15 forwarder and self-tracing checks")
    print(f"phase 15 depth: phases 0-14 took {elapsed:.1f} s -> "
          + ("the forwarder and self-tracing checks shed" if shed15 else "nothing shed"),
          flush=True)
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_receivers_") as receivers_root:
        receivers = receivers_phase(seed, receivers_root, queries, shed=shed15)
    receivers["launches"] = read_launches()
    # the generator tee's sketches at every push, the flush's page encode,
    # query_range over the flushed blocks
    for k in ("hll_update", "cm_update", "rle_change_mask", "dbp_pack", "seg_bincount"):
        check(receivers["launches"][k] > 0, f"receivers path: {k} never launched")
    for kind, m in receivers["ms"].items():
        print(f"phase 15 {kind}: p50 {m['p50']:.1f} ms, max {m['max']:.1f} ms over {m['n']} "
              "requests", flush=True)
    print(f"grpc_transport: \"{receivers['grpc_transport']}\"", flush=True)
    print(f"phase 15 receivers and tees: {receivers['phase_s']:.1f} s | "
          + ", ".join(f"{c} {r['spans_per_s']:.0f}" for c, r in receivers["carriers"].items())
          + f" spans/s | flush {receivers['flush_ms']:.0f} ms | launches on the path "
          f"{receivers['launches']}", flush=True)

    # ---------------------------------------------------------------- 16
    # a slow host sheds phase 16's GCS and Azure round trips and the CLI
    # convert (SHED16_S); S3, vrow1, the readers and /metrics always run
    elapsed = time.perf_counter() - t_script
    shed16 = elapsed > SHED16_S
    if shed16:
        sheds.append("phase 16 GCS and Azure round trips and the CLI convert")
    print(f"phase 16 depth: phases 0-15 took {elapsed:.1f} s -> "
          + ("the GCS and Azure round trips and the CLI convert shed" if shed16
             else "nothing shed"), flush=True)
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_objectstore_") as store_root:
        store = objectstore_phase(seed, store_root, queries, plan_of, shed=shed16)
    store["launches"] = read_launches()
    # the card's vtpu1 writes (page encode, block sketch), the vrow1 writes
    # and merges (block sketch), query_range over S3 and through the App
    for k in ("hll_update", "rle_change_mask", "dbp_pack", "seg_bincount"):
        check(store["launches"][k] > 0, f"object storage path: {k} never launched")
    for kind, m in store["ms"].items():
        print(f"phase 16 {kind}: p50 {m['p50']:.1f} ms, max {m['max']:.1f} ms over {m['n']}",
              flush=True)
    print(f"phase 16 object storage and the off-cluster readers: {store['phase_s']:.1f} s | "
          "write ms a block: " + ", ".join(f"{k} {statistics.median(v):.0f}"
                                           for k, v in store["write_ms"].items())
          + f" | launches on the path {store['launches']}", flush=True)

    # ---------------------------------------------------------------- 17
    # a slow host sheds phase 17 (c)'s repeat on the (2, 2) mesh (SHED17_S)
    elapsed = time.perf_counter() - t_script
    shed17 = elapsed > SHED17_S
    if shed17:
        sheds.append("phase 17 (c) searches on the (2, 2) mesh")
    print(f"phase 17 depth: phases 0-16 took {elapsed:.1f} s -> "
          + ("(c)'s (2, 2) repeat shed" if shed17 else "nothing shed"), flush=True)
    mesh = mesh_phase(seed, mesh_dir.name, a, b, os.path.join(mesh_dir.name, "src"), queries,
                      plan_of, batches, step=(fn, ex, out), shed=shed17)
    check_mesh_launches(mesh, "mesh path")
    print(f"phase 17 mesh ({smi}): {mesh['phase_s']:.1f} s | step ms {mesh['step']} | merge ms "
          f"{mesh['compact_ms']} | launches on the mesh path (mesh calls only): "
          f"{mesh['launches']} | by step {mesh['launches_by_step']}", flush=True)
    rle_times = rle_kernel_check(torch, dev, lib, stream, os.path.join(mesh_dir.name, "src"), rng)
    kernels["rle_cols_hit"] = dict(rle_times["Q=1"], launches=mesh["launches"]["rle_cols_hit"],
                                   q8=rle_times["Q=8"], units16=rle_times["U=16"],
                                   run_a_row=rle_times["run a row"], cases=rle_times["cases"],
                                   ptxas=rle_times["ptxas"])
    if torch.cuda.device_count() > 1:
        n_cards = torch.cuda.device_count()
        distinct = [torch.device("cuda", i % n_cards) for i in range(4)]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_cards_") as cards_root:
            shutil.copytree(os.path.join(mesh_dir.name, "src"), os.path.join(cards_root, "src"))
            mesh["distinct_cards"] = mesh_phase(
                seed, cards_root, a, b, os.path.join(cards_root, "src"), queries, plan_of,
                batches, step=(fn, ex, out), devices=distinct, shed=True)
        check_mesh_launches(mesh["distinct_cards"], "mesh path over distinct cards")
    mesh_dir.cleanup()

    source = {k: "tempo_tpu_torch/csrc/kernels.cu"
              for k in ("seg_bincount", "in_set_scan", "u64_range_scan")}
    source.update({k: "tempo_tpu_torch/csrc/codec_kernels.cu"
                   for k in CODEC_KERNELS + RESIDENT_KERNELS})
    source.update({k: "tempo_tpu_torch/csrc/graph_sketch_kernels.cu"
                   for k in GRAPH_SKETCH_KERNELS})
    source.update({k: "tempo_tpu_torch/csrc/tail_kernels.cu" for k in TAIL_KERNELS})
    source["rle_cols_hit"] = "tempo_tpu_torch/csrc/codec_kernels.cu"
    replaces = {
        "seg_bincount": "tempo_tpu/ops/pallas_kernels.py:194",
        "in_set_scan": "tempo_tpu/ops/pallas_kernels.py:55",
        "u64_range_scan": "tempo_tpu/ops/pallas_kernels.py:152",
        "rle_change_mask": "tempo_tpu/ops/encode.py:135",
        "dbp_pack": "tempo_tpu/ops/encode.py:147",
        "dbp_decode": "tempo_tpu/ops/pallas_kernels.py:383",
        "compiled_metrics": "tempo_tpu/compiled/program.py:58",
        "resident_rle_scan": "tempo_tpu/ops/scan.py:169",
        "resident_dct_scan": "tempo_tpu/ops/scan.py:186",
        "resident_dbp_scan": "tempo_tpu/ops/scan.py:204",
        # one launch over a search's stage-1 pages, where the reference
        # runs its per-page jits page by page
        "resident_rle_scan_batch": "tempo_tpu/ops/scan.py:169",
        "resident_dct_scan_batch": "tempo_tpu/ops/scan.py:186",
        "resident_dbp_scan_batch": "tempo_tpu/ops/scan.py:204",
        # jitted programs of the reference, none a pallas_call
        "hll_update": "tempo_tpu/ops/sketch.py:55",
        "cm_update": "tempo_tpu/ops/sketch.py:117",
        "root_path_sums": "tempo_tpu/ops/graph.py:106",
        "tail_fold": "tempo_tpu/ops/ingest_tail.py:234",
        "tail_scan": "tempo_tpu/ops/ingest_tail.py:410",
        "rle_cols_hit": "tempo_tpu/ops/pallas_kernels.py:478",
    }
    for k in kernels:
        kernels[k]["launches_cluster_path"] = cluster["launches_total"][k]
        kernels[k]["launches_receivers_path"] = receivers["launches"][k]
        kernels[k]["launches_objectstore_path"] = store["launches"][k]
        kernels[k]["launches_mesh_path"] = mesh["launches"][k]
    # the second querier's, from its /status/device: one launch a dispatch
    for k, dispatch in (("seg_bincount", "seg_bincount"), ("root_path_sums", "graph_critical_path")):
        kernels[k]["launches_cluster_querier_1"] = cluster["querier_b_dispatches"].get(dispatch, 0)
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": source[k], "replaces": replaces[k], **kernels[k]}
        for k in ("seg_bincount", "in_set_scan", "u64_range_scan") + CODEC_KERNELS
        + RESIDENT_KERNELS + GRAPH_SKETCH_KERNELS + TAIL_KERNELS + ("rle_cols_hit",)
    ], "ptxas": ptxas, "compaction_step_ms": statistics.median(step_s) * 1e3,
        "compaction_step_torch_op_sketch_ms": statistics.median(plain_step_s) * 1e3,
        "query_ms": query_ms, "blocks": blocks, "db": db, "app": app, "standing": standing,
        "tier": tier, "graph": graph, "tail": tail, "resultcache": rc, "cluster": cluster,
        "receivers": receivers, "grpc_transport": receivers["grpc_transport"],
        "objectstore": store, "mesh": mesh, "shed": sheds,
        "phases_0_6_s": phases_0_6_s,
        "phase_2_graph_sketch_s": graph_sketch_s,
        "script_s": time.perf_counter() - t_script}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
