"""Mesh-sharded search: block/page ranges fanned across devices, and
the process-wide device dispatch lock.

Port of tempo_tpu/parallel/search.py. Row-group batches from many
blocks stack on the mesh's range axis; every shard scans its units on
its own device with the rle_cols_hit kernel (ops/pallas_kernels: the
fused run-length decode + in-set scan; an expanded column is a run a
row), hit counts add up over the range axis (parallel/mesh), and the
hit masks come back to the host, where only matching units pay the
metadata phase — the reference's early-exit economy (P3/P4, SURVEY.md
section 2.8).

The JAX package's jitted shard_map programs become the factories below:
each returns fn(*stacked_inputs) over (W, R, ...) host arrays (or, for a
resident run stack, one tensor a shard on its device) -> (masks numpy,
hits per window). Shards are padded to one bucket size, as in the
reference.

`dispatch_lock`: every device-program dispatcher of the process (the
mesh searcher and the mesh metrics evaluator here, the compiled query
tier) serialises on this ONE lock, so two threads' launches and host
reads never interleave on the cards (tests/test_race_stress.py's
concurrent-search scenario).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tempo_tpu_torch.ops import bloom
from tempo_tpu_torch.ops.pallas_kernels import rle_hit_lanes
from tempo_tpu_torch.parallel import mesh as _mesh
from tempo_tpu_torch.parallel.mesh import RANGE_AXIS, WINDOW_AXIS
from tempo_tpu_torch.util import metrics
from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

dispatch_lock = threading.Lock()

# fused-batch width observability: mean width over a window =
# rate(lanes) / rate(tempo_tpu_device_dispatches_total{kernel="batched_rle_scan"})
batched_lanes_total = metrics.counter(
    "tempo_tpu_batched_query_lanes_total",
    "Active query lanes served by fused multi-query scan dispatches",
)


def _shard_input(a, s: int, n_shards: int, dev: torch.device) -> torch.Tensor:
    """Shard s of a stacked (W, R, ...) host array, on dev; a list of
    per-shard tensors (a resident stack) gives its s-th tensor."""
    if isinstance(a, (list, tuple)):
        return a[s].to(dev)
    return _mesh.to_shard(a.reshape(n_shards, *a.shape[2:])[s], dev)


def _gather_masks(mesh, masks: list) -> np.ndarray:
    """The shards' masks stacked on the mesh's lead device and copied to
    the host in one transfer -> (W, R, ...) bool."""
    out = torch.stack([m.to(mesh.lead) for m in masks]).cpu().numpy()
    return out.reshape(mesh.shape[WINDOW_AXIS], mesh.shape[RANGE_AXIS], *out.shape[1:])


def _hits(mesh, masks: list) -> np.ndarray:
    """Per-window hit counts: each shard's count, summed over the range
    axis on the window's lead device -> (W, ...) int64."""
    counts = [m.sum(dim=-1) for m in masks]
    return np.stack([c.cpu().numpy() for c in _mesh.reduce_range(mesh, counts, "sum")])


def _scan_program(mesh, lane):
    """fn(*stacked) -> (masks (W, R, ...), hits (W, ...)): lane(s, dev,
    *shard_inputs) gives one shard's mask on its device."""

    def run(*stacked):
        n = mesh.size

        def one(s, dev):
            return lane(*(_shard_input(a, s, n, dev) for a in stacked))

        masks = _mesh.map_shards(mesh, one)
        return _gather_masks(mesh, masks), _hits(mesh, masks)

    return run


def make_sharded_tag_scan(mesh, n_cols: int, max_codes: int = 64):
    """Sharded equality-set scan over expanded columns.

    Inputs: cols (W, R, C, N) uint32 — C predicate columns a shard;
    codes (C, K) uint32 — accepted code sets, padded with the NO_MATCH
    sentinel (the same for every shard); valid (W, R, N) bool.
    Returns (mask (W, R, N) bool, hits (W,) int64)."""
    per_shard = make_sharded_tag_scan_per_shard(mesh, n_cols, max_codes)
    shape = (mesh.shape[WINDOW_AXIS], mesh.shape[RANGE_AXIS])

    def run(cols, codes, valid):
        codes = np.asarray(codes, np.uint32)
        return per_shard(cols, np.broadcast_to(codes, shape + codes.shape), valid)

    return run


def make_sharded_tag_scan_per_shard(mesh, n_cols: int, max_codes: int = 64):
    """make_sharded_tag_scan with code sets SHARDED with the rows: codes
    (W, R, C, K) — shards from different blocks resolve the same string
    predicate to their own dictionary codes."""

    def lane(cols, codes, valid):
        return rle_hit_lanes(cols[None], None, codes[None, None], cols.shape[1],
                             hit=valid.to(torch.bool)[None])[0, 0]

    return _scan_program(mesh, lane)


def make_sharded_bloom_test(mesh, p: bloom.BloomPlan):
    """Bloom membership over mesh-sharded block filters: words (W, R, S,
    words_per_shard) uint32 — one bloom a shard — and limbs (M, 4) uint32
    query IDs (the same for every shard) -> maybe (W, R, M) bool (no
    reduction: the caller wants to know WHICH ranges to open)."""

    def run(words, limbs):
        n = mesh.size
        lim = np.asarray(limbs)

        def one(s, dev):
            w = _shard_input(words, s, n, dev).to(torch.int64) & 0xFFFFFFFF
            return bloom.test(w, _mesh.to_shard(lim, dev).to(torch.int64) & 0xFFFFFFFF, p)

        return _gather_masks(mesh, _mesh.map_shards(mesh, one))

    return run


def make_sharded_rle_scan(mesh, n_cols: int, max_codes: int, n_pad: int):
    """Fused RLE decode + in-set scan, sharded over the mesh: the
    zero-decode road. Each shard ships its predicate columns as RUNS
    (values + lengths — the encoded form); its device computes the
    in-set verdict a run, expands it to rows, ANDs across columns
    (rle_cols_hit) and the hit counts add over the range axis.

    Inputs: values (W, R, C, RP) uint32, NO_MATCH-padded; lengths
    (W, R, C, RP) int32 (0 = padding run) — each also a list of per-shard
    tensors when the stack is resident; codes (W, R, C, K) uint32; valid
    (W, R, N) bool. Returns (mask (W, R, N) bool, hits (W,) int64)."""

    def lane(values, lengths, codes, valid):
        return rle_hit_lanes(values[None], lengths[None], codes[None, None], n_pad,
                             hit=valid.to(torch.bool)[None])[0, 0]

    return _scan_program(mesh, lane)


def make_sharded_batched_rle_scan(mesh, n_cols: int, max_codes: int,
                                  q: int, n_pad: int):
    """The multi-query variant of make_sharded_rle_scan: ONE run payload
    a shard, Q predicate sets scanned over it in a single launch.

    Inputs: values/lengths as make_sharded_rle_scan; codes (W, R, Q, C,
    K) uint32; live (W, R, Q, C) bool — which columns each query
    constrained (a dead column accepts all); valid (W, R, N) bool.
    Returns (masks (W, R, Q, N) bool, hits (W, Q) int64)."""

    def lane(values, lengths, codes, live, valid):
        return rle_hit_lanes(values[None], lengths[None], codes[None], n_pad,
                             live=live.to(torch.bool)[None],
                             hit=valid.to(torch.bool)[None])[0]

    return _scan_program(mesh, lane)


def _stack_arrays(mesh, values: np.ndarray, lengths: np.ndarray) -> tuple[dict, dict]:
    """A run stack as the device tier holds it: one values and one
    lengths array a shard, each bound for its shard's device."""
    arrays, devices = {}, {}
    for s, dev in enumerate(mesh.flat_devices):
        for name, a in (("values", values), ("lengths", lengths)):
            key = f"{name}/{s}"
            arrays[key] = np.ascontiguousarray(a[s])
            devices[key] = dev
    return arrays, devices


def _resident_stack(res, cap: int) -> tuple[list, list]:
    """The per-shard (values, lengths) tensors of a resident run stack."""
    return ([res.arrays[f"values/{s}"] for s in range(cap)],
            [res.arrays[f"lengths/{s}"] for s in range(cap)])


class MeshSearcher:
    """Mesh-sharded multi-block tag search with a bytes-bounded column
    cache (reference P4 + the async column iterator's page economy,
    modules/frontend/searchsharding.go:266-314 /
    pkg/parquetquery/iters.go:246).

    Each dispatch stacks up to W*R (block, row-group) units on the mesh;
    every device runs the fused equality-set scan over its shard with
    that shard's OWN dictionary codes, hit masks come back sharded, and
    only matching shards pay the host-side metadata phase. Columns are
    read through the process-wide decoded-column cache
    (encoding/vtpu/colcache.py) that every VtpuBackendBlock.read_columns
    call shares, so the mesh path and the default read path warm each
    other.
    """

    def __init__(self, mesh, bucket_for, max_codes: int = 64):
        self.mesh = mesh
        self.w = mesh.shape[WINDOW_AXIS]
        self.r = mesh.shape[RANGE_AXIS]
        self.bucket_for = bucket_for
        self.max_codes = max_codes
        # per-job device/transfer accounting: dispatches, units, bytes
        # each way and rows per shard
        self.last_stats: dict = {}

    def _col(self, blk, rg_index: int, rg, name: str) -> np.ndarray:
        return blk.read_columns(rg, [name])[name].astype(np.uint32, copy=False)

    def _scan(self, n_cols: int):
        return make_sharded_tag_scan_per_shard(self.mesh, n_cols, self.max_codes)

    # -- search ----------------------------------------------------------
    def search_blocks(self, blocks, req, on_block_error=None,
                      on_block_ok=None) -> "object":
        """blocks: ITERABLE of lazily-opened VtpuBackendBlocks — a block
        is only opened (index + dictionary reads) when the scan actually
        reaches it, so limited queries over large tenants keep the old
        path's early-exit economy. Device path covers the span_eq
        predicates; duration/attr predicates AND in host-side on matched
        shards only. Results get the same dedupe / newest-first /
        limit discipline as SearchResponse.merge.

        Failure domains: every opened block reports one verdict through
        on_block_error(block_id, exc) / on_block_ok(block_id) (the
        caller feeds quarantine accounting), and any terminal error
        fails the whole search loudly — the one result this path must
        never produce is a silently truncated "complete" response.
        NotFound is the benign deleted-mid-query race and only skips
        the block."""
        import logging

        from tempo_tpu_torch.encoding.common import SearchResponse
        from tempo_tpu_torch.encoding.vtpu.block import (
            _resolve_tag_predicates,
            pruned_row_groups_total,
            zone_maps_enabled,
            zone_prunes,
        )

        from tempo_tpu_torch.backend.faults import with_retries

        log = logging.getLogger(__name__)
        zm = zone_maps_enabled()
        resp = SearchResponse()
        stats = self.last_stats = {
            "dispatches": 0, "units_scanned": 0, "units_runspace": 0,
            "h2d_bytes": 0, "d2h_bytes": 0, "collectives": 0,
            "per_shard_rows": np.zeros(self.w * self.r, np.int64),
        }
        opened: list = []
        hits: list = []
        seen_ids: set = set()
        errors: list = []
        cap = self.w * self.r
        pending: list = []  # (blk, rg_index, rg, preds)
        done = False

        def unique_hits() -> int:
            return len(seen_ids)

        def collect(blk, i, rg, preds, span_mask):
            nonlocal done
            # feed the cached predicate columns back so hits_for_mask does
            # not re-read pages the device scan already pulled — but only
            # columns that actually expanded; encoded pages stay encoded
            # (the run-space hit collector gathers from them directly)
            have = {
                name: self._col(blk, i, rg, name)
                for name, _ in preds["span_eq"]
                if blk.encoded_column(rg, name) is None
            }
            if preds["attr"]:
                from tempo_tpu_torch.encoding.vtpu.block import attr_predicate_mask

                span_mask = span_mask & attr_predicate_mask(blk, rg, preds)
            if req.min_duration_ns or req.max_duration_ns:
                dur = blk.read_columns(rg, ["duration_nano"])["duration_nano"]
                have["duration_nano"] = dur
                if req.min_duration_ns:
                    span_mask = span_mask & (dur >= np.uint64(req.min_duration_ns))
                if req.max_duration_ns:
                    span_mask = span_mask & (dur <= np.uint64(req.max_duration_ns))
            if not span_mask.any():
                return
            for h in blk.hits_for_mask(rg, span_mask, req, 0, have_cols=have):
                if h.trace_id_hex not in seen_ids:
                    seen_ids.add(h.trace_id_hex)
                    hits.append(h)
            if req.limit and unique_hits() >= req.limit:
                done = True

        def flush(chunk):
            nonlocal done
            if not chunk:
                return
            n_cols = max(len(p["span_eq"]) for _, _, _, p in chunk)
            if n_cols == 0:
                # no device-scannable predicate: plain per-row-group scan
                for blk, i, rg, preds in chunk:
                    resp.inspected_traces += rg.n_traces
                    try:
                        rows = with_retries(
                            lambda b=blk, r=rg, p=preds:
                            list(b._search_row_group(r, req, p, limit=0)))
                        for h in rows:
                            if h.trace_id_hex not in seen_ids:
                                seen_ids.add(h.trace_id_hex)
                                hits.append(h)
                    except Exception as e:
                        errors.append((blk, e))
                        log.warning("mesh search: row group scan failed: %s", e)
                    if req.limit and unique_hits() >= req.limit:
                        done = True
                        return
                return
            pad = self.bucket_for(max(rg.n_spans for _, _, rg, _ in chunk))
            codes = np.full((cap, n_cols, self.max_codes), NO_MATCH, np.uint32)
            valid = np.zeros((cap, pad), bool)
            live = []

            # zero-decode run path: when EVERY unit's predicate pages
            # are rle, ship the runs themselves — H2D carries the
            # encoded form and the device fuses expansion + compare
            # (make_sharded_rle_scan); mixed chunks take the expanded
            # row path below, bit-identically.
            unit_encs: list | None = []
            for blk, i, rg, preds in chunk:
                row = []
                for col_name, _ in preds["span_eq"]:
                    enc = blk.encoded_column(rg, col_name)
                    if enc is None or enc.codec != "rle":
                        unit_encs = None
                        break
                    row.append(enc)
                if unit_encs is None:
                    break
                unit_encs.append(row)

            if unit_encs is not None:
                from tempo_tpu_torch.encoding.vtpu.colcache import shared_device_tier

                tier = shared_device_tier()
                pkeys = tuple(tuple(e.resident_key() for e in row)
                              for row in unit_encs)
                skey = ("mesh_stack", pkeys, n_cols, pad)
                res = tier.get(skey) if tier is not None else None
                if res is not None:
                    # resident hot path: the stacked run payload is
                    # already parked on device — skip run loading and
                    # host stacking entirely; only the (tiny) per-query
                    # codes + valid ship
                    run_pad = int(res.meta["run_pad"])
                    dev_values, dev_lengths = _resident_stack(res, cap)
                    tier.record_avoided(res.host_bytes, kernel="mesh_rle_scan")
                    for s, (blk, i, rg, preds) in enumerate(chunk):
                        for c, (col_name, accept) in enumerate(preds["span_eq"]):
                            k = min(len(accept), self.max_codes)
                            codes[s, c, :k] = accept[:k]
                        for c in range(len(preds["span_eq"]), n_cols):
                            codes[s, c, 0] = 0
                        valid[s, : rg.n_spans] = True
                        live.append(s)
                else:
                    max_runs = 8
                    unit_runs = []
                    for s, (blk, i, rg, preds) in enumerate(chunk):
                        try:
                            runs = [with_retries(e.runs) for e in unit_encs[s]]
                        except Exception as e:  # e.g. block deleted mid-query
                            errors.append((blk, e))
                            log.warning("mesh search: run load failed: %s", e)
                            unit_runs.append(None)
                            continue
                        unit_runs.append(runs)
                        for v, l in runs:
                            max_runs = max(max_runs, len(l))
                    run_pad = 1 << (max_runs - 1).bit_length()
                    values = np.full((cap, n_cols, run_pad), NO_MATCH, np.uint32)
                    lengths = np.zeros((cap, n_cols, run_pad), np.int32)
                    for s, (blk, i, rg, preds) in enumerate(chunk):
                        if unit_runs[s] is None:
                            continue
                        for c, ((col_name, accept), (v, l)) in enumerate(
                                zip(preds["span_eq"], unit_runs[s])):
                            values[s, c, : len(v)] = v.astype(np.uint32)
                            lengths[s, c, : len(l)] = l
                            k = min(len(accept), self.max_codes)
                            codes[s, c, :k] = accept[:k]
                        for c in range(len(preds["span_eq"]), n_cols):
                            # fewer predicates than the widest: accept-all
                            # (one all-covering run of value 0, code 0)
                            values[s, c, 0] = 0
                            lengths[s, c, 0] = rg.n_spans
                            codes[s, c, 0] = 0
                        valid[s, : rg.n_spans] = True
                        live.append(s)
                    dev_values = values.reshape(self.w, self.r, n_cols, run_pad)
                    dev_lengths = lengths.reshape(self.w, self.r, n_cols, run_pad)
                    if tier is not None and all(r is not None for r in unit_runs):
                        # offer the WHOLE stack; admitted only when every
                        # page in it sits inside the what-if knee. The
                        # admitting dispatch serves from the fresh entry
                        # too (one ship, counted as device_tier_admit)
                        arrays, devices = _stack_arrays(self.mesh, values, lengths)
                        tier.offer(skey, "rle_stack", arrays,
                                   meta={"run_pad": run_pad},
                                   host_bytes=values.nbytes + lengths.nbytes,
                                   page_keys=[k for row in pkeys for k in row],
                                   devices=devices)
                        got = tier.get(skey)
                        if got is not None:
                            dev_values, dev_lengths = _resident_stack(got, cap)
                scan = make_sharded_rle_scan(self.mesh, n_cols, self.max_codes, pad)
                with dispatch_lock:
                    # host arrays ship inside the dispatch (the transfer
                    # is part of its time); resident stacks ship nothing
                    masks, _totals = timed_dispatch(
                        "mesh_rle_scan", scan,
                        dev_values,
                        dev_lengths,
                        codes.reshape(self.w, self.r, n_cols, self.max_codes),
                        valid.reshape(self.w, self.r, pad),
                        device=self.mesh.lead,
                    )
                    masks_np = masks.reshape(cap, pad)
                h2d = codes.nbytes + valid.nbytes
                if isinstance(dev_values, np.ndarray):
                    h2d += dev_values.nbytes + dev_lengths.nbytes
                count_transfer("mesh_rle_scan", h2d=h2d, d2h=masks_np.nbytes)
                stats["units_runspace"] += len(live)
                stats["h2d_bytes"] += h2d
            else:
                scan = self._scan(n_cols)
                cols = np.zeros((cap, n_cols, pad), np.uint32)
                for s, (blk, i, rg, preds) in enumerate(chunk):
                    try:
                        for c, (col_name, accept) in enumerate(preds["span_eq"]):
                            cols[s, c, : rg.n_spans] = with_retries(
                                lambda b=blk, j=i, r=rg, n=col_name: self._col(b, j, r, n))
                            k = min(len(accept), self.max_codes)
                            codes[s, c, :k] = accept[:k]
                    except Exception as e:  # e.g. block deleted mid-query
                        errors.append((blk, e))
                        log.warning("mesh search: column load failed: %s", e)
                        continue
                    for c in range(len(preds["span_eq"]), n_cols):
                        # unit has fewer predicates than the widest: accept-all
                        codes[s, c, 0] = 0
                    valid[s, : rg.n_spans] = True
                    live.append(s)
                with dispatch_lock:
                    masks, _totals = timed_dispatch(
                        "mesh_scan", scan,
                        cols.reshape(self.w, self.r, n_cols, pad),
                        codes.reshape(self.w, self.r, n_cols, self.max_codes),
                        valid.reshape(self.w, self.r, pad),
                        device=self.mesh.lead,
                    )
                    masks_np = masks.reshape(cap, pad)
                count_transfer("mesh_scan", h2d=cols.nbytes + codes.nbytes + valid.nbytes,
                               d2h=masks_np.nbytes)
                stats["h2d_bytes"] += cols.nbytes + codes.nbytes + valid.nbytes
            stats["dispatches"] += 1
            stats["units_scanned"] += len(live)
            stats["collectives"] += 1  # psum of the per-window hit count
            stats["d2h_bytes"] += masks_np.nbytes
            stats["per_shard_rows"] += valid.sum(axis=1)
            for s in live:
                blk, i, rg, preds = chunk[s]
                resp.inspected_traces += rg.n_traces
                span_mask = masks_np[s, : rg.n_spans].copy()
                if not span_mask.any():
                    continue
                try:
                    # idempotent under retry: hit dedupe rides seen_ids
                    with_retries(lambda b=blk, j=i, r=rg, p=preds, m=span_mask:
                                 collect(b, j, r, p, m))
                except Exception as e:
                    errors.append((blk, e))
                    log.warning("mesh search: hit collection failed: %s", e)
                if done:
                    return

        for blk in blocks:
            if done:
                break
            opened.append(blk)
            resp.inspected_blocks += 1
            try:
                preds = _resolve_tag_predicates(req, with_retries(blk.dictionary))
                if preds is None:
                    continue  # impossible in this block: no more IO for it
                row_groups = list(with_retries(blk.index).row_groups)
            except Exception as e:
                # a block deleted between the blocklist snapshot and the
                # read (NotFound) must not abort the whole tenant search;
                # anything else is surfaced below
                errors.append((blk, e))
                log.warning("mesh search: block %s unreadable: %s", blk.meta.block_id, e)
                continue
            for i, rg in enumerate(row_groups):
                if req.start_seconds and rg.end_s < req.start_seconds:
                    continue
                if req.end_seconds and rg.start_s > req.end_seconds:
                    continue
                if zm and zone_prunes(rg, preds, req):
                    # zero reads, zero device lanes for this unit
                    resp.pruned_row_groups += 1
                    pruned_row_groups_total.inc()
                    continue
                pending.append((blk, i, rg, preds))
                if len(pending) >= cap:
                    flush(pending)
                    pending = []
                    if done:
                        break
        if not done:
            flush(pending)

        from tempo_tpu_torch.backend.base import NotFound

        failed: dict = {}
        for bad_blk, e in errors:
            failed.setdefault(bad_blk.meta.block_id, e)
        for b in opened:
            bid = b.meta.block_id
            if bid in failed:
                # NotFound is neither a strike nor a success: a block
                # deleted by compaction mid-query is a benign race, not
                # quarantine evidence (same exemption as guard_block)
                if on_block_error is not None and not isinstance(failed[bid], NotFound):
                    on_block_error(bid, failed[bid])
            elif on_block_ok is not None:
                on_block_ok(bid)
        fatal = [e for _, e in errors if not isinstance(e, NotFound)]
        if fatal:
            raise fatal[0]

        # same result discipline as SearchResponse.merge: newest first,
        # truncated to the limit (dedupe already applied via seen_ids)
        hits.sort(key=lambda t: -t.start_time_unix_nano)
        resp.traces = hits[: req.limit] if req.limit else hits
        # inspected bytes = actual IO of every opened block (cache hits
        # cost no IO and are deliberately not counted)
        resp.inspected_bytes = sum(b.bytes_read for b in opened)
        resp.decoded_bytes = sum(getattr(b, "decoded_bytes", 0) for b in opened)
        resp.coalesced_reads = sum(getattr(b, "coalesced_reads", 0) for b in opened)
        return resp


    # -- batched multi-query search --------------------------------------
    def search_blocks_multi(self, blocks, reqs, on_block_error=None,
                            on_block_ok=None) -> list:
        """N concurrent queries over the SAME block list, coalesced: each
        (block, row-group) unit's rle run payload is stacked ONCE (or
        served straight from the device-resident hot tier) and every
        query's predicate set scans it in fused multi-query launches —
        ceil(N / max_query_batch) dispatches per chunk instead of N.

        Per-query semantics are bit-identical to N sequential
        search_blocks calls: each query keeps its own predicate
        resolution, zone pruning, time-window filter, attr/duration
        post-filters, dedupe and limit. Units whose predicate pages are
        not all-rle fall back to the host row-group scan per query.
        Returns one SearchResponse per request, in order."""
        import logging

        from tempo_tpu_torch.backend.faults import with_retries
        from tempo_tpu_torch.encoding.common import SearchResponse
        from tempo_tpu_torch.encoding.vtpu.block import (
            _resolve_tag_predicates,
            attr_predicate_mask,
            pruned_row_groups_total,
            zone_maps_enabled,
            zone_prunes,
        )
        from tempo_tpu_torch.encoding.vtpu.colcache import shared_device_tier

        log = logging.getLogger(__name__)
        reqs = list(reqs)
        nq = len(reqs)
        if nq == 0:
            return []
        if nq == 1:
            return [self.search_blocks(blocks, reqs[0], on_block_error,
                                       on_block_ok)]
        zm = zone_maps_enabled()
        tier = shared_device_tier()
        batch = tier.max_query_batch if tier is not None else MAX_QUERY_BATCH
        resps = [SearchResponse() for _ in reqs]
        seen: list = [set() for _ in reqs]
        hits: list = [[] for _ in reqs]
        done = [False] * nq
        opened: list = []
        errors: list = []
        cap = self.w * self.r
        stats = self.last_stats = {
            "dispatches": 0, "units_scanned": 0, "units_runspace": 0,
            "h2d_bytes": 0, "d2h_bytes": 0, "collectives": 0,
            "queries": nq, "query_lanes": 0,
            "per_shard_rows": np.zeros(cap, np.int64),
        }

        def collect(q, blk, i, rg, preds, span_mask):
            req = reqs[q]
            have = {
                name: self._col(blk, i, rg, name)
                for name, _ in preds["span_eq"]
                if blk.encoded_column(rg, name) is None
            }
            if preds["attr"]:
                span_mask = span_mask & attr_predicate_mask(blk, rg, preds)
            if req.min_duration_ns or req.max_duration_ns:
                dur = blk.read_columns(rg, ["duration_nano"])["duration_nano"]
                have["duration_nano"] = dur
                if req.min_duration_ns:
                    span_mask = span_mask & (dur >= np.uint64(req.min_duration_ns))
                if req.max_duration_ns:
                    span_mask = span_mask & (dur <= np.uint64(req.max_duration_ns))
            if not span_mask.any():
                return
            for h in blk.hits_for_mask(rg, span_mask, req, 0, have_cols=have):
                if h.trace_id_hex not in seen[q]:
                    seen[q].add(h.trace_id_hex)
                    hits[q].append(h)
            if req.limit and len(seen[q]) >= req.limit:
                done[q] = True

        def host_unit(q, blk, i, rg, preds):
            resps[q].inspected_traces += rg.n_traces
            try:
                rows = with_retries(
                    lambda b=blk, r=rg, p=preds:
                    list(b._search_row_group(r, reqs[q], p, limit=0)))
                for h in rows:
                    if h.trace_id_hex not in seen[q]:
                        seen[q].add(h.trace_id_hex)
                        hits[q].append(h)
            except Exception as e:
                errors.append((blk, e))
                log.warning("mesh multi-search: row group scan failed: %s", e)
            if reqs[q].limit and len(seen[q]) >= reqs[q].limit:
                done[q] = True

        def flush_multi(chunk):
            # chunk: list of (blk, i, rg, preds_q, want) — preds_q is the
            # per-query predicate resolution against this unit's block,
            # want the per-query participation mask
            if not chunk:
                return
            units = []  # device-eligible: (blk, i, rg, preds_q, want, encs, cols)
            for blk, i, rg, preds_q, want in chunk:
                cols: list = []  # first-seen-ordered union of constrained columns
                for q in range(nq):
                    if want[q]:
                        for name, _ in preds_q[q]["span_eq"]:
                            if name not in cols:
                                cols.append(name)
                encs = []
                ok = True
                for name in cols:
                    enc = blk.encoded_column(rg, name)
                    if enc is None or enc.codec != "rle":
                        ok = False
                        break
                    encs.append(enc)
                if ok:
                    units.append((blk, i, rg, preds_q, want, encs, cols))
                else:
                    for q in range(nq):
                        if want[q] and not done[q]:
                            host_unit(q, blk, i, rg, preds_q[q])
            if not units or all(done):
                return
            n_cols = max(1, max(len(u[6]) for u in units))
            pad = self.bucket_for(max(u[2].n_spans for u in units))
            pkeys = tuple(tuple(e.resident_key() for e in u[5]) for u in units)
            skey = ("mesh_stack", pkeys, n_cols, pad)
            res = tier.get(skey) if tier is not None else None
            loaded = [True] * len(units)
            if res is not None:
                run_pad = int(res.meta["run_pad"])
                dev_values, dev_lengths = _resident_stack(res, cap)
                tier.record_avoided(res.host_bytes, kernel="batched_rle_scan")
            else:
                max_runs = 8
                unit_runs: list = []
                for s, u in enumerate(units):
                    blk, i, rg = u[0], u[1], u[2]
                    try:
                        runs = [with_retries(e.runs) for e in u[5]]
                    except Exception as e:
                        errors.append((blk, e))
                        log.warning("mesh multi-search: run load failed: %s", e)
                        unit_runs.append(None)
                        loaded[s] = False
                        continue
                    unit_runs.append(runs)
                    for v, l in runs:
                        max_runs = max(max_runs, len(l))
                run_pad = 1 << (max_runs - 1).bit_length()
                values = np.full((cap, n_cols, run_pad), NO_MATCH, np.uint32)
                lengths = np.zeros((cap, n_cols, run_pad), np.int32)
                for s, u in enumerate(units):
                    if unit_runs[s] is None:
                        continue
                    rg = u[2]
                    for c, (v, l) in enumerate(unit_runs[s]):
                        values[s, c, : len(v)] = v.astype(np.uint32)
                        lengths[s, c, : len(l)] = l
                    for c in range(len(u[6]), n_cols):
                        values[s, c, 0] = 0
                        lengths[s, c, 0] = rg.n_spans
                dev_values = values.reshape(self.w, self.r, n_cols, run_pad)
                dev_lengths = lengths.reshape(self.w, self.r, n_cols, run_pad)
                pkeys_flat = [k for row in pkeys for k in row]
                if tier is not None and all(loaded) and pkeys_flat:
                    arrays, devices = _stack_arrays(self.mesh, values, lengths)
                    tier.offer(skey, "rle_stack", arrays,
                               meta={"run_pad": run_pad},
                               host_bytes=values.nbytes + lengths.nbytes,
                               page_keys=pkeys_flat, devices=devices)
                    got = tier.get(skey)
                    if got is not None:
                        dev_values, dev_lengths = _resident_stack(got, cap)
            valid = np.zeros((cap, pad), bool)
            for s, u in enumerate(units):
                if loaded[s]:
                    valid[s, : u[2].n_spans] = True
            scan = make_sharded_batched_rle_scan(
                self.mesh, n_cols, self.max_codes, batch, pad)
            shipped_payload = isinstance(dev_values, np.ndarray)
            first_dispatch = True
            for g0 in range(0, nq, batch):
                lanes = [q for q in range(g0, min(g0 + batch, nq))]
                if not any(not done[q] and any(u[4][q] for u in units)
                           for q in lanes):
                    continue  # every query in this group is done/absent
                codes = np.full((cap, batch, n_cols, self.max_codes),
                                NO_MATCH, np.uint32)
                live = np.zeros((cap, batch, n_cols), bool)
                for s, u in enumerate(units):
                    if not loaded[s]:
                        continue
                    preds_q, want, cols = u[3], u[4], u[6]
                    for j, q in enumerate(lanes):
                        if not want[q] or done[q]:
                            continue
                        for name, accept in preds_q[q]["span_eq"]:
                            c = cols.index(name)
                            k = min(len(accept), self.max_codes)
                            codes[s, j, c, :k] = accept[:k]
                            live[s, j, c] = True
                with dispatch_lock:
                    masks, _totals = timed_dispatch(
                        "batched_rle_scan", scan,
                        dev_values,
                        dev_lengths,
                        codes.reshape(self.w, self.r, batch, n_cols,
                                      self.max_codes),
                        live.reshape(self.w, self.r, batch, n_cols),
                        valid.reshape(self.w, self.r, pad),
                        device=self.mesh.lead,
                    )
                    masks_np = masks.reshape(cap, batch, pad)
                stats["dispatches"] += 1
                stats["collectives"] += 1
                active_lanes = sum(
                    1 for q in lanes if not done[q]
                    and any(u[4][q] for u in units))
                stats["query_lanes"] += active_lanes
                batched_lanes_total.inc(active_lanes)
                stats["d2h_bytes"] += masks_np.nbytes
                h2d = codes.nbytes + live.nbytes
                if first_dispatch:
                    h2d += valid.nbytes
                    if shipped_payload:
                        h2d += dev_values.nbytes + dev_lengths.nbytes
                stats["h2d_bytes"] += h2d
                count_transfer("batched_rle_scan", h2d=h2d, d2h=masks_np.nbytes)
                if first_dispatch:
                    stats["units_scanned"] += sum(loaded)
                    stats["units_runspace"] += sum(loaded)
                    stats["per_shard_rows"] += valid.sum(axis=1)
                first_dispatch = False
                for s, u in enumerate(units):
                    if not loaded[s]:
                        continue
                    blk, i, rg, preds_q, want = u[0], u[1], u[2], u[3], u[4]
                    for j, q in enumerate(lanes):
                        if not want[q] or done[q]:
                            continue
                        resps[q].inspected_traces += rg.n_traces
                        span_mask = masks_np[s, j, : rg.n_spans].copy()
                        if not span_mask.any():
                            continue
                        try:
                            with_retries(
                                lambda qq=q, b=blk, jj=i, r=rg,
                                p=preds_q[q], m=span_mask:
                                collect(qq, b, jj, r, p, m))
                        except Exception as e:
                            errors.append((blk, e))
                            log.warning(
                                "mesh multi-search: hit collection failed: %s", e)
                if all(done):
                    return

        pending: list = []
        for blk in blocks:
            if all(done):
                break
            opened.append(blk)
            for resp in resps:
                resp.inspected_blocks += 1
            try:
                dic = with_retries(blk.dictionary)
                preds_q = [_resolve_tag_predicates(r, dic) for r in reqs]
                if all(p is None for p in preds_q):
                    continue  # impossible for every query: no more IO
                row_groups = list(with_retries(blk.index).row_groups)
            except Exception as e:
                errors.append((blk, e))
                log.warning("mesh multi-search: block %s unreadable: %s",
                            blk.meta.block_id, e)
                continue
            for i, rg in enumerate(row_groups):
                want = []
                for q, (req, p) in enumerate(zip(reqs, preds_q)):
                    w = p is not None and not done[q]
                    if w and req.start_seconds and rg.end_s < req.start_seconds:
                        w = False
                    if w and req.end_seconds and rg.start_s > req.end_seconds:
                        w = False
                    if w and zm and zone_prunes(rg, p, req):
                        resps[q].pruned_row_groups += 1
                        pruned_row_groups_total.inc()
                        w = False
                    want.append(w)
                if not any(want):
                    continue
                pending.append((blk, i, rg, preds_q, want))
                if len(pending) >= cap:
                    flush_multi(pending)
                    pending = []
                    if all(done):
                        break
        if not all(done):
            flush_multi(pending)

        from tempo_tpu_torch.backend.base import NotFound

        failed: dict = {}
        for bad_blk, e in errors:
            failed.setdefault(bad_blk.meta.block_id, e)
        for b in opened:
            bid = b.meta.block_id
            if bid in failed:
                if on_block_error is not None and not isinstance(
                        failed[bid], NotFound):
                    on_block_error(bid, failed[bid])
            elif on_block_ok is not None:
                on_block_ok(bid)
        fatal = [e for _, e in errors if not isinstance(e, NotFound)]
        if fatal:
            raise fatal[0]

        inspected = sum(b.bytes_read for b in opened)
        decoded = sum(getattr(b, "decoded_bytes", 0) for b in opened)
        coalesced = sum(getattr(b, "coalesced_reads", 0) for b in opened)
        for q, resp in enumerate(resps):
            hits[q].sort(key=lambda t: -t.start_time_unix_nano)
            resp.traces = (hits[q][: reqs[q].limit]
                           if reqs[q].limit else hits[q])
            resp.inspected_bytes = inspected
            resp.decoded_bytes = decoded
            resp.coalesced_reads = coalesced
        return resps


NO_MATCH = np.uint32(0xFFFFFFFF)
MAX_QUERY_BATCH = 8  # query lanes per fused multi-query dispatch (default)


def pack_predicates(code_sets: list[np.ndarray], max_codes: int) -> np.ndarray:
    """(C, K) uint32 code matrix padded with the NO_MATCH sentinel."""
    out = np.full((len(code_sets), max_codes), NO_MATCH, np.uint32)
    for i, cs in enumerate(code_sets):
        if len(cs) > max_codes:
            raise ValueError(f"predicate {i}: {len(cs)} codes > max_codes {max_codes}")
        out[i, : len(cs)] = cs
    return out


def stack_shards(arrays: list[np.ndarray], w: int, r: int, pad_to: int,
                 fill=0) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-shard row batches into the (W, R, ..., pad_to) device
    layout; returns (stacked, valid)."""
    total = w * r
    if len(arrays) > total:
        raise ValueError(f"{len(arrays)} shards > mesh capacity {total}")
    sample = arrays[0]
    inner = sample.shape[:-1]
    stacked = np.full((total, *inner, pad_to), fill, sample.dtype)
    valid = np.zeros((total, pad_to), bool)
    for i, a in enumerate(arrays):
        n = a.shape[-1]
        if n > pad_to:
            raise ValueError(f"shard {i} length {n} > pad_to {pad_to}")
        stacked[i, ..., :n] = a
        valid[i, :n] = True
    return (
        stacked.reshape(w, r, *inner, pad_to),
        valid.reshape(w, r, pad_to),
    )
