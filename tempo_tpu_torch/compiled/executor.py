"""Compiled-tier execution: bind blocks, stack units, launch once.

Port of tempo_tpu/compiled/executor.py. The interpreter walks every row
group through plan -> predicate eval -> gather -> seg_bincount. Here the
whole query becomes:

  1. BIND (host, per block under guard_block): resolve each predicate's
     code set against the block dictionary, collect each surviving row
     group's ENCODED pages (rle runs / dct dictionary+index / dbp packed
     words) plus its epoch-seconds column. Zone-map and time pruning
     reuse the interpreter's own hooks, so the same row groups prune. A
     row group whose pages cannot bind (legacy entropy codec, vector
     columns, u32-overflowing values) is evaluated right here by the
     interpreter — a decline, bit-identical by construction.
  2. STACK (host): bound units group by codec mix and pad to shared pow2
     widths; the query-independent stack is offered to the device tier
     (encoding/vtpu/colcache.DeviceTier) under a composite key, so
     repeated shapes over the same block set ship ZERO payload bytes.
     A stack the tier does not hold moves to the DB's device.
  3. LAUNCH (device, once per codec group, under dispatch_lock): the
     fused program of compiled/program.py — filter + time-bin + count for
     all Q query lanes over all U units in one dispatch (a prepare and a
     count launch, the dbp decode fused into the count).

Counts are integers and merge by addition, so folding device partials
with interpreter partials is exact.

Unlike the reference, a failure of the tier raises instead of falling
back to the interpreter: only the declines above reach it.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tempo_tpu_torch.backend.base import NotFound
from tempo_tpu_torch.compiled import cache as cache_mod
from tempo_tpu_torch.compiled.lower import (
    NO_MATCH,
    lower_metrics_plan,
    resolve_codes,
)
from tempo_tpu_torch.compiled.program import build_metrics_program
from tempo_tpu_torch.encoding.vtpu.colcache import device_tensor as _tensor
from tempo_tpu_torch.ops.scan import pad_codes_u32
from tempo_tpu_torch.util import queryshape

log = logging.getLogger(__name__)

_TS_MAX = (1 << 32) - 1


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class _Unit:
    """One bound row group: encoded payloads per predicate column plus
    the epoch-seconds column, ready to stack."""

    __slots__ = ("n", "t_s", "cols", "pkeys")

    def __init__(self, n, t_s, cols, pkeys):
        self.n = n
        self.t_s = t_s
        self.cols = cols  # per pred: (codec, arrays: dict, meta: dict)
        self.pkeys = pkeys


def _bind_unit(blk, rg, lowered):
    """The row group's device payload, or None -> interpreter fallback.
    Reads happen here (inside the caller's guard_block), so a block
    deleted later cannot corrupt the dispatch."""
    cols, pkeys = [], []
    for (kind, col, *_rest) in lowered.colsig:
        enc = blk.encoded_column(rg, col)
        if enc is None:
            return None  # legacy entropy page / runspace off
        payload = enc.resident_payload()
        if payload is None:
            return None  # vector column, >32-bit rle/dct values, ...
        codec, arrays, meta, _hb = payload
        if kind == "set" and codec not in ("rle", "dct"):
            return None  # set membership needs u32 code values
        cols.append((codec, arrays, meta))
        pkeys.append(enc.resident_key())
    t_ns = blk.read_columns(rg, ["start_unix_nano"])["start_unix_nano"]
    t_s = (np.asarray(t_ns, np.uint64) // np.uint64(10 ** 9))
    if t_s.size and int(t_s.max()) > _TS_MAX:
        return None  # past-2106 garbage: u32 seconds would wrap
    pm = rg.pages["start_unix_nano"]
    pkeys.append((str(blk.meta.block_id), "start_unix_nano", int(pm.offset)))
    return _Unit(rg.n_spans, t_s.astype(np.uint32), cols, tuple(pkeys))


def _group_key(unit):
    return tuple(c[0] for c in unit.cols)


def _dbp_words_needed(n_pad: int, width: int) -> int:
    # the decode reads words[word_i] and words[word_i + 1] for deltas
    # 0..n_pad-2; one extra guard word on top
    return (((n_pad - 1) * max(int(width), 1)) >> 5) + 2


def _stack_group(units, colsig, n_pad):
    """Query-independent stacked host arrays for one codec group:
    (t_s (U,N), valid (U,N), payloads tuple, pads)."""
    u = len(units)
    t_s = np.zeros((u, n_pad), np.uint32)
    valid = np.zeros((u, n_pad), bool)
    for s, un in enumerate(units):
        t_s[s, : un.n] = un.t_s
        valid[s, : un.n] = True
    payloads, pads = [], []
    for i, _cs in enumerate(colsig):
        codec = units[0].cols[i][0]
        if codec == "rle":
            rp = _pow2(max(len(un.cols[i][1]["lengths"]) for un in units))
            values = np.full((u, rp), NO_MATCH, np.uint32)
            lengths = np.zeros((u, rp), np.int32)
            for s, un in enumerate(units):
                v, ln = un.cols[i][1]["values"], un.cols[i][1]["lengths"]
                values[s, : len(v)] = v
                lengths[s, : len(ln)] = ln
            payloads.append((values, lengths))
            pads.append(rp)
        elif codec == "dct":
            vp = _pow2(max(len(un.cols[i][1]["values"]) for un in units))
            dvals = np.full((u, vp), NO_MATCH, np.uint32)
            idx = np.zeros((u, n_pad), np.int32)
            for s, un in enumerate(units):
                dv, ix = un.cols[i][1]["values"], un.cols[i][1]["idx"]
                dvals[s, : len(dv)] = dv
                idx[s, : len(ix)] = ix
            payloads.append((dvals, idx))
            pads.append(vp)
        else:  # dbp
            wp = _pow2(max(
                max(len(un.cols[i][1]["words"]),
                    _dbp_words_needed(n_pad, un.cols[i][2]["width"]))
                for un in units))
            words = np.zeros((u, wp), np.uint32)
            first = np.zeros(u, np.uint64)
            width = np.zeros(u, np.int32)
            for s, un in enumerate(units):
                w = un.cols[i][1]["words"]
                words[s, : len(w)] = w
                first[s] = int(un.cols[i][2]["first"])
                width[s] = int(un.cols[i][2]["width"])
            payloads.append((words, first, width))
            pads.append(wp)
    return t_s, valid, tuple(payloads), tuple(pads)


def _stack_arrays(t_s, valid, payloads) -> dict:
    """A stack's arrays by name, as the device tier holds them."""
    arrays = {"t_s": t_s, "valid": valid}
    for i, p in enumerate(payloads):
        for j, a in enumerate(p):
            arrays[f"c{i}_{j}"] = a
    return arrays


def _resident_payloads(res, colsig):
    """Rebuild the (t_s, valid, payloads) tuple from a resident entry's
    tensors (the naming _stack_group gave them when offering)."""
    width = {"rle": 2, "dct": 2, "dbp": 3}
    payloads = tuple(tuple(res.arrays[f"c{i}_{j}"] for j in range(width[codec]))
                     for i, codec in enumerate(res.meta["codecs"][: len(colsig)]))
    return res.arrays["t_s"], res.arrays["valid"], payloads


def _dispatch_group(cache, units, colsig, plans, lanes, slot_pad, device):
    """ONE fused dispatch for one codec group; returns the (Q, slot_pad)
    counts. lanes[q] = per-plan list of per-unit code sets /
    bounds, aligned with `units`."""
    from tempo_tpu_torch.encoding.vtpu.colcache import shared_device_tier
    from tempo_tpu_torch.parallel.search import dispatch_lock
    from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

    n_pad = _pow2(max(un.n for un in units))
    gkey = tuple(c[0] for c in units[0].cols)
    pkeys = tuple(un.pkeys for un in units)
    skey = ("compiled_stack", pkeys, gkey, n_pad)

    tier = shared_device_tier()
    res = tier.get(skey) if tier is not None else None
    if res is not None:
        t_s, valid, payloads = _resident_payloads(res, colsig)
        pads = tuple(res.meta["pads"])
        tier.record_avoided(res.host_bytes, kernel="compiled_metrics")
    else:
        t_s, valid, payloads, pads = _stack_group(units, colsig, n_pad)
        if tier is not None:
            arrays = _stack_arrays(t_s, valid, payloads)
            tier.offer(skey, "compiled_stack", arrays,
                       meta={"pads": list(pads), "codecs": list(gkey)},
                       host_bytes=sum(a.nbytes for a in arrays.values()),
                       page_keys=[k for un in units for k in un.pkeys])
            res = tier.get(skey)
            if res is not None:
                t_s, valid, payloads = _resident_payloads(res, colsig)

    # per-lane runtime args: codes (Q, U, K) per set column (each block
    # dictionary maps the literal to its own codes), bounds (Q, 2) per
    # range column, window (Q, 2) + n_bins (Q,)
    q = len(plans)
    qargs, sig_cols = [], []
    for i, cs in enumerate(colsig):
        codec = gkey[i]
        if cs[0] == "set":
            # pad_codes_u32 pow2-pads each set by repeating its first
            # code (and maps empty sets to [NO_MATCH]); a second repeat
            # pad widens every lane to the group-wide k_pad
            padded = [[pad_codes_u32(lanes[qq][i][s])
                       for s in range(len(units))] for qq in range(q)]
            k_pad = max(len(c) for row in padded for c in row)
            codes = np.empty((q, len(units), k_pad), np.uint32)
            for qq in range(q):
                for s in range(len(units)):
                    cset = padded[qq][s]
                    codes[qq, s, : len(cset)] = cset
                    codes[qq, s, len(cset):] = cset[0]
            qargs.append(codes)
            sig_cols.append((codec, "set", cs[2], k_pad))
        else:
            bounds = np.zeros((q, 2), np.uint64)
            for qq in range(q):
                # range bounds are per plan, the same for every unit
                bounds[qq] = lanes[qq][i][0]
            qargs.append(bounds)
            sig_cols.append((codec, "range", False, pads[i]))
    tb = np.array([[p.start_s, p.step_s] for p in plans], np.uint32)
    nb = np.array([p.n_bins for p in plans], np.uint32)

    sig = (tuple(sig_cols), n_pad, slot_pad, q)
    prog = cache.program(sig, build_metrics_program)

    def dev(a):
        return _tensor(a, device)

    def launch():
        if res is None:  # the stack ships; a resident one is on the card already
            stack = dev(t_s), dev(valid), tuple(tuple(dev(a) for a in p) for p in payloads)
        else:
            stack = t_s, valid, payloads
        return prog(*stack, tuple(dev(a) for a in qargs), dev(tb), dev(nb))

    with dispatch_lock:
        counts = timed_dispatch("compiled_metrics", launch, device=device)
        # no bin can count more rows than the stack holds, so below 2^31
        # rows the counts come back as int32, the reference's type
        if len(units) * n_pad < 1 << 31:
            counts = counts.to(torch.int32)
        counts = counts.cpu().numpy()
    stack_bytes = (t_s.nbytes + valid.nbytes + sum(a.nbytes for p in payloads for a in p))
    args_bytes = sum(a.nbytes for a in qargs) + tb.nbytes + nb.nbytes
    if res is None:
        count_transfer("compiled_metrics", h2d=stack_bytes + args_bytes, d2h=counts.nbytes)
    else:
        count_transfer("compiled_metrics", h2d=args_bytes, d2h=counts.nbytes,
                       resident=stack_bytes)
    return counts


def run_query_range(db, tenant, plans, lowereds, metas):
    """Evaluate Q same-shape lowered plans over one block set; returns
    per-plan HostAccumulator wires. Shared page set, one dispatch per
    codec group."""
    from tempo_tpu_torch.encoding.vtpu.block import (
        pruned_row_groups_total,
        zone_maps_enabled,
    )
    from tempo_tpu_torch.metrics_engine.evaluate import (
        HostAccumulator,
        _lower_prunes,
        eval_batch,
        rg_eval_view,
        rg_prunes,
    )

    cache = cache_mod.shape_cache()
    q = len(plans)
    accs = [HostAccumulator(p) for p in plans]
    zm = zone_maps_enabled()
    units: list = []          # bound _Units across all blocks
    unit_lanes: list = []     # parallel: per-plan resolved preds per unit
    slot_pad = _pow2(max(p.n_bins for p in plans))

    for m in metas:
        staged: dict = {"units": [], "lanes": [], "subs": None}

        def run(meta=m, staged=staged):
            blk = db.encoding_for(meta.version).open_block(
                meta, db.backend, db.cfg.block)
            d = blk.dictionary()
            subs = [HostAccumulator(p, series=a.series)
                    for p, a in zip(plans, accs)]
            for s in subs:
                s.stats["inspectedBlocks"] += 1
            prune_info = []
            for p in plans:
                resolvers, impossible = _lower_prunes(p, d)
                all_conds = p.pipeline.conditions().all_conditions
                prune_info.append((resolvers, impossible, all_conds))
            if all(pi[1] for pi in prune_info):
                # every lane's filter literal is absent from the block
                # dictionary: zero page IO, same as evaluate_block's
                # impossible early return (bytes below still count the
                # dictionary read, as the interpreter's do)
                for s in subs:
                    s.stats["inspectedBytes"] += blk.bytes_read
                    s.stats["decodedBytes"] += getattr(blk, "decoded_bytes", 0)
                staged["subs"] = subs
                return

            # resolve each set predicate ONCE per (plan, block): all of
            # a block's row groups share the dictionary
            block_codes = []
            for p, lw in zip(plans, lowereds):
                per_pred = []
                for pred in lw.preds:
                    if pred[0] == "set":
                        per_pred.append(resolve_codes(pred, d))
                    else:
                        per_pred.append((pred[2], pred[3]))
                block_codes.append(per_pred)

            for rg in blk.index().row_groups:
                wants = []
                for qq, p in enumerate(plans):
                    resolvers, impossible, all_conds = prune_info[qq]
                    if impossible:
                        wants.append(False)
                        continue
                    if rg.end_s < p.start_s or rg.start_s > p.end_s:
                        wants.append(False)
                        continue
                    if zm and resolvers and rg_prunes(p, rg, resolvers,
                                                      all_conds):
                        subs[qq].stats["prunedRowGroups"] += 1
                        blk.pruned_row_groups += 1
                        pruned_row_groups_total.inc()
                        wants.append(False)
                        continue
                    subs[qq].stats["inspectedSpans"] += rg.n_spans
                    wants.append(True)
                if not any(wants):
                    continue
                unit = _bind_unit(blk, rg, lowereds[0])
                if unit is not None:
                    # device lanes evaluate EVERY plan over the unit: a
                    # lane whose pruning rejected this row group counts
                    # zero there by zone-map soundness, so sharing the
                    # stack never changes results
                    staged["units"].append(unit)
                    staged["lanes"].append(
                        [[bc[i] for i in range(len(lowereds[0].preds))]
                         for bc in block_codes])
                else:
                    for qq, p in enumerate(plans):
                        if not wants[qq]:
                            continue
                        view, premask, dead = rg_eval_view(p, blk, rg, d)
                        if dead:
                            continue
                        subs[qq].add(
                            eval_batch(p, view, d, subs[qq].series,
                                       premask=premask), view)
            for s in subs:
                s.stats["inspectedBytes"] += blk.bytes_read
                s.stats["decodedBytes"] += getattr(blk, "decoded_bytes", 0)
            staged["subs"] = subs

        try:
            db.guard_block(tenant, m.block_id, run)
        except NotFound:
            # deleted by compaction mid-query: benign, its spans live on
            # in the compaction output; any OTHER failure propagates
            log.warning("compiled metrics: block %s deleted mid-query",
                        m.block_id)
            continue
        # commit-whole: the block's units and fallback partials land
        # only after guard_block succeeds
        units.extend(staged["units"])
        unit_lanes.extend(staged["lanes"])
        if staged["subs"] is not None:
            for acc, sub in zip(accs, staged["subs"]):
                acc.counts += sub.merged_counts()
                for k, v in sub.stats.items():
                    acc.stats[k] = acc.stats.get(k, 0) + v

    # ---- stack + launch: one dispatch per codec group ----------------
    groups: dict = {}
    for ui, un in enumerate(units):
        groups.setdefault(_group_key(un), []).append(ui)
    for _gkey, idxs in groups.items():
        g_units = [units[i] for i in idxs]
        # lanes[q][pred][unit] aligned with g_units
        lanes = [
            [[unit_lanes[i][qq][pi] for i in idxs]
             for pi in range(len(lowereds[0].preds))]
            for qq in range(q)
        ]
        counts = _dispatch_group(cache, g_units, lowereds[0].colsig,
                                 plans, lanes, slot_pad, db.device)
        for qq, (p, acc) in enumerate(zip(plans, accs)):
            acc.counts[: p.n_bins] += counts[qq, : p.n_bins].astype(np.int64)

    wires = []
    for acc in accs:
        if acc.counts.any():
            acc.series.slot_of("")  # the single unlabeled series
        wires.append(acc.to_wire())
    return wires


def try_query_range(db, tenant, plan, metas):
    """Compiled-tier attempt for one metrics job. Returns the wire dict
    (with `compiledShape` set to hit|miss) or None when the tier is off
    or the plan does not lower — the caller then runs the interpreter.
    A failure of the tier raises."""
    if not cache_mod.enabled():
        return None
    cache = cache_mod.shape_cache()
    key = queryshape.metrics_shape(plan.query)
    entry, hit = cache.lookup(key)
    if entry is not None and not entry.lowerable:
        return None  # known-unlowerable shape: no AST re-walk
    lowered = lower_metrics_plan(plan)
    if entry is None:
        cache.store(key, lowerable=lowered is not None)
    if lowered is None:
        return None
    wires = run_query_range(db, tenant, [plan], [lowered], metas)
    wires[0]["compiledShape"] = "hit" if hit else "miss"
    return wires[0]


def try_query_range_many(db, tenant, plans, metas):
    """Batched entry: N concurrent plans; same-shape lowerable lanes
    share ONE binding + launch, the rest return None (the caller runs
    them one by one). The result list is aligned with `plans`."""
    if not cache_mod.enabled():
        return [None] * len(plans)
    cache = cache_mod.shape_cache()
    out: list = [None] * len(plans)
    lanes: dict = {}  # (shape key) -> [(index, plan, lowered, hit)]
    for i, plan in enumerate(plans):
        key = queryshape.metrics_shape(plan.query)
        entry, hit = cache.lookup(key)
        if entry is not None and not entry.lowerable:
            continue
        lowered = lower_metrics_plan(plan)
        if entry is None:
            cache.store(key, lowerable=lowered is not None)
        if lowered is None:
            continue
        lanes.setdefault((key, lowered.colsig), []).append(
            (i, plan, lowered, hit))
    for (_key, _sig), members in lanes.items():
        wires = run_query_range(
            db, tenant,
            [m[1] for m in members], [m[2] for m in members], metas)
        for (i, _p, _lw, hit), wire in zip(members, wires):
            wire["compiledShape"] = "hit" if hit else "miss"
            out[i] = wire
    return out


def observe_search_shape(req) -> str:
    """Record one search request's shape against the executable cache;
    the returned hit|miss feeds compiledShape on search insights
    records. Returns "fallback" when the tier is disabled."""
    if not cache_mod.enabled():
        return "fallback"
    cache = cache_mod.shape_cache()
    key = queryshape.search_shape(req)
    entry, hit = cache.lookup(key)
    if entry is None:
        cache.store(key, lowerable=True)
    return "hit" if hit else "miss"
