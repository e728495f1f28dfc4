"""Metrics evaluation: span rows -> combined slot index -> bincount.

Port of tempo_tpu/metrics_engine/evaluate.py. Every stage of
`| rate() by (...)` / `| quantile_over_time(...)` reduces to one
combined slot index per span — series slot (by() value), time bin and,
for histogram functions, the log-scale value bucket — with -1 for spans
the filters reject or the window excludes. Counting those ids IS the
range-vector partial:

    counts[(series * n_bins + bin) * n_buckets + bucket] += 1

Counts are integers and merge by addition, so the host numpy fold
(HostAccumulator) and the CUDA kernel behind DeviceAccumulator
(ops/pallas_kernels.seg_bincount, adding every flush into one count
vector on the card) produce the same vector bit for bit.
Filters and field expressions reuse the vectorized TraceQL evaluator
(traceql/vector.py). evaluate_block folds a stored vtpu1 block into an
accumulator, zone-map pruned, with filters answered in encoded space
where the pages allow (rg_eval_view).
"""

from __future__ import annotations

import numpy as np

import torch

from tempo_tpu_torch import device as _device
from tempo_tpu_torch.encoding.vtpu.block import _lower_condition, zone_maps_enabled
from tempo_tpu_torch.metrics_engine.plan import MetricsPlan
from tempo_tpu_torch.model.columnar import ATTR_COLUMNS, _empty_cols
from tempo_tpu_torch.ops.pallas_kernels import compress_slot_runs, seg_bincount_into
from tempo_tpu_torch.ops.sketch import np_hist_quantile
from tempo_tpu_torch.traceql import vector
from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch


def _id_to_hex(limbs: np.ndarray) -> str:
    return np.asarray(limbs, dtype=np.uint32).astype(">u4").tobytes().hex()


def new_stats() -> dict:
    return {
        "inspectedBytes": 0,
        "decodedBytes": 0,
        "inspectedBlocks": 0,
        "inspectedSpans": 0,
        "prunedRowGroups": 0,
        "seriesDropped": 0,
    }


def wire_stats_merge(dst: dict, src: dict) -> None:
    for k, v in (src or {}).items():
        dst[k] = dst.get(k, 0) + int(v)


class SeriesTable:
    """by()-value -> series slot, first-seen order, capped at
    max_series (overflow series are dropped and counted — the analog of
    the generator registry's active-series limit)."""

    def __init__(self, max_series: int):
        self.max_series = max_series
        self.slots: dict = {}  # key (str | None) -> slot id
        self.dropped = 0

    def slot_of(self, key) -> int:
        s = self.slots.get(key, -1)
        if s >= 0:
            return s
        if len(self.slots) >= self.max_series:
            self.dropped += 1
            return -1
        s = len(self.slots)
        self.slots[key] = s
        return s


class EvalResult:
    __slots__ = ("slots", "series_slot", "values", "matched")

    def __init__(self, slots, series_slot, values, matched):
        self.slots = slots  # (n,) int64 combined slot, -1 = not counted
        self.series_slot = series_slot  # (n,) int64, -1 = dropped/invalid
        self.values = values  # (n,) float64 read-out values (exemplars)
        self.matched = matched


def _format_group_value(kind, v, d) -> str:
    if kind == "str":
        return d[int(v)]
    if kind == "bool":
        return "true" if v else "false"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def eval_batch(plan: MetricsPlan, batch, dictionary, series: SeriesTable,
               premask: np.ndarray | None = None) -> EvalResult:
    """One row group (ColumnView) or span batch (SpanBatch) -> combined
    slot ids. Exact: filters/fields evaluate on the vectorized TraceQL
    path, identical to what search would match.

    premask: the filter-stage mask already computed in encoded (run/
    dictionary) space — vector.encoded_filter_mask guarantees it equals
    what the stages below would produce, so the filter columns are never
    expanded to rows."""
    n = batch.num_spans
    empty = EvalResult(np.empty(0, np.int64), np.empty(0, np.int64), None, 0)
    if n == 0:
        return empty
    ctx = vector._Ctx(batch=batch, d=dictionary, n=n)

    mask = premask
    if mask is None:
        for st in plan.filters:
            mask = vector._spanset_mask(st, ctx, base=mask)
    if mask is None:
        mask = np.ones(n, bool)

    t_ns = batch.cols["start_unix_nano"].astype(np.int64)
    step_ns = plan.step_s * 10**9
    bins = (t_ns - plan.start_s * 10**9) // step_ns
    valid = mask & (t_ns >= plan.start_s * 10**9) & (bins < plan.n_bins)
    matched = int(np.count_nonzero(valid))

    # series slot per span (by() grouping). Slots are assigned only for
    # values that actually appear on counted spans, so junk values on
    # filtered-out rows can't burn the series cap.
    sslot = np.zeros(n, np.int64)
    if plan.by_expr is None:
        if valid.any():
            series.slot_of("")  # register the single unlabeled series
    else:
        k, vals, defined = vector._eval(plan.by_expr, ctx)
        sslot = np.full(n, -1, np.int64)
        if k is None or vals is None:
            nil_rows = valid
            if nil_rows.any():
                sslot[nil_rows] = series.slot_of(None)
        else:
            live = valid & defined
            if live.any():
                uvals, inv = np.unique(vals[live], return_inverse=True)
                lut = np.array(
                    [series.slot_of(_format_group_value(k, u, dictionary)) for u in uvals],
                    np.int64,
                )
                sslot[live] = lut[inv]
            nil_rows = valid & ~defined
            if nil_rows.any():
                sslot[nil_rows] = series.slot_of(None)
        valid = valid & (sslot >= 0)

    # measured value -> histogram bucket (quantile/histogram functions)
    bucket = 0
    if plan.hist is not None:
        vk, vvals, vdef = vector._eval(plan.value_expr, ctx)
        if vk != "num" or vvals is None:
            return EvalResult(np.full(n, -1, np.int64), sslot, None, 0)
        valid = valid & vdef
        bucket = plan.hist.np_bucket_of(vvals)
        values = vvals * plan.value_scale
    else:
        # exemplar read-out for rate/count: the span duration in seconds
        # (skipped entirely when no exemplars were requested)
        values = (
            batch.cols["duration_nano"].astype(np.float64) * 1e-9
            if plan.exemplars else None
        )

    flat = (sslot * plan.n_bins + bins) * plan.n_buckets + bucket
    slots = np.where(valid, flat, np.int64(-1))
    return EvalResult(slots, np.where(valid, sslot, np.int64(-1)), values, matched)


# ---------------------------------------------------------------------------
# accumulators
# ---------------------------------------------------------------------------


class HostAccumulator:
    """numpy fallback reduction (the host path, like the search scan)."""

    def __init__(self, plan: MetricsPlan, series: SeriesTable | None = None):
        self.plan = plan
        self.series = series or SeriesTable(plan.max_series)
        self.counts = np.zeros(plan.n_slots, np.int64)
        self.exemplars: dict = {}  # series key -> list[dict]
        self.stats = new_stats()

    def add(self, res: EvalResult, batch=None) -> None:
        live = res.slots[res.slots >= 0]
        if len(live):
            np.add.at(self.counts, live, 1)
        self.observe_exemplars(res, batch)

    def observe_exemplars(self, res: EvalResult, batch) -> None:
        plan = self.plan
        if not plan.exemplars or batch is None or res.values is None:
            return
        cand = np.flatnonzero(res.slots >= 0)
        if not len(cand):
            return
        for key, s in list(self.series.slots.items()):
            have = self.exemplars.setdefault(key, [])
            need = plan.exemplars - len(have)
            if need <= 0:
                continue
            rows = cand[res.series_slot[cand] == s][:need]
            for r in rows:
                # the generator registry's exemplar shape (traceID, value,
                # timestamp ms), as query_range answers it
                have.append({
                    "traceID": _id_to_hex(batch.cols["trace_id"][r]),
                    "value": float(res.values[r]),
                    "timestamp": int(batch.cols["start_unix_nano"][r]) // 10**6,
                })

    def merged_counts(self) -> np.ndarray:
        return self.counts

    def to_wire(self) -> dict:
        """JSON-safe partial for the frontend<->querier job protocol:
        sparse per-series (flat-bin, count) pairs + exemplars + stats."""
        plan = self.plan
        counts = self.merged_counts()
        per_series = counts.reshape(plan.max_series, plan.n_bins * plan.n_buckets)
        by_slot = {s: key for key, s in self.series.slots.items()}
        series_out = []
        for s, key in sorted(by_slot.items()):
            nz = np.flatnonzero(per_series[s])
            if not len(nz):
                continue
            series_out.append({
                "key": key,
                "bins": [[int(i), int(per_series[s][i])] for i in nz],
            })
        stats = dict(self.stats)
        stats["seriesDropped"] = stats.get("seriesDropped", 0) + self.series.dropped
        return {
            "series": series_out,
            "exemplars": [
                {"key": key, **ex}
                for key, exs in self.exemplars.items()
                for ex in exs
            ],
            "stats": stats,
        }


class DeviceAccumulator(HostAccumulator):
    """Single-device reduction: slot batches buffer host-side, run
    compressed at flush (spans of one trace share series and usually
    time bin, so consecutive slot ids repeat — compress_slot_runs
    collapses them to (slot, weight) pairs), and one seg_bincount
    launch on `device` folds many row groups at once. On CUDA that is
    the hand-written kernel; on the CPU its plain version. Every flush
    of a query adds into one int64 count vector that stays on `device`;
    merged_counts copies it to the host once."""

    def __init__(self, plan: MetricsPlan, series: SeriesTable | None = None,
                 flush_rows: int = 1 << 20, device=None):
        super().__init__(plan, series)
        self.device = _device.resolve(device)
        self._buf: list = []
        self._buf_rows = 0
        self._dev_counts: torch.Tensor | None = None  # counts not yet on the host
        self.flush_rows = flush_rows
        self.dispatches = 0

    def add(self, res: EvalResult, batch=None) -> None:
        # per-row-group cost is ONE list append: masking, run
        # compression and the fold all happen once per flush over the
        # concatenated stream (the kernel drops negative slots itself)
        if len(res.slots):
            self._buf.append(res.slots)
            self._buf_rows += len(res.slots)
        self.observe_exemplars(res, batch)
        if self._buf_rows >= self.flush_rows:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        raw = self._buf[0] if len(self._buf) == 1 else np.concatenate(self._buf)
        self._buf, self._buf_rows = [], 0
        slots, weights = compress_slot_runs(raw)
        # slot ids are < MAX_SLOTS (2**22) or -1, so int32 holds them
        d_slots = torch.from_numpy(np.ascontiguousarray(slots, np.int32)).to(self.device)
        d_w = (None if weights is None
               else torch.from_numpy(np.ascontiguousarray(weights, np.int32)).to(self.device))
        count_transfer("seg_bincount",
                       h2d=d_slots.numel() * 4 + (0 if d_w is None else d_w.numel() * 4))
        if self._dev_counts is None:
            self._dev_counts = torch.zeros(self.plan.n_slots, dtype=torch.int64,
                                           device=self.device)
        timed_dispatch("seg_bincount", seg_bincount_into, self._dev_counts, d_slots,
                       self.plan.n_slots, weights=d_w, device=self.device)
        self.dispatches += 1

    def merged_counts(self) -> np.ndarray:
        self.flush()
        if self._dev_counts is not None:
            self.counts += self._dev_counts.cpu().numpy()
            count_transfer("seg_bincount", d2h=self._dev_counts.numel() * 8)
            self._dev_counts = None
        return self.counts


def make_accumulator(plan: MetricsPlan, device=None) -> HostAccumulator:
    """Pick the reduction path from the resolved device: the CUDA kernel
    (DeviceAccumulator) on a CUDA device, the host numpy fold on the
    CPU. device=None means CUDA, and raises when CUDA is absent."""
    dev = _device.resolve(device)
    return DeviceAccumulator(plan, device=dev) if dev.type == "cuda" else HostAccumulator(plan)


# ---------------------------------------------------------------------------
# block evaluation
# ---------------------------------------------------------------------------


def _lower_prunes(plan: MetricsPlan, dictionary):
    """(resolvers, impossible): zone-map prune hooks for the filter
    conditions, exactly the fetch_candidates lowering — sound because
    conditions are the necessary predicates of the filter stages."""
    spec = plan.pipeline.conditions()
    resolvers = []
    for cond in spec.conditions:
        r = _lower_condition(cond, dictionary)
        if r == "impossible":
            if spec.all_conditions:
                return [], True
            continue  # OR: this arm matches nothing; others may match
        if r is None:
            if not spec.all_conditions:
                # OR with an opaque arm: pruning on the remaining arms
                # would drop spans only the opaque arm matches (same
                # guard as fetch_candidates' fetch_all)
                return [], False
            continue
        resolvers.append(r)
    return resolvers, False


def rg_prunes(plan: MetricsPlan, rg, resolvers, all_conditions: bool) -> bool:
    """True when time range or zone maps prove the row group contributes
    nothing (zero backend reads)."""
    if rg.end_s < plan.start_s or rg.start_s > plan.end_s:
        return True
    hooks = [r.prune(rg) for r in resolvers if getattr(r, "prune", None) is not None]
    if all_conditions:
        return any(hooks)
    return bool(hooks) and len(hooks) == len(resolvers) and all(hooks)


def rg_eval_view(plan: MetricsPlan, blk, rg, d):
    """(view, premask, dead) for one surviving row group: the filter
    stages are tried in ENCODED space first (vector.encoded_filter_mask
    over the row group's rle/dct pages — filter columns never expand);
    a dead premask means nothing in the group can match and NO column
    needs decoding at all. The view is lazy either way, so the rest of
    evaluation (bins, by(), value exprs) decodes exactly the columns it
    touches."""
    enc_of = (lambda name: blk.encoded_column(rg, name))
    premask = vector.encoded_filter_mask(plan.filters, enc_of, d, rg.n_spans)
    if premask is not None and not premask.any():
        return None, premask, True
    if premask is None:
        # filters need row space anyway: keep the ONE coalesced
        # projection read (gap-tolerant ranged IO) instead of a
        # round trip per touched column
        cols = blk.read_columns(rg, list(plan.span_cols))
        attrs = (blk.read_columns(rg, list(ATTR_COLUMNS))
                 if plan.needs_attrs else _empty_cols(ATTR_COLUMNS))
        return vector.ColumnView(cols, attrs, rg.n_spans), None, False
    view = vector.LazyColumnView(
        lambda name, b=blk, r=rg: b.read_columns(r, [name])[name],
        lambda name, b=blk, r=rg: b.read_columns(r, [name])[name],
        rg.n_spans,
        enc_of=enc_of,
    )
    return view, premask, False


def evaluate_block(plan: MetricsPlan, blk, acc: HostAccumulator | None = None,
                   device=None) -> HostAccumulator:
    """Fold one backend block into the accumulator, zone-map pruned and
    projection-limited like the search read path; returns the
    accumulator. Without `acc`, make_accumulator(plan, device) picks one
    (CUDA unless device="cpu"; it raises without CUDA)."""
    if acc is None:
        acc = make_accumulator(plan, device=device)
    d = blk.dictionary()
    resolvers, impossible = _lower_prunes(plan, d)
    if impossible:
        return acc  # a filter string absent from the dictionary: zero IO
    zm = zone_maps_enabled()
    all_conds = plan.pipeline.conditions().all_conditions
    for rg in blk.index().row_groups:
        if rg.end_s < plan.start_s or rg.start_s > plan.end_s:
            continue
        if zm and resolvers and rg_prunes(plan, rg, resolvers, all_conds):
            acc.stats["prunedRowGroups"] += 1
            blk.pruned_row_groups += 1
            continue
        view, premask, dead = rg_eval_view(plan, blk, rg, d)
        acc.stats["inspectedSpans"] += rg.n_spans
        if dead:
            continue  # run-space veto: zero columns expanded
        acc.add(eval_batch(plan, view, d, acc.series, premask=premask), view)
    return acc


# ---------------------------------------------------------------------------
# cross-shard merge + Prometheus-matrix finalize (frontend side)
# ---------------------------------------------------------------------------


def new_wire() -> dict:
    """Mutable merged state the frontend folds job partials into."""
    return {"series": {}, "exemplars": {}, "stats": new_stats()}


def merge_wire(merged: dict, wire: dict, plan: MetricsPlan, bin_offset: int = 0) -> None:
    """Fold one job partial (HostAccumulator.to_wire form) into the
    merged state, shifting the job's local bins by bin_offset steps
    (frontend time-range sharding). Addition only, so merge order never
    changes results."""
    nb = plan.n_buckets
    for s in wire.get("series", []):
        key = s.get("key")
        dst = merged["series"].setdefault(key, {})
        for flat, count in s.get("bins", []):
            b, bucket = divmod(int(flat), nb)
            g = (b + bin_offset) * nb + bucket
            dst[g] = dst.get(g, 0) + int(count)
    for ex in wire.get("exemplars", []):
        key = ex.get("key")
        have = merged["exemplars"].setdefault(key, [])
        if len(have) < max(plan.exemplars, 1):
            have.append({k: v for k, v in ex.items() if k != "key"})
    wire_stats_merge(merged["stats"], wire.get("stats", {}))


def _fmt_val(v: float) -> str:
    return f"{v:.10g}"


def finalize_matrix(plan: MetricsPlan, merged: dict) -> dict:
    """Merged counts -> Prometheus-compatible matrix
    ({"resultType": "matrix", "result": [{metric, values}]}), plus the
    per-query stats the search response carries."""
    nb, nbins = plan.n_buckets, plan.n_bins
    result = []
    keys = sorted(merged["series"], key=lambda k: (k is None, k))
    for key in keys:
        dense = np.zeros(nbins * nb, np.int64)
        for flat, c in merged["series"][key].items():
            if 0 <= flat < len(dense):
                dense[flat] += c
        arr = dense.reshape(nbins, nb)
        labels = {}
        if plan.by_label and key is not None:
            labels[plan.by_label] = key
        if plan.func in ("rate", "count_over_time"):
            vals = arr[:, 0].astype(np.float64)
            if plan.func == "rate":
                vals = vals / plan.step_s
            result.append({
                "metric": {"__name__": plan.func, **labels},
                "values": [[plan.bin_ts(b), _fmt_val(vals[b])] for b in range(nbins)],
            })
        elif plan.func == "quantile_over_time":
            totals = arr.sum(axis=1)
            live = np.flatnonzero(totals)
            for q in plan.qs:
                samples = []
                for b in live:
                    v = float(np_hist_quantile(arr[b], [q], plan.hist)[0])
                    samples.append([plan.bin_ts(int(b)), _fmt_val(v * plan.value_scale)])
                result.append({
                    "metric": {"__name__": plan.func, "p": _fmt_val(float(q)), **labels},
                    "values": samples,
                })
        else:  # histogram_over_time: one series per live bucket
            for j in np.flatnonzero(arr.sum(axis=0)):
                le = float(plan.hist.bucket_upper(int(j))) * plan.value_scale
                samples = [
                    [plan.bin_ts(int(b)), _fmt_val(float(arr[b, j]))]
                    for b in np.flatnonzero(arr[:, j])
                ]
                result.append({
                    "metric": {"__name__": plan.func, "le": _fmt_val(le), **labels},
                    "values": samples,
                })
    exemplars = [
        {**({plan.by_label: key} if plan.by_label and key is not None else {}), **ex}
        for key, exs in merged["exemplars"].items()
        for ex in exs
    ]
    return {
        "resultType": "matrix",
        "result": result,
        "exemplars": exemplars,
        "stats": dict(merged["stats"]),
    }
