"""Step-partial downsampling tier: pre-bucketed (series, bin) counts.

Port of tempo_tpu/standing/rules.py, host code copied as is (np.unique
over rows and np.add.at included), with the reference's two Prometheus
counters.

The range-vector partial of every metrics query is one segmented
bincount (metrics_engine/evaluate.py), and integer counts merge by
addition — so a block can carry, for a small configured set of
downsampling RULES (`BlockConfig.step_partial_rules`), the already
bucketed (series, absolute-step-bin, histogram-bucket) -> count table of
its own spans. A 30-day `query_range` whose plan matches a rule then
reads these tiny partial pages instead of the span columns: zero
span-column fetches, bit-identical results (both sides bucket with the
SAME eval_batch slotting, and floor arithmetic on a shared step grid
commutes with aggregation when the query's step is a multiple of the
rule's and its start is grid-aligned).

Layout: one extra page per (row group, rule), named `__sp.<rule>` inside
the ordinary page dict (PageMeta with codec/crc like any column), int64
shape (nnz, 4): [series-local-index, absolute step bin, histogram
bucket, count]. The per-row-group series key list + rule identity live
in `RowGroupMeta.partials[rule]` ({"series": [...], "step": s,
"q": query}). Because partials ride the row group:

- the compactor's zero-decode relocation copies the page verbatim (keys
  are strings, not dictionary codes, so a dictionary remap cannot
  invalidate them), and
- merge clusters — the only place compaction dedupes/caps spans —
  RECOMPUTE partials from the decoded output rows, so partials always
  describe exactly the spans stored beside them.

Soundness rule: absence of a partial (legacy block, over-ceiling series,
pathological time range) means "evaluate the spans" — never wrong,
only slower. A stored partial whose rule identity (query text + step)
differs from the configured rule is treated as absent.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

# page-name prefix of step-partial pages inside RowGroupMeta.pages;
# never collides with span/attr schema names
SP_PREFIX = "__sp."

# write-side ceiling on a batch's step-bin span: partials aggregate
# sparsely (np.unique), so the cap only guards the int64 flat-slot
# arithmetic against pathological (fuzzed) timestamps
WRITE_MAX_BINS = 1 << 20


@dataclass(frozen=True)
class StepRule:
    name: str
    query: str  # a filter-less metrics pipeline, e.g. `{} | rate() by (...)`
    step_s: int
    max_series: int = 512


DEFAULT_STEP_RULES = (
    ("rate_by_service", "{} | rate() by (resource.service.name)", 60, 512),
    ("duration_hist", "{} | histogram_over_time(duration)", 60, 1),
)


@lru_cache(maxsize=32)
def parse_rules(raw: tuple) -> tuple:
    """BlockConfig.step_partial_rules tuples -> StepRule objects. A rule
    that fails to compile (bad query) is dropped loudly rather than
    poisoning every block write."""
    import logging

    out = []
    for item in raw or ():
        try:
            r = StepRule(*[tuple(x) if isinstance(x, list) else x for x in item])
            if r.step_s <= 0 or r.max_series < 1:
                raise ValueError("step_s and max_series must be positive")
            rule_template(r)  # compile now: a bad rule fails here, once
            out.append(r)
        except Exception as e:  # noqa: BLE001 — config, not data plane
            logging.getLogger(__name__).warning(
                "step-partial rule %r dropped: %s", item, e)
    return tuple(out)


def block_rules(block_cfg) -> tuple:
    """Configured rules for one BlockConfig (empty when the tier is
    off: `step_partial_rules=()`)."""
    raw = getattr(block_cfg, "step_partial_rules", ()) or ()
    return parse_rules(tuple(tuple(r) for r in raw))


@lru_cache(maxsize=64)
def rule_template(rule: StepRule):
    """One-bin template plan for a rule: pins func/by/value/hist exactly
    the way query planning would, so write-time slotting and read-time
    plans can never drift. Raises for malformed rule queries."""
    from tempo_tpu_torch.metrics_engine import compile_metrics_plan

    return compile_metrics_plan(rule.query, 0, rule.step_s, rule.step_s,
                                max_series=rule.max_series)


def window_plan(template, start_s: int, n_bins: int):
    """Shift a template onto [start, start + n_bins*step) — pure
    re-anchoring, no re-validation (callers bound n_bins themselves)."""
    return dataclasses.replace(
        template,
        start_s=int(start_s),
        end_s=int(start_s + n_bins * template.step_s),
        n_bins=int(n_bins),
    )


def _filterless(plan) -> bool:
    """True when every filter stage is `{}` (match-all) — the only
    filter shape a rule may carry and still serve arbitrary blocks."""
    return all(getattr(st, "expr", object()) is None for st in plan.filters)


# rule func -> plan funcs it can serve: the stored counts are the same
# range-vector partial, only finalize differs (rate divides by step;
# quantiles read the bucket histogram the rule already stored)
_SERVES = {
    "rate": ("rate", "count_over_time"),
    "count_over_time": ("rate", "count_over_time"),
    "histogram_over_time": ("histogram_over_time", "quantile_over_time"),
}


def match_rule(plan, rules: tuple):
    """The configured rule whose stored partials can answer `plan`
    exactly, or None. Exactness requires: filter-less plan, compatible
    function family, identical grouping label, identical histogram
    geometry/scale, and a plan grid that the rule grid refines
    (step multiple + aligned start)."""
    if plan.exemplars or not _filterless(plan):
        return None
    for rule in rules:
        t = rule_template(rule)
        if plan.func not in _SERVES.get(t.func, ()):
            continue
        if plan.by_label != t.by_label:
            continue
        if plan.hist != t.hist or plan.value_scale != t.value_scale:
            continue
        if plan.step_s % rule.step_s != 0 or plan.start_s % rule.step_s != 0:
            continue
        return rule
    return None


# ---------------------------------------------------------------------------
# write side: batch -> per-row slot decomposition -> per-row-group pages
# ---------------------------------------------------------------------------


class BatchPartial:
    """Per-row (series, abs-bin, bucket) decomposition of one batch under
    one rule, sliceable by the writer's row-group boundaries."""

    __slots__ = ("keys", "sslot", "abs_bin", "bucket", "rule")

    def __init__(self, rule, keys, sslot, abs_bin, bucket):
        self.rule = rule
        self.keys = keys  # series-slot order
        self.sslot = sslot  # (n,) int64, -1 = not counted
        self.abs_bin = abs_bin
        self.bucket = bucket

    def rg_table(self, lo: int, hi: int):
        """(local series keys, (nnz, 4) int64 table) for rows [lo, hi),
        or None when nothing counted."""
        s = self.sslot[lo:hi]
        live = s >= 0
        if not live.any():
            return None
        s = s[live]
        b = self.abs_bin[lo:hi][live]
        k = self.bucket[lo:hi][live]
        packed = np.stack([s, b, k], axis=1)
        uniq, counts = np.unique(packed, axis=0, return_counts=True)
        used = np.unique(uniq[:, 0])
        local = np.searchsorted(used, uniq[:, 0])
        table = np.column_stack(
            [local, uniq[:, 1], uniq[:, 2], counts]).astype(np.int64)
        return [self.keys[int(i)] for i in used], table


def batch_partial(batch, dictionary, rule: StepRule) -> BatchPartial | None:
    """Decompose one trace-sorted batch under one rule. Returns None —
    "no partial, fall back to spans" — whenever exactness cannot be
    guaranteed: series over the rule ceiling, or a time range too wild
    for the flat-slot arithmetic (fuzzed data)."""
    from tempo_tpu_torch.metrics_engine import SeriesTable, eval_batch

    n = batch.num_spans
    if n == 0:
        return None
    t = batch.cols["start_unix_nano"].astype(np.int64)
    t_lo, t_hi = int(t.min()), int(t.max())
    if t_lo < 0:
        return None
    step = rule.step_s
    start = (t_lo // (step * 10**9)) * step
    n_bins = (t_hi // (step * 10**9)) - (start // step) + 1
    if n_bins > WRITE_MAX_BINS:
        return None
    template = rule_template(rule)
    plan = window_plan(template, start, n_bins)
    series = SeriesTable(rule.max_series)
    res = eval_batch(plan, batch, dictionary, series)
    if series.dropped:
        # a partial missing some series would silently undercount; the
        # rule ceiling is a soundness line, not a truncation
        return None
    nb, nk = plan.n_bins, plan.n_buckets
    valid = res.slots >= 0
    flat = np.where(valid, res.slots, 0)
    sslot = np.where(valid, flat // (nb * nk), -1)
    rem = flat % (nb * nk)
    abs_bin = (start // step) + rem // nk
    bucket = rem % nk
    keys = [key for key, _ in sorted(series.slots.items(),
                                     key=lambda kv: kv[1])]
    return BatchPartial(rule, keys, sslot.astype(np.int64),
                        abs_bin.astype(np.int64), bucket.astype(np.int64))


def page_name(rule_name: str) -> str:
    return SP_PREFIX + rule_name


def partial_meta(rule: StepRule, keys: list) -> dict:
    """RowGroupMeta.partials entry: the rule identity travels with the
    data so a configured-rule change can never serve stale semantics."""
    return {"series": keys, "step": int(rule.step_s), "q": rule.query}


# ---------------------------------------------------------------------------
# read side: fold stored partials into a query accumulator
# ---------------------------------------------------------------------------


def rg_has_partial(rg, rule: StepRule) -> bool:
    meta = (getattr(rg, "partials", None) or {}).get(rule.name)
    return (
        meta is not None
        and meta.get("step") == rule.step_s
        and meta.get("q") == rule.query
        and page_name(rule.name) in rg.pages
    )


def fold_rg_partial(plan, rule: StepRule, blk, rg, acc) -> None:
    """Fold one row group's stored partial into a HostAccumulator —
    integer adds on the plan's grid, zero span columns touched."""
    meta = rg.partials[rule.name]
    name = page_name(rule.name)
    table = blk.read_columns(rg, [name])[name]
    if table.size == 0:
        return
    table = table.reshape(-1, 4).astype(np.int64)
    keys = meta["series"]
    t0 = table[:, 1] * rule.step_s
    grid_end = plan.start_s + plan.n_bins * plan.step_s
    sel = (t0 >= plan.start_s) & (t0 < grid_end) & (table[:, 2] < plan.n_buckets)
    if not sel.any():
        return
    table, t0 = table[sel], t0[sel]
    pbin = (t0 - plan.start_s) // plan.step_s
    # series-local index -> this query's series slot (first-seen order,
    # capped at plan.max_series exactly like the span path)
    lut = np.array([acc.series.slot_of(keys[i])
                    for i in range(len(keys))], np.int64)
    sslot = lut[table[:, 0]]
    live = sslot >= 0
    if not live.any():
        return
    flat = (sslot[live] * plan.n_bins + pbin[live]) * plan.n_buckets + table[live, 2]
    np.add.at(acc.counts, flat, table[live, 3])


def evaluate_block_hybrid(plan, rule: StepRule, blk, acc) -> None:
    """Per-row-group hybrid evaluation: stored partials where present,
    span evaluation where not (legacy row groups) — bit-identical to the
    pure span path either way. Matched plans are filter-less, so pruning
    is the time filter alone."""
    from tempo_tpu_torch.metrics_engine.evaluate import eval_batch, rg_eval_view

    d = None
    grid_end = plan.start_s + plan.n_bins * plan.step_s
    for rg in blk.index().row_groups:
        if rg.end_s < plan.start_s or rg.start_s > grid_end:
            continue
        if rg_has_partial(rg, rule):
            fold_rg_partial(plan, rule, blk, rg, acc)
            acc.stats["partialRowGroups"] = acc.stats.get("partialRowGroups", 0) + 1
            partial_row_groups_read_total.inc()
            continue
        if d is None:
            d = blk.dictionary()
        view, premask, dead = rg_eval_view(plan, blk, rg, d)
        acc.stats["inspectedSpans"] += rg.n_spans
        if dead:
            continue
        acc.add(eval_batch(plan, view, d, acc.series, premask=premask), view)


from tempo_tpu_torch.util import metrics as _metrics  # noqa: E402

partial_row_groups_read_total = _metrics.counter(
    "tempo_tpu_standing_partial_row_groups_read_total",
    "Row groups whose query_range contribution was served from stored "
    "step-partial columns (zero span-column fetches)",
)
partial_pages_written_total = _metrics.counter(
    "tempo_tpu_standing_partial_pages_written_total",
    "Step-partial pages written at block flush/compaction, by rule",
)
