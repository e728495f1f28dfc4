"""Metrics query planning: parsed pipeline -> per-row-group kernel plan.

A compiled plan pins everything the evaluators need: the filter stages
(evaluated exactly by the vectorized TraceQL path), the time-bin grid
(start/end/step alignment), the grouping expression, and — for
quantile/histogram functions — the fixed-bucket log-scale HistogramPlan
whose integer counts make shard partials psum-mergeable. The combined
slot space (series x bins x buckets) is the static shape the device
reductions are jitted against, so it is bounded here (MAX_SLOTS) and a
query that would exceed it fails fast as a client error.

Port note: copied from tempo_tpu/metrics_engine/plan.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from tempo_tpu_torch.ops.sketch import HistogramPlan
from tempo_tpu_torch.traceql import ast_nodes as A
from tempo_tpu_torch.traceql.parser import ParseError, parse

MAX_BINS = 4096
MAX_SLOTS = 1 << 22  # series * bins * buckets ceiling (16 MiB of int32)

# histogram geometry: duration values are nanoseconds (1us..~73min,
# 8 sub-buckets/octave -> <=12.5% relative quantile error); generic
# numeric attributes get a wider, coarser range
_DURATION_HIST = HistogramPlan(min_exp=10, max_exp=42, sub=8)
_GENERIC_HIST = HistogramPlan(min_exp=-16, max_exp=40, sub=4)


@dataclass(frozen=True)
class MetricsPlan:
    query: str
    pipeline: object  # A.Pipeline
    filters: tuple  # spanset stages before the metrics stage
    func: str  # rate | count_over_time | quantile_over_time | histogram_over_time
    value_expr: object  # measured field (quantile/histogram) or None
    qs: tuple
    by_expr: object  # grouping field or None
    by_label: str  # label name for the by() dimension ("" without by)
    start_s: int
    end_s: int
    step_s: int
    n_bins: int
    max_series: int
    hist: HistogramPlan | None
    value_scale: float  # applied at read-out (duration ns -> seconds)
    exemplars: int  # max exemplars kept per series (0 = off)
    span_cols: tuple  # columns each row group evaluation decodes
    needs_attrs: bool

    @property
    def n_buckets(self) -> int:
        return self.hist.n_buckets if self.hist is not None else 1

    @property
    def n_slots(self) -> int:
        return self.max_series * self.n_bins * self.n_buckets

    def bin_ts(self, b: int) -> int:
        """Unix-seconds timestamp of bin b (start of the step interval)."""
        return self.start_s + b * self.step_s


def is_simple_count_plan(plan: "MetricsPlan") -> bool:
    """True when the plan's reduction is a pure span count per time bin
    — one unlabeled series, no histogram buckets, no value read-out.
    This is the reduction shape the compiled tier (tempo_tpu_torch/compiled)
    fuses into a single device program: rate and count_over_time share
    it because rate only rescales counts at finalize (finalize_matrix
    divides by step_s). by()/quantile/histogram/exemplar plans keep the
    interpreter, whose answers are bit-identical where both run."""
    return (plan.func in ("rate", "count_over_time")
            and plan.by_expr is None
            and plan.hist is None
            and plan.value_expr is None
            and not plan.qs
            and plan.exemplars == 0
            and plan.max_series == 1)


def _label_name(e) -> str:
    if isinstance(e, A.Attribute):
        if e.scope == "any":
            return e.name
        return f"{e.scope}.{e.name}"
    if isinstance(e, A.Intrinsic):
        return e.name
    return "value"


def compile_metrics_plan(query: str, start_s: int, end_s: int, step_s: int,
                         max_series: int = 64, exemplars: int = 0) -> MetricsPlan:
    """Parse + plan one query_range request. Raises ParseError for query
    shape problems and ValueError for range/size problems (both are
    client errors end to end: the HTTP layer maps them to 400 and the
    frontend never retries them)."""
    from tempo_tpu_torch.traceql import vector

    pipeline = parse(query)
    if not A.is_metrics_pipeline(pipeline):
        raise ParseError(
            "query_range requires a metrics pipeline (e.g. `{...} | rate()`)"
        )
    stage = pipeline.stages[-1]
    filters = tuple(pipeline.stages[:-1])
    try:
        for st in filters:
            vector._validate_spanset(st)
        for e in (stage.value_expr, stage.by_expr):
            if e is not None:
                vector._validate_expr(e)
    except vector.Unsupported as e:
        raise ParseError(f"unsupported in a metrics query: {e}") from e

    if step_s <= 0:
        raise ValueError("step must be positive")
    if end_s <= start_s:
        raise ValueError("end must be after start")
    n_bins = int(math.ceil((end_s - start_s) / step_s))
    if n_bins > MAX_BINS:
        raise ValueError(
            f"{n_bins} steps exceed the {MAX_BINS}-bin limit; increase step"
        )
    if max_series < 1:
        raise ValueError("max_series must be >= 1")

    if stage.by_expr is None:
        # without by() there is exactly ONE series; keeping the cap at
        # its default would multiply every slot space (and the device
        # reduction's tile width) by max_series for nothing
        max_series = 1

    hist = None
    scale = 1.0
    if stage.func in ("quantile_over_time", "histogram_over_time"):
        if isinstance(stage.value_expr, A.Intrinsic) and stage.value_expr.name == "duration":
            hist, scale = _DURATION_HIST, 1e-9  # ns in storage, seconds out
        else:
            hist = _GENERIC_HIST
    n_buckets = hist.n_buckets if hist is not None else 1
    if max_series * n_bins * n_buckets > MAX_SLOTS:
        raise ValueError(
            f"series*bins*buckets = {max_series * n_bins * n_buckets} exceeds "
            f"{MAX_SLOTS}; increase step or lower max_series"
        )

    # projection: the filter columns + whatever the metric reads. The
    # faux GroupBy stages exist only so vector.needed_columns walks the
    # value/grouping expressions with its normal rules.
    faux_stages = list(filters) or [A.SpansetFilter(None)]
    faux_stages += [A.GroupBy(e) for e in (stage.value_expr, stage.by_expr)
                    if e is not None]
    span_cols, needs_attrs = vector.needed_columns(A.Pipeline(faux_stages))

    return MetricsPlan(
        query=query,
        pipeline=pipeline,
        filters=filters,
        func=stage.func,
        value_expr=stage.value_expr,
        qs=stage.qs,
        by_expr=stage.by_expr,
        by_label=_label_name(stage.by_expr) if stage.by_expr is not None else "",
        start_s=int(start_s),
        end_s=int(end_s),
        step_s=int(step_s),
        n_bins=n_bins,
        max_series=int(max_series),
        hist=hist,
        value_scale=scale,
        exemplars=int(exemplars),
        span_cols=tuple(span_cols),
        needs_attrs=needs_attrs,
    )
