"""Port of tempo_tpu/traceql/engine.py, copied as is (host code).

TraceQL execution engine.

Reference: pkg/traceql/engine.go:25-108 (Execute: parse -> extract fetch
conditions -> storage Fetch -> evaluate pipeline per spanset) and
ast_execute.go (spanset algebra).

The fetcher contract: fetch(spec: FetchSpec, start_s, end_s) returns
candidate Trace objects (false positives fine — the engine re-evaluates
the exact expression; traces straddling blocks must arrive combined).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tempo_tpu_torch.traceql import ast_nodes as A
from tempo_tpu_torch.traceql.parser import parse


class EvalContext:
    """Per-trace evaluation context: parent links, children counts,
    resource attrs per span."""

    def __init__(self, trace):
        self.trace = trace
        self._by_id = {}
        self._resource = {}
        self._children = {}
        for resource, spans in trace.batches:
            for s in spans:
                self._by_id[s.span_id] = s
                self._resource[s.span_id] = resource
        for s in self.all_spans():
            self._children[s.parent_span_id] = self._children.get(s.parent_span_id, 0) + 1

    def all_spans(self):
        return list(self._by_id.values())

    def parent_of(self, span):
        return self._by_id.get(span.parent_span_id)

    def resource_of(self, span):
        return self._resource.get(span.span_id, {})

    def child_count(self, span):
        return self._children.get(span.span_id, 0)

    def ancestors(self, span):
        seen = set()
        p = self.parent_of(span)
        while p is not None and p.span_id not in seen:
            seen.add(p.span_id)
            yield p
            p = self.parent_of(p)


def eval_spanset_expr(node, spans, ctx):
    if isinstance(node, A.Pipeline):
        # wrapped pipeline as spanset operand: evaluate it over the same
        # input spans; its matched spans are the operand's spanset
        matched, _sel = run_stages(node, spans, ctx)
        return matched
    if isinstance(node, A.SpansetFilter):
        return node.matches(spans, ctx)
    if isinstance(node, A.SpansetOp):
        a = eval_spanset_expr(node.lhs, spans, ctx)
        b = eval_spanset_expr(node.rhs, spans, ctx)
        if node.op == "&&":
            return _union(a, b) if a and b else []
        if node.op == "||":
            return _union(a, b)
        if node.op == ">":
            a_ids = {s.span_id for s in a}
            return [s for s in b if s.parent_span_id in a_ids]
        if node.op == ">>":
            a_ids = {s.span_id for s in a}
            return [s for s in b if any(p.span_id in a_ids for p in ctx.ancestors(s))]
        if node.op == "~":
            # sibling: b-spans sharing a parent with a DIFFERENT a-span
            # (reference: OpSpansetSibling, pkg/traceql/enum_operators.go)
            by_parent = {}
            for s in a:
                by_parent.setdefault(s.parent_span_id, set()).add(s.span_id)
            return [
                s
                for s in b
                if by_parent.get(s.parent_span_id, set()) - {s.span_id}
            ]
        raise A.TypeError_(f"unknown spanset op {node.op}")
    raise A.TypeError_(f"unexpected spanset node {node}")


def _union(a, b):
    seen = set()
    out = []
    for s in list(a) + list(b):
        if s.span_id not in seen:
            seen.add(s.span_id)
            out.append(s)
    return out


@dataclass
class SpansetResult:
    trace_id_hex: str
    root_service_name: str = ""
    root_trace_name: str = ""
    start_time_unix_nano: int = 0
    duration_ms: int = 0
    spans: list = field(default_factory=list)  # matched Span objects
    span_attrs: dict = field(default_factory=dict)  # span_id -> select()ed fields
    # real matched count when spans is truncated (vector path caps the
    # retained spans per trace); -1 = len(spans)
    matched_override: int = -1

    def to_dict(self):
        def one(s):
            d = {
                "spanID": s.span_id.hex(),
                "name": s.name,
                "startTimeUnixNano": str(s.start_unix_nano),
                "durationNanos": str(s.duration_nano),
            }
            sel = self.span_attrs.get(s.span_id)
            if sel:
                d["attributes"] = [
                    {"key": k, "value": _attr_value(v)} for k, v in sel.items()
                ]
            return d

        return {
            "traceID": self.trace_id_hex,
            "rootServiceName": self.root_service_name,
            "rootTraceName": self.root_trace_name,
            "startTimeUnixNano": str(self.start_time_unix_nano),
            "durationMs": self.duration_ms,
            "spanSet": {
                "matched": self.matched_override if self.matched_override >= 0 else len(self.spans),
                "spans": [one(s) for s in self.spans[:20]],
            },
        }


def _attr_value(v):
    """OTLP-style typed value for the search response JSON."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def run_stages(pipeline, spans, ctx):
    """Run the pipeline's stages for one trace.

    Returns (matched spans, select exprs). The unit of flow between
    stages is a LIST of spansets (groups) per trace — by() fans a
    spanset out into per-value groups, aggregate filters drop groups,
    coalesce merges them back, and filter stages re-filter each group's
    spans (reference: pipeline evaluation over []Spanset,
    pkg/traceql/ast_execute.go + groupOperation/coalesceOperation in
    expr.y)."""
    groups = [eval_spanset_expr(pipeline.stages[0], spans, ctx)]
    select_exprs = []
    for stage in pipeline.stages[1:]:
        groups = [g for g in groups if g]
        if not groups:
            break
        if isinstance(stage, (A.SpansetFilter, A.SpansetOp, A.Pipeline)):
            groups = [eval_spanset_expr(stage, g, ctx) for g in groups]
        elif isinstance(stage, A.GroupBy):
            regrouped = {}
            for g in groups:
                for s in g:
                    key = stage.expr.eval(s, ctx)
                    regrouped.setdefault(key, []).append(s)
            groups = list(regrouped.values())
        elif isinstance(stage, A.AggregateFilter):
            groups = [g for g in groups if stage.test(g, ctx)]
        elif isinstance(stage, A.Coalesce):
            merged = []
            for g in groups:
                merged = _union(merged, g)
            groups = [merged]
        elif isinstance(stage, A.Select):
            select_exprs.extend(stage.exprs)
        else:
            raise A.TypeError_(f"unknown pipeline stage {stage}")
    matched = []
    for g in groups:
        matched = _union(matched, g)
    return matched, select_exprs


class Engine:
    def execute(self, query: str, fetch, start_s: int = 0, end_s: int = 0,
                limit: int = 20) -> list[SpansetResult]:
        pipeline = parse(query)
        if A.is_metrics_pipeline(pipeline):
            # range-vector queries have their own evaluator + endpoint;
            # surfacing as ParseError keeps the HTTP mapping a 400
            from tempo_tpu_torch.traceql.parser import ParseError

            raise ParseError(
                "metrics queries (| rate() ...) must use /api/metrics/query_range"
            )
        spec = pipeline.conditions()
        results = []
        for trace in fetch(spec, start_s, end_s):
            ctx = EvalContext(trace)
            spans = ctx.all_spans()
            if not spans:
                continue
            if start_s or end_s:
                # exact trace-level window check: fetchers only prune at
                # row-group/block granularity (false positives expected),
                # and the live-ingester path doesn't prune at all
                t_start = min(s.start_unix_nano for s in spans)
                t_end = max(s.end_unix_nano for s in spans)
                if start_s and t_end < start_s * 10**9:
                    continue
                if end_s and t_start > end_s * 10**9:
                    continue
            matched, select_exprs = run_stages(pipeline, spans, ctx)
            if not matched:
                continue
            results.append(_to_result(trace, matched, ctx, select_exprs))
            if limit and len(results) >= limit:
                break
        results.sort(key=lambda r: -r.start_time_unix_nano)
        return results


def _to_result(trace, matched, ctx, select_exprs=()) -> SpansetResult:
    spans = ctx.all_spans()
    start = min(s.start_unix_nano for s in spans)
    end = max(s.end_unix_nano for s in spans)
    roots = [s for s in spans if s.parent_span_id == b"\x00" * 8]
    root = roots[0] if roots else spans[0]
    # same retention cap + ordering rule as the vector path
    # (vector.MAX_SPANS_PER_RESULT): earliest by (start, span_id), true
    # matched count carried separately
    from tempo_tpu_torch.traceql.vector import MAX_SPANS_PER_RESULT

    kept = sorted(matched, key=lambda s: (s.start_unix_nano, s.span_id))
    attrs = {}
    if select_exprs:
        # only the KEPT spans render (to_dict shows spans[:cap]), so
        # attach select() fields to exactly those — same invariant as
        # the vector path, which never materializes attrs it won't emit
        for s in kept[:MAX_SPANS_PER_RESULT]:
            vals = {}
            for e in select_exprs:
                v = e.eval(s, ctx)
                if v is not None and not isinstance(v, (dict, list)):
                    vals[_select_label(e)] = v
            if vals:
                attrs[s.span_id] = vals
    return SpansetResult(
        trace_id_hex=trace.trace_id.hex(),
        root_service_name=ctx.resource_of(root).get("service.name", ""),
        root_trace_name=root.name,
        start_time_unix_nano=start,
        duration_ms=(end - start) // 10**6,
        spans=kept[:MAX_SPANS_PER_RESULT],
        span_attrs=attrs,
        matched_override=len(matched),
    )


def _select_label(e) -> str:
    if isinstance(e, A.Attribute):
        return f"{e.scope}.{e.name}" if e.scope != "any" else f".{e.name}"
    return e.name


def execute(query: str, fetch, **kw) -> list[SpansetResult]:
    return Engine().execute(query, fetch, **kw)
