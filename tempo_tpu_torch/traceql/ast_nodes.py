"""TraceQL typed AST + evaluation + storage condition extraction.

Reference: pkg/traceql/ast.go (typed nodes + validation),
ast_execute.go (evaluation over spansets), storage.go:15-63 (condition
extraction: the approximate, false-positive-allowed predicate set handed
to the storage layer; the engine re-evaluates exactly).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from tempo_tpu_torch.model.trace import (
    KIND_CLIENT,
    KIND_CONSUMER,
    KIND_INTERNAL,
    KIND_PRODUCER,
    KIND_SERVER,
    KIND_UNSPECIFIED,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_UNSET,
)

STATUS_KEYWORDS = {"ok": STATUS_OK, "error": STATUS_ERROR, "unset": STATUS_UNSET}
KIND_KEYWORDS = {
    "client": KIND_CLIENT,
    "server": KIND_SERVER,
    "internal": KIND_INTERNAL,
    "producer": KIND_PRODUCER,
    "consumer": KIND_CONSUMER,
    "unspecified": KIND_UNSPECIFIED,
}

COMPARISON_OPS = {"=", "!=", ">", ">=", "<", "<=", "=~", "!~"}
ARITH_OPS = {"+", "-", "*", "/", "%", "^"}


class TypeError_(Exception):
    """Static validation failure (name avoids shadowing builtin)."""


@dataclass(frozen=True)
class Condition:
    """One pushdown predicate for the storage layer.

    scope: span | resource | any | intrinsic ; op None = fetch column only.
    Storage may ignore any condition (false positives allowed) but must
    never drop true matches when all_conditions handling is correct.
    """

    scope: str
    name: str
    op: str | None
    value: object = None


@dataclass
class FetchSpec:
    conditions: list = field(default_factory=list)
    all_conditions: bool = True  # True: span must satisfy ALL conditions


# ---------------------------------------------------------------------------
# expression nodes (evaluated per span)
# ---------------------------------------------------------------------------


class Expr:
    def eval(self, span, ctx):  # -> python value or None
        raise NotImplementedError

    def conditions(self) -> FetchSpec:
        return FetchSpec(conditions=[], all_conditions=True)


@dataclass
class Literal(Expr):
    value: object
    kind: str  # string | int | float | bool | duration | status | kind | nil

    def eval(self, span, ctx):
        return self.value


@dataclass
class Attribute(Expr):
    scope: str  # any | span | resource | parent
    name: str

    def eval(self, span, ctx):
        if self.scope == "parent":
            parent = ctx.parent_of(span)
            return parent.attributes.get(self.name) if parent else None
        if self.scope in ("any", "span"):
            v = span.attributes.get(self.name)
            if v is not None or self.scope == "span":
                return v
        return ctx.resource_of(span).get(self.name)


@dataclass
class Intrinsic(Expr):
    name: str  # duration | name | status | kind | childCount | parent

    def eval(self, span, ctx):
        if self.name == "duration":
            return span.duration_nano
        if self.name == "name":
            return span.name
        if self.name == "status":
            return span.status_code
        if self.name == "kind":
            return span.kind
        if self.name == "childCount":
            return ctx.child_count(span)
        if self.name == "parent":
            return ctx.parent_of(span)
        raise TypeError_(f"unknown intrinsic {self.name}")


@dataclass
class Unary(Expr):
    op: str  # - | !
    expr: Expr

    def eval(self, span, ctx):
        v = self.expr.eval(span, ctx)
        if v is None:
            return None
        if self.op == "-":
            return -v
        return not v


@dataclass
class Binary(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def eval(self, span, ctx):
        op = self.op
        if op == "&&":
            return bool(self.lhs.eval(span, ctx)) and bool(self.rhs.eval(span, ctx))
        if op == "||":
            return bool(self.lhs.eval(span, ctx)) or bool(self.rhs.eval(span, ctx))
        l = self.lhs.eval(span, ctx)
        r = self.rhs.eval(span, ctx)
        if op in ("=", "!="):
            if _is_nil_literal(self.rhs) or _is_nil_literal(self.lhs):
                target = l if _is_nil_literal(self.rhs) else r
                return (target is None) == (op == "=")
            if l is None or r is None:
                return False
            if isinstance(l, bool) != isinstance(r, bool) and not (
                isinstance(l, (int, float)) and isinstance(r, (int, float))
            ):
                return False
            eq = l == r
            return eq if op == "=" else not eq
        if l is None or r is None:
            return None if op in ARITH_OPS else False
        if op in ("=~", "!~"):
            if not isinstance(l, str) or not isinstance(r, str):
                return False
            hit = re.search(r, l) is not None
            return hit if op == "=~" else not hit
        if op in (">", ">=", "<", "<="):
            try:
                return {
                    ">": l > r,
                    ">=": l >= r,
                    "<": l < r,
                    "<=": l <= r,
                }[op]
            except TypeError:
                return False
        if op in ARITH_OPS:
            try:
                if op == "+":
                    return l + r
                if op == "-":
                    return l - r
                if op == "*":
                    return l * r
                if op == "/":
                    return l / r if r != 0 else None
                if op == "%":
                    return l % r if r != 0 else None
                if op == "^":
                    return l**r
            except TypeError:
                return None
        raise TypeError_(f"unknown operator {op}")

    def conditions(self) -> FetchSpec:
        if self.op == "&&":
            a, b = self.lhs.conditions(), self.rhs.conditions()
            return FetchSpec(
                conditions=a.conditions + b.conditions,
                all_conditions=a.all_conditions and b.all_conditions,
            )
        if self.op == "||":
            a, b = self.lhs.conditions(), self.rhs.conditions()
            if not a.conditions or not b.conditions:
                # one side is opaque -> no safe pushdown at all
                return FetchSpec(conditions=[], all_conditions=False)
            return FetchSpec(conditions=a.conditions + b.conditions, all_conditions=False)
        cond = self._leaf_condition()
        return FetchSpec(conditions=[cond] if cond else [], all_conditions=True)

    def _leaf_condition(self) -> Condition | None:
        """field <op> literal -> pushdown condition (both orders)."""
        for fld, lit, op in ((self.lhs, self.rhs, self.op), (self.rhs, self.lhs, _flip(self.op))):
            if not isinstance(lit, Literal) or lit.kind == "nil":
                continue
            if isinstance(fld, Attribute) and fld.scope in ("any", "span", "resource"):
                if op in COMPARISON_OPS:
                    return Condition(fld.scope, fld.name, op, lit.value)
            if isinstance(fld, Intrinsic) and fld.name in ("duration", "name", "status", "kind"):
                if op in COMPARISON_OPS:
                    return Condition("intrinsic", fld.name, op, lit.value)
        return None


def _flip(op: str) -> str:
    return {">": "<", "<": ">", ">=": "<=", "<=": ">="}.get(op, op)


# ---------------------------------------------------------------------------
# static validation (reference: pkg/traceql/ast.go validate() — type
# checking after parse; test corpus section `validate_fails` in
# pkg/traceql/test_examples.yaml)
# ---------------------------------------------------------------------------

# static types: int/float/duration unify into "number" (the reference
# accepts `{ 1 * 1h = 1 }`); attributes are dynamically typed so they
# unify with anything ("unknown").
_LITERAL_TYPES = {
    "int": "number",
    "float": "number",
    "duration": "number",
    "string": "string",
    "bool": "bool",
    "status": "status",
    "kind": "kind",
    "nil": "nil",
}
_INTRINSIC_TYPES = {
    "duration": "number",
    "childCount": "number",
    "name": "string",
    "status": "status",
    "kind": "kind",
    "parent": "span",
}


def _compatible(a: str, b: str) -> bool:
    if "unknown" in (a, b) or a == b:
        return True
    if "nil" in (a, b):  # nil compares against attributes and parent
        return {a, b} <= {"nil", "span", "unknown"}
    return False


def _int_backed_enum(node: Expr, t: str) -> bool:
    """The status/kind INTRINSICS are int-backed columns, so numeric
    literals compare against them (`{ status = 2 }` worked before static
    validation and must keep working). Keyword literals are not numeric:
    `{ 1 > ok }` stays rejected like the reference corpus."""
    return t in ("status", "kind") and isinstance(node, Intrinsic)


def static_type(e: Expr) -> str:
    """Infer the static type of a field expression, raising TypeError_
    on an ill-typed subtree."""
    if isinstance(e, Literal):
        return _LITERAL_TYPES[e.kind]
    if isinstance(e, Attribute):
        return "unknown"
    if isinstance(e, Intrinsic):
        return _INTRINSIC_TYPES[e.name]
    if isinstance(e, Unary):
        t = static_type(e.expr)
        if e.op == "-":
            if t not in ("number", "unknown"):
                raise TypeError_(f"operator - not defined for {t}")
            return "number"
        if t not in ("bool", "unknown"):
            raise TypeError_(f"operator ! not defined for {t}")
        return "bool"
    if isinstance(e, Binary):
        lt, rt = static_type(e.lhs), static_type(e.rhs)
        op = e.op
        if op in ARITH_OPS:
            for t in (lt, rt):
                if t not in ("number", "unknown"):
                    raise TypeError_(f"operator {op} not defined for {t}")
            return "number"
        if op in ("&&", "||"):
            for t in (lt, rt):
                if t not in ("bool", "unknown"):
                    raise TypeError_(f"operator {op} not defined for {t}")
            return "bool"
        if op in ("=~", "!~"):
            # validate BOTH sides: today's grammar only produces string
            # literals on the RHS, but the type layer must stay
            # self-contained if that ever loosens (the reference's
            # validator rejects `{ 1 =~ 2 }` at this layer too)
            if lt not in ("string", "unknown"):
                raise TypeError_(f"operator {op} requires a string, got {lt}")
            if rt not in ("string", "unknown"):
                raise TypeError_(f"operator {op} requires a string pattern, got {rt}")
            return "bool"
        enum_num = (_int_backed_enum(e.lhs, lt) and rt in ("number", "unknown")) or (
            _int_backed_enum(e.rhs, rt) and lt in ("number", "unknown")
        )
        if op in ("=", "!="):
            if not (_compatible(lt, rt) or enum_num):
                raise TypeError_(f"cannot compare {lt} with {rt}")
            return "bool"
        if op in (">", ">=", "<", "<="):
            if enum_num:  # { status > 1 } orders over the raw int
                return "bool"
            for t in (lt, rt):
                if t not in ("number", "string", "unknown"):
                    raise TypeError_(f"operator {op} not defined for {t}")
            if not _compatible(lt, rt):
                raise TypeError_(f"cannot compare {lt} with {rt}")
            return "bool"
        raise TypeError_(f"unknown operator {op}")
    raise TypeError_(f"cannot type {e!r}")


def _references_span(e: Expr) -> bool:
    if isinstance(e, (Attribute, Intrinsic)):
        return True
    if isinstance(e, Unary):
        return _references_span(e.expr)
    if isinstance(e, Binary):
        return _references_span(e.lhs) or _references_span(e.rhs)
    return False


def validate(pipeline: "Pipeline") -> None:
    """Static type checking over a parsed pipeline; raises TypeError_.

    Intentional supersets vs the reference's validate_fails corpus: this
    engine actually evaluates min/max/sum/avg aggregate pipelines and
    scalar filters over them, so the reference's 'aggregates not
    supported yet at this time' rejections are accepted here.
    """

    def walk(stage):
        if isinstance(stage, SpansetFilter):
            if stage.expr is not None:
                t = static_type(stage.expr)
                if t not in ("bool", "unknown"):
                    raise TypeError_(f"spanset filter must be boolean, got {t}")
        elif isinstance(stage, SpansetOp):
            walk(stage.lhs)
            walk(stage.rhs)
        elif isinstance(stage, AggregateFilter):
            if stage.field_expr is not None:
                t = static_type(stage.field_expr)
                if t not in ("number", "unknown"):
                    raise TypeError_(f"{stage.agg}() requires a numeric field, got {t}")
                if not _references_span(stage.field_expr):
                    raise TypeError_(f"{stage.agg}() must reference the span")
            rt = _LITERAL_TYPES[stage.rhs.kind]
            if rt not in ("number", "unknown"):
                raise TypeError_(f"cannot compare {stage.agg}() with {rt}")
        elif isinstance(stage, GroupBy):
            static_type(stage.expr)
            if not _references_span(stage.expr):
                raise TypeError_("by() must reference the span")
        elif isinstance(stage, MetricsAggregate):
            walk_metrics(stage)
        elif isinstance(stage, Pipeline):
            for s in stage.stages:
                walk(s)
        # Coalesce / Select need no checks (Select's parser already
        # restricts arguments to field nodes)

    def walk_metrics(stage: MetricsAggregate):
        if stage.func not in METRICS_FUNCS:
            raise TypeError_(f"unknown metrics function {stage.func}")
        if stage.value_expr is not None:
            t = static_type(stage.value_expr)
            if t not in ("number", "unknown"):
                raise TypeError_(f"{stage.func}() requires a numeric field, got {t}")
            if not _references_span(stage.value_expr):
                raise TypeError_(f"{stage.func}() must reference the span")
        for q in stage.qs:
            if not (0.0 < float(q) <= 1.0):
                raise TypeError_(f"quantile {q} outside (0, 1]")
        if stage.by_expr is not None:
            static_type(stage.by_expr)
            if not _references_span(stage.by_expr):
                raise TypeError_("by() must reference the span")

    # a metrics stage turns the whole pipeline into a range-vector
    # query: it must be the FINAL stage, appear once, and follow only
    # spanset expressions (the reference's grammar encodes the same
    # shape — spansetPipeline PIPE metricsAggregation)
    metrics_idx = [i for i, s in enumerate(pipeline.stages)
                   if isinstance(s, MetricsAggregate)]
    if metrics_idx:
        if len(metrics_idx) > 1 or metrics_idx[0] != len(pipeline.stages) - 1:
            raise TypeError_("metrics stage must be the single final pipeline stage")
        for s in pipeline.stages[:-1]:
            if not isinstance(s, (SpansetFilter, SpansetOp)):
                raise TypeError_(
                    "metrics stage can only follow spanset filter stages"
                )

    walk(pipeline)


def _is_nil_literal(e: Expr) -> bool:
    return isinstance(e, Literal) and e.kind == "nil"


# ---------------------------------------------------------------------------
# spanset-level nodes
# ---------------------------------------------------------------------------


@dataclass
class SpansetFilter:
    expr: Expr | None  # None = {} match-all

    def conditions(self) -> FetchSpec:
        if self.expr is None:
            return FetchSpec(conditions=[], all_conditions=True)
        return self.expr.conditions()

    def matches(self, spans, ctx):
        if self.expr is None:
            return list(spans)
        out = []
        for s in spans:
            v = self.expr.eval(s, ctx)
            if isinstance(v, bool) and v:
                out.append(s)
        return out


@dataclass
class SpansetOp:
    op: str  # && | "||" | ">" | ">>" | "~" (sibling)
    lhs: object
    rhs: object

    def conditions(self) -> FetchSpec:
        a, b = self.lhs.conditions(), self.rhs.conditions()
        if self.op == "||":
            if not a.conditions or not b.conditions:
                return FetchSpec(conditions=[], all_conditions=False)
            return FetchSpec(conditions=a.conditions + b.conditions, all_conditions=False)
        # &&, >, >>: span-level conditions from either side are
        # trace-level necessary, but no single span must satisfy all
        return FetchSpec(conditions=a.conditions + b.conditions, all_conditions=False)


@dataclass
class AggregateFilter:
    agg: str  # count | avg | min | max | sum
    field_expr: Expr | None  # None only for count
    op: str
    rhs: Literal

    def conditions(self) -> FetchSpec:
        return FetchSpec(conditions=[], all_conditions=False)

    def test(self, spans, ctx) -> bool:
        if self.agg == "count":
            val = len(spans)
        else:
            vals = [self.field_expr.eval(s, ctx) for s in spans]
            vals = [v for v in vals if isinstance(v, (int, float)) and not isinstance(v, bool)]
            if not vals:
                return False
            val = {
                "avg": lambda: sum(vals) / len(vals),
                "min": lambda: min(vals),
                "max": lambda: max(vals),
                "sum": lambda: sum(vals),
            }[self.agg]()
        r = self.rhs.value
        return {
            "=": val == r,
            "!=": val != r,
            ">": val > r,
            ">=": val >= r,
            "<": val < r,
            "<=": val <= r,
        }[self.op]


@dataclass
class Coalesce:
    def conditions(self) -> FetchSpec:
        return FetchSpec(conditions=[], all_conditions=True)


METRICS_FUNCS = ("rate", "count_over_time", "quantile_over_time", "histogram_over_time")


@dataclass
class MetricsAggregate:
    """Terminal metrics pipeline stage — `| rate() by (...)`,
    `| count_over_time()`, `| quantile_over_time(attr, q...)`,
    `| histogram_over_time(attr)` (reference: the TraceQL metrics
    grammar, pkg/traceql/expr.y metricsAggregation + ast.go
    MetricsAggregate). Spanset engines never evaluate this node; the
    metrics engine (tempo_tpu_torch/metrics_engine) compiles it to a
    time-bucketed segmented reduction over stored blocks."""

    func: str  # one of METRICS_FUNCS
    value_expr: Expr | None = None  # measured field (quantile/histogram)
    qs: tuple = ()  # quantiles for quantile_over_time
    by_expr: Expr | None = None  # `by (...)` grouping field


def is_metrics_pipeline(pipeline: "Pipeline") -> bool:
    return any(isinstance(s, MetricsAggregate) for s in pipeline.stages)


@dataclass
class GroupBy:
    """`| by(expr)` — partition each spanset by the per-span value of
    expr (reference: groupOperation, pkg/traceql/expr.y BY)."""

    expr: Expr

    def conditions(self) -> FetchSpec:
        return FetchSpec(conditions=[], all_conditions=False)


@dataclass
class Select:
    """`| select(expr, ...)` — attach the given fields to returned spans
    (reference: the select() pipeline stage; fetch-only conditions with
    op None ask storage to retrieve the columns without filtering,
    pkg/traceql/storage.go condition contract)."""

    exprs: list  # Attribute / Intrinsic nodes

    def conditions(self) -> FetchSpec:
        conds = []
        for e in self.exprs:
            if isinstance(e, Attribute) and e.scope != "parent":
                conds.append(Condition(e.scope, e.name, None))
            elif isinstance(e, Intrinsic):
                conds.append(Condition("intrinsic", e.name, None))
        return FetchSpec(conditions=conds, all_conditions=False)


@dataclass
class Pipeline:
    stages: list  # spanset expr first; then filter/by/select/agg/coalesce

    def conditions(self) -> FetchSpec:
        """Merged pushdown: a span surviving the pipeline must pass every
        SpansetFilter stage, so their specs AND-compose; other stages
        (by/select/coalesce/aggregates) only regroup or drop spansets and
        contribute nothing span-level. Select's fetch-only conditions are
        omitted — this storage always materializes full rows for
        candidate traces."""
        specs = [
            s.conditions()
            for s in self.stages
            if isinstance(s, (SpansetFilter, SpansetOp))
        ]
        if not specs:
            return FetchSpec(conditions=[], all_conditions=False)
        return FetchSpec(
            conditions=[c for sp in specs for c in sp.conditions],
            all_conditions=all(sp.all_conditions for sp in specs),
        )
