"""Vectorized TraceQL evaluation over columnar span batches.

The object engine (engine.py) materializes python Span dicts per trace
and walks them per span — fine for ingester live traces, but the
hottest read loop of the reference runs as compiled column scans
(vparquet/block_traceql.go:279-617 iterator trees). This module is the
columnar equivalent: the whole pipeline evaluates as numpy array ops
over a row group's SpanBatch, and per-trace aggregates are computed as
segment reductions.

Cross-block correctness: a trace's spans may straddle blocks, so block
evaluation returns per-trace PARTIALS — matched span masks are span-
local (safe per block), while aggregate inputs (count/sum/min/max) are
associative and merge across blocks before the final aggregate filter
(db.traceql_search drives the merge). by() keeps those partials per
(trace, materialized group value) and resolves each group's aggregate
chain at finalize; select() attaches the chosen fields to the retained
span tuples.

Structural evaluation (parent.*, childCount, the spanset ops `>`, `>>`,
`~`, `&&`, `||`) is vectorized as parent-span-id joins within trace
segments: span_id/parent_span_id pairs rank-compress to a sorted
(segment, id) key array, one searchsorted resolves every span's parent
row, `>>` reachability closes by pointer doubling, and `~` groups by
(segment, parent-id value). Blocks store whole traces (row groups are
trace-aligned, fmt.row_group_slices), so the per-batch joins see the
complete span tree exactly like the reference's per-parquet-row
evaluation (vparquet/block_traceql.go:375-617). Only filters after
by()/aggregates, coalesce after by(), and pipeline-valued spanset
operands raise Unsupported and fall back to the object engine.

Type model: every field expression evaluates to (kind, values, defined)
with kind in {num, bool, str}; strings are block-dictionary codes, so
equality is code compare and regex resolves to a code set once per
block (the reference's dictionary-pruning trick,
pkg/parquetquery/predicates.go).

Port of tempo_tpu/traceql/vector.py, copied whole but for the
compiled-tier lowering (`compiled_filter_specs`, `_compiled_expr_specs`),
whose one caller is tempo_tpu/compiled/lower.py; it arrives with the
compiled/ slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tempo_tpu_torch.model.columnar import (
    SCOPE_RESOURCE,
    SCOPE_SPAN,
    VT_BOOL,
    VT_FLOAT,
    VT_INT,
    VT_STR,
)
from tempo_tpu_torch.traceql import ast_nodes as A

MAX_SPANS_PER_RESULT = 20  # spans retained per trace in results — both
# engines apply the same cap (earliest by start, span_id tiebreak) with
# the true matched count carried separately, so memory stays bounded by
# limit*cap instead of total matched spans


class Unsupported(Exception):
    """Query shape the vector path does not cover; use the object engine."""


class ColumnView:
    """Duck-typed, projection-limited stand-in for SpanBatch: only the
    columns a query touches are fetched/decoded (reference analog: the
    iterator tree only reads the parquet columns its predicates name)."""

    def __init__(self, cols: dict, attrs: dict, n: int):
        self.cols = cols
        self.attrs = attrs
        self._n = n
        self._tb = None

    @property
    def num_spans(self) -> int:
        return self._n

    def trace_boundaries(self):
        if self._tb is None:
            from tempo_tpu_torch.model.columnar import trace_segmentation

            _, seg, firsts = trace_segmentation(self.cols["trace_id"])
            self._tb = (firsts, seg)
        return self._tb


class _LazyCols(dict):
    """Column dict that decodes on first access — evaluation touches a
    column, the loader pays for it; columns nobody reads cost nothing
    (and columns answered in encoded space are never expanded at all)."""

    def __init__(self, loader):
        super().__init__()
        self._loader = loader

    def __missing__(self, key):
        arr = self._loader(key)
        self[key] = arr
        return arr


class LazyColumnView(ColumnView):
    """ColumnView whose columns materialize lazily from a block reader.

    The run-space metrics path hands eval_batch one of these plus a
    pre-computed filter mask: when the filters were answered in encoded
    space, the filter columns are never decoded, and the remaining
    evaluation (bins, by(), value expressions) decodes exactly the
    columns it touches. enc_of(name) additionally serves trace
    segmentation straight from an RLE trace-ID page's run lengths —
    zero ID decode (the runs ARE the traces).
    """

    def __init__(self, col_loader, attr_loader, n: int, enc_of=None):
        super().__init__(_LazyCols(col_loader), _LazyCols(attr_loader), n)
        self._enc_of = enc_of

    def trace_boundaries(self):
        if self._tb is None and self._enc_of is not None:
            enc = self._enc_of("trace_id")
            if enc is not None and enc.codec == "rle":
                from tempo_tpu_torch.ops import scan

                _, lengths = enc.runs()
                firsts, seg = scan.runs_firsts_seg(lengths)
                self._tb = (firsts, seg)
        return super().trace_boundaries()


def needed_columns(pipeline: A.Pipeline):
    """(span column names, needs_attr_table) for a supported pipeline."""
    span_cols = set(_BASE_COLS)
    needs_attrs = [False]

    def walk(e):
        if isinstance(e, A.Attribute):
            # parent.X reads X from the parent span's span-scoped attrs
            scope = "span" if e.scope == "parent" else e.scope
            served = e.name in _DEDICATED_SCOPES and scope in _DEDICATED_SCOPES[e.name]
            if served:
                span_cols.add(_DEDICATED.get(e.name, "http_status"))
            if not served or scope == "any":
                # attr-table lookup: unserved scopes always; "any" also
                # probes the table for the scope the dedicated column
                # does not cover (an explicit attr may shadow it)
                needs_attrs[0] = True
        elif isinstance(e, A.Intrinsic):
            if e.name == "status":
                span_cols.add("status_code")
            elif e.name == "kind":
                span_cols.add("kind")
        elif isinstance(e, A.Unary):
            walk(e.expr)
        elif isinstance(e, A.Binary):
            walk(e.lhs)
            walk(e.rhs)

    def walk_spanset(node):
        if isinstance(node, A.SpansetFilter):
            if node.expr is not None:
                walk(node.expr)
        elif isinstance(node, A.SpansetOp):
            walk_spanset(node.lhs)
            walk_spanset(node.rhs)

    for stage in pipeline.stages:
        if isinstance(stage, (A.SpansetFilter, A.SpansetOp)):
            walk_spanset(stage)
        elif isinstance(stage, A.AggregateFilter) and stage.field_expr is not None:
            walk(stage.field_expr)
        elif isinstance(stage, A.GroupBy):
            walk(stage.expr)
        elif isinstance(stage, A.Select):
            for e in stage.exprs:
                walk(e)
    return sorted(span_cols), needs_attrs[0]


# span columns every evaluation needs
_BASE_COLS = ["trace_id", "span_id", "parent_span_id", "start_unix_nano",
              "duration_nano", "name", "service"]

_DEDICATED = {
    "service.name": "service",
    "http.method": "http_method",
    "http.url": "http_url",
}

# scopes each dedicated column answers for (mirrors where the object
# model places the value: model/trace.py WELL_KNOWN_SPAN_ATTRS are span
# attrs; service.name lives on the resource)
_DEDICATED_SCOPES = {
    "service.name": ("any", "resource"),
    "http.method": ("any", "span"),
    "http.url": ("any", "span"),
    "http.status_code": ("any", "span"),
}


def supports(pipeline: A.Pipeline) -> bool:
    try:
        _validate(pipeline)
        return True
    except Unsupported:
        return False


def needs_whole_traces(pipeline: A.Pipeline) -> bool:
    """True when evaluation reads span TOPOLOGY (parent joins): the
    structural spanset ops, parent.* attributes, or childCount.

    Per-batch joins see a complete tree only when each trace lives
    wholly inside one block (the normal state: row groups are
    trace-aligned and compaction merges a trace's copies). The db layer
    checks that at runtime — if a trace id actually appears in several
    blocks it re-runs the query on the object engine, which evaluates
    combined traces (stronger than the reference, whose per-parquet-row
    evaluation is always block-local, vparquet/block_traceql.go:375).
    Bare `parent = nil` stays exempt: its zero-id form is span-local.
    """

    found = [False]

    def walk_expr(e):
        if isinstance(e, A.Attribute):
            if e.scope == "parent":
                found[0] = True
        elif isinstance(e, A.Intrinsic):
            if e.name == "childCount":
                found[0] = True
        elif isinstance(e, A.Unary):
            walk_expr(e.expr)
        elif isinstance(e, A.Binary):
            walk_expr(e.lhs)
            walk_expr(e.rhs)

    def walk_spanset(node):
        if isinstance(node, A.SpansetOp):
            # `&&` needs the whole trace too: its both-operands-matched
            # test is per TRACE, which a block holding half the trace
            # answers differently. Only `||` is pointwise.
            if node.op in (">", ">>", "~", "&&"):
                found[0] = True
            walk_spanset(node.lhs)
            walk_spanset(node.rhs)
        elif isinstance(node, A.SpansetFilter) and node.expr is not None:
            walk_expr(node.expr)

    for stage in pipeline.stages:
        if isinstance(stage, (A.SpansetFilter, A.SpansetOp)):
            walk_spanset(stage)
        elif isinstance(stage, A.AggregateFilter) and stage.field_expr is not None:
            walk_expr(stage.field_expr)
        elif isinstance(stage, A.GroupBy):
            walk_expr(stage.expr)
        elif isinstance(stage, A.Select):
            for e in stage.exprs:
                walk_expr(e)
    return found[0]


def _validate(pipeline: A.Pipeline):
    seen_agg = False
    seen_by = False
    for stage in pipeline.stages:
        if isinstance(stage, (A.SpansetFilter, A.SpansetOp)):
            if seen_agg:
                # the flat-mask model folds all filters together before
                # aggregates resolve (at cross-block finalize), so a
                # filter AFTER an aggregate would change what the
                # aggregate observes — stage order matters there
                raise Unsupported("filter stage after aggregate filter")
            if seen_by:
                # same reason: a filter after by() re-filters each
                # group, which the one-shot mask cannot express
                raise Unsupported("filter stage after by()")
            _validate_spanset(stage)
        elif isinstance(stage, A.AggregateFilter):
            seen_agg = True
            if stage.field_expr is not None:
                _validate_expr(stage.field_expr)
        elif isinstance(stage, A.Coalesce):
            if seen_by:
                # coalesce merges groups back; aggregates after it see
                # the union again — the keyed-partial model doesn't
                raise Unsupported("coalesce after by()")
        elif isinstance(stage, A.GroupBy):
            if seen_by:
                raise Unsupported("multiple by() stages")
            if seen_agg:
                raise Unsupported("by() after aggregate filter")
            seen_by = True
            _validate_expr(stage.expr)
        elif isinstance(stage, A.Select):
            for e in stage.exprs:
                _validate_expr(e)
        else:
            raise Unsupported(f"stage {type(stage).__name__}")


def _validate_spanset(node):
    """Spanset expression tree: filters composed with the structural ops
    the mask model evaluates (&&, ||, >, >>, ~)."""
    if isinstance(node, A.SpansetFilter):
        if node.expr is not None:
            _validate_expr(node.expr)
        return
    if isinstance(node, A.SpansetOp):
        if node.op not in ("&&", "||", ">", ">>", "~"):
            raise Unsupported(f"spanset op {node.op}")
        _validate_spanset(node.lhs)
        _validate_spanset(node.rhs)
        return
    # a full pipeline as operand re-runs stages per group — object engine
    raise Unsupported(f"spanset operand {type(node).__name__}")


def _validate_expr(e: A.Expr):
    if isinstance(e, A.Literal):
        return
    if isinstance(e, A.Attribute):
        return
    if isinstance(e, A.Intrinsic):
        if e.name == "parent":
            # bare `parent` only compares against nil (root test); other
            # uses aren't well-typed and the object engine answers them
            raise Unsupported(e.name)
        return
    if isinstance(e, A.Unary):
        return _validate_expr(e.expr)
    if isinstance(e, A.Binary):
        if isinstance(e.lhs, A.Intrinsic) and e.lhs.name == "parent":
            if isinstance(e.rhs, A.Literal) and e.rhs.kind == "nil":
                return  # parent = nil is span-local (root test)
        if isinstance(e.rhs, A.Intrinsic) and e.rhs.name == "parent":
            if isinstance(e.lhs, A.Literal) and e.lhs.kind == "nil":
                return
        _validate_expr(e.lhs)
        _validate_expr(e.rhs)
        return
    raise Unsupported(type(e).__name__)


# ---------------------------------------------------------------------------
# expression evaluation -> (kind, values, defined)
# ---------------------------------------------------------------------------


@dataclass
class _Ctx:
    batch: object  # SpanBatch
    d: object  # Dictionary
    n: int
    _attr_cache: dict = field(default_factory=dict)
    # stored VT_* per (scope, name), recorded by _compute_attr — the
    # "num" kind erases int vs float, but select() must render the
    # stored type (intValue vs doubleValue) like the object engine
    _attr_vt: dict = field(default_factory=dict)
    # structural join caches (parent row / sibling key / child counts)
    _parent_rows: object = None
    _child_counts: object = None
    _sib_keys: object = None

    def parent_rows(self) -> np.ndarray:
        """Row index of each span's parent within its trace segment, -1
        when the parent id resolves to no span (the object engine's
        `parent_of` dict miss). One rank-compress + searchsorted join
        over the whole batch; duplicate span ids within a trace resolve
        to the LAST row, matching the engine's dict insert order."""
        if self._parent_rows is None:
            b = self.batch
            _, seg = b.trace_boundaries()
            sid = b.cols["span_id"]
            par = b.cols["parent_span_id"]
            sidp = (sid[:, 0].astype(np.uint64) << np.uint64(32)) | sid[:, 1]
            parp = (par[:, 0].astype(np.uint64) << np.uint64(32)) | par[:, 1]
            uniq = np.unique(np.concatenate([sidp, parp]))
            k = np.int64(len(uniq) + 1)
            skey = seg.astype(np.int64) * k + np.searchsorted(uniq, sidp)
            qkey = seg.astype(np.int64) * k + np.searchsorted(uniq, parp)
            self._sib_keys = qkey  # sibling grouping key: (seg, parent id VALUE)
            order = np.argsort(skey, kind="stable")
            sk = skey[order]
            p = np.searchsorted(sk, qkey, side="right") - 1
            safe = np.maximum(p, 0)
            ok = (p >= 0) & (sk[safe] == qkey)
            self._parent_rows = np.where(ok, order[safe], -1)
        return self._parent_rows

    def sibling_keys(self) -> np.ndarray:
        if self._sib_keys is None:
            self.parent_rows()
        return self._sib_keys

    def child_counts(self) -> np.ndarray:
        """Spans naming each span as parent (EvalContext.child_count)."""
        if self._child_counts is None:
            pr = self.parent_rows()
            self._child_counts = np.bincount(
                pr[pr >= 0], minlength=self.n).astype(np.int64)
        return self._child_counts

    def attr_is_int(self, scope: str, name: str) -> bool:
        if scope == "any":
            # span wins where defined (same precedence as _eval's merge)
            for s in ("span", "resource"):
                vt = self._attr_vt.get((s, name))
                if vt is not None:
                    return vt == VT_INT
            return False
        return self._attr_vt.get((scope, name)) == VT_INT

    def attr_values(self, scope: str, name: str):
        """(kind, values, defined) for an attribute across all spans."""
        key = (scope, name)
        if key in self._attr_cache:
            return self._attr_cache[key]
        out = self._compute_attr(scope, name)
        self._attr_cache[key] = out
        return out

    def _compute_attr(self, scope, name):
        # dedicated columns serve only the scope the object model stores
        # them under (model/trace.py: http.* are span attrs, service.name
        # is resource-level); the other scope falls through to the attr
        # table so results match the object engine exactly
        col = _DEDICATED.get(name)
        if col is not None and scope in _DEDICATED_SCOPES[name]:
            codes = self.batch.cols[col].astype(np.uint32)
            return ("str", codes, codes != 0)
        if name == "http.status_code" and scope in ("any", "span"):
            v = self.batch.cols["http_status"].astype(np.float64)
            self._attr_vt[(scope, name)] = VT_INT
            return ("num", v, v != 0)
        kc = self.d.get(name)
        if kc is None:
            return (None, None, np.zeros(self.n, bool))
        a = self.batch.attrs
        rows = a["attr_key"] == np.uint32(kc)
        if scope == "span":
            rows &= a["attr_scope"] == SCOPE_SPAN
        elif scope == "resource":
            rows &= a["attr_scope"] == SCOPE_RESOURCE
        idx = np.flatnonzero(rows)
        if len(idx) == 0:
            return (None, None, np.zeros(self.n, bool))
        vts = a["attr_vtype"][idx]
        vt = vts[0]
        if not (vts == vt).all():
            raise Unsupported(f"attr {name} has mixed value types in block")
        self._attr_vt[(scope, name)] = int(vt)
        owners = a["attr_span"][idx]
        defined = np.zeros(self.n, bool)
        defined[owners] = True
        if vt == VT_STR:
            vals = np.zeros(self.n, np.uint32)
            vals[owners] = a["attr_str"][idx]
            return ("str", vals, defined)
        if vt == VT_BOOL:
            vals = np.zeros(self.n, bool)
            vals[owners] = a["attr_num"][idx] != 0
            return ("bool", vals, defined)
        vals = np.zeros(self.n, np.float64)
        vals[owners] = a["attr_num"][idx]
        return ("num", vals, defined)


def _lit(e: A.Literal, ctx: _Ctx):
    n = ctx.n
    if e.kind == "string":
        code = ctx.d.get(e.value)
        # absent string: no code can equal it; represent as sentinel
        val = np.uint32(code) if code is not None else np.uint32(0xFFFFFFFF)
        return ("str", np.full(n, val, np.uint32), np.ones(n, bool))
    if e.kind == "bool":
        return ("bool", np.full(n, e.value, bool), np.ones(n, bool))
    if e.kind == "nil":
        return ("nil", None, np.zeros(n, bool))
    # int/float/duration/status/kind all compare numerically
    return ("num", np.full(n, float(e.value), np.float64), np.ones(n, bool))


def _eval(e: A.Expr, ctx: _Ctx):
    n = ctx.n
    if isinstance(e, A.Literal):
        return _lit(e, ctx)
    if isinstance(e, A.Attribute):
        if e.scope == "any":
            # span-scoped value wins, resource fills the gaps — mirror
            # Attribute.eval's precedence
            ks, vs, ds = ctx.attr_values("span", e.name)
            kr, vr, dr = ctx.attr_values("resource", e.name)
            if ks is None and kr is None:
                return (None, None, np.zeros(n, bool))
            if ks is None:
                return (kr, vr, dr)
            if kr is None:
                return (ks, vs, ds)
            if ks != kr:
                raise Unsupported(f"attr {e.name} span/resource type mismatch")
            return (ks, np.where(ds, vs, vr), ds | dr)
        if e.scope == "parent":
            # parent.X = X from the parent span's span-scoped attrs
            # (Attribute.eval: parent.attributes.get(name)); gather the
            # whole-column values through the parent-row join
            k, v, d = ctx.attr_values("span", e.name)
            if k is None:
                return (None, None, np.zeros(n, bool))
            pr = ctx.parent_rows()
            safe = np.maximum(pr, 0)
            defined = (pr >= 0) & d[safe]
            vals = np.where(defined, v[safe], np.zeros(1, v.dtype))
            return (k, vals, defined)
        return ctx.attr_values(e.scope, e.name)
    if isinstance(e, A.Intrinsic):
        b = ctx.batch
        if e.name == "duration":
            return ("num", b.cols["duration_nano"].astype(np.float64), np.ones(n, bool))
        if e.name == "name":
            return ("str", b.cols["name"].astype(np.uint32), np.ones(n, bool))
        if e.name == "status":
            return ("num", b.cols["status_code"].astype(np.float64), np.ones(n, bool))
        if e.name == "kind":
            return ("num", b.cols["kind"].astype(np.float64), np.ones(n, bool))
        if e.name == "childCount":
            return ("num", ctx.child_counts().astype(np.float64), np.ones(n, bool))
        raise Unsupported(e.name)
    if isinstance(e, A.Unary):
        k, v, d = _eval(e.expr, ctx)
        if e.op == "-":
            if k != "num":
                return ("num", np.zeros(n, np.float64), np.zeros(n, bool))
            return ("num", -v, d)
        bk = _as_bool(k, v, d, n)
        return ("bool", ~bk & d, d)
    if isinstance(e, A.Binary):
        return _eval_binary(e, ctx)
    raise Unsupported(type(e).__name__)


def _as_bool(kind, vals, defined, n):
    if kind == "bool":
        return vals & defined
    if kind is None or vals is None:
        return np.zeros(n, bool)
    if kind == "num":
        return (vals != 0) & defined
    return defined  # strings: defined = truthy (matches object engine bool())


def _parent_nil_mask(e: A.Binary, ctx: _Ctx):
    """`parent = nil` / `parent != nil` -> root-span test.

    Deliberately the zero-parent-id test, NOT the parent-row dict-miss:
    a trace straddling blocks leaves its non-root spans with dangling
    parent ids in the later block, and the id test keeps matching the
    whole-trace answer there (the dict-miss test would call them roots).
    This keeps bare `parent = nil` span-local and exempt from the
    whole-trace straddle guard (needs_whole_traces)."""
    sides = (e.lhs, e.rhs)
    has_parent_intr = any(isinstance(s, A.Intrinsic) and s.name == "parent" for s in sides)
    has_nil = any(isinstance(s, A.Literal) and s.kind == "nil" for s in sides)
    if not (has_parent_intr and has_nil and e.op in ("=", "!=")):
        return None
    is_root = (ctx.batch.cols["parent_span_id"] == 0).all(axis=1)
    return is_root if e.op == "=" else ~is_root


def _eval_binary(e: A.Binary, ctx: _Ctx):
    import re

    n = ctx.n
    op = e.op
    pm = _parent_nil_mask(e, ctx)
    if pm is not None:
        return ("bool", pm, np.ones(n, bool))
    if op in ("&&", "||"):
        lk, lv, ld = _eval(e.lhs, ctx)
        rk, rv, rd = _eval(e.rhs, ctx)
        lb = _as_bool(lk, lv, ld, n)
        rb = _as_bool(rk, rv, rd, n)
        return ("bool", (lb & rb) if op == "&&" else (lb | rb), np.ones(n, bool))

    # nil equality on attributes: defined-ness test
    for fld, lit in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
        if isinstance(lit, A.Literal) and lit.kind == "nil" and op in ("=", "!="):
            _k, _v, d = _eval(fld, ctx)
            return ("bool", ~d if op == "=" else d, np.ones(n, bool))

    lk, lv, ld = _eval(e.lhs, ctx)
    rk, rv, rd = _eval(e.rhs, ctx)
    both = ld & rd

    if op in ("=~", "!~"):
        if lk != "str":
            return ("bool", np.zeros(n, bool), np.ones(n, bool))
        if not (isinstance(e.rhs, A.Literal) and e.rhs.kind == "string"):
            raise Unsupported("dynamic regex")
        codes = _regex_codes(ctx.d, e.rhs.value)
        hit = np.isin(lv, codes) & ld
        return ("bool", hit if op == "=~" else (~hit & ld), np.ones(n, bool))

    if lk is None or rk is None or lv is None or rv is None:
        # undefined side: = / != / comparisons are False (object engine
        # returns False when either side is None)
        if op in A.ARITH_OPS:
            return (None, None, np.zeros(n, bool))
        return ("bool", np.zeros(n, bool), np.ones(n, bool))

    if op in ("=", "!="):
        if lk == rk:
            eq = (lv == rv) & both
        elif {lk, rk} == {"num", "bool"}:
            eq = (lv.astype(np.float64) == rv.astype(np.float64)) & both
        else:
            eq = np.zeros(n, bool)
        if op == "=":
            return ("bool", eq, np.ones(n, bool))
        return ("bool", ~eq & both, np.ones(n, bool))

    if op in (">", ">=", "<", "<="):
        if lk == "str" or rk == "str":
            # Python compares strings lexicographically; codes don't.
            # Bail so the object engine answers exactly.
            raise Unsupported("string ordering comparison")
        if lk != "num" or rk != "num":
            return ("bool", np.zeros(n, bool), np.ones(n, bool))
        cmp = {">": lv > rv, ">=": lv >= rv, "<": lv < rv, "<=": lv <= rv}[op]
        return ("bool", cmp & both, np.ones(n, bool))

    if op in A.ARITH_OPS:
        if lk == "str" or rk == "str":
            raise Unsupported("string arithmetic")
        if lk != "num" or rk != "num":
            return (None, None, np.zeros(n, bool))
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            if op == "+":
                v = lv + rv
            elif op == "-":
                v = lv - rv
            elif op == "*":
                v = lv * rv
            elif op == "/":
                v = np.where(rv != 0, lv / np.where(rv != 0, rv, 1), 0)
                both = both & (rv != 0)
            elif op == "%":
                v = np.where(rv != 0, np.mod(lv, np.where(rv != 0, rv, 1)), 0)
                both = both & (rv != 0)
            else:  # ^
                v = lv**rv
        return ("num", v, both)

    raise Unsupported(op)


def _regex_codes(d, pattern: str) -> np.ndarray:
    """Dictionary codes matching a regex, cached per block dictionary —
    the dictionary is shared by all of a block's row groups, so the
    Python-level scan runs once per (block, pattern), not per row group."""
    import re

    cache = getattr(d, "_rx_code_cache", None)
    if cache is None:
        cache = {}
        d._rx_code_cache = cache
    key = (pattern, len(d.entries))  # length guards append-only growth
    codes = cache.get(key)
    if codes is None:
        rx = re.compile(pattern)
        codes = np.asarray(
            [i for i, s in enumerate(d.entries) if rx.search(s)], np.uint32
        )
        cache[key] = codes
    return codes


# ---------------------------------------------------------------------------
# encoded-space filter evaluation (run/dictionary space)
# ---------------------------------------------------------------------------
#
# A restricted mirror of _eval for the filter shapes that dominate
# metrics/search traffic: dedicated-column string predicates, duration
# comparisons, and &&/|| combinations. Each predicate evaluates per RUN
# (rle) or per page-dictionary entry (dct) via EncodedColumn.map_mask —
# the verdict expands as one bool per row and the column values are
# never materialized. Anything outside the supported grammar returns
# None and the caller falls back to the exact row-space evaluator; the
# formulas below replicate _eval's defined-ness semantics exactly
# (dedicated string columns: code 0 = absent; duration: always
# defined), so both paths are bit-identical where this one answers.

# exact scopes served purely by a dedicated column (scope "any" also
# probes the attr table for shadowing and must take the row-space path)
_ENC_STR_SCOPES = {
    "service.name": ("resource",),
    "http.method": ("span",),
    "http.url": ("span",),
}


def _enc_str_field(e):
    """(column, kind) for an expression the encoded path can serve as a
    plain dictionary-code column, else None."""
    if isinstance(e, A.Intrinsic) and e.name == "name":
        return "name"
    if isinstance(e, A.Attribute) and e.scope in _ENC_STR_SCOPES.get(e.name, ()):
        return _DEDICATED[e.name]
    return None


def _enc_expr_mask(e, enc_of, d, n):
    """Row mask for one supported expression, or None (unsupported /
    page not encoded). Never partially wrong: any doubt returns None."""
    if isinstance(e, A.Binary) and e.op in ("&&", "||"):
        a = _enc_expr_mask(e.lhs, enc_of, d, n)
        if a is None:
            return None
        b = _enc_expr_mask(e.rhs, enc_of, d, n)
        if b is None:
            return None
        return (a & b) if e.op == "&&" else (a | b)
    if not isinstance(e, A.Binary):
        return None
    # (field, literal) in either order; a swap REVERSES comparison
    # operators (`100 < duration` is `duration > 100`)
    _SWAPPED_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                   "=": "=", "!=": "!="}
    fld, lit, op = e.lhs, e.rhs, e.op
    if isinstance(fld, A.Literal) and not isinstance(lit, A.Literal):
        if op in ("=~", "!~"):
            # literal-on-LHS regex is NOT symmetric: the row-space arm
            # raises Unsupported (dynamic regex) and falls back to the
            # object engine — the encoded path must decline too
            return None
        op = _SWAPPED_OP.get(op)
        if op is None:
            return None
        fld, lit = lit, fld
    if not isinstance(lit, A.Literal) or isinstance(fld, A.Literal):
        return None

    col = _enc_str_field(fld)
    if col is not None and lit.kind == "string":
        enc = enc_of(col)
        if enc is None:
            return None
        if op in ("=", "!="):
            code = d.get(lit.value)
            want = np.uint32(code) if code is not None else np.uint32(0xFFFFFFFF)
            if op == "=":
                # (codes == code) & defined; code 0 = absent ⇒ never eq
                fn = (lambda v: (v == want) & (v != 0))
            else:
                fn = (lambda v: (v != want) & (v != 0))
            return enc.map_mask(fn)
        if op in ("=~", "!~"):
            codes = _regex_codes(d, lit.value)
            if op == "=~":
                fn = (lambda v: np.isin(v, codes) & (v != 0))
            else:
                fn = (lambda v: ~(np.isin(v, codes) & (v != 0)) & (v != 0))
            return enc.map_mask(fn)
        return None

    if (isinstance(fld, A.Intrinsic) and fld.name == "duration"
            and lit.kind in ("int", "float", "duration")
            and op in ("=", "!=", ">", ">=", "<", "<=")):
        enc = enc_of("duration_nano")
        if enc is None:
            return None
        # mirror _eval: the column is compared as float64 (so the same
        # values compare the same way, rounding included)
        rv = float(lit.value)
        fn = (lambda v: {
            "=": v.astype(np.float64) == rv,
            "!=": v.astype(np.float64) != rv,
            ">": v.astype(np.float64) > rv,
            ">=": v.astype(np.float64) >= rv,
            "<": v.astype(np.float64) < rv,
            "<=": v.astype(np.float64) <= rv,
        }[op])
        return enc.map_mask(fn)
    return None


def encoded_filter_mask(stages, enc_of, d, n: int) -> np.ndarray | None:
    """Evaluate a chain of SpansetFilter stages entirely in encoded
    space: the AND of the stages' masks, or None when any stage (or any
    page involved) is outside the supported grammar. Exactly equal to
    chaining _spanset_mask over the same stages."""
    mask = None
    for st in stages:
        if not isinstance(st, A.SpansetFilter):
            return None
        if st.expr is None:
            m = np.ones(n, bool)
        else:
            m = _enc_expr_mask(st.expr, enc_of, d, n)
            if m is None:
                return None
        mask = m if mask is None else (mask & m)
    return mask if mask is not None else np.ones(n, bool)


def filter_mask(expr: A.Expr | None, batch, dictionary) -> np.ndarray:
    """Exact span mask for one spanset filter over a batch."""
    n = batch.num_spans
    if expr is None:
        return np.ones(n, bool)
    ctx = _Ctx(batch=batch, d=dictionary, n=n)
    return _filter_mask_ctx(expr, ctx)


def _filter_mask_ctx(expr: A.Expr | None, ctx: _Ctx) -> np.ndarray:
    if expr is None:
        return np.ones(ctx.n, bool)
    k, v, d = _eval(expr, ctx)
    # only a boolean True matches (object engine: isinstance(v, bool) and v)
    if k != "bool":
        return np.zeros(ctx.n, bool)
    return v & d


def _spanset_mask(node, ctx: _Ctx, base: np.ndarray | None = None) -> np.ndarray:
    """Mask of one spanset expression (filters + structural ops). With
    `base` set (a later pipeline stage), operand filters see only the
    current group's spans — pointwise AND, exactly eval_spanset_expr
    run over the group list."""
    if isinstance(node, A.SpansetFilter):
        m = _filter_mask_ctx(node.expr, ctx)
        return m if base is None else m & base
    if isinstance(node, A.SpansetOp):
        a = _spanset_mask(node.lhs, ctx, base)
        b = _spanset_mask(node.rhs, ctx, base)
        return _structural_combine(node.op, a, b, ctx)
    raise Unsupported(f"spanset operand {type(node).__name__}")


def _seg_any(mask: np.ndarray, seg: np.ndarray, n_traces: int) -> np.ndarray:
    hit = np.zeros(n_traces, bool)
    np.logical_or.at(hit, seg[mask], True)
    return hit


def _structural_combine(op: str, a: np.ndarray, b: np.ndarray, ctx: _Ctx) -> np.ndarray:
    """Columnar spanset algebra, matching eval_spanset_expr per trace:

    &&  union when BOTH operands matched somewhere in the trace
    ||  union
    >   b-spans whose parent row is an a-span (one gather)
    >>  b-spans with ANY ancestor in a (pointer-doubling closure)
    ~   b-spans sharing a parent-id VALUE with a DIFFERENT a-span
        (dangling parent ids group siblings too, like the engine's
        by_parent dict — reference OpSpansetSibling)
    """
    firsts, seg = ctx.batch.trace_boundaries()
    n_traces = len(firsts)
    if op == "||":
        return a | b
    if op == "&&":
        both = _seg_any(a, seg, n_traces) & _seg_any(b, seg, n_traces)
        return (a | b) & both[seg]
    if op == ">":
        pr = ctx.parent_rows()
        safe = np.maximum(pr, 0)
        return b & (pr >= 0) & a[safe]
    if op == ">>":
        # ancestor-of closure by pointer doubling. Invariant after k
        # rounds: acc[i] = OR of a[] over ancestors at distance 1..2^k,
        # p[i] = ancestor at distance 2^k (or -1). log2(n)+1 rounds
        # cover any simple path; the hard cap also terminates on
        # pathological parent-id cycles (where acc has already
        # converged — the OR is monotone over a finite set).
        pr = ctx.parent_rows()
        p = pr.copy()
        acc = (p >= 0) & a[np.maximum(p, 0)]
        rounds = max(1, int(np.ceil(np.log2(max(ctx.n, 2)))) + 1)
        for _ in range(rounds):
            if not (p >= 0).any():
                break
            safe = np.maximum(p, 0)
            acc = acc | ((p >= 0) & acc[safe])
            p = np.where(p >= 0, p[safe], -1)
        return b & acc
    if op == "~":
        keys = ctx.sibling_keys()
        uniq, inv = np.unique(keys, return_inverse=True)
        cnt_a = np.bincount(inv[a], minlength=len(uniq))
        return b & (cnt_a[inv] - a.astype(np.int64) > 0)
    raise Unsupported(f"spanset op {op}")


# ---------------------------------------------------------------------------
# per-trace partials + cross-block merge
# ---------------------------------------------------------------------------


def _span_key(s):
    """(start, span_id_hex): unique per span, so the trailing tuple
    fields (name, dur, select values) never get compared."""
    return (s[0], s[1])


def _merge_aggs(mine: list, other: list) -> None:
    """Fold other's (count, total, min, max) partials into mine."""
    for i, (c, t, mn, mx) in enumerate(other):
        c0, t0, mn0, mx0 = mine[i]
        mine[i] = (c0 + c, t0 + t, min(mn0, mn), max(mx0, mx))


def _merge_spans(a: list, b: list) -> list:
    """Sorted-union-truncate: both sides are already capped, and the
    kept set must be the globally earliest spans regardless of block
    merge order."""
    return sorted(a + b, key=_span_key)[:MAX_SPANS_PER_RESULT]


@dataclass
class _GroupPartial:
    """One by()-group of one trace: same associative partials as the
    trace itself, keyed by the materialized group value."""

    matched: int = 0
    aggs: list = field(default_factory=list)
    spans: list = field(default_factory=list)

    def merge(self, other: "_GroupPartial"):
        self.matched += other.matched
        _merge_aggs(self.aggs, other.aggs)
        self.spans = _merge_spans(self.spans, other.spans)


@dataclass
class TracePartial:
    trace_id: bytes
    matched: int = 0
    # aggregate partials per AggregateFilter index: (count, total, mn, mx)
    aggs: list = field(default_factory=list)
    # response metadata partials
    start: int = 0
    end: int = 0
    root_service: str = ""
    root_name: str = ""
    has_root: bool = False  # root_* comes from a TRUE root span, not the
    # first-span fallback — a real root in a later block must win
    spans: list = field(default_factory=list)  # (start, span_id_hex, name, dur[, sel])
    # by() mode: {group value: _GroupPartial}; group values are
    # materialized python scalars (dictionary codes resolved), so keys
    # merge exactly across blocks with different dictionaries
    groups: dict | None = None

    def merge(self, other: "TracePartial"):
        self.matched += other.matched
        _merge_aggs(self.aggs, other.aggs)
        self.start = min(self.start, other.start)
        self.end = max(self.end, other.end)
        if other.has_root and not self.has_root:
            self.root_service = other.root_service
            self.root_name = other.root_name
            self.has_root = True
        self.spans = _merge_spans(self.spans, other.spans)
        if other.groups:
            if self.groups is None:
                self.groups = {}
            for key, g in other.groups.items():
                mine = self.groups.get(key)
                if mine is None:
                    self.groups[key] = g
                else:
                    mine.merge(g)


def _materialize_keys(kind, vals, defined, d, n):
    """Per-span python-scalar by() keys (None = undefined), stable
    across blocks whose dictionaries assign different codes."""
    out = np.full(n, None, dtype=object)
    if kind is None:
        return out
    idx = np.flatnonzero(defined)
    if not len(idx):
        return out
    if kind == "str":
        uniq, inv = np.unique(vals[idx], return_inverse=True)
        strings = np.array([d[int(c)] for c in uniq], dtype=object)
        out[idx] = strings[inv]
    else:  # num / bool scalars hash and compare consistently everywhere
        out[idx] = vals[idx].astype(object)
    return out


def evaluate_batch(pipeline: A.Pipeline, batch, dictionary) -> dict:
    """One row-group batch -> {trace_id_bytes: TracePartial}.

    Aggregate filters are NOT applied here — their inputs are collected
    as associative partials and resolved in finalize() after all blocks
    merged (a trace may straddle blocks). With a by() stage the partials
    are kept per (trace, group value); select() fields are attached to
    the retained span tuples."""
    n = batch.num_spans
    if n == 0:
        return {}
    ctx = _Ctx(batch=batch, d=dictionary, n=n)

    mask = _spanset_mask(pipeline.stages[0], ctx)
    agg_stages = []
    for stage in pipeline.stages[1:]:
        if isinstance(stage, A.SpansetFilter):
            if mask.any():
                mask = mask & _filter_mask_ctx(stage.expr, ctx)
        elif isinstance(stage, A.SpansetOp):
            # later-stage structural op: operand filters see only the
            # current group's spans (run_stages feeds g, not all spans)
            if mask.any():
                mask = _spanset_mask(stage, ctx, base=mask)
        elif isinstance(stage, A.AggregateFilter):
            agg_stages.append(stage)
        # Coalesce: no-op in the flat-mask model
    if not mask.any():
        return {}
    group_stage = next((s for s in pipeline.stages if isinstance(s, A.GroupBy)), None)
    select_exprs = [e for s in pipeline.stages if isinstance(s, A.Select) for e in s.exprs]

    firsts, seg = batch.trace_boundaries()
    n_traces = len(firsts)
    m_count = np.bincount(seg[mask], minlength=n_traces)
    hit_traces = np.flatnonzero(m_count > 0)

    # aggregate inputs evaluated over MATCHED spans only. Ungrouped:
    # whole-column bincount partials per trace. Grouped: keep the raw
    # per-span arrays; the (small) per-group reductions happen in the
    # assembly loop below.
    agg_parts = []
    agg_raw = []
    for stage in agg_stages:
        if group_stage is None and stage.agg == "count":
            agg_parts.append((m_count, np.zeros(n_traces), None, None))
            continue
        if stage.agg == "count":
            agg_raw.append(("count", None, None))
            continue
        k, v, d = _eval(stage.field_expr, ctx)
        if k != "num":
            v = np.zeros(n, np.float64)
            d = np.zeros(n, bool)
        if group_stage is not None:
            agg_raw.append((stage.agg, v, d))
            continue
        ok = mask & d
        cnt = np.bincount(seg[ok], minlength=n_traces)
        tot = np.bincount(seg[ok], weights=v[ok], minlength=n_traces)
        mn = np.full(n_traces, np.inf)
        mx = np.full(n_traces, -np.inf)
        if ok.any():
            np.minimum.at(mn, seg[ok], v[ok])
            np.maximum.at(mx, seg[ok], v[ok])
        agg_parts.append((cnt, tot, mn, mx))

    gkeys = None
    if group_stage is not None:
        gk, gv, gd = _eval(group_stage.expr, ctx)
        gkeys = _materialize_keys(gk, gv, gd, dictionary, n)

    sel_arrays = []
    if select_exprs:
        from tempo_tpu_torch.traceql.engine import _select_label

        for e in select_exprs:
            k, v, d = _eval(e, ctx)
            if k is not None:
                if isinstance(e, A.Intrinsic):
                    is_int = e.name in ("duration", "childCount", "status", "kind")
                elif isinstance(e, A.Attribute):
                    # _eval populated the vt cache via attr_values. An
                    # "any"-scope attr can mix VT_INT and VT_FLOAT across
                    # scopes (both kind "num"): the flag must then be
                    # per span, following _eval's span-wins fill.
                    if e.scope == "any":
                        vt_s = ctx._attr_vt.get(("span", e.name))
                        vt_r = ctx._attr_vt.get(("resource", e.name))
                        if vt_s is not None and vt_r is not None and vt_s != vt_r:
                            _, _, ds = ctx.attr_values("span", e.name)
                            is_int = np.where(ds, vt_s == VT_INT, vt_r == VT_INT)
                        else:
                            is_int = ctx.attr_is_int(e.scope, e.name)
                    else:
                        is_int = ctx.attr_is_int(e.scope, e.name)
                else:
                    is_int = False
                sel_arrays.append((_select_label(e), k, v, d, is_int))

    tid = batch.cols["trace_id"]
    starts = batch.cols["start_unix_nano"]
    durations = batch.cols["duration_nano"]
    ends = starts + durations
    is_root = (batch.cols["parent_span_id"] == 0).all(axis=1)
    sid = batch.cols["span_id"]
    names = batch.cols["name"]
    service = batch.cols["service"]

    # per-trace metadata computed in whole-column passes (the per-trace
    # Python loop below only assembles already-reduced scalars — on
    # match-heavy queries this loop used to dominate the whole path)
    t_start = np.minimum.reduceat(starts, firsts)
    t_end = np.maximum.reduceat(ends, firsts)
    # first TRUE-root row per trace (fallback: the trace's first row)
    root_row = firsts.copy()
    has_root_arr = np.zeros(n_traces, bool)
    root_rows_all = np.flatnonzero(is_root)
    if len(root_rows_all):
        root_seg = seg[root_rows_all]
        # rows are in ascending order, so keep the FIRST root per segment
        first_idx = np.unique(root_seg, return_index=True)[1]
        root_row[root_seg[first_idx]] = root_rows_all[first_idx]
        has_root_arr[root_seg[first_idx]] = True
    # all trace-id / span-id bytes in two bulk byteswaps
    tid_be = np.ascontiguousarray(tid[firsts]).astype(">u4")
    m_rows_all = np.flatnonzero(mask)
    m_seg = seg[m_rows_all]
    sid_be = np.ascontiguousarray(sid[m_rows_all]).astype(">u4")
    # matched rows grouped per trace: m_rows_all is sorted, so segment
    # boundaries are a searchsorted over the hit traces
    grp_bounds = np.searchsorted(m_seg, hit_traces)

    def _sel_value(kind, val, is_int):
        if kind == "str":
            return dictionary[int(val)]
        if kind == "bool":
            return bool(val)
        # render the STORED type: VT_INT attrs / int intrinsics as ints
        # (wire intValue), VT_FLOAT as floats (doubleValue) — exactly
        # what the object engine's eval returns
        return int(val) if is_int else float(val)

    def _tuple_at(i):
        """Span tuple for position i into m_rows_all."""
        row = m_rows_all[i]
        t = (
            int(starts[row]),
            sid_be[i].tobytes().hex(),
            dictionary[int(names[row])],
            int(durations[row]),
        )
        if sel_arrays:
            t = t + (
                tuple(
                    (
                        lbl,
                        _sel_value(
                            k, v[row],
                            bool(is_int[row]) if isinstance(is_int, np.ndarray) else is_int,
                        ),
                    )
                    for (lbl, k, v, d, is_int) in sel_arrays
                    if d[row]
                ),
            )
        return t

    out = {}
    for j, t in enumerate(hit_traces):
        lo_m = grp_bounds[j]
        hi_m = grp_bounds[j + 1] if j + 1 < len(hit_traces) else len(m_rows_all)
        if gkeys is not None:
            sel = ()  # grouped mode keeps spans per group, not per trace
        elif hi_m - lo_m > MAX_SPANS_PER_RESULT:
            # earliest by (start, span_id) — same rule as the object engine
            rows = m_rows_all[lo_m:hi_m]
            key = np.lexsort((sid[rows, 1], sid[rows, 0], starts[rows]))
            sel = lo_m + key[:MAX_SPANS_PER_RESULT]
        else:
            sel = range(lo_m, hi_m)
        root = int(root_row[t])
        p = TracePartial(
            trace_id=tid_be[t].tobytes(),
            matched=int(m_count[t]),
            start=int(t_start[t]),
            end=int(t_end[t]),
            root_service=dictionary[int(service[root])],
            root_name=dictionary[int(names[root])],
            has_root=bool(has_root_arr[t]),
            spans=[_tuple_at(i) for i in sel],
        )
        if gkeys is not None:
            # partials per (trace, group value); small python loop over
            # this trace's matched rows only
            pos_by_key: dict = {}
            for i in range(lo_m, hi_m):
                pos_by_key.setdefault(gkeys[m_rows_all[i]], []).append(i)
            p.groups = {}
            for key, poss in pos_by_key.items():
                rows_k = m_rows_all[poss]
                gp = _GroupPartial(matched=len(poss))
                for (aggname, v, d) in agg_raw:
                    if aggname == "count":
                        gp.aggs.append((len(poss), 0.0, np.inf, -np.inf))
                        continue
                    ok = rows_k[d[rows_k]]
                    if len(ok):
                        vals = v[ok]
                        gp.aggs.append(
                            (len(ok), float(vals.sum()), float(vals.min()), float(vals.max()))
                        )
                    else:
                        gp.aggs.append((0, 0.0, np.inf, -np.inf))
                if len(poss) > MAX_SPANS_PER_RESULT:
                    order = np.lexsort((sid[rows_k, 1], sid[rows_k, 0], starts[rows_k]))
                    keep = [poss[k] for k in order[:MAX_SPANS_PER_RESULT]]
                else:
                    keep = poss
                gp.spans = [_tuple_at(i) for i in keep]
                p.groups[key] = gp
        for (cnt, tot, mn, mx) in agg_parts:
            p.aggs.append(
                (
                    int(cnt[t]),
                    float(tot[t]),
                    float(mn[t]) if mn is not None else np.inf,
                    float(mx[t]) if mx is not None else -np.inf,
                )
            )
        out[p.trace_id] = p
    return out


def _aggs_pass(agg_stages, matched: int, aggs: list) -> bool:
    """Resolve the aggregate-filter chain over merged partials."""
    ok = matched > 0
    for stage, (cnt, tot, mn, mx) in zip(agg_stages, aggs):
        if not ok:
            break
        if stage.agg == "count":
            val = matched
        elif cnt == 0:
            return False
        else:
            val = {
                "avg": tot / cnt,
                "sum": tot,
                "min": mn,
                "max": mx,
            }[stage.agg]
        r = stage.rhs.value
        ok = {
            "=": val == r,
            "!=": val != r,
            ">": val > r,
            ">=": val >= r,
            "<": val < r,
            "<=": val <= r,
        }[stage.op]
    return ok


def finalize(pipeline: A.Pipeline, partials: dict, limit: int = 20,
             start_s: int = 0, end_s: int = 0) -> list:
    """Merged partials -> SpansetResult list (aggregate filters applied,
    exact trace-level time window enforced). In by() mode each group
    resolves its own aggregate chain; a trace matches if ANY group
    survives, and its matched spans are the union of surviving groups —
    the same union the object engine's run_stages produces."""
    from tempo_tpu_torch.traceql.engine import SpansetResult

    agg_stages = [s for s in pipeline.stages[1:] if isinstance(s, A.AggregateFilter)]
    group_mode = any(isinstance(s, A.GroupBy) for s in pipeline.stages)
    results = []
    for p in partials.values():
        if start_s and p.end < start_s * 10**9:
            continue
        if end_s and p.start > end_s * 10**9:
            continue
        if group_mode:
            matched_val = 0
            spans: list = []
            for g in (p.groups or {}).values():
                if _aggs_pass(agg_stages, g.matched, g.aggs):
                    matched_val += g.matched
                    spans.extend(g.spans)
            if matched_val == 0:
                continue
        else:
            if not _aggs_pass(agg_stages, p.matched, p.aggs):
                continue
            matched_val = p.matched
            spans = p.spans
        kept = sorted(spans, key=_span_key)[:MAX_SPANS_PER_RESULT]
        span_attrs = {}
        for s in kept:
            if len(s) > 4 and s[4]:
                span_attrs[bytes.fromhex(s[1])] = dict(s[4])
        results.append(
            SpansetResult(
                trace_id_hex=p.trace_id.hex(),
                root_service_name=p.root_service,
                root_trace_name=p.root_name,
                start_time_unix_nano=p.start,
                duration_ms=(p.end - p.start) // 10**6,
                spans=[_VSpan(*s[:4]) for s in kept],
                span_attrs=span_attrs,
                matched_override=matched_val,
            )
        )
    results.sort(key=lambda r: -r.start_time_unix_nano)
    return results[:limit] if limit else results


class _VSpan:
    """Duck-typed span for SpansetResult.to_dict()."""

    __slots__ = ("start_unix_nano", "_sid_hex", "name", "duration_nano")

    def __init__(self, start, sid_hex, name, dur):
        self.start_unix_nano = start
        self._sid_hex = sid_hex
        self.name = name
        self.duration_nano = dur

    @property
    def span_id(self):
        return bytes.fromhex(self._sid_hex)
