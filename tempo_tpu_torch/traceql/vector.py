"""Vectorized TraceQL evaluation over columnar span batches.

The hottest read loop of the reference runs as compiled column scans
(vparquet/block_traceql.go:279-617 iterator trees). This module is the
columnar equivalent: filters and field expressions evaluate as numpy
array ops over a SpanBatch.

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
operands raise Unsupported.

Type model: every field expression evaluates to (kind, values, defined)
with kind in {num, bool, str}; strings are block-dictionary codes, so
equality is code compare and regex resolves to a code set once per
block (the reference's dictionary-pruning trick,
pkg/parquetquery/predicates.go).

Port note: copied from tempo_tpu/traceql/vector.py with the parts that
the metrics path over span batches reaches — expression and spanset
evaluation, validation, projection. The block views, encoded-space
filters, compiled-tier lowering and the per-trace search partials (with
the object-engine fallback) arrive with the encoding and search slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tempo_tpu_torch.model.columnar import (
    SCOPE_RESOURCE,
    SCOPE_SPAN,
    VT_BOOL,
    VT_INT,
    VT_STR,
)
from tempo_tpu_torch.traceql import ast_nodes as A


class Unsupported(Exception):
    """Query shape the vector path does not cover; use the object engine."""


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
