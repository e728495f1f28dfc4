"""TraceQL recursive-descent parser.

Reference grammar: pkg/traceql/expr.y (goyacc). Precedence (field
expressions, loosest to tightest): || &&, comparisons, + -, * / %, ^,
unary. Spanset level: primary `{...}` / parens, then left-assoc chains
of && || > >>, then `|` pipeline stages.
"""

from __future__ import annotations

from tempo_tpu_torch.traceql import ast_nodes as A
from tempo_tpu_torch.traceql.lexer import Token, lex


class ParseError(Exception):
    pass


KIND_KEYWORDS = A.KIND_KEYWORDS
STATUS_KEYWORDS = A.STATUS_KEYWORDS
AGG_NAMES = ("count", "avg", "min", "max", "sum")
INTRINSICS = ("duration", "name", "status", "kind", "childCount", "parent")


class Parser:
    def __init__(self, src: str):
        try:
            self.toks = lex(src)
        except Exception as e:
            raise ParseError(str(e)) from e
        self.i = 0

    # -- token helpers --------------------------------------------------
    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, text=None):
        t = self.peek()
        if t.kind == kind and (text is None or t.text == text):
            return self.next()
        return None

    def expect(self, kind, text=None) -> Token:
        t = self.accept(kind, text)
        if t is None:
            got = self.peek()
            raise ParseError(f"expected {text or kind}, got {got.text!r} at {got.pos}")
        return t

    # -- entry ----------------------------------------------------------
    def parse(self) -> A.Pipeline:
        t = self.peek()
        if t.kind == "keyword" and (t.text in AGG_NAMES or t.text == "by"):
            # a pipeline may start with a scalar filter or by() — the
            # implicit input is the match-all spanset (reference:
            # spansetPipeline: scalarFilter | groupOperation, expr.y)
            stages = [A.SpansetFilter(None), self.parse_stage()]
        else:
            stages = [self.parse_spanset_expr()]
        while self.accept("op", "|"):
            stages.append(self.parse_stage())
        self.expect("eof")
        return A.Pipeline(stages)

    # -- spanset level ---------------------------------------------------
    def parse_spanset_expr(self):
        lhs = self.parse_spanset_primary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("&&", "||", ">", ">>", "~"):
                self.next()
                rhs = self.parse_spanset_primary()
                lhs = A.SpansetOp(t.text, lhs, rhs)
            else:
                return lhs

    def parse_spanset_primary(self):
        if self.accept("op", "("):
            e = self.parse_spanset_expr()
            if self.peek().kind == "op" and self.peek().text == "|":
                # wrapped pipeline as a spanset operand (reference:
                # wrappedSpansetPipeline, pkg/traceql/expr.y)
                stages = [e]
                while self.accept("op", "|"):
                    stages.append(self.parse_stage())
                e = A.Pipeline(stages)
            self.expect("op", ")")
            return e
        self.expect("op", "{")
        if self.accept("op", "}"):
            return A.SpansetFilter(None)
        expr = self.parse_field_expr()
        self.expect("op", "}")
        return A.SpansetFilter(expr)

    def parse_stage(self):
        t = self.peek()
        if t.kind == "op" and t.text in ("{", "("):
            # `| { ... }` (or a parenthesized spanset expr): re-filter
            # the spans of each spanset (reference: spansetPipeline PIPE
            # spansetExpression, pkg/traceql/expr.y)
            return self.parse_spanset_expr()
        if t.kind == "keyword" and t.text == "coalesce":
            self.next()
            self.expect("op", "(")
            self.expect("op", ")")
            return A.Coalesce()
        if t.kind == "keyword" and t.text == "by":
            self.next()
            self.expect("op", "(")
            expr = self.parse_field_expr()
            self.expect("op", ")")
            return A.GroupBy(expr)
        if t.kind == "keyword" and t.text == "select":
            self.next()
            self.expect("op", "(")
            exprs = [self.parse_field_expr()]
            while self.accept("op", ","):
                exprs.append(self.parse_field_expr())
            self.expect("op", ")")
            for e in exprs:
                if not isinstance(e, (A.Attribute, A.Intrinsic)):
                    raise ParseError("select() takes attribute or intrinsic fields")
            return A.Select(exprs)
        if t.kind == "ident" and t.text in A.METRICS_FUNCS:
            return self._parse_metrics_stage()
        if t.kind == "keyword" and t.text in AGG_NAMES:
            self.next()
            self.expect("op", "(")
            fe = None
            if t.text != "count":
                fe = self.parse_field_expr()
            self.expect("op", ")")
            op_t = self.peek()
            if not (op_t.kind == "op" and op_t.text in ("=", "!=", ">", ">=", "<", "<=")):
                raise ParseError(f"aggregate {t.text} needs a comparison, got {op_t.text!r}")
            self.next()
            rhs = self.parse_literal()
            return A.AggregateFilter(t.text, fe, op_t.text, rhs)
        raise ParseError(f"unknown pipeline stage at {t.pos}: {t.text!r}")

    def _parse_metrics_stage(self):
        """`| rate() [by (expr)]`, `| count_over_time() [by (...)]`,
        `| quantile_over_time(field, q, ...) [by (...)]`,
        `| histogram_over_time(field) [by (...)]` (reference:
        metricsAggregation, pkg/traceql/expr.y)."""
        func = self.next().text
        self.expect("op", "(")
        value_expr = None
        qs: list[float] = []
        if func in ("quantile_over_time", "histogram_over_time"):
            value_expr = self.parse_field_expr()
            if func == "quantile_over_time":
                while self.accept("op", ","):
                    lit = self.parse_literal()
                    if lit.kind not in ("int", "float"):
                        raise ParseError(f"quantile must be a number, got {lit.kind}")
                    qs.append(float(lit.value))
                if not qs:
                    raise ParseError("quantile_over_time() needs at least one quantile")
        self.expect("op", ")")
        by_expr = None
        if self.accept("keyword", "by"):
            self.expect("op", "(")
            by_expr = self.parse_field_expr()
            self.expect("op", ")")
        return A.MetricsAggregate(func, value_expr, tuple(qs), by_expr)

    # -- field expression precedence climb -------------------------------
    def parse_field_expr(self):
        return self._parse_or()

    def _parse_or(self):
        lhs = self._parse_and()
        while self.accept("op", "||"):
            lhs = A.Binary("||", lhs, self._parse_and())
        return lhs

    def _parse_and(self):
        lhs = self._parse_cmp()
        while self.accept("op", "&&"):
            lhs = A.Binary("&&", lhs, self._parse_cmp())
        return lhs

    def _parse_cmp(self):
        lhs = self._parse_add()
        t = self.peek()
        if t.kind == "op" and t.text in A.COMPARISON_OPS:
            self.next()
            rhs = self._parse_add()
            if t.text in ("=~", "!~"):
                if not (isinstance(rhs, A.Literal) and rhs.kind == "string"):
                    raise ParseError("regex operator requires a string literal on the right")
                import re as _re

                try:
                    _re.compile(rhs.value)
                except _re.error as e:
                    raise ParseError(f"invalid regex {rhs.value!r}: {e}") from e
            return A.Binary(t.text, lhs, rhs)
        return lhs

    def _parse_add(self):
        lhs = self._parse_mul()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("+", "-"):
                self.next()
                lhs = A.Binary(t.text, lhs, self._parse_mul())
            else:
                return lhs

    def _parse_mul(self):
        lhs = self._parse_pow()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("*", "/", "%"):
                self.next()
                lhs = A.Binary(t.text, lhs, self._parse_pow())
            else:
                return lhs

    def _parse_pow(self):
        lhs = self._parse_unary()
        if self.accept("op", "^"):
            return A.Binary("^", lhs, self._parse_pow())  # right assoc
        return lhs

    def _parse_unary(self):
        t = self.peek()
        if t.kind == "op" and t.text in ("-", "!"):
            self.next()
            return A.Unary(t.text, self._parse_unary())
        return self._parse_primary()

    def _parse_primary(self):
        t = self.peek()
        if t.kind == "op" and t.text == "(":
            self.next()
            e = self.parse_field_expr()
            self.expect("op", ")")
            return e
        if t.kind == "attr":
            self.next()
            return A.Attribute("any", t.value)
        if t.kind in ("string", "int", "float", "duration"):
            return self.parse_literal()
        if t.kind == "keyword":
            return self._parse_keyword_primary()
        if t.kind == "ident":
            # scoped attributes lex as one ident because '.' is an ident
            # char: span.level, resource.service.name, parent.name
            for scope in ("span", "resource", "parent"):
                if t.text.startswith(scope + ".") and len(t.text) > len(scope) + 1:
                    self.next()
                    return A.Attribute(scope, t.text[len(scope) + 1 :])
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    def _parse_keyword_primary(self):
        t = self.next()
        kw = t.text
        if kw in ("true", "false"):
            return A.Literal(kw == "true", "bool")
        if kw == "nil":
            return A.Literal(None, "nil")
        if kw in STATUS_KEYWORDS:
            return A.Literal(STATUS_KEYWORDS[kw], "status")
        if kw in KIND_KEYWORDS:
            return A.Literal(KIND_KEYWORDS[kw], "kind")
        if kw in ("span", "resource"):
            at = self.expect("attr")
            return A.Attribute(kw, at.value)
        if kw == "parent":
            nxt = self.peek()
            if nxt.kind == "attr":
                self.next()
                return A.Attribute("parent", nxt.value)
            return A.Intrinsic("parent")
        if kw in INTRINSICS:
            return A.Intrinsic(kw)
        raise ParseError(f"unexpected keyword {kw!r} at {t.pos}")

    def parse_literal(self) -> A.Literal:
        t = self.next()
        if t.kind == "string":
            return A.Literal(t.value, "string")
        if t.kind == "int":
            return A.Literal(t.value, "int")
        if t.kind == "float":
            return A.Literal(t.value, "float")
        if t.kind == "duration":
            return A.Literal(t.value, "duration")
        if t.kind == "keyword" and t.text in STATUS_KEYWORDS:
            return A.Literal(STATUS_KEYWORDS[t.text], "status")
        if t.kind == "keyword" and t.text in KIND_KEYWORDS:
            return A.Literal(KIND_KEYWORDS[t.text], "kind")
        if t.kind == "keyword" and t.text in ("true", "false"):
            return A.Literal(t.text == "true", "bool")
        raise ParseError(f"expected literal, got {t.text!r} at {t.pos}")


def parse(src: str, validate: bool = True) -> A.Pipeline:
    """Parse + statically validate (reference runs the same two phases:
    yacc parse then ast.validate(), both surfacing as query errors)."""
    if not src or not src.strip():
        raise ParseError("empty query")
    p = Parser(src).parse()
    if validate:
        try:
            A.validate(p)
        except A.TypeError_ as e:
            raise ParseError(f"invalid query: {e}") from e
    return p
