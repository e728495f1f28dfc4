"""TraceQL: lexer, typed AST and recursive-descent parser (copied from
tempo_tpu/traceql), plus the vectorized evaluator that metrics queries
use (vector.py)."""

from tempo_tpu_torch.traceql.parser import ParseError, parse  # noqa: F401
