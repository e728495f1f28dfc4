"""TraceQL: lexer, typed AST and recursive-descent parser, the exact
object engine (engine.py) and the vectorized evaluator (vector.py).
Port of tempo_tpu/traceql, which exports the same names."""

from tempo_tpu_torch.traceql.engine import Engine, execute  # noqa: F401
from tempo_tpu_torch.traceql.parser import ParseError, parse  # noqa: F401
