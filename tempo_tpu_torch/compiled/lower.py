"""Lowerable-plan extraction: MetricsPlan -> LoweredMetrics.

Port of tempo_tpu/compiled/lower.py (host code).

A plan lowers when its reduction is a pure span count per time bin
(plan.is_simple_count_plan) and every filter stage flattens to an AND
of per-column predicates (vector.compiled_filter_specs). The lowering
is cheap (one AST walk, microseconds) and runs per query — what the
shape cache actually saves is (a) the walk for KNOWN-unlowerable
shapes and (b) the program's launch plan, which literal swaps share
because literals/time bounds are runtime arguments of the fused program.

Exactness contract: every formula here mirrors the encoded-space
interpreter (vector._enc_expr_mask) term for term —

  =   (v == code) & (v != 0)        -> isin(v, {code})         code>=1
  !=  (v != code) & (v != 0)        -> NOT isin(v, {code, 0})
  =~  isin(v, rx) & (v != 0)        -> isin(v, rx \\ {0})
  !~  ~(isin(v, rx) & v!=0) & v!=0  -> NOT isin(v, rx | {0})

(code 0 is the dictionary's "absent" sentinel and can never equal a
real string). Duration predicates compare as float64 on the
interpreter; for unsigned integer columns that comparison is EXACTLY
an inclusive integer range when the literal sits below 2^53 (float64
is monotone over the integers and exact below 2^53) — literals at or
above 2^53 decline and fall back rather than risk a rounding
divergence."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from tempo_tpu_torch.metrics_engine.plan import MetricsPlan, is_simple_count_plan

NO_MATCH = np.uint32(0xFFFFFFFF)
_U64_MAX = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class LoweredMetrics:
    """One query's lowered form: per-column predicates plus the static
    column signature the program cache keys on. Literal-dependent
    pieces (code values, range bounds) live in preds and ship as
    runtime arguments; colsig is shape-stable across literal swaps."""

    preds: tuple   # ("set", col, invert, value) | ("range", col, lo, hi)
    colsig: tuple  # ("set", col, invert) | ("range", col) per pred


def _duration_bounds(op: str, rv: float):
    """Inclusive u64 [lo, hi] equal to `float64(v) op rv` over unsigned
    integer v, or None when no exact range exists (rv >= 2^53)."""
    if rv < 0:
        # every unsigned value exceeds a negative bound
        return (0, _U64_MAX) if op in (">", ">=") else (1, 0)
    if rv >= 2.0 ** 53:
        return None
    if op == ">":
        return (math.floor(rv) + 1, _U64_MAX)
    if op == ">=":
        return (math.ceil(rv), _U64_MAX)
    if op == "<":
        return (0, math.ceil(rv) - 1) if rv > 0 else (1, 0)
    if op == "<=":
        return (0, math.floor(rv))
    return None


def lower_metrics_plan(plan: MetricsPlan) -> LoweredMetrics | None:
    """The plan's compiled form, or None (interpreter fallback)."""
    from tempo_tpu_torch.traceql import vector

    if not is_simple_count_plan(plan):
        return None
    # the device bins in u32 epoch seconds; the nested-floor identity
    # needs integer-second start/step inside u32 range (the interpreter
    # keeps int64 — out-of-range windows simply stay on it)
    if not (0 <= plan.start_s < 2 ** 32 and 0 < plan.step_s < 2 ** 32):
        return None
    specs = vector.compiled_filter_specs(plan.filters)
    if specs is None:
        return None
    preds, colsig = [], []
    for spec in specs:
        if spec[0] == "set":
            _, col, mode, value = spec
            invert = mode in ("ne", "nre")
            preds.append(("set", col, mode, value))
            colsig.append(("set", col, invert))
        else:
            _, col, op, rv = spec
            bounds = _duration_bounds(op, rv)
            if bounds is None:
                return None
            preds.append(("range", col, bounds[0], bounds[1]))
            colsig.append(("range", col))
    return LoweredMetrics(preds=tuple(preds), colsig=tuple(colsig))


def resolve_codes(pred, d) -> np.ndarray:
    """One set predicate's accepted code set against one BLOCK
    dictionary — u32, unpadded (the executor pads per dispatch group).
    The invert flag in the colsig decides membership vs exclusion; the
    0/sentinel handling here makes the pair equal the interpreter's
    formulas above."""
    from tempo_tpu_torch.traceql.vector import _regex_codes

    _, _col, mode, value = pred
    if mode == "eq":
        code = d.get(value)
        # absent literal: nothing matches; the NO_MATCH sentinel is
        # exactly the interpreter's `want` in that case
        return np.array([code if code is not None else NO_MATCH], np.uint32)
    if mode == "ne":
        code = d.get(value)
        want = np.uint32(code) if code is not None else NO_MATCH
        return np.array([want, 0], np.uint32)
    codes = _regex_codes(d, value)
    if mode == "re":
        codes = codes[codes != 0]
        return codes if codes.size else np.array([NO_MATCH], np.uint32)
    # nre: exclusion set always contains the absent code
    return np.union1d(codes, np.array([0], np.uint32)).astype(np.uint32)
