"""Compiled-query tier: shape-keyed fused device programs.

Port of tempo_tpu/compiled/. One normalized query shape
(util/queryshape) -> one lowering verdict; one static signature (codec
mix, pad widths) -> ONE fused program whose literals and time bounds are
runtime arguments. A simple-count metrics query over blocks then runs as
one dispatch per codec group (the hand-written dbp_decode and
compiled_metrics kernels on the card) instead of the interpreter's
per-row-group train. Kill switch: TEMPO_TPU_COMPILED=0 or
compiled.enabled=false (results are bit-identical either way; the tier
only changes WHERE the counting happens).
"""

from tempo_tpu_torch.compiled.cache import (  # noqa: F401
    CompiledConfig,
    ShapeCache,
    configure,
    enabled,
    shape_cache,
)
from tempo_tpu_torch.compiled.executor import (  # noqa: F401
    observe_search_shape,
    try_query_range,
    try_query_range_many,
)
from tempo_tpu_torch.compiled.lower import lower_metrics_plan  # noqa: F401
