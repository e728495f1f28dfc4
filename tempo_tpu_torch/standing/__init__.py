"""Standing-query subsystem: incremental streaming metrics + the
step-partial downsampling tier. Port of tempo_tpu/standing.

- `engine.py` — registered `query_range` queries evaluate incrementally
  against live ingest: each cut's delta folds into a per-query standing
  accumulator (on a CUDA device through the `seg_bincount` kernel), so
  dashboards and alert rules cost O(new spans), not O(re-scan).
- `rules.py` — flush and compaction write per-block pre-bucketed
  (series, bin) count columns for a small configured rule set, so a
  `query_range` matching a rule reads step partials with zero
  span-column fetches (and a restart rebuilds standing accumulators
  from the same partials). The reference's `step_partials_enabled`
  (the `TEMPO_TPU_STEP_PARTIALS` switch) is not exported: the port
  switches the tier off with `BlockConfig(step_partial_rules=())`.
"""

from tempo_tpu_torch.standing.engine import (  # noqa: F401
    StandingConfig,
    StandingEngine,
    StandingQuery,
    UnknownStandingQuery,
)
from tempo_tpu_torch.standing.rules import (  # noqa: F401
    DEFAULT_STEP_RULES,
    StepRule,
    block_rules,
    evaluate_block_hybrid,
    match_rule,
)
