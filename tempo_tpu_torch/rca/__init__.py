"""Port of tempo_tpu/rca (host code).

Auto-RCA plane: machine-written incident reports.

A fast-burn SLO transition (util/slo) or a standing-query deviation
(standing/engine) opens a bounded incident record carrying a typed root
cause and the evidence that supports it — see rca/engine.py for the
mechanism and rca/classify.py for the cause taxonomy.
"""

from tempo_tpu_torch.rca.classify import CAUSES, classify  # noqa: F401
from tempo_tpu_torch.rca.engine import (  # noqa: F401
    RCAConfig,
    RCAEngine,
    UnknownIncident,
)
