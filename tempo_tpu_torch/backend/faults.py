"""Port of tempo_tpu/backend/faults.py: the retryable-vs-terminal
error taxonomy (`retryable_error`) and the per-operation retry loop
(`with_retries`) that TempoDB's block-scoped reads run under.

The seeded fault-injecting backend (`FaultInjectingBackend`, `FaultPlan`
and the `TEMPO_TPU_FAULTS` plan) arrives with the chaos tests.

Connection-ish errors retry; NotFound / CorruptPage / DeadlineExceeded /
client errors are terminal.
"""

from __future__ import annotations

import time

from tempo_tpu_torch.backend.base import NotFound
from tempo_tpu_torch.util import deadline


def retryable_error(e: Exception) -> bool:
    """The retryable-vs-terminal taxonomy (reference: retry.go retries
    5xx only; the SDKs retry connection resets). Terminal: the request
    can never succeed by repetition — missing object, corrupt data,
    exceeded deadline, or a client mistake.

    Overload-control errors compose with it: ResourceExhausted (a shed
    with a retry hint) is retryable-with-backoff."""
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage
    from tempo_tpu_torch.util.resource import ResourceExhausted

    if isinstance(e, (NotFound, CorruptPage, deadline.DeadlineExceeded)):
        return False
    if isinstance(e, ResourceExhausted):
        return True
    if isinstance(e, (ValueError, TypeError, KeyError, PermissionError)):
        return False
    return isinstance(e, (IOError, OSError, ConnectionError, TimeoutError))


def with_retries(fn, attempts: int = 3, backoff_s: float = 0.01):
    """Run fn with bounded retries of RETRYABLE errors (taxonomy above),
    backoff clipped to the propagated deadline.

    This is the per-OPERATION retry layer for block-scoped reads
    (TempoDB.guard_block). It matters because the
    job layers above retry whole multi-block jobs: without per-op
    retries, one transient blip anywhere fails the entire job, and the
    probability of a job-level retry passing every operation cleanly
    decays exponentially with job size — under sustained fault rates a
    query can never converge. Per-op retries make each operation
    individually likely to succeed, which is how the reference behaves
    too (its object-store SDK retries sit beneath every read).

    The reference's optional circuit breaker (`breaker=`, util/circuit)
    arrives with the HTTP client that shares it."""
    last: Exception | None = None
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if not retryable_error(e) or i == attempts - 1:
                raise
            last = e
            time.sleep(deadline.bound_timeout(backoff_s * (2 ** i)))
            deadline.check()  # out of budget mid-backoff: terminal
    raise last  # pragma: no cover — loop always returns or raises
