"""Port of tempo_tpu/util/deadline.py, copied as is (host code).

Per-request deadline propagation (frontend -> job -> querier -> backend).

Reference analog: the Go stack threads context.Context deadlines from the
frontend's round-tripper through the querier into every backend read, so
a query that has already timed out upstream stops consuming work
downstream. Python has no ambient context, so this is a tiny
contextvars-based scope: the worker enters `scope(deadline_ts)` around
job execution, and anything below — backend ops, retry loops, fault
injection — calls `check()` / bounds its own timeouts with `remaining()`.

An exceeded deadline raises DeadlineExceeded, which the whole stack
treats as TERMINAL: retrying work whose requester already gave up only
amplifies load during an incident (the frontend's retry loop and the
worker pools both refuse to retry it).

contextvars (not threading.local) so JobPool can propagate the scope
into its worker threads via copy_context — see db/pool.py.
"""

from __future__ import annotations

import contextlib
import contextvars
import time


class DeadlineExceeded(Exception):
    """The request's deadline passed; terminal, never retried."""


_deadline_ts: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "tempo_tpu_deadline_ts", default=None
)


@contextlib.contextmanager
def scope(deadline_ts: float | None):
    """Enter a deadline scope. deadline_ts: absolute unix seconds
    (time.time() base — it crosses process boundaries in job
    descriptors); None/0 = no deadline (no-op scope)."""
    if not deadline_ts:
        yield
        return
    tok = _deadline_ts.set(float(deadline_ts))
    try:
        yield
    finally:
        _deadline_ts.reset(tok)


def current() -> float | None:
    """The active absolute deadline, or None."""
    return _deadline_ts.get()


def remaining() -> float | None:
    """Seconds left before the active deadline, or None when no deadline
    is set. Can be negative (already exceeded)."""
    ts = _deadline_ts.get()
    if ts is None:
        return None
    return ts - time.time()


def check() -> None:
    """Raise DeadlineExceeded when the active deadline has passed."""
    rem = remaining()
    if rem is not None and rem <= 0:
        raise DeadlineExceeded(f"deadline exceeded by {-rem:.3f}s")


def bound_timeout(timeout_s: float) -> float:
    """Clamp a local timeout to the remaining deadline (never below a
    small floor so in-flight syscalls can still fail fast cleanly)."""
    rem = remaining()
    if rem is None:
        return timeout_s
    return max(0.001, min(timeout_s, rem))
