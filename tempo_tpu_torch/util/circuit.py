"""Port of tempo_tpu/util/circuit.py (host code).

Shared circuit breaker: closed -> open -> half-open -> closed.

Reference analog: dskit's circuitbreaker middleware around store-gateway
/ ingester clients. The system retries at every layer (per-op
with_retries, PooledHTTPClient attempts, worker-pool retries, frontend
job resubmission) — exactly the machinery that AMPLIFIES an outage when
the backend is down for everyone, not flaking for one request. The
breaker is the anti-amplification valve those layers share:

- CLOSED: requests flow; consecutive *retryable* failures count
  (terminal errors — NotFound, CorruptPage, client mistakes — say
  nothing about backend health and never trip it).
- OPEN: every attempt fails fast with CircuitOpen (no I/O, no backoff
  burned) until reset_timeout_s has passed.
- HALF-OPEN: at most probe_budget concurrent probes go through; one
  success closes the breaker, one failure re-opens it.

CircuitOpen subclasses ConnectionError, so the retry taxonomy
(backend/faults.retryable_error) classifies it retryable: callers keep
their bounded retry loops, but every attempt inside the open window is
a microsecond-level local failure instead of a network hit on the
struggling backend — retries stop amplifying the outage by
construction. It also carries retry_after_s (time until the next probe
window) so shed responses can forward a meaningful hint.

The clock is injectable so chaos tests drive open->half-open->closed
transitions deterministically without sleeping.
"""

from __future__ import annotations

import threading
import time

from tempo_tpu_torch.util import metrics

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

state_gauge = metrics.gauge(
    "tempo_tpu_circuit_state", "Breaker state (0=closed 1=half-open 2=open)"
)
transitions_total = metrics.counter(
    "tempo_tpu_circuit_transitions_total", "Breaker state transitions, by target state"
)
rejected_total = metrics.counter(
    "tempo_tpu_circuit_rejected_total", "Attempts failed fast by an open breaker"
)


class CircuitOpen(ConnectionError):
    """Failed fast: the breaker is open. Retryable by taxonomy, but
    costs nothing — that is the point."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class CircuitBreaker:
    def __init__(
        self,
        name: str = "backend",
        failure_threshold: int = 5,
        reset_timeout_s: float = 10.0,
        probe_budget: int = 1,
        clock=time.monotonic,
    ):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = float(reset_timeout_s)
        self.probe_budget = max(1, int(probe_budget))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_inflight = 0
        state_gauge.set(CLOSED, name=self.name)

    # ------------------------------------------------------------------
    def _set_state(self, state: int) -> None:
        # callers hold self._lock
        if state != self._state:
            self._state = state
            state_gauge.set(state, name=self.name)
            transitions_total.inc(name=self.name, to=_STATE_NAMES[state])

    @property
    def state(self) -> str:
        with self._lock:
            return _STATE_NAMES[self._state]

    # ------------------------------------------------------------------
    def before(self) -> None:
        """Gate one attempt; raises CircuitOpen to fail fast. An allowed
        attempt MUST be paired with exactly one record_success /
        record_failure (the half-open probe budget is a lease)."""
        now = self._clock()
        with self._lock:
            if self._state == OPEN:
                remaining = self._opened_at + self.reset_timeout_s - now
                if remaining > 0:
                    rejected_total.inc(name=self.name)
                    raise CircuitOpen(
                        f"circuit {self.name!r} open "
                        f"({self._failures} consecutive failures); "
                        f"probe in {remaining:.2f}s",
                        retry_after_s=remaining,
                    )
                self._set_state(HALF_OPEN)
                self._probes_inflight = 0
            if self._state == HALF_OPEN:
                if self._probes_inflight >= self.probe_budget:
                    rejected_total.inc(name=self.name)
                    raise CircuitOpen(
                        f"circuit {self.name!r} half-open; probe budget "
                        f"({self.probe_budget}) in flight",
                        retry_after_s=self.reset_timeout_s,
                    )
                self._probes_inflight += 1

    def record_success(self) -> None:
        with self._lock:
            if self._state == OPEN:
                # a straggler admitted BEFORE the trip finishing now says
                # nothing about current health — closing here would let
                # one slow success cancel the whole open window while
                # failures are still pouring in
                return
            if self._state == HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)
            self._failures = 0
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        now = self._clock()
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh window
                self._probes_inflight = max(0, self._probes_inflight - 1)
                self._opened_at = now
                self._set_state(OPEN)
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = now
                self._set_state(OPEN)

    # ------------------------------------------------------------------
    def run(self, fn, classify=None):
        """Run fn() behind the breaker. classify(exc) -> bool decides
        whether an exception counts as a breaker failure (default: the
        retryable-vs-terminal taxonomy — only infrastructure-ish errors
        indicate backend health)."""
        if classify is None:
            from tempo_tpu_torch.backend.faults import retryable_error

            classify = retryable_error
        self.before()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — classified, then re-raised
            if classify(e):
                self.record_failure()
            else:
                # terminal errors release the half-open probe lease
                # without a health verdict either way
                with self._lock:
                    if self._state == HALF_OPEN:
                        self._probes_inflight = max(0, self._probes_inflight - 1)
            raise
        self.record_success()
        return out
