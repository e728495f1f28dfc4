"""Port of tempo_tpu/util/stagetimings.py, copied as is (host code).

Per-request execution waterfall: where did this query's time go?

The reference answers "why is this query slow" with pprof + span
timings; here every search/query_range request carries a StageTimings
accumulator (contextvar-scoped, so the block reader and codec deep in
the stack record into the active request without parameter threading)
with one bucket per pipeline stage:

  queue_wait     job sat in the frontend queue before a worker pulled it
  admission      frontend admission gates (concurrency caps, byte pools)
  zonemap_prune  zone-map consults that skipped row groups
  fetch          backend ranged reads (coalesced page IO)
  decode         codec work materializing columns from fetched pages
  transfer       host->device shipping of dispatch arguments (timed at
                 the util/devicetiming seam; EXCLUSIVE of kernel)
  kernel         device dispatches (pallas/mesh), wall clock around
                 block_until_ready minus the transfer stage
                 (util/devicetiming.timed_dispatch)
  merge          frontend-side partial merging across shards
  other          worker execution time not attributed to any stage

plus a device dispatch count. Stage contexts are EXCLUSIVE: a nested
stage's time is subtracted from its parent, so the buckets sum to
(roughly) wall clock instead of double-counting.

Workers run jobs on their own threads/processes, so worker-side stages
travel back to the frontend in the job result ("stages" wire dict) and
merge shard-wise there — the same partial-merge seam the search and
metrics responses already use. The merged waterfall lands in the
response stats and in the `tempo_tpu_query_stage_seconds` histogram.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

from tempo_tpu_torch.util import metrics

STAGES = (
    "queue_wait",
    "admission",
    "zonemap_prune",
    "fetch",
    "decode",
    "transfer",
    "kernel",
    "merge",
    "other",
)

stage_seconds_hist = metrics.histogram(
    "tempo_tpu_query_stage_seconds",
    "Per-query execution time by pipeline stage (the waterfall)",
)
device_dispatches_total = metrics.counter(
    "tempo_tpu_query_device_dispatches_total",
    "Device dispatches issued on behalf of queries",
)


class StageTimings:
    """Thread-safe per-request stage accumulator (pool threads of one
    request all record into the same instance)."""

    __slots__ = ("seconds", "dispatches", "_lock")

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.dispatches = 0
        self._lock = threading.Lock()

    def add(self, stage: str, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self.seconds[stage] = self.seconds.get(stage, 0.0) + seconds

    def count_dispatch(self, n: int = 1) -> None:
        with self._lock:
            self.dispatches += n

    def total(self) -> float:
        with self._lock:
            return sum(self.seconds.values())

    def merge_wire(self, wire: dict | None) -> None:
        """Fold a worker's stage wire (to_wire form) into this one."""
        if not wire:
            return
        for stage, s in (wire.get("stageSeconds") or {}).items():
            self.add(str(stage), float(s))
        n = int(wire.get("deviceDispatches") or 0)
        if n:
            self.count_dispatch(n)

    def to_wire(self) -> dict:
        with self._lock:
            return {
                "stageSeconds": {k: round(v, 6) for k, v in self.seconds.items()},
                "deviceDispatches": self.dispatches,
            }

    def observe(self, kind: str) -> None:
        """Publish this request's waterfall to the process histograms."""
        with self._lock:
            items = list(self.seconds.items())
            n = self.dispatches
        for stage, s in items:
            stage_seconds_hist.observe(s, stage=stage, kind=kind)
        if n:
            device_dispatches_total.inc(n, kind=kind)


_active: contextvars.ContextVar = contextvars.ContextVar(
    "tempo_stage_timings", default=None
)
# (stage_name, child_seconds_cell) of the innermost open stage, for
# exclusive accounting; None outside any stage
_open_stage: contextvars.ContextVar = contextvars.ContextVar(
    "tempo_open_stage", default=None
)


def active() -> StageTimings | None:
    return _active.get()


@contextlib.contextmanager
def request(acc: StageTimings | None = None):
    """Activate `acc` (or a fresh accumulator) for this context; yields
    it. db/pool copies the context into its worker threads, so block
    jobs record into the same request accumulator."""
    acc = acc or StageTimings()
    token = _active.set(acc)
    try:
        yield acc
    finally:
        _active.reset(token)


# shared no-op context for calls outside any request: the hot read path
# enters stages unconditionally, so the inactive case must cost one
# contextvar read, not a fresh generator (nullcontext is reentrant)
_NULL_STAGE = contextlib.nullcontext()


class _Stage:
    __slots__ = ("acc", "name", "parent", "cell", "token", "t0")

    def __init__(self, acc, name):
        self.acc = acc
        self.name = name

    def __enter__(self):
        self.parent = _open_stage.get()
        self.cell = [0.0]  # seconds consumed by OUR nested stages
        self.token = _open_stage.set((self.name, self.cell))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        _open_stage.reset(self.token)
        self.acc.add(self.name, max(0.0, dt - self.cell[0]))
        if self.parent is not None:
            self.parent[1][0] += dt
        return False


def stage(name: str):
    """Attribute the wrapped work to `name` on the active accumulator
    (shared no-op when none is active). Nested stages subtract from
    their parent so time is counted exactly once."""
    acc = _active.get()
    if acc is None:
        return _NULL_STAGE
    return _Stage(acc, name)


def add(name: str, seconds: float) -> None:
    """Record pre-measured time (e.g. a device dispatch timed by
    util/devicetiming) — behaves like a zero-overhead nested stage, so
    an enclosing stage() does not double-count it."""
    acc = _active.get()
    if acc is None:
        return
    acc.add(name, seconds)
    parent = _open_stage.get()
    if parent is not None:
        parent[1][0] += seconds


def count_dispatch(n: int = 1) -> None:
    acc = _active.get()
    if acc is not None:
        acc.count_dispatch(n)
