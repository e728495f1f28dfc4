"""Port of tempo_tpu/util/resource.py, copied as is (host code).

Process-wide resource governor: accounted pools + RSS -> pressure.

Reference analog: the dskit limiters + ingester instance limits the
reference leans on are all *local* caps; what actually protects a
process under sustained 10-100x traffic is a single view of memory
pressure that every module consults. This module provides it:

- Named accounted byte pools (live traces, WAL head blocks, inflight
  push/query bytes; the colcache and ReadAhead report through their own
  gauges but *react* to the level computed here). Pools are plain
  thread-safe counters with an optional limit — `try_add` is the
  admission primitive, `add`/`sub` the accounting one.
- RSS sampling (/proc/self/statm, cached for rss_sample_period_s) so
  un-accounted allocations still register.
- A pressure level derived from the worst pool fraction and the RSS
  watermarks: OK below the soft watermark, PRESSURE between soft and
  hard (cut/flush early, shrink caches, stop prefetching, tighten
  admission), CRITICAL above hard (refuse work with a retryable
  ResourceExhausted that carries a retry hint).

ResourceExhausted is the ONE shedding error of the stack: the HTTP
layer maps it to 429 + Retry-After, the gRPC layer to RESOURCE_EXHAUSTED
with a RetryInfo detail, and the retryable-vs-terminal taxonomy
(backend/faults.retryable_error) treats it as retryable-with-backoff —
the client should slow down and come back, not give up.

One governor per process (`governor()`); tests construct private
instances and hand them to the modules under test.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from tempo_tpu_torch.util import metrics

LEVEL_OK = 0
LEVEL_PRESSURE = 1
LEVEL_CRITICAL = 2
LEVEL_NAMES = {LEVEL_OK: "ok", LEVEL_PRESSURE: "pressure", LEVEL_CRITICAL: "critical"}

# pools whose fill level drives the process pressure level (admission
# gates like inflight_push/query enforce their own limits directly and
# must not mark the whole process unhealthy when briefly full)
PRESSURE_POOLS = ("live_traces", "wal_head")

shed_total = metrics.counter(
    "tempo_tpu_shed_total",
    "Requests shed by the overload control plane, by component and reason",
)
pressure_level_gauge = metrics.gauge(
    "tempo_tpu_pressure_level",
    "Process pressure level (0=ok 1=pressure 2=critical)",
)
pool_bytes_gauge = metrics.gauge(
    "tempo_tpu_resource_pool_bytes", "Accounted bytes per resource pool"
)
pool_limit_gauge = metrics.gauge(
    "tempo_tpu_resource_pool_limit_bytes", "Configured limit per resource pool (0=unlimited)"
)
rss_gauge = metrics.gauge("tempo_tpu_process_rss_bytes", "Sampled process RSS")


class TokenBucket:
    """The stack's one token-bucket: per-tenant ingest limiters
    (modules/distributor) and the self-tracing export bound
    (util/tracing.SelfTraceExporter) share this arithmetic."""

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t = time.monotonic()
        self.last_used = self.t
        self.lock = threading.Lock()

    def allow_n(self, n: float) -> bool:
        with self.lock:
            now = time.monotonic()
            self.last_used = now
            self.tokens = min(self.burst, self.tokens + (now - self.t) * self.rate)
            self.t = now
            if n <= self.tokens:
                self.tokens -= n
                return True
            return False

    def retry_after_s(self, n: float) -> float:
        """Seconds until n tokens will have refilled — the Retry-After
        hint for a rejected request of size n. Deliberately NOT capped
        at the burst size: a request larger than the burst gets the
        honest (long) accrual time rather than a zero hint."""
        with self.lock:
            if self.rate <= 0:
                return 1.0
            return max(0.0, (n - self.tokens) / self.rate)


class ResourceExhausted(Exception):
    """Shed: the process (or one of its pools) is over budget. Carries a
    retry hint — HTTP surfaces it as Retry-After, gRPC as RetryInfo."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class Pool:
    """Thread-safe accounted byte counter with an optional limit."""

    def __init__(self, name: str, limit: int = 0):
        self.name = name
        self.limit = int(limit)
        self._used = 0
        self._lock = threading.Lock()

    @property
    def used(self) -> int:
        with self._lock:
            return self._used

    def add(self, n: int) -> None:
        with self._lock:
            self._used += int(n)

    def sub(self, n: int) -> None:
        with self._lock:
            # clamp: a missed add (crashed caller) must not wedge the
            # pool permanently negative and mask real growth
            self._used = max(0, self._used - int(n))

    def try_add(self, n: int) -> bool:
        """Admission primitive: reserve n bytes unless it would exceed
        the limit. Unlimited pools always admit (accounting only)."""
        n = int(n)
        with self._lock:
            if self.limit and self._used + n > self.limit:
                return False
            self._used += n
            return True

    def fraction(self) -> float:
        with self._lock:
            if not self.limit:
                return 0.0
            return self._used / self.limit


@dataclasses.dataclass
class ResourceConfig:
    """Budgets for the governor (config section `resource`). All byte
    limits 0 = unlimited (that pool becomes accounting-only)."""

    live_trace_bytes: int = 256 << 20
    wal_head_bytes: int = 512 << 20
    inflight_push_bytes: int = 64 << 20
    # must fit SEVERAL queries at their resident ceiling (frontend
    # charges min(est, query_shards x target_bytes_per_job) ≈ 400 MiB
    # with default frontend config) or large-query concurrency
    # collapses to one process-wide
    inflight_query_bytes: int = 2 << 30
    rss_limit_bytes: int = 0
    soft_watermark: float = 0.75
    hard_watermark: float = 0.95
    rss_sample_period_s: float = 1.0
    shed_retry_after_s: float = 1.0


_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def sample_rss_bytes(pid: int | str = "self") -> int:
    """Current RSS from /proc/<pid>/statm (field 2, pages); 0 when the
    platform has no procfs — RSS watermarks simply stay inert there.
    Also used by the loadtest rig to watch its cluster's processes."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


class ResourceGovernor:
    """The process view: pools + RSS -> level, consulted everywhere."""

    def __init__(self, cfg: ResourceConfig | None = None):
        self.cfg = cfg or ResourceConfig()
        self._lock = threading.Lock()
        self.pools: dict[str, Pool] = {}
        self._rss = 0
        self._rss_at = 0.0
        self.configure(self.cfg)

    # ------------------------------------------------------------------
    def configure(self, cfg: ResourceConfig) -> None:
        """(Re)apply budgets. Existing Pool objects are kept — modules
        hold references — only their limits move."""
        self.cfg = cfg
        limits = {
            "live_traces": cfg.live_trace_bytes,
            "wal_head": cfg.wal_head_bytes,
            "inflight_push": cfg.inflight_push_bytes,
            "inflight_query": cfg.inflight_query_bytes,
        }
        with self._lock:
            for name, limit in limits.items():
                pool = self.pools.get(name)
                if pool is None:
                    self.pools[name] = Pool(name, limit)
                else:
                    pool.limit = int(limit)

    def pool(self, name: str) -> Pool:
        with self._lock:
            p = self.pools.get(name)
            if p is None:
                p = Pool(name, 0)
                self.pools[name] = p
            return p

    # ------------------------------------------------------------------
    def rss_bytes(self) -> int:
        now = time.monotonic()
        with self._lock:
            if now - self._rss_at < self.cfg.rss_sample_period_s and self._rss_at:
                return self._rss
        rss = sample_rss_bytes()
        with self._lock:
            self._rss = rss
            self._rss_at = now
        return rss

    def _worst_fraction(self) -> float:
        frac = 0.0
        for name in PRESSURE_POOLS:
            p = self.pools.get(name)
            if p is not None:
                frac = max(frac, p.fraction())
        if self.cfg.rss_limit_bytes:
            frac = max(frac, self.rss_bytes() / self.cfg.rss_limit_bytes)
        return frac

    def level(self) -> int:
        frac = self._worst_fraction()
        if frac >= self.cfg.hard_watermark:
            return LEVEL_CRITICAL
        if frac >= self.cfg.soft_watermark:
            return LEVEL_PRESSURE
        return LEVEL_OK

    def level_name(self) -> str:
        return LEVEL_NAMES[self.level()]

    def retry_after_s(self) -> float:
        """Hint for shed responses: deeper overload -> longer backoff, so
        a synchronized client herd spreads out instead of returning in
        one wave."""
        base = self.cfg.shed_retry_after_s
        frac = self._worst_fraction()
        if frac >= self.cfg.hard_watermark:
            return base * 4
        if frac >= self.cfg.soft_watermark:
            return base * 2
        return base

    def check_critical(self, component: str, what: str) -> None:
        """Raise ResourceExhausted at the hard watermark (the ingester's
        refuse-pushes gate). Counted per component."""
        if self.level() >= LEVEL_CRITICAL:
            shed_total.inc(component=component, reason="critical_pressure")
            raise ResourceExhausted(
                f"{component}: refusing {what} at critical memory pressure "
                f"(pools: {self.describe()})",
                retry_after_s=self.retry_after_s(),
            )

    def describe(self) -> str:
        parts = []
        for name in sorted(self.pools):
            p = self.pools[name]
            parts.append(f"{name}={p.used}/{p.limit or 'inf'}")
        if self.cfg.rss_limit_bytes:
            parts.append(f"rss={self._rss}/{self.cfg.rss_limit_bytes}")
        return " ".join(parts)


_shared: ResourceGovernor | None = None
_shared_lock = threading.Lock()


def governor() -> ResourceGovernor:
    """The process-wide governor (created on first use; reconfigured by
    App startup via configure())."""
    global _shared
    if _shared is None:
        with _shared_lock:
            if _shared is None:
                _shared = ResourceGovernor()
                _register_metrics(_shared)
    return _shared


def configure(cfg: ResourceConfig) -> ResourceGovernor:
    gov = governor()
    gov.configure(cfg)
    return gov


def _register_metrics(gov: ResourceGovernor) -> None:
    def collect():
        pressure_level_gauge.set(gov.level())
        rss_gauge.set(gov.rss_bytes())
        with gov._lock:
            pools = list(gov.pools.values())
        for p in pools:
            pool_bytes_gauge.set(p.used, pool=p.name)
            pool_limit_gauge.set(p.limit, pool=p.name)

    metrics.register_collector(collect)
