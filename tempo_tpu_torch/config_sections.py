"""Config sections of modules the port does not carry yet.

The port reads the same YAML into the same dataclasses as tempo_tpu
(config.py), so every section keeps every field of the reference. The
modules behind these sections wait for later slices; App raises
NotImplementedError, naming the ROADMAP item, when one is switched on.
Every default is the reference's. (`standing:` is the ported engine's
own StandingConfig, in tempo_tpu_torch/standing/engine.py;
`device_tier:` is served, with its ingest-tail share.)

Copies of: encoding/vtpu/colcache.DeviceTierConfig,
modules/forwarder.ForwarderConfig, modules/generator/storage.
RemoteWriteConfig, rca/engine.RCAConfig,
usagestats.UsageStatsConfig, util/slo.SLOObjective + SLOConfig,
vulture.VultureConfig and
resultcache.ResultCacheConfig.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DeviceTierConfig:
    """`device_tier:` — the device-resident hot tier; budget_mb=0 (the
    reference's default too) disables it."""

    budget_mb: int = 0
    ingest_tail_budget_mb: int = 0
    admit_min_ships: int = 2
    refresh_s: float = 30.0
    respect_governor: bool = True
    max_query_batch: int = 8


@dataclass
class ForwarderConfig:
    name: str = ""
    backend: str = "otlphttp"
    endpoint: str = ""
    path: str = "/v1/traces"
    queue_size: int = 256
    workers: int = 1
    timeout_s: float = 10.0


@dataclass
class RemoteWriteConfig:
    endpoint: str = ""
    path: str = "/api/v1/write"
    headers: dict = field(default_factory=dict)
    wal_dir: str = ""
    send_interval_s: float = 15.0
    max_retries: int = 3
    timeout_s: float = 10.0
    max_wal_bytes: int = 64 << 20


@dataclass
class RCAConfig:
    """`rca:` — the auto-RCA incident engine."""

    enabled: bool = False
    max_incidents: int = 64
    cooldown_s: float = 300.0
    window_s: float = 600.0
    walks: int = 64
    walk_steps: int = 6
    walk_seed: int = 0
    insights_limit: int = 20
    queue_max: int = 16


@dataclass
class UsageStatsConfig:
    enabled: bool = False
    endpoint: str = ""
    path: str = "/usage-stats"
    report_interval_s: float = 4 * 3600.0
    timeout_s: float = 10.0


@dataclass
class SLOObjective:
    name: str
    sli: str
    objective: float = 0.999
    threshold_s: float = 0.0


@dataclass
class SLOConfig:
    """`slo:` — the burn-rate SLO engine."""

    enabled: bool = False
    eval_interval_s: float = 15.0
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    objectives: list = field(default_factory=list)


@dataclass
class VultureConfig:
    """`vulture:` — the continuous-verification prober."""

    enabled: bool = False
    target: str = ""
    query_target: str = ""
    tenant: str = "single-tenant"
    write_backoff_s: int = 10
    read_backoff_s: int = 10
    search_backoff_s: int = 30
    metrics_backoff_s: int = 60
    retention_s: int = 14400
    recent_min_age_s: int = 60
    aged_min_age_s: int = 5400
    freshness_slo_s: float = 10.0
    metrics_step_s: int = 5
    handoff_grace_s: float = 0.0


@dataclass
class ResultCacheConfig:
    """`storage.trace.result_cache:` — the shard-partial result cache."""

    enabled: bool = False
    max_bytes: int = 64 << 20
    negative: bool = True
