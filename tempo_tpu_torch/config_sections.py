"""Config sections of modules the port does not carry yet.

The port reads the same YAML into the same dataclasses as tempo_tpu
(config.py), so every section keeps every field of the reference. The
modules behind these sections wait for later slices; App raises
NotImplementedError, naming the ROADMAP item, when one is switched on.
Every default is the reference's. (`standing:` is the ported engine's
own StandingConfig, in tempo_tpu_torch/standing/engine.py, and
`rca:`, `slo:`, `vulture:` and `storage.trace.result_cache:` are their
ported modules' own; `device_tier:` is served, with its ingest-tail
share.)

Copies of: encoding/vtpu/colcache.DeviceTierConfig,
modules/forwarder.ForwarderConfig, modules/generator/storage.
RemoteWriteConfig and usagestats.UsageStatsConfig.
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
class UsageStatsConfig:
    enabled: bool = False
    endpoint: str = ""
    path: str = "/usage-stats"
    report_interval_s: float = 4 * 3600.0
    timeout_s: float = 10.0
