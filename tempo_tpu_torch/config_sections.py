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
modules/forwarder.ForwarderConfig and usagestats.UsageStatsConfig.
(`metrics_generator.remote_write:` is the ported
modules/generator/storage.RemoteWriteConfig.)
"""

from __future__ import annotations

from dataclasses import dataclass


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
class UsageStatsConfig:
    enabled: bool = False
    endpoint: str = ""
    path: str = "/usage-stats"
    report_interval_s: float = 4 * 3600.0
    timeout_s: float = 10.0
