"""The device tier's config section, kept apart from its module.

`device_tier:` is served on the App's device with its ingest-tail share;
its dataclass lives here so that config.py and app.py can read it
without importing the column cache. Every default is the reference's.

Copy of: encoding/vtpu/colcache.DeviceTierConfig.
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
