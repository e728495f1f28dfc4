"""Port of tempo_tpu/modules/overrides.py, copied as is (host code).

Per-tenant limits with hot-reloadable overrides.

Reference: modules/overrides (overrides.go:44-95 runtimeconfig poller,
limits.go:49-91 knobs). Defaults come from config; a per-tenant
overrides file (JSON or YAML-subset) is re-read when its mtime changes,
mirroring dskit runtimeconfig's file poller. Unknown keys are rejected
at load so typos fail loudly (the reference's strict YAML option).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading

import yaml

from dataclasses import dataclass, field

log = logging.getLogger(__name__)


@dataclass
class Limits:
    # ingestion (distributor)
    ingestion_rate_limit_bytes: int = 15 * 1024 * 1024
    ingestion_burst_size_bytes: int = 20 * 1024 * 1024
    ingestion_rate_strategy: str = "local"  # local | global
    max_traces_per_user: int = 10_000
    max_bytes_per_trace: int = 5 * 1024 * 1024
    max_spans_per_trace: int = 50_000  # span-count analog of bytes cap
    # query
    max_bytes_per_tag_values_query: int = 5 * 1024 * 1024
    max_search_duration_s: int = 0  # 0 = unlimited
    max_queriers_per_tenant: int = 0  # query shuffle-sharding
    # admission: concurrent queries this tenant may hold in the frontend
    # (0 = inherit FrontendConfig.max_concurrent_queries; the excess is
    # shed with 429 + Retry-After, not queued)
    max_concurrent_queries: int = 0
    # graceful degradation: fraction of a query's shards allowed to fail
    # terminally before the whole query fails — within budget the
    # frontend returns status="partial" with a failed-shard count.
    # -1 = inherit the frontend default (FrontendConfig.
    # max_failed_shard_fraction); 0 = any terminal shard failure fails
    # the query (strict completeness)
    query_partial_shard_fraction: float = -1.0
    # standing queries: registrations this tenant may hold (0 = inherit
    # standing.max_queries_per_tenant; each registration is evaluated on
    # every ingest cut, so the cap bounds per-cut fold work)
    max_standing_queries: int = 0
    # storage
    block_retention_s: int = 0  # 0 = fall back to engine default
    # generator
    metrics_generator_processors: tuple = ()
    metrics_generator_max_active_series: int = 0
    metrics_generator_ring_size: int = 0
    # forwarders
    forwarders: tuple = ()


_KNOWN = {f.name for f in dataclasses.fields(Limits)}


class Overrides:
    def __init__(self, defaults: Limits | None = None, overrides_path: str | None = None,
                 reload_period_s: float = 10.0):
        self.defaults = defaults or Limits()
        self.path = overrides_path
        self.reload_period_s = reload_period_s
        self._lock = threading.Lock()
        self._per_tenant: dict[str, Limits] = {}
        self._mtime = 0.0
        if self.path:
            self._load(force=True)

    # ------------------------------------------------------------------
    def _load(self, force: bool = False) -> None:
        if not self.path or not os.path.exists(self.path):
            return
        mtime = os.path.getmtime(self.path)
        if not force and mtime == self._mtime:
            return
        try:
            with open(self.path) as f:
                # YAML like the reference's runtimeconfig overrides file
                # (JSON files keep working: JSON is a YAML subset)
                doc = yaml.safe_load(f) or {}
            per_tenant = {}
            # empty `overrides:` key / tenant block parse as None in YAML
            for tenant, knobs in (doc.get("overrides") or {}).items():
                knobs = knobs or {}
                unknown = set(knobs) - _KNOWN
                if unknown:
                    raise ValueError(f"tenant {tenant}: unknown limit keys {sorted(unknown)}")
                base = dataclasses.asdict(self.defaults)
                base.update(knobs)
                base = {k: tuple(v) if isinstance(v, list) else v for k, v in base.items()}
                per_tenant[tenant] = Limits(**base)
            with self._lock:
                self._per_tenant = per_tenant
                self._mtime = mtime
            log.info("overrides: loaded %d tenant override(s)", len(per_tenant))
        except Exception:
            # keep serving the previous good config (runtimeconfig behavior)
            log.exception("overrides: reload failed; keeping previous values")

    def maybe_reload(self) -> None:
        self._load()

    # ------------------------------------------------------------------
    def for_tenant(self, tenant: str) -> Limits:
        with self._lock:
            return self._per_tenant.get(tenant, self.defaults)

    def ingestion_rate_bytes(self, tenant: str, ring_size: int = 1) -> float:
        """Global strategy divides the rate across distributors
        (reference: modules/distributor rate strategy)."""
        lim = self.for_tenant(tenant)
        rate = lim.ingestion_rate_limit_bytes
        if lim.ingestion_rate_strategy == "global" and ring_size > 1:
            rate = rate / ring_size
        return rate

    def tenants_with_overrides(self) -> list[str]:
        with self._lock:
            return sorted(self._per_tenant)
