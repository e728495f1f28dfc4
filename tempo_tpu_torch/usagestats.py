"""Port of tempo_tpu/usagestats.py, copied as is (host code).

Anonymous usage statistics reporting.

Reference: pkg/usagestats — a cluster seed (random UID) is kept in the
object store so every process in the cluster reports under one identity
(seed.go:23), and a reporter ships a JSON snapshot of registered stats
every 4h (reporter.go:54). Reports carry feature/scale data only, never
tenant data. Disabled unless an endpoint is configured.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field

from tempo_tpu_torch.backend.base import NotFound

log = logging.getLogger(__name__)

SEED_KEY = "tempo_cluster_seed.json"
_SEED_KEYPATH = ()  # root of the store, beside tenants (reference keeps it at bucket root)


def get_or_create_cluster_seed(raw_backend) -> dict:
    """Idempotent seed bootstrap (reference: seed.go leader-writes then
    memberlist-merges; object-store last-writer-wins is equivalent for
    a seed whose only job is to be stable afterwards)."""
    try:
        return json.loads(raw_backend.read(SEED_KEY, _SEED_KEYPATH))
    except NotFound:
        seed = {"UID": str(uuid.uuid4()), "created_at": time.time()}
        raw_backend.write(SEED_KEY, _SEED_KEYPATH, json.dumps(seed).encode())
        # re-read: if two processes raced, both settle on whatever landed
        try:
            return json.loads(raw_backend.read(SEED_KEY, _SEED_KEYPATH))
        except NotFound:
            return seed


@dataclass
class UsageStatsConfig:
    enabled: bool = False
    endpoint: str = ""  # stats sink URL
    path: str = "/usage-stats"
    report_interval_s: float = 4 * 3600.0
    timeout_s: float = 10.0


class Reporter:
    def __init__(self, cfg: UsageStatsConfig, raw_backend, version: str = "dev"):
        self.cfg = cfg
        self.raw = raw_backend
        self.version = version
        self._edge: dict[str, float] = {}
        self._extra: dict = {}
        self._providers: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._client = None
        self.seed = None

    def set_stat(self, name: str, value) -> None:
        """Typed stat registry entry (reference: stats.go Edge/Target)."""
        with self._lock:
            self._extra[name] = value

    def register_provider(self, fn) -> None:
        """fn() -> dict of stats merged into every report at build time
        (the app registers storage-scale facts this way). Providers must
        return feature/scale data ONLY — never tenant names; a raising
        provider is skipped, never fatal (stats must not break the app)."""
        with self._lock:
            self._providers.append(fn)

    def build_report(self, now: float | None = None) -> dict:
        if self.seed is None:
            self.seed = get_or_create_cluster_seed(self.raw)
        from tempo_tpu_torch.util import metrics

        now = now or time.time()
        with self._lock:
            extra = dict(self._extra)
            providers = list(self._providers)
        for fn in providers:
            try:
                extra.update(fn() or {})
            except Exception as e:  # noqa: BLE001 — see register_provider
                log.debug("usage-stats provider failed: %s", e)
        return {
            "clusterID": self.seed["UID"],
            "createdAt": self.seed["created_at"],
            "interval": self.cfg.report_interval_s,
            "target": "all",
            "version": self.version,
            "os": "linux",
            "metrics": {**metrics.snapshot_totals(), **extra},
            "timestamp": now,
        }

    def send_report(self) -> bool:
        if not self.cfg.enabled or not self.cfg.endpoint:
            return False
        from tempo_tpu_torch.backend.httpclient import PooledHTTPClient

        try:
            if self._client is None:
                self._client = PooledHTTPClient(self.cfg.endpoint, self.cfg.timeout_s)
            # build_report may touch the object store (seed bootstrap) —
            # it must not be able to kill the reporter loop either
            body = json.dumps(self.build_report()).encode()
            self._client.request(
                "POST",
                self.cfg.path,
                headers={"Content-Type": "application/json"},
                body=body,
                ok=(200, 201, 202, 204),
            )
            return True
        except Exception as e:  # noqa: BLE001 — stats must never break the app
            log.debug("usage-stats report failed: %s", e)
            return False

    def start_loop(self) -> None:
        if not self.cfg.enabled:
            return

        def run():
            while not self._stop.wait(self.cfg.report_interval_s):
                self.send_report()

        self._thread = threading.Thread(target=run, daemon=True, name="usage-stats")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None
