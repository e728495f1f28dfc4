"""Port of tempo_tpu/modules/netkv.py (host code).

Networked ring KV: revisioned CAS + long-poll watch over HTTP.

Reference: dskit's memberlist KV shared by every ring
(cmd/tempo/app/modules.go:297-325), with consul/etcd as the e2e-tested
alternatives. This build uses a KV *service* rather than gossip: any
role can serve a revisioned compare-and-swap store on its existing HTTP
listener (/kv/v1/<name>), and every other role points its rings at it —
the consul/etcd topology without an external dependency, so the shipped
k8s/compose manifests form a ring across nodes with no shared volume.

Three pieces:
- KVService — the in-process store (revision counter + condition
  variable for watches); served by api/server.py.
- LocalKV — KVStore adapter for the process that serves the KV (its
  rings hit the store directly; no HTTP to self at startup).
- HttpKV — KVStore adapter for every other process: update() is a
  read-CAS-retry loop; get() returns a cache kept fresh by a background
  long-poll watch thread, so the hot ingest path (a ring snapshot per
  push) never blocks on the network.
"""

from __future__ import annotations

import copy
import json
import logging
import threading
import time
import urllib.error
import urllib.request

from tempo_tpu_torch.modules.ring import KVStore

log = logging.getLogger(__name__)

KV_PATH_PREFIX = "/kv/v1/"


class KVService:
    """Revisioned multi-name KV with CAS and blocking watch."""

    def __init__(self):
        self._cond = threading.Condition()
        self._stores: dict[str, tuple[int, dict]] = {}  # name -> (rev, data)

    def read(self, name: str, wait_revision: int | None = None,
             timeout_s: float = 0.0) -> tuple[int, dict]:
        """Current (revision, data); with wait_revision, block until the
        revision exceeds it (long-poll watch) or timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while wait_revision is not None:
                rev, _ = self._stores.get(name, (0, {}))
                if rev > wait_revision:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            rev, data = self._stores.get(name, (0, {}))
            return rev, copy.deepcopy(data)

    def names(self) -> list[str]:
        """Existing store names (membership debug page)."""
        with self._cond:
            return sorted(self._stores)

    def summary(self) -> dict:
        """{name: {revision, keys}} in one lock acquisition, without
        copying the values (the /memberlist debug page needs names
        only — ring stores carry every instance's token lists)."""
        with self._cond:
            return {
                name: {"revision": rev, "keys": sorted(data)}
                for name, (rev, data) in sorted(self._stores.items())
            }

    def cas(self, name: str, revision: int, data: dict) -> tuple[bool, int]:
        """Store data if revision matches; returns (ok, current revision)."""
        with self._cond:
            cur, _ = self._stores.get(name, (0, {}))
            if revision != cur:
                return False, cur
            self._stores[name] = (cur + 1, copy.deepcopy(data))
            self._cond.notify_all()
            return True, cur + 1


class LocalKV(KVStore):
    """Ring KV for the process that serves the KVService itself."""

    def __init__(self, service: KVService, name: str):
        self.service = service
        self.name = name

    def get(self) -> dict:
        return self.service.read(self.name)[1]

    def update(self, mutate):
        while True:
            rev, data = self.service.read(self.name)
            new = mutate(data)
            ok, _ = self.service.cas(self.name, rev, new)
            if ok:
                return new


class HttpKV(KVStore):
    """Ring KV client against a role serving /kv/v1/<name>.

    connect_grace_s covers startup ordering: the KV-serving role may
    come up seconds after this one, so early reads/updates retry
    connection errors instead of failing the whole process.
    """

    def __init__(self, base_url: str, name: str, connect_grace_s: float = 30.0,
                 watch: bool = True, timeout_s: float = 10.0):
        self.base = base_url.rstrip("/") + KV_PATH_PREFIX + name
        self.connect_grace_s = connect_grace_s
        self.timeout_s = timeout_s
        self._watch_enabled = watch
        self._lock = threading.Lock()
        self._cache: tuple[int, dict] | None = None
        self._watcher: threading.Thread | None = None
        self._stop = threading.Event()

    # -- http ----------------------------------------------------------
    def _fetch(self, wait_revision: int | None = None,
               timeout_s: float | None = None) -> tuple[int, dict]:
        url = self.base
        if wait_revision is not None:
            url += f"?wait_revision={wait_revision}&timeout={timeout_s or 25}"
        req_timeout = (timeout_s or 25) + 5 if wait_revision is not None else self.timeout_s
        with urllib.request.urlopen(url, timeout=req_timeout) as r:
            doc = json.loads(r.read())
        return int(doc["revision"]), doc["data"]

    def _fetch_with_grace(self) -> tuple[int, dict]:
        deadline = time.monotonic() + self.connect_grace_s
        while True:
            try:
                return self._fetch()
            except (urllib.error.URLError, OSError, TimeoutError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)

    # -- KVStore -------------------------------------------------------
    def get(self) -> dict:
        if not self._watch_enabled:
            # no watcher keeping the cache fresh -> always read through
            return self._fetch_with_grace()[1]
        with self._lock:
            cached = self._cache
        if cached is None:
            rev, data = self._fetch_with_grace()
            with self._lock:
                self._cache = (rev, data)
            self._ensure_watcher()
            return copy.deepcopy(data)
        return copy.deepcopy(cached[1])

    def update(self, mutate):
        deadline = time.monotonic() + self.connect_grace_s
        while True:
            try:
                rev, data = self._fetch()
                new = mutate(data)
                body = json.dumps({"revision": rev, "data": new}).encode()
                req = urllib.request.Request(self.base, data=body, method="POST",
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    json.loads(r.read())
                with self._lock:
                    # monotonic like the watcher: never clobber a newer
                    # revision the watch thread stored concurrently
                    if self._cache is None or self._cache[0] < rev + 1:
                        self._cache = (rev + 1, new)
                self._ensure_watcher()
                return new
            except urllib.error.HTTPError as e:
                if e.code == 409:  # CAS lost: re-read and retry
                    continue
                raise
            except (urllib.error.URLError, OSError, TimeoutError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)

    # -- watch ---------------------------------------------------------
    def _ensure_watcher(self):
        if not self._watch_enabled or self._watcher is not None:
            return
        with self._lock:
            if self._watcher is not None:
                return
            t = threading.Thread(target=self._watch_loop, daemon=True,
                                 name=f"kv-watch-{self.base.rsplit('/', 1)[-1]}")
            self._watcher = t
        t.start()

    def _watch_loop(self):
        while not self._stop.is_set():
            with self._lock:
                rev = self._cache[0] if self._cache else 0
            try:
                new_rev, data = self._fetch(wait_revision=rev)
                with self._lock:
                    if self._cache is None or new_rev > self._cache[0]:
                        self._cache = (new_rev, data)
            except (urllib.error.URLError, OSError, TimeoutError, ValueError):
                # server briefly away: keep serving the stale cache (ring
                # health degrades via heartbeats, not KV reachability)
                if self._stop.wait(1.0):
                    return

    def close(self):
        self._stop.set()
