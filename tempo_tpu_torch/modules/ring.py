"""Port of tempo_tpu/modules/ring.py (host code): the ring with the
generator's shuffle sharding, over MemoryKV (target=all), FileKV (the
one-host KV of microservices mode: a cross-process flock around each
read-modify-write and an atomic rewrite) or modules/netkv's HttpKV and
LocalKV.

Consistent-hash ring + membership.

Reference: vendored dskit ring (SURVEY.md section 2.8 P1) — instances
own random tokens on a uint32 ring; a trace's token (hash of tenant +
trace ID) walks clockwise to find its replication set; heartbeats gate
health. The reference gossips ring state via memberlist; here the
KV store is pluggable: in-memory for single-binary / tests, a
file-backed store for multi-process on one host (the e2e pattern), and
any networked KV can implement the same 3-method interface.
"""

from __future__ import annotations

import bisect
import fcntl
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field

ACTIVE = "ACTIVE"
LEAVING = "LEAVING"
UNHEALTHY = "UNHEALTHY"


@dataclass
class InstanceDesc:
    instance_id: str
    addr: str = ""
    tokens: list = field(default_factory=list)
    state: str = ACTIVE
    heartbeat: float = 0.0
    zone: str = ""  # failure domain for zone-aware replication

    def healthy(self, timeout_s: float, now: float) -> bool:
        return self.state == ACTIVE and (timeout_s <= 0 or now - self.heartbeat <= timeout_s)


class KVStore:
    """Ring state store: get/cas semantics like dskit kv."""

    def get(self) -> dict:
        raise NotImplementedError

    def update(self, mutate) -> dict:
        """Atomically apply mutate(dict) -> dict and persist."""
        raise NotImplementedError


class MemoryKV(KVStore):
    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict = {}

    def get(self):
        with self._lock:
            return json.loads(json.dumps(self._data)) if self._data else {}

    def update(self, mutate):
        with self._lock:
            self._data = mutate(json.loads(json.dumps(self._data)) if self._data else {})
            return self._data


class FileKV(KVStore):
    """Shared-file ring state for multi-process single-host clusters
    (the reference's e2e topology without docker)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def get(self):
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def update(self, mutate):
        # cross-process flock around the read-modify-write: without it two
        # processes registering concurrently each write a state containing
        # only themselves and the last writer wins
        with self._lock:
            lockpath = f"{self.path}.lock"
            with open(lockpath, "w") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                try:
                    cur = self.get()
                    new = mutate(cur)
                    tmp = f"{self.path}.tmp.{os.getpid()}"
                    with open(tmp, "w") as f:
                        json.dump(new, f)
                    os.replace(tmp, self.path)
                    return new
                finally:
                    fcntl.flock(lockf, fcntl.LOCK_UN)


NUM_TOKENS = 128


class _JoiningStopEvent(threading.Event):
    """Stop event that joins its loop thread on set(), so a mid-flight
    heartbeat can't re-register an instance after unregister runs."""

    _thread: threading.Thread | None = None

    def set(self) -> None:
        super().set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=15)


class Ring:
    def __init__(self, kv: KVStore, heartbeat_timeout_s: float = 60.0,
                 replication_factor: int = 1, zone_awareness: bool = False):
        self.kv = kv
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.replication_factor = replication_factor
        # spread each replica set across distinct zones (reference:
        # dskit ring zone-awareness) — one replica per zone until every
        # zone is used, then fall back to distinct instances
        self.zone_awareness = zone_awareness
        self._unregistered: set[str] = set()
        self._reg_params: dict[str, dict] = {}

    # -- membership (Lifecycler role) -----------------------------------
    def register(self, instance_id: str, addr: str = "", n_tokens: int = NUM_TOKENS,
                 seed: int | None = None, zone: str = "") -> None:
        self._unregistered.discard(instance_id)
        # stash params so lost-registration recovery replays them verbatim
        self._reg_params[instance_id] = {
            "addr": addr, "n_tokens": n_tokens, "seed": seed, "zone": zone,
        }
        rng = random.Random(seed if seed is not None else instance_id)
        tokens = sorted(rng.randrange(0, 2**32) for _ in range(n_tokens))

        def mutate(state):
            state[instance_id] = {
                "addr": addr,
                "tokens": tokens,
                "state": ACTIVE,
                "heartbeat": time.time(),
                "zone": zone,
            }
            return state

        self.kv.update(mutate)

    def heartbeat(self, instance_id: str) -> None:
        def mutate(state):
            if instance_id in state:
                state[instance_id]["heartbeat"] = time.time()
            else:
                # lost registration (e.g. ring state wiped or raced away):
                # re-register rather than silently stay absent forever —
                # unless this process explicitly unregistered it
                missing.append(instance_id)
            return state

        missing: list[str] = []
        self.kv.update(mutate)
        if missing and instance_id not in self._unregistered:
            self.register(instance_id, **self._reg_params.get(instance_id, {}))

    def set_state(self, instance_id: str, st: str) -> None:
        def mutate(state):
            if instance_id in state:
                state[instance_id]["state"] = st
            return state

        self.kv.update(mutate)

    def unregister(self, instance_id: str) -> None:
        self._unregistered.add(instance_id)
        def mutate(state):
            state.pop(instance_id, None)
            return state

        self.kv.update(mutate)

    # -- reads ----------------------------------------------------------
    def instances(self) -> list[InstanceDesc]:
        now = time.time()
        out = []
        for iid, d in self.kv.get().items():
            out.append(
                InstanceDesc(
                    instance_id=iid,
                    addr=d.get("addr", ""),
                    tokens=d.get("tokens", []),
                    state=d.get("state", ACTIVE),
                    heartbeat=d.get("heartbeat", 0.0),
                    zone=d.get("zone", ""),
                )
            )
        return out

    def healthy_instances(self) -> list[InstanceDesc]:
        now = time.time()
        return [i for i in self.instances() if i.healthy(self.heartbeat_timeout_s, now)]

    def snapshot(self) -> "RingSnapshot":
        """One consistent view for a batch of lookups — the hot ingest
        path takes one snapshot per push instead of re-reading and
        re-sorting the ring per trace."""
        return RingSnapshot(self.healthy_instances(), self.replication_factor,
                            self.zone_awareness)

    def get_replicas(self, token: int) -> list[InstanceDesc]:
        """Replication set for a token: walk clockwise collecting RF
        distinct healthy instances (reference: ring.Get with Write op)."""
        return self.snapshot().get_replicas(token)

    def start_heartbeat(self, instance_id: str, period_s: float = 10.0) -> threading.Event:
        """Background heartbeat for a registered instance; returns the
        stop event. Without this, the instance ages out of the healthy
        set after heartbeat_timeout_s (reference: dskit Lifecycler's
        heartbeat loop)."""
        stop = _JoiningStopEvent()

        def loop():
            while not stop.wait(period_s):
                try:
                    self.heartbeat(instance_id)
                except Exception:
                    pass

        t = threading.Thread(target=loop, daemon=True, name=f"heartbeat-{instance_id}")
        stop._thread = t
        t.start()
        return stop

    def shuffle_shard(self, key: str, size: int) -> list[InstanceDesc]:
        """Deterministic per-tenant subset (reference: generator shuffle-
        sharding, modules/distributor/distributor.go:447)."""
        healthy = sorted(self.healthy_instances(), key=lambda i: i.instance_id)
        if size <= 0 or size >= len(healthy):
            return healthy
        rng = random.Random(key)
        return sorted(rng.sample(healthy, size), key=lambda i: i.instance_id)

    def owns(self, instance_id: str, job_hash: int) -> bool:
        """Work-sharding ownership: does instance own this job token?
        (reference: modules/compactor/compactor.go:189-217)."""
        replicas = self.get_replicas(job_hash % (2**32))
        return bool(replicas) and replicas[0].instance_id == instance_id


class RingSnapshot:
    """Immutable sorted token ring for repeated lookups."""

    def __init__(self, instances: list[InstanceDesc], replication_factor: int,
                 zone_awareness: bool = False):
        self.replication_factor = replication_factor
        self.zone_awareness = zone_awareness
        self._instances = {i.instance_id: i for i in instances}
        self._n_zones = len({i.zone for i in instances})
        points = []
        for inst in instances:
            for t in inst.tokens:
                points.append((t, inst.instance_id))
        points.sort()
        self._points = points
        self._tokens = [t for t, _ in points]

    def get_replicas(self, token: int) -> list[InstanceDesc]:
        """Walk clockwise collecting RF distinct healthy instances
        (reference: ring.Get with Write op). With zone awareness, an
        instance whose zone is already represented is skipped until
        every zone holds a replica; only then (RF > zones) does the walk
        fall back to distinct instances regardless of zone — dskit's
        spread-then-overflow behavior."""
        if not self._points:
            return []
        out, seen, seen_zones = [], set(), set()
        idx = bisect.bisect_right(self._tokens, token) % len(self._points)
        for step in range(len(self._points)):
            _, iid = self._points[(idx + step) % len(self._points)]
            if iid in seen:
                continue
            inst = self._instances[iid]
            if (self.zone_awareness and inst.zone in seen_zones
                    and len(seen_zones) < self._n_zones):
                continue
            seen.add(iid)
            seen_zones.add(inst.zone)
            out.append(inst)
            if len(out) >= self.replication_factor:
                break
        return out
