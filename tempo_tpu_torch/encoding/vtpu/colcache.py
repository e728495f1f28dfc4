"""Process-wide column caches: host tier (decoded arrays) + device tier
(COMPRESSED pages resident in the card's memory).

Port of tempo_tpu/encoding/vtpu/colcache.py: `ColumnCache`,
`shared_cache` and `_register_metrics` on the host; `DeviceTier`,
`configure_device_tier`, `shared_device_tier`, `hbm_headroom_bytes` and
`device_tier_report` for the device tier, whose residents are torch
tensors on the tier's device (the App's: cuda unless it runs on the
CPU).

Reference analog: the reference caches parquet footers/column pages
across queries (vparquet/readers.go over tempodb/backend/cache). Here
the unit is a DECODED column chunk: repeated queries against a hot block
skip the ranged read AND the codec, not just the bytes.

Keys are (block_id, column name, page offset): blocks are immutable and
content lives at fixed offsets, so entries never need invalidation —
deletion just stops producing hits and the LRU ages the dead entries
out. The column name is part of the key because zero-byte pages (empty
columns) share one offset with their neighbors and would otherwise
alias across columns.
Cached arrays are marked read-only; every consumer treats SpanBatch
columns as immutable by convention, and the flag turns a future
violation into a loud error instead of silent cross-query corruption.

Sizing: TEMPO_TPU_COLCACHE_MB (default 256; 0 disables), as in the
reference. One shared instance serves every block of the process.

The DEVICE tier (`DeviceTier`, sized by TEMPO_TPU_DEVICE_TIER_MB or the
`device_tier` config section; 0 = off, the reference's default too)
closes the transfer-ledger loop: the hottest (block, column) pages — in
their ENCODED run/dict/packed form, 10-50x smaller than decoded rows —
are admitted as device tensors at the knee of the ghost-LRU what-if
curve (util/pageheat.admission_*), so repeat queries skip
fetch+decode+h2d and run the device decode fused into the scan (the
resident kernels of ops/scan). Eviction rides the governor's pressure
levels, MORE aggressively than the host tier: at PRESSURE the device
tier drops to a quarter (host halves), at CRITICAL it sheds completely
(host keeps an eighth) — device memory yields first, host cache second,
and only then does ingest refuse. The ingest tail's half of the tier
(`park_tail`) is here, but nothing parks a tail until ops/ingest_tail is
ported (ROADMAP Queue 1 item 4b).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from tempo_tpu_torch.config_sections import DeviceTierConfig
from tempo_tpu_torch.ops.scan import page_row
from tempo_tpu_torch.util import usage


class ColumnCache:
    """Bytes-bounded, thread-safe LRU of numpy arrays.

    Pressure-aware: the effective capacity shrinks with the process
    pressure level (util/resource) — half at PRESSURE, an eighth at
    CRITICAL — so cached decode results yield memory to live ingest
    instead of competing with it, and grow back automatically when the
    pressure clears. The level is consulted on put (the only growth
    path), never on get."""

    _PRESSURE_FACTORS = {0: 1.0, 1: 0.5, 2: 0.125}

    def __init__(self, max_bytes: int, governor=None):
        self.max_bytes = max_bytes
        self._governor = governor  # None = process governor, bound lazily
        self._lru: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def effective_max_bytes(self) -> int:
        gov = self._governor
        if gov is None:
            from tempo_tpu_torch.util import resource

            gov = self._governor = resource.governor()
        return int(self.max_bytes * self._PRESSURE_FACTORS.get(gov.level(), 1.0))

    def get(self, key):
        with self._lock:
            arr = self._lru.get(key)
            if arr is not None:
                self._lru.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        # cost plane: hit/miss charged to the requesting tenant's vector
        # (outside the lock — charge takes the vector's own lock)
        usage.charge("cache_hits" if arr is not None else "cache_misses")
        return arr

    def put(self, key, arr) -> None:
        try:
            arr.setflags(write=False)
        except ValueError:  # non-owned buffer already read-only
            pass
        limit = self.effective_max_bytes()
        with self._lock:
            prev = self._lru.get(key)
            if prev is not None:
                # racing loaders of the same miss: replace, don't
                # double-count (an unconditional += ratchets _bytes up
                # and shrinks effective capacity toward zero)
                self._bytes -= prev.nbytes
            self._lru[key] = arr
            self._bytes += arr.nbytes
            while self._bytes > limit and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self._bytes -= evicted.nbytes
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "tier": "host",
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bytes": self._bytes,
                "entries": len(self._lru),
                "max_bytes": self.max_bytes,
                "effective_max_bytes": self.effective_max_bytes(),
            }

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._bytes = 0


_shared: ColumnCache | None = None
_shared_lock = threading.Lock()


def shared_cache() -> ColumnCache | None:
    """The process-wide cache, or None when disabled
    (TEMPO_TPU_COLCACHE_MB=0)."""
    global _shared
    if _shared is None:
        with _shared_lock:
            if _shared is None:
                mb = int(os.environ.get("TEMPO_TPU_COLCACHE_MB", "256"))
                if mb <= 0:
                    return None
                _shared = ColumnCache(mb << 20)
                _register_metrics(_shared)
    return _shared


def _register_metrics(cache) -> None:
    """Publish cache stats on /metrics (reference: the backend cache's
    promauto gauges): a collector refreshes the gauges from stats() at
    every exposition, so read-path cache behavior is observable
    process-wide, not just per bench run. The `tier` label keeps the
    host and device tiers separate series of ONE family."""
    from tempo_tpu_torch.util import metrics

    gauges = {
        name: metrics.gauge(
            f"tempo_tpu_colcache_{name}",
            f"Column cache {name} by tier (host=decoded arrays, "
            "device=resident compressed pages; colcache.stats)",
        )
        # the tail_* trio only ever appears on the device tier (the
        # ingest_tail keyspace); host stats simply never set them
        for name in ("hits", "misses", "evictions", "bytes", "entries",
                     "tail_bytes", "tail_entries", "tail_max_bytes")
    }

    def collect():
        stats = cache.stats()
        tier = stats.get("tier", "host")
        for name, value in stats.items():
            g = gauges.get(name)
            if g is not None:
                g.set(value, tier=tier)

    metrics.register_collector(collect)


# ---------------------------------------------------------------------------
# device-resident hot tier
# ---------------------------------------------------------------------------

# key-space tag for just-cut ingest tails parked by the cut path; these
# entries bypass page-heat admission, live under their own sub-budget,
# and are shed before any hot page
TAIL_KEYSPACE = "ingest_tail"


def is_tail_key(key) -> bool:
    return isinstance(key, tuple) and len(key) > 0 and key[0] == TAIL_KEYSPACE


def device_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; uint32 as int32 bits, uint64 as
    int64 bits (the kernels read both as unsigned)."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    # a copy: the host cache's arrays are read-only, and the tier must
    # not alias them on the CPU
    return torch.tensor(np.ascontiguousarray(a), device=device)


class _Resident:
    """One resident entry: device tensors of an ENCODED page form plus
    the host-side metadata needed to scan it without re-reading."""

    __slots__ = ("codec", "arrays", "meta", "nbytes", "host_bytes", "row")

    def __init__(self, codec: str, arrays: dict, meta: dict,
                 host_bytes: int):
        self.codec = codec
        self.arrays = arrays
        self.meta = meta or {}
        self.nbytes = sum(int(getattr(a, "nbytes", 0)) for a in arrays.values())
        # what one host-path serve of this page would have shipped h2d —
        # the per-hit "transfer bytes avoided" increment
        self.host_bytes = int(host_bytes)
        # the page's row of a batched scan's page table, built once here
        self.row = page_row(codec, arrays, self.meta)


class DeviceTier:
    """Bytes-bounded LRU of COMPRESSED pages held as device tensors.

    Admission is the closed loop over the page-heat ledger: a key is
    admitted only while it is in the current admission set — the
    hottest pages by re-ship bytes, packed into the KNEE budget of the
    ghost-LRU what-if curve (capped by the configured budget). Eviction
    is LRU within the pressure-scaled budget; the factors are harsher
    than the host cache's on purpose — device memory is the scarcest
    pool and must yield before the host tier, long before ingest
    refuses (shed order: device tier -> host tier -> ingest)."""

    _PRESSURE_FACTORS = {0: 1.0, 1: 0.25, 2: 0.0}

    def __init__(self, budget_bytes: int, governor=None,
                 admit_min_ships: int = 2, refresh_s: float = 30.0,
                 respect_governor: bool = True, max_query_batch: int = 8,
                 ingest_tail_budget_bytes: int = 0, device="cuda"):
        self.budget_bytes = int(budget_bytes)
        self.ingest_tail_budget_bytes = int(ingest_tail_budget_bytes)
        self.device = torch.device(device)
        self._tail_bytes = 0
        self._governor = governor  # None = process governor, bound lazily
        self.admit_min_ships = int(admit_min_ships)
        self.refresh_s = float(refresh_s)
        self.respect_governor = respect_governor
        self.max_query_batch = max(1, int(max_query_batch))
        self._lru: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admissions = 0
        self.avoided_bytes = 0
        # admission set: frozenset of (block_id, column, offset) keys,
        # recomputed from the ledger at most every refresh_s
        self._admit_keys: frozenset = frozenset()
        self._admit_budget = 0
        self._admit_at = 0.0

    # -- pressure ------------------------------------------------------
    def _level(self) -> int:
        gov = self._governor
        if gov is None:
            from tempo_tpu_torch.util import resource

            gov = self._governor = resource.governor()
        return gov.level()

    def effective_budget_bytes(self) -> int:
        if not self.respect_governor:
            return self.budget_bytes
        return int(self.budget_bytes
                   * self._PRESSURE_FACTORS.get(self._level(), 1.0))

    def shed(self) -> int:
        """Evict down to the pressure-scaled budget: ingest-tail entries
        FIRST (oldest first — they re-materialize from the WAL at the
        next cut for free), then LRU over the hot pages. Called on every
        get/offer (cheap when under budget) and by the metrics
        collector, so a pressure spike empties the tier even if no query
        arrives to trigger it. Dropping the reference frees the tensor
        (the caching allocator keeps the block for reuse)."""
        limit = self.effective_budget_bytes()
        n = 0
        with self._lock:
            while self._bytes > limit and self._lru:
                key = next((k for k in self._lru if is_tail_key(k)), None)
                if key is None:
                    key, res = self._lru.popitem(last=False)
                else:
                    res = self._lru.pop(key)
                    self._tail_bytes -= res.nbytes
                self._bytes -= res.nbytes
                self.evictions += 1
                n += 1
        return n

    # -- admission set -------------------------------------------------
    def refresh_admission(self, force: bool = False) -> None:
        """Recompute the admission set from the page-heat ledger: knee
        of the what-if curve, capped at the configured budget, packed
        by re-ship bytes (pageheat.admission_candidates)."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._admit_at < self.refresh_s:
                return
            self._admit_at = now
        from tempo_tpu_torch.util import pageheat

        rep = pageheat.admission_report(budget_bytes=self.budget_bytes,
                                        min_ships=self.admit_min_ships)
        keys = frozenset((c["block"], c["column"], c["offset"])
                         for c in rep["candidates"])
        with self._lock:
            self._admit_keys = keys
            self._admit_budget = rep["effectiveBudgetBytes"]

    def should_admit(self, page_keys) -> bool:
        """True when EVERY (block_id, column, offset) in page_keys is in
        the current admission set — composite entries (the compiled
        tier's stacks) admit only when all their pages are hot."""
        self.refresh_admission()
        with self._lock:
            admit = self._admit_keys
        if not admit:
            return False
        return all((str(b), c, int(o)) in admit for b, c, o in page_keys)

    # -- get/put -------------------------------------------------------
    def peek(self, key):
        """The entry of `key` if it is resident now, counting nothing and
        leaving the LRU order as it is: a batched scan reads its pages
        first and counts each one's get where the per-page path would."""
        with self._lock:
            return self._lru.get(key)

    def get(self, key, count_miss: bool = True):
        """count_miss=False: a miss counts nothing, so the caller's
        per-page path can take the page's own get (a batched scan's page
        evicted before its turn)."""
        self.shed()
        with self._lock:
            res = self._lru.get(key)
            if res is not None:
                self._lru.move_to_end(key)
                self.hits += 1
            elif count_miss:
                self.misses += 1
        return res

    def _to_device(self, kernel: str, arrays: dict, nbytes: int) -> dict:
        """The one h2d copy of an entry, measured where it happens, so
        the tier can never LOWER apparent transfer by hiding its own
        warm-up traffic."""
        from tempo_tpu_torch.util import devicetiming

        dev = {name: device_tensor(a, self.device) for name, a in arrays.items()}
        devicetiming.count_transfer(kernel, h2d=nbytes)
        return dev

    def offer(self, key, codec: str, arrays: dict, meta: dict | None = None,
              host_bytes: int = 0, page_keys=None) -> bool:
        """Admission path: host numpy arrays of one encoded page form go
        to the device HERE (the one h2d this page pays from now on) iff
        the page is in the admission set and fits the pressure-scaled
        budget. Returns True when the entry is resident after the call.

        page_keys: the (block_id, column, offset) identities backing
        this entry (defaults to [key] when key has that shape); the
        admission set is consulted per page."""
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                return True
        if page_keys is None:
            page_keys = [key]
        if not self.should_admit(page_keys):
            return False
        limit = self.effective_budget_bytes()
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        if nbytes > limit or nbytes <= 0:
            return False
        dev = self._to_device("device_tier_admit", arrays, nbytes)
        res = _Resident(codec, dev, meta or {}, host_bytes or nbytes)
        with self._lock:
            prev = self._lru.get(key)
            if prev is not None:
                self._bytes -= prev.nbytes
            self._lru[key] = res
            self._bytes += res.nbytes
            self.admissions += 1
            while self._bytes > limit and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self._bytes -= evicted.nbytes
                self.evictions += 1
        return True

    # -- ingest tail ---------------------------------------------------
    def effective_tail_budget_bytes(self) -> int:
        """Pressure-scaled tail sub-budget, never above the tier's own
        effective budget (the tail is carved out of it, not added)."""
        limit = self.ingest_tail_budget_bytes
        if self.respect_governor:
            limit = int(limit * self._PRESSURE_FACTORS.get(self._level(), 1.0))
        return min(limit, self.effective_budget_bytes())

    def park_tail(self, key, arrays: dict, meta: dict | None = None,
                  host_bytes: int = 0) -> bool:
        """Park a just-cut columnar tail under the `ingest_tail` key
        space. Unlike offer(), this bypasses the page-heat admission set
        — a cut is hot by construction (the standing fold and live-tail
        search hit it immediately, before any ledger heat could accrue)
        — but pays its own sub-budget, and tail entries are the FIRST
        thing shed under pressure. Returns True when resident."""
        limit = self.effective_tail_budget_bytes()
        if limit <= 0:
            return False
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        if nbytes <= 0 or nbytes > limit:
            return False
        # parking is a real h2d ship, measured where it happens
        dev = self._to_device("ingest_tail_park", arrays, nbytes)
        res = _Resident("tail", dev, meta or {}, host_bytes or nbytes)
        with self._lock:
            prev = self._lru.get(key)
            if prev is not None:
                self._bytes -= prev.nbytes
                self._tail_bytes -= prev.nbytes
            self._lru[key] = res
            self._bytes += res.nbytes
            self._tail_bytes += res.nbytes
            self.admissions += 1
            while self._tail_bytes > limit:
                k = next(k for k in self._lru if is_tail_key(k))
                ev = self._lru.pop(k)
                self._bytes -= ev.nbytes
                self._tail_bytes -= ev.nbytes
                self.evictions += 1
        self.shed()
        with self._lock:
            return key in self._lru

    def record_avoided(self, nbytes: int, kernel: str = "resident_scan") -> None:
        """One resident-tier serve elided `nbytes` of h2d: feed the
        transfer plane's avoided counter + the tier's own rollup."""
        from tempo_tpu_torch.util import devicetiming

        with self._lock:
            self.avoided_bytes += int(nbytes)
        devicetiming.count_avoided(kernel, nbytes)

    # -- views ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "tier": "device",
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "admissions": self.admissions,
                "bytes": self._bytes,
                "entries": len(self._lru),
                "avoided_bytes": self.avoided_bytes,
                "max_bytes": self.budget_bytes,
                "effective_max_bytes": self.effective_budget_bytes(),
                "tail_bytes": self._tail_bytes,
                "tail_entries": sum(1 for k in self._lru if is_tail_key(k)),
                "tail_max_bytes": self.ingest_tail_budget_bytes,
            }

    def resident_pages(self, top: int = 50) -> list:
        """MRU-first listing for /status/device."""
        with self._lock:
            items = list(reversed(self._lru.items()))[:top]
        out = []
        for key, res in items:
            row = {"codec": res.codec, "deviceBytes": res.nbytes,
                   "hostBytes": res.host_bytes}
            if is_tail_key(key):
                # ("ingest_tail", tenant, seg_key): slot 2 is the WAL
                # segment identity, not a page offset
                row.update(keyspace=TAIL_KEYSPACE, tenant=str(key[1]),
                           segment=str(key[2]))
            elif (isinstance(key, tuple) and len(key) == 3
                    and isinstance(key[1], str)):
                row.update(block=str(key[0]), column=key[1],
                           offset=int(key[2]))
            else:
                row["key"] = repr(key)
            out.append(row)
        return out

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._bytes = 0


_shared_device: DeviceTier | None = None
# where an environment-sized tier (TEMPO_TPU_DEVICE_TIER_MB) lives: the
# device of the last configure_device_tier call (the App's), else cuda
_tier_device = None
_device_lock = threading.Lock()
_device_metrics_armed = False


def _arm_device_metrics() -> None:
    """ONE collector, registered once, reading whichever tier is
    currently installed — reconfiguration must not stack collectors or
    leave a replaced tier publishing stale series. The collector also
    sheds: a pressure spike empties the tier at the next exposition
    even if no query arrives to trigger eviction (the governor hook)."""
    global _device_metrics_armed
    if _device_metrics_armed:
        return
    _device_metrics_armed = True

    class _Current:
        @staticmethod
        def stats():
            tier = _shared_device
            if tier is None:
                return {"tier": "device"}
            tier.shed()
            return tier.stats()

    _register_metrics(_Current)


def configure_device_tier(cfg: DeviceTierConfig | None, device=None) -> DeviceTier | None:
    """Install (or disable) the process-wide device tier from config on
    `device` (None: cuda) — App startup calls this with its own device;
    tests hand modules private instances instead. Replacing an enabled
    tier drops the old one's residents."""
    global _shared_device, _tier_device
    with _device_lock:
        _tier_device = device
        if cfg is None or cfg.budget_mb <= 0:
            _shared_device = None
            return None
        tier = DeviceTier(
            cfg.budget_mb << 20,
            admit_min_ships=cfg.admit_min_ships,
            refresh_s=cfg.refresh_s,
            respect_governor=cfg.respect_governor,
            max_query_batch=cfg.max_query_batch,
            ingest_tail_budget_bytes=cfg.ingest_tail_budget_mb << 20,
            device=_tier_device_resolved(),
        )
        _arm_device_metrics()
        _shared_device = tier
        return tier


def _tier_device_resolved() -> torch.device:
    from tempo_tpu_torch import device as _device

    return _device.resolve(_tier_device)


def shared_device_tier() -> DeviceTier | None:
    """The process-wide device tier, or None when disabled (the default:
    no config and TEMPO_TPU_DEVICE_TIER_MB unset/0)."""
    global _shared_device
    if _shared_device is None:
        with _device_lock:
            if _shared_device is None:
                mb = int(os.environ.get("TEMPO_TPU_DEVICE_TIER_MB", "0"))
                if mb <= 0:
                    return None
                tail_mb = int(os.environ.get("TEMPO_TPU_INGEST_TAIL_MB", "0"))
                tier = DeviceTier(mb << 20,
                                  ingest_tail_budget_bytes=tail_mb << 20,
                                  device=_tier_device_resolved())
                _arm_device_metrics()
                _shared_device = tier
    return _shared_device


def hbm_headroom_bytes() -> int:
    """Detected card memory for the tier's device, or 0 when unknown
    (the CPU reports no limit). TEMPO_TPU_HBM_BYTES overrides for fleets
    whose runtime under-reports. check_config compares the configured
    tier budget against this."""
    env = os.environ.get("TEMPO_TPU_HBM_BYTES", "")
    if env:
        try:
            return int(env)
        except ValueError:
            return 0
    try:
        dev = torch.device("cuda" if _tier_device is None else _tier_device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return 0
        return int(torch.cuda.mem_get_info(dev)[1])
    except Exception:
        return 0


def device_tier_report() -> dict:
    """The /status/device `residentTier` section: enabled/budget/stats +
    the resident set, plus the admission decision that produced it."""
    tier = shared_device_tier()
    if tier is None:
        return {"enabled": False}
    tier.refresh_admission()
    with tier._lock:
        admit_budget = tier._admit_budget
        admit_size = len(tier._admit_keys)
    return {
        "enabled": True,
        "stats": tier.stats(),
        "admissionBudgetBytes": admit_budget,
        "admissionSetSize": admit_size,
        "residentPages": tier.resident_pages(),
    }
