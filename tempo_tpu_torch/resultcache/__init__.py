"""Immutable-block result cache + negative cache. Port of
tempo_tpu/resultcache, copied as is (host code): the keys, the
fingerprints and the framed entries are byte-equal to the reference's,
so a port replica and a reference replica that share a memcached share
entries.

Blocks are immutable and frontend shard jobs deterministic, so a shard
partial is a pure function of (block_id, kind, normalized query +
literals, row-group subrange, format version) — exact reuse with ZERO
invalidation problems. This module caches all three partial shapes the
read stack produces behind one seam:

  * search / query_range integer-add partials (modules/querier.py),
  * graph (block, query) partials (tempo_tpu_torch/graph),
  * standing (block, rule) step partials (tempo_tpu_torch/standing),

so a repeated dashboard query recomputes only the newest blocks and the
existing `_run_jobs` merge folds cached partials bit-identically with
cold ones.

Tiers: an owned in-process LRU (cache/client.LRUCache) in front of the
db's shared remote client (memcached/redis, usually write-behind via
BackgroundCache) — the remote is BORROWED: db.shutdown stops it once.

Entries are CRC-framed (`RC1` + crc32 + canonical JSON): a corrupted or
truncated entry decodes to None, counts on
tempo_tpu_resultcache_corrupt_total, and falls through to recompute —
the cache can serve stale-free or nothing, never garbage. When a
TEMPO_TPU_FAULTS plan is armed, its corrupt/short-read rates are applied
to fetched entries too, so the chaos suite exercises this frame
end-to-end.

Negative cache: a block PROVABLY empty for a query (dictionary-miss
impossibility or every row group zone/window-pruned — i.e. zero rows
inspected, not merely zero results) caches the veto, so the repeat skips
the block open and meta fetch entirely. Same key, same lookup; `neg`
entries differ only in accounting (tempo_tpu_resultcache_negative_total
and the `negative` insights verdict).

Key scheme:
    rc{FORMAT_VERSION}|qs{KEYSPACE_VERSION}|{tenant}|{block}|{kind}|{subrange}|{blake2s fp}
Bumping FORMAT_VERSION (entry layout) or queryshape.KEYSPACE_VERSION
(normalizer semantics) rotates the whole keyspace — old entries become
unreachable, never misread. The blake2s fingerprint keeps keys inside
memcached's 250-char / no-whitespace rules regardless of query text.

Cache economics are measured, not asserted: every hit / miss / negative
/ store moves an untagged counter AND usage.charge()s the per-tenant
cost vector at the same statement (the usage-plane exactness contract),
with bytes_saved credited from the cold compute's recorded read bytes.

Kill switch: TEMPO_TPU_RESULT_CACHE=0 disables everything (the e2e
bit-identity proof); =force/1 enables regardless of config (the
loadtest arm's knob).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import zlib

from tempo_tpu_torch.backend import faults as faults_mod
from tempo_tpu_torch.cache.client import LRUCache
from tempo_tpu_torch.util import metrics, usage
from tempo_tpu_torch.util.queryshape import KEYSPACE_VERSION

# entry-layout version: bump when the framed document schema changes
FORMAT_VERSION = 1
_MAGIC = b"RC1"

# partial kinds an entry can hold (bounded — this is a metric label)
RC_KINDS = ("search", "metrics", "graph", "standing")

rc_hits = metrics.counter(
    "tempo_tpu_resultcache_hits_total",
    "Result-cache hits: cached shard partial served, block recompute "
    "skipped, by partial kind")
rc_misses = metrics.counter(
    "tempo_tpu_resultcache_misses_total",
    "Result-cache misses: block recomputed cold, by partial kind")
rc_negative = metrics.counter(
    "tempo_tpu_resultcache_negative_total",
    "Negative-cache vetoes served: block provably empty for the query, "
    "fetch skipped entirely, by partial kind")
rc_stores = metrics.counter(
    "tempo_tpu_resultcache_stores_total",
    "Shard partials written into the result cache, by partial kind")
rc_corrupt = metrics.counter(
    "tempo_tpu_resultcache_corrupt_total",
    "Cached entries rejected by the CRC frame (corrupt/truncated; "
    "treated as miss, recomputed), by partial kind")
rc_bytes_saved = metrics.counter(
    "tempo_tpu_resultcache_bytes_saved_total",
    "Backend bytes not read because a cached or negative entry answered "
    "for the block, by partial kind")


@dataclasses.dataclass
class ResultCacheConfig:
    """storage.trace.result_cache config section."""

    enabled: bool = False
    # in-process LRU tier bound; the remote tier rides the db's
    # memcached/redis client and its own ttl/eviction policy
    max_bytes: int = 64 << 20
    # cache provably-empty vetoes (needs zone maps on the store's
    # blocks to ever fire — check_config warns on stats-less stores)
    negative: bool = True


def fingerprint(*parts) -> str:
    """Stable 128-bit hex digest of the query-identity parts (normalized
    shape, ordered literals, window params). Canonical JSON so dict
    ordering can never split the keyspace."""
    blob = json.dumps(parts, sort_keys=True, separators=(",", ":"),
                      default=repr)
    return hashlib.blake2s(blob.encode(), digest_size=16).hexdigest()


def encode_entry(doc: dict) -> bytes:
    """CRC-frame a JSON-safe document: MAGIC + crc32(payload) + payload."""
    payload = json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()
    return _MAGIC + zlib.crc32(payload).to_bytes(4, "big") + payload


def decode_entry(raw: bytes | None) -> dict | None:
    """Inverse of encode_entry; None on ANY framing/CRC/JSON defect —
    a damaged entry must read as a miss, never as data."""
    if not raw or len(raw) < 8 or raw[:3] != _MAGIC:
        return None
    if zlib.crc32(raw[7:]) != int.from_bytes(raw[3:7], "big"):
        return None
    try:
        doc = json.loads(raw[7:])
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def _env_state() -> str:
    """'' (follow config) | 'off' | 'on' from TEMPO_TPU_RESULT_CACHE."""
    v = os.environ.get("TEMPO_TPU_RESULT_CACHE", "").strip().lower()
    if v in ("0", "false", "no"):
        return "off"
    if v in ("1", "true", "yes", "force", "on"):
        return "on"
    return ""


class ResultCache:
    """Two-tier get/put of framed partial documents + the accounting.

    Documents are small JSON dicts:
      computed partial:  {"w": <kind-specific wire>, "sb": <cold bytes>}
      negative veto:     {"neg": 1, "sb": <cold bytes>}
    "sb" is what the cold compute read from the backend for this block —
    the bytes a hit saves, credited to bytes_saved on every hit.
    """

    def __init__(self, cfg: ResultCacheConfig | None = None, remote=None):
        self.cfg = cfg or ResultCacheConfig()
        self._local = LRUCache(max_bytes=max(1 << 20, self.cfg.max_bytes))
        self._remote = remote  # borrowed (db owns + stops it)
        self._chaos_lock = threading.Lock()
        self._chaos_n = 0

    # -- gating ----------------------------------------------------------
    def enabled(self) -> bool:
        env = _env_state()
        if env == "off":
            return False
        if env == "on":
            return True
        return bool(self.cfg.enabled)

    def negative_enabled(self) -> bool:
        return self.enabled() and bool(self.cfg.negative)

    # -- keys ------------------------------------------------------------
    @staticmethod
    def key(tenant: str, block_id: str, kind: str, fp: str,
            subrange: str = "all") -> str:
        return (f"rc{FORMAT_VERSION}|qs{KEYSPACE_VERSION}|{tenant}|"
                f"{block_id}|{kind}|{subrange}|{fp}")

    # -- chaos seam ------------------------------------------------------
    def _chaos(self, raw: bytes) -> bytes:
        """Apply an armed TEMPO_TPU_FAULTS plan's corrupt/short-read
        rates to a fetched entry (deterministic in plan seed + fetch
        sequence number, same as the backend injector)."""
        plan = faults_mod.env_plan()
        if plan is None or not raw:
            return raw
        with self._chaos_lock:
            self._chaos_n += 1
            n = self._chaos_n
        if plan.short_read_rate and \
                faults_mod._roll(plan.seed, "rc_fetch", n, 4) < plan.short_read_rate:
            raw = raw[: 1 + faults_mod._mix(plan.seed, n, 5) % max(len(raw) - 1, 1)]
        if plan.corrupt_rate and \
                faults_mod._roll(plan.seed, "rc_fetch", n, 6) < plan.corrupt_rate:
            pos = faults_mod._mix(plan.seed, n, 7) % len(raw)
            bit = 1 << (faults_mod._mix(plan.seed, n, 8) % 8)
            raw = raw[:pos] + bytes([raw[pos] ^ bit]) + raw[pos + 1:]
        return raw

    # -- get/put ---------------------------------------------------------
    def _fetch_raw(self, k: str) -> bytes | None:
        found, bufs, _ = self._local.fetch([k])
        if found:
            return self._chaos(bufs[0])
        if self._remote is not None:
            found, bufs, _ = self._remote.fetch([k])
            if found:
                raw = self._chaos(bufs[0])
                # promote only entries that survive the frame check —
                # re-framing a damaged remote entry would launder it
                if decode_entry(raw) is not None:
                    self._local.store([k], [raw])
                return raw
        return None

    def get(self, tenant: str, block_id: str, kind: str, fp: str,
            subrange: str = "all") -> dict | None:
        """Returns the cached document or None (miss). ALL accounting
        happens here: the untagged kind-labelled counters and the active
        per-tenant cost vector move at the same statement."""
        k = self.key(tenant, block_id, kind, fp, subrange)
        raw = self._fetch_raw(k)
        doc = decode_entry(raw)
        if doc is None:
            if raw is not None:
                rc_corrupt.inc(kind=kind)
            rc_misses.inc(kind=kind)
            usage.charge("result_cache_misses")
            return None
        if doc.get("neg"):
            if not self.negative_enabled():
                # vetoes written before the operator disabled negative
                # caching must not be served
                rc_misses.inc(kind=kind)
                usage.charge("result_cache_misses")
                return None
            rc_negative.inc(kind=kind)
            usage.charge("result_cache_negative")
        else:
            rc_hits.inc(kind=kind)
            usage.charge("result_cache_hits")
        saved = int(doc.get("sb", 0))
        if saved > 0:
            rc_bytes_saved.inc(saved, kind=kind)
            usage.charge("result_cache_bytes_saved", saved)
        return doc

    def _store(self, k: str, doc: dict) -> None:
        raw = encode_entry(doc)
        self._local.store([k], [raw])
        if self._remote is not None:
            self._remote.store([k], [raw])

    def put(self, tenant: str, block_id: str, kind: str, fp: str,
            wire, bytes_saved: int = 0, subrange: str = "all") -> None:
        """Cache a computed partial; bytes_saved = backend bytes the cold
        compute read for this block (what every future hit avoids)."""
        self._store(self.key(tenant, block_id, kind, fp, subrange),
                    {"w": wire, "sb": int(bytes_saved)})
        rc_stores.inc(kind=kind)
        usage.charge("result_cache_stores")

    def put_negative(self, tenant: str, block_id: str, kind: str, fp: str,
                     bytes_saved: int = 0, subrange: str = "all") -> None:
        """Cache a provable-emptiness veto (zero rows inspected — the
        caller asserts the scan pruned everything, not that it matched
        nothing)."""
        if not self.negative_enabled():
            return
        self._store(self.key(tenant, block_id, kind, fp, subrange),
                    {"neg": 1, "sb": int(bytes_saved)})
        rc_stores.inc(kind=kind)
        usage.charge("result_cache_stores")

    # -- lifecycle -------------------------------------------------------
    def stop(self) -> None:
        """Drop the local tier. The remote client is borrowed — the db
        stops it exactly once in its own shutdown."""
        self._local = LRUCache(max_bytes=max(1 << 20, self.cfg.max_bytes))
