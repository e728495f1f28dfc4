"""Port of tempo_tpu/db/blocklist.py, copied as is (host code).

Per-tenant in-memory blocklist + backend poller.

Reference: tempodb/blocklist/list.go:17 (List with in-flight compaction
reconciliation, updateInternal:123) and poller.go:122 (scan bucket or
read per-tenant index.json.gz; designated builders write the index;
staleness fallback :284).
"""

from __future__ import annotations

import logging
import threading
import time

from tempo_tpu_torch.backend.base import (
    BlockMeta,
    CompactedBlockMeta,
    CompactedMetaName,
    MetaName,
    NotFound,
    TypedBackend,
)
from tempo_tpu_torch.util import metrics
from tempo_tpu_torch.backend.tenantindex import (
    TenantIndex,
    is_stale,
    read_tenant_index,
    write_tenant_index,
)

log = logging.getLogger(__name__)

blocklist_length = metrics.gauge(
    "tempodb_blocklist_length", "Current blocklist length per tenant"
)
quarantined_blocks = metrics.gauge(
    "tempodb_blocklist_quarantined_blocks",
    "Blocks quarantined after repeated read/checksum failures, per tenant "
    "(see runbook: TempoTpuBlockQuarantined)",
)
quarantined_skips = metrics.counter(
    "tempodb_quarantined_block_skips_total",
    "Times a quarantined block was skipped by a query or the compactor",
)


class Blocklist:
    """Thread-safe per-tenant lists of live + compacted block metas.

    Also owns the QUARANTINE: blocks that repeatedly fail reads (page
    checksum failures count double — they are definitively the block's
    fault) are pulled out of the default metas() view, so queries and
    the compaction selector skip them
    instead of failing every request that touches them. Quarantine is
    in-memory per instance (like the blocklist itself) and survives
    polls; an operator clears it with unquarantine() after repairing or
    deleting the block (runbook: TempoTpuBlockQuarantined).
    """

    def __init__(self, quarantine_threshold: int = 3):
        self._lock = threading.Lock()
        self._metas: dict[str, list[BlockMeta]] = {}
        self._compacted: dict[str, list[CompactedBlockMeta]] = {}
        self.quarantine_threshold = quarantine_threshold
        self._failures: dict[tuple[str, str], int] = {}
        self._quarantined: dict[str, dict[str, str]] = {}  # tenant -> id -> reason

    def tenants(self) -> list[str]:
        with self._lock:
            return [t for t, m in self._metas.items() if m]

    def compacted_tenants(self) -> list[str]:
        with self._lock:
            return [t for t, c in self._compacted.items() if c]

    def metas(self, tenant: str, include_quarantined: bool = False) -> list[BlockMeta]:
        with self._lock:
            out = list(self._metas.get(tenant, []))
            bad = self._quarantined.get(tenant)
        if bad and not include_quarantined:
            skipped = [m for m in out if m.block_id in bad]
            if skipped:
                quarantined_skips.inc(len(skipped), tenant=tenant)
                out = [m for m in out if m.block_id not in bad]
        return out

    # -- quarantine ----------------------------------------------------
    def record_block_failure(self, tenant: str, block_id: str, reason: str = "",
                             weight: int = 1) -> bool:
        """Count one failed read against a block; quarantine it at the
        threshold. weight>1 fast-tracks definitive evidence (a checksum
        mismatch is the block's fault; a connection reset may not be).
        Returns True when this call newly quarantined the block."""
        with self._lock:
            if block_id in self._quarantined.get(tenant, ()):
                return False
            key = (tenant, block_id)
            n = self._failures.get(key, 0) + weight
            self._failures[key] = n
            if n < self.quarantine_threshold:
                return False
            self._quarantined.setdefault(tenant, {})[block_id] = reason
            self._failures.pop(key, None)
            quarantined_blocks.set(len(self._quarantined[tenant]), tenant=tenant)
        log.error(
            "QUARANTINING block %s/%s after repeated failures (%s) — queries and "
            "compaction will skip it; see runbook TempoTpuBlockQuarantined",
            tenant, block_id, reason,
        )
        return True

    def record_block_success(self, tenant: str, block_id: str) -> None:
        """A successful read resets the failure count: quarantine is for
        persistent faults, not one unlucky streak per week."""
        with self._lock:
            self._failures.pop((tenant, block_id), None)

    def quarantined(self, tenant: str) -> dict[str, str]:
        with self._lock:
            return dict(self._quarantined.get(tenant, {}))

    def quarantined_report(self) -> dict[str, dict[str, str]]:
        """All quarantined blocks across tenants ({tenant -> {block id ->
        reason}}) — the RCA evidence-bundle accessor: an incident must be
        able to ask "is ANY storage quarantined right now" without
        enumerating tenants."""
        with self._lock:
            return {t: dict(bad) for t, bad in self._quarantined.items() if bad}

    def is_quarantined(self, tenant: str, block_id: str) -> bool:
        with self._lock:
            return block_id in self._quarantined.get(tenant, ())

    def unquarantine(self, tenant: str, block_id: str) -> bool:
        """Operator escape hatch after repairing/deleting the block."""
        with self._lock:
            bad = self._quarantined.get(tenant, {})
            hit = bad.pop(block_id, None)
            self._failures.pop((tenant, block_id), None)
            quarantined_blocks.set(len(bad), tenant=tenant)
        return hit is not None

    def compacted_metas(self, tenant: str) -> list[CompactedBlockMeta]:
        with self._lock:
            return list(self._compacted.get(tenant, []))

    def apply_poll_results(self, metas, compacted):
        with self._lock:
            self._metas = {t: list(v) for t, v in metas.items()}
            self._compacted = {t: list(v) for t, v in compacted.items()}
            for t, v in self._metas.items():
                blocklist_length.set(len(v), tenant=t)

    def update(self, tenant, adds=(), removes=(), compacted_adds=()):
        """In-flight reconciliation between polls: the compactor updates
        the list immediately after a job so queries and the next selector
        cycle see the new world (reference: updateInternal:123)."""
        with self._lock:
            cur = self._metas.setdefault(tenant, [])
            rm_ids = {m.block_id for m in removes}
            cur[:] = [m for m in cur if m.block_id not in rm_ids]
            have = {m.block_id for m in cur}
            cur.extend(m for m in adds if m.block_id not in have)
            cc = self._compacted.setdefault(tenant, [])
            have_c = {c.meta.block_id for c in cc}
            cc.extend(c for c in compacted_adds if c.meta.block_id not in have_c)
            blocklist_length.set(len(cur), tenant=tenant)

    def drop_compacted(self, tenant, block_ids):
        """Forget compacted entries whose objects were cleared (retention
        phase 2), so they aren't re-cleared every cycle until the next poll."""
        ids = set(block_ids)
        with self._lock:
            cc = self._compacted.get(tenant, [])
            cc[:] = [c for c in cc if c.meta.block_id not in ids]


class Poller:
    """Scans the backend into poll results; optionally builds the
    per-tenant index when this instance is a designated builder."""

    def __init__(self, backend: TypedBackend, build_index: bool = False,
                 stale_tenant_index_s: float = 0.0, pool=None):
        self.backend = backend
        self.build_index = build_index
        self.stale_tenant_index_s = stale_tenant_index_s
        self.pool = pool

    def do(self):
        """-> (metas: {tenant: [BlockMeta]}, compacted: {tenant: [CompactedBlockMeta]})"""
        metas, compacted = {}, {}
        for tenant in self.backend.tenants():
            m, c = self._poll_tenant(tenant)
            metas[tenant] = m
            compacted[tenant] = c
        return metas, compacted

    def _poll_tenant(self, tenant: str):
        if not self.build_index:
            try:
                idx = read_tenant_index(self.backend.raw, tenant)
                if not is_stale(idx, self.stale_tenant_index_s):
                    return idx.metas, idx.compacted
                log.warning("tenant index for %s is stale; falling back to scan", tenant)
            except NotFound:
                pass
            except Exception as e:
                log.warning("tenant index read failed for %s: %s", tenant, e)
        m, c = self._scan_tenant(tenant)
        if self.build_index:
            try:
                write_tenant_index(
                    self.backend.raw, tenant, TenantIndex(created_at=time.time(), metas=m, compacted=c)
                )
            except Exception as e:
                log.warning("tenant index write failed for %s: %s", tenant, e)
        return m, c

    def _scan_tenant(self, tenant: str):
        return scan_tenant(self.backend, tenant, pool=self.pool)


def scan_tenant(backend, tenant: str, pool=None):
    """Bucket scan of one tenant: (live metas, compacted metas), both
    sorted by block id. Shared by the Poller and offline tooling (CLI)."""
    metas, compacted = [], []

    def load(block_id):
        try:
            return ("live", backend.block_meta(tenant, block_id))
        except NotFound:
            pass
        try:
            return ("compacted", backend.compacted_block_meta(tenant, block_id))
        except NotFound:
            return None  # mid-write block without meta yet

    block_ids = backend.blocks(tenant)
    if pool is not None:
        results, errors = pool.run_jobs([lambda b=b: load(b) for b in block_ids])
        if errors:
            # a transient meta-read failure must abort the poll (keeping
            # the previous blocklist) rather than silently dropping the
            # block from query visibility
            raise errors[0]
    else:
        results = [r for r in (load(b) for b in block_ids) if r is not None]
    for kind, meta in results:
        (metas if kind == "live" else compacted).append(meta)
    metas.sort(key=lambda m: m.block_id)
    compacted.sort(key=lambda c: c.meta.block_id)
    return metas, compacted
