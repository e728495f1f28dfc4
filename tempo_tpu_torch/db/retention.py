"""Port of tempo_tpu/db/retention.py, copied as is (host code).

Retention: two-phase deletion of expired blocks.

Reference: tempodb/retention.go:14-70 — phase 1 marks live blocks older
than per-tenant retention as compacted; phase 2 clears compacted blocks
after CompactedBlockRetention so in-flight queries against them drain.
"""

from __future__ import annotations

import logging
import time

from tempo_tpu_torch.backend.base import CompactedBlockMeta, NotFound

log = logging.getLogger(__name__)


class RetentionDriver:
    def __init__(self, db, retention_for_tenant=None):
        self.db = db
        # callable tenant -> seconds (overrides hook); falls back to db cfg
        self.retention_for_tenant = retention_for_tenant
        self.blocks_retained = 0
        self.blocks_cleared = 0

    def run_once(self, now: float | None = None) -> None:
        now = now or time.time()
        cfg = self.db.compaction_cfg
        for tenant in set(self.db.blocklist.tenants()) | set(self.db.blocklist.compacted_tenants()):
            retention = (
                self.retention_for_tenant(tenant)
                if self.retention_for_tenant
                else cfg.retention_s
            )
            if retention > 0:
                self._mark_expired(tenant, now, retention)
            self._clear_compacted(tenant, now, cfg.compacted_retention_s)
        # crash debris: blocks whose writer died between data/index/bloom
        # and the meta.json commit are invisible to queries (meta-LAST
        # protocol) but still hold bytes — sweep them here, on the same
        # single owner that clears compacted blocks
        try:
            self.db.sweep_orphans(now=now)
        except Exception:
            log.exception("orphan sweep failed")

    def _mark_expired(self, tenant, now, retention):
        # include quarantined blocks: quarantine hides a block from
        # queries and compaction, but retention must still expire it —
        # otherwise a corrupt block's bytes outlive the tenant's
        # retention window forever
        expired = [
            m for m in self.db.blocklist.metas(tenant, include_quarantined=True)
            if m.end_time < now - retention
        ]
        compacted = []
        for m in expired:
            try:
                self.db.backend.mark_block_compacted(tenant, m.block_id, now)
                compacted.append(CompactedBlockMeta(meta=m, compacted_time=now))
                self.blocks_retained += 1
            except NotFound:
                pass
            except Exception:
                log.exception("retention: marking %s failed", m.block_id)
        if expired:
            self.db.blocklist.update(tenant, removes=expired, compacted_adds=compacted)

    def _clear_compacted(self, tenant, now, keep_s):
        cleared = []
        for c in self.db.blocklist.compacted_metas(tenant):
            if c.compacted_time < now - keep_s:
                try:
                    self.db.backend.clear_block(tenant, c.meta.block_id)
                    self.blocks_cleared += 1
                    cleared.append(c.meta.block_id)
                except Exception:
                    log.exception("retention: clearing %s failed", c.meta.block_id)
        if cleared:
            self.db.blocklist.drop_compacted(tenant, cleared)
