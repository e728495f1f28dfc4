"""Port of tempo_tpu/backend/tenantindex.py, copied as is (host code).

Per-tenant block index: <tenant>/index.json.gz.

Reference: tempodb/backend/tenantindex.go + the poller's builder role
(tempodb/blocklist/poller.go:157-199). Designated compactors write one
gzip'd JSON listing of all live + compacted block metas per tenant so
other roles can poll one object instead of listing the whole bucket;
readers fall back to a full scan when the index is stale
(poller.go:284 staleness check).
"""

from __future__ import annotations

import gzip
import json
import time
from dataclasses import dataclass, field

from tempo_tpu_torch.backend.base import (
    BlockMeta,
    CompactedBlockMeta,
    NotFound,
    RawBackend,
    TenantIndexName,
)


@dataclass
class TenantIndex:
    created_at: float = field(default_factory=time.time)
    metas: list = field(default_factory=list)  # list[BlockMeta]
    compacted: list = field(default_factory=list)  # list[CompactedBlockMeta]

    def to_bytes(self) -> bytes:
        doc = {
            "created_at": self.created_at,
            "meta": [json.loads(m.to_json()) for m in self.metas],
            "compacted": [json.loads(c.to_json()) for c in self.compacted],
        }
        return gzip.compress(json.dumps(doc).encode())

    @staticmethod
    def from_bytes(raw: bytes) -> "TenantIndex":
        doc = json.loads(gzip.decompress(raw))
        return TenantIndex(
            created_at=doc.get("created_at", 0.0),
            metas=[BlockMeta.from_json(json.dumps(m).encode()) for m in doc.get("meta", [])],
            compacted=[
                CompactedBlockMeta.from_json(json.dumps(c).encode())
                for c in doc.get("compacted", [])
            ],
        )


def write_tenant_index(raw: RawBackend, tenant: str, idx: TenantIndex) -> None:
    raw.write(TenantIndexName, (tenant,), idx.to_bytes())


def read_tenant_index(raw: RawBackend, tenant: str) -> TenantIndex:
    return TenantIndex.from_bytes(raw.read(TenantIndexName, (tenant,)))


def is_stale(idx: TenantIndex, max_age_s: float) -> bool:
    return max_age_s > 0 and (time.time() - idx.created_at) > max_age_s
