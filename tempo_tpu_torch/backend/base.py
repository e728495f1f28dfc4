"""Port of tempo_tpu/backend/base.py, copied as is (host code).

Backend contracts: raw byte objects + typed block layer.

Reference parity:
- RawReader/RawWriter keypath object model: tempodb/backend/raw.go:24-48
  (objects live under <tenant>/<blockID>/<name>).
- Object names: raw.go:16-22 (meta.json, bloom-N, data, index,
  meta.compacted.json) — kept byte-compatible in spirit; the data/index
  objects differ because the encoding is the TPU-native one.
- BlockMeta: tempodb/backend/block_meta.go:16-35 — plus the bloom/sketch
  geometry the TPU kernels need to reinterpret serialized filters
  (a reader with different defaults would otherwise get silent false
  negatives; geometry always travels with the block).
- Typed Reader/Writer/Compactor: tempodb/backend/backend.go:22-69.
"""

from __future__ import annotations

import dataclasses
import json
import uuid
from dataclasses import dataclass, field

MetaName = "meta.json"
CompactedMetaName = "meta.compacted.json"
TenantIndexName = "index.json.gz"
DataName = "data.bin"
ColumnIndexName = "index.json"
DictionaryName = "dict.bin"


def bloom_name(shard: int) -> str:
    return f"bloom-{shard}"


class NotFound(Exception):
    """Object does not exist (reference: backend.ErrDoesNotExist)."""


class AlreadyExists(Exception):
    """Block meta already present (reference: backend.ErrMetaDoesNotExist inverse)."""


@dataclass
class BlockMeta:
    """Per-block metadata, JSON at <tenant>/<block>/meta.json."""

    version: str = "vtpu1"
    block_id: str = ""
    tenant_id: str = ""
    start_time: int = 0  # unix seconds, min span start
    end_time: int = 0  # unix seconds, max span end
    total_objects: int = 0  # traces
    total_spans: int = 0
    size_bytes: int = 0
    compaction_level: int = 0
    min_id: str = "0" * 32  # hex 128-bit
    max_id: str = "f" * 32
    total_records: int = 0  # row groups
    data_encoding: str = ""
    # bloom geometry (ops.bloom.BloomPlan) — must travel with the block
    bloom_shards: int = 1
    bloom_bits_per_shard: int = 0
    bloom_k: int = 0
    # sketch geometry
    hll_precision: int = 12
    # estimated distinct traces (HLL) — drives compaction sizing
    est_distinct_traces: int = 0

    def __post_init__(self):
        if not self.block_id:
            self.block_id = str(uuid.uuid4())

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @staticmethod
    def from_json(raw: bytes) -> "BlockMeta":
        d = json.loads(raw)
        known = {f.name for f in dataclasses.fields(BlockMeta)}
        return BlockMeta(**{k: v for k, v in d.items() if k in known})


@dataclass
class CompactedBlockMeta:
    meta: BlockMeta = field(default_factory=BlockMeta)
    compacted_time: float = 0.0  # unix seconds

    def to_json(self) -> bytes:
        d = dataclasses.asdict(self.meta)
        d["compacted_time"] = self.compacted_time
        return json.dumps(d, sort_keys=True).encode()

    @staticmethod
    def from_json(raw: bytes) -> "CompactedBlockMeta":
        d = json.loads(raw)
        t = d.pop("compacted_time", 0.0)
        known = {f.name for f in dataclasses.fields(BlockMeta)}
        return CompactedBlockMeta(
            meta=BlockMeta(**{k: v for k, v in d.items() if k in known}), compacted_time=t
        )


class RawBackend:
    """Raw byte-object store. keypath is (tenant, block_id) or (tenant,)."""

    def write(self, name: str, keypath: tuple, data: bytes) -> None:
        raise NotImplementedError

    def append(self, name: str, keypath: tuple, data: bytes) -> None:
        """Append to an object (used for streamed data writes)."""
        raise NotImplementedError

    def read(self, name: str, keypath: tuple) -> bytes:
        raise NotImplementedError

    def read_range(self, name: str, keypath: tuple, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def list(self, keypath: tuple) -> list[str]:
        """Immediate child 'directories' under keypath."""
        raise NotImplementedError

    def delete(self, name: str, keypath: tuple) -> None:
        raise NotImplementedError


class TypedBackend:
    """Typed block operations over a RawBackend.

    One class covers the reference's Reader+Writer+Compactor trio
    (tempodb/backend/backend.go:22-69): python doesn't need the
    interface split, the engine façade narrows usage by convention.
    """

    def __init__(self, raw: RawBackend):
        self.raw = raw

    # -- writer ---------------------------------------------------------
    def write_block_meta(self, meta: BlockMeta) -> None:
        self.raw.write(MetaName, (meta.tenant_id, meta.block_id), meta.to_json())

    def write_named(self, meta: BlockMeta, name: str, data: bytes) -> None:
        self.raw.write(name, (meta.tenant_id, meta.block_id), data)

    def append_named(self, meta: BlockMeta, name: str, data: bytes) -> None:
        self.raw.append(name, (meta.tenant_id, meta.block_id), data)

    # -- reader ---------------------------------------------------------
    def tenants(self) -> list[str]:
        return self.raw.list(())

    def blocks(self, tenant: str) -> list[str]:
        return self.raw.list((tenant,))

    def block_meta(self, tenant: str, block_id: str) -> BlockMeta:
        return BlockMeta.from_json(self.raw.read(MetaName, (tenant, block_id)))

    def read_named(self, tenant: str, block_id: str, name: str) -> bytes:
        return self.raw.read(name, (tenant, block_id))

    def read_range_named(self, tenant: str, block_id: str, name: str, offset: int, length: int) -> bytes:
        return self.raw.read_range(name, (tenant, block_id), offset, length)

    # -- compactor ------------------------------------------------------
    def mark_block_compacted(self, tenant: str, block_id: str, now: float) -> None:
        """meta.json -> meta.compacted.json (two-phase delete, reference:
        tempodb/backend compactor MarkBlockCompacted)."""
        meta = self.block_meta(tenant, block_id)
        cm = CompactedBlockMeta(meta=meta, compacted_time=now)
        self.raw.write(CompactedMetaName, (tenant, block_id), cm.to_json())
        self.raw.delete(MetaName, (tenant, block_id))

    def compacted_block_meta(self, tenant: str, block_id: str) -> CompactedBlockMeta:
        return CompactedBlockMeta.from_json(self.raw.read(CompactedMetaName, (tenant, block_id)))

    def clear_block(self, tenant: str, block_id: str) -> None:
        for name in list(self._block_objects(tenant, block_id)):
            try:
                self.raw.delete(name, (tenant, block_id))
            except NotFound:
                pass

    def _block_objects(self, tenant: str, block_id: str) -> list[str]:
        lister = getattr(self.raw, "list_objects", None)
        if lister is not None:
            return lister((tenant, block_id))
        return [MetaName, CompactedMetaName, DataName, ColumnIndexName, DictionaryName]
