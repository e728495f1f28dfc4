"""The VersionedEncoding implementation for vtpu1.

Port of tempo_tpu/encoding/vtpu/encoding.py. The one change: the
writer and the compactor take the `device` their sketch plane runs on
(CUDA unless "cpu" is passed), which TempoDB hands down.

Reference: tempodb/encoding/versioned.go:18-51 — the interface the
engine façade and WAL manager program against. Everything block-shaped
in the engine goes through this seam, so alternative encodings remain
pluggable via the block-version config knob.
"""

from __future__ import annotations

import os

from tempo_tpu_torch.backend.base import BlockMeta, TypedBackend
from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
from tempo_tpu_torch.encoding.vtpu import VERSION
from tempo_tpu_torch.encoding.vtpu import wal as wal_mod
from tempo_tpu_torch.encoding.vtpu.block import VtpuBackendBlock
from tempo_tpu_torch.encoding.vtpu.compactor import VtpuCompactor
from tempo_tpu_torch.encoding.vtpu.create import write_block
from tempo_tpu_torch.encoding.vtpu.wal import VtpuWalBlock


class Encoding:
    version = VERSION

    # blocks ------------------------------------------------------------
    def open_block(self, meta: BlockMeta, backend: TypedBackend,
                   cfg: BlockConfig | None = None) -> VtpuBackendBlock:
        return VtpuBackendBlock(meta, backend, cfg)

    def create_block(self, batches, tenant: str, backend: TypedBackend,
                     cfg: BlockConfig, **kw) -> BlockMeta | None:
        return write_block(batches, tenant, backend, cfg, **kw)

    def new_compactor(self, opts: CompactionOptions | None = None,
                      device=None) -> VtpuCompactor:
        return VtpuCompactor(opts, device=device)

    def copy_block(self, meta: BlockMeta, src: TypedBackend, dst: TypedBackend) -> None:
        """Byte-copy all block objects between backends (reference:
        versioned.go CopyBlock, used by ingester flush local->object store)."""
        names = src.raw.list_objects((meta.tenant_id, meta.block_id))  # type: ignore[attr-defined]
        for name in names:
            data = src.read_named(meta.tenant_id, meta.block_id, name)
            dst.write_named(meta, name, data)

    # wal ---------------------------------------------------------------
    def create_wal_block(self, wal_root: str, tenant: str) -> VtpuWalBlock:
        return VtpuWalBlock.create(wal_root, tenant, VERSION)

    def open_wal_block(self, path: str) -> VtpuWalBlock:
        return VtpuWalBlock.open(path)

    def owns_wal_block(self, path: str) -> bool:
        parsed = wal_mod.parse_wal_dir_name(os.path.basename(path))
        return parsed is not None and parsed[2] == VERSION
