"""Port of tempo_tpu/encoding/vrow/encoding.py. As vtpu1's, the writer
and the compactor take the `device` their sketches run on.

VersionedEncoding implementation for vrow1.

Reference: tempodb/encoding/versioned.go — same seam as vtpu1's
encoding.py. The WAL reuses the columnar segment WAL (vtpu wal module)
under the vrow1 version tag: WAL durability is encoding-independent
here because the head block stores distributor segments, and the
encoding only decides the at-rest block layout (the reference's
`wal.version` knob makes the same separation, tempodb/wal/wal.go:157).
"""

from __future__ import annotations

import os

from tempo_tpu_torch.backend.base import BlockMeta, TypedBackend
from tempo_tpu_torch.encoding.common import BlockConfig, CompactionOptions
from tempo_tpu_torch.encoding.vrow.block import VrowBackendBlock, VrowCompactor, write_block
from tempo_tpu_torch.encoding.vtpu import wal as wal_mod
from tempo_tpu_torch.encoding.vtpu.wal import VtpuWalBlock

VERSION = "vrow1"


class Encoding:
    version = VERSION

    # blocks ------------------------------------------------------------
    def open_block(self, meta: BlockMeta, backend: TypedBackend,
                   cfg: BlockConfig | None = None) -> VrowBackendBlock:
        return VrowBackendBlock(meta, backend, cfg)

    def create_block(self, batches, tenant: str, backend: TypedBackend,
                     cfg: BlockConfig, **kw) -> BlockMeta | None:
        return write_block(batches, tenant, backend, cfg, **kw)

    def new_compactor(self, opts: CompactionOptions | None = None,
                      device=None) -> VrowCompactor:
        return VrowCompactor(opts, device=device)

    def copy_block(self, meta: BlockMeta, src: TypedBackend, dst: TypedBackend) -> None:
        names = src.raw.list_objects((meta.tenant_id, meta.block_id))  # type: ignore[attr-defined]
        for name in names:
            dst.write_named(meta, name, src.read_named(meta.tenant_id, meta.block_id, name))

    # wal ---------------------------------------------------------------
    def create_wal_block(self, wal_root: str, tenant: str) -> VtpuWalBlock:
        return VtpuWalBlock.create(wal_root, tenant, VERSION)

    def open_wal_block(self, path: str) -> VtpuWalBlock:
        return VtpuWalBlock.open(path)

    def owns_wal_block(self, path: str) -> bool:
        parsed = wal_mod.parse_wal_dir_name(os.path.basename(path))
        return parsed is not None and parsed[2] == VERSION
