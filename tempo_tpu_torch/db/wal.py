"""Port of tempo_tpu/db/wal.py, copied as is (host code).

WAL folder manager.

Reference: tempodb/wal/wal.go:47-201 — owns the wal directory, creates
new WAL blocks through the configured encoding, and rescans the folder
on restart by asking each registered encoding whether it owns a block
dir (RescanBlocks / OwnsWALBlock, wal.go:93-152). Unparseable dirs are
skipped with a warning; corrupt segments are dropped during replay by
the encoding itself.
"""

from __future__ import annotations

import logging
import os

from tempo_tpu_torch import encoding as encoding_registry

log = logging.getLogger(__name__)


class WAL:
    def __init__(self, root: str, version: str = encoding_registry.DEFAULT_ENCODING):
        self.root = root
        self.version = version
        os.makedirs(root, exist_ok=True)

    def new_block(self, tenant: str):
        return encoding_registry.from_version(self.version).create_wal_block(self.root, tenant)

    def rescan_blocks(self) -> list:
        """Reopen every decodable WAL block after a restart."""
        blocks = []
        try:
            names = sorted(os.listdir(self.root))
        except FileNotFoundError:
            return blocks
        for name in names:
            path = os.path.join(self.root, name)
            if not os.path.isdir(path):
                continue
            owner = next(
                (e for e in encoding_registry.all_encodings() if e.owns_wal_block(path)), None
            )
            if owner is None:
                log.warning("wal: skipping unrecognized dir %s", path)
                continue
            try:
                blocks.append(owner.open_wal_block(path))
            except Exception as e:
                log.warning("wal: failed to open %s: %s", path, e)
        return blocks
