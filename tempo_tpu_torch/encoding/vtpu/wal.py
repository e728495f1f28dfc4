"""Port of tempo_tpu/encoding/vtpu/wal.py, copied as is (host code).

WAL block: appendable on-disk segments, replayable after a crash.

Reference analog: tempodb/encoding/vparquet/wal_block.go (one parquet
file per flush under the block dir, replay re-reads files in order,
truncated tail files dropped with a warning) and the WAL folder naming
<blockID>+<tenant>+<version> that RescanBlocks parses
(tempodb/wal/wal.go:93-152).

Each append writes one self-contained segment (format.serialize_batch):
columnar pages + its own dictionary. No fsync-batching subtleties — a
segment either fully decodes or is discarded at replay.
"""

from __future__ import annotations

import logging
import os
import tempfile
import uuid

from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.model.columnar import SpanBatch

log = logging.getLogger(__name__)

SEG_SUFFIX = ".seg"


def wal_dir_name(block_id: str, tenant: str, version: str) -> str:
    return f"{block_id}+{tenant}+{version}"


def parse_wal_dir_name(name: str):
    """-> (block_id, tenant, version) or None."""
    parts = name.split("+")
    if len(parts) != 3:
        return None
    try:
        uuid.UUID(parts[0])
    except ValueError:
        return None
    return parts[0], parts[1], parts[2]


class VtpuWalBlock:
    def __init__(self, path: str, block_id: str, tenant: str, version: str = "vtpu1"):
        self.path = path
        self.block_id = block_id
        self.tenant = tenant
        self.version = version
        self._next_seg = 0
        os.makedirs(path, exist_ok=True)
        existing = self._segments()
        if existing:
            self._next_seg = int(os.path.basename(existing[-1])[: -len(SEG_SUFFIX)]) + 1

    @classmethod
    def create(cls, wal_root: str, tenant: str, version: str = "vtpu1") -> "VtpuWalBlock":
        block_id = str(uuid.uuid4())
        path = os.path.join(wal_root, wal_dir_name(block_id, tenant, version))
        return cls(path, block_id, tenant, version)

    @classmethod
    def open(cls, path: str) -> "VtpuWalBlock":
        parsed = parse_wal_dir_name(os.path.basename(path))
        if parsed is None:
            raise ValueError(f"not a wal block dir: {path}")
        return cls(path, *parsed)

    def _segments(self) -> list[str]:
        try:
            names = [n for n in os.listdir(self.path) if n.endswith(SEG_SUFFIX)]
        except FileNotFoundError:
            return []
        return [os.path.join(self.path, n) for n in sorted(names)]

    def append(self, batch: SpanBatch) -> None:
        """One flush = one segment file, atomically renamed into place."""
        if batch.num_spans == 0:
            return
        raw = fmt.serialize_batch(batch)
        fd, tmp = tempfile.mkstemp(dir=self.path, prefix=".seg.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(raw)
            os.replace(tmp, os.path.join(self.path, f"{self._next_seg:08d}{SEG_SUFFIX}"))
            self._next_seg += 1
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def iter_batches(self):
        """Replay all decodable segments; corrupt segments are dropped
        with a warning (reference: partial WAL replay warns + continues,
        tempodb/wal/wal.go:124-147)."""
        for _, batch in self.iter_batches_keyed():
            yield batch

    def iter_batches_keyed(self):
        """(segment index, batch) pairs, the index parsed from the ON-DISK
        file name — the identity the ingester cut path stamps on standing
        folds must survive a corrupt segment being skipped, so enumerate
        order is never a substitute."""
        for seg in self._segments():
            try:
                idx = int(os.path.basename(seg)[: -len(SEG_SUFFIX)])
                with open(seg, "rb") as f:
                    yield idx, fmt.deserialize_batch(f.read())
            except Exception as e:  # corrupt/truncated segment
                log.warning("wal: dropping corrupt segment %s: %s", seg, e)

    def all_spans(self) -> SpanBatch:
        return SpanBatch.concat(list(self.iter_batches()))

    def num_segments(self) -> int:
        return len(self._segments())

    def size_bytes(self) -> int:
        return sum(os.path.getsize(s) for s in self._segments())

    def clear(self) -> None:
        import shutil

        shutil.rmtree(self.path, ignore_errors=True)
