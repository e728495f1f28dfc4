"""Port of tempo_tpu/modules/compactor_module.py, copied as is (host code).

Compactor role: ring-sharded ownership over the engine's driver.

Reference: modules/compactor/compactor.go (ring-based Owns:189-217 via
fnv32 of the job hash, BasicLifecycler membership, enabling tempodb
compaction + retention).
"""

from __future__ import annotations

import threading
import time

from tempo_tpu_torch.db.compaction import CompactionDriver
from tempo_tpu_torch.ops.hashing import FNV1A_OFFSET32, FNV1A_PRIME32


def job_token(job_hash: str) -> int:
    h = int(FNV1A_OFFSET32)
    for b in job_hash.encode():
        h = ((h ^ b) * int(FNV1A_PRIME32)) & 0xFFFFFFFF
    return h


class CompactorModule:
    def __init__(self, db, ring=None, instance_id: str = "compactor-0",
                 cycle_s: float | None = None):
        self.db = db
        self.ring = ring
        self.instance_id = instance_id
        self._heartbeat_stop = None
        if ring is not None:
            ring.register(instance_id)
            self._heartbeat_stop = ring.start_heartbeat(instance_id)
        self.driver = CompactionDriver(db, db.compaction_cfg, owns=self.owns)
        self.cycle_s = cycle_s or db.compaction_cfg.cycle_s
        self._stop = threading.Event()
        self._thread = None

    def owns(self, job_hash: str) -> bool:
        if self.ring is None:
            return True
        return self.ring.owns(self.instance_id, job_token(job_hash))

    def run_once(self) -> int:
        jobs = self.driver.run_one_cycle()
        self.db.retain_once()
        return jobs

    def start(self):
        if self._thread:
            return

        def loop():
            while not self._stop.wait(self.cycle_s):
                try:
                    self.run_once()
                except Exception:
                    import logging

                    logging.getLogger(__name__).exception("compaction cycle failed")

        self._thread = threading.Thread(target=loop, daemon=True, name="compactor")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self._heartbeat_stop is not None:
            self._heartbeat_stop.set()
        if self.ring is not None:
            self.ring.unregister(self.instance_id)
