"""The process-wide device dispatch lock.

Port of `dispatch_lock` from tempo_tpu/parallel/search.py, on one device:
every device-program dispatcher of the process serialises on this one
lock (the compiled query tier here; the mesh searcher and the mesh
metrics evaluator when the multi-GPU slice lands, ROADMAP Queue 1 item
12). On one card it keeps the compiled tier's launches from interleaving
with each other's host reads of the counts.
"""

from __future__ import annotations

import threading

dispatch_lock = threading.Lock()
