"""Port of tempo_tpu/db/pool.py, copied as is (host code).

Bounded worker pool with early exit.

Reference: tempodb/pool/pool.go:81 (RunJobs: bounded goroutines, stop
dispatching once a result is found) — used to parallelize per-block
queries. Python threads are fine here: block queries are IO-bound
(object-store reads) and the numpy/torch work releases the GIL.
"""

from __future__ import annotations

import contextvars
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait


class JobPool:
    def __init__(self, max_workers: int = 8):
        self.max_workers = max_workers

    def run_jobs(self, jobs, stop_when=None):
        """Run callables concurrently; returns (results, errors).

        stop_when(result) -> True stops dispatch + collection early
        (trace-by-ID stops at the first block that has the full trace).
        Results keep job order where completed; None results are skipped.
        """
        results, errors = [], []
        if not jobs:
            return results, errors
        stop = threading.Event()
        # propagate the caller's context (the request's deadline scope,
        # util/deadline.py) into worker threads: a block read running on
        # behalf of a deadlined query must see that deadline
        ctx = contextvars.copy_context()

        def wrap(fn):
            def run():
                if stop.is_set():
                    return None
                return ctx.copy().run(fn)

            return run

        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            futures = [ex.submit(wrap(j)) for j in jobs]
            pending = set(futures)
            while pending and not stop.is_set():
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for f in done:
                    try:
                        r = f.result()
                    except Exception as e:  # propagate after the loop
                        errors.append(e)
                        continue
                    if r is None:
                        continue
                    results.append(r)
                    if stop_when is not None and stop_when(r):
                        stop.set()
            # drain remaining completed futures without blocking on stop
            for f in pending:
                f.cancel()
        return results, errors
