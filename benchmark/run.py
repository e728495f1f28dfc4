"""One run of one cell of the port's benchmark (BENCHMARK.json).

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks` (each number compared beside its limit, also the last
lines of standard error). Needs an NVIDIA card: without one it exits 2 and
prints no result.
"""

import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
