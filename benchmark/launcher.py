"""The server process of a query cell.

    python3 benchmark/launcher.py --config FILE --seed N --dir RUN_DIR --port P --trace 0|1

Writes the configuration's blocks from the seed through the port's flush
path (`TempoDB.write_batch`, on the card), installs the kernel-call
recorder, then runs the port's own entry point (`tempo_tpu_torch.__main__`)
over the same backend directory with the configuration's YAML. Before the
entry point's loops start, the blocklist is polled once, the state that a
deployment reaches at its first poll.

It answers the harness through files in RUN_DIR: the FIFO `window_start`
(reset the recorder; with --trace 1, open one torch.profiler window of CPU
and CUDA activities) answered by `window_started`, and the FIFO
`window_stop` answered by `window.json` (the recorder's totals over the
window, the peak device memory, the card's name, the window's length on
the host clock, any JAX module loaded) and, traced, `trace.json`. Both
FIFOs are read blocking, so nothing polls in the served process.
SIGTERM stops the server.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402


def write_blocks(cfg: dict, seed: int, run_dir: str, device: str) -> None:
    from benchmark import adapter, datasets
    from tempo_tpu_torch.db import DBConfig, TempoDB

    db = TempoDB(DBConfig(backend="local", backend_path=os.path.join(run_dir, "blocks"),
                          wal_path=os.path.join(run_dir, "wal")), device=device)
    try:
        for block in datasets.blocks(cfg, seed):
            db.write_batch(cfg["tenant"], adapter.span_batch(block))
    finally:
        db.shutdown()


def _poll_first(app_cls) -> None:
    start_loops = app_cls.start_loops

    def polled(self):
        if self.db is not None:
            self.db.poll_now()
        return start_loops(self)

    app_cls.start_loops = polled


def _wait_for(path: str) -> None:
    """Blocks, without waking, until the harness signals the FIFO at path."""
    with open(path, "rb") as f:
        f.read()


def control(run_dir: str, trace: bool, rec, device: str) -> None:
    import torch

    from benchmark import recorder

    _wait_for(os.path.join(run_dir, "window_start"))
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    before = rec.snapshot()
    t0 = time.perf_counter()
    common.touch(os.path.join(run_dir, "window_started"))
    _wait_for(os.path.join(run_dir, "window_stop"))
    if device == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    calls = recorder.delta(rec.snapshot(), before)
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(run_dir, "trace.json"))
    out = {"window_s": window_s, "calls": calls, "jax_modules": common.jax_modules(),
           **common.device_info(device)}
    common.write_json(os.path.join(run_dir, "window.json"), out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)

    from benchmark import faults, recorder

    rec = recorder.Recorder()
    recorder.install(rec)
    faults.install(args.fault)
    write_blocks(cfg, args.seed, args.dir, args.device)
    yaml_path = os.path.join(args.dir, "tempo.yaml")
    with open(yaml_path, "w") as f:
        f.write(common.server_yaml(cfg["server"], args.dir))

    from tempo_tpu_torch import __main__ as entry
    from tempo_tpu_torch.app import App

    _poll_first(App)
    for name in ("window_start", "window_stop"):
        os.mkfifo(os.path.join(args.dir, name))
    threading.Thread(target=control, args=(args.dir, bool(args.trace), rec, args.device),
                     daemon=True, name="bench-control").start()
    argv = ["-config.file", yaml_path, "-server.http-listen-port", str(args.port)]
    if args.device != "cuda":
        argv += ["-device", args.device]
    return entry.main(argv)


if __name__ == "__main__":
    sys.exit(main())
