"""Small pieces shared by the harness and the processes it starts."""

from __future__ import annotations

import errno
import json
import os
import socket
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tempo_tpu")


def jax_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (`tempo_tpu_torch` is the program and is allowed)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_env() -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(ROOT, ".bench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}


def device_info(device: str) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def touch(path: str) -> None:
    with open(path, "w"):
        pass


def signal(path: str, alive, timeout: float = 120.0) -> None:
    """Opens and closes the FIFO at path for writing, which wakes the one
    thread blocked reading it; waits, while alive() holds, for that reader."""
    deadline = time.perf_counter() + timeout
    while True:
        try:
            os.close(os.open(path, os.O_WRONLY | os.O_NONBLOCK))
            return
        except OSError as e:
            if e.errno != errno.ENXIO or not alive() or time.perf_counter() > deadline:
                raise RuntimeError(f"no reader of {os.path.basename(path)}") from e
        time.sleep(0.01)


def write_json(path: str, doc) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def server_yaml(server: dict, run_dir: str) -> str:
    """The configuration's server YAML, its local backend and WAL under
    run_dir (`{run_dir}` in a string value is replaced)."""
    def fill(v):
        if isinstance(v, dict):
            return {k: fill(x) for k, x in v.items()}
        return v.replace("{run_dir}", run_dir) if isinstance(v, str) else v

    import yaml

    return yaml.safe_dump(fill(server), sort_keys=False)
