"""Mesh construction and the one runner the sharded programs share.

Port of tempo_tpu/parallel/mesh.py. One mesh, up to two axes:
- "range": block/ID-range shards — the axis sketch/bloom merges and hit
  counts reduce over;
- "window": independent compaction windows / job parallelism (no
  reduction crosses it, except where a caller asks for both axes).

The JAX package drives every local chip from one process through
`shard_map`; the port does the same from one process over a list of
torch devices. A Mesh is a (W, R) array of torch.devices; a device may
repeat, so one card can hold every shard (each shard's launches then
queue on that card), and the CPU tests build an 8-shard mesh of "cpu"
devices as the JAX tests build 8 virtual ones. `shard_map_compat` has
no counterpart: `map_shards` calls a per-shard function on each shard's
device, and `reduce_range` / `reduce_all` merge the shards' outputs
(SUM, MAX or OR) by copying each partial to the window's lead device
(the first shard of the window, or of the mesh) and reducing there —
plain device-to-device copies, no NCCL.

`local_devices(device)` is the seam every caller reads the available
devices from: every card of torch.cuda.device_count() for a CUDA
device, the one device otherwise. Tests monkeypatch it to a list of
eight "cpu" devices.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

RANGE_AXIS = "range"
WINDOW_AXIS = "window"

_MASK32 = 0xFFFFFFFF


class Mesh:
    """(W, R) devices under the axis names ("window", "range")."""

    def __init__(self, devices):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"mesh devices must be a non-empty (W, R) array, got {arr.shape}")
        self.devices = arr
        self.shape = {WINDOW_AXIS: arr.shape[0], RANGE_AXIS: arr.shape[1]}
        self.flat_devices = [arr[w, r] for w in range(arr.shape[0]) for r in range(arr.shape[1])]

    @property
    def size(self) -> int:
        return len(self.flat_devices)

    def window_lead(self, w: int) -> torch.device:
        """The device a window's range reductions land on."""
        return self.devices[w, 0]

    @property
    def lead(self) -> torch.device:
        return self.devices[0, 0]

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.flat_devices]})"


def local_devices(device) -> list:
    """The devices a mesh may be built from, for a DB or App whose device
    is `device`: every card for CUDA, the one device otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def mesh_shape_for(n_devices: int) -> tuple[int, int]:
    """(window, range) shape: prefer 2 windows when devices allow."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return (2, n_devices // 2)
    return (1, n_devices)


def _pick(n_devices: int | None, devices) -> list:
    devs = list(devices) if devices is not None else local_devices("cuda")
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    return devs[:n]


def get_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Mesh of the first n devices (default: every card), shaped by
    mesh_shape_for. `devices` may repeat a device."""
    devs = _pick(n_devices, devices)
    w, r = mesh_shape_for(len(devs))
    arr = np.empty((w, r), dtype=object)
    for i, d in enumerate(devs):
        arr[i // r, i % r] = d
    return Mesh(arr)


def compaction_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Single-job mesh: one window, all devices on the range axis (the
    compaction driver runs one job at a time, so every device takes an
    ID-range shard of that job)."""
    devs = _pick(n_devices, devices)
    arr = np.empty((1, len(devs)), dtype=object)
    for i, d in enumerate(devs):
        arr[0, i] = d
    return Mesh(arr)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def on_device(dev: torch.device):
    """Make `dev` the current CUDA device for the launches inside (the
    kernels launch on the current device's stream); a no-op on the CPU."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            yield
    else:
        yield


def map_shards(mesh: Mesh, fn) -> list:
    """[fn(s, device) for every shard s in (window, range) order], each
    call made with its device current."""
    out = []
    for s, dev in enumerate(mesh.flat_devices):
        with on_device(dev):
            out.append(fn(s, dev))
    return out


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "sum":
        return a + b
    if op == "sum32":  # uint32 counters held in int64: the add wraps
        return (a + b) & _MASK32
    if op == "max":
        return torch.maximum(a, b)
    if op == "or":
        return a | b
    raise ValueError(f"unknown reduction {op!r}")


def _reduce(parts: list, op: str, dev: torch.device) -> torch.Tensor:
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = _combine(op, acc, p.to(dev))
    return acc


def reduce_range(mesh: Mesh, partials: list, op: str) -> list:
    """Merge per-shard partials over the range axis: one tensor a window,
    on the window's lead device (the psum/pmax of the JAX programs)."""
    r = mesh.shape[RANGE_AXIS]
    return [
        _reduce(partials[w * r:(w + 1) * r], op, mesh.window_lead(w))
        for w in range(mesh.shape[WINDOW_AXIS])
    ]


def reduce_all(mesh: Mesh, partials: list, op: str) -> torch.Tensor:
    """Merge per-shard partials over both axes, on the mesh's lead device."""
    return _reduce(partials, op, mesh.lead)


def to_shard(a, dev: torch.device) -> torch.Tensor:
    """One shard's host slice (numpy) -> tensor on its device; uint32 ride
    as int32 bits, tensors move as they are."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a broadcast view: torch wants its own copy
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)
