"""Device dispatch timing and transfer accounting, slim.

Port of tempo_tpu/util/devicetiming.py (timed_dispatch, count_transfer,
count_avoided, transfer_report).
A dispatch's wall clock closes only when its work is done: on CUDA the
seam calls torch.cuda.synchronize() where the JAX package called
jax.block_until_ready. Totals accumulate in a DeviceStats object
(`STATS`), and each dispatch lands in the request's stage waterfall
(`kernel`, one dispatch; util/stagetimings) and its cost vector
(`device_seconds`, `device_dispatches`, and `transfer_bytes` from
count_transfer; util/usage), which the query responses report as
`deviceDispatches`. Bytes that a dispatch found already on the device
count as `resident`, never as movement, and the h2d bytes that the
device tier's resident pages spared count as `avoided`; transfer_report
rolls them up for /status/device as the reference does. The Prometheus
families are not ported yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from tempo_tpu_torch.util import stagetimings, usage


@dataclass
class DeviceStats:
    """Per-kernel dispatch counts, seconds and bytes moved."""

    dispatches: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)
    h2d: dict = field(default_factory=dict)
    d2h: dict = field(default_factory=dict)
    resident: dict = field(default_factory=dict)
    avoided: dict = field(default_factory=dict)


STATS = DeviceStats()


def _add(d: dict, key: str, v) -> None:
    d[key] = d.get(key, 0) + v


def count_transfer(kernel: str, h2d: int = 0, d2h: int = 0, resident: int = 0) -> None:
    """Account the bytes one dispatch moved host->device and back, in
    the totals and, as the reference does, in the active cost vector's
    `transfer_bytes`. Resident bytes (inputs already on the device) are
    reuse, not movement, and are never charged."""
    if h2d:
        _add(STATS.h2d, kernel, int(h2d))
    if d2h:
        _add(STATS.d2h, kernel, int(d2h))
    if resident:
        _add(STATS.resident, kernel, int(resident))
    if h2d or d2h:
        usage.charge("transfer_bytes", int(h2d) + int(d2h))


def count_avoided(kernel: str, nbytes: int) -> None:
    """One resident-tier serve spared `nbytes` of h2d: what the host path
    would have shipped, kept apart from the movement totals."""
    if nbytes:
        _add(STATS.avoided, kernel, int(nbytes))


def transfer_report() -> dict:
    """Per-kernel movement rollup for /status/device, in the reference's
    layout."""
    by_kernel: dict = {}
    totals = {"h2d": 0, "d2h": 0, "resident": 0}
    for direction in totals:
        for k, v in dict(getattr(STATS, direction)).items():
            by_kernel.setdefault(k, {"h2d": 0, "d2h": 0, "resident": 0})[direction] = int(v)
            totals[direction] += int(v)
    avoided = {k: int(v) for k, v in dict(STATS.avoided).items()}
    return {
        "byKernel": by_kernel,
        "totals": {**totals, "moved": totals["h2d"] + totals["d2h"],
                   "avoided": sum(avoided.values())},
        "avoidedByKernel": avoided,
        "dispatchesByKernel": {k: int(v) for k, v in dict(STATS.dispatches).items()},
    }


def timed_dispatch(kernel: str, fn, *args, device: torch.device, stream=None, **kwargs):
    """Run fn(*args, **kwargs) as one device dispatch and record its wall
    clock, waiting for its work first when `device` is a CUDA device so
    that the time includes the work, not just its launch: on an event of
    `stream` when one is given (the dispatch ran there), else on the
    whole device."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
        if device.type == "cuda":
            if stream is None:
                torch.cuda.synchronize(device)
            else:
                done = torch.cuda.Event()
                done.record(stream)
                done.synchronize()
        return out
    finally:
        dt = time.perf_counter() - t0
        _add(STATS.seconds, kernel, dt)
        _add(STATS.dispatches, kernel, 1)
        stagetimings.add("kernel", dt)
        stagetimings.count_dispatch()
        usage.charge("device_seconds", dt)
        usage.charge("device_dispatches")
