"""Device dispatch timing and transfer accounting, slim.

Port of tempo_tpu/util/devicetiming.py (timed_dispatch, count_transfer,
count_avoided, transfer_report, moved_total, avoided_total and the
four Prometheus families).
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
rolls them up for /status/device as the reference does. The reference's
four families live in util/metrics' registry, so /metrics exposes them
from the module's import (app.py imports it at boot):

  tempo_tpu_device_dispatch_seconds{kernel}                  histogram
  tempo_tpu_device_dispatches_total{kernel}                  counter
  tempo_tpu_device_transfer_bytes_total{direction,kernel}    counter
      direction: h2d, d2h, resident
  tempo_tpu_device_transfer_bytes_avoided_total{kernel}      counter

Each moves in the statement that updates STATS and charges the cost
vector, so the per-tenant `transfer_bytes` sum to h2d + d2h exactly
(the reference's exactness contract).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import torch

from tempo_tpu_torch.util import metrics, stagetimings, usage

dispatch_hist = metrics.histogram(
    "tempo_tpu_device_dispatch_seconds",
    "Wall-clock seconds per host-level device dispatch, by kernel label "
    "(transfer + kernel execution + compile-cache lookup + "
    "block_until_ready; the transfer/kernel split rides the query "
    "waterfall stages)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0, 10.0),
)
dispatch_total = metrics.counter(
    "tempo_tpu_device_dispatches_total",
    "Host-level device dispatches, by kernel label",
)
transfer_bytes_total = metrics.counter(
    "tempo_tpu_device_transfer_bytes_total",
    "Bytes crossing (h2d|d2h) or parked at (resident) the host<->device "
    "boundary per host-level dispatch, by direction and kernel label",
)
transfer_avoided_bytes_total = metrics.counter(
    "tempo_tpu_device_transfer_bytes_avoided_total",
    "H2D bytes NOT moved because the scan was served from the "
    "device-resident hot tier (what the host path would have shipped), "
    "by kernel label — the hot tier's measured win",
)


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


_STATS_LOCK = threading.Lock()


def _add(d: dict, key: str, v) -> None:
    # dispatches run on several worker threads: a lost update would part
    # STATS from the families beside it
    with _STATS_LOCK:
        d[key] = d.get(key, 0) + v


def count_transfer(kernel: str, h2d: int = 0, d2h: int = 0, resident: int = 0) -> None:
    """Account the bytes one dispatch moved host->device and back, in
    the totals and, as the reference does, in the active cost vector's
    `transfer_bytes`. Resident bytes (inputs already on the device) are
    reuse, not movement, and are never charged."""
    if h2d:
        _add(STATS.h2d, kernel, int(h2d))
        transfer_bytes_total.inc(int(h2d), direction="h2d", kernel=kernel)
    if d2h:
        _add(STATS.d2h, kernel, int(d2h))
        transfer_bytes_total.inc(int(d2h), direction="d2h", kernel=kernel)
    if resident:
        _add(STATS.resident, kernel, int(resident))
        transfer_bytes_total.inc(int(resident), direction="resident", kernel=kernel)
    if h2d or d2h:
        usage.charge("transfer_bytes", int(h2d) + int(d2h))


def count_avoided(kernel: str, nbytes: int) -> None:
    """One resident-tier serve spared `nbytes` of h2d: what the host path
    would have shipped, kept apart from the movement totals."""
    if nbytes:
        _add(STATS.avoided, kernel, int(nbytes))
        transfer_avoided_bytes_total.inc(int(nbytes), kernel=kernel)


def avoided_total() -> float:
    """Lifetime h2d bytes the hot tier spared."""
    return transfer_avoided_bytes_total.total()


def moved_total() -> float:
    """Bytes actually moved (h2d + d2h; resident excluded): what the
    per-tenant `transfer_bytes` vectors must sum to."""
    return (transfer_bytes_total.total(direction="h2d")
            + transfer_bytes_total.total(direction="d2h"))


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
        dispatch_hist.observe(dt, kernel=kernel)
        dispatch_total.inc(kernel=kernel)
        stagetimings.add("kernel", dt)
        stagetimings.count_dispatch()
        usage.charge("device_seconds", dt)
        usage.charge("device_dispatches")
