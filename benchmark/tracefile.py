"""Reduces a torch.profiler Chrome trace to the device's busy time.

The busy time is the union of the intervals of the card's kernels, copies
and memsets (the arithmetic of `tools/profile_torch_port.py`'s
`device_busy`, copied here so that the yardstick stays with the
benchmark). Besides it: device time by kernel name, the device operations
that took most time, and the longest idle gaps, each named by the host
operation that covered most of it.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_name(events: list, a: float, b: float) -> str:
    """The host op (outermost, longest overlap) running over [a, b]."""
    best, best_len = "host: no traced op", 0.0
    for e in events:
        lo, hi = max(a, e["ts"]), min(b, e["ts"] + e["dur"])
        if hi - lo > best_len:
            best, best_len = "host: " + e["name"], hi - lo
    return best


def reduce(path: str) -> dict:
    """{busy_s, kernel_us, device_ops, idle_gaps, n_device} of the trace
    at path (the profiler's window is the measured window)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append(e)
        elif e.get("cat") in ("cpu_op", "user_annotation", "python_function"):
            host.append(e)
    by_name: dict = {}
    spans = []
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
        spans.append((a, b))
    busy = _union(spans)
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "n_device": len(spans),
        "kernel_us": by_name,
        "device_ops": [[k, v / 1e6] for k, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[_host_name(host, a, b), (b - a) / 1e6] for a, b in gaps],
    }
