"""In-process sampling profiler and the device profile window for the
/status/profile and /status/profile/device endpoints.

Port of tempo_tpu/util/profiling.py. `sample_profile` is the same
sampler: every live thread's stack via sys._current_frames() at a fixed
rate for a bounded window, aggregated by frame (reference analog:
net/http/pprof, cmd/tempo/main.go:57,90), in two formats:
- text (default): human-readable hottest frames + hottest stacks;
- collapsed: one `frame;frame;...;frame count` line per distinct stack
  (Brendan Gregg's folded format), for flamegraph.pl / speedscope.

`capture_device_profile` is the accelerator-side window. Where the
reference runs jax.profiler, the port runs torch.profiler: the CPU
activity always, and the CUDA activity (CUPTI: every kernel the card
runs in the window, whoever launched it) when the App's device is a
CUDA device. The window starts once the profiler has started: a
process's first CUDA window first spends seconds starting CUPTI (8.3 s
on an H100 machine, `chip_smoke.py` phase 12). The window's Chrome trace
is written into a fresh `tempfile.mkdtemp` directory; the newest few
captures are kept, and none still in flight is pruned. Every
response carries the page-heat ledger's accesses over the same window
(`transferLedger`), so the kernel trace and the data movement it paid
for are one artifact.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import threading
import time
from collections import Counter

import torch

_STACK_DEPTH = 64


def _sample(seconds: float, hz: int):
    """(frame_hits, stack_hits, samples): stack_hits keys are FULL
    root->leaf semicolon-joined stacks (collapsed format needs the whole
    stack; the text report truncates for display)."""
    seconds = max(0.1, min(float(seconds), 60.0))
    interval = 1.0 / max(1, min(int(hz), 1000))
    me = threading.get_ident()
    frame_hits: Counter = Counter()
    stack_hits: Counter = Counter()
    samples = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = []
            f = frame
            while f is not None and len(stack) < _STACK_DEPTH:
                co = f.f_code
                entry = f"{co.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}:{co.co_name}"
                stack.append(entry)
                f = f.f_back
            if not stack:
                continue
            frame_hits[stack[0]] += 1
            stack_hits[";".join(reversed(stack))] += 1
            samples += 1
        time.sleep(interval)
    return frame_hits, stack_hits, samples


def sample_profile(seconds: float = 5.0, hz: int = 100, top: int = 40,
                   fmt: str = "text") -> str:
    """Sample all thread stacks for `seconds`.

    fmt="text": report of the hottest frames and hottest whole stacks.
    fmt="collapsed": semicolon-folded stacks with sample counts, one
    line each — standard flamegraph input."""
    frame_hits, stack_hits, samples = _sample(seconds, hz)
    if fmt == "collapsed":
        lines = [f"{stack} {n}" for stack, n in sorted(stack_hits.items())]
        return "\n".join(lines) + ("\n" if lines else "")
    lines = [f"# sampling profile: {seconds:.1f}s @ {hz}Hz, {samples} thread-samples"]
    lines.append("\n## hottest frames (leaf)")
    for entry, n in frame_hits.most_common(top):
        lines.append(f"{n:6d}  {entry}")
    lines.append("\n## hottest stacks (root->leaf, truncated)")
    for stack, n in stack_hits.most_common(10):
        parts = stack.split(";")
        shown = ";".join(parts[:10])
        lines.append(f"{n:6d}  {shown}")
    return "\n".join(lines) + "\n"


_DEVICE_PROFILE_PREFIX = "tempo-tpu-torch-device-profile-"
_DEVICE_PROFILE_KEEP = 3
# a capture lasts 30 s at most: a directory touched since is in flight
_DEVICE_PROFILE_IN_FLIGHT_S = 60.0
TRACE_FILE = "trace.json"


def _prune_device_profiles(keep: int = _DEVICE_PROFILE_KEEP) -> None:
    """Captures are per-request artifacts on a long-lived server: keep
    only the newest few so a dashboard probe hammering the endpoint
    can't fill the disk with profiler traces. A directory younger than
    a capture's longest window is never pruned: a concurrent capture
    (another request or process) may still be writing there."""
    root = tempfile.gettempdir()
    dirs = []
    try:
        names = [n for n in os.listdir(root) if n.startswith(_DEVICE_PROFILE_PREFIX)]
    except OSError:
        return
    for n in names:
        path = os.path.join(root, n)
        try:
            dirs.append((os.path.getmtime(path), path))
        except OSError:
            continue  # pruned by a concurrent capture
    dirs.sort()
    cutoff = time.time() - _DEVICE_PROFILE_IN_FLIGHT_S
    for mtime, stale in dirs[:-keep] if keep else dirs:
        if mtime < cutoff:
            shutil.rmtree(stale, ignore_errors=True)


def _ledger_window(mark: int) -> dict:
    """Transfer-ledger view of the capture window: which (block, column)
    pages shipped while the profiler ran."""
    from tempo_tpu_torch.util import pageheat

    return pageheat.LEDGER.window_report(mark)


def capture_device_profile(seconds: float = 1.0, out_dir: str | None = None,
                           device=None) -> dict:
    """Bounded torch.profiler capture of whatever runs in the window on
    `device` (a torch.device or name; None: the CPU activity alone),
    written as a Chrome trace (`trace.json`, for chrome://tracing or
    Perfetto). Degrades to {"supported": False, "error": ...} when the
    profiler cannot start or stop (another capture holds it), because
    an admin endpoint that 500s under the conditions it exists to debug
    is worse than useless."""
    seconds = max(0.1, min(float(seconds), 30.0))
    from tempo_tpu_torch.util import pageheat

    mark = pageheat.LEDGER.mark()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if out_dir is None:
        # mkdtemp: unique under rapid successive captures; old captures
        # are pruned
        out_dir = tempfile.mkdtemp(prefix=_DEVICE_PROFILE_PREFIX)
        _prune_device_profiles()
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except RuntimeError as e:
        return {"supported": False, "error": f"profiler start failed: {e}",
                "transferLedger": _ledger_window(mark)}
    try:
        time.sleep(seconds)
    finally:
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
        except RuntimeError as e:
            return {"supported": False, "error": f"profiler stop failed: {e}",
                    "dir": out_dir, "transferLedger": _ledger_window(mark)}
    files = []
    for root, _dirs, names in os.walk(out_dir):
        for n in names:
            files.append(os.path.relpath(os.path.join(root, n), out_dir))
    return {
        "supported": True,
        "seconds": seconds,
        "dir": out_dir,
        "files": sorted(files)[:200],
        "hint": f"load {TRACE_FILE} in chrome://tracing or Perfetto",
        "transferLedger": _ledger_window(mark),
    }
