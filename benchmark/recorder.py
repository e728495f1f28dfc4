"""Records the shapes of each call into the port's hand kernels.

`install()` wraps the Python entry of each op named in `roofline.OPS`
in its module of `tempo_tpu_torch`, before the server or the engine
runs. Each call adds its least time on the card (the roofline bound of
its inputs' and output's bytes and its operations) to a per-op total, so
a reader can divide the totals of a window by the kernels' device time
in the trace of the same window.
"""

from __future__ import annotations

import functools
import importlib
import threading

from benchmark import roofline


class Recorder:
    def __init__(self):
        self._lock = threading.Lock()
        self.totals: dict = {}

    def add(self, op: str, bound: dict) -> None:
        with self._lock:
            t = self.totals.setdefault(op, {"calls": 0, "bytes": 0, "ops": 0})
            t["calls"] += 1
            t["bytes"] += bound["bytes"]
            t["ops"] += bound["ops"]

    def snapshot(self) -> dict:
        with self._lock:
            return {op: dict(t) for op, t in self.totals.items()}


def delta(after: dict, before: dict) -> dict:
    out = {}
    for op, t in after.items():
        b = before.get(op, {})
        d = {k: v - b.get(k, 0) for k, v in t.items()}
        if d["calls"]:
            out[op] = d
    return out


def _wrap(rec: Recorder, op: str, fn):
    count = roofline.OPS[op]["count"]

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        rec.add(op, count(args, kwargs, out))
        return out

    return wrapper


def install(rec: Recorder) -> None:
    for op, spec in roofline.OPS.items():
        mod = importlib.import_module(spec["module"])
        setattr(mod, op, _wrap(rec, op, getattr(mod, op)))
