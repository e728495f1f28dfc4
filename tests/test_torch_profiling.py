"""The port's /status/profile and /status/profile/device
(tempo_tpu_torch/util/profiling.py) against the JAX package's, on the CPU.

The host sampler is the reference's: both formats (the text report and
the collapsed stacks) catch a busy thread, and the routes answer the same
400s on both Apps. The device window runs torch.profiler where the
reference runs jax.profiler: on the CPU it records the CPU activity and
answers `supported: true` with a Chrome trace among its files and the
page-heat ledger's window (`transferLedger`) in the reference's layout;
its keys are the reference's. Old captures are pruned to the newest
three, a capture still in flight never. The window on the card, with the hand kernels in its trace, is a
`cuda` test in tests/test_torch_tail_kernels.py.
"""

import json
import os
import tempfile
import threading
import time

import pytest

from tempo_tpu.util import profiling as jprofiling
from tempo_tpu_torch.util import profiling

from test_torch_app import _no_prefetch, idle_pair  # noqa: F401 (fixtures)


def _spin_marker_fn(stop):
    while not stop.is_set():
        sum(range(1000))


@pytest.fixture
def busy():
    stop = threading.Event()
    t = threading.Thread(target=_spin_marker_fn, args=(stop,), daemon=True)
    t.start()
    yield
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("mod", [jprofiling, profiling], ids=["jax", "port"])
def test_sample_profile_text(busy, mod):
    out = mod.sample_profile(0.3, hz=200, fmt="text")
    assert out.startswith("# sampling profile: 0.3s @ 200Hz, ")
    assert "## hottest frames (leaf)" in out and "## hottest stacks" in out
    assert "_spin_marker_fn" in out


@pytest.mark.parametrize("mod", [jprofiling, profiling], ids=["jax", "port"])
def test_sample_profile_collapsed(busy, mod):
    lines = mod.sample_profile(0.3, hz=200, fmt="collapsed").splitlines()
    assert lines and all(line.rsplit(" ", 1)[1].isdigit() for line in lines)
    assert any("_spin_marker_fn" in line.split(";")[-1] for line in lines)


@pytest.mark.parametrize("path", [
    "/status/profile?seconds=abc", "/status/profile?hz=x", "/status/profile?fmt=pprof",
    "/status/profile/device?seconds=abc",
])
def test_profile_400(idle_pair, path):
    status, _ = idle_pair.same("GET", path)
    assert status == 400


def test_profile_routes_served(idle_pair):
    for path in ("/status/profile?seconds=0.2", "/status/profile?seconds=0.2&fmt=collapsed"):
        (js, jh, _), (ts, th, tb) = idle_pair.both("GET", path)
        assert js == ts == 200 and jh["Content-Type"] == th["Content-Type"]
    (js, _, jb), (ts, _, tb) = idle_pair.both("GET", "/status/profile/device?seconds=0.2")
    jdoc, tdoc = json.loads(jb), json.loads(tb)
    assert js == ts == 200 and jdoc["supported"] and tdoc["supported"]
    assert set(jdoc) == set(tdoc)
    assert set(jdoc["transferLedger"]) == set(tdoc["transferLedger"])
    assert tdoc["files"] == [profiling.TRACE_FILE]


def test_device_profile_on_the_cpu():
    doc = profiling.capture_device_profile(0.2, device="cpu")
    assert doc["supported"] is True and doc["seconds"] == 0.2
    assert doc["files"] == ["trace.json"] and os.path.isdir(doc["dir"])
    with open(os.path.join(doc["dir"], "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    assert set(doc["transferLedger"]) == {"sinceSeq", "accesses", "movedBytes", "pages"}
    # the window is clamped as the reference's
    t0 = time.monotonic()
    assert profiling.capture_device_profile(0.0)["seconds"] == 0.1
    assert time.monotonic() - t0 < 10


def test_old_captures_pruned(tmp_path, monkeypatch):
    """The newest three captures stay; so does any capture younger than
    a window's longest (one another request may still be writing)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    dirs = [profiling.capture_device_profile(0.1)["dir"] for _ in range(5)]
    assert all(os.path.isdir(d) for d in dirs)  # all in flight a minute ago
    for age, d in enumerate(reversed(dirs), start=2):
        os.utime(d, (time.time() - 60 * age,) * 2)
    dirs.append(profiling.capture_device_profile(0.1)["dir"])
    assert [os.path.isdir(d) for d in dirs] == [False, False, False, True, True, True]


def test_profiler_busy_degrades(monkeypatch):
    class Held:
        def __init__(self, **_):
            pass

        def start(self):
            raise RuntimeError("another profiler is running")

    monkeypatch.setattr(profiling.torch.profiler, "profile", Held)
    doc = profiling.capture_device_profile(0.1)
    assert doc["supported"] is False and "another profiler" in doc["error"]
    assert "transferLedger" in doc
