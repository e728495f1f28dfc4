"""The device-trace arithmetic: the busy union, time by kernel, idle gaps
named by the host op over them, and a roofline share that finds nothing
to read returning nothing."""

import json

from benchmark import roofline, tracefile


def test_busy_union_kernel_time_and_idle_gaps(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 100, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 10, "dur": 95},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = tracefile.reduce(str(path))
    assert tr["busy_s"] == 20e-6 and tr["n_device"] == 3
    assert tr["kernel_us"] == {"k": 15.0, "m": 10.0}
    assert tr["idle_gaps"] == [["host: aten::x", 85e-6]]


def test_roofline_share():
    totals = {"compiled_metrics": {"calls": 2, "bytes": 3.35e6, "ops": 1}}
    kernels = {"compiled_prepare_kernel(x)": 0.5, "compiled_count_kernel(y)": 1.5,
               "other_kernel": 100.0}
    # 1 us of bytes at 3.35 TB/s over 2 us of the op's kernels
    assert abs(roofline.share(totals, kernels, ("compiled_metrics",)) - 50.0) < 1e-9
    assert roofline.share({}, kernels, ("compiled_metrics",)) is None
    assert roofline.share(totals, {"other_kernel": 1.0}, ("compiled_metrics",)) is None
