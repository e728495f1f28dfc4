"""The card's peaks, and the bytes and operations of a call into each hand
kernel that a per-layer metric divides by its device time.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at its 700 W limit:
3.35 TB/s of HBM and 67 TOP/s outside the tensor cores. A call's least
time is the larger of its bytes over the first and its operations over
the second. Bytes count every input tensor or array read once and every
output written once, as the call's arguments give them (padding
included); operations count one compare a row for each query lane and
column it tests, and two more a row to bin and count it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12


def _nbytes(x) -> int:
    if hasattr(x, "element_size") and hasattr(x, "numel"):
        return int(x.element_size() * x.numel())
    if hasattr(x, "nbytes") and hasattr(x, "dtype"):
        return int(x.nbytes)
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _numel(x) -> int:
    return int(x.numel()) if hasattr(x, "numel") else 0


def compiled_metrics(args, kwargs, out) -> dict:
    """compiled_metrics(sig, t_s, valid, payloads, qargs, tb, nb) ->
    (Q, slot_pad) counts. Rows: the stacked units' rows; each query lane
    tests each column once a row, then bins and counts it."""
    sig, t_s = args[0], args[1]
    n_cols = len(sig[0])
    q = int(args[5].shape[0])
    rows = _numel(t_s)
    return {"bytes": _nbytes(args[1:]) + _nbytes(out), "ops": rows * q * (n_cols + 2)}


OPS = {
    "compiled_metrics": {"module": "tempo_tpu_torch.compiled.program", "count": compiled_metrics,
                         "kernels": ("compiled_prepare_kernel", "compiled_count_kernel")},
}


def least_seconds(totals: dict) -> tuple:
    """(seconds, "bytes" or "ops") of a recorder total."""
    by_bytes = totals["bytes"] / HBM_BYTES_PER_S
    by_ops = totals["ops"] / INT_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "ops")


def kernel_seconds(kernel_us: dict, names: tuple) -> float:
    """Device seconds of the trace's kernels whose name holds one of names."""
    return sum(us for k, us in kernel_us.items() if any(n in k for n in names)) / 1e6


def share(totals: dict, kernel_us: dict, ops: tuple) -> float | None:
    """Percent of the roofline: the least time of the ops' calls over the
    device time of their kernels; None where either is absent."""
    calls = [totals[op] for op in ops if op in totals]
    names = tuple(k for op in ops for k in OPS[op]["kernels"])
    dev = kernel_seconds(kernel_us, names)
    if not calls or dev <= 0:
        return None
    least = sum(least_seconds(c)[0] for c in calls)
    return 100.0 * least / dev
