"""Trace-graph kernels: parent rank-join, self-time, and the
pointer-doubling critical-path accumulation (host and device arms).

Port of tempo_tpu/ops/graph.py (parent_row_join, self_times_ns,
_n_rounds, root_path_sums_host, the device arm and critical_path). The
rank-join and self times are host numpy, as in the reference. The root
path sums have three arms that give the same uint64 sums bit for bit:

- root_path_sums_host: numpy, with an early exit once every pointer is
  -1 (the reference's host arm);
- _root_path_sums_plain: the same rounds as torch ops, every round run
  (the reference's jitted device arm did the same with two uint32 limbs
  and a carry; int64 adds wrap mod 2**64 exactly as the limbs do);
- the root_path_sums kernel: CUDA C++ (csrc/graph_sketch_kernels.cu),
  one launch a round over ping-pong buffers.

root_path_sums, the wrapper, takes the plain version only for tensors on
the CPU and launches the kernel for CUDA tensors or raises; it counts
its calls that launched in `root_path_sums.launches` and its kernel
launches in `root_path_sums.kernel_launches`.

The arm follows the device the caller passes (the querier passes its
DB's device): a CUDA device runs the kernel under
timed_dispatch("graph_critical_path"), the CPU or no device the host
arm. TEMPO_TPU_GRAPH_DEVICE=0 forces the host arm, as in the reference.
The reference picks by its backend instead (device_enabled(): a TPU).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from tempo_tpu_torch.ops import _build

# ---------------------------------------------------------------------------
# parent rank-join
# ---------------------------------------------------------------------------


def parent_row_join(seg: np.ndarray, span_id: np.ndarray,
                    parent_id: np.ndarray) -> np.ndarray:
    """Row index of each span's parent within its trace segment, -1 when
    the parent id resolves to no span. One rank-compress + searchsorted
    join over the whole batch (the traceql/vector parent_rows idiom);
    duplicate span ids within a trace resolve to the LAST row, matching
    the object engine's dict insert order."""
    n = len(seg)
    if n == 0:
        return np.empty(0, np.int64)
    sidp = (span_id[:, 0].astype(np.uint64) << np.uint64(32)) | span_id[:, 1]
    parp = (parent_id[:, 0].astype(np.uint64) << np.uint64(32)) | parent_id[:, 1]
    uniq = np.unique(np.concatenate([sidp, parp]))
    k = np.int64(len(uniq) + 1)
    skey = seg.astype(np.int64) * k + np.searchsorted(uniq, sidp)
    qkey = seg.astype(np.int64) * k + np.searchsorted(uniq, parp)
    order = np.argsort(skey, kind="stable")
    sk = skey[order]
    p = np.searchsorted(sk, qkey, side="right") - 1
    safe = np.maximum(p, 0)
    ok = (p >= 0) & (sk[safe] == qkey)
    # a self-parenting span (malformed data) would never terminate the
    # path walk; treat it as a root
    out = np.where(ok, order[safe], -1)
    return np.where(out == np.arange(n), -1, out)


# ---------------------------------------------------------------------------
# self time
# ---------------------------------------------------------------------------


def self_times_ns(parent: np.ndarray, duration: np.ndarray) -> np.ndarray:
    """Per-span self time: duration minus the summed durations of direct
    children, clamped at zero (overlapping/async children can exceed the
    parent). uint64 nanoseconds in, uint64 out."""
    n = len(parent)
    dur = duration.astype(np.uint64)
    child_sum = np.zeros(n, np.uint64)
    has = parent >= 0
    np.add.at(child_sum, parent[has], dur[has])
    return np.where(child_sum >= dur, np.uint64(0), dur - child_sum)


# ---------------------------------------------------------------------------
# pointer-doubling root-path accumulation
# ---------------------------------------------------------------------------


def _n_rounds(n: int) -> int:
    """log2(n)+1 doubling rounds cover any simple path; the fixed cap
    also terminates on pathological parent-id cycles (extra rounds are
    no-ops once pointers hit -1)."""
    return max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)


def root_path_sums_host(parent: np.ndarray, self_ns: np.ndarray) -> np.ndarray:
    """acc[i] = self time summed over i and every ancestor of i (uint64
    ns). Invariant after k rounds: acc covers distance 0..2^k-1, p[i] is
    the ancestor at distance 2^k (or -1)."""
    acc = self_ns.astype(np.uint64).copy()
    p = parent.astype(np.int64).copy()
    for _ in range(_n_rounds(len(parent))):
        if not (p >= 0).any():
            break
        safe = np.maximum(p, 0)
        acc = acc + np.where(p >= 0, acc[safe], np.uint64(0))
        p = np.where(p >= 0, p[safe], -1)
    return acc


def _root_path_sums_plain(parent: torch.Tensor, self_ns: torch.Tensor,
                          rounds: int) -> torch.Tensor:
    """Plain version of the root_path_sums kernel: `rounds` doubling
    rounds, each reading the round before's acc and p. parent: (n,)
    int32; self_ns: (n,) int64 holding uint64 bits. Returns (n,) int64
    of uint64 bits."""
    acc = self_ns.to(torch.int64).clone()
    p = parent.to(torch.int64)
    for _ in range(rounds):
        live = p >= 0
        safe = torch.clamp(p, min=0)
        acc = acc + torch.where(live, acc[safe], 0)
        p = torch.where(live, p[safe], -1)
    return acc


def root_path_sums(parent: torch.Tensor, self_ns: torch.Tensor,
                   rounds: int | None = None) -> torch.Tensor:
    """Sum of self times over each span and its ancestors, by `rounds`
    (default _n_rounds(n)) pointer-doubling rounds. parent: (n,) int32,
    -1 at a root and otherwise in [0, n); self_ns: (n,) int64 holding
    uint64 bits, on parent's device. Returns (n,) int64 holding the
    uint64 sums (mod 2**64). The plain version for CPU tensors; for CUDA
    tensors the root_path_sums kernel, one launch a round, or a raise."""
    if parent.ndim != 1 or self_ns.shape != parent.shape:
        raise ValueError("root_path_sums: parent and self_ns must be (n,)")
    n = parent.shape[0]
    if rounds is None:
        rounds = _n_rounds(n)
    if parent.device.type == "cpu":
        return _root_path_sums_plain(parent, self_ns, rounds)
    if parent.device.type != "cuda":
        raise ValueError(f"root_path_sums: no kernel for device {parent.device}")
    if self_ns.device != parent.device:
        raise ValueError(f"root_path_sums: tensors on {self_ns.device} and {parent.device}")
    if parent.dtype != torch.int32 or self_ns.dtype not in (torch.int64, torch.uint64):
        raise TypeError("root_path_sums: parent int32, self_ns int64 or uint64")
    if n >= 2**31:
        raise ValueError("root_path_sums: n must be below 2**31")
    parent, self_ns = parent.contiguous(), self_ns.contiguous()
    if n == 0 or rounds < 1:
        return self_ns.view(torch.int64).clone()
    p_a, p_b = torch.empty_like(parent), torch.empty_like(parent)
    acc_a = torch.empty(n, dtype=torch.int64, device=parent.device)
    acc_b = torch.empty_like(acc_a)
    launched = ctypes.c_int32(0)
    with torch.cuda.device(parent.device):
        err = _build.lib().tt_root_path_sums(
            parent.data_ptr(), self_ns.data_ptr(), n, rounds, p_a.data_ptr(),
            acc_a.data_ptr(), p_b.data_ptr(), acc_b.data_ptr(), ctypes.byref(launched),
            torch.cuda.current_stream(parent.device).cuda_stream)
    _build.check(err, "root_path_sums")
    root_path_sums.launches += 1 if launched.value else 0
    root_path_sums.kernel_launches += launched.value
    # round k writes pair a when k is even: the last round, rounds - 1
    return acc_a if rounds % 2 == 1 else acc_b


root_path_sums.launches = 0
root_path_sums.kernel_launches = 0


def root_path_sums_device(parent: np.ndarray, self_ns: np.ndarray, device,
                          bucket_for=None) -> np.ndarray:
    """The torch arm of root_path_sums_host on `device`, as one
    `graph_critical_path` dispatch: one host-to-device copy of parents
    and self times, every doubling round (the kernel on a CUDA device),
    one copy back. `bucket_for` is the reference's signature: it padded
    to a bucket shape for XLA's shape cache, which the CUDA arm does not
    need, so it is ignored."""
    from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

    del bucket_for
    n = len(parent)
    if n == 0:
        return np.empty(0, np.uint64)
    if parent.max(initial=-1) >= n:
        raise ValueError("root_path_sums_device: a parent index past the spans")
    dev = torch.device(device)
    p_h = torch.from_numpy(np.ascontiguousarray(parent, np.int32))
    s_h = torch.from_numpy(np.ascontiguousarray(self_ns, np.uint64).view(np.int64))

    def run():
        out = root_path_sums(p_h.to(dev), s_h.to(dev), _n_rounds(n))
        return out.cpu().numpy().view(np.uint64)

    out = timed_dispatch("graph_critical_path", run, device=dev)
    count_transfer("graph_critical_path", h2d=n * 12, d2h=n * 8)
    return out


def _arm(device) -> torch.device | None:
    """The torch device that runs the root path sums, or None for the
    host arm (see the module docstring)."""
    if os.environ.get("TEMPO_TPU_GRAPH_DEVICE") == "0" or device is None:
        return None
    dev = torch.device(device)
    return None if dev.type == "cpu" else dev


# ---------------------------------------------------------------------------
# critical path
# ---------------------------------------------------------------------------


def critical_path(parent: np.ndarray, duration: np.ndarray, seg: np.ndarray,
                  firsts: np.ndarray, device=None, bucket_for=None):
    """Per-trace longest self-time path.

    Returns (self_ns, on_path, path_ns):
      self_ns  (N,) uint64 — per-span self time
      on_path  (N,) bool   — span lies on its trace's winning path
      path_ns  (T,) uint64 — each trace's critical-path total

    The winning path is the root-to-span chain maximizing summed self
    time; ties break to the LOWEST row index (deterministic for any
    fixed block row order, which is what shard-count invariance needs).
    `device`: a torch device (or its name) whose arm sums the root paths,
    None for the host arm."""
    n = len(parent)
    n_traces = len(firsts)
    self_ns = self_times_ns(parent, duration)
    if n == 0:
        return self_ns, np.zeros(0, bool), np.empty(0, np.uint64)
    arm = _arm(device)
    if arm is not None:
        acc = root_path_sums_device(parent, self_ns, arm, bucket_for=bucket_for)
    else:
        acc = root_path_sums_host(parent, self_ns)
    # segmented argmax: first row reaching the segment max
    mx = np.maximum.reduceat(acc, firsts)
    best = np.flatnonzero(acc == mx[seg])
    leaf = best[np.searchsorted(seg[best], np.arange(n_traces))]
    # mark the winning chain by walking parents (vectorized over traces;
    # iterations = max depth). visited guard terminates parent cycles.
    on_path = np.zeros(n, bool)
    cur = leaf.copy()
    while len(cur):
        fresh = ~on_path[cur]
        cur = cur[fresh]
        if not len(cur):
            break
        on_path[cur] = True
        nxt = parent[cur]
        cur = nxt[nxt >= 0]
    return self_ns, on_path, mx
