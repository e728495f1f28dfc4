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
- the root_path_sums kernels: CUDA C++ (csrc/graph_sketch_kernels.cu).
  Given the traces' first rows (`firsts`), one launch over whole traces,
  their rounds in shared memory (tt_root_path_sums_segmented); without
  them one launch a round over ping-pong buffers (tt_root_path_sums).

root_path_sums, the wrapper, takes the plain version only for tensors on
the CPU and launches a kernel for CUDA tensors or raises; it counts its
calls that launched in `root_path_sums.launches` and its kernel launches
in `root_path_sums.kernel_launches`. With `firsts`, every parent must lie
in its own trace segment: the CPU arm checks that with torch ops, the
kernel sets an error flag, and both raise ValueError.

The arm follows the device the caller passes (the querier passes its
DB's device): a CUDA device runs the segmented kernel under
timed_dispatch("graph_critical_path") (critical_path passes its
segments), the CPU or no device the host arm. TEMPO_TPU_GRAPH_DEVICE=0
forces the host arm, as in the reference.
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


def _check_segments(parent: torch.Tensor, firsts: torch.Tensor) -> None:
    """Raise unless `firsts` ascend strictly from 0 below n and every
    parent (>= 0) lies in its own span's trace segment: what the
    segmented kernel flags."""
    n = parent.shape[0]
    f = firsts.to(torch.int64)
    if n == 0:
        return
    if len(f) == 0 or int(f[0]) != 0 or bool((f[1:] <= f[:-1]).any()) or int(f[-1]) >= n:
        raise ValueError("root_path_sums: firsts must ascend strictly from 0 below n")
    seg = torch.searchsorted(f, torch.arange(n, device=f.device), right=True) - 1
    ends = torch.cat([f[1:], f.new_tensor([n])])
    p = parent.to(torch.int64)
    if bool(((p >= 0) & ((p < f[seg]) | (p >= ends[seg]))).any()):
        raise ValueError("root_path_sums: a parent outside its trace segment")


def _launch_segmented(parent: torch.Tensor, self_ns: torch.Tensor, firsts: torch.Tensor,
                      rounds: int, out: torch.Tensor, flag: torch.Tensor) -> None:
    """One launch of the segmented kernel on the current stream: the sums
    into `out` ((n,) int64), a bad parent or bad `firsts` into `flag`
    (an int32 word the caller zeroed). Counts the call and its launch."""
    n = parent.shape[0]
    # two records of 16 B a span, for a run longer than a CTA's tile
    scratch = torch.empty(4 * n, dtype=torch.int64, device=parent.device)
    launched = ctypes.c_int32(0)
    with torch.cuda.device(parent.device):
        err = _build.lib().tt_root_path_sums_segmented(
            parent.data_ptr(), self_ns.data_ptr(), firsts.data_ptr(), n, firsts.shape[0],
            rounds, out.data_ptr(), scratch.data_ptr(), flag.data_ptr(), ctypes.byref(launched),
            torch.cuda.current_stream(parent.device).cuda_stream)
    _build.check(err, "root_path_sums")
    root_path_sums.launches += 1 if launched.value else 0
    root_path_sums.kernel_launches += launched.value


def root_path_sums(parent: torch.Tensor, self_ns: torch.Tensor,
                   rounds: int | None = None,
                   firsts: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of self times over each span and its ancestors, by `rounds`
    (default _n_rounds(n)) pointer-doubling rounds. parent: (n,) int32,
    -1 at a root and otherwise in [0, n); self_ns: (n,) int64 holding
    uint64 bits, on parent's device. Returns (n,) int64 holding the
    uint64 sums (mod 2**64).

    firsts (optional, on parent's device): the (T,) first rows of the
    trace segments, ascending from 0; every parent must lie in its own
    span's segment, or this raises ValueError. The result is the same
    with or without them.

    The plain version for CPU tensors; for CUDA tensors a kernel or a
    raise: with `firsts` the segmented kernel (one launch; the wrapper
    reads its error flag, which waits for it), without them one launch
    a round."""
    if parent.ndim != 1 or self_ns.shape != parent.shape:
        raise ValueError("root_path_sums: parent and self_ns must be (n,)")
    if firsts is not None and firsts.ndim != 1:
        raise ValueError("root_path_sums: firsts must be (T,)")
    n = parent.shape[0]
    if rounds is None:
        rounds = _n_rounds(n)
    if parent.device.type == "cpu":
        if firsts is not None:
            _check_segments(parent, firsts)
        return _root_path_sums_plain(parent, self_ns, rounds)
    if parent.device.type != "cuda":
        raise ValueError(f"root_path_sums: no kernel for device {parent.device}")
    for t in (self_ns, firsts):
        if t is not None and t.device != parent.device:
            raise ValueError(f"root_path_sums: tensors on {t.device} and {parent.device}")
    if parent.dtype != torch.int32 or self_ns.dtype not in (torch.int64, torch.uint64):
        raise TypeError("root_path_sums: parent int32, self_ns int64 or uint64")
    if n >= 2**31:
        raise ValueError("root_path_sums: n must be below 2**31")
    parent, self_ns = parent.contiguous(), self_ns.contiguous()
    if n == 0:
        return self_ns.view(torch.int64).clone()
    if firsts is not None:
        out = torch.empty(n, dtype=torch.int64, device=parent.device)
        flag = torch.zeros(1, dtype=torch.int32, device=parent.device)
        _launch_segmented(parent, self_ns, firsts.to(torch.int32).contiguous(), rounds, out,
                          flag)
        if int(flag.item()):
            raise ValueError(SEGMENT_FAULT)
        return out
    if rounds < 1:
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

SEGMENT_FAULT = ("root_path_sums: a parent outside its trace segment, or firsts not "
                 "ascending strictly from 0 below n")


def _words(count: int, itemsize: int) -> int:
    """int64 words holding `count` items of `itemsize` bytes, rounded up
    to an even count so that the next section starts 16-byte aligned."""
    w = -(-count * itemsize // 8)
    return w + (w & 1)


def _segmented_dispatch(parent: np.ndarray, self_ns: np.ndarray, firsts: np.ndarray,
                        dev: torch.device, rounds: int) -> np.ndarray:
    """The segmented kernel's dispatch on a CUDA device: parents, self
    times and firsts packed into one pinned buffer and copied in once on
    the current stream, one launch, the error flag and the sums copied
    back once into pinned memory, then a wait on that stream."""
    n, t = len(parent), len(firsts)
    ws, wp, wf = _words(n, 8), _words(n, 4), _words(t, 4)
    f_at = ws + wp + wf  # the flag word, then a pad word, then the sums
    host = torch.empty(f_at + 2, dtype=torch.int64, pin_memory=True)
    h = host.numpy()
    h[:n] = np.asarray(self_ns).view(np.int64)
    np.copyto(h[ws:ws + wp].view(np.int32)[:n], parent, casting="unsafe")
    np.copyto(h[ws + wp:f_at].view(np.int32)[:t], firsts, casting="unsafe")
    h[f_at:] = 0
    buf = torch.empty(f_at + 2 + n, dtype=torch.int64, device=dev)
    buf[:f_at + 2].copy_(host, non_blocking=True)
    i32 = buf[:f_at].view(torch.int32)
    _launch_segmented(i32[2 * ws:2 * ws + n], buf[:n], i32[2 * (ws + wp):2 * (ws + wp) + t],
                      rounds, buf[f_at + 2:], buf[f_at:f_at + 1].view(torch.int32))
    back = torch.empty(n + 2, dtype=torch.int64, pin_memory=True)
    back.copy_(buf[f_at:], non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    done.synchronize()
    out = back.numpy()
    if out[0] != 0:
        raise ValueError(SEGMENT_FAULT)
    return out[2:].view(np.uint64)


def root_path_sums_device(parent: np.ndarray, self_ns: np.ndarray, device,
                          bucket_for=None, firsts: np.ndarray | None = None) -> np.ndarray:
    """The torch arm of root_path_sums_host on `device`, as one
    `graph_critical_path` dispatch. With `firsts` (the traces' first
    rows, ascending from 0; every parent inside its trace, or this
    raises) on a CUDA device: one copy in and one copy back through
    pinned memory and the segmented kernel, one launch, waiting on the
    current stream only. Without them: pageable copies and one launch a
    round. On the CPU the plain version. `bucket_for` is the reference's
    signature: it padded to a bucket shape for XLA's shape cache, which
    the CUDA arm does not need, so it is ignored."""
    from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

    del bucket_for
    n = len(parent)
    if n == 0:
        return np.empty(0, np.uint64)
    dev = torch.device(device)
    rounds = _n_rounds(n)
    if firsts is not None and dev.type == "cuda":
        out = timed_dispatch("graph_critical_path", _segmented_dispatch, parent, self_ns,
                             firsts, dev, rounds, device=dev,
                             stream=torch.cuda.current_stream(dev))
        count_transfer("graph_critical_path", h2d=n * 12 + len(firsts) * 4, d2h=n * 8)
        return out
    if parent.max(initial=-1) >= n:
        raise ValueError("root_path_sums_device: a parent index past the spans")
    p_h = torch.from_numpy(np.ascontiguousarray(parent, np.int32))
    s_h = torch.from_numpy(np.ascontiguousarray(self_ns, np.uint64).view(np.int64))
    f_h = None if firsts is None else torch.from_numpy(np.asarray(firsts, np.int64))

    def run():
        out = root_path_sums(p_h.to(dev), s_h.to(dev), rounds,
                             firsts=None if f_h is None else f_h.to(dev))
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
        acc = root_path_sums_device(parent, self_ns, arm, bucket_for=bucket_for,
                                    firsts=firsts)
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
