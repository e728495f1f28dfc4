"""Resident just-cut tail: park cut columns on the device, fold and scan
them where they sit.

Port of tempo_tpu/ops/ingest_tail.py. The cut path
(`TenantInstance.cut_complete_traces`) parks the dedicated columns of
each freshly cut batch in the DeviceTier under the `ingest_tail` key
space — `("ingest_tail", tenant, "<block_id>:<seg>")`, the identity the
WAL gives the segment, so any consumer holding a WAL segment can rebuild
the key. While the entry is resident:

- the standing fold (`standing/engine._fold_one`) lowers supported plans
  (rate/count_over_time over dedicated-column equality/compare filters,
  optional by() on a dedicated string column) to one `tail_fold` launch
  over the parked columns: h2d per fold is the literals, bin edges and
  by() codes (O(100 B-16 KB)), never the columns; and
- live-tail search (`querier._search_batch`) computes its span mask with
  one `tail_scan` launch for dedicated-column tags + duration bounds.

Both record the column bytes they did not ship via
`DeviceTier.record_avoided`, with the reference's formulas.

The reference's two jitted programs (`_fold_kernel`, `_scan_kernel`)
are hand-written CUDA kernels here (csrc/tail_kernels.cu, built at first
use by ops/_build.py). Each wrapper (`tail_fold`, `tail_scan`) takes its
plain PyTorch version (`_tail_fold_plain`, `_tail_scan_plain`, the
reference's arithmetic) only for tensors that lie on the CPU; for CUDA
tensors it launches its kernel or raises, and counts the calls that
launched in `<wrapper>.launches`. Counts and masks are bit-equal to the
reference's.

Exactness: lowering is conservative. A fold plan lowers only when every
filter stage is a dedicated-column predicate with the EXACT dedicated
scope (`resource.service.name`, `span.http.*`, intrinsic `name`) —
`any`-scope attributes also probe the attribute table on the host path,
which the parked tail cannot see. Anything else returns None and the
caller runs the host path. Series registration replicates eval_batch's
order: unique by() codes ascending (only those with counted rows), then
the nil series.

A miss (not resident, evicted, `n` differs, not lowerable, a tag that
needs the attribute table, a zero tail budget) takes the host path, as
in the reference. A failure does not: where the reference logs a failed
park, fold or scan and answers from the host, the port raises.

64-bit timestamps and durations are parked as two u32 limbs (lo, hi)
and compared on both limbs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tempo_tpu_torch.encoding.vtpu.colcache import TAIL_KEYSPACE
from tempo_tpu_torch.ops import _build
from tempo_tpu_torch.ops.pallas_kernels import _stream, _u32
from tempo_tpu_torch.traceql.ast_nodes import (
    Attribute,
    Binary,
    Intrinsic,
    Literal,
    SpansetFilter,
)

# columns parked per cut: dictionary-code and enum columns as u32 lanes,
# 64-bit timestamps/durations as (lo, hi) u32 limb pairs: 44 B a span
_CODE_COLS = ("service", "name", "http_method", "http_url")
_PARKED = _CODE_COLS + ("http_status", "kind", "status_code",
                        "start_lo", "start_hi", "dur_lo", "dur_hi")

# (scope, attribute name) -> parked column; exact dedicated scopes ONLY
# (mirrors traceql.vector._DEDICATED + _DEDICATED_SCOPES — `any` scope
# would also probe the attr table, which the tail does not park)
_STR_ATTRS = {
    ("resource", "service.name"): "service",
    ("span", "http.method"): "http_method",
    ("span", "http.url"): "http_url",
}
_NUM_ATTRS = {("span", "http.status_code"): "http_status"}
_CMP_OPS = ("=", "!=", ">", ">=", "<", "<=")
# the kernel's operator codes
_OP_CODES = {op: i for i, op in enumerate(_CMP_OPS)}

# code columns never reach this value (dictionary codes are dense small
# ints), so it is a safe "matches nothing" sentinel — the same one the
# host vector path uses for absent string literals
_ABSENT = np.uint32(0xFFFFFFFF)

_MAX_FOLD_BINS = 2048
_MAX_FOLD_SERIES = 4096
_MAX_SCAN_EQ = 5  # name, service.name, service, http.method, http.url
_MAX_DESC_PREDS = 16  # predicates passed by value; more go through a device array


def _pow2(n: int) -> int:
    p = 8
    while p < n:
        p <<= 1
    return p


def _limbs(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    v = np.ascontiguousarray(col).view("<u4").reshape(-1, 2)
    return v[:, 0], v[:, 1]


# ---------------------------------------------------------------------------
# parking
# ---------------------------------------------------------------------------


def tail_key(tenant: str, seg_key: str) -> tuple:
    return (TAIL_KEYSPACE, tenant, seg_key)


def park_cut(tier, tenant: str, seg_key: str, batch) -> tuple | None:
    """Park one cut batch's dedicated columns; returns the tier key when
    resident, None when parking is off or the cut does not fit the tail
    share. Rows are padded to a power of two with zeros. A failure to
    park raises."""
    n = batch.num_spans
    if tier is None or n == 0 or tier.effective_tail_budget_bytes() <= 0:
        return None
    c = batch.cols
    host_bytes = (sum(c[k].nbytes for k in _CODE_COLS)
                  + c["http_status"].nbytes + c["kind"].nbytes
                  + c["status_code"].nbytes
                  + c["start_unix_nano"].nbytes
                  + c["duration_nano"].nbytes)
    p = _pow2(n)
    arrays = {}
    for k in _CODE_COLS:
        arrays[k] = _pad_u32(c[k], p)
    arrays["http_status"] = _pad_u32(c["http_status"], p)
    arrays["kind"] = _pad_u32(c["kind"], p)
    arrays["status_code"] = _pad_u32(c["status_code"], p)
    s_lo, s_hi = _limbs(c["start_unix_nano"])
    d_lo, d_hi = _limbs(c["duration_nano"])
    arrays["start_lo"] = _pad_u32(s_lo, p)
    arrays["start_hi"] = _pad_u32(s_hi, p)
    arrays["dur_lo"] = _pad_u32(d_lo, p)
    arrays["dur_hi"] = _pad_u32(d_hi, p)
    key = tail_key(tenant, seg_key)
    if tier.park_tail(key, arrays, meta={"n": n}, host_bytes=host_bytes):
        return key
    return None


def _pad_u32(col: np.ndarray, p: int) -> np.ndarray:
    out = np.zeros(p, np.uint32)
    out[: col.shape[0]] = col.astype(np.uint32, copy=False)
    return out


# ---------------------------------------------------------------------------
# standing-fold lowering
# ---------------------------------------------------------------------------


class FoldPlan:
    """A standing plan lowered onto the parked columns."""

    __slots__ = ("preds", "by_col")

    def __init__(self, preds: tuple, by_col: str | None):
        self.preds = preds  # tuple of (col, op, kind, value)
        self.by_col = by_col


def _lower_expr(expr) -> list | None:
    """Conjunctive predicate list [(col, op, kind, value)], or None."""
    if isinstance(expr, Binary) and expr.op == "&&":
        lhs = _lower_expr(expr.lhs)
        rhs = _lower_expr(expr.rhs)
        if lhs is None or rhs is None:
            return None
        return lhs + rhs
    if not isinstance(expr, Binary) or expr.op not in _CMP_OPS:
        return None
    lhs, rhs = expr.lhs, expr.rhs
    if not isinstance(rhs, Literal):
        return None
    if isinstance(lhs, Intrinsic) and lhs.name == "name":
        col = "name"
        if expr.op not in ("=", "!=") or rhs.kind != "string":
            return None
        return [(col, expr.op, "str", str(rhs.value))]
    if not isinstance(lhs, Attribute):
        return None
    skey = (lhs.scope, lhs.name)
    if skey in _STR_ATTRS:
        if expr.op not in ("=", "!=") or rhs.kind != "string":
            return None
        return [(_STR_ATTRS[skey], expr.op, "str", str(rhs.value))]
    if skey in _NUM_ATTRS:
        if rhs.kind not in ("int", "float"):
            return None
        v = float(rhs.value)
        # integer literals compare exactly as u32; fractional ones need
        # the host's f64 semantics
        if not v.is_integer() or not (0 <= v < 2**32):
            return None
        return [(_NUM_ATTRS[skey], expr.op, "num", int(v))]
    return None


def lower_fold_plan(plan) -> FoldPlan | None:
    """Lower a MetricsPlan to the parked columns, or None (host path).

    Supported: rate/count_over_time without histogram/exemplars, filter
    stages that are {} or conjunctions of dedicated-column predicates,
    by() absent or on a dedicated string column."""
    if plan.func not in ("rate", "count_over_time"):
        return None
    if plan.hist is not None or plan.exemplars:
        return None
    if getattr(plan, "value_expr", None) is not None:
        return None
    if plan.n_bins <= 0 or plan.n_bins > _MAX_FOLD_BINS:
        return None
    preds: list = []
    for st in plan.filters:
        if not isinstance(st, SpansetFilter):
            return None
        if st.expr is None:
            continue
        lowered = _lower_expr(st.expr)
        if lowered is None:
            return None
        preds.extend(lowered)
    by_col = None
    if plan.by_expr is not None:
        be = plan.by_expr
        if isinstance(be, Intrinsic) and be.name == "name":
            by_col = "name"
        elif isinstance(be, Attribute) and (be.scope, be.name) in _STR_ATTRS:
            by_col = _STR_ATTRS[(be.scope, be.name)]
        else:
            return None
    return FoldPlan(tuple(preds), by_col)


# ---------------------------------------------------------------------------
# the fold: tail_fold (kernel) and its plain version
# ---------------------------------------------------------------------------

_CMP = {
    "=": lambda c, v: c == v, "!=": lambda c, v: c != v,
    ">": lambda c, v: c > v, ">=": lambda c, v: c >= v,
    "<": lambda c, v: c < v, "<=": lambda c, v: c <= v,
}


def _count_le(x_hi: torch.Tensor, x_lo: torch.Tensor, a_hi: torch.Tensor,
              a_lo: torch.Tensor) -> torch.Tensor:
    """For each x, the number of entries a with a <= x, on two u32 limbs
    (int64 tensors of uint32 values): the reference's broadcast compare
    and sum, a block of rows at a time so the (rows, entries) matrix
    stays near 2**22 elements."""
    out = torch.empty(x_lo.numel(), dtype=torch.int64, device=x_lo.device)
    step = max(1, (1 << 22) // max(1, a_lo.numel()))
    for i in range(0, x_lo.numel(), step):
        h, lo = x_hi[i:i + step, None], x_lo[i:i + step, None]
        ge = (h > a_hi[None, :]) | ((h == a_hi[None, :]) & (lo >= a_lo[None, :]))
        out[i:i + step] = ge.sum(dim=1)
    return out


def _tail_fold_plain(arrays: dict, n: int, preds: list, by_col: str | None,
                     uvals: np.ndarray, edges_lo: np.ndarray, edges_hi: np.ndarray,
                     nb_real: int) -> torch.Tensor:
    """Plain version of tail_fold: the reference's `_fold_kernel`."""
    t_lo = _u32(arrays["start_lo"])
    dev, p = t_lo.device, t_lo.numel()
    mask = torch.arange(p, device=dev) < n
    for col, op, lit in preds:
        c = _u32(arrays[col])
        # str and num predicates alike: the compare on the u32 code or
        # value, and the column defined (non-zero)
        mask &= _CMP[op](c, int(lit)) & (c != 0)
    e_lo = torch.from_numpy(edges_lo.astype(np.int64)).to(dev)
    e_hi = torch.from_numpy(edges_hi.astype(np.int64)).to(dev)
    bin_idx = _count_le(_u32(arrays["start_hi"]), t_lo, e_hi, e_lo) - 1
    valid = mask & (bin_idx >= 0) & (bin_idx < nb_real)
    b_pad = len(edges_lo) - 1
    if by_col is not None:
        c = _u32(arrays[by_col])
        uv = torch.from_numpy(uvals.astype(np.int64)).to(dev)
        zeros = torch.zeros_like(c)
        idx = _count_le(zeros, c, torch.zeros_like(uv), uv) - 1
        flat = idx * b_pad + bin_idx
    else:
        flat = bin_idx
    length = len(uvals) * b_pad
    # jnp.bincount clips negative indices to 0; rows past `valid` go to
    # the slot past the end, which is cut off
    flat = torch.where(valid, flat, length).clamp(min=0)
    return torch.bincount(flat, minlength=length + 1)[:length].to(torch.int32)


class _Pred(ctypes.Structure):
    _fields_ = [("col", ctypes.c_void_p), ("lit", ctypes.c_uint32), ("op", ctypes.c_uint32)]


class _FoldDesc(ctypes.Structure):
    """tail::FoldDesc of csrc/tail_kernels.cu, passed to the kernel by value."""

    _fields_ = [("preds", _Pred * _MAX_DESC_PREDS), ("more", ctypes.c_void_p),
                ("t_lo", ctypes.c_void_p), ("t_hi", ctypes.c_void_p), ("by", ctypes.c_void_p),
                ("consts", ctypes.c_void_p), ("counts", ctypes.c_void_p),
                ("n_preds", ctypes.c_int32), ("n", ctypes.c_int32), ("e_pad", ctypes.c_int32),
                ("u_pad", ctypes.c_int32), ("nb_real", ctypes.c_int32),
                ("shared_hist", ctypes.c_int32)]


def _parked_columns(kernel: str, arrays: dict, names: list) -> list:
    """The named parked columns, checked as the kernels read them: one
    CUDA device, int32 (uint32 bits), contiguous, the same rows."""
    cols = [arrays[k] for k in names]
    p, dev = cols[0].numel(), cols[0].device
    for k, c in zip(names, cols):
        if c.device != dev or c.dtype != torch.int32 or not c.is_contiguous() or c.numel() != p:
            raise ValueError(f"{kernel}: parked column {k} is {c.dtype} {tuple(c.shape)} on "
                             f"{c.device}, not int32 ({p},) on {dev}")
    return cols


def tail_fold(arrays: dict, n: int, preds: list, by_col: str | None, uvals: np.ndarray,
              edges_lo: np.ndarray, edges_hi: np.ndarray, nb_real: int) -> torch.Tensor:
    """Count the first `n` parked rows into (by-index, bin) cells.

    arrays: the parked columns (int32 tensors of uint32 values, p rows);
    preds: [(column, op, u32 literal)], ANDed, each also requiring the
    column non-zero; edges_lo/hi: the bin edges (uint32 limbs, ascending,
    padded with u64 max, e_pad of them); uvals: the by() codes (uint32,
    ascending, padded with 0xFFFFFFFF; one zero without by()). A row's
    bin is the number of edges <= its start less one, kept when in
    [0, nb_real); its cell idx * (e_pad - 1) + bin, idx the number of
    uvals <= its by() code less one. Returns len(uvals) * (e_pad - 1)
    int32 counts on the columns' device: the plain version for CPU
    tensors, one tail_fold launch for CUDA tensors (none for n = 0)."""
    edges = (edges_hi.astype(np.uint64) << np.uint64(32)) | edges_lo.astype(np.uint64)
    if len(edges) < 2 or len(edges_hi) != len(edges) or np.any(edges[1:] < edges[:-1]):
        raise ValueError("tail_fold: the bin edges must ascend, two at least")
    if not 0 <= nb_real < len(edges) or np.any(uvals[1:] < uvals[:-1]):
        raise ValueError("tail_fold: nb_real out of range or the by() codes do not ascend")
    dev = arrays["start_lo"].device
    if dev.type == "cpu":
        return _tail_fold_plain(arrays, n, preds, by_col, uvals, edges_lo, edges_hi, nb_real)
    if dev.type != "cuda":
        raise ValueError(f"tail_fold: no kernel for device {dev}")
    names = ([col for col, _, _ in preds] + ["start_lo", "start_hi"]
             + ([by_col] if by_col is not None else []))
    cols = _parked_columns("tail_fold", arrays, names)
    if not 0 <= n <= cols[0].numel():
        raise ValueError(f"tail_fold: n={n} outside the {cols[0].numel()} parked rows")
    e_pad, u_pad = len(edges_lo), len(uvals)
    counts = torch.zeros(u_pad * (e_pad - 1), dtype=torch.int32, device=dev)
    if n == 0:
        return counts
    # the only host input: the edges and the by() codes, one copy
    consts = fold_consts(uvals, edges_lo, edges_hi, dev)
    # _more (the predicates past the descriptor's 16) lives until the launch
    desc, _more = fold_descriptor(arrays, n, preds, by_col, u_pad, e_pad, nb_real, consts,
                                  counts)
    with torch.cuda.device(dev):
        err = _build.lib().tt_tail_fold(ctypes.addressof(desc), _stream(counts))
    _build.check(err, "tail_fold")
    tail_fold.launches += 1
    return counts


tail_fold.launches = 0


def fold_consts(uvals: np.ndarray, edges_lo: np.ndarray, edges_hi: np.ndarray,
                device) -> torch.Tensor:
    """edges_lo, edges_hi and uvals as one int32 tensor on `device`, the
    layout tail_fold_kernel reads."""
    both = np.concatenate([edges_lo, edges_hi, uvals]).astype(np.uint32).view(np.int32)
    return torch.from_numpy(both).to(device)


def fold_descriptor(arrays: dict, n: int, preds: list, by_col: str | None, u_pad: int,
                    e_pad: int, nb_real: int, consts: torch.Tensor,
                    counts: torch.Tensor) -> tuple:
    """(the kernel's descriptor, the device array of predicates past the
    16 it holds by value, or None). The caller keeps the array alive
    until the launch is enqueued."""
    desc = _FoldDesc(n_preds=len(preds), n=n, e_pad=e_pad, u_pad=u_pad, nb_real=nb_real,
                     t_lo=arrays["start_lo"].data_ptr(), t_hi=arrays["start_hi"].data_ptr(),
                     by=None if by_col is None else arrays[by_col].data_ptr(),
                     consts=consts.data_ptr(), counts=counts.data_ptr())
    more = None
    if len(preds) > _MAX_DESC_PREDS:
        # Pred {col, lit, op} as two 64-bit words each
        words = np.array([[arrays[col].data_ptr(), int(lit) | (_OP_CODES[op] << 32)]
                          for col, op, lit in preds], np.uint64).view(np.int64)
        more = torch.from_numpy(words).to(counts.device)
        desc.more = more.data_ptr()
    else:
        for j, (col, op, lit) in enumerate(preds):
            desc.preds[j] = _Pred(arrays[col].data_ptr(), int(lit), _OP_CODES[op])
    return desc, more


def fold_args(plan, fold_plan: FoldPlan, batch, dictionary):
    """(lits, preds, uvals_real, uvals, edges_lo, edges_hi) of one fold of
    `batch` (tail_fold's host inputs: the literals resolved in the
    dictionary, the by() codes present in the batch, the plan's bin
    edges), or None when the by() codes exceed the series cap."""
    lits = np.zeros(max(len(fold_plan.preds), 1), np.uint32)
    for j, (_, _, kind, value) in enumerate(fold_plan.preds):
        if kind == "str":
            code = dictionary.get(str(value))
            lits[j] = _ABSENT if code is None else np.uint32(code)
        else:
            lits[j] = np.uint32(value)
    preds = [(col, op, int(lits[j])) for j, (col, op, _, _) in enumerate(fold_plan.preds)]
    if fold_plan.by_col is not None:
        uvals_real = np.unique(batch.cols[fold_plan.by_col].astype(np.uint32))
        if len(uvals_real) > _MAX_FOLD_SERIES:
            return None
        uvals = np.full(_pow2(len(uvals_real)), _ABSENT, np.uint32)
        uvals[: len(uvals_real)] = uvals_real
    else:
        uvals_real = np.zeros(0, np.uint32)
        uvals = np.zeros(1, np.uint32)
    nb = plan.n_bins
    start_ns = plan.start_s * 10**9
    step_ns = plan.step_s * 10**9
    edges = start_ns + np.arange(nb + 1, dtype=np.uint64) * np.uint64(step_ns)
    e_pad = _pow2(nb + 2)
    edges_lo = np.full(e_pad, 0xFFFFFFFF, np.uint32)
    edges_hi = np.full(e_pad, 0xFFFFFFFF, np.uint32)
    edges_lo[: nb + 1] = (edges & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    edges_hi[: nb + 1] = (edges >> np.uint64(32)).astype(np.uint32)
    return lits, preds, uvals_real, uvals, edges_lo, edges_hi


def resident_fold(plan, fold_plan: FoldPlan, batch, dictionary, series,
                  tier=None, key=None):
    """Fold one parked cut into sparse (series slot, relative bin) counts
    on the tier's device. Returns {(slot, rel_bin): count}, or None on a
    miss (the caller runs eval_batch — the same counts either way).

    `batch` is the host copy of the SAME cut (the engine holds it
    anyway); it is used only for the by() code inventory (np.unique on
    host memory — no transfer), never shipped."""
    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

    if tier is None:
        tier = colcache.shared_device_tier()
    if tier is None or key is None:
        return None
    entry = tier.get(key)
    if entry is None:
        return None
    n = int(entry.meta.get("n", 0))
    if n != batch.num_spans or n == 0:
        return None
    d = dictionary
    args = fold_args(plan, fold_plan, batch, d)
    if args is None:
        return None
    lits, preds, uvals_real, uvals, edges_lo, edges_hi = args
    by = fold_plan.by_col is not None
    resident = [entry.arrays[col] for col, _, _ in preds]
    resident += [entry.arrays["start_lo"], entry.arrays["start_hi"]]
    if by:
        resident.append(entry.arrays[fold_plan.by_col])
    nb = plan.n_bins
    e_pad = len(edges_lo)
    dev = entry.arrays["start_lo"].device
    # the reference's accounting: the literals, by() codes and edges ship,
    # the parked columns are resident
    count_transfer("standing_fold",
                   h2d=lits.nbytes + uvals.nbytes + edges_lo.nbytes + edges_hi.nbytes,
                   resident=sum(int(c.nbytes) for c in resident))
    counts = timed_dispatch("standing_fold", tail_fold, entry.arrays, n, preds,
                            fold_plan.by_col, uvals, edges_lo, edges_hi, nb, device=dev)
    counts = counts.cpu().numpy()
    count_transfer("standing_fold", d2h=counts.nbytes)
    b_pad = e_pad - 1
    # what the host fold would have walked: predicate + time + by columns
    avoided = n * (4 * len(preds) + 8) + (n * 4 if by else 0)
    tier.record_avoided(avoided, kernel="standing_fold")
    out: dict = {}
    if not by:
        vec = counts[:nb]
        if vec.sum() == 0:
            return out
        series.slot_of("")  # register the single unlabeled series
        for b in np.flatnonzero(vec):
            out[(0, int(b))] = int(vec[b])
        return out
    mat = counts.reshape(len(uvals), b_pad)[:, :nb]
    # registration order must replicate eval_batch: unique codes of
    # counted rows ascending, then the nil (code 0) series
    nil_row = None
    for ui, u in enumerate(uvals_real):
        row = mat[ui]
        if not row.any():
            continue
        if u == 0:
            nil_row = row
            continue
        slot = series.slot_of(d[int(u)])
        if slot < 0:
            continue  # over the series cap: dropped, same as the host
        for b in np.flatnonzero(row):
            k = (int(slot), int(b))
            out[k] = out.get(k, 0) + int(row[b])
    if nil_row is not None:
        slot = series.slot_of(None)
        if slot >= 0:
            for b in np.flatnonzero(nil_row):
                k = (int(slot), int(b))
                out[k] = out.get(k, 0) + int(nil_row[b])
    return out


# ---------------------------------------------------------------------------
# live-tail search mask: tail_scan (kernel) and its plain version
# ---------------------------------------------------------------------------

_TAG_COLS = {
    "name": "name",
    "service.name": "service",
    "service": "service",
    "http.method": "http_method",
    "http.url": "http_url",
}


def _tail_scan_plain(arrays: dict, n: int, eq: list, status: int | None,
                     min_ns: int, max_ns: int) -> torch.Tensor:
    """Plain version of tail_scan: the reference's `_scan_kernel`."""
    carrier = arrays["service"]
    mask = torch.arange(carrier.numel(), device=carrier.device) < n
    for col, code in eq:
        mask &= _u32(arrays[col]) == int(code)
    if status is not None:
        mask &= _u32(arrays["http_status"]) == int(status)
    if min_ns or max_ns:
        d_lo, d_hi = _u32(arrays["dur_lo"]), _u32(arrays["dur_hi"])
        if min_ns:
            lo, hi = min_ns & 0xFFFFFFFF, min_ns >> 32
            mask &= (d_hi > hi) | ((d_hi == hi) & (d_lo >= lo))
        if max_ns:
            lo, hi = max_ns & 0xFFFFFFFF, max_ns >> 32
            mask &= (d_hi < hi) | ((d_hi == hi) & (d_lo <= lo))
    return mask


class _ScanDesc(ctypes.Structure):
    """tail::ScanDesc of csrc/tail_kernels.cu, passed to the kernel by value."""

    _fields_ = [("eq_cols", ctypes.c_void_p * _MAX_SCAN_EQ), ("status", ctypes.c_void_p),
                ("dur_lo", ctypes.c_void_p), ("dur_hi", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("min_d", ctypes.c_uint64), ("max_d", ctypes.c_uint64),
                ("codes", ctypes.c_uint32 * _MAX_SCAN_EQ), ("status_val", ctypes.c_uint32),
                ("n_eq", ctypes.c_int32), ("n", ctypes.c_int32), ("p", ctypes.c_int32)]


def tail_scan(arrays: dict, n: int, eq: list, status: int | None, min_ns: int,
              max_ns: int) -> torch.Tensor:
    """The live-tail span mask over p parked rows: row < n, each
    (column, code) of `eq` equal, http_status == status (None: no
    status tag), min_ns <= duration <= max_ns (0: no bound; two u32
    limbs). Returns a (p,) bool tensor on the columns' device: the plain
    version for CPU tensors, one tail_scan launch for CUDA tensors."""
    if len(eq) > _MAX_SCAN_EQ:
        raise ValueError(f"tail_scan: {len(eq)} equalities, {_MAX_SCAN_EQ} at most")
    if status is not None and not 0 <= status < 2**32:
        raise ValueError(f"tail_scan: status {status} is not a u32")
    if not (0 <= min_ns < 2**64 and 0 <= max_ns < 2**64):
        raise ValueError("tail_scan: duration bounds must be u64")
    dev = arrays["service"].device
    if dev.type == "cpu":
        return _tail_scan_plain(arrays, n, eq, status, min_ns, max_ns)
    if dev.type != "cuda":
        raise ValueError(f"tail_scan: no kernel for device {dev}")
    names = (["service"] + [col for col, _ in eq] + (["http_status"] if status is not None else [])
             + (["dur_lo", "dur_hi"] if min_ns or max_ns else []))
    cols = _parked_columns("tail_scan", arrays, names)
    p = cols[0].numel()
    if not 0 <= n <= p:
        raise ValueError(f"tail_scan: n={n} outside the {p} parked rows")
    out = torch.empty(p, dtype=torch.uint8, device=dev)
    desc = scan_descriptor(arrays, n, eq, status, min_ns, max_ns, out)
    with torch.cuda.device(dev):
        err = _build.lib().tt_tail_scan(ctypes.addressof(desc), _stream(out))
    _build.check(err, "tail_scan")
    tail_scan.launches += 1
    return out.view(torch.bool)


tail_scan.launches = 0


def scan_descriptor(arrays: dict, n: int, eq: list, status: int | None, min_ns: int,
                    max_ns: int, out: torch.Tensor) -> _ScanDesc:
    """The kernel's descriptor: every input by value, the mask into `out`."""
    desc = _ScanDesc(n_eq=len(eq), n=n, p=out.numel(), out=out.data_ptr(), min_d=min_ns,
                     max_d=max_ns, status_val=0 if status is None else status,
                     status=None if status is None else arrays["http_status"].data_ptr())
    for j, (col, code) in enumerate(eq):
        desc.eq_cols[j] = arrays[col].data_ptr()
        desc.codes[j] = int(code)
    if min_ns or max_ns:
        desc.dur_lo, desc.dur_hi = arrays["dur_lo"].data_ptr(), arrays["dur_hi"].data_ptr()
    return desc


def tail_search_mask(batch, req, tier=None) -> np.ndarray | None:
    """Span mask for a tag search over a parked cut. Returns the (n,)
    bool mask, or None when the batch is not resident or a tag needs the
    attribute table (host path). Absent dictionary codes and unparsable
    status values yield an all-False mask — exactly the host loop's
    early-empty behavior."""
    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.util.devicetiming import count_transfer, timed_dispatch

    key = getattr(batch, "_tail_key", None)
    if key is None:
        return None
    if tier is None:
        tier = colcache.shared_device_tier()
    if tier is None:
        return None
    entry = tier.get(key)
    if entry is None:
        return None
    n = batch.num_spans
    if int(entry.meta.get("n", 0)) != n:
        return None
    d = batch.dictionary
    eq: list = []
    status = None
    empty = np.zeros(n, bool)
    for k, v in req.tags.items():
        v = str(v)
        if k == "http.status_code":
            try:
                status = int(v)
            except ValueError:
                return empty
            if not (0 <= status < 2**32):
                return empty
            continue
        col = _TAG_COLS.get(k)
        if col is None:
            return None  # attr-table tag: host path
        code = d.get(v)
        if code is None:
            return empty
        eq.append((col, code))
    mn = int(req.min_duration_ns or 0)
    mx = int(req.max_duration_ns or 0)
    resident = [entry.arrays[col] for col, _ in eq]
    if status is not None:
        resident.append(entry.arrays["http_status"])
    if mn or mx:
        resident += [entry.arrays["dur_lo"], entry.arrays["dur_hi"]]
    if not resident:
        resident = [entry.arrays["service"]]  # the reference's row-count carrier
    dev = entry.arrays["service"].device
    count_transfer("live_tail_scan", h2d=4 * max(len(eq), 1),
                   resident=sum(int(c.nbytes) for c in resident))
    mask = timed_dispatch("live_tail_scan", tail_scan, entry.arrays, n, eq, status, mn, mx,
                          device=dev)
    mask = mask[:n].cpu().numpy()
    count_transfer("live_tail_scan", d2h=mask.nbytes)
    avoided = n * 4 * len(eq)
    if status is not None:
        avoided += n * 2
    if mn or mx:
        avoided += n * 8
    tier.record_avoided(max(avoided, n), kernel="live_tail_scan")
    return mask
