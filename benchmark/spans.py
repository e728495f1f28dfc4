"""Seeded span data in plain NumPy, with the OpenTelemetry Demo's shapes.

The shapes are those of `tempo_tpu_torch.model.synth.make_batch`: 8
services, 6 operation names, 4 HTTP methods, 64 URLs and 5 attribute keys
whose string values are `v0`..`v255` and whose integer values are 0..999.
Here the services, names, methods and string values are drawn
Zipf-skewed with YCSB's constant 0.99 (uniform draws would flatter every
cache), a trace's spans form a parent chain that starts at its root and
may cross services, span starts spread over a stated time range, and
durations are log-uniform from 100 us to 1 s.

Columns are named and typed as the port's span and attribute columns,
and every string column holds a code into `STRINGS` (code 0 is the empty
string), so `benchmark.adapter` hands them to the port unchanged and
`benchmark.reference` reads them with no program code at all.
"""

from __future__ import annotations

import numpy as np

SERVICES = ["frontend", "cart", "checkout", "currency", "shipping", "payment", "email", "ads"]
OP_NAMES = ["GET /api/products", "POST /api/cart", "oteldemo.Checkout/Place", "db.query",
            "cache.get", "render"]
HTTP_METHODS = ["GET", "POST", "PUT", "DELETE"]
URLS = [f"http://svc/{i}" for i in range(64)]
ATTR_KEYS = ["k8s.pod.name", "region", "customer.id", "retry.count", "db.statement"]
VALUES = [f"v{i}" for i in range(256)]
HTTP_STATUSES = np.array([200, 404, 500], np.uint16)
HTTP_STATUS_P = np.array([0.75, 0.15, 0.10])

STRINGS = [""] + SERVICES + OP_NAMES + HTTP_METHODS + URLS + ATTR_KEYS + VALUES


SERVICE_BASE = 1
NAME_BASE = SERVICE_BASE + len(SERVICES)
METHOD_BASE = NAME_BASE + len(OP_NAMES)
URL_BASE = METHOD_BASE + len(HTTP_METHODS)
KEY_BASE = URL_BASE + len(URLS)
VALUE_BASE = KEY_BASE + len(ATTR_KEYS)

VT_STR, VT_INT = 0, 1
SCOPE_SPAN = 0
ZIPF_THETA = 0.99


def code(s: str) -> int:
    return STRINGS.index(s)


def zipf_p(n: int, theta: float = ZIPF_THETA) -> np.ndarray:
    """Probabilities of ranks 1..n under Zipf's law with constant theta."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
    return w / w.sum()


def zipf_draw(rng: np.random.Generator, n: int, size) -> np.ndarray:
    """Indices 0..n-1, index 0 the most frequent."""
    cdf = np.cumsum(zipf_p(n))
    return np.minimum(np.searchsorted(cdf, rng.random(size), side="right"), n - 1)


def traces(rng: np.random.Generator, n_traces: int, spans_per_trace: int, t0_s: int,
           span_s: int, attrs_per_span: int) -> dict:
    """n_traces fresh traces of spans_per_trace spans each, rows sorted by
    (trace ID, span ID) as a block stores them. Returns {"cols": span
    columns, "attrs": attribute columns}."""
    k = spans_per_trace
    n = n_traces * k
    tid = rng.integers(0, 2**32, size=(n_traces, 4), dtype=np.uint32)
    sid = rng.integers(1, 2**32, size=(n, 2), dtype=np.uint32)
    hop = np.tile(np.arange(k), n_traces)
    parent = np.zeros((n, 2), np.uint32)
    parent[hop > 0] = sid[np.flatnonzero(hop > 0) - 1]
    t_trace = t0_s * 10**9 + rng.integers(0, span_s * 10**9, size=n_traces, dtype=np.int64)
    offsets = np.sort(rng.integers(0, 10**9, size=(n_traces, k), dtype=np.int64), axis=1)
    offsets[:, 0] = 0  # the root starts the trace
    start = (np.repeat(t_trace, k) + offsets.reshape(-1)).astype(np.uint64)
    duration = np.exp(rng.uniform(np.log(1e5), np.log(1e9), size=n)).astype(np.uint64)
    status = HTTP_STATUSES[np.searchsorted(np.cumsum(HTTP_STATUS_P), rng.random(n),
                                           side="right").clip(max=len(HTTP_STATUSES) - 1)]
    cols = {
        "trace_id": np.repeat(tid, k, axis=0),
        "span_id": sid,
        "parent_span_id": parent,
        "start_unix_nano": start,
        "duration_nano": duration,
        "kind": np.where(hop == 0, 2, rng.integers(1, 6, size=n)).astype(np.uint8),
        "status_code": np.where(status == 500, 2, 0).astype(np.uint8),
        "name": (NAME_BASE + zipf_draw(rng, len(OP_NAMES), n)).astype(np.uint32),
        "service": (SERVICE_BASE + zipf_draw(rng, len(SERVICES), n)).astype(np.uint32),
        "http_status": status.astype(np.uint16),
        "http_method": (METHOD_BASE + zipf_draw(rng, len(HTTP_METHODS), n)).astype(np.uint32),
        "http_url": (URL_BASE + rng.integers(0, len(URLS), size=n)).astype(np.uint32),
    }
    m = n * attrs_per_span
    vtype = rng.integers(VT_STR, VT_INT + 1, size=m).astype(np.uint8)
    attrs = {
        "attr_span": np.repeat(np.arange(n, dtype=np.uint32), attrs_per_span),
        "attr_scope": np.full(m, SCOPE_SPAN, np.uint8),
        "attr_key": (KEY_BASE + rng.integers(0, len(ATTR_KEYS), size=m)).astype(np.uint32),
        "attr_vtype": vtype,
        "attr_str": np.where(vtype == VT_STR, VALUE_BASE + zipf_draw(rng, len(VALUES), m),
                             0).astype(np.uint32),
        "attr_num": np.where(vtype == VT_INT, rng.integers(0, 1000, size=m), 0
                             ).astype(np.float64),
    }
    return sort_by_trace({"cols": cols, "attrs": attrs})


def select(block: dict, rows: np.ndarray) -> dict:
    """The rows (in the given order) with their attributes."""
    rows = np.asarray(rows, np.int64)
    cols = {c: v[rows] for c, v in block["cols"].items()}
    attrs = block["attrs"]
    pos = np.full(len(block["cols"]["trace_id"]), -1, np.int64)
    pos[rows] = np.arange(len(rows))
    owner = pos[attrs["attr_span"]]
    keep = np.flatnonzero(owner >= 0)
    keep = keep[np.argsort(owner[keep], kind="stable")]
    out = {c: v[keep] for c, v in attrs.items()}
    out["attr_span"] = owner[keep].astype(np.uint32)
    return {"cols": cols, "attrs": out}


def concat(blocks: list) -> dict:
    offs = np.cumsum([0] + [len(b["cols"]["trace_id"]) for b in blocks])
    cols = {c: np.concatenate([b["cols"][c] for b in blocks]) for c in blocks[0]["cols"]}
    attrs = {c: np.concatenate([b["attrs"][c] for b in blocks]) for c in blocks[0]["attrs"]}
    attrs["attr_span"] = np.concatenate(
        [b["attrs"]["attr_span"].astype(np.int64) + o for b, o in zip(blocks, offs)]
    ).astype(np.uint32)
    return {"cols": cols, "attrs": attrs}


def sort_by_trace(block: dict) -> dict:
    c = block["cols"]
    keys = np.concatenate([c["trace_id"], c["span_id"]], axis=1)
    order = np.lexsort(tuple(keys[:, i] for i in reversed(range(keys.shape[1]))))
    return select(block, order)


def trace_firsts(block: dict) -> np.ndarray:
    """First row of each trace (rows sorted by trace)."""
    tid = block["cols"]["trace_id"]
    new = np.ones(len(tid), bool)
    new[1:] = (tid[1:] != tid[:-1]).any(axis=1)
    return np.flatnonzero(new)


def pair(rng: np.random.Generator, n_traces: int, spans_per_trace: int, copy_every: int,
         t0_s: int, span_s: int, attrs_per_span: int) -> list:
    """Two blocks of n_traces traces each: the first fresh, the second
    fresh traces plus every copy_every-th trace of the first (a
    replication factor of 2's copies, row for row)."""
    a = traces(rng, n_traces, spans_per_trace, t0_s, span_s, attrs_per_span)
    copies = n_traces // copy_every
    fresh = traces(rng, n_traces - copies, spans_per_trace, t0_s, span_s, attrs_per_span)
    picked = trace_firsts(a)[::copy_every][:copies]
    rows = (picked[:, None] + np.arange(spans_per_trace)[None]).reshape(-1)
    b = sort_by_trace(concat([fresh, select(a, rows)]))
    return [a, b]


def shifted(block: dict, trace_xor: np.ndarray, shift_s: int) -> dict:
    """The block with limbs 1..3 of every trace ID XORed with trace_xor
    and every start moved by shift_s seconds: new trace IDs and a new
    time range for the same work. Rows are sorted again where two traces
    shared their first limb and swapped."""
    cols = dict(block["cols"])
    tid = cols["trace_id"].copy()
    tid[:, 1:] ^= trace_xor.astype(np.uint32)
    cols["trace_id"] = tid
    cols["start_unix_nano"] = cols["start_unix_nano"] + np.uint64(shift_s * 10**9)
    out = {"cols": cols, "attrs": block["attrs"]}
    keys = np.concatenate([tid, cols["span_id"]], axis=1)
    later = keys[1:] != keys[:-1]
    first = later.argmax(axis=1)
    ordered = keys[1:][np.arange(len(first)), first] > keys[:-1][np.arange(len(first)), first]
    return out if bool(ordered.all()) else sort_by_trace(out)
