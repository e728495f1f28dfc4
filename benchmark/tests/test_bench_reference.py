"""The reference's answers on a small hand-checked case."""

import numpy as np

from benchmark import reference, spans

H = 1_699_999_200


def _block():
    """Two traces of two spans: trace 1 = root (frontend, GET /api/products,
    start H+10 s, 200 ms; region=v7) and a child (cart, db.query, start
    H+70 s, 50 ms); trace 2 = root (cart, render, H+65 s, 2 s) and a child
    (cart, db.query, H+66 s, 150 ms, status 500)."""
    s = spans.code
    cols = {
        "trace_id": np.array([[0, 0, 0, 1]] * 2 + [[0, 0, 0, 2]] * 2, np.uint32),
        "span_id": np.array([[0, 1], [0, 2], [0, 3], [0, 4]], np.uint32),
        "parent_span_id": np.array([[0, 0], [0, 1], [0, 0], [0, 3]], np.uint32),
        "start_unix_nano": np.array([H + 10, H + 70, H + 65, H + 66], np.uint64) * 10**9,
        "duration_nano": np.array([200, 50, 2000, 150], np.uint64) * 10**6,
        "kind": np.full(4, 2, np.uint8),
        "status_code": np.array([0, 0, 0, 2], np.uint8),
        "name": np.array([s("GET /api/products"), s("db.query"), s("render"), s("db.query")],
                         np.uint32),
        "service": np.array([s("frontend"), s("cart"), s("cart"), s("cart")], np.uint32),
        "http_status": np.array([200, 200, 200, 500], np.uint16),
        "http_method": np.array([s("GET")] * 4, np.uint32),
        "http_url": np.array([s("http://svc/0")] * 4, np.uint32),
    }
    attrs = {"attr_span": np.array([0], np.uint32), "attr_scope": np.zeros(1, np.uint8),
             "attr_key": np.array([s("region")], np.uint32),
             "attr_vtype": np.array([spans.VT_STR], np.uint8),
             "attr_str": np.array([s("v7")], np.uint32), "attr_num": np.zeros(1)}
    return {"cols": cols, "attrs": attrs}


def test_range_counts_by_step_and_filter():
    b = _block()
    where = [["resource.service.name", "=", "cart"]]
    assert reference.range_counts([b], where, H, H + 180, 60).tolist() == [0, 3, 0]
    assert reference.range_counts([b, b], where, H, H + 180, 60).tolist() == [0, 6, 0]
    slow = [["resource.service.name", "!=", "cart"], ["duration", ">", "100ms"]]
    assert reference.range_counts([b], slow, H, H + 180, 60).tolist() == [1, 0, 0]
    assert reference.range_values([b], "rate", where, H, H + 180, 60)[1] == 3 / 60
    assert reference.range_counts([b], [["span.http.method", "!~", "^G"]], H, H + 120,
                                  60).tolist() == [0, 0]


def test_judge_query_range_in_spans():
    ref = reference.RangeReference([_block()])
    spec = {"func": "rate", "where": [["name", "=", "db.query"]], "start": H, "end": H + 120,
            "step": 60}
    served = [{"values": [[H, "0"], [H + 60, str(2 / 60)]]}]
    assert reference.judge_query_range(ref, spec, served) < 1e-9
    off = [{"values": [[H, "0"], [H + 60, str(3 / 60)]]}]
    assert abs(reference.judge_query_range(ref, spec, off) - 1) < 1e-9
    assert reference.judge_query_range(ref, spec, []) == float("inf")


def test_a_trace_keeps_a_copied_span_once():
    b = _block()
    spans_ = reference.trace_of([b, b], b["cols"]["trace_id"][0])
    assert len(spans_) == 2 and {s[4] for s in spans_} == {"GET /api/products", "db.query"}


def test_key_gap_counts_a_kept_copy_and_a_lost_or_foreign_span():
    b = _block()
    want = reference.span_keys([b, b])
    keys = np.concatenate([b["cols"]["trace_id"], b["cols"]["span_id"]], axis=1)
    assert len(want) == 4 and reference.key_gap(keys, want) == 0
    assert reference.key_gap(np.concatenate([keys, keys[:1]]), want) == 1
    assert reference.key_gap(keys[1:], want) == 2
    foreign = keys.copy()
    foreign[0, -1] = 9
    assert reference.key_gap(foreign, want) == 2
