"""Port of tempo_tpu/model/tags.py, copied as is (host code).

Tag-name/value enumeration over span batches.

Backs /api/search/tags and /api/search/tag/{name}/values (reference:
the ingester's SearchTags/SearchTagValues over live + local data,
modules/ingester/instance_search.go — in the snapshot era these
endpoints query ingesters only). Columnar form: tag names are the
dictionary-decoded attr_key codes plus the promoted well-known columns;
values come from the matching column or attr rows.
"""

from __future__ import annotations

import numpy as np

from tempo_tpu_torch.model.columnar import VT_BOOL, VT_FLOAT, VT_INT, VT_STR, SpanBatch

# promoted columns exposed as tags: tag name -> (column, kind)
WELL_KNOWN_TAGS = {
    "service.name": ("service", "dict"),
    "name": ("name", "dict"),
    "http.method": ("http_method", "dict"),
    "http.url": ("http_url", "dict"),
    "http.status_code": ("http_status", "int"),
}


def batch_tag_names(batch: SpanBatch) -> set[str]:
    return tag_names_from_columns(batch.cols, batch.attrs, batch.dictionary)


def tag_names_from_columns(cols: dict, attrs: dict, d) -> set[str]:
    """Column-dict form shared by live batches and backend row groups."""
    out: set[str] = set()
    for tag, (col, kind) in WELL_KNOWN_TAGS.items():
        vals = cols[col]
        if kind == "dict":
            if any(d[int(c)] != "" for c in np.unique(vals)):
                out.add(tag)
        elif np.any(vals != 0):
            out.add(tag)
    keys = attrs.get("attr_key")
    for code in np.unique(keys) if keys is not None and len(keys) else []:
        name = d[int(code)]
        if name:
            out.add(name)
    return out


def batch_tag_values(batch: SpanBatch, tag: str) -> set[str]:
    return tag_values_from_columns(batch.cols, batch.attrs, batch.dictionary, tag)


def tag_values_from_columns(cols: dict, attrs: dict, d, tag: str) -> set[str]:
    out: set[str] = set()
    wk = WELL_KNOWN_TAGS.get(tag)
    if wk is not None:
        col, kind = wk
        for c in np.unique(cols[col]):
            if kind == "dict":
                s = d[int(c)]
                if s:
                    out.add(s)
            elif c != 0:
                out.add(str(int(c)))
        return out
    code = d.get(tag)
    if code is None or attrs.get("attr_key") is None or not len(attrs["attr_key"]):
        return out
    mask = attrs["attr_key"] == code
    vts = attrs["attr_vtype"][mask]
    strs = attrs["attr_str"][mask]
    nums = attrs["attr_num"][mask]
    for vt, sc, num in zip(vts, strs, nums):
        if vt == VT_STR:
            s = d[int(sc)]
            if s:
                out.add(s)
        elif vt == VT_INT:
            out.add(str(int(num)))
        elif vt == VT_BOOL:
            out.add("true" if num else "false")
        elif vt == VT_FLOAT:
            out.add(repr(float(num)))
    return out


def block_tag_names(blk) -> set[str]:
    """Tag names of one backend block: native reader when the encoding
    has one, streamed-batch fallback otherwise (vrow1). The ONE home for
    this capability check — db._tag_fanout and the CLI both call it."""
    if hasattr(blk, "tag_names"):
        return set(blk.tag_names())
    out: set[str] = set()
    for batch in blk.iter_trace_batches():
        out |= batch_tag_names(batch)
    return out


def block_tag_values(blk, tag: str) -> set[str]:
    if hasattr(blk, "tag_values"):
        return set(blk.tag_values(tag))
    out: set[str] = set()
    for batch in blk.iter_trace_batches():
        out |= batch_tag_values(batch, tag)
    return out
