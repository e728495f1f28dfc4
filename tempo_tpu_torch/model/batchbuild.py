"""Port of tempo_tpu/model/batchbuild.py, copied as is (host code).

Columnar batch builder for the receive path.

`BatchBuilder` accumulates span fields straight into per-column buffers
(byte strings for IDs, flat Python lists for scalars, deferred strings
for everything dictionary-coded) and materializes one `SpanBatch` at the
end. Receivers and `traces_to_batch` write rows through it instead of
building `Span`/`Trace` object trees and re-walking them per span —
dictionary hashing collapses to one `Dictionary.add_many` per string
column (work per unique value, not per row), IDs land as one
`np.frombuffer` over the concatenated bytes, and well-known span attrs
promote to their dedicated columns exactly as the object path did.

Semantics match `trace.traces_to_batch` exactly: the same promotion of
http.method/url/status_code, the same VT_* typing for generic attrs,
and the same attr-row order (a span's own attrs, then its resource's
extra attrs, in row order). Dictionary code NUMBERING may differ (codes
are assigned per unique value in sorted order rather than encounter
order) — codes are batch-internal and every consumer resolves strings
through the dictionary, so this is unobservable outside the raw arrays.
"""

from __future__ import annotations

import numpy as np

from tempo_tpu_torch.model.columnar import (
    ATTR_COLUMNS,
    SCOPE_RESOURCE,
    SCOPE_SPAN,
    VT_BOOL,
    VT_FLOAT,
    VT_INT,
    VT_STR,
    Dictionary,
    SpanBatch,
)

_ZERO8 = b"\x00" * 8


class BatchBuilder:
    def __init__(self, dictionary: Dictionary | None = None):
        self.dictionary = dictionary or Dictionary()
        self._n = 0
        self._tid = bytearray()
        self._sid = bytearray()
        self._pid = bytearray()
        self._start: list = []
        self._dur: list = []
        self._kind: list = []
        self._status: list = []
        self._name: list = []  # str per span, encoded at build
        self._grp: list = []  # resource-group index per span
        self._grp_service: list = []  # service.name str per group
        self._hstat: list = []
        self._hmeth: list = []  # "" = absent (code 0 either way)
        self._hurl: list = []
        self._a_span: list = []
        self._a_scope: list = []
        self._a_key: list = []  # str, encoded at build
        self._a_vt: list = []
        self._a_str: list = []  # str for VT_STR, "" otherwise (code 0)
        self._a_num: list = []
        self._cur_extra: list = []

    @property
    def num_spans(self) -> int:
        return self._n

    def begin_resource(self, resource: dict) -> None:
        """Open a resource group: spans added until the next call belong
        to it. service.name promotes to the dedicated column; the other
        resource attrs replicate into each span's attr rows (the same
        flattening the object path does)."""
        self._grp_service.append(str(resource.get("service.name", "")))
        self._cur_extra = [(k, v) for k, v in resource.items()
                           if k != "service.name"]

    def add_span(self, trace_id: bytes, span_id: bytes,
                 parent_span_id: bytes, name: str, kind: int,
                 start_unix_nano: int, duration_nano: int, status_code: int,
                 attributes: dict | None = None) -> None:
        row = self._n
        self._n = row + 1
        self._tid += trace_id.rjust(16, b"\x00")[-16:]
        self._sid += span_id.rjust(8, b"\x00")[-8:]
        self._pid += (parent_span_id or _ZERO8).rjust(8, b"\x00")[-8:]
        self._start.append(start_unix_nano)
        self._dur.append(duration_nano)
        self._kind.append(kind)
        self._status.append(status_code)
        self._name.append(name)
        self._grp.append(len(self._grp_service) - 1)
        hs, hm, hu = 0, "", ""
        if attributes:
            for k, v in attributes.items():
                if k == "http.status_code":
                    hs = int(v)
                elif k == "http.method":
                    hm = str(v)
                elif k == "http.url":
                    hu = str(v)
                else:
                    self._attr(row, SCOPE_SPAN, k, v)
        for k, v in self._cur_extra:
            self._attr(row, SCOPE_RESOURCE, k, v)
        self._hstat.append(hs)
        self._hmeth.append(hm)
        self._hurl.append(hu)

    def _attr(self, row: int, scope: int, key: str, value) -> None:
        if isinstance(value, bool):
            vt, num, sval = VT_BOOL, float(value), ""
        elif isinstance(value, int):
            vt, num, sval = VT_INT, float(value), ""
        elif isinstance(value, float):
            vt, num, sval = VT_FLOAT, value, ""
        else:
            vt, num, sval = VT_STR, 0.0, str(value)
        self._a_span.append(row)
        self._a_scope.append(scope)
        self._a_key.append(key)
        self._a_vt.append(vt)
        self._a_str.append(sval)
        self._a_num.append(num)

    def build(self) -> SpanBatch:
        d = self.dictionary
        n = self._n
        cols = {
            "trace_id": np.frombuffer(bytes(self._tid), dtype=">u4")
            .reshape(n, 4).astype(np.uint32),
            "span_id": np.frombuffer(bytes(self._sid), dtype=">u4")
            .reshape(n, 2).astype(np.uint32),
            "parent_span_id": np.frombuffer(bytes(self._pid), dtype=">u4")
            .reshape(n, 2).astype(np.uint32),
            "start_unix_nano": np.asarray(self._start, dtype=np.uint64),
            "duration_nano": np.asarray(self._dur, dtype=np.uint64),
            "kind": np.asarray(self._kind, dtype=np.uint8),
            "status_code": np.asarray(self._status, dtype=np.uint8),
            "name": d.add_many(self._name),
            "http_status": np.asarray(self._hstat, dtype=np.uint16),
            "http_method": d.add_many(self._hmeth),
            "http_url": d.add_many(self._hurl),
        }
        svc = d.add_many(self._grp_service)
        cols["service"] = (svc[np.asarray(self._grp, dtype=np.intp)]
                           if n else np.empty(0, np.uint32))
        attrs = {
            "attr_span": np.asarray(self._a_span, dtype=np.uint32),
            "attr_scope": np.asarray(self._a_scope, dtype=np.uint8),
            "attr_key": d.add_many(self._a_key),
            "attr_vtype": np.asarray(self._a_vt, dtype=np.uint8),
            "attr_str": d.add_many(self._a_str),
            "attr_num": np.asarray(self._a_num, dtype=np.float64),
        }
        for k, (dt, _) in ATTR_COLUMNS.items():
            if attrs[k].shape[0] == 0:
                attrs[k] = np.empty(0, dtype=dt)
        return SpanBatch(cols=cols, attrs=attrs, dictionary=d)
