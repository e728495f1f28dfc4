"""Port of tempo_tpu/jaeger_query.py, copied as is (host code).

Jaeger query bridge — serves the Jaeger HTTP query API from Tempo data.

Reference: cmd/tempo-query — a Jaeger storage backend that translates
GetTrace / FindTraces / GetServices / GetOperations into Tempo HTTP API
calls (cmd/tempo-query/tempo/plugin.go:45), so the Jaeger UI can browse
Tempo. The reference speaks the Jaeger gRPC storage-plugin protocol;
this bridge speaks the Jaeger *HTTP* query dialect (`/api/traces`,
`/api/services`, ...), which is what the Jaeger UI actually consumes,
and drives the engine through the same seams (trace-by-ID, search, tag
values).

Conversion follows the OTLP->Jaeger mapping the reference inherits from
jaeger/model: resource batches become processes (p1, p2, ...), span
attrs/kind/status become tags, nanos become micros.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from tempo_tpu_torch.encoding.common import SearchRequest
from tempo_tpu_torch.model.trace import KIND_CLIENT, KIND_CONSUMER, KIND_PRODUCER, KIND_SERVER, STATUS_ERROR, Trace

log = logging.getLogger(__name__)

_KIND_NAMES = {
    KIND_SERVER: "server",
    KIND_CLIENT: "client",
    KIND_PRODUCER: "producer",
    KIND_CONSUMER: "consumer",
}


def _tag(key: str, value) -> dict:
    if isinstance(value, bool):
        return {"key": key, "type": "bool", "value": value}
    if isinstance(value, int):
        return {"key": key, "type": "int64", "value": value}
    if isinstance(value, float):
        return {"key": key, "type": "float64", "value": value}
    return {"key": key, "type": "string", "value": str(value)}


def trace_to_jaeger(trace: Trace) -> dict:
    """One Tempo trace -> one Jaeger JSON trace object."""
    processes = {}
    spans = []
    for i, (resource, batch_spans) in enumerate(trace.batches):
        pid = f"p{i + 1}"
        processes[pid] = {
            "serviceName": resource.get("service.name", ""),
            "tags": [_tag(k, v) for k, v in sorted(resource.items()) if k != "service.name"],
        }
        for s in batch_spans:
            tags = [_tag(k, v) for k, v in sorted(s.attributes.items())]
            kind = _KIND_NAMES.get(s.kind)
            if kind:
                tags.append(_tag("span.kind", kind))
            if s.status_code == STATUS_ERROR:
                tags.append(_tag("error", True))
            refs = []
            if s.parent_span_id and s.parent_span_id != b"\x00" * 8:
                refs.append(
                    {
                        "refType": "CHILD_OF",
                        "traceID": trace.trace_id.hex(),
                        "spanID": s.parent_span_id.hex(),
                    }
                )
            spans.append(
                {
                    "traceID": trace.trace_id.hex(),
                    "spanID": s.span_id.hex(),
                    "operationName": s.name,
                    "references": refs,
                    "startTime": s.start_unix_nano // 1000,  # micros
                    "duration": max(s.duration_nano // 1000, 1),
                    "tags": tags,
                    "logs": [],
                    "processID": pid,
                }
            )
    return {"traceID": trace.trace_id.hex(), "spans": spans, "processes": processes}


class JaegerQueryBridge:
    """Translates Jaeger query calls onto an App (in-process) — the
    plugin.go Backend equivalent."""

    def __init__(self, app, tenant: str | None = None):
        self.app = app
        self.tenant = tenant

    def get_trace(self, trace_id_hex: str) -> dict | None:
        tid = bytes.fromhex(trace_id_hex.zfill(32))
        trace = self.app.find_trace(tid, org_id=self.tenant)
        return None if trace is None else trace_to_jaeger(trace)

    def get_services(self) -> list[str]:
        return self.app.search_tag_values("service.name", org_id=self.tenant)

    def get_operations(self, service: str) -> list[str]:
        # reference plugin narrows by service tag; name values are global
        # in the snapshot's tag API, so mirror that
        return self.app.search_tag_values("name", org_id=self.tenant)

    def find_traces(self, params: dict) -> list[dict]:
        """params: Jaeger /api/traces query params (service, operation,
        tags, start/end micros, minDuration, maxDuration, limit)."""
        return [trace_to_jaeger(t) for t in self.find_traces_model(params)]

    def _search_request(self, params: dict) -> SearchRequest:
        from tempo_tpu_torch.api.params import parse_duration_ns

        req = SearchRequest()
        tags = {}
        if params.get("service"):
            tags["service"] = params["service"]
        if params.get("operation"):
            tags["name"] = params["operation"]
        for k, v in json.loads(params.get("tags") or "{}").items():
            tags[k] = v
        req.tags = tags
        if params.get("start"):
            req.start_seconds = int(params["start"]) // 1_000_000
        if params.get("end"):
            req.end_seconds = int(params["end"]) // 1_000_000 + 1
        if params.get("minDuration"):
            req.min_duration_ns = parse_duration_ns(params["minDuration"])
        if params.get("maxDuration"):
            req.max_duration_ns = parse_duration_ns(params["maxDuration"])
        req.limit = int(params.get("limit") or 20)
        return req

    def find_traces_model(self, params: dict) -> list[Trace]:
        """Like find_traces but returning model Traces — the gRPC
        storage-plugin server (jaeger_plugin.py) encodes these into
        api_v2 spans instead of UI JSON."""
        req = self._search_request(params)
        resp = self.app.search(req, org_id=self.tenant)
        out = []
        for hit in resp.traces:
            tid = bytes.fromhex(hit.trace_id_hex.zfill(32))
            trace = self.app.find_trace(tid, org_id=self.tenant)
            if trace is not None:
                out.append(trace)
        return out


class JaegerQueryServer:
    """Jaeger HTTP query API endpoints over the bridge."""

    def __init__(self, bridge: JaegerQueryBridge, host: str = "127.0.0.1", port: int = 0):
        outer = self
        self.bridge = bridge

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, doc) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                url = urlparse(self.path)
                path = url.path.rstrip("/")
                qs = {k: v[0] for k, v in parse_qs(url.query).items()}
                b = outer.bridge
                try:
                    if path == "/api/services":
                        self._send(200, {"data": b.get_services(), "errors": None})
                    elif path.startswith("/api/services/") and path.endswith("/operations"):
                        svc = unquote(path[len("/api/services/"):-len("/operations")])
                        self._send(200, {"data": b.get_operations(svc), "errors": None})
                    elif path.startswith("/api/traces/"):
                        doc = b.get_trace(path[len("/api/traces/"):])
                        if doc is None:
                            self._send(404, {"data": None, "errors": [{"msg": "trace not found"}]})
                        else:
                            self._send(200, {"data": [doc], "errors": None})
                    elif path == "/api/traces":
                        self._send(200, {"data": b.find_traces(qs), "errors": None})
                    else:
                        self._send(404, {"data": None, "errors": [{"msg": "not found"}]})
                except ValueError as e:
                    self._send(400, {"data": None, "errors": [{"msg": str(e)}]})
                except Exception as e:  # noqa: BLE001
                    log.exception("jaeger bridge error")
                    self._send(500, {"data": None, "errors": [{"msg": str(e)}]})

        self._srv = ThreadingHTTPServer((host, port), _H)
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self._srv.server_address[0]}:{self._srv.server_address[1]}"

    def start(self) -> "JaegerQueryServer":
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        if self._thread:
            self._thread.join(timeout=2)
