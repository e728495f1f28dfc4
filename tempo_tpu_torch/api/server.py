"""HTTP server: ingest receivers + query API + admin endpoints.

Reference: the weaveworks server hosted by cmd/tempo/app (HTTP API paths
pkg/api/http.go:54-62; admin endpoints /ready, /status/*, /metrics
cmd/tempo/app/app.go:237-516) and the receiver ports collapsed onto one
listener (the reference binds OTLP/Zipkin/Jaeger HTTP receivers on their
conventional ports; here every protocol rides the main listener, keyed
by path). stdlib ThreadingHTTPServer — no external HTTP framework in
the image.

Port of tempo_tpu/api/server.py for the single binary. Routes:
  POST /v1/traces            OTLP http (protobuf or json, gzip/deflate)
  GET  /api/traces/{id}      trace by ID (OTLP json; protobuf if Accept'd)
  GET  /api/search           tag search (tags=logfmt) or TraceQL (q=...)
  GET  /api/search/tags      tag names
  GET  /api/search/tag/{n}/values
  GET  /api/metrics/query_range   TraceQL metrics (Prometheus matrix)
  POST/GET/DELETE /api/metrics/standing[/{id}[/state]]  standing queries
  GET  /api/query-insights   per-query records + the compiled tier's cache stats
  GET  /api/echo             frontend liveness ("echo")
  POST /flush /shutdown
  GET  /ready /metrics /status[/config|/runtime_config|/services|
       /endpoints|/buildinfo|/standing|/device] and the ring pages
Every other route of the reference answers 404 naming the ROADMAP item
that ports it (_UNPORTED_ROUTES).
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
import traceback
from dataclasses import asdict, is_dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from tempo_tpu_torch import receivers, traceql
from tempo_tpu_torch.api import params as api_params
from tempo_tpu_torch.api.params import BadRequest
from tempo_tpu_torch.app import RoleUnavailable
from tempo_tpu_torch.modules.distributor import RateLimited
from tempo_tpu_torch.modules.ingester import MaxLiveTraces, TraceTooLarge
from tempo_tpu_torch.modules.queue import TooManyRequests
from tempo_tpu_torch.receivers import otlp
from tempo_tpu_torch.util import metrics, tracing
from tempo_tpu_torch.util.resource import ResourceExhausted

VERSION = "0.1.0"

log = logging.getLogger(__name__)

_Q1_2A = "ROADMAP Queue 1 item 1.2 (db/analytics)"
_Q1_2 = "ROADMAP Queue 1 item 2 (single binary: microservices and the other roles)"
_Q1_3 = "ROADMAP Queue 1 item 3 (query and ingest slices)"
# (exact paths, path prefixes, what, ROADMAP item) of the reference's
# routes that this port does not serve yet
_UNPORTED_ROUTES = (
    (("/api/v2/spans", "/api/v1/spans"), (), "the Zipkin receiver", _Q1_2),
    (("/api/traces",), (), "the Jaeger thrift receiver", _Q1_2),
    ((), ("/rpc/", "/kv/"), "inter-role RPC and the ring KV (microservices mode)", _Q1_2),
    (("/memberlist",), (), "the ring KV (netkv)", _Q1_2),
    (("/api/graph/dependencies", "/api/graph/critical-path", "/api/graph/walks"), (),
     "the graph/ analytics", _Q1_3),
    ((api_params.PATH_RCA, "/status/rca"), (api_params.PATH_RCA + "/",), "rca", _Q1_3),
    (("/status/slo",), (), "the SLO engine", _Q1_3),
    (("/status/profile", "/status/profile/device"), (), "util/profiling", _Q1_3),
    (("/status/storage",), (), "the storage analytics", _Q1_2A),
)


def _unported_route(method: str, path: str) -> str | None:
    """404 message for a reference route the port does not serve yet."""
    for exact, prefixes, what, item in _UNPORTED_ROUTES:
        if path in exact or path.startswith(prefixes):
            if path == "/api/traces" and method != "POST":
                continue  # GET /api/traces/{id} is served; the bare path is not a route
            return f"{path}: {what} is not ported yet ({item})"
    return None


_req_count = metrics.counter("tempo_request_duration_seconds_total", "HTTP requests by route/status")
_req_hist = metrics.histogram("tempo_request_duration_seconds", "HTTP request latency")
metrics.gauge("tempo_build_info", "Build information").set(1, version=VERSION)


def _dict_diff(current, defaults):
    """Nested keys in `current` that differ from `defaults`."""
    if not isinstance(current, dict) or not isinstance(defaults, dict):
        return current
    out = {}
    for k, v in current.items():
        if k not in defaults:
            out[k] = v
        elif isinstance(v, dict) and isinstance(defaults[k], dict):
            sub = _dict_diff(v, defaults[k])
            if sub:
                out[k] = sub
        elif v != defaults[k]:
            out[k] = v
    return out


def _config_dict(cfg) -> dict:
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return asdict(cfg)
    if hasattr(cfg, "__dict__"):
        return {k: _config_dict(v) if is_dataclass(v) else v for k, v in vars(cfg).items()}
    return cfg


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "tempo-tpu/" + VERSION

    # set by server factory
    app = None
    endpoints: list[str] = []

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("http: " + fmt, *args)

    # -- plumbing ------------------------------------------------------
    def _send(self, code: int, body: bytes, content_type: str = "application/json",
              headers: dict | None = None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        try:
            self.wfile.write(body)
        except BrokenPipeError:
            pass

    def _send_json(self, code: int, doc) -> None:
        self._send(code, json.dumps(doc).encode())

    def _send_error(self, code: int, msg: str, headers: dict | None = None) -> None:
        # error paths may not have drained the request body; keeping the
        # HTTP/1.1 connection alive would desync the next request on the
        # socket with the unread bytes
        self.close_connection = True
        self._send(code, (msg.rstrip("\n") + "\n").encode(),
                   "text/plain; charset=utf-8", headers=headers)

    def _send_shed(self, e: Exception) -> None:
        """One shape for every shed/backpressure rejection: 429 with a
        Retry-After computed from the limiter refill / governor state, so
        well-behaved clients pace their retries instead of hammering
        (reference: the distributor's rate-limit translation plus dskit's
        Retry-After middleware)."""
        retry_after = max(1, math.ceil(getattr(e, "retry_after_s", 1.0)))
        self._send_error(429, str(e), headers={"Retry-After": str(retry_after)})

    def _org_id(self) -> str | None:
        return self.headers.get("X-Scope-OrgID")

    def _body(self) -> bytes:
        if (self.headers.get("Transfer-Encoding") or "").lower() == "chunked":
            body = bytearray()
            while True:
                size_line = self.rfile.readline(1024).strip()
                size = int(size_line.split(b";")[0], 16)
                if size == 0:
                    self.rfile.readline(1024)  # trailing CRLF after last-chunk
                    break
                body += self.rfile.read(size)
                self.rfile.read(2)  # chunk CRLF
            body = bytes(body)
        else:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
        return receivers.decompress_body(body, self.headers.get("Content-Encoding", ""))

    # -- dispatch ------------------------------------------------------
    def do_GET(self):  # noqa: N802
        self._route("GET")

    def do_POST(self):  # noqa: N802
        self._route("POST")

    # routed so APIs answer 405 (method known, not allowed here) instead
    # of the stdlib's blanket 501
    def do_PUT(self):  # noqa: N802
        self._route("PUT")

    def do_DELETE(self):  # noqa: N802
        self._route("DELETE")

    def _route_template(self, path: str) -> str:
        """Collapse id-bearing paths to templates so metric label
        cardinality stays bounded."""
        p = path.rstrip("/") or "/"
        if p.startswith(api_params.PATH_TRACES + "/"):
            return api_params.PATH_TRACES + "/{traceID}"
        if p.startswith(api_params.PATH_SEARCH_TAG_VALUES + "/") and p.endswith("/values"):
            return api_params.PATH_SEARCH_TAG_VALUES + "/{name}/values"
        if p.startswith(api_params.PATH_METRICS_STANDING + "/"):
            if p.endswith("/state"):
                return api_params.PATH_METRICS_STANDING + "/{id}/state"
            return api_params.PATH_METRICS_STANDING + "/{id}"
        if p.startswith(("/rpc/", "/kv/", api_params.PATH_RCA + "/")):
            return "{unported}"
        return p

    # paths that poll/long-poll constantly: a root span per request
    # would flood the dogfood tenant with noise traces (the reference
    # similarly leaves health/metrics endpoints uninstrumented)
    _UNTRACED = ("/metrics", "/ready")

    def _traced_handle(self, method: str, url, route: str) -> int:
        """Extract the inbound W3C traceparent (reference: the server's
        otelhttp middleware) and open one server span per request, so an
        instrumented client's push/query and our internal RPC hops land
        in one coherent trace."""
        if not tracing.TRACER.enabled or route in self._UNTRACED:
            return self._handle(method, url)
        with tracing.remote_context(self.headers.get(tracing.TRACEPARENT_HEADER)):
            with tracing.span(f"http/{method} {route}", route=route) as s:
                code = self._handle(method, url)
                if s is not None:
                    s.attributes["status_code"] = code
                return code

    def _route(self, method: str) -> None:
        start = time.monotonic()
        url = urlparse(self.path)
        route = self._route_template(url.path)
        code = 500
        try:
            code = self._traced_handle(method, url, route)
        except BadRequest as e:
            code = 400
            self._send_error(400, str(e))
        except traceql.ParseError as e:
            # malformed or ill-typed query is the caller's error
            # (reference maps TraceQL parse/validate errors to 400)
            code = 400
            self._send_error(400, str(e))
        except receivers.UnsupportedPayload as e:
            code = 400
            self._send_error(400, str(e))
        except PermissionError as e:
            code = 401
            self._send_error(401, str(e))
        except (RateLimited, ResourceExhausted, TooManyRequests) as e:
            # rate limits AND overload sheds: 429 with a Retry-After hint
            code = 429
            self._send_shed(e)
        except (TraceTooLarge, MaxLiveTraces) as e:
            # reference maps resource-exhausted pushes to 429 (distributor
            # push error translation)
            code = 429
            self._send_error(429, str(e))
        except RoleUnavailable as e:
            # endpoint exists but this process doesn't serve it (or the
            # port does not serve it yet)
            code = 404
            self._send_error(404, str(e))
        except Exception:
            code = 500
            log.error("internal error on %s %s:\n%s", method, route, traceback.format_exc())
            self._send_error(500, "internal error")
        finally:
            _req_count.inc(method=method, route=route, status_code=str(code))
            _req_hist.observe(time.monotonic() - start, method=method, route=route)

    def _handle(self, method: str, url) -> int:
        path = url.path.rstrip("/") or "/"
        qs = parse_qs(url.query)
        app = self.app

        msg = _unported_route(method, path)
        if msg is not None:
            raise RoleUnavailable(msg)

        # ingest
        if method == "POST" and path == receivers.OTLP_HTTP_PATH:
            ct = self.headers.get("Content-Type", "")
            body = self._body()
            # columnar fast path: OTLP decodes straight into a SpanBatch
            # (the forwarder tee that needs object traces is not ported)
            try:
                batch = receivers.decode_http_columnar(path, ct, body)
            except (ValueError, OSError, TypeError, AttributeError, KeyError) as e:
                # wire/json decode errors and shape-invalid JSON
                raise BadRequest(f"malformed payload: {e}") from e
            try:
                if batch.num_spans:
                    app.push_spans(batch, org_id=self._org_id())
            except ValueError as e:
                # distributor admission contract: ValueError = the
                # request can never be admitted (e.g. one batch over
                # the whole inflight budget) — client error, not 500
                raise BadRequest(str(e)) from e
            # OTLP/HTTP: response content type must match the request;
            # empty ExportTraceServiceResponse = empty proto message
            if "json" in ct:
                self._send(200, b"{}")
            else:
                self._send(200, b"", "application/x-protobuf")
            return 200

        # standing queries (tempo_tpu_torch/standing): registration +
        # incremental reads + alert state, tenant-scoped. Served by
        # ingester-owning processes (the cut path folds there).
        if path == api_params.PATH_METRICS_STANDING or path.startswith(
                api_params.PATH_METRICS_STANDING + "/"):
            return self._standing(method, path, qs)

        if method != "GET" and path not in ("/flush", "/shutdown"):
            self._send_error(405, "method not allowed")
            return 405

        # query API
        if path.startswith(api_params.PATH_TRACES + "/"):
            return self._trace_by_id(path[len(api_params.PATH_TRACES) + 1 :], qs)
        if path == api_params.PATH_SEARCH:
            return self._search(qs)
        if path == api_params.PATH_METRICS_QUERY_RANGE:
            return self._query_range(qs)
        if path == api_params.PATH_SEARCH_TAGS:
            self._send_json(200, {"tagNames": app.search_tags(org_id=self._org_id())})
            return 200
        if path.startswith(api_params.PATH_SEARCH_TAG_VALUES + "/") and path.endswith("/values"):
            tag = unquote(path[len(api_params.PATH_SEARCH_TAG_VALUES) + 1 : -len("/values")])
            self._send_json(200, {"tagValues": app.search_tag_values(tag, org_id=self._org_id())})
            return 200
        if path == api_params.PATH_USAGE:
            # tenant-scoped cost rollup (util/usage): a tenant sees only
            # its own vectors
            from tempo_tpu_torch.util import usage as usage_mod

            tenant = app.resolve_tenant(self._org_id())
            doc = usage_mod.usage_report(tenant).get("tenants", {}).get(tenant, {})
            self._send_json(200, {
                "tenant": tenant,
                "kinds": doc.get("kinds", {}),
                "total": doc.get("total", {}),
            })
            return 200
        if path == api_params.PATH_QUERY_INSIGHTS:
            # the query-insights ring (util/insights): sampled + slow/
            # error-triggered per-query records, tenant-scoped
            from tempo_tpu_torch.compiled import cache as compiled_cache
            from tempo_tpu_torch.util import insights as insights_mod

            tenant = app.resolve_tenant(self._org_id())
            try:
                limit = int(qs.get("limit", ["50"])[0])
            except ValueError as e:
                raise BadRequest(f"bad limit: {e}") from e
            self._send_json(200, {
                "tenant": tenant,
                "insights": insights_mod.LOG.snapshot(tenant, limit=limit),
                # the compiled tier's cache roll-up behind the records'
                # compiledShape field: shapes/programs cached, hits,
                # misses, compiles, evictions
                "compiled": compiled_cache.shape_cache().stats(),
            })
            return 200
        if path == api_params.PATH_ECHO:
            self._send(200, b"echo", "text/plain; charset=utf-8")
            return 200

        # ring + membership status pages (reference: GET /{role}/ring and
        # /memberlist debug pages, docs/tempo api_docs + dskit ring http)
        if path in ("/ingester/ring", "/distributor/ring", "/compactor/ring",
                    "/metrics-generator/ring"):
            if path == "/metrics-generator/ring":
                ring = None  # the generator is not ported (App refuses it)
            elif path == "/compactor/ring":
                # the compactor's OWN ring (job-hash sharding), not the
                # data ring — None when compaction runs unsharded
                ring = getattr(app.compactor, "ring", None) if app.compactor else None
            else:
                ring = app.ring
            if ring is None:
                self._send_json(200, {"enabled": False})
                return 200
            now = time.time()
            self._send_json(200, {
                "enabled": True,
                "replication_factor": ring.replication_factor,
                "heartbeat_timeout_s": ring.heartbeat_timeout_s,
                "instances": [
                    {
                        "id": i.instance_id,
                        "addr": i.addr,
                        "state": i.state,
                        "tokens": len(i.tokens),
                        "heartbeat_age_s": round(now - i.heartbeat, 1) if i.heartbeat else None,
                        "healthy": i.healthy(ring.heartbeat_timeout_s, now),
                    }
                    for i in sorted(ring.instances(), key=lambda i: i.instance_id)
                ],
            })
            return 200
        # admin — side-effecting endpoints require POST: the reference
        # registers them for GET too, but a GET with side effects is one
        # crawler/prefetcher away from an accidental drain if the admin
        # port ever leaks
        if path in ("/flush", "/shutdown") and method != "POST":
            self._send_error(405, f"{path} requires POST")
            return 405
        if path == "/flush":
            # cut + drain everything now (reference FlushHandler,
            # modules/ingester/flush.go:170 'no jitter if immediate')
            if not app.ingesters:
                raise RoleUnavailable("no ingester in this process")
            for ing in app.ingesters.values():
                ing.flush_all()
            self._send(204, b"", "text/plain; charset=utf-8")
            return 204
        if path == "/shutdown":
            # graceful drain then terminate (reference ShutdownHandler,
            # modules/ingester/flush.go:88-114: flush, exit ring, stop)
            if not app.ingesters:
                raise RoleUnavailable("no ingester in this process")
            for ing in app.ingesters.values():
                ing.flush_all()
            req = getattr(app, "on_shutdown_request", None)
            if req is None:
                # embedded server (tests, library use): nobody owns the
                # process lifecycle, so acking termination would be a lie
                self._send(200, b"flushed; no process manager, not terminating",
                           "text/plain; charset=utf-8")
                return 200
            # response goes out BEFORE the stop fires so the client
            # reliably sees the ack rather than a reset mid-write
            self._send(200, b"shutdown job acknowledged", "text/plain; charset=utf-8")
            req()
            return 200
        if path == "/ready":
            self._send(200, b"ready", "text/plain; charset=utf-8")
            return 200
        if path == "/metrics":
            self._send(200, metrics.expose().encode(), "text/plain; version=0.0.4")
            return 200
        if path == "/status" or path == "/status/endpoints":
            self._send_json(200, {"endpoints": self.endpoints})
            return 200
        if path == "/status/buildinfo":
            self._send_json(200, {"version": VERSION, "goVersion": "n/a", "pythonNative": True})
            return 200
        if path == "/status/config":
            # ?mode=defaults dumps a pristine config; ?mode=diff only the
            # keys changed from defaults (reference writeStatusConfig,
            # cmd/tempo/app/app.go:246-270)
            mode = qs.get("mode", [""])[0]
            if mode == "defaults":
                self._send_json(200, _config_dict(type(app.cfg)()))
            elif mode == "diff":
                self._send_json(
                    200, _dict_diff(_config_dict(app.cfg), _config_dict(type(app.cfg)()))
                )
            elif mode == "":
                self._send_json(200, _config_dict(app.cfg))
            else:
                raise BadRequest(f"unknown config mode {mode!r}")
            return 200
        if path == "/status/runtime_config":
            # hot-reloaded per-tenant overrides (reference: runtime_config
            # status endpoint, cmd/tempo/app/app.go:364)
            ov = getattr(app, "overrides", None)
            if ov is None:
                self._send_json(200, {"defaults": {}, "tenants": {}})
            else:
                ov.maybe_reload()
                doc = {
                    "defaults": _config_dict(ov.for_tenant("")),
                    "tenants": {
                        t: _config_dict(ov.for_tenant(t)) for t in ov.tenants_with_overrides()
                    },
                }
                self._send_json(200, doc)
            return 200
        if path == "/status/services":
            self._send_json(200, app.service_states() if hasattr(app, "service_states") else {"app": "Running"})
            return 200
        if path == "/status/usage":
            # operator view: every tenant's cost vectors
            from tempo_tpu_torch.util import usage as usage_mod

            self._send_json(200, usage_mod.usage_report())
            return 200
        if path == "/status/usage-stats":
            # the anonymous usage reporter is not ported (its config
            # section is refused), so no report is ever built
            self._send_json(200, {"enabled": False})
            return 200
        if path == "/status/device":
            # device data-movement plane (util/pageheat + devicetiming):
            # per-kernel transfer bytes, the (block, column) page-heat
            # hot set with transfer amplification, the ghost-LRU what-if
            # curve and the resident tier's state.
            # ?budgets_mb=64,128,256 overrides the working-set-fraction
            # budgets; ?top=N bounds the hot-set report.
            from tempo_tpu_torch.util import pageheat

            budgets = None
            raw = qs.get("budgets_mb", [""])[0]
            if raw:
                try:
                    budgets = [int(float(b) * (1 << 20))
                               for b in raw.split(",") if b.strip()]
                except (ValueError, OverflowError) as e:
                    # OverflowError: int(inf * 2**20) — same client error
                    raise BadRequest(f"bad budgets_mb: {e}") from e
                if not budgets or any(b <= 0 for b in budgets):
                    raise BadRequest(
                        f"bad budgets_mb {raw!r}: need positive MB values")
            try:
                top = int(qs.get("top", ["50"])[0])
            except ValueError as e:
                raise BadRequest(f"bad top: {e}") from e
            self._send_json(200, pageheat.device_report(
                budgets_bytes=budgets, top=top))
            return 200
        if path == "/status/standing":
            # operator view of the standing-query engine: registration
            # and fold totals plus the per-tenant cut-delta counters
            eng = getattr(app, "standing", None)
            if eng is None:
                self._send_json(200, {"enabled": False})
            else:
                self._send_json(200, {"enabled": True, **eng.status()})
            return 200
        self._send_error(404, "not found")
        return 404

    # -- standing queries ----------------------------------------------
    def _standing(self, method: str, path: str, qs: dict) -> int:
        from tempo_tpu_torch.standing import UnknownStandingQuery
        from tempo_tpu_torch.standing.engine import StandingFoldFailed

        app, org = self.app, self._org_id()
        tail = path[len(api_params.PATH_METRICS_STANDING):].strip("/")
        try:
            if not tail:
                if method == "POST":
                    try:
                        body = json.loads(self._body() or b"{}")
                    except ValueError as e:
                        raise BadRequest(f"bad json body: {e}") from e
                    if not isinstance(body, dict):
                        raise BadRequest("body must be a json object")
                    try:
                        doc = app.standing_register(body, org_id=org)
                    except (ValueError, TypeError) as e:
                        raise BadRequest(str(e)) from e
                    self._send_json(200, doc)
                    return 200
                if method == "GET":
                    self._send_json(200, {"queries": app.standing_list(org_id=org)})
                    return 200
                self._send_error(405, "method not allowed")
                return 405
            parts = tail.split("/")
            qid = parts[0]
            if len(parts) == 2 and parts[1] == "state" and method == "GET":
                self._send_json(200, app.standing_state(qid, org_id=org))
                return 200
            if len(parts) != 1:
                self._send_error(404, "not found")
                return 404
            if method == "DELETE":
                app.standing_delete(qid, org_id=org)
                self._send(204, b"", "text/plain; charset=utf-8")
                return 204
            if method == "GET":
                req = api_params.parse_standing_read_request(qs)
                try:
                    doc = app.standing_read(qid, org_id=org,
                                            start_s=req.start_s,
                                            end_s=req.end_s,
                                            step_s=req.step_s)
                except ValueError as e:
                    raise BadRequest(str(e)) from e
                stats = doc.pop("stats", {})
                self._send_json(200, {
                    "status": "success",
                    "data": {"resultType": doc["resultType"],
                             "result": doc["result"]},
                    "metrics": stats,
                })
                return 200
            self._send_error(405, "method not allowed")
            return 405
        except UnknownStandingQuery:
            self._send_error(404, "no such standing query")
            return 404
        except StandingFoldFailed as e:
            # the card's fold arm failed: no host rebuild stands in for it
            self._send_error(500, str(e))
            return 500

    # -- query handlers ------------------------------------------------
    def _trace_by_id(self, tail: str, qs: dict) -> int:
        trace_id = api_params.parse_trace_id(tail)
        trace = self.app.find_trace(trace_id, org_id=self._org_id())
        if trace is None:
            self._send_error(404, "trace not found")
            return 404
        accept = self.headers.get("Accept", "")
        if "application/protobuf" in accept or "application/x-protobuf" in accept:
            self._send(200, otlp.encode_traces_request([trace]), "application/protobuf")
            return 200
        self._send_json(200, otlp.encode_traces_json([trace]))
        return 200

    def _query_range(self, qs: dict) -> int:
        """TraceQL metrics: Prometheus-compatible query_range matrix
        (reference: api.PathMetricsQueryRange + the Prometheus HTTP API
        response envelope, so Grafana's Prometheus datasource can graph
        it directly)."""
        req = api_params.parse_query_range_request(qs)
        t0 = time.monotonic()
        try:
            doc = self.app.query_range(
                req.query, req.start_s, req.end_s, req.step_s,
                org_id=self._org_id(), max_series=req.max_series,
                exemplars=req.exemplars,
            )
        except ValueError as e:
            # the metrics planner's contract: ValueError = range/size
            # problem, a client error end to end
            raise BadRequest(str(e)) from e
        stats = doc.pop("stats", {})
        stats["elapsedMs"] = int((time.monotonic() - t0) * 1000)
        stats["inspectedBytes"] = str(stats.get("inspectedBytes", 0))
        stats["decodedBytes"] = str(stats.get("decodedBytes", 0))
        self._send_json(200, {
            # "partial" when terminal shard failures stayed within the
            # tenant's failed-shard budget (stats.failedShards says how
            # many); "success" otherwise
            "status": doc.pop("status", "success"),
            "data": {"resultType": doc["resultType"], "result": doc["result"]},
            "exemplars": doc.get("exemplars", []),
            "metrics": stats,
        })
        return 200

    def _search(self, qs: dict) -> int:
        req = api_params.parse_search_request(qs)
        org = self._org_id()
        try:
            return self._search_inner(req, org)
        except ValueError as e:
            # the frontend's contract on both search paths: ValueError =
            # window/size/admission problem, a client error end to end
            # ("narrow the time range", max_search_duration, ...) — the
            # guidance must reach the caller as 400, not vanish into a
            # 500 that retrying clients hammer
            raise BadRequest(str(e)) from e

    def _search_inner(self, req, org) -> int:
        if req.query:
            stats: dict = {}
            t0 = time.monotonic()
            hits = self.app.traceql(
                req.query,
                org_id=org,
                start_s=req.start_seconds,
                end_s=req.end_seconds,
                limit=req.limit,
                stats=stats,
            )
            doc = {
                "traces": [t.to_dict() for t in hits],
                # per-query stats (reference: modules/querier/stats proto
                # surfaced in the search response)
                "metrics": {
                    "inspectedTraces": stats.get("inspectedTraces", 0),
                    "inspectedBytes": str(stats.get("inspectedBytes", 0)),
                    "decodedBytes": str(stats.get("decodedBytes", 0)),
                    "inspectedBlocks": stats.get("inspectedBlocks", 0),
                    "elapsedMs": int((time.monotonic() - t0) * 1000),
                    # the execution waterfall (util/stagetimings): where
                    # this query's milliseconds and dispatches went
                    "stageSeconds": stats.get("stageSeconds", {}),
                    "deviceDispatches": stats.get("deviceDispatches", 0),
                },
            }
        else:
            t0 = time.monotonic()
            resp = self.app.search(req, org_id=org)
            doc = {
                "traces": [t.to_dict() for t in resp.traces],
                "metrics": {
                    "inspectedTraces": resp.inspected_traces,
                    "inspectedBytes": str(resp.inspected_bytes),
                    "decodedBytes": str(resp.decoded_bytes),
                    "inspectedBlocks": resp.inspected_blocks,
                    "elapsedMs": int((time.monotonic() - t0) * 1000),
                    "stageSeconds": resp.stage_seconds,
                    "deviceDispatches": resp.device_dispatches,
                },
            }
        self._send_json(200, doc)
        return 200


_ENDPOINTS = [
    "POST /v1/traces",
    "GET /api/traces/{traceID}",
    "GET /api/search",
    "GET /api/search/tags",
    "GET /api/search/tag/{name}/values",
    "GET /api/metrics/query_range",
    "POST /api/metrics/standing",
    "GET /api/metrics/standing",
    "GET /api/metrics/standing/{id}",
    "GET /api/metrics/standing/{id}/state",
    "DELETE /api/metrics/standing/{id}",
    "GET /api/query-insights",
    "GET /api/echo",
    "GET /ready",
    "GET /metrics",
    "GET /status",
    "GET /status/buildinfo",
    "GET /status/config",
    "GET /status/services",
    "GET /status/endpoints",
    "GET /status/device",
    "GET /status/standing",
    "GET /status/runtime_config",
    "POST /flush",
    "POST /shutdown",
    "GET /ingester/ring",
    "GET /distributor/ring",
    "GET /compactor/ring",
    "GET /metrics-generator/ring",
]


class TempoServer:
    """Owns the listener; one instance per process/role."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"app": app, "endpoints": _ENDPOINTS})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "TempoServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="tempo-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
