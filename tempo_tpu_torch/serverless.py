"""Port of tempo_tpu/serverless.py, copied as is (host code).

Serverless backend search — stateless one-block search handler.

Reference: cmd/tempo-serverless/handler.go — a function deployment
(Lambda / Cloud Run) where one HTTP request = "search N pages of one
block"; the handler builds its reader once per instance (handler.go:39-44,
config from environment), opens the block named by the querystring, and
returns search results. The querier offloads burst backend-search jobs
to such endpoints (modules/querier/querier.go:540
searchExternalEndpoint).

Here the handler opens blocks straight from a RawBackend (no engine,
no blocklist, no WAL — truly stateless) and the server half is a thin
stdlib HTTP wrapper so the same handler runs under any FaaS shim.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tempo_tpu_torch import encoding as encoding_registry
from tempo_tpu_torch.api.params import BadRequest, parse_search_block_request
from tempo_tpu_torch.backend import TypedBackend, make_raw_backend
from tempo_tpu_torch.encoding.common import BlockConfig, SearchResponse

log = logging.getLogger(__name__)


class SearchBlockHandler:
    """The function body. Thread-safe; construct once per instance."""

    def __init__(self, backend_kind: str, backend_options: dict | None = None,
                 block_cfg: BlockConfig | None = None, backend=None):
        self._lock = threading.Lock()
        self._backend = TypedBackend(backend) if backend is not None else None
        self._backend_kind = backend_kind
        self._backend_options = backend_options or {}
        self.block_cfg = block_cfg or BlockConfig()

    def backend(self) -> TypedBackend:
        # once-initialized, like the reference's sync.Once reader
        with self._lock:
            if self._backend is None:
                self._backend = TypedBackend(
                    make_raw_backend(self._backend_kind, self._backend_options)
                )
            return self._backend

    def handle(self, qs: dict, tenant: str) -> SearchResponse:
        if not tenant:
            raise BadRequest("tenant (X-Scope-OrgID) required")
        req = parse_search_block_request(qs)
        be = self.backend()
        meta = be.block_meta(tenant, req.block_id)
        if req.version and meta.version != req.version:
            raise BadRequest(
                f"block {req.block_id} is {meta.version}, request expects {req.version}"
            )
        enc = encoding_registry.from_version(meta.version)
        blk = enc.open_block(meta, be, self.block_cfg)
        return blk.search(
            req.search, start_row_group=req.start_row_group, row_groups=req.row_groups
        )


def response_to_dict(resp: SearchResponse) -> dict:
    """The same JSON shape the /api/search endpoint returns — frontends
    merge serverless partials interchangeably with querier partials."""
    return resp.to_dict()


class ServerlessServer:
    """Local/a container stand-in for the FaaS runtime."""

    def __init__(self, handler: SearchBlockHandler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        outer = self

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                url = urlparse(self.path)
                qs = parse_qs(url.query)
                tenant = self.headers.get("X-Scope-OrgID", "")
                try:
                    resp = outer.handler.handle(qs, tenant)
                    body = json.dumps(response_to_dict(resp)).encode()
                    code = 200
                except BadRequest as e:
                    body, code = json.dumps({"error": str(e)}).encode(), 400
                except Exception as e:  # noqa: BLE001
                    log.exception("serverless search failed")
                    body, code = json.dumps({"error": str(e)}).encode(), 500
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer((host, port), _H)
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self._srv.server_address[0]}:{self._srv.server_address[1]}"

    def start(self) -> "ServerlessServer":
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        if self._thread:
            self._thread.join(timeout=2)
