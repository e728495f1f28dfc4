"""Port of tempo_tpu/backend/azure.py, copied as is (host code).

Azure Blob Storage backend (REST, SharedKey auth).

Reference: tempodb/backend/azure/azure.go (azure-storage-blob-go:
block-blob writes with manual Put Block / Put Block List append,
ranged downloads, container listing with delimiter; config
azure/config.go — storage_account_name/key, container_name, endpoint
suffix, hedging). Azurite (the emulator used by the reference's e2e
suite, integration/e2e/backend/backend.go) speaks the same dialect.

True streaming append is implemented the reference's way: each append
stages an uncommitted block (Put Block), and the flush commits the
accumulated block list (Put Block List) — no in-memory whole-object
buffering for large data objects.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import threading
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from tempo_tpu_torch.backend.base import NotFound
from tempo_tpu_torch.backend.cloud import CloudBackendBase, join_key
from tempo_tpu_torch.backend.httpclient import HedgeConfig, HTTPError, PooledHTTPClient


@dataclass
class AzureConfig:
    storage_account_name: str = ""
    storage_account_key: str = ""  # base64
    container_name: str = ""
    endpoint: str = ""  # e.g. http://127.0.0.1:10000/devstoreaccount1 (azurite) or https://<acct>.blob.core.windows.net
    prefix: str = ""
    timeout_s: float = 30.0
    max_retries: int = 3
    hedge: HedgeConfig = field(default_factory=HedgeConfig)


class SharedKeySigner:
    """Azure Storage SharedKey authorization (2019-12-12 dialect)."""

    def __init__(self, account: str, key_b64: str):
        self.account = account
        self.key = base64.b64decode(key_b64) if key_b64 else b""

    def sign(self, method: str, path: str, query: dict, headers: dict) -> str:
        # canonicalized headers: all x-ms-*, sorted
        xms = sorted((k.lower(), v) for k, v in headers.items() if k.lower().startswith("x-ms-"))
        canon_headers = "".join(f"{k}:{v}\n" for k, v in xms)
        # canonicalized resource: /account/path + sorted query params
        canon_res = f"/{self.account}{path}"
        for k in sorted(query):
            canon_res += f"\n{k.lower()}:{query[k]}"
        content_length = headers.get("Content-Length", "")
        if content_length == "0":
            content_length = ""
        string_to_sign = "\n".join(
            [
                method,
                "",  # Content-Encoding
                "",  # Content-Language
                content_length,
                "",  # Content-MD5
                headers.get("Content-Type", ""),
                "",  # Date (use x-ms-date)
                "",  # If-Modified-Since
                "",  # If-Match
                "",  # If-None-Match
                "",  # If-Unmodified-Since
                "",  # Range
                canon_headers + canon_res,
            ]
        )
        sig = base64.b64encode(
            hmac.new(self.key, string_to_sign.encode(), hashlib.sha256).digest()
        ).decode()
        return f"SharedKey {self.account}:{sig}"


class AzureBackend(CloudBackendBase):
    def __init__(self, cfg: AzureConfig, client: PooledHTTPClient | None = None):
        super().__init__(cfg.prefix)
        if not cfg.container_name:
            raise ValueError("azure: container_name is required")
        endpoint = cfg.endpoint or f"https://{cfg.storage_account_name}.blob.core.windows.net"
        self.cfg = cfg
        self.client = client or PooledHTTPClient(endpoint, cfg.timeout_s, cfg.max_retries, cfg.hedge)
        u = urllib.parse.urlsplit(endpoint)
        self._base_path = u.path.rstrip("/")  # azurite embeds the account in the path
        self.signer = SharedKeySigner(cfg.storage_account_name, cfg.storage_account_key)
        # uncommitted block ids per blob key (Put Block append state)
        self._block_lists: dict[str, list[str]] = {}
        self._bl_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _request(self, method, path, query=None, body=None, extra_headers=None, ok=(200, 201, 202)):
        query = dict(query or {})
        headers = dict(extra_headers or {})
        headers["x-ms-date"] = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%a, %d %b %Y %H:%M:%S GMT"
        )
        headers["x-ms-version"] = "2019-12-12"
        headers["Content-Length"] = str(len(body) if body else 0)
        if self.signer.key:
            headers["Authorization"] = self.signer.sign(method, path, query, headers)
        qs = urllib.parse.urlencode(query)
        return self.client.request(
            method, path + (f"?{qs}" if qs else ""), headers=headers, body=body, ok=ok
        )

    def _blob_path(self, key: str) -> str:
        return f"{self._base_path}/{self.cfg.container_name}/" + urllib.parse.quote(key)

    # append via Put Block / Put Block List ------------------------------
    def append(self, name: str, keypath: tuple, data: bytes) -> None:
        key = join_key(self.prefix, keypath, name)
        with self._bl_lock:
            ids = self._block_lists.setdefault(key, [])
            block_id = base64.b64encode(f"blk-{len(ids):08d}".encode()).decode()
            ids.append(block_id)
        self._request(
            "PUT",
            self._blob_path(key),
            query={"comp": "block", "blockid": block_id},
            body=data,
            ok=(201,),
        )

    def flush_appends(self, keypath: tuple | None = None) -> None:
        scope = None if keypath is None else join_key(self.prefix, keypath) + "/"
        with self._bl_lock:
            keys = [k for k in self._block_lists if scope is None or k.startswith(scope)]
            pending = [(k, self._block_lists.pop(k)) for k in keys]
        for key, ids in pending:
            xml = "<?xml version='1.0' encoding='utf-8'?><BlockList>" + "".join(
                f"<Uncommitted>{i}</Uncommitted>" for i in ids
            ) + "</BlockList>"
            self._request(
                "PUT",
                self._blob_path(key),
                query={"comp": "blocklist"},
                body=xml.encode(),
                extra_headers={"Content-Type": "application/xml"},
                ok=(201,),
            )

    # CloudBackendBase verbs --------------------------------------------
    def _put_object(self, key: str, data: bytes) -> None:
        self._request(
            "PUT",
            self._blob_path(key),
            body=data,
            extra_headers={"x-ms-blob-type": "BlockBlob"},
            ok=(201,),
        )

    def _get_object(self, key: str, offset: int = -1, length: int = -1) -> bytes:
        headers = {}
        if offset >= 0:
            headers["x-ms-range"] = f"bytes={offset}-{offset + length - 1}"
        try:
            _, data, _ = self._request(
                "GET", self._blob_path(key), extra_headers=headers, ok=(200, 206)
            )
            return data
        except HTTPError as e:
            if e.status == 404:
                raise NotFound(key) from e
            raise

    def _delete_object(self, key: str) -> None:
        try:
            self._request("DELETE", self._blob_path(key), ok=(202,))
        except HTTPError as e:
            if e.status == 404:
                raise NotFound(key) from e
            raise

    def _list_prefix(self, prefix: str, delimiter: str) -> tuple[list[str], list[str]]:
        dirs: list[str] = []
        keys: list[str] = []
        marker = None
        path = f"{self._base_path}/{self.cfg.container_name}"
        while True:
            query = {
                "restype": "container",
                "comp": "list",
                "prefix": prefix,
                "delimiter": delimiter,
            }
            if marker:
                query["marker"] = marker
            _, data, _ = self._request("GET", path, query=query, ok=(200,))
            root = ET.fromstring(data)
            blobs = root.find("Blobs")
            if blobs is not None:
                for bp in blobs.findall("BlobPrefix/Name"):
                    dirs.append(bp.text or "")
                for b in blobs.findall("Blob/Name"):
                    keys.append(b.text or "")
            marker = root.findtext("NextMarker")
            if not marker:
                return dirs, keys
