"""Port of tempo_tpu/backend/gcs.py, copied as is (host code).

GCS object-store backend (JSON API v1).

Reference: tempodb/backend/gcs/gcs.go (cloud.google.com/go/storage:
Writer/Reader with range, bucket list with delimiter, per-object
delete; config gcs/config.go — bucket_name, prefix, hedging,
insecure/custom endpoint for fake-gcs-server). Here the JSON API is
spoken directly: media upload `POST /upload/storage/v1/b/<b>/o`,
`GET .../o/<obj>?alt=media` with Range header, delimiter listings, and
bearer-token auth (static token or anonymous for emulators — the
reference e2e tests run against fake-gcs-server the same way,
integration/e2e/backend/backend.go).
"""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass, field

from tempo_tpu_torch.backend.base import NotFound
from tempo_tpu_torch.backend.cloud import CloudBackendBase
from tempo_tpu_torch.backend.httpclient import HedgeConfig, HTTPError, PooledHTTPClient


@dataclass
class GCSConfig:
    bucket_name: str = ""
    endpoint: str = "https://storage.googleapis.com"
    prefix: str = ""
    token: str = ""  # static bearer token; empty = anonymous (emulator)
    timeout_s: float = 30.0
    max_retries: int = 3
    hedge: HedgeConfig = field(default_factory=HedgeConfig)


class GCSBackend(CloudBackendBase):
    def __init__(self, cfg: GCSConfig, client: PooledHTTPClient | None = None):
        super().__init__(cfg.prefix)
        if not cfg.bucket_name:
            raise ValueError("gcs: bucket_name is required")
        self.cfg = cfg
        self.client = client or PooledHTTPClient(
            cfg.endpoint, cfg.timeout_s, cfg.max_retries, cfg.hedge
        )

    def _headers(self, extra: dict | None = None) -> dict:
        h = dict(extra or {})
        if self.cfg.token:
            h["Authorization"] = f"Bearer {self.cfg.token}"
        return h

    def _obj_url(self, key: str, **params) -> str:
        q = urllib.parse.urlencode(params)
        return (
            f"/storage/v1/b/{self.cfg.bucket_name}/o/{urllib.parse.quote(key, safe='')}"
            + (f"?{q}" if q else "")
        )

    # CloudBackendBase verbs --------------------------------------------
    def _put_object(self, key: str, data: bytes) -> None:
        url = (
            f"/upload/storage/v1/b/{self.cfg.bucket_name}/o?uploadType=media&name="
            + urllib.parse.quote(key, safe="")
        )
        self.client.request(
            "POST",
            url,
            headers=self._headers({"Content-Type": "application/octet-stream"}),
            body=data,
            ok=(200,),
        )

    def _get_object(self, key: str, offset: int = -1, length: int = -1) -> bytes:
        headers = self._headers()
        if offset >= 0:
            headers["Range"] = f"bytes={offset}-{offset + length - 1}"
        try:
            _, data, _ = self.client.request(
                "GET", self._obj_url(key, alt="media"), headers=headers, ok=(200, 206)
            )
            return data
        except HTTPError as e:
            if e.status == 404:
                raise NotFound(key) from e
            raise

    def _delete_object(self, key: str) -> None:
        try:
            self.client.request("DELETE", self._obj_url(key), headers=self._headers(), ok=(204, 200))
        except HTTPError as e:
            if e.status == 404:
                raise NotFound(key) from e
            raise

    def _list_prefix(self, prefix: str, delimiter: str) -> tuple[list[str], list[str]]:
        dirs: list[str] = []
        keys: list[str] = []
        token = None
        while True:
            params = {"prefix": prefix, "delimiter": delimiter, "maxResults": "1000"}
            if token:
                params["pageToken"] = token
            url = f"/storage/v1/b/{self.cfg.bucket_name}/o?" + urllib.parse.urlencode(params)
            _, data, _ = self.client.request("GET", url, headers=self._headers(), ok=(200,))
            doc = json.loads(data)
            dirs.extend(doc.get("prefixes", []))
            keys.extend(item["name"] for item in doc.get("items", []))
            token = doc.get("nextPageToken")
            if not token:
                return dirs, keys
