"""Port of tempo_tpu/backend/s3.py, copied as is (host code).

S3 object-store backend (AWS Signature Version 4, path-style).

Reference: tempodb/backend/s3/s3.go (minio-go based: PutObject,
GetObject with range, ListObjects with delimiter, StatObject,
RemoveObject; config in s3/config.go — bucket, endpoint, region,
access_key/secret_key, insecure, hedging). Here the REST API is spoken
directly over the pooled/hedged HTTP client, with hand-rolled SigV4 so
the backend has zero SDK dependencies; works against AWS S3, minio, or
any S3-compatible endpoint.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from tempo_tpu_torch.backend.base import NotFound
from tempo_tpu_torch.backend.cloud import CloudBackendBase
from tempo_tpu_torch.backend.httpclient import HedgeConfig, HTTPError, PooledHTTPClient

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


@dataclass
class S3Config:
    bucket: str = ""
    endpoint: str = "http://127.0.0.1:9000"  # minio default; AWS: https://s3.<region>.amazonaws.com
    region: str = "us-east-1"
    access_key: str = ""
    secret_key: str = ""
    prefix: str = ""
    timeout_s: float = 30.0
    max_retries: int = 3
    hedge: HedgeConfig = field(default_factory=HedgeConfig)


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "" if encode_slash else "/"
    return urllib.parse.quote(s, safe=safe + "-_.~")


class SigV4Signer:
    """AWS Signature Version 4 (header-based)."""

    def __init__(self, access_key: str, secret_key: str, region: str, service: str = "s3"):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = service

    def sign(
        self,
        method: str,
        host: str,
        path: str,
        query: list[tuple[str, str]],
        payload_sha256: str,
        now: datetime.datetime | None = None,
    ) -> dict:
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")

        canonical_query = "&".join(
            f"{_uri_encode(k)}={_uri_encode(v)}" for k, v in sorted(query)
        )
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_sha256,
            "x-amz-date": amz_date,
        }
        signed_headers = ";".join(sorted(headers))
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        canonical_request = "\n".join(
            [
                method,
                _uri_encode(path, encode_slash=False),
                canonical_query,
                canonical_headers,
                signed_headers,
                payload_sha256,
            ]
        )
        scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )

        def _hmac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k_date = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k_region = _hmac(k_date, self.region)
        k_service = _hmac(k_region, self.service)
        k_signing = _hmac(k_service, "aws4_request")
        signature = hmac.new(k_signing, string_to_sign.encode(), hashlib.sha256).hexdigest()

        return {
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_sha256,
            "Authorization": (
                f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                f"SignedHeaders={signed_headers}, Signature={signature}"
            ),
        }


class S3Backend(CloudBackendBase):
    def __init__(self, cfg: S3Config, client: PooledHTTPClient | None = None):
        super().__init__(cfg.prefix)
        if not cfg.bucket:
            raise ValueError("s3: bucket is required")
        self.cfg = cfg
        self.client = client or PooledHTTPClient(
            cfg.endpoint, cfg.timeout_s, cfg.max_retries, cfg.hedge
        )
        self.signer = SigV4Signer(cfg.access_key, cfg.secret_key, cfg.region)
        u = urllib.parse.urlsplit(cfg.endpoint)
        self._host = u.netloc

    # ------------------------------------------------------------------
    def _request(self, method, path, query=(), body=None, extra_headers=None, ok=(200, 204, 206)):
        payload_sha = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
        headers = self.signer.sign(method, self._host, path, list(query), payload_sha)
        headers.update(extra_headers or {})
        qs = urllib.parse.urlencode(list(query))
        url = path + (f"?{qs}" if qs else "")
        return self.client.request(method, url, headers=headers, body=body, ok=ok)

    def _key_path(self, key: str) -> str:
        # path-style addressing: /<bucket>/<key>
        return f"/{self.cfg.bucket}/" + _uri_encode(key, encode_slash=False)

    # CloudBackendBase verbs --------------------------------------------
    def _put_object(self, key: str, data: bytes) -> None:
        self._request("PUT", self._key_path(key), body=data, ok=(200,))

    def _get_object(self, key: str, offset: int = -1, length: int = -1) -> bytes:
        headers = {}
        if offset >= 0:
            headers["Range"] = f"bytes={offset}-{offset + length - 1}"
        try:
            _, data, _ = self._request(
                "GET", self._key_path(key), extra_headers=headers, ok=(200, 206)
            )
            return data
        except HTTPError as e:
            if e.status == 404:
                raise NotFound(key) from e
            raise

    def _delete_object(self, key: str) -> None:
        try:
            self._request("DELETE", self._key_path(key), ok=(204, 200))
        except HTTPError as e:
            if e.status == 404:
                raise NotFound(key) from e
            raise

    def _list_prefix(self, prefix: str, delimiter: str) -> tuple[list[str], list[str]]:
        dirs: list[str] = []
        keys: list[str] = []
        token = None
        while True:
            query = [
                ("list-type", "2"),
                ("prefix", prefix),
                ("delimiter", delimiter),
                ("max-keys", "1000"),
            ]
            if token:
                query.append(("continuation-token", token))
            _, data, _ = self._request("GET", f"/{self.cfg.bucket}", query=query, ok=(200,))
            root = ET.fromstring(data)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for cp in root.findall(f"{ns}CommonPrefixes/{ns}Prefix"):
                dirs.append(cp.text or "")
            for c in root.findall(f"{ns}Contents/{ns}Key"):
                keys.append(c.text or "")
            trunc = root.findtext(f"{ns}IsTruncated") == "true"
            token = root.findtext(f"{ns}NextContinuationToken")
            if not trunc or not token:
                return dirs, keys
