"""Port of tempo_tpu/backend/httpclient.py (host code): the pooled,
retrying, hedging client that every role client of microservices mode
and the cloud backends (S3, GCS, Azure) share.

HTTP plumbing shared by the cloud object-store backends.

Reference parity:
- hedged requests against object stores: all three reference backends
  wrap their HTTP transport in cristalhq/hedgedhttp (e.g.
  tempodb/backend/gcs/gcs.go, s3/s3.go, azure/azure.go config knobs
  `hedge_requests_at` / `hedge_requests_up_to`), with hedge counts
  exported via pkg/hedgedmetrics.
- retries on transient failures (5xx / connection reset) live in the
  cloud SDKs the reference vendors; here they are explicit.

Implementation: stdlib http.client with a small per-host connection
pool. Hedging fires a second identical request after `hedge_at_s` and
takes the first success — only for idempotent requests (GET/HEAD).
"""

from __future__ import annotations

import concurrent.futures
import http.client
import threading
import time
import urllib.parse
from dataclasses import dataclass

from tempo_tpu_torch.util import deadline, metrics, tracing

hedged_total = metrics.counter(
    "tempo_backend_hedged_roundtrips_total",
    "Total hedged requests fired (reference: pkg/hedgedmetrics)",
)


class HTTPError(Exception):
    def __init__(self, status: int, body: bytes, url: str, headers: dict | None = None):
        self.status = status
        self.body = body[:512]
        self.headers = headers or {}
        super().__init__(f"HTTP {status} for {url}: {self.body!r}")

    def parse_retry_after(self) -> float | None:
        """Parsed Retry-After header (seconds form), for 429 shed
        responses. A method name distinct from the `retry_after_s` FLOAT
        attribute every overload error carries — duck-typing consumers
        (`getattr(e, "retry_after_s", 0.0)`) must never pick up a bound
        method where they expect a number."""
        v = self.headers.get("retry-after")
        if v is None:
            return None
        try:
            return float(v)
        except ValueError:
            return None


def retriable(e: Exception) -> bool:
    if isinstance(e, HTTPError):
        return e.status >= 500 or e.status == 429
    return isinstance(e, (ConnectionError, http.client.HTTPException, OSError, TimeoutError))


@dataclass
class HedgeConfig:
    """hedge_requests_at / hedge_requests_up_to (reference config names)."""

    hedge_at_s: float = 0.0  # 0 = disabled
    hedge_up_to: int = 2


class PooledHTTPClient:
    """Connection-pooled client for one endpoint (scheme://host:port)."""

    def __init__(
        self,
        endpoint: str,
        timeout_s: float = 30.0,
        max_retries: int = 3,
        hedge: HedgeConfig | None = None,
        breaker=None,
    ):
        u = urllib.parse.urlsplit(endpoint)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"endpoint must be http(s), got {endpoint!r}")
        self.scheme = u.scheme
        self.host = u.hostname or ""
        self.port = u.port
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.hedge = hedge or HedgeConfig()
        # optional util/circuit.CircuitBreaker: when the endpoint is down
        # for everyone, attempts (INCLUDING this client's own retries)
        # fail fast with CircuitOpen instead of stacking timeouts on a
        # struggling host — the anti-amplification valve around every
        # retry loop above this client
        self.breaker = breaker
        self._pool: list[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        self._hedge_pool = concurrent.futures.ThreadPoolExecutor(max_workers=8)

    # -- connection pool -------------------------------------------------
    def _get_conn(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        cls = http.client.HTTPSConnection if self.scheme == "https" else http.client.HTTPConnection
        return cls(self.host, self.port, timeout=self.timeout_s)

    def _put_conn(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._pool) < 8:
                self._pool.append(conn)
                return
        conn.close()

    # -- request execution ----------------------------------------------
    def _once(self, method: str, path: str, headers: dict, body: bytes | None):
        conn = self._get_conn()
        # bound the socket timeout by the propagated request deadline: a
        # backend read must not outlive the query that asked for it.
        # ALWAYS set it — a pooled connection may carry the shortened
        # timeout of a previous deadlined request, which would spuriously
        # time out healthy requests that have no (or a long) deadline
        bounded = (deadline.bound_timeout(self.timeout_s)
                   if deadline.remaining() is not None else self.timeout_s)
        conn.timeout = bounded
        if getattr(conn, "sock", None) is not None:
            conn.sock.settimeout(bounded)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            out_headers = {k.lower(): v for k, v in resp.getheaders()}
            self._put_conn(conn)
            return resp.status, data, out_headers
        except BaseException:
            conn.close()
            raise

    def request(
        self,
        method: str,
        path: str,
        headers: dict | None = None,
        body: bytes | None = None,
        ok=(200, 201, 202, 204, 206),
    ) -> tuple[int, bytes, dict]:
        """Retrying (and, for idempotent methods, hedged) request.

        Returns (status, body, headers); raises HTTPError for non-ok
        status after retries are exhausted.
        """
        headers = dict(headers or {})
        headers.setdefault("Host", self.host if self.port is None else f"{self.host}:{self.port}")
        # propagate the active trace context (W3C traceparent) on every
        # internal request, so distributor→ingester and frontend→worker
        # hops join the caller's trace (reference: otelhttp transport
        # wrapping every internal client); absent when no span is open
        tp = tracing.current_traceparent()
        if tp is not None:
            headers.setdefault(tracing.TRACEPARENT_HEADER, tp)
        if body is not None:
            headers.setdefault("Content-Length", str(len(body)))
        idempotent = method in ("GET", "HEAD", "PUT", "DELETE")

        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            deadline.check()  # an exceeded deadline is terminal, not retried
            if self.breaker is not None:
                # raises CircuitOpen (fail fast, zero I/O) while open —
                # including for this client's OWN retry attempts, so a
                # dead endpoint costs microseconds, not stacked timeouts
                self.breaker.before()
            try:
                if idempotent and method in ("GET", "HEAD") and self.hedge.hedge_at_s > 0:
                    status, data, h = self._hedged(method, path, headers, body)
                else:
                    status, data, h = self._once(method, path, headers, body)
            except Exception as e:  # connection-level failure
                if self.breaker is not None:
                    self.breaker.record_failure()
                if not retriable(e) or not idempotent:
                    raise
                last = e
            else:
                if self.breaker is not None:
                    # any response proves the transport; only 5xx says the
                    # backend itself is unhealthy (4xx/429 are the
                    # caller's problem or explicit backpressure)
                    if status >= 500:
                        self.breaker.record_failure()
                    else:
                        self.breaker.record_success()
                if status in ok:
                    return status, data, h
                err = HTTPError(status, data, path, headers=h)
                if not retriable(err) or not idempotent:
                    raise err
                last = err
            if attempt < self.max_retries:
                time.sleep(deadline.bound_timeout(min(0.05 * (2**attempt), 1.0)))
        assert last is not None
        raise last

    def _hedged(self, method: str, path: str, headers: dict, body):
        """First SUCCESSFUL response wins; an error surfaces only when
        every launched attempt has failed. (Taking the first *completed*
        future would let a fast connection error mask a slower in-flight
        success — exactly the window hedging exists to cover.) The
        straggler of a won race is abandoned; its pooled connection is
        closed by _once's error path or drained later."""
        futs = [self._hedge_pool.submit(self._once, method, path, headers, body)]
        fired = 1
        pending = set(futs)
        last_err: Exception | None = None
        while True:
            done, pending = concurrent.futures.wait(
                pending,
                timeout=self.hedge.hedge_at_s if fired < self.hedge.hedge_up_to else None,
                return_when=concurrent.futures.FIRST_COMPLETED,
            )
            for f in done:
                try:
                    return f.result()
                except Exception as e:  # noqa: BLE001 — keep racing others
                    last_err = e
            if not pending and fired >= self.hedge.hedge_up_to:
                assert last_err is not None
                raise last_err
            if fired < self.hedge.hedge_up_to:
                # hedge timer elapsed, or an attempt failed: launch the
                # next attempt immediately (failure = free hedge trigger)
                hedged_total.inc()
                nf = self._hedge_pool.submit(self._once, method, path, headers, body)
                pending.add(nf)
                fired += 1

    def close(self) -> None:
        with self._lock:
            for c in self._pool:
                c.close()
            self._pool.clear()
        self._hedge_pool.shutdown(wait=False)
