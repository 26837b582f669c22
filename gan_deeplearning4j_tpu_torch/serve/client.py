"""Retrying HTTP client for the serving gateway (torch twin of
``gan_deeplearning4j_tpu/serve/client.py``, a copy: the stdlib and numpy
only).

The gateway's error contract is TYPED at the wire level (429 shed with
``Retry-After``, 503 unavailable, 400 validation — serve/gateway.py),
and this client is the reference consumer of that contract: bounded
retries with exponential backoff-and-jitter on the RETRYABLE statuses
(429/503 — the two that mean "the service is alive but can't take this
request right now"), honoring the server's ``Retry-After`` hint when it
is larger than the computed backoff.  Everything else (400, 404, 413…)
is a caller bug or a routing miss and fails fast on the first answer.

Stdlib-only (``http.client``) with a BOUNDED keep-alive pool: the
gateway speaks HTTP/1.1 with a Content-Length on every reply, so a
connection survives across requests and the per-request connect cost
is paid once, not per call.  A
pooled socket can be stale (server restarted, idle timeout) — the
first transport error on a REUSED connection gets exactly one typed
reconnect on a fresh socket (counted in ``reconnects_total``) before
the retry policy sees anything; fresh-socket failures propagate
immediately, so retry storms no longer amplify connection churn.
Jitter comes from a seeded ``random.Random`` so tests and the bench
are reproducible.

Wire formats (mirrors serve/gateway.py):

* JSON — request ``{"inputs": [[...], ...]}`` (one nested list per
  graph input), response ``{"outputs": [[...], ...]}``.  Values are
  float32; float32 -> JSON -> float32 is exact (every float32 is
  representable as a float64, and JSON round-trips float64 shortest
  repr), so JSON responses are BIT-EQUAL to the engine's outputs.
* npy — request body is ``np.save`` bytes of the single input array
  (``application/x-npy``), response is ``np.savez`` bytes
  (``application/x-npz``, keys ``out0..outN``) — bit-exact by
  construction.
"""

from __future__ import annotations

import io
import json
import random
import threading
import time
from collections import deque
from http.client import HTTPConnection, HTTPException
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.telemetry import events, tracing

# statuses worth retrying: the service is up but cannot take THIS
# request right now (shed / no healthy replica / engine restarting)
RETRYABLE_STATUSES = (429, 503)


class GatewayHTTPError(RuntimeError):
    """A non-200 gateway answer (after retries, for retryable
    statuses).  Carries the status code, the server's error payload,
    and the ``Retry-After`` hint so callers can classify without
    string-matching."""

    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None,
                 error_type: Optional[str] = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = int(status)
        self.retry_after = retry_after
        self.error_type = error_type


def _encode_json(xs: Sequence[np.ndarray]) -> bytes:
    return json.dumps(
        {"inputs": [np.asarray(x).tolist() for x in xs]}
    ).encode("utf-8")


def _encode_npy(xs: Sequence[np.ndarray]) -> bytes:
    if len(xs) != 1:
        raise ValueError(
            "the npy wire format carries exactly one input array; "
            "multi-input graphs must use the JSON format")
    buf = io.BytesIO()
    np.save(buf, np.asarray(xs[0]), allow_pickle=False)
    return buf.getvalue()


def _decode_outputs(body: bytes, content_type: str) -> List[np.ndarray]:
    if content_type.startswith("application/x-npz"):
        with np.load(io.BytesIO(body), allow_pickle=False) as f:
            return [np.asarray(f[f"out{i}"]) for i in range(len(f.files))]
    payload = json.loads(body.decode("utf-8"))
    return [np.asarray(o, dtype=np.float32) for o in payload["outputs"]]


class GatewayClient:
    """Bounded-retry client over one gateway base address.

    ``retries``: extra attempts AFTER the first (0 = fail fast — the
    loadgen's shed-counting mode).  ``backoff_s`` doubles per attempt
    (times ``backoff_mult``) with multiplicative jitter in
    ``[1, 1+jitter]``; a server ``Retry-After`` overrides the computed
    backoff when larger.  ``seed`` makes the jitter reproducible.
    ``pool_size`` bounds the idle keep-alive pool (0 disables reuse);
    ``reused_total`` / ``reconnects_total`` count pool hits and typed
    stale-socket reconnects.  ``close()`` drains the pool."""

    def __init__(self, host: str, port: int, *,
                 retries: int = 3, backoff_s: float = 0.05,
                 backoff_mult: float = 2.0, jitter: float = 0.5,
                 timeout_s: float = 60.0, seed: int = 0,
                 pool_size: int = 4):
        if pool_size < 0:
            raise ValueError("pool_size must be >= 0")
        self.host = host
        self.port = int(port)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self.jitter = float(jitter)
        self.timeout_s = float(timeout_s)
        self.pool_size = int(pool_size)
        self._rng = random.Random(seed)
        self._pool_lock = threading.Lock()
        self._idle: deque = deque()
        self._pool_closed = False
        self.retried_total = 0
        self.reused_total = 0
        self.reconnects_total = 0

    # -- connection pool -------------------------------------------------------

    def _checkout(self) -> Tuple[HTTPConnection, bool]:
        """Pop an idle keep-alive connection, else make a fresh one
        (``HTTPConnection`` connects lazily — no socket I/O here)."""
        with self._pool_lock:
            if self._idle:
                self.reused_total += 1
                return self._idle.popleft(), True
        return (HTTPConnection(self.host, self.port,
                               timeout=self.timeout_s), False)

    def _checkin(self, conn: HTTPConnection) -> None:
        """Return a healthy connection to the pool, or close it when
        the pool is full/closed (the close happens OUTSIDE the lock)."""
        surplus = None
        with self._pool_lock:
            if self._pool_closed or len(self._idle) >= self.pool_size:
                surplus = conn
            else:
                self._idle.append(conn)
        if surplus is not None:
            surplus.close()

    def close(self) -> None:
        """Close every pooled connection and refuse further pooling
        (requests still work — they just run connection-per-call)."""
        with self._pool_lock:
            self._pool_closed = True
            taken = list(self._idle)
            self._idle.clear()
        for conn in taken:
            conn.close()

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- low-level -------------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[bytes],
                 content_type: Optional[str], trace=None,
                 attempt: int = 0):
        headers = {}
        if content_type is not None:
            headers["Content-Type"] = content_type
        if trace is not None:
            headers[tracing.TRACE_HEADER] = tracing.to_header(trace)
        conn, reused = self._checkout()
        t_send = t_recv = None
        try:
            try:
                t_send = time.perf_counter()
                conn.request(method, path, body=body, headers=headers)
                t_recv = time.perf_counter()
                resp = conn.getresponse()
                data = resp.read()
            except (ConnectionError, HTTPException, OSError):
                conn.close()
                if not reused:
                    raise
                # a pooled socket can be stale (server restarted, idle
                # timeout): exactly ONE typed reconnect on a fresh
                # socket; a second failure is a real transport error
                # and propagates to the retry policy
                with self._pool_lock:
                    self.reconnects_total += 1
                conn = HTTPConnection(self.host, self.port,
                                      timeout=self.timeout_s)
                reused = False
                t_send = time.perf_counter()
                conn.request(method, path, body=body, headers=headers)
                t_recv = time.perf_counter()
                resp = conn.getresponse()
                data = resp.read()
        except BaseException:
            conn.close()
            raise
        t_done = time.perf_counter()
        if resp.will_close:
            conn.close()
        else:
            self._checkin(conn)
        if trace is not None:
            # one send + one recv span per wire attempt, children of
            # the caller's span — the client side of the wire gap
            events.complete("trace.wire_send", dur=t_recv - t_send,
                            t_start=t_send, trace=trace.trace,
                            span=tracing.new_span_id(),
                            parent=trace.span, attempt=attempt)
            events.complete("trace.wire_recv", dur=t_done - t_recv,
                            t_start=t_recv, trace=trace.trace,
                            span=tracing.new_span_id(),
                            parent=trace.span, attempt=attempt,
                            status=resp.status)
        return (resp.status, dict(resp.getheaders()), data)

    def _raise(self, status: int, headers: Dict, data: bytes) -> None:
        retry_after = None
        ra = headers.get("Retry-After")
        if ra is not None:
            try:
                retry_after = float(ra)
            except ValueError:
                retry_after = None
        message, error_type = data.decode("utf-8", "replace"), None
        try:
            payload = json.loads(message)
            message = payload.get("error", message)
            error_type = payload.get("type")
        except ValueError:
            pass  # a non-JSON error body is raised as its raw text
        raise GatewayHTTPError(status, message, retry_after=retry_after,
                               error_type=error_type)

    def _with_retries(self, method: str, path: str,
                      body: Optional[bytes],
                      content_type: Optional[str], trace=None):
        backoff = self.backoff_s
        attempt = 0
        while True:
            try:
                status, headers, data = self._request(
                    method, path, body, content_type,
                    trace=trace, attempt=attempt)
            except (ConnectionError, HTTPException, OSError):
                # transport-level failure (reset, refused mid-restart):
                # retry on the same schedule as a 503
                if attempt >= self.retries:
                    raise
                status, headers, data = None, {}, b""
            if status is not None:
                if status == 200:
                    return headers, data
                if (status not in RETRYABLE_STATUSES
                        or attempt >= self.retries):
                    self._raise(status, headers, data)
            wait = backoff * (1.0 + self.jitter * self._rng.random())
            ra = headers.get("Retry-After")
            if ra is not None:
                try:
                    # the server's hint is authoritative when LARGER:
                    # retrying earlier than it asks just buys a 429
                    wait = max(wait, float(ra))
                except ValueError:
                    # a malformed Retry-After is the server's bug: the
                    # computed backoff stands
                    pass
            time.sleep(wait)
            backoff *= self.backoff_mult
            attempt += 1
            with self._pool_lock:
                self.retried_total += 1

    # -- API -------------------------------------------------------------------

    def generate(self, xs: Sequence[np.ndarray], *,
                 tenant: Optional[str] = None,
                 encoding: str = "json",
                 trace=None) -> List[np.ndarray]:
        """POST one generation request; returns the output arrays.
        ``tenant`` targets ``/v1/tenants/{tenant}/generate`` (the
        fleet-sliced model); without it the request load-balances
        across the replica set.  Raises ``GatewayHTTPError`` on a
        non-200 answer after retries.

        Tracing: with ``trace=None`` the client is the FIRST hop and
        mints a root ``trace.client`` span (the whole call, retries
        included); a caller-supplied ``tracing.TraceContext`` (the
        mesh's per-hop context) is propagated instead, without a new
        root.  Either way the context rides the ``X-Gan4j-Trace``
        header and each wire attempt records send/recv spans."""
        if encoding == "json":
            body, ctype = _encode_json(xs), "application/json"
        elif encoding == "npy":
            body, ctype = _encode_npy(xs), "application/x-npy"
        else:
            raise ValueError(f"unknown encoding {encoding!r} "
                             "(expected 'json' or 'npy')")
        path = ("/v1/generate" if tenant is None
                else f"/v1/tenants/{tenant}/generate")
        if trace is not None:
            headers, data = self._with_retries("POST", path, body,
                                               ctype, trace=trace)
            return _decode_outputs(data,
                                   headers.get("Content-Type", ""))
        ctx = tracing.mint()
        with events.span("trace.client", trace=ctx.trace,
                         span=ctx.span, path=path):
            headers, data = self._with_retries("POST", path, body,
                                               ctype, trace=ctx)
            return _decode_outputs(data,
                                   headers.get("Content-Type", ""))

    def healthz(self) -> Dict:
        """GET the gateway's own /healthz block (any status — health is
        a read, not a retryable mutation)."""
        status, _, data = self._request("GET", "/healthz", None, None)
        payload = json.loads(data.decode("utf-8"))
        payload["_status"] = status
        return payload

    def report(self) -> Dict:
        """Scrape feed for ``MetricsRegistry.observe_client`` (the
        ``gan4j_client_*`` series): the keep-alive pool's counters,
        read under the pool lock."""
        with self._pool_lock:
            return {"reused_total": self.reused_total,
                    "reconnects_total": self.reconnects_total,
                    "retried_total": self.retried_total,
                    "pool_idle": len(self._idle)}
