"""The HTTP front door of the serving plane (torch twin of
``gan_deeplearning4j_tpu/serve/gateway.py``: the stdlib and numpy only,
its wire contract unchanged).

Until a request can arrive over a socket, none of the admission,
shedding, or SLO machinery is reachable by an actual user.  ``Gateway``
closes that gap with the stdlib ``ThreadingHTTPServer`` — no new
dependencies, every thread named, bounded shutdown — layered over a
``Router`` (serve/router.py) that balances replicas and routes fleet
tenants.

Endpoints:

* ``POST /v1/generate`` — balanced across the replica set.
* ``POST /v1/tenants/{id}/generate`` — the tenant's own fleet-sliced
  model through the router's ``FleetTenantBank`` (404 ``unknown_tenant``
  for an id the bank does not serve, or when no bank is configured).
* ``GET /healthz`` — the gateway block (200 when the router has a
  healthy replica, 503 otherwise).  With a ``serve_report`` hook
  configured (the replica process), the reply carries a ``serve``
  block too and the status folds it in — a remote probe's one-GET
  health read.
* ``POST /admin/{name}`` — operator verbs registered via the
  ``admin`` hook dict (the replica process registers ``hotswap`` and
  ``chaos/wedge``): JSON params in, JSON result out, the same typed
  status mapping (400 validation / 404 unknown / 503 failed).

Error contract (the typed engine failures mapped to the wire):

* validation (bad JSON/npy, wrong shape/dtype/row count, oversized
  declared or actual body) → **400** (or **413** for an oversized
  body — rejected from the Content-Length header, BEFORE reading);
* unknown route / unknown tenant → **404**; wrong method → **405**;
* body slower than the read deadline (slow-loris) → **408**;
* per-tenant token-bucket exhausted, or ``ShedError`` from admission →
  **429** with ``Retry-After``;
* ``DispatchError`` / ``WatchdogTimeout`` / stopped engine / no
  healthy replica → **503**;
* the gateway's own result wait expiring → **504**.

Blast-radius discipline: everything about a request is validated
BEFORE it can touch an engine — size from the headers, shape/dtype
from the decoded arrays (plus the engine's own submit validation) —
so one tenant's malformed or hostile request costs one connection
thread a bounded amount of time and nothing else.  The body read
enforces a TOTAL wall-clock deadline (``read_timeout_s``), not a
per-recv timeout: a slow-loris dripping one byte per interval keeps
every per-recv timer happy forever, but not the total.

Ops surface: ``report()`` feeds ``MetricsRegistry.observe_gateway``
(the ``gan4j_gateway_*`` series and the ``/healthz`` gateway block).
Tracing: each generate request continues the caller's trace (the
``X-Gan4j-Trace`` header) or mints a root, records its stages as
``trace.*`` spans, and echoes the header on every reply, typed errors
included (with a terminal ``trace.reject``); a 200 carries
``Server-Timing`` (the gateway's stages in ms).  ``gateway.start`` and
``gateway.reject`` are instants on the events timeline.
"""

from __future__ import annotations

import io
import itertools
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.serve.admission import ShedError
from gan_deeplearning4j_tpu_torch.serve.engine import DispatchError
from gan_deeplearning4j_tpu_torch.serve.router import (
    NoHealthyReplicaError,
    Router,
    TenantThrottledError,
)
from gan_deeplearning4j_tpu_torch.telemetry import events, tracing
from gan_deeplearning4j_tpu_torch.train.watchdog import WatchdogTimeout

_GENERATE = "/v1/generate"
_TENANT_PREFIX = "/v1/tenants/"
_ADMIN_PREFIX = "/admin/"


class _SlowBody(Exception):
    """The request body did not arrive within the total read
    deadline (the slow-loris failure mode) — answered 408."""


class _Disconnect(Exception):
    """The peer vanished mid-body — nothing to answer, counted."""


class TokenBucket:
    """One tenant's rate allowance: ``capacity`` tokens refilled at
    ``refill_per_s``.  ``take`` is lock-free arithmetic (the caller —
    the gateway — serializes per-bucket access under its own lock) and
    returns the seconds until a token exists when empty — the 429's
    ``Retry-After``."""

    __slots__ = ("capacity", "refill_per_s", "tokens", "t_last")

    def __init__(self, capacity: float, refill_per_s: float):
        if capacity <= 0 or refill_per_s <= 0:
            raise ValueError("capacity and refill_per_s must be > 0")
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self.tokens = float(capacity)
        self.t_last = time.monotonic()

    def take(self, now: Optional[float] = None
             ) -> Tuple[bool, float]:
        if now is None:
            now = time.monotonic()
        self.tokens = min(self.capacity,
                          self.tokens
                          + (now - self.t_last) * self.refill_per_s)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, 0.0
        return False, (1.0 - self.tokens) / self.refill_per_s


def _decode_json(body: bytes) -> List[np.ndarray]:
    try:
        payload = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"request body is not valid JSON: {e}") \
            from None
    if not isinstance(payload, dict) or "inputs" not in payload:
        raise ValueError('JSON body must be {"inputs": [...]}')
    inputs = payload["inputs"]
    if not isinstance(inputs, list) or not inputs:
        raise ValueError('"inputs" must be a non-empty list of arrays')
    out = []
    for i, v in enumerate(inputs):
        try:
            arr = np.asarray(v, dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise ValueError(f"inputs[{i}] is not numeric: {e}") \
                from None
        if arr.ndim < 1 or arr.size == 0:
            raise ValueError(f"inputs[{i}] must be a non-empty array")
        out.append(arr)
    return out


def _decode_npy(body: bytes) -> List[np.ndarray]:
    try:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    except (ValueError, OSError, EOFError) as e:
        raise ValueError(f"request body is not a valid .npy: {e}") \
            from None
    if arr.ndim < 1 or arr.size == 0:
        raise ValueError("npy input must be a non-empty array")
    return [arr]


def _encode_json(outs: List[np.ndarray]) -> Tuple[bytes, str]:
    body = json.dumps(
        {"outputs": [np.asarray(o).tolist() for o in outs]}
    ).encode("utf-8")
    return body, "application/json"


def _encode_npz(outs: List[np.ndarray]) -> Tuple[bytes, str]:
    buf = io.BytesIO()
    np.savez(buf, **{f"out{i}": np.asarray(o)
                     for i, o in enumerate(outs)})
    return buf.getvalue(), "application/x-npz"


class _Handler(BaseHTTPRequestHandler):
    server_version = "gan4j-gateway"
    protocol_version = "HTTP/1.1"

    # -- plumbing --------------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet: report() is the surface
        pass

    @property
    def gateway(self) -> "Gateway":
        return self.server.gateway  # type: ignore[attr-defined]

    def setup(self):
        super().setup()
        # bounds the HEADER read and any idle keep-alive gap; the body
        # read below enforces its own TOTAL deadline on top
        self.connection.settimeout(self.gateway.read_timeout_s)
        self.gateway._conn_delta(+1)

    def finish(self):
        try:
            super().finish()
        finally:
            self.gateway._conn_delta(-1)

    def _reply(self, status: int, body: bytes, content_type: str,
               headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        ctx = getattr(self, "_trace_ctx", None)
        if ctx is not None:
            # EVERY traced reply — success AND typed error — echoes
            # the trace header, so a shed/timeout caller can still
            # find its request in the merged timeline
            headers = tuple(headers) + (
                (tracing.TRACE_HEADER, tracing.to_header(ctx)),)
            self._trace_status = status
        try:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            # the peer hung up mid-write; there is no one left to
            # answer, only the connection to close
            self.close_connection = True

    def _reply_error(self, status: int, error_type: str, message: str,
                     retry_after: Optional[float] = None) -> None:
        self.gateway._count_rejected(status, error_type)
        ctx = getattr(self, "_trace_ctx", None)
        if ctx is not None:
            # terminal span for the rejected request: without it the
            # trace would end mid-tree and vanish from merged views
            events.instant("trace.reject", trace=ctx.trace,
                           span=tracing.new_span_id(),
                           parent=ctx.span, status=status,
                           type=error_type)
        headers: Tuple[Tuple[str, str], ...] = ()
        if retry_after is not None:
            # integral seconds, always >= 1: a 0s hint just converts
            # one 429 into an immediate second 429
            headers = (("Retry-After",
                        str(max(1, math.ceil(retry_after)))),)
        self._reply(status,
                    json.dumps({"error": message,
                                "type": error_type}).encode("utf-8"),
                    "application/json", headers)

    def _stage(self, name: str, t0: float,
               ctx: "tracing.TraceContext") -> None:
        """Record one gateway-side stage both as a ``trace.*`` child
        span and as a ``Server-Timing`` entry on this response."""
        dur = time.perf_counter() - t0
        self._stage_ms[name] = dur * 1000.0
        events.complete(f"trace.{name}", dur=dur, t_start=t0,
                        trace=ctx.trace, span=tracing.new_span_id(),
                        parent=ctx.span)

    def _server_timing(self) -> str:
        return ", ".join(f"{k};dur={v:.3f}"
                         for k, v in self._stage_ms.items())

    def _read_body(self, length: int) -> bytes:
        """Read exactly ``length`` bytes under a TOTAL wall-clock
        deadline.  Raises ``_SlowBody`` past the deadline (slow-loris)
        and ``_Disconnect`` on EOF/reset (mid-body disconnect)."""
        deadline = time.monotonic() + self.gateway.read_timeout_s
        buf = bytearray()
        conn = self.connection
        while len(buf) < length:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _SlowBody()
            # short per-recv timeout so the TOTAL deadline is checked
            # at least every 0.25s no matter how slowly bytes drip
            conn.settimeout(min(remaining, 0.25))
            try:
                chunk = self.rfile.read1(
                    min(65536, length - len(buf)))
            except TimeoutError:
                # a per-recv timeout is the POLLING TICK of the total
                # deadline: the loop head re-checks it
                continue
            except OSError:
                raise _Disconnect() from None
            if not chunk:
                raise _Disconnect()
            buf += chunk
        conn.settimeout(self.gateway.read_timeout_s)
        return bytes(buf)

    # -- routes ----------------------------------------------------------------

    def do_GET(self):
        if self.path == "/healthz":
            status, doc = self.gateway.health_doc()
            self._reply(status,
                        json.dumps(doc, indent=2).encode("utf-8"),
                        "application/json")
            return
        if self.path == _GENERATE or (
                self.path.startswith(_TENANT_PREFIX)
                and self.path.endswith("/generate")):
            self._reply_error(405, "method", "generate is POST-only")
            return
        if self.path.startswith(_ADMIN_PREFIX):
            self._reply_error(405, "method", "admin verbs are POST-only")
            return
        self._reply_error(404, "route", f"no route {self.path}")

    def _do_admin(self):
        """``POST /admin/{name}``: JSON params in, JSON result out,
        dispatched to the ``admin`` hook dict.  Typed mapping mirrors
        generate: ``ValueError`` → 400, ``FileNotFoundError`` (incl.
        ``NoVerifiedCheckpointError``) → 404, ``RuntimeError``/
        ``OSError`` → 503.  Handlers run on THIS connection thread with
        no gateway lock held — a slow hotswap costs one thread, not
        the listener."""
        name = self.path[len(_ADMIN_PREFIX):]
        handler = self.gateway._admin_handler(name)
        if handler is None:
            self._reply_error(404, "route",
                              f"no admin route {self.path}")
            return
        raw_len = self.headers.get("Content-Length")
        try:
            length = int(raw_len) if raw_len is not None else 0
        except ValueError:
            self._reply_error(400, "validation",
                              "bad Content-Length")
            return
        if length > self.gateway.max_body_bytes:
            self._reply_error(
                413, "validation",
                f"declared body of {length} bytes exceeds the "
                f"{self.gateway.max_body_bytes} byte bound")
            self.close_connection = True
            return
        params: Dict = {}
        if length > 0:
            try:
                body = self._read_body(length)
            except _SlowBody:
                self._reply_error(
                    408, "slow_body",
                    f"request body did not arrive within "
                    f"{self.gateway.read_timeout_s:.1f}s")
                self.close_connection = True
                return
            except _Disconnect:
                self.gateway._count_rejected(0, "disconnect")
                self.close_connection = True
                return
            try:
                params = json.loads(body.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                self._reply_error(400, "validation",
                                  f"admin body is not valid JSON: {e}")
                return
            if not isinstance(params, dict):
                self._reply_error(400, "validation",
                                  "admin body must be a JSON object")
                return
        try:
            result = handler(params)
        except ValueError as e:
            self._reply_error(400, "validation", str(e))
            return
        except FileNotFoundError as e:
            self._reply_error(404, "not_found", str(e))
            return
        except (RuntimeError, OSError) as e:
            self._reply_error(503, "admin_failed", str(e),
                              retry_after=1.0)
            return
        self._reply(200,
                    json.dumps({"result": result}).encode("utf-8"),
                    "application/json")

    def do_POST(self):
        if self.path.startswith(_ADMIN_PREFIX):
            self._do_admin()
            return
        # trace envelope: continue the caller's trace (header) or mint
        # a fresh root for untraced callers — EVERY generate request
        # lands in the merged timeline either way
        incoming = tracing.from_header(
            self.headers.get(tracing.TRACE_HEADER))
        ctx = (tracing.child(incoming) if incoming is not None
               else tracing.mint())
        self._trace_ctx = ctx
        self._trace_status: Optional[int] = None
        self._stage_ms: Dict[str, float] = {}
        t_req = time.perf_counter()
        try:
            self._do_generate(ctx)
        finally:
            attrs = {"trace": ctx.trace, "span": ctx.span,
                     "status": self._trace_status, "path": self.path}
            if incoming is not None:
                attrs["parent"] = incoming.span
            events.complete("trace.request",
                            dur=time.perf_counter() - t_req,
                            t_start=t_req, **attrs)
            self._trace_ctx = None

    def _do_generate(self, ctx: "tracing.TraceContext"):
        tenant: Optional[str] = None
        if self.path == _GENERATE:
            # the limiter key for untenanted traffic: the declared
            # tenant header when present, else one shared bucket
            limiter_key = self.headers.get("X-Tenant", "")
        elif (self.path.startswith(_TENANT_PREFIX)
              and self.path.endswith("/generate")):
            tenant = self.path[len(_TENANT_PREFIX):-len("/generate")]
            if not tenant or "/" in tenant:
                self._reply_error(404, "route",
                                  f"no route {self.path}")
                return
            limiter_key = tenant
        else:
            self._reply_error(404, "route", f"no route {self.path}")
            return
        self.gateway._count_request()
        t0 = time.perf_counter()
        ok, retry_after = self.gateway._rate_check(limiter_key)
        self._stage("rate_limit", t0, ctx)
        if not ok:
            self._reply_error(
                429, "rate_limit",
                f"tenant {limiter_key or '<default>'!s} is over its "
                f"request rate; retry after {retry_after:.2f}s",
                retry_after=retry_after)
            return
        raw_len = self.headers.get("Content-Length")
        try:
            length = int(raw_len)
        except (TypeError, ValueError):
            self._reply_error(400, "validation",
                              "Content-Length is required")
            return
        if length <= 0:
            self._reply_error(400, "validation",
                              "request body must be non-empty")
            return
        if length > self.gateway.max_body_bytes:
            # rejected from the HEADER — the oversized body is never
            # read, so the caller pays for their mistake, not us
            self._reply_error(
                413, "validation",
                f"declared body of {length} bytes exceeds the "
                f"{self.gateway.max_body_bytes} byte bound")
            self.close_connection = True
            return
        t0 = time.perf_counter()
        try:
            body = self._read_body(length)
        except _SlowBody:
            self._reply_error(
                408, "slow_body",
                f"request body did not arrive within "
                f"{self.gateway.read_timeout_s:.1f}s")
            self.close_connection = True
            return
        except _Disconnect:
            # the peer is gone; count it and release the thread
            self.gateway._count_rejected(0, "disconnect")
            self.close_connection = True
            return
        self._stage("wire_recv", t0, ctx)
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        npy = ctype == "application/x-npy"
        t0 = time.perf_counter()
        try:
            xs = (_decode_npy if npy else _decode_json)(body)
            for x in xs:
                if x.shape[0] > self.gateway.max_rows:
                    raise ValueError(
                        f"{x.shape[0]} rows exceeds the per-request "
                        f"bound of {self.gateway.max_rows}")
        except ValueError as e:
            self._reply_error(400, "validation", str(e))
            return
        self._stage("decode", t0, ctx)
        t0 = time.perf_counter()
        status, payload, content_type, error = \
            self.gateway._dispatch(xs, tenant, npy, trace=ctx)
        self._stage_ms["dispatch"] = \
            (time.perf_counter() - t0) * 1000.0
        if error is not None:
            self._reply_error(status, error[0], error[1],
                              retry_after=error[2])
            return
        self._reply(status, payload, content_type,
                    headers=((tracing.TIMING_HEADER,
                              self._server_timing()),))


class _GatewayServer(ThreadingHTTPServer):
    daemon_threads = True
    block_on_close = False
    allow_reuse_address = True

    def __init__(self, addr, handler, gateway: "Gateway"):
        self.gateway = gateway
        self._conn_seq = itertools.count()
        super().__init__(addr, handler)

    def process_request(self, request, client_address):
        # ThreadingMixIn spawns anonymous threads; name ours so a
        # stack dump under load reads as a service, not a mystery
        t = threading.Thread(
            target=self.process_request_thread,
            args=(request, client_address),
            name=f"gan4j-gateway-conn-{next(self._conn_seq)}",
            daemon=True)
        t.start()

    def handle_error(self, request, client_address):
        # a connection thread must never die loudly on a peer reset;
        # the typed surfaces (counters, /healthz) carry the signal
        self.gateway._count_rejected(0, "connection_error")


class Gateway:
    """The HTTP server: owns the listener, the per-tenant token
    buckets, and the wire counters; delegates placement to ``router``.

    ``rate_limit``: ``(capacity, refill_per_s)`` applied PER TENANT in
    front of admission (None disables).  ``max_body_bytes`` /
    ``max_rows``: the strict size bounds enforced before anything is
    read or dispatched.  ``read_timeout_s``: TOTAL body-read deadline
    (the slow-loris bound).  ``result_timeout_s``: bounded wait for
    the engine's answer (expiry → 504 — the gateway never strands a
    connection on a wedged backend; the engine's own watchdog is the
    primary never-hang layer).

    ``serve_report``: optional zero-arg hook returning the local
    engine's report — when set, ``/healthz`` carries a ``serve`` block
    and the status folds its ``ok`` in (the replica-process contract
    the mesh probes).  ``admin``: optional ``{name: handler}`` dict of
    operator verbs exposed as ``POST /admin/{name}`` (handler takes
    the decoded JSON params dict, returns a JSON-able result).  Both
    are fixed at construction — reads need no lock."""

    def __init__(self, router: Router, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_body_bytes: int = 8 << 20, max_rows: int = 4096,
                 read_timeout_s: float = 5.0,
                 rate_limit: Optional[Tuple[float, float]] = None,
                 result_timeout_s: float = 60.0,
                 serve_report=None, admin=None):
        self.router = router
        self._serve_report = serve_report
        self._admin: Dict[str, Callable] = dict(admin or {})
        self._host = host
        self._port = int(port)
        self.max_body_bytes = int(max_body_bytes)
        self.max_rows = int(max_rows)
        self.read_timeout_s = float(read_timeout_s)
        self.result_timeout_s = float(result_timeout_s)
        self._rate_limit = rate_limit
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._requests_total = 0
        self._rejected_total = 0
        self._rejected_by_type: Dict[str, int] = {}
        self._active_connections = 0
        self._server: Optional[_GatewayServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "Gateway":
        with self._lock:
            if self._server is not None:
                raise RuntimeError("gateway already started")
            server = _GatewayServer((self._host, self._port),
                                    _Handler, self)
            self._server = server
            thread = threading.Thread(
                target=server.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="gan4j-gateway-http", daemon=True)
            self._thread = thread
        thread.start()
        events.instant("gateway.start", host=self._host,
                       port=server.server_address[1])
        return self

    def stop(self) -> None:
        with self._lock:
            server, self._server = self._server, None
            thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()  # bounded: serve_forever polls at 0.1s
            server.server_close()
        if thread is not None:
            thread.join(timeout=10.0)

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def port(self) -> int:
        with self._lock:
            if self._server is None:
                raise RuntimeError("gateway is not running")
            return self._server.server_address[1]

    @property
    def host(self) -> str:
        return self._host

    # -- per-request internals (connection threads) ----------------------------

    def _conn_delta(self, d: int) -> None:
        with self._lock:
            self._active_connections += d

    def _count_request(self) -> None:
        with self._lock:
            self._requests_total += 1

    def _count_rejected(self, status: int, error_type: str) -> None:
        with self._lock:
            self._rejected_total += 1
            self._rejected_by_type[error_type] = \
                self._rejected_by_type.get(error_type, 0) + 1
        events.instant("gateway.reject", status=status, type=error_type)

    def _rate_check(self, key: str) -> Tuple[bool, float]:
        if self._rate_limit is None:
            return True, 0.0
        cap, refill = self._rate_limit
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = TokenBucket(cap, refill)
            return bucket.take()

    def _dispatch(self, xs: List[np.ndarray], tenant: Optional[str],
                  npy: bool, trace=None):
        """Place one decoded request and wait (bounded) for its
        answer.  Returns ``(status, payload, content_type, error)``
        where ``error`` is ``None`` on success and
        ``(type, message, retry_after)`` otherwise — the handler
        stays a thin wire adapter.  ``trace`` rides through to the
        engine (the replica-side stage spans parent under it) and
        cuts the gateway's own wait/encode spans."""
        t0 = time.perf_counter()
        try:
            req = self.router.submit(xs, tenant=tenant, trace=trace)
            outs = req.result(timeout=self.result_timeout_s)
        except ShedError as e:
            wait_ms = e.est_wait_ms if e.est_wait_ms is not None \
                else e.budget_ms
            return 429, b"", "", (
                "shed", str(e), max(0.05, wait_ms / 1000.0))
        except TenantThrottledError as e:
            # the bank's per-tenant quota: this tenant's fault domain
            # only — same 429 wire shape as the gateway's own limiter
            return 429, b"", "", (
                "tenant_throttled", str(e),
                max(0.05, e.retry_after_s))
        except KeyError:
            return 404, b"", "", (
                "unknown_tenant", f"unknown tenant {tenant!r}", None)
        except ValueError as e:
            return 400, b"", "", ("validation", str(e), None)
        except (DispatchError, WatchdogTimeout,
                NoHealthyReplicaError) as e:
            return 503, b"", "", ("unavailable", str(e), 1.0)
        except TimeoutError as e:
            return 504, b"", "", ("result_timeout", str(e), None)
        except RuntimeError as e:
            # "engine is not running" / "queue is closed": a replica
            # died after routing — still a typed unavailable
            return 503, b"", "", ("unavailable", str(e), 1.0)
        t1 = time.perf_counter()
        payload, content_type = (_encode_npz if npy
                                 else _encode_json)(outs)
        if trace is not None:
            events.complete("trace.dispatch_wait", dur=t1 - t0,
                            t_start=t0, trace=trace.trace,
                            span=tracing.new_span_id(),
                            parent=trace.span)
            events.complete("trace.response_encode",
                            dur=time.perf_counter() - t1, t_start=t1,
                            trace=trace.trace,
                            span=tracing.new_span_id(),
                            parent=trace.span)
        return 200, payload, content_type, None

    # -- ops surface -----------------------------------------------------------

    def report(self) -> Dict:
        """Scrape feed for ``MetricsRegistry.observe_gateway`` (the
        ``gan4j_gateway_*`` series and the ``/healthz`` gateway
        block)."""
        r = self.router.report()
        with self._lock:
            out = {
                "requests_total": self._requests_total,
                "rejected_total": self._rejected_total,
                "rejected_by_type": dict(self._rejected_by_type),
                "active_connections": self._active_connections,
            }
        out.update({
            "replicas": r["replicas"],
            "replicas_healthy": r["replicas_healthy"],
            "ejected_total": r["ejected_total"],
            "tenants_live": r["tenants_live"],
            "ok": r["ok"],
        })
        return out

    def health_block(self) -> Dict:
        return self.report()

    def _admin_handler(self, name: str) -> Optional[Callable]:
        return self._admin.get(name)  # fixed at construction

    def health_doc(self) -> Tuple[int, Dict]:
        """The full ``/healthz`` reply: the gateway block, plus the
        local engine's ``serve`` block when a ``serve_report`` hook is
        configured.  The status folds BOTH oks in, so a remote probe
        reads replica health from the status line alone (a wedged
        engine answers 503 while still listening)."""
        block = self.health_block()
        doc: Dict = {"gateway": block}
        ok = bool(block["ok"])
        if self._serve_report is not None:
            try:
                sblock = self._serve_report()
            except Exception as e:
                # a broken report hook is an UNHEALTHY replica, not a
                # crashed health endpoint
                sblock = {"ok": False, "error": repr(e)}
            doc["serve"] = sblock
            ok = ok and bool(sblock.get("ok"))
        return (200 if ok else 503), doc
