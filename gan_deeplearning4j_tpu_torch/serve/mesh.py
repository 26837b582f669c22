"""The multi-host routing tier: remote replicas over real sockets (torch
twin of ``gan_deeplearning4j_tpu/serve/mesh.py``, a copy: numpy and the
stdlib only).

``Router`` (serve/router.py) balances ENGINES in this process;
``MeshRouter`` balances replica PROCESSES (serve/replica.py) by their
HTTP surface, with the same semantics the in-process tier proved:

* **typed routing** — a 429 from a replica means "alive, shedding":
  try the next one, re-raise the last shed when everyone sheds.  A
  503/504 or a transport failure means THAT replica is broken: eject
  it and try the next.  A 400/404 is the caller's bug and propagates
  unchanged.  Nobody healthy → ``NoHealthyReplicaError``.
* **ejection + re-probe** — an ejected replica is skipped for
  ``recheck_s``, then re-probed via ``GET /healthz`` (the replica
  process folds its engine's ok into the status line, so one GET
  answers "healthy?"); a 200 re-admits it.  A wedged replica answers
  503 while still listening — distinguished from a dead socket by the
  SAME probe.
* **lock discipline** — the mesh lock guards the replica list and the
  ejection map only; every probe, every proxied generate and every
  event write runs OUTSIDE it (sockets never under locks).

The replica set is MUTABLE (``add``/``remove``) — the control plane
(serve/controlplane.py) grows and shrinks it live.  ``poll()`` runs
one full probe sweep and returns the aggregate the autoscaler feeds
on (queue-depth sum, p99 max, shed total), refreshing every
replica's health as a side effect.
"""

from __future__ import annotations

import json
import threading
import time
from http.client import HTTPException
from typing import Dict, List, Optional, Sequence

import numpy as np

from gan_deeplearning4j_tpu_torch.serve.client import (
    GatewayClient,
    GatewayHTTPError,
)
from gan_deeplearning4j_tpu_torch.serve.router import NoHealthyReplicaError
from gan_deeplearning4j_tpu_torch.telemetry import events, tracing

# what a probe treats as "the socket is broken" (vs. an HTTP answer)
_TRANSPORT_ERRORS = (ConnectionError, HTTPException, OSError)


class ReplicaProbeError(RuntimeError):
    """A health probe could not get ANY HTTP answer from the replica
    (refused, reset, timeout) — the dead-socket failure, as opposed to
    a 503 from a listening-but-unhealthy one."""

    def __init__(self, message: str, *, replica: str):
        super().__init__(message)
        self.replica = replica


class RemoteReplica:
    """One replica process's HTTP surface: health probe, proxied
    generate, admin verbs.  Owns a pooled ``GatewayClient`` with
    ``retries=0`` — retry/failover policy belongs to the MESH (try
    the next replica), not to the edge."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 30.0, pool_size: int = 4):
        self.host = host
        self.port = int(port)
        self._client = GatewayClient(host, port, retries=0,
                                     timeout_s=timeout_s,
                                     pool_size=pool_size)

    @property
    def name(self) -> str:
        return f"{self.host}:{self.port}"

    def probe(self) -> Dict:
        """GET /healthz; returns the parsed doc with ``_status``.
        Raises ``ReplicaProbeError`` when no HTTP answer exists."""
        try:
            return self._client.healthz()
        except _TRANSPORT_ERRORS as e:
            raise ReplicaProbeError(
                f"replica {self.name} unreachable: {e!r}",
                replica=self.name) from e

    def generate(self, xs: Sequence[np.ndarray], *,
                 tenant: Optional[str] = None,
                 encoding: str = "json",
                 trace=None) -> List[np.ndarray]:
        return self._client.generate(xs, tenant=tenant,
                                     encoding=encoding, trace=trace)

    def admin(self, verb: str, params: Optional[Dict] = None) -> Dict:
        """POST /admin/{verb}; returns the result payload.  Raises
        ``GatewayHTTPError`` (typed status) on a non-200 answer and
        transport errors unchanged."""
        body = json.dumps(params or {}).encode("utf-8")
        status, headers, data = self._client._request(
            "POST", f"/admin/{verb}", body, "application/json")
        if status != 200:
            self._client._raise(status, headers, data)
        return json.loads(data.decode("utf-8"))["result"]

    def close(self) -> None:
        self._client.close()


class MeshRouter:
    """Round-robin over a MUTABLE set of remote replicas with typed
    ejection and bounded re-probe (semantics above).

    A replica starts healthy; it is ejected when a routed request
    fails at the replica level (503/504/transport) or a ``poll``
    sweep finds it unhealthy, and re-admitted when a re-probe — run
    at most every ``recheck_s`` per ejected replica, on the next
    request that considers it or the next sweep — answers 200."""

    def __init__(self, replicas: Sequence[RemoteReplica] = (), *,
                 recheck_s: float = 1.0):
        self.recheck_s = float(recheck_s)
        self._lock = threading.Lock()
        self._replicas: List[RemoteReplica] = list(replicas)
        self._down: Dict[str, float] = {}  # name -> t_ejected/reprobed
        self._rr = 0
        self._ejected_total = 0
        # requests re-offered to another replica after a failed
        # attempt (shed/eject failover) — read by run_socket_load the
        # way it reads GatewayClient.retried_total
        self.retried_total = 0

    # -- membership (the control plane's surface) ------------------------------

    def add(self, replica: RemoteReplica) -> None:
        with self._lock:
            if any(r.name == replica.name for r in self._replicas):
                raise ValueError(
                    f"replica {replica.name} already in the mesh")
            self._replicas.append(replica)
        events.instant("mesh.replica_added", replica=replica.name)

    def remove(self, name: str) -> Optional[RemoteReplica]:
        """Drop ``name`` from the set (closing its client); returns
        the removed replica or None.  Traffic in flight to it finishes
        or fails typed — removal only stops NEW placements."""
        with self._lock:
            found = None
            for i, r in enumerate(self._replicas):
                if r.name == name:
                    found = self._replicas.pop(i)
                    break
            self._down.pop(name, None)
        if found is not None:
            found.close()
            events.instant("mesh.replica_removed", replica=name)
        return found

    def get(self, name: str) -> Optional[RemoteReplica]:
        with self._lock:
            for r in self._replicas:
                if r.name == name:
                    return r
        return None

    def names(self) -> List[str]:
        with self._lock:
            return [r.name for r in self._replicas]

    # -- health bookkeeping ----------------------------------------------------

    def _mark(self, replica: RemoteReplica, ok: bool) -> None:
        """Fold one probe/request outcome into the ejection map (pure
        bookkeeping under the lock; events after)."""
        now = time.monotonic()
        flipped = None
        with self._lock:
            down = replica.name in self._down
            if ok and down:
                del self._down[replica.name]
                flipped = "mesh.replica_restored"
            elif not ok:
                self._down[replica.name] = now
                if not down:
                    self._ejected_total += 1
                    flipped = "mesh.replica_ejected"
        if flipped is not None:
            events.instant(flipped, replica=replica.name)

    def _healthy(self, replica: RemoteReplica) -> bool:
        """Routing-time health: a non-ejected replica is trusted (its
        failures eject it); an ejected one gets a real re-probe at
        most every ``recheck_s``."""
        now = time.monotonic()
        with self._lock:
            t = self._down.get(replica.name)
            if t is None:
                return True
            if (now - t) < self.recheck_s:
                return False
            # claim this re-probe window so concurrent callers don't
            # all probe at once
            self._down[replica.name] = now
        try:
            ok = replica.probe().get("_status") == 200
        except ReplicaProbeError:
            ok = False
        self._mark(replica, ok)
        return ok

    # -- routing ---------------------------------------------------------------

    def generate(self, xs: Sequence[np.ndarray], *,
                 tenant: Optional[str] = None,
                 encoding: str = "json",
                 trace=None) -> List[np.ndarray]:
        """Place one request on a healthy replica (semantics in the
        module docstring).

        Tracing: the mesh is the first hop for its direct callers —
        with ``trace=None`` it mints a root and wraps the whole
        routing decision in a ``trace.route`` span; a caller context
        parents the route span instead.  EVERY attempt (failed hops
        included) is its own ``trace.hop`` child span, and the hop's
        context rides the wire to the replica — so a failover's
        merged trace shows both hops under one trace id."""
        ctx = (tracing.child(trace) if trace is not None
               else tracing.mint())
        route_attrs = {"trace": ctx.trace, "span": ctx.span}
        if trace is not None:
            route_attrs["parent"] = trace.span
        with events.span("trace.route", **route_attrs):
            return self._generate_routed(xs, tenant, encoding, ctx)

    def _generate_routed(self, xs: Sequence[np.ndarray],
                         tenant: Optional[str], encoding: str,
                         ctx: "tracing.TraceContext"
                         ) -> List[np.ndarray]:
        with self._lock:
            replicas = list(self._replicas)
            start = self._rr
            self._rr += 1
        n = len(replicas)
        if n == 0:
            raise NoHealthyReplicaError(
                "no replicas configured in the mesh")
        last_shed: Optional[GatewayHTTPError] = None
        tried = 0
        for i in range(n):
            replica = replicas[(start + i) % n]
            if not self._healthy(replica):
                continue
            tried += 1
            hop = tracing.child(ctx)
            try:
                # the hop span closes with an ``error`` attribute when
                # the attempt raises — the failed hop stays visible in
                # the merged timeline next to the one that succeeded
                with events.span("trace.hop", trace=ctx.trace,
                                 span=hop.span, parent=ctx.span,
                                 replica=replica.name):
                    return replica.generate(xs, tenant=tenant,
                                            encoding=encoding,
                                            trace=hop)
            except GatewayHTTPError as e:
                if e.status == 429:
                    last_shed = e  # alive but shedding: try the next
                    with self._lock:
                        self.retried_total += 1
                    continue
                if e.status in (503, 504):
                    self._mark(replica, False)
                    with self._lock:
                        self.retried_total += 1
                    continue
                raise  # 400/404/...: the caller's bug, not routing
            except _TRANSPORT_ERRORS:
                self._mark(replica, False)
                with self._lock:
                    self.retried_total += 1
                continue
        if last_shed is not None:
            raise last_shed
        raise NoHealthyReplicaError(
            f"no healthy replica ({n} configured, {tried} accepting)")

    # -- sweeps + ops surface --------------------------------------------------

    def poll(self) -> Dict:
        """One full probe sweep: refresh every replica's health and
        return the autoscaler's aggregate — queue-depth SUM, p99 MAX,
        shed/error SUMs over the healthy serve blocks, plus the raw
        per-replica blocks."""
        with self._lock:
            replicas = list(self._replicas)
        agg: Dict = {"replicas": len(replicas), "healthy": 0,
                     "queue_depth": 0, "p99_ms": 0.0, "shed_total": 0,
                     "errors_total": 0, "requests_total": 0,
                     "reports": {}}
        for replica in replicas:
            try:
                doc = replica.probe()
            except ReplicaProbeError:
                self._mark(replica, False)
                agg["reports"][replica.name] = None
                continue
            ok = doc.get("_status") == 200
            self._mark(replica, ok)
            serve = doc.get("serve") or {}
            agg["reports"][replica.name] = serve
            if not ok:
                continue
            agg["healthy"] += 1
            agg["queue_depth"] += int(serve.get("queue_depth") or 0)
            agg["p99_ms"] = max(agg["p99_ms"],
                                float(serve.get("p99_ms") or 0.0))
            agg["shed_total"] += int(serve.get("shed_total") or 0)
            agg["errors_total"] += int(serve.get("errors_total") or 0)
            agg["requests_total"] += int(
                serve.get("requests_total") or 0)
        return agg

    def report(self) -> Dict:
        """Scrape feed for ``MetricsRegistry.observe_serving_mesh``
        (the ``gan4j_mesh_*`` series and the ``/healthz``
        serving_mesh block).  Pure bookkeeping — no probes."""
        with self._lock:
            names = [r.name for r in self._replicas]
            down = set(self._down) & set(names)
            ejected_total = self._ejected_total
        healthy = len(names) - len(down)
        return {"replicas": len(names),
                "replicas_healthy": healthy,
                "replica_ok": [n not in down for n in names],
                "ejected_total": ejected_total,
                "ok": healthy > 0}

    def close(self) -> None:
        with self._lock:
            taken = list(self._replicas)
            self._replicas = []
            self._down.clear()
        for r in taken:
            r.close()
