"""Multi-engine routing: replica load balancing (torch twin of
``gan_deeplearning4j_tpu/serve/router.py``).

One ``ServeEngine`` is one dispatch thread over one set of bucket graphs.
``Router`` spreads plain generate traffic round-robin across N engine
replicas with health-aware dispatch: a replica whose watchdog reports
stalled (``engine.stalled`` — the ``/healthz`` serve block's failure
condition) or whose engine is not running is EJECTED and re-probed at
most every ``recheck_s`` until it recovers; requests drain to the
survivors.  A replica that sheds (``ShedError``) is NOT unhealthy — it is
at capacity — so the router offers the request to the next replica and
only re-raises the shed when every healthy replica shed it (the service,
not one engine, is full).  Graceful degradation, never a hang: with zero
healthy replicas ``submit`` raises a typed ``NoHealthyReplicaError``
immediately.

Fleet tenants (``FleetTenantBank``: ``/v1/tenants/{id}/generate`` routed
to a tenant's generator sliced from a fleet state) need the fleet
trainer, which is not ported (ROADMAP Queue 1 item 9): the class raises.
Without a bank a tenant request raises ``KeyError`` (the gateway's 404),
as the JAX router does.  A replica's ejection and its return are
``router.replica_ejected`` / ``router.replica_restored`` instants on the
events timeline.

Lock discipline: the router lock guards only its own bookkeeping
(round-robin cursor, ejection map); engine calls — submit, stop — and
event writes always happen OUTSIDE it, so it can never be part of a cycle
with the engine, admission or recorder locks.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.serve.admission import Request, ShedError
from gan_deeplearning4j_tpu_torch.serve.engine import ServeEngine
from gan_deeplearning4j_tpu_torch.telemetry import events


class NoHealthyReplicaError(RuntimeError):
    """Every replica is ejected (stalled or stopped): the typed
    "service unavailable" answer — the router never parks a request
    hoping a replica comes back."""


class TenantThrottledError(RuntimeError):
    """A tenant's serving quota bucket is empty — the typed 429 for
    per-tenant isolation: one tenant burning its allowance never
    degrades its neighbours.  ``retry_after_s`` is when one token is
    back (the gateway's Retry-After header)."""

    def __init__(self, tenant, retry_after_s: float):
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"tenant {tenant!r} is over its serving quota — retry in "
            f"{self.retry_after_s:.3f}s")


class Router:
    """Health-aware round-robin over engine replicas, plus optional
    tenant routing through a ``FleetTenantBank``.

    ``replicas``: started ``ServeEngine`` instances (may be empty when
    only tenant routing is used).  ``tenants``: a ``FleetTenantBank``
    (or anything with an ``engine(tenant_id) -> ServeEngine`` method).
    ``recheck_s``: how often an ejected replica is re-probed."""

    def __init__(self, replicas: Sequence[ServeEngine] = (),
                 tenants: Optional["FleetTenantBank"] = None,
                 recheck_s: float = 0.5):
        self.replicas: Tuple[ServeEngine, ...] = tuple(replicas)
        self.tenants = tenants
        self._recheck_s = float(recheck_s)
        self._lock = threading.Lock()
        self._rr = 0
        # replica index -> monotonic time of the last failed probe;
        # presence in the map IS the ejected state
        self._down: Dict[int, float] = {}
        self._ejected_total = 0

    # -- health ----------------------------------------------------------------

    def _probe(self, idx: int) -> bool:
        eng = self.replicas[idx]
        return eng.running and not eng.stalled

    def _healthy(self, idx: int) -> bool:
        """Probe gate for one replica: healthy replicas are checked
        every time (the probe is two flag reads); ejected replicas are
        re-probed at most every ``recheck_s`` so a dead engine costs
        one timestamp compare per request, not a probe."""
        now = time.monotonic()
        with self._lock:
            down_at = self._down.get(idx)
            if down_at is not None and now - down_at < self._recheck_s:
                return False
        ok = self._probe(idx)
        flipped = None
        with self._lock:
            if ok:
                if self._down.pop(idx, None) is not None:
                    flipped = "router.replica_restored"
            else:
                if idx not in self._down:
                    self._ejected_total += 1
                    flipped = "router.replica_ejected"
                self._down[idx] = now
        if flipped is not None:
            events.instant(flipped, replica=idx)
        return ok

    def _eject(self, idx: int) -> None:
        with self._lock:
            fresh = idx not in self._down
            if fresh:
                self._ejected_total += 1
            self._down[idx] = time.monotonic()
        if fresh:
            events.instant("router.replica_ejected", replica=idx)

    # -- dispatch --------------------------------------------------------------

    def submit(self, xs: Sequence[np.ndarray],
               tenant: Optional[str] = None, trace=None) -> Request:
        """Admit one request and return its ``Request`` handle.

        Tenant requests go to the tenant's own engine (``KeyError``
        for an unknown tenant).  Plain requests try each healthy
        replica once in round-robin order: a stopped/stalled replica
        is ejected and skipped, a shedding replica is passed over; the
        request fails with the LAST shed only when every healthy
        replica shed it, and with ``NoHealthyReplicaError`` when none
        was healthy at all.  ``trace`` (a ``tracing.TraceContext``)
        rides through to the engine, which parents the request's stage
        spans under it."""
        if tenant is not None:
            if self.tenants is None:
                raise KeyError(tenant)
            # charge BEFORE the engine accessor: a throttled request
            # must not trigger a first-use engine build (compile), and
            # charge() validates the id, so unknown tenants still get
            # their KeyError without allocating a quota bucket
            charge = getattr(self.tenants, "charge", None)
            if charge is not None:
                charge(tenant)
            return self.tenants.engine(tenant).submit(*xs, trace=trace)
        if not self.replicas:
            raise NoHealthyReplicaError(
                "router has no replicas configured")
        n = len(self.replicas)
        with self._lock:
            start = self._rr
            self._rr = (self._rr + 1) % n
        last_shed: Optional[ShedError] = None
        tried = 0
        for off in range(n):
            idx = (start + off) % n
            if not self._healthy(idx):
                continue
            tried += 1
            try:
                return self.replicas[idx].submit(*xs, trace=trace)
            except ShedError as e:
                last_shed = e  # at capacity, not unhealthy: try next
            except ValueError:
                raise  # caller bug — identical on every replica
            except RuntimeError:
                # "engine is not running" / "queue is closed": the
                # replica died between the probe and the submit
                self._eject(idx)
        if last_shed is not None:
            raise last_shed
        raise NoHealthyReplicaError(
            f"no healthy replica ({n} configured, {tried} accepting)")

    # -- ops surface -----------------------------------------------------------

    def healthy_count(self) -> int:
        return sum(1 for i in range(len(self.replicas))
                   if self._healthy(i))

    def report(self) -> Dict:
        replica_ok = [self._healthy(i)
                      for i in range(len(self.replicas))]
        with self._lock:
            ejected_total = self._ejected_total
        ok = (any(replica_ok) if self.replicas
              else self.tenants is not None)
        return {
            "replicas": len(self.replicas),
            "replicas_healthy": sum(replica_ok),
            "replica_ok": replica_ok,
            "ejected_total": ejected_total,
            "tenants_live": (self.tenants.live_count()
                             if self.tenants is not None else 0),
            "ok": ok,
        }

    def stop(self) -> None:
        """Stop every replica and tenant engine (bounded — each
        ``ServeEngine.stop`` is)."""
        for eng in self.replicas:
            eng.stop()
        if self.tenants is not None:
            self.tenants.stop()


class FleetTenantBank:
    """Per-tenant serving engines sliced from one fleet state — not
    ported: it needs the fleet trainer (``train/fleet.py``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FleetTenantBank is not ported yet (ROADMAP Queue 1 item 9: "
            "train/fleet.py, the fleet trainer it slices tenants from)")
