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
to a tenant's own engine over its generator sliced from a fleet state,
``train/fleet.py``) come with per-tenant quotas, an LRU bound on live
engines, in-place hotswap from a newer fleet checkpoint and the
``router.tenant_*`` / ``router.fleet_hotswap`` events.  Without a bank a
tenant request raises ``KeyError`` (the gateway's 404), as the JAX router
does.  A replica's ejection and its return are
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
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.parallel.inference import (
    DEFAULT_SERVING_BUCKETS,
    ParallelInference,
)
from gan_deeplearning4j_tpu_torch.serve.admission import Request, ShedError
from gan_deeplearning4j_tpu_torch.serve.engine import (
    ServeEngine,
    _array_trailing,
)
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
    """Per-tenant serving engines sliced from one fleet state.

    ``build_graph``: zero-arg factory returning a fresh generator
    ``ComputationGraph`` whose parameter tree matches the fleet's
    ``gen_params`` entry (e.g. ``lambda: M.build_generator(cfg)``); the
    engines serve on its device.  ``checkpointer``: a ``FleetCheckpointer``
    to restore the fleet state from (lazily, once, onto the host); or pass
    ``state`` (a fleet ``ProtocolState`` with a leading tenant axis)
    directly.  ``max_live``: LRU bound on concurrently-live tenant engines
    — the eviction victim is stopped (``ServeEngine.stop`` is bounded and
    answers everything outstanding first).

    Tenant ids are validated against the fleet BEFORE slicing: a negative
    torch index would wrap around and serve another tenant's weights, so
    an id outside ``[0, num_tenants)`` is a ``KeyError`` (the gateway's
    404 ``unknown_tenant``).

    A checkpoint that records a tenant-id -> slot map in its extras
    (``fleet_tenant_map``, lifecycle fleets) keys everything on stable
    tenant ids and resolves the slot per request.  Without a map, ids are
    raw slot indices.

    ``quota_capacity``/``quota_refill_per_s`` arm a per-tenant serving
    token bucket (one token per request, charged by the router before the
    engine accessor): an exhausted tenant gets a typed
    ``TenantThrottledError`` while its neighbours keep their allowance."""

    def __init__(self, build_graph: Callable, *,
                 checkpointer=None, state=None,
                 buckets: Sequence[int] = DEFAULT_SERVING_BUCKETS,
                 max_live: int = 4,
                 supervise: bool = False,
                 watchdog_deadline_s: Optional[float] = None,
                 admission_factory: Optional[Callable] = None,
                 quota_capacity: Optional[int] = None,
                 quota_refill_per_s: Optional[float] = None):
        if (checkpointer is None) == (state is None):
            raise ValueError(
                "FleetTenantBank needs exactly one of checkpointer= "
                "or state=")
        if max_live <= 0:
            raise ValueError("max_live must be > 0")
        self._build_graph = build_graph
        self._checkpointer = checkpointer
        self._state = state
        self._buckets = tuple(buckets)
        self._max_live = int(max_live)
        self._supervise = bool(supervise)
        self._wd_deadline_s = watchdog_deadline_s
        self._admission_factory = admission_factory
        self._quota_capacity = quota_capacity
        self._quota_refill = (quota_refill_per_s
                              if quota_refill_per_s is not None
                              else quota_capacity)
        self._lock = threading.Lock()
        self._live: "OrderedDict[int, ServeEngine]" = OrderedDict()
        self._num_tenants: Optional[int] = None
        # tenant-id -> slot (from the checkpoint's fleet_tenant_map); None
        # means raw-slot-index ids
        self._tenant_slots: Optional[List[Optional[int]]] = None
        self._quota: Dict[int, object] = {}
        self._device = None  # the engines' device, from the first graph

    # -- state -----------------------------------------------------------------

    def _ensure_state(self):
        """Restore the full fleet state once (host) and cache it: slicing
        the cached state per tenant is bit-equal to a per-tenant restore
        (``FleetCheckpointer.restore(tenants=t)`` is defined so)."""
        with self._lock:
            state = self._state
        if state is not None:
            return state
        _, state, extra = self._checkpointer.restore()
        n = extra.get("fleet_tenants")
        tmap = extra.get("fleet_tenant_map")
        with self._lock:
            if self._state is None:
                self._state = state
                if n is not None:
                    self._num_tenants = int(n)
                if isinstance(tmap, dict) and "slots" in tmap:
                    self._tenant_slots = list(tmap["slots"])
            state = self._state
        return state

    def num_tenants(self) -> int:
        state = self._ensure_state()
        with self._lock:
            if self._num_tenants is None:
                self._num_tenants = int(state.it.shape[0])
            return self._num_tenants

    def _resolve(self, t: int) -> int:
        """The state slot serving tenant id ``t``: the id itself for
        raw-slot fleets (checked in range: never a negative index), a
        ``slots.index`` lookup with a recorded tenant map.  ``KeyError``
        for an id the current state does not serve."""
        self._ensure_state()
        with self._lock:
            slots = self._tenant_slots
        if slots is not None:
            try:
                return slots.index(t)
            except ValueError:
                raise KeyError(t) from None
        if not 0 <= t < self.num_tenants():
            raise KeyError(t)
        return t

    # -- quotas ----------------------------------------------------------------

    def charge(self, tenant) -> None:
        """Take one token from ``tenant``'s serving quota bucket (a no-op
        without quotas).  Validates the id FIRST (unknown tenants get their
        ``KeyError`` without allocating a bucket).  Raises
        :class:`TenantThrottledError` when the bucket is empty."""
        if self._quota_capacity is None:
            return
        t = _tenant_id(tenant)
        self._resolve(t)
        from gan_deeplearning4j_tpu_torch.serve.gateway import TokenBucket

        with self._lock:
            bucket = self._quota.get(t)
            if bucket is None:
                bucket = TokenBucket(self._quota_capacity,
                                     self._quota_refill)
                self._quota[t] = bucket
            ok, retry_after = bucket.take()
        if not ok:
            events.instant("router.tenant_throttled", tenant=t,
                           retry_after_s=round(retry_after, 3))
            raise TenantThrottledError(t, retry_after)

    # -- engines ---------------------------------------------------------------

    def _build_engine(self, tenant: int) -> ServeEngine:
        slot = self._resolve(tenant)
        graph = self._build_graph()
        self._device = graph.device
        # the slice copied onto the engine's device: the engine owns it
        graph.params = {
            layer: {n: v[slot].detach().to(graph.device, copy=True)
                    for n, v in lp.items()}
            for layer, lp in self._ensure_state().gen_params.items()}
        infer = ParallelInference(graph, buckets=self._buckets)
        admission = (self._admission_factory()
                     if self._admission_factory is not None else None)
        eng = ServeEngine(infer=infer, admission=admission,
                          supervise=self._supervise,
                          watchdog_deadline_s=self._wd_deadline_s)
        # capture every bucket before the first request, as a replica does
        eng.warmup(*(np.zeros((1,) + _array_trailing(graph.input_specs[n]),
                              np.float32) for n in graph.input_names))
        eng.start()
        return eng

    def engine(self, tenant) -> ServeEngine:
        """The live engine for ``tenant`` (built, warmed and started on
        first use; LRU thereafter).  ``KeyError`` for an id the current
        fleet state does not serve."""
        t = _tenant_id(tenant)
        with self._lock:
            eng = self._live.get(t)
            if eng is not None:
                self._live.move_to_end(t)
                return eng
        self._resolve(t)  # KeyError for an unknown id
        # build OUTSIDE the lock (capture + thread start are slow); a
        # racing builder for the same tenant loses and is stopped
        built = self._build_engine(t)
        evicted: List[ServeEngine] = []
        with self._lock:
            eng = self._live.get(t)
            if eng is None:
                self._live[t] = built
                eng = built
                while len(self._live) > self._max_live:
                    _, victim = self._live.popitem(last=False)
                    evicted.append(victim)
            else:
                evicted.append(built)
        for victim in evicted:
            victim.stop()
        if evicted:
            events.instant("router.tenant_evicted",
                           evicted=len(evicted), tenant=t)
        return eng

    # -- hotswap ---------------------------------------------------------------

    def hotswap_from(self, directory: Optional[str] = None, *,
                     step: Optional[int] = None,
                     max_step: Optional[int] = None) -> int:
        """Restore a newer fleet checkpoint and push each live tenant's
        fresh slice into its engine in place (``ServeEngine.hotswap_params``:
        the engine objects stay, so routers holding them stay valid).
        ``step`` pins exactly (``CheckpointCorruptError`` on verification
        failure), ``max_step`` bounds the newest-first verified walk, and
        ``NoVerifiedCheckpointError`` propagates when nothing loads (the
        bank keeps serving the old state).  ``directory`` defaults to the
        bank's own checkpointer.  Tenants the new state no longer serves
        are evicted, never remapped onto someone else's slot."""
        from gan_deeplearning4j_tpu_torch.train.fleet import FleetCheckpointer

        if directory is not None:
            # read-side handle: the trainer owns this directory and may be
            # mid-save — never sweep its in-flight tmp dirs
            ck = FleetCheckpointer(str(directory), sweep_debris=False)
        elif self._checkpointer is not None:
            ck = self._checkpointer
        else:
            raise ValueError(
                "a state-mode FleetTenantBank needs an explicit "
                "directory to hotswap from")
        got, state, extra = ck.restore(step=step, max_step=max_step)
        n = int(extra.get("fleet_tenants") or state.it.shape[0])
        tmap = extra.get("fleet_tenant_map")
        slots = (list(tmap["slots"])
                 if isinstance(tmap, dict) and "slots" in tmap else None)

        def _slot_of(t: int) -> Optional[int]:
            if slots is not None:
                return slots.index(t) if t in slots else None
            return t if 0 <= t < n else None

        evicted: List[ServeEngine] = []
        with self._lock:
            self._state = state
            self._num_tenants = n
            self._tenant_slots = slots
            for t in [t for t in self._live if _slot_of(t) is None]:
                evicted.append(self._live.pop(t))
            live = list(self._live.items())
        for victim in evicted:
            victim.stop()
        # push the new slices OUTSIDE the lock: each engine's own swap
        # lock serializes against its dispatch
        for t, eng in live:
            slot = _slot_of(t)
            eng.hotswap_params({
                layer: {k: v[slot].detach().to(self._device, copy=True)
                        for k, v in lp.items()}
                for layer, lp in state.gen_params.items()})
        events.instant("router.fleet_hotswap", step=got, tenants=n,
                       live=len(live), evicted=len(evicted))
        return got

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def stop(self) -> None:
        with self._lock:
            live, self._live = list(self._live.values()), OrderedDict()
        for eng in live:
            eng.stop()


def _tenant_id(tenant) -> int:
    """A tenant id as an int (the gateway passes the URL's text); anything
    else is an unknown tenant."""
    if isinstance(tenant, bool):
        raise KeyError(tenant)
    try:
        return int(tenant)
    except (TypeError, ValueError):
        raise KeyError(tenant) from None
