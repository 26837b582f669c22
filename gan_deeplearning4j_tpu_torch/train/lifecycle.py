"""Tenant lifecycle layer: heterogeneous elastic fleets, one fault domain a
tenant (torch twin of ``gan_deeplearning4j_tpu/train/lifecycle.py``).

``train/fleet.py`` runs N tenants of one architecture with N fixed when it
starts.  Here every tenant is its own fault domain and membership is a
runtime value:

  - **Heterogeneous cohorts**: tenants are grouped by architecture
    (``TenantSpec.hidden`` x ``TenantSpec.gen_layers``) into cohorts; each
    cohort is one masked fleet step (``make_fleet_step(masked=True,
    per_tenant_data=True)``), and every cohort advances inside one
    supervised window loop (``LifecycleFleetTrainer``, behind the one
    ``SupervisionShell``).
  - **Bucketed capacity, no capture after warm-up**: each cohort is padded
    to a bucketed slot count (``DEFAULT_TENANT_BUCKETS``); unoccupied slots
    are *ghosts* (template params, mask off, zero data), so onboard,
    offboard, quarantine and a hop to the next warmed bucket are mask flips
    and state surgery.  On the card ``warmup()`` captures one CUDA graph
    per (cohort, warmed bucket) (``fused_step.GraphedStep``); the torch
    counterpart of the JAX ``RecompileSentinel`` is
    ``captures_after_warmup``, which a
    membership change within the warmed set leaves at 0.  Surgery writes
    into the captured graph's static state in place (a rebound buffer
    would leave the graph reading stale memory), and a bucket hop copies
    the state into the next bucket's static buffers.  Before a window's
    replays the mask, the per-tenant tables and the tenant ids are copied
    into the graph's static inputs.
  - **Per-tenant latents**: a tenant's draws depend only on (seed, tenant
    id, its own step count), whatever its slot, its cohort's capacity or
    its neighbours (the JAX module's ``fold_in(base, tenant_id)``):
    ``fleet.tenant_latents`` is a counter-based draw (a SplitMix64 hash of
    those values and the element's index) computed inside the step, so the
    graph needs no generator state and a checkpoint needs none beyond
    ``it``.  Parity tests replace ``FleetManager.latent_fn`` with the JAX
    package's draws.
  - **Isolation**: per-tenant NaN / divergence tripping
    (``FleetHealthSentinel``) quarantines (masks off and freezes) only the
    sick tenant; the ``TenantRouter``'s per-tenant quarantine budgets run
    with ``raise_on_budget=False``, so a poisoned feed trips one tenant
    instead of raising through the loop; token-bucket quotas cap a hot
    tenant's rows.  Lanes are element-wise independent in the step and its
    kernels, so every surviving tenant's losses and params stay bitwise
    those of a control run through any lifecycle event.

Checkpoints: one ``FleetCheckpointer`` directory per cohort, each save
carrying the tenant-id -> slot/cohort map, so ``restore(tenants=<id>)``
resolves by identity.  Offboarding writes a final single-tenant checkpoint
the tenant can be re-onboarded from.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.data import resilient
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.telemetry import events as telemetry_events
from gan_deeplearning4j_tpu_torch.train import fleet as fleet_lib
from gan_deeplearning4j_tpu_torch.train import fused_step as fused_lib
from gan_deeplearning4j_tpu_torch.train.fused_step import ProtocolState
from gan_deeplearning4j_tpu_torch.utils import device as device_lib

# Bucketed slot counts of the tenant axis (the serving buckets' discipline
# applied to fleet membership): a cohort's capacity is always one of these.
DEFAULT_TENANT_BUCKETS = (2, 4, 8, 16, 32, 64)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= ``n`` (capacity for ``n`` occupied slots)."""
    for b in sorted(buckets):
        if b >= n:
            return int(b)
    raise ValueError(
        f"{n} tenants exceed the largest tenant bucket "
        f"{max(buckets)} — extend LifecycleConfig.buckets")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's identity and architecture.  ``tenant_id`` is the
    stable routing identity (a ``TenantRouter`` segment); tenants share a
    cohort iff their (hidden, gen_layers) agree."""

    tenant_id: int
    hidden: int = 100
    gen_layers: int = 3

    @property
    def cohort_key(self) -> str:
        return f"h{self.hidden}_l{self.gen_layers}"


@dataclasses.dataclass
class LifecycleConfig:
    """Knobs of a lifecycle-managed heterogeneous fleet (the JAX module's
    fields and defaults, and ``device``)."""

    batch_size: int = 4
    seed: int = prng.NUMBER_OF_THE_BEAST
    res_path: str = "outputs/lifecycle"
    buckets: Tuple[int, ...] = DEFAULT_TENANT_BUCKETS
    # buckets captured per cohort at warm-up; None = every bucket up to ONE
    # above the cohort's first occupancy (room to grow once); the
    # no-capture guarantee covers exactly the warmed set
    warm_buckets: Optional[Tuple[int, ...]] = None
    # the router's fixed segment universe; None = max tenant id + 1 over
    # the first specs (pass it when later onboards use higher ids)
    num_segments: Optional[int] = None
    quarantine_budget: int = 8   # bad rows per tenant before a trip
    quota_rows: Optional[float] = None          # token-bucket capacity
    quota_refill_per_s: Optional[float] = None  # rows/s refill
    divergence_factor: float = 1e3
    divergence_patience: int = 2
    keep_checkpoints: int = 3
    checkpoint_every: int = 0    # steps; 0 = only explicit saves
    record_timelines: bool = False  # keep per-step per-tenant losses
    device: Optional[str] = None    # None = the card


class FleetHealthSentinel:
    """Per-tenant divergence / NaN tripping over window loss vectors.

    A non-finite d/g loss trips at once (``"nan"``); a window whose mean
    loss magnitude exceeds ``factor`` x the tenant's own rolling median
    for ``patience`` consecutive windows trips as ``"divergence"``.  The
    scope is ONE tenant."""

    def __init__(self, factor: float = 1e3, patience: int = 2,
                 history: int = 16):
        self.factor = float(factor)
        self.patience = int(patience)
        self._hist: Dict[int, deque] = {}
        self._strikes: Dict[int, int] = {}

    def observe(self, tenant: int, d_losses, g_losses) -> Optional[str]:
        """Feed one window of per-step losses -> a trip reason or None."""
        d = np.asarray(d_losses, np.float64)
        g = np.asarray(g_losses, np.float64)
        if not (np.isfinite(d).all() and np.isfinite(g).all()):
            return "nan"
        mag = float(np.abs(d).mean() + np.abs(g).mean())
        hist = self._hist.setdefault(
            tenant, deque(maxlen=max(4, self.patience * 8)))
        if len(hist) >= 3:
            med = float(np.median(hist))
            if med > 0.0 and mag > self.factor * med:
                self._strikes[tenant] = self._strikes.get(tenant, 0) + 1
                if self._strikes[tenant] >= self.patience:
                    return "divergence"
                return None  # a strike is not yet a trip
        self._strikes[tenant] = 0
        hist.append(mag)
        return None

    def forget(self, tenant: int) -> None:
        self._hist.pop(tenant, None)
        self._strikes.pop(tenant, None)


class _PendingOps:
    """Thread-safe queue of boundary ops: other threads enqueue lifecycle
    mutations; the loop drains them at window boundaries, the only place
    membership may change."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: List[Callable[[], None]] = []

    def push(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._ops.append(fn)

    def drain(self) -> List[Callable[[], None]]:
        with self._lock:
            ops, self._ops = self._ops, []
        return ops


# ---------------------------------------------------------------------------
# state surgery on stacked states, in place

def _set_row(state: ProtocolState, slot: int, row: ProtocolState) -> None:
    """Write the single-tenant ``row`` into lane ``slot`` of ``state``'s
    buffers (the buffers stay the same tensors)."""
    dst, src = fused_lib._leaves(state), fused_lib._leaves(row)
    if dst.keys() != src.keys():
        raise ValueError(f"the row's leaves differ from the fleet's: "
                         f"{sorted(set(dst) ^ set(src))}")
    with torch.no_grad():
        for key, t in dst.items():
            t[slot].copy_(src[key].to(t.device, t.dtype))


def _copy_rows(dst: ProtocolState, src: ProtocolState, n: int) -> None:
    """Lanes [0, n) of ``src`` into the same lanes of ``dst``, in place."""
    d, s = fused_lib._leaves(dst), fused_lib._leaves(src)
    with torch.no_grad():
        for key, t in d.items():
            t[:n].copy_(s[key][:n])


def _host_row(state: ProtocolState, slot: int) -> ProtocolState:
    """Lane ``slot`` of ``state`` as a single-tenant state on the host."""
    return fused_lib.clone_state(
        fleet_lib._map_state(lambda x: x[slot].cpu(), state))


class Cohort:
    """One architecture's slice of the fleet: a bucketed slot vector, its
    masked step and the lifecycle verbs as state surgery.  ``state`` is the
    live stacked state: on the card, once warmed, the static state of the
    current capacity's graph (``FleetManager.lane_graph``)."""

    def __init__(self, key: str, hidden: int, gen_layers: int,
                 config: LifecycleConfig, device: torch.device):
        from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as M

        self.key = key
        self.hidden = hidden
        self.gen_layers = gen_layers
        self.c = config
        self.device = device
        cfg = M.InsuranceConfig(seed=config.seed, hidden=hidden,
                                gen_layers=gen_layers)
        self.model_cfg = cfg
        dis = M.build_discriminator(cfg, device=device)
        self.graphs = (dis, M.build_generator(cfg, device=device),
                       M.build_gan(cfg, device=device),
                       M.build_classifier(dis, cfg))
        self.maps = (M.DIS_TO_GAN, M.gan_to_gen_map(cfg),
                     M.DIS_TO_CLASSIFIER)
        self.step = fleet_lib.make_fleet_step(
            *self.graphs, *self.maps, z_size=cfg.z_size,
            num_features=cfg.num_features, per_tenant_data=True,
            masked=True)
        # ghost lanes hold the template init: a fresh onboard is a mask
        # flip plus this row (it = 0)
        self.template = fused_lib.clone_state(
            fused_lib.state_from_graphs(*self.graphs))
        self.slots: List[Optional[int]] = []
        self.mask = np.zeros((0,), bool)
        self.state: Optional[ProtocolState] = None
        self.lane_graphs: Dict[int, fused_lib.GraphedStep] = {}

    # -- membership ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return len(self.slots)

    def launches_per_step(self) -> Dict[str, int]:
        """The port kernels one masked step launches, from the graphs: a
        forward and a backward tenant BN for every train-mode BN of the
        three trained graphs (frozen layers run in inference), one
        ``fused_update`` a graph update."""
        from gan_deeplearning4j_tpu_torch.graph import BatchNorm

        dis, _, gan, clf = self.graphs
        bns = sum(isinstance(node.layer, BatchNorm) and name not in g.frozen
                  for g in (dis, gan, clf) for name, node in g.nodes.items())
        return {"bn_act_tenants": bns, "bn_act_tenants_bwd": bns,
                "fused_update": 3}

    def active_ids(self) -> List[int]:
        return [t for t, on in zip(self.slots, self.mask)
                if t is not None and on]

    def occupied_ids(self) -> List[int]:
        return [t for t in self.slots if t is not None]

    def slot_of(self, tenant: int) -> int:
        return self.slots.index(tenant)

    def blank(self, cap: int) -> ProtocolState:
        """A ``cap``-lane state of template rows, a buffer each leaf."""
        return fleet_lib.replicate_state(self.template, cap)

    def _rebase(self, cap: int, manager: "FleetManager") -> None:
        """Move the live state to capacity ``cap``: lanes [0, old) carried
        over, the rest template.  After warm-up on the card, into that
        capacity's graph's static state (captured now when it was not
        warmed)."""
        old = self.state
        graph = (manager.lane_graph(self, cap)
                 if manager.graphed and manager.warmed else None)
        new = self.blank(cap)
        if graph is not None:
            _copy_rows(graph.state, new, cap)
            new = graph.state
        if old is not None:
            _copy_rows(new, old, fleet_lib.fleet_size(old))
        self.state = new

    def ensure_capacity(self, need_slots: int,
                        manager: "FleetManager") -> None:
        """Grow to the bucket holding ``need_slots`` occupied slots."""
        cap = bucket_for(need_slots, self.c.buckets)
        if cap <= self.capacity:
            return
        grow = cap - self.capacity
        self.slots += [None] * grow
        self.mask = np.concatenate([self.mask, np.zeros(grow, bool)])
        if self.state is not None:
            self._rebase(cap, manager)
        telemetry_events.instant("fleet.cohort_grow", cohort=self.key,
                                 capacity=cap)

    def admit(self, tenant: int, manager: "FleetManager",
              params: Optional[ProtocolState] = None) -> int:
        """Occupy a slot for ``tenant`` (growing when full) and unmask it.
        ``params``: a single-tenant state (re-onboard from a final
        checkpoint); None = the template init."""
        if tenant in self.slots:
            raise ValueError(f"tenant {tenant} already holds a slot "
                             f"in cohort {self.key}")
        free = [i for i, t in enumerate(self.slots) if t is None]
        if not free:
            self.ensure_capacity(len(self.occupied_ids()) + 1, manager)
            free = [i for i, t in enumerate(self.slots) if t is None]
        slot = free[0]
        self.ensure_state(manager)
        # the vacated slot may hold a previous occupant's lane
        _set_row(self.state, slot, self.template if params is None
                 else params)
        self.slots[slot] = tenant
        self.mask[slot] = True
        return slot

    def vacate(self, tenant: int) -> ProtocolState:
        """Mask off and free ``tenant``'s slot -> its final single-tenant
        state on the host (the offboard checkpoint's payload)."""
        slot = self.slot_of(tenant)
        final = _host_row(self.state, slot)
        self.slots[slot] = None
        self.mask[slot] = False
        return final

    def freeze(self, tenant: int) -> None:
        """Quarantine: mask off but keep the slot (the frozen lane stays
        for forensics, named in the checkpoints' tenant map)."""
        self.mask[self.slot_of(tenant)] = False

    def ensure_state(self, manager: "FleetManager") -> None:
        if self.state is None:
            self._rebase(max(1, self.capacity), manager)

    def tenant_map(self) -> Dict:
        """The slot semantics saved with every cohort checkpoint."""
        return {"slots": self.slots,
                "cohorts": {str(t): self.key for t in self.slots
                            if t is not None}}


class FleetManager:
    """The lifecycle-managed heterogeneous fleet: cohorts, bucketed
    capacity, onboard / offboard / quarantine as boundary operations, and
    per-tenant health.  Drive it with :meth:`step_window`; change
    membership between windows, or from another thread through
    :meth:`request` (applied at the next boundary).

    On the card every (cohort, capacity) step is a CUDA graph
    (:meth:`lane_graph`); ``captures`` counts them and ``captures_after_warmup`` those taken
    after :meth:`warmup`.  ``latent_fn(cohort, tids, its) -> (z1, z2)``
    gives the lanes' latents (default: ``fleet.tenant_latents`` under the
    config's seed); on the CPU a test may replace it."""

    def __init__(self, specs: Sequence[TenantSpec],
                 config: LifecycleConfig, registry=None,
                 health: Optional[resilient.DataHealth] = None):
        self.c = config
        self.device = backend.resolve_device(config.device)
        self.graphed = self.device.type == "cuda"
        os.makedirs(config.res_path, exist_ok=True)
        self.specs: Dict[int, TenantSpec] = {}
        self.health = (health if health is not None
                       else resilient.DataHealth())
        num_segments = config.num_segments
        if num_segments is None:
            num_segments = max((s.tenant_id for s in specs), default=0) + 1
        self.router = fleet_lib.TenantRouter(
            config.res_path, budget=config.quarantine_budget,
            health=self.health, tenants=[s.tenant_id for s in specs],
            num_segments=num_segments, quota_rows=config.quota_rows,
            quota_refill_per_s=config.quota_refill_per_s,
            raise_on_budget=False)
        self.cohorts: Dict[str, Cohort] = {}
        self._checkpointers: Dict[str, fleet_lib.FleetCheckpointer] = {}
        self.captures = 0
        self.captures_at_warmup: Optional[int] = None
        self._z_key = prng.stream_seed(config.seed, "fleet-z")
        self.latent_fn = self._default_latents
        B = config.batch_size
        dev = self.device
        soften = prng.generator(config.seed, "soften")
        self.ones = torch.ones((B, 1), device=dev)
        self.y_real = self.ones + (0.05 * torch.randn(
            (B, 1), generator=soften)).to(dev)
        self.y_fake = (0.05 * torch.randn((B, 1), generator=soften)).to(dev)
        self.warmed = False
        for s in specs:
            self._admit_spec(s)
        for cohort in self.cohorts.values():
            cohort.ensure_state(self)
        self.sentinel = FleetHealthSentinel(config.divergence_factor,
                                            config.divergence_patience)
        self.registry = registry
        self.quarantined: Dict[int, str] = {}
        self.onboarded_total = 0
        self.offboarded_total = 0
        self.throttled_total = 0
        self.step_count = 0
        self._onboard_ms: deque = deque(maxlen=64)
        self._pending = _PendingOps()
        self._steps_per_sec = 0.0
        self._dispatch_ms = 0.0
        self.loss_history: Dict[int, Dict[str, list]] = {}
        # device ms a step by (cohort, capacity), one entry a window
        self.window_device_ms: Dict[Tuple[str, int], List[float]] = {}

    # -- plumbing ------------------------------------------------------------

    def _default_latents(self, cohort: Cohort, tids, its):
        cfg = cohort.model_cfg
        return fleet_lib.tenant_latents(self._z_key, tids, its,
                                        self.c.batch_size, cfg.z_size)

    @property
    def captures_after_warmup(self) -> int:
        if self.captures_at_warmup is None:
            return 0
        return self.captures - self.captures_at_warmup

    def lane_graph(self, cohort: Cohort,
                   cap: int) -> fused_lib.GraphedStep:
        """``cohort``'s masked step at capacity ``cap`` as a CUDA graph,
        captured on first use.  Its inputs are the window's tables
        [cap, B, F] and [cap, B, 1], the targets, the mask [cap] and the
        lanes' tenant ids [cap] (-1 for a ghost), overwritten in place
        before each window; a replay draws every lane's latents from its
        tenant id and ``it`` (``latent_fn``), so the graph takes no
        generator.  Its loss ring holds (d, g, clf) for each lane in
        turn."""
        graph = cohort.lane_graphs.get(cap)
        if graph is None:
            dev, B = self.device, self.c.batch_size
            inputs = (
                torch.zeros((cap, B, cohort.model_cfg.num_features),
                            device=dev),
                torch.zeros((cap, B, 1), device=dev),
                self.y_real, self.y_fake, self.ones,
                torch.zeros(cap, dtype=torch.bool, device=dev),
                torch.full((cap,), -1, dtype=torch.int64, device=dev))

            def body(state, data, labels, y_real, y_fake, ones, mask, tids,
                     z_gen=None, _c=cohort):
                z1, z2 = self.latent_fn(_c, tids, state.it)
                return _c.step(state, data, labels, y_real, y_fake, ones,
                               mask, z1=z1, z2=z2)

            graph = fused_lib.GraphedStep(body, cohort.blank(cap), *inputs,
                                          n_losses=3 * cap)
            cohort.lane_graphs[cap] = graph
            self.captures += 1
            if self.warmed:
                telemetry_events.instant("fleet.capture_after_warmup",
                                         cohort=cohort.key, capacity=cap)
        return graph

    def _admit_spec(self, spec: TenantSpec,
                    params: Optional[ProtocolState] = None) -> Cohort:
        cohort = self.cohorts.get(spec.cohort_key)
        if cohort is None:
            cohort = Cohort(spec.cohort_key, spec.hidden, spec.gen_layers,
                            self.c, self.device)
            self.cohorts[spec.cohort_key] = cohort
        cohort.admit(spec.tenant_id, self, params=params)
        self.specs[spec.tenant_id] = spec
        return cohort

    def checkpointer_for(self, cohort_key: str
                         ) -> fleet_lib.FleetCheckpointer:
        ck = self._checkpointers.get(cohort_key)
        if ck is None:
            ck = fleet_lib.FleetCheckpointer(
                os.path.join(self.c.res_path, "checkpoints", cohort_key),
                keep=self.c.keep_checkpoints)
            self._checkpointers[cohort_key] = ck
        return ck

    def request(self, fn: Callable[[], None]) -> None:
        """Enqueue a lifecycle op from any thread; it runs at the next
        window boundary (membership never changes mid-window)."""
        self._pending.push(fn)

    def drain_pending(self) -> int:
        ops = self._pending.drain()
        for fn in ops:
            fn()
        return len(ops)

    # -- warm-up -------------------------------------------------------------

    def _warm_caps(self, cohort: Cohort) -> List[int]:
        if self.c.warm_buckets is not None:
            return sorted(set(self.c.warm_buckets))
        caps = sorted(self.c.buckets)
        upto = [b for b in caps if b <= cohort.capacity]
        nxt = [b for b in caps if b > cohort.capacity][:1]
        return upto + nxt

    def _warm_cohort(self, cohort: Cohort) -> List[int]:
        """Capture the cohort's graph at every warmed capacity, and move
        its live state into the current capacity's static state."""
        caps = self._warm_caps(cohort)
        if self.graphed:
            for cap in caps:
                self.lane_graph(cohort, cap)
            live = cohort.lane_graphs.get(cohort.capacity)
            if live is not None and cohort.state is not live.state:
                _copy_rows(live.state, cohort.state, cohort.capacity)
                cohort.state = live.state
        return caps

    def warmup(self) -> Dict[str, List[int]]:
        """Capture every (cohort, warmed bucket) graph once (on the CPU
        there is nothing to capture).  After this a membership change
        within the warmed buckets captures nothing: ``captures_after_
        warmup`` stays 0.  A new architecture onboarded after warm-up warms
        its cohort inside :meth:`onboard`, charged to its latency."""
        warmed = {cohort.key: self._warm_cohort(cohort)
                  for cohort in self.cohorts.values()}
        self.warmed = True
        self.captures_at_warmup = self.captures
        telemetry_events.instant(
            "fleet.warmup", cohorts=len(self.cohorts),
            programs=sum(len(v) for v in warmed.values()))
        return warmed

    # -- lifecycle verbs -----------------------------------------------------

    def active_ids(self) -> List[int]:
        out: List[int] = []
        for cohort in self.cohorts.values():
            out.extend(cohort.active_ids())
        return sorted(out)

    def cohort_of(self, tenant: int) -> Cohort:
        for cohort in self.cohorts.values():
            if tenant in cohort.slots:
                return cohort
        raise KeyError(f"tenant {tenant} holds no slot in any cohort")

    def onboard(self, spec: TenantSpec,
                from_checkpoint: Optional[str] = None) -> float:
        """Onboard ``spec`` at this boundary: fill a ghost slot (or hop the
        cohort to its next bucket) with init or checkpointed params and
        start routing its segment -> the latency in milliseconds."""
        t0 = time.perf_counter()
        if spec.tenant_id in self.specs:
            raise ValueError(f"tenant {spec.tenant_id} is already "
                             "onboarded")
        params = None
        if from_checkpoint is not None:
            ck = fleet_lib.FleetCheckpointer(from_checkpoint,
                                             sweep_debris=False)
            _, params, _ = ck.restore(tenants=spec.tenant_id)
        new_cohort = spec.cohort_key not in self.cohorts
        cohort = self._admit_spec(spec, params=params)
        if new_cohort and self.warmed:
            # a new architecture after warm-up: its graphs are captured
            # here, charged to the onboard
            self._warm_cohort(cohort)
            self.captures_at_warmup = self.captures
            telemetry_events.instant("fleet.cohort_warm_on_onboard",
                                     cohort=cohort.key)
        self.router.add_tenant(spec.tenant_id)
        if self.graphed:
            device_lib.stream_fence(torch.cuda.current_stream(self.device))
        ms = (time.perf_counter() - t0) * 1e3
        self._onboard_ms.append(ms)
        self.onboarded_total += 1
        telemetry_events.instant(
            "fleet.onboard", tenant=spec.tenant_id, cohort=cohort.key,
            slot=cohort.slot_of(spec.tenant_id), latency_ms=ms,
            restored=from_checkpoint is not None)
        if self.registry is not None:
            self.registry.inc("gan4j_fleet_tenant_onboarded_total")
        return ms

    def offboard(self, tenant: int) -> Optional[str]:
        """Offboard ``tenant``: vacate its slot (a ghost again), stop
        routing its segment and write its final single-tenant checkpoint
        (re-onboard with ``onboard(spec, from_checkpoint=...)``) -> the
        checkpoint's path."""
        cohort = self.cohort_of(tenant)
        final = cohort.vacate(tenant)
        # a quarantined tenant no longer routes: offboarding it must not
        # raise through the loop
        if tenant in self.router.tenants:
            self.router.remove_tenant(tenant)
        self.specs.pop(tenant, None)
        self.sentinel.forget(tenant)
        self.quarantined.pop(tenant, None)
        ck = fleet_lib.FleetCheckpointer(
            os.path.join(self.c.res_path, "offboarded", f"tenant{tenant}"),
            keep=self.c.keep_checkpoints)
        path = ck.save(self.step_count, fleet_lib.stack_states([final]),
                       tenant_map={"slots": [tenant],
                                   "cohorts": {str(tenant): cohort.key}})
        self.offboarded_total += 1
        telemetry_events.instant("fleet.offboard", tenant=tenant,
                                 cohort=cohort.key, checkpoint=path)
        if self.registry is not None:
            self.registry.inc("gan4j_fleet_tenant_offboarded_total")
        return path

    def quarantine(self, tenant: int, reason: str) -> None:
        """Freeze and mask ONE sick tenant; its cohort-mates keep stepping.
        The slot stays attached to the id."""
        if tenant in self.quarantined or tenant not in self.specs:
            return
        cohort = self.cohort_of(tenant)
        cohort.freeze(tenant)
        if tenant in self.router.tenants:
            self.router.remove_tenant(tenant)
        self.quarantined[tenant] = reason
        with open(os.path.join(self.c.res_path, "quarantine_fleet.jsonl"),
                  "a") as f:
            f.write(json.dumps({"tenant": tenant, "reason": reason,
                                "step": self.step_count}) + "\n")
        telemetry_events.instant("fleet.quarantine", tenant=tenant,
                                 cohort=cohort.key, reason=reason,
                                 step=self.step_count)
        if self.registry is not None:
            self.registry.inc("gan4j_fleet_tenant_quarantined_total")

    def poison_params(self, tenant: int) -> None:
        """Chaos seam (``testing/chaos.py``): ``tenant``'s discriminator
        and generator params NaN in place, the fault the per-tenant
        sentinel must catch without disturbing cohort-mates."""
        cohort = self.cohort_of(tenant)
        slot = cohort.slot_of(tenant)
        with torch.no_grad():
            for tree in (cohort.state.dis_params, cohort.state.gen_params):
                for lp in tree.values():
                    for t in lp.values():
                        t[slot].fill_(float("nan"))
        telemetry_events.instant("chaos.poison_params", tenant=tenant,
                                 cohort=cohort.key)

    def checkpoint_fleet(self) -> Dict[str, str]:
        """One verified save per cohort, each with its tenant map."""
        out = {}
        for key, cohort in self.cohorts.items():
            if cohort.state is None:
                continue
            out[key] = self.checkpointer_for(key).save(
                self.step_count, cohort.state,
                tenant_map=cohort.tenant_map())
        return out

    # -- the window loop -----------------------------------------------------

    def _run_cohort(self, cohort: Cohort, data: np.ndarray, labs: np.ndarray,
                    mask: np.ndarray, steps: int):
        """``steps`` masked steps of ``cohort`` on one window's tables ->
        the per-step losses, unread: (the graph, its ring rows) on the card,
        else a [steps, 3, cap] tensor."""
        dev = self.device
        tids = np.array([-1 if t is None else t for t in cohort.slots],
                        np.int64)
        if self.graphed:
            graph = self.lane_graph(cohort, cohort.capacity)
            if graph.state is not cohort.state:
                raise RuntimeError(f"cohort {cohort.key}: the live state is "
                                   "not the current graph's static state")
            g_data, g_labs, _, _, _, g_mask, g_tids = graph.inputs
            for dst, src in ((g_data, data), (g_labs, labs),
                             (g_mask, mask), (g_tids, tids)):
                dst.copy_(torch.from_numpy(src), non_blocking=False)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            rows = graph.launch(steps)
            t1.record()
            return graph, rows, (t0, t1)
        state = cohort.state
        d_t, l_t, m_t, id_t = (torch.from_numpy(a).to(dev)
                               for a in (data, labs, mask, tids))
        per_step = []
        for _ in range(steps):
            z1, z2 = self.latent_fn(cohort, id_t, state.it)
            state, out = cohort.step(state, d_t, l_t, self.y_real,
                                     self.y_fake, self.ones, m_t, z1=z1,
                                     z2=z2)
            per_step.append(torch.stack(out))
        cohort.state = state
        return None, torch.stack(per_step), None

    def step_window(self, features, labels, steps: int) -> Dict:
        """Drain the boundary ops, route one window's rows, advance every
        cohort ``steps`` masked steps, then run per-tenant health -> the
        window report (losses per ACTIVE tenant; ghost and quarantined
        lanes are masked out)."""
        if self.graphed and not self.warmed:
            self.warmup()
        self.drain_pending()
        c = self.c
        B = c.batch_size
        # a new source tag a window: the same bad row index in two windows
        # burns budget twice
        f_all, l_all, info = self.router.route_tables(
            features, labels, B, source=f"<window@{self.step_count}>")
        # table rows follow the router's tenant list AS ROUTED, taken
        # before a trip's quarantine removes tenants from it
        order = {t: i for i, t in enumerate(self.router.tenants)}
        for t in info.tripped:
            self.quarantine(t, "data-quarantine-budget")
        self.throttled_total += sum(info.throttled.values())
        if self.registry is not None and info.throttled:
            self.registry.inc("gan4j_fleet_tenant_throttled_total",
                              sum(info.throttled.values()))
        starved = set(info.starved) - set(self.quarantined)
        t0 = time.perf_counter()
        runs = {}
        for key, cohort in self.cohorts.items():
            cohort.ensure_state(self)
            cap = cohort.capacity
            data = np.zeros((cap, B, f_all.shape[2]), np.float32)
            labs = np.zeros((cap, B, l_all.shape[2]), np.float32)
            mask = cohort.mask.copy()
            for slot, t in enumerate(cohort.slots):
                if t is None or not cohort.mask[slot]:
                    continue
                if t in starved or t not in order:
                    mask[slot] = False  # frozen for THIS window only
                    continue
                data[slot] = f_all[order[t]]
                labs[slot] = l_all[order[t]]
            runs[key] = self._run_cohort(cohort, data, labs, mask, steps)
        # ONE readback a window, then host-side health over the losses
        losses = {}
        for key, (graph, out, ev) in runs.items():
            if graph is not None:
                ring = device_lib.readback(graph.losses)
                losses[key] = ring[out].reshape(steps, -1, 3).transpose(
                    0, 2, 1)
                ms = ev[0].elapsed_time(ev[1]) / steps
                self.window_device_ms.setdefault(
                    (key, self.cohorts[key].capacity), []).append(ms)
            else:
                losses[key] = device_lib.readback(out)
        dt = time.perf_counter() - t0
        self.step_count += steps
        if dt > 0:
            self._steps_per_sec = steps / dt
            self._dispatch_ms = (dt / steps) * 1e3
        report: Dict[int, Dict[str, np.ndarray]] = {}
        trips: List[Tuple[int, str]] = []
        for key, cohort in self.cohorts.items():
            per_step = losses[key]  # [steps, 3, cap]
            for slot, t in enumerate(cohort.slots):
                if t is None or not cohort.mask[slot] or t in starved:
                    continue
                d, g, cl = (np.array(per_step[:, j, slot]) for j in range(3))
                report[t] = {"d": d, "g": g, "clf": cl}
                if c.record_timelines:
                    hist = self.loss_history.setdefault(
                        t, {"d": [], "g": [], "clf": []})
                    hist["d"].extend(d.tolist())
                    hist["g"].extend(g.tolist())
                    hist["clf"].extend(cl.tolist())
                reason = self.sentinel.observe(t, d, g)
                if reason is not None:
                    trips.append((t, reason))
        for t, reason in trips:
            self.quarantine(t, reason)
        if self.registry is not None:
            self.registry.inc("gan4j_steps_total", steps)
            self.registry.set("gan4j_step", self.step_count)
        if c.checkpoint_every and self.step_count % c.checkpoint_every == 0:
            self.checkpoint_fleet()
        return {"step": self.step_count, "losses": report,
                "starved": sorted(starved),
                "quarantined_now": [t for t, _ in trips], "info": info}

    # -- observability -------------------------------------------------------

    @property
    def onboard_latency_ms(self) -> float:
        if not self._onboard_ms:
            return 0.0
        return float(np.median(self._onboard_ms))

    def report(self) -> Dict:
        """The ``observe_fleet`` feed: the fleet block plus the lifecycle's
        ``tenants_detail``."""
        active = self.active_ids()
        return {
            "tenants": len(active),
            "steps_per_sec": self._steps_per_sec,
            "dispatch_ms": self._dispatch_ms,
            "ok": self.health.report().get("ok", True),
            "tenants_detail": {
                "active": len(active),
                "cohorts": len(self.cohorts),
                "quarantined": sorted(self.quarantined),
                "quarantine_reasons": dict(sorted(self.quarantined.items())),
                "onboarded_total": self.onboarded_total,
                "offboarded_total": self.offboarded_total,
                "throttled_total": self.throttled_total,
                "onboard_latency_ms": self.onboard_latency_ms,
                "captures_after_warmup": self.captures_after_warmup,
            },
        }


class LifecycleFleetTrainer:
    """The heterogeneous lifecycle fleet as ONE payload behind the one
    ``SupervisionShell``: every cohort's steps, the health sentinel and all
    boundary ops inside a single install / teardown bracket (recorder,
    watchdog, exporter), as ``GANTrainer`` and ``FleetTrainer`` run.

    ``feed(window) -> (features, labels)`` supplies each window's raw rows
    (the chaos harness poisons a tenant by poisoning its segment's rows
    there).  ``on_warm(manager)`` fires after :meth:`FleetManager.warmup`;
    ``on_window(manager, window, report)`` after each window."""

    def __init__(self, specs: Sequence[TenantSpec], config: LifecycleConfig,
                 metrics_port: Optional[int] = None,
                 events_enabled: bool = True):
        from gan_deeplearning4j_tpu_torch.telemetry.exporter import (
            MetricsRegistry,
        )

        self.c = config
        self.registry = MetricsRegistry()
        self.health = resilient.DataHealth()
        self.registry.observe_data(self.health.report)
        self.manager = FleetManager(specs, config, registry=self.registry,
                                    health=self.health)
        self.registry.observe_fleet(self.manager.report)
        self._metrics_port = metrics_port
        self._events = events_enabled
        self.metrics_port: Optional[int] = None

    def train(self, feed: Callable[[int], Tuple], windows: int,
              steps_per_window: int, on_warm: Optional[Callable] = None,
              stop: Optional[Callable[[int], bool]] = None,
              on_window: Optional[Callable] = None,
              log: Optional[Callable[[str], None]] = print) -> Dict:
        from gan_deeplearning4j_tpu_torch.train.shell import SupervisionShell

        m = self.manager
        shell = SupervisionShell(self.registry, self.c.res_path,
                                 events_enabled=self._events,
                                 metrics_port=self._metrics_port, log=log)

        def _payload():
            self.metrics_port = shell.metrics_port
            m.warmup()
            if on_warm is not None:
                on_warm(m)
            w = 0
            while w < windows:
                feats, labs = feed(w)
                rep = m.step_window(feats, labs, steps_per_window)
                w += 1
                if shell.watchdog is not None:
                    shell.watchdog.beat(m.step_count)
                if on_window is not None:
                    on_window(m, w, rep)
                if stop is not None and stop(w):
                    break
            m.checkpoint_fleet()
            r = m.report()
            r["windows"] = w
            r["steps"] = m.step_count
            r["timelines"] = {
                t: {k: np.asarray(v, np.float32) for k, v in h.items()}
                for t, h in m.loss_history.items()}
            return r

        return shell.run(_payload)
