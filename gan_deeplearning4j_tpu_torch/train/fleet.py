"""Fleet execution layer: thousands of per-segment GANs advanced as one
step (torch twin of ``gan_deeplearning4j_tpu/train/fleet.py``).

The reference application is per-customer-segment feature engineering: at
production scale that is one small MLP-GAN per insurance segment, a fleet
of independent models.  Run one at a time, each insurance step is a few
hundred tiny launches; here N tenants' states are stacked along a leading
tenant axis and one step advances all of them, one CUDA graph replay on
the card whose launch count does not depend on N.

Semantics (the JAX module's):

  - **Stacking**: every ``ProtocolState`` leaf gains a leading tenant dim;
    ``state.it`` becomes an ``[N]`` vector of per-tenant step counters.
    ``replicate_state`` gives each stacked leaf a buffer of its own (not a
    view into one flat buffer), so the updater kernel's 16-byte test holds
    on every leaf.
  - **Per-tenant semantics preserved**: the fleet step is the protocol
    step of ``train/fused_step.py`` with an explicit tenant axis, not a
    ``vmap`` (``torch.func.vmap`` cannot run ``torch.autograd.grad`` or
    the kernels' ``autograd.Function``s): dense and output layers are
    batched products (``torch.bmm``), every train-mode BN is ONE launch of
    the tenant-batched ``bn_act`` kernel (``ops/cuda/bn_act.py``
    ``fused_bn_act_train_tenants``), each tenant's loss is its own mean
    over its own rows, and the per-tenant losses are summed into one
    scalar for one ``autograd.grad``: no leaf is shared between tenants,
    so each tenant's gradient is exactly its own.  The RmsProp chain is
    elementwise with rates shared by all tenants, so the updater runs
    ``fused_rmsprop_chains`` over the stacked leaves unchanged: three
    launches a step, whatever N.
  - **Random draws**: the JAX fleet folds a key per tenant
    (``tenant_keys``), which torch cannot reproduce.  The port draws the
    whole fleet's latents from ONE generator as stacked [N, B, z] tensors
    (z1, then z2, each step) and checkpoints its state (``z_gen_state``);
    parity tests inject the JAX package's draws.  The lifecycle's masked
    step (``train/lifecycle.py``, one CUDA graph a cohort's capacity)
    draws each lane's latents from (seed, tenant id, the lane's ``it``)
    instead (``tenant_latents``), so a tenant's draws do not depend on its
    slot.
    A fleet on a tenant mesh (``FleetConfig.n_devices``) draws so too,
    keyed on GLOBAL tenant ids, so its trajectory does not depend on the
    mesh's size (``parallel/fleet.py``).
    The insurance model's Dropout has rate 0.0, so the step draws no
    masks (ROADMAP item 8.5).

``parallel/fleet.py`` splits the tenant axis over a mesh of shards (zero
collectives); ``FleetCheckpointer`` records the writing mesh and reshards
a checkpoint onto another.  The supervised payload composes the shared
shell of ``train/shell.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import _NO_TARGET
from gan_deeplearning4j_tpu_torch.data import resilient
from gan_deeplearning4j_tpu_torch.graph.layers import BatchNorm, Dense, Dropout
from gan_deeplearning4j_tpu_torch.ops import activations as act_lib
from gan_deeplearning4j_tpu_torch.ops import losses as loss_lib
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
    fused_bn_act_train_tenants,
)
from gan_deeplearning4j_tpu_torch.optim import ema as ema_lib
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.telemetry import events as telemetry_events
from gan_deeplearning4j_tpu_torch.train import fused_step as fused_lib
from gan_deeplearning4j_tpu_torch.train.fused_step import (
    ProtocolState,
    batch_rows,
)
from gan_deeplearning4j_tpu_torch.utils import device as device_lib

# ProtocolState fields in checkpoint-tree order (``it`` and the optional
# ``ema_gen`` are keyed explicitly; see state_to_tree)
_STATE_FIELDS = fused_lib.TREES


def _map_state(fn, state: ProtocolState) -> ProtocolState:
    """``fn`` applied to every tensor of a state (trees of any depth, the
    counter, the EMA when on)."""
    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else fn(t))

    return ProtocolState(*(None if v is None else tree(v) for v in state))


# ---------------------------------------------------------------------------
# stacking / slicing

def replicate_state(state: ProtocolState, num_tenants: int) -> ProtocolState:
    """Broadcast ONE template init to an N-tenant fleet state: every leaf
    copied N times into a buffer of its own.  All tenants start from the
    same weights; their trajectories decorrelate through their own latent
    draws.  For per-tenant inits stack distinct states with
    :func:`stack_states` instead."""
    return _map_state(lambda x: x.detach()[None].repeat(
        (num_tenants,) + (1,) * x.dim()), state)


def stack_states(states: Sequence[ProtocolState]) -> ProtocolState:
    """Stack N per-tenant states along a new leading tenant axis."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return None if xs[0] is None else torch.stack([x.detach() for x in xs])

    return ProtocolState(*(stack(*vs) for vs in zip(*states)))


def fleet_size(state: ProtocolState) -> int:
    return int(state.it.shape[0])


def slice_tenant(state: ProtocolState, tenant: int) -> ProtocolState:
    """Tenant ``tenant``'s state as a plain single-model ProtocolState
    (views of the stacked leaves; ``it`` 0-d).  ``tenant`` must lie in
    [0, N): a negative index would wrap to another tenant."""
    n = fleet_size(state)
    tenant = int(tenant)
    if not 0 <= tenant < n:
        raise IndexError(f"tenant {tenant} outside a fleet of {n}")
    return _map_state(lambda x: x[tenant], state)


def subset_state(state: ProtocolState,
                 tenants: Sequence[int]) -> ProtocolState:
    """A smaller fleet holding only ``tenants`` (order preserved), in
    fresh buffers."""
    n = fleet_size(state)
    ids = [int(t) for t in tenants]
    bad = [t for t in ids if not 0 <= t < n]
    if bad:
        raise IndexError(f"tenants {bad} outside a fleet of {n}")
    idx = torch.tensor(ids, dtype=torch.long, device=state.it.device)
    return _map_state(lambda x: x.index_select(0, idx), state)


# ---------------------------------------------------------------------------
# checkpoint tree form (the flat '/'-key serialization cannot hold an
# EMPTY dict, and a Dropout layer's params are one: the tree form carries
# an explicit zero-scalar marker per empty dict, which state_from_tree
# strips; the JAX module's format, so fleet checkpoints cross packages)

_EMPTY_MARKER = "__fleet_empty__"


def _mark_empty(tree):
    if isinstance(tree, dict):
        if not tree:
            return {_EMPTY_MARKER: np.zeros((), np.int32)}
        return {k: _mark_empty(v) for k, v in tree.items()}
    return tree


def _unmark_empty(tree, device):
    if isinstance(tree, dict):
        return {k: _unmark_empty(v, device) for k, v in tree.items()
                if k != _EMPTY_MARKER}
    a = np.asarray(tree)
    dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
    return torch.tensor(a.astype(dtype, copy=False), device=device)


def state_to_tree(state: ProtocolState) -> Dict:
    """ProtocolState -> nested dict, the checkpoint-extras form (tensor
    leaves; the counter as int32, the JAX state's dtype)."""
    tree = {f: _mark_empty(getattr(state, f)) for f in _STATE_FIELDS}
    tree["it"] = state.it.to(torch.int32)
    if state.ema_gen is not None:
        tree["ema_gen"] = _mark_empty(state.ema_gen)
    return tree


def state_from_tree(tree: Dict, device="cpu") -> ProtocolState:
    """The inverse, from host arrays or tensors, onto ``device`` (the
    counter back to int64)."""
    ema = tree.get("ema_gen")
    it = torch.as_tensor(np.asarray(tree["it"]).astype(np.int64),
                         device=device)
    return ProtocolState(
        *(_unmark_empty(tree[f], device) for f in _STATE_FIELDS), it,
        None if ema is None else _unmark_empty(ema, device))


# ---------------------------------------------------------------------------
# the tenant-stacked graph: forward, loss and one train step

def _forward(graph, params, inputs: Dict[str, torch.Tensor], train: bool):
    """The graph's forward with every value [N, B, ...] and every param
    [N, ...]: ``ComputationGraph._forward`` for the layer kinds of the
    insurance graphs (Dense / Output, BatchNorm over 2-D rows, Dropout at
    rate 0).  Returns (values, BN running-stat updates)."""
    values = dict(inputs)
    updates: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, node in graph.nodes.items():
        layer = node.layer
        if (not isinstance(layer, (BatchNorm, Dense, Dropout))
                or layer.multi_input or node.preprocessor is not None):
            raise fused_lib.not_ported(
                f"the fleet step over layer {name!r} "
                f"({type(layer).__name__})", "9")
        x = values[node.inputs[0]]
        p = params[name]
        live = train and name not in graph.frozen
        # a tenant's values must not depend on the tenants beside it (the
        # shards of a tenant mesh)
        act = act_lib.tail_stable(layer.activation or "identity")
        if isinstance(layer, BatchNorm):
            if live:
                y, bmean, bvar = fused_bn_act_train_tenants(
                    x, p["gamma"], p["beta"], layer.eps,
                    layer.activation or "identity")
                updates[name] = {
                    "mean": layer.decay * p["mean"] + (1 - layer.decay) * bmean,
                    "var": layer.decay * p["var"] + (1 - layer.decay) * bvar}
            else:
                y = (x - p["mean"][:, None]) * torch.rsqrt(
                    p["var"][:, None] + layer.eps)
                y = act(y * p["gamma"][:, None] + p["beta"][:, None])
        elif isinstance(layer, Dense):  # Output too
            y = act(torch.bmm(x, p["W"]) + p["b"][:, None])
        else:  # Dropout
            if live and layer.rate > 0.0:
                raise fused_lib.not_ported("dropout masks in the fleet step",
                                           "8.5")
            y = x
        values[name] = y
    return values, updates


def _tenant_loss(graph, values, labels) -> torch.Tensor:
    """[N]: each tenant's loss on its own rows (the registry losses are a
    mean over rows of a per-row sum; ``torch.func.vmap`` maps one over the
    tenant axis)."""
    total = 0.0
    for name in graph.output_names:
        fn = loss_lib.get(getattr(graph.nodes[name].layer, "loss", "mse"))
        total = total + torch.func.vmap(fn)(values[name], labels[name])
    return total


def train_step(graph, params, opt_state, inputs, labels):
    """One optimization step of every tenant -> (new_params, new_opt_state,
    loss [N]): ``ComputationGraph._train_step`` with a tenant axis.  The
    per-tenant losses are summed for one ``autograd.grad``; no leaf is
    shared between tenants, so each tenant's gradient is its own loss's."""
    leaves = {layer: {n: t.detach().requires_grad_(True)
                      for n, t in lp.items()}
              for layer, lp in params.items()}
    values, updates = _forward(graph, leaves, inputs, True)
    loss = _tenant_loss(graph, values, labels)
    keys = [(layer, n) for layer, lp in leaves.items() for n in lp]
    flat = torch.autograd.grad(loss.sum(), [leaves[l][n] for l, n in keys],
                               allow_unused=True)
    grads = {layer: {} for layer in leaves}
    for (layer, n), g in zip(keys, flat):
        grads[layer][n] = torch.zeros_like(params[layer][n]) if g is None else g
    new_params, new_opt = graph.updater.apply(params, grads, opt_state)
    for lname, upd in updates.items():
        new_params[lname].update({k: v.detach() for k, v in upd.items()})
    return new_params, new_opt, loss.detach()


def output(graph, params, *xs: torch.Tensor):
    """Inference forward of every tenant (running BN statistics): one
    [N, B, ...] tensor per input -> one per output layer."""
    with torch.no_grad():
        values, _ = _forward(graph, params, dict(zip(graph.input_names, xs)),
                             False)
    return [values[n] for n in graph.output_names]


# ---------------------------------------------------------------------------
# the fleet step

def _where(mask: torch.Tensor, new, old):
    def pick(a, b):
        m = mask.view((-1,) + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)

    def tree(a, b):
        if isinstance(a, dict):
            return {k: tree(a[k], b[k]) for k in a}
        return None if a is None else pick(a, b)

    return ProtocolState(*(tree(a, b) for a, b in zip(new, old)))


def make_fleet_step(dis, gen, gan, classifier, dis_to_gan, gan_to_gen,
                    dis_to_classifier, z_size: int, num_features: int,
                    per_tenant_data: bool = False, steps_per_call: int = 1,
                    ema_decay: float = 0.0, masked: bool = False):
    """Build the fleet step:
    (state, real, labels, y_real, y_fake, ones, mask=None, *, z_gen=None,
    z1=None, z2=None) -> (state', (d_loss, g_loss, clf_loss)), every state
    leaf and every loss carrying a leading tenant dim ([N]; [K, N] with K
    steps a call).

    ``per_tenant_data``: ``real``/``labels`` are [N, rows, ...] per-tenant
    tables (the TenantRouter's output), tenant i slicing its own; off, one
    shared [rows, ...] table that every tenant slices by its own counter.
    Each tenant takes batch ``it % (rows // B)`` of its table, B the rows of
    ``ones``; ``y_real``/``y_fake``/``ones`` are [B, 1] targets shared by
    the tenants.  The latents are U[-1, 1) draws [N, B, z_size] from
    ``z_gen`` (z1, then z2), unless ``z1``/``z2`` are given ([K, N, B,
    z_size] with K > 1): tests inject the JAX package's draws that way.

    ``masked``: the lifecycle form — ``mask`` ([N] bool) is required; a
    lane that is off comes back bit-identical (``it`` included, so its
    data schedule does not advance) while live lanes step as the unmasked
    program.  Losses are reported for every lane.

    ``ema_decay`` > 0 keeps ``state.ema_gen`` (stack a state seeded with
    ``state_from_graphs(..., ema=True)``) as in the single step.  The step
    runs in f32 parity (the precision policy at build time must be the
    default)."""
    if int(steps_per_call) != steps_per_call or steps_per_call < 1:
        raise ValueError(f"steps_per_call must be a positive int, got "
                         f"{steps_per_call}")
    pol = backend.config()
    if pol.compute_bf16 or pol.matmul_bf16:
        raise fused_lib.not_ported("the fleet step under --bf16 / --mp", "9")

    def one(state: ProtocolState, real, labels, y_real, y_fake, ones,
            mask: Optional[torch.Tensor] = None, *,
            z_gen: Optional[torch.Generator] = None,
            z1: Optional[torch.Tensor] = None,
            z2: Optional[torch.Tensor] = None):
        if masked and mask is None:
            raise ValueError("a masked fleet step needs its [N] mask")
        N, B = state.it.shape[0], ones.shape[0]
        n_rows = real.shape[1] if per_tenant_data else real.shape[0]
        if n_rows < B:
            raise ValueError(f"resident table has {n_rows} rows, fewer than "
                             f"one batch of {B}")
        rows = batch_rows(state.it[:, None], n_rows, B)  # [N, B]
        if per_tenant_data:
            lane = torch.arange(N, device=rows.device)[:, None]
            real, labels = real[lane, rows], labels[lane, rows]
        else:
            real, labels = real[rows], labels[rows]
        dev = real.device
        if z1 is None or z2 is None:
            if z_gen is None:
                raise ValueError("pass z_gen, or both z1 and z2")
            z1 = torch.rand((N, B, z_size), generator=z_gen, device=dev) * 2 - 1
            z2 = torch.rand((N, B, z_size), generator=z_gen, device=dev) * 2 - 1
        y_real, y_fake, ones = (t.expand(N, B, t.shape[-1])
                                for t in (y_real, y_fake, ones))
        # (1) D-step on [real; G(z1)], the generator in inference mode
        fake = output(gen, state.gen_params, z1)[0].reshape(N, B, num_features)
        dis_params, dis_opt, d_loss = train_step(
            dis, state.dis_params, state.dis_opt,
            {dis.input_names[0]: torch.cat([real, fake], 1)},
            {dis.output_names[0]: torch.cat([y_real, y_fake], 1)})
        # (2) dis -> gan frozen tail
        gan_params = fused_lib._apply_sync(state.gan_params, dis_params,
                                           dis_to_gan)
        # (3) G-step through the stacked graph
        gan_params, gan_opt, g_loss = train_step(
            gan, gan_params, state.gan_opt, {gan.input_names[0]: z2},
            {gan.output_names[0]: ones})
        # (4) gan generator -> standalone gen
        gen_params = fused_lib._apply_sync(state.gen_params, gan_params,
                                           gan_to_gen)
        # (5) classifier on the labeled real batch
        clf_params = fused_lib._apply_sync(state.clf_params, dis_params,
                                           dis_to_classifier)
        clf_params, clf_opt, c_loss = train_step(
            classifier, clf_params, state.clf_opt,
            {classifier.input_names[0]: real},
            {classifier.output_names[0]: labels})
        # (6) the generator EMA
        ema_gen = state.ema_gen
        if ema_decay:
            ema_gen = ema_lib.ema_update(ema_gen, gen_params, ema_decay)
        new_state = ProtocolState(dis_params, dis_opt, gan_params, gan_opt,
                                  clf_params, clf_opt, gen_params,
                                  state.it + 1, ema_gen)
        if masked:
            new_state = _where(mask, new_state, state)
        return new_state, (d_loss, g_loss, c_loss)

    if steps_per_call == 1:
        return one

    def multi(state: ProtocolState, real, labels, y_real, y_fake, ones,
              mask: Optional[torch.Tensor] = None, *,
              z_gen: Optional[torch.Generator] = None,
              z1: Optional[torch.Tensor] = None,
              z2: Optional[torch.Tensor] = None):
        steps = []
        for k in range(steps_per_call):
            state, out = one(state, real, labels, y_real, y_fake, ones, mask,
                             z_gen=z_gen, z1=None if z1 is None else z1[k],
                             z2=None if z2 is None else z2[k])
            steps.append(out)
        return state, tuple(torch.stack(ls) for ls in zip(*steps))

    return multi


def graphed_fleet_step(step, state: ProtocolState, *inputs: torch.Tensor,
                       z_gen: torch.Generator,
                       ring: int = fused_lib.MAX_STEPS_PER_CALL
                       ) -> fused_lib.GraphedStep:
    """The (unmasked, one step a call) fleet step captured as one CUDA
    graph: a replay advances every tenant.  Its loss ring holds [ring,
    3 * N] rows: (d, g, clf) for each tenant in turn, on a counter started
    at tenant 0's ``it`` (the unmasked step advances every lane
    together)."""
    return fused_lib.GraphedStep(step, state, *inputs, z_gen=z_gen, ring=ring,
                                 n_losses=3 * fleet_size(state))


# ---------------------------------------------------------------------------
# per-tenant latents: a counter-based draw (the lifecycle's: a tenant's
# draws depend only on (seed, tenant id, its own step), the JAX module's
# ``fold_in(base, tenant_id)`` discipline)

_M64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the signed int64 of its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finalizer on int64 bits (products wrap mod 2^64)."""
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def tenant_latents(key: int, tids: torch.Tensor, its: torch.Tensor, B: int,
                   z_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z1, z2), U[-1, 1) draws [N, B, z_size] each, for lanes whose tenant
    ids are ``tids`` [N] at step counters ``its`` [N] (int64): a pure
    function of (``key``, tenant id, step, draw, element), 24 bits a value
    (exact in f32).  Device ops only, so a CUDA graph can record it."""
    n = B * z_size
    elem = torch.arange(2 * n, device=tids.device, dtype=torch.int64)
    h = _fmix(tids.to(torch.int64) * _GOLDEN + _i64(key & _M64))
    h = _fmix(h + its.to(torch.int64) * _GOLDEN)
    h = _fmix(h[:, None] + (elem[None] + 1) * _GOLDEN)
    u = _shr(h, 40).to(torch.float32) * (2.0 ** -24)
    z = (u * 2 - 1).view(-1, 2, B, z_size)
    return z[:, 0], z[:, 1]


# ---------------------------------------------------------------------------
# per-tenant data routing

@dataclasses.dataclass
class RouteInfo:
    """What :meth:`TenantRouter.route_tables` did beyond the tables:
    per-tenant fault-domain outcomes (starved/tripped tenants are frozen
    for the window, never allowed to stall or truncate cohort-mates)."""

    starved: list    # live tenants with < rows_per_tenant clean rows
    tripped: list    # tenants whose quarantine budget blew this call
    throttled: Dict[int, int]  # tenant -> rows dropped by its quota
    unrouted: int    # rows whose segment had no live tenant THIS call
    # (the router's ``unrouted`` attribute keeps the lifetime total)


class TenantRouter:
    """Route a row stream to tenants with PER-TENANT quarantine budgets,
    stable segment identity, and optional token-bucket ingest quotas (the
    JAX router, byte for byte).

    Row ``r`` belongs to segment ``r % num_segments``; ``num_segments`` is
    the FIXED segment universe (default: max live tenant id + 1), so a
    surviving tenant's routed rows are identical before and after any
    onboard/offboard; rows for segments with no live tenant are counted in
    ``unrouted`` and dropped.

    Each tenant owns its own ``data/resilient.RecordQuarantine``
    (``quarantine_tenant{i}.jsonl``, budget ``budget`` EACH): one
    segment's poisoned feed burns only that segment's budget and raises
    only that tenant's ``DataQuarantineError``.  All charges also feed the
    shared ``DataHealth``.  With ``raise_on_budget=False`` a blown budget
    marks the tenant *tripped* in the returned :class:`RouteInfo` instead.

    ``quota_rows``/``quota_refill_per_s`` arm a per-tenant
    ``serve/gateway.TokenBucket`` over ingested ROWS: the excess rows of a
    hot tenant are dropped (counted per tenant in ``RouteInfo.throttled``).

    :meth:`route` validates rows (finite features/labels), quarantines
    offenders, and returns rectangular per-tenant tables truncated to the
    minimum surviving per-tenant row count; :meth:`route_tables` is the
    lifecycle form — fixed ``rows_per_tenant`` tables where a short tenant
    is reported starved rather than truncating everyone else."""

    def __init__(self, res_path: str, num_tenants: Optional[int] = None,
                 budget: int = 100,
                 health: Optional[resilient.DataHealth] = None, *,
                 tenants: Optional[Sequence[int]] = None,
                 num_segments: Optional[int] = None,
                 quota_rows: Optional[float] = None,
                 quota_refill_per_s: Optional[float] = None,
                 raise_on_budget: bool = True):
        if tenants is None:
            if num_tenants is None or num_tenants < 1:
                raise ValueError(
                    f"num_tenants must be >= 1, got {num_tenants}")
            tenants = list(range(num_tenants))
        else:
            tenants = [int(t) for t in tenants]
            if len(set(tenants)) != len(tenants):
                raise ValueError(f"duplicate tenant ids: {tenants}")
        if num_segments is None:
            num_segments = (max(tenants) + 1) if tenants else 1
        self.num_segments = int(num_segments)
        for t in tenants:
            self._check_segment(t)
        self.res_path = res_path
        self.tenants = tenants  # live tenant ids, stacking order
        self.budget = budget
        self.health = health
        self.raise_on_budget = raise_on_budget
        self.quota_rows = quota_rows
        self.quota_refill_per_s = quota_refill_per_s
        self.unrouted = 0
        # lazily created: a 4096-tenant fleet with clean data should not
        # stat 4096 quarantine files up front
        self._quarantines: Dict[int, resilient.RecordQuarantine] = {}
        self._buckets: Dict[int, object] = {}

    @property
    def num_tenants(self) -> int:
        return len(self.tenants)

    def _check_segment(self, tenant: int) -> None:
        if not 0 <= tenant < self.num_segments:
            raise ValueError(
                f"tenant id {tenant} outside the segment universe "
                f"[0, {self.num_segments})")

    def add_tenant(self, tenant: int) -> None:
        """Onboard: ``tenant``'s segment starts routing to it."""
        tenant = int(tenant)
        self._check_segment(tenant)
        if tenant in self.tenants:
            raise ValueError(f"tenant {tenant} is already live")
        self.tenants.append(tenant)

    def remove_tenant(self, tenant: int) -> None:
        """Offboard: the segment's rows become unrouted from now on."""
        self.tenants.remove(int(tenant))

    def quarantine_for(self, tenant: int) -> resilient.RecordQuarantine:
        q = self._quarantines.get(tenant)
        if q is None:
            q = resilient.RecordQuarantine(
                os.path.join(self.res_path,
                             f"quarantine_tenant{tenant}.jsonl"),
                self.budget, health=self.health)
            self._quarantines[tenant] = q
        return q

    def quarantined_total(self) -> int:
        return sum(q.count for q in self._quarantines.values())

    def _bucket_for(self, tenant: int):
        b = self._buckets.get(tenant)
        if b is None:
            from gan_deeplearning4j_tpu_torch.serve.gateway import TokenBucket

            b = TokenBucket(self.quota_rows,
                            self.quota_refill_per_s or self.quota_rows)
            self._buckets[tenant] = b
        return b

    def _gather(self, features, labels, source: str):
        """Validate + segment-route the row stream; returns per-tenant row
        lists plus the call's fault-domain bookkeeping."""
        feats = np.asarray(features, np.float32)
        labs = np.asarray(labels, np.float32)
        if labs.ndim == 1:
            labs = labs[:, None]
        if feats.shape[0] != labs.shape[0]:
            raise ValueError(
                f"features/labels row counts differ: {feats.shape[0]} "
                f"vs {labs.shape[0]}")
        per_feat: Dict[int, list] = {t: [] for t in self.tenants}
        per_lab: Dict[int, list] = {t: [] for t in self.tenants}
        tripped: set = set()
        throttled: Dict[int, int] = {}
        unrouted = 0
        live = set(self.tenants)
        bad = ~(np.isfinite(feats).all(axis=1)
                & np.isfinite(labs).all(axis=1))
        for r in range(feats.shape[0]):
            t = r % self.num_segments
            if t not in live:
                unrouted += 1
                continue
            if bad[r]:
                if t in tripped:
                    continue
                try:
                    # raises this tenant's DataQuarantineError past budget;
                    # lifecycle mode converts that to a trip
                    self.quarantine_for(t).charge(
                        source, row=r, reason="non-finite row",
                        raw=f"tenant={t}")
                except resilient.DataQuarantineError:
                    if self.raise_on_budget:
                        raise
                    tripped.add(t)
                continue
            if self.quota_rows is not None:
                ok, _ = self._bucket_for(t).take()
                if not ok:
                    throttled[t] = throttled.get(t, 0) + 1
                    continue
            per_feat[t].append(feats[r])
            per_lab[t].append(labs[r])
        self.unrouted += unrouted
        return (feats, labs, per_feat, per_lab, tripped, throttled,
                unrouted)

    def route(self, features, labels, source: str = "<memory>"):
        """``(rows, F), (rows, L)`` -> ``(N, m, F), (N, m, L)`` stacked
        per-tenant tables (f32 CPU tensors), bad rows quarantined per
        tenant."""
        _, _, per_feat, per_lab, _, _, _ = self._gather(
            features, labels, source)
        m = min(len(v) for v in per_feat.values())
        if m == 0:
            raise ValueError(
                "tenant routing left at least one tenant with zero "
                f"rows ({np.asarray(features).shape[0]} rows over "
                f"{self.num_tenants} tenants)")
        out_f = np.stack([np.stack(per_feat[t][:m]) for t in self.tenants])
        out_l = np.stack([np.stack(per_lab[t][:m]) for t in self.tenants])
        return torch.from_numpy(out_f), torch.from_numpy(out_l)

    def route_tables(self, features, labels, rows_per_tenant: int,
                     source: str = "<memory>"):
        """The lifecycle form: HOST ``(N, rows_per_tenant, ...)`` f32
        tables in ``self.tenants`` order plus a :class:`RouteInfo`.  A
        tenant short of ``rows_per_tenant`` clean rows is reported
        ``starved`` (its table rows are zeros) and a tenant whose
        quarantine budget blew is ``tripped``; neither truncates or stalls
        cohort-mates."""
        feats, labs, per_feat, per_lab, tripped, throttled, unrouted = \
            self._gather(features, labels, source)
        nt = len(self.tenants)
        out_f = np.zeros((nt, rows_per_tenant, feats.shape[1]), np.float32)
        out_l = np.zeros((nt, rows_per_tenant, labs.shape[1]), np.float32)
        starved = []
        for i, t in enumerate(self.tenants):
            if t in tripped:
                continue
            got = per_feat[t]
            if len(got) < rows_per_tenant:
                starved.append(t)
                continue
            out_f[i] = np.stack(got[:rows_per_tenant])
            out_l[i] = np.stack(per_lab[t][:rows_per_tenant])
        info = RouteInfo(starved=starved, tripped=sorted(tripped),
                         throttled=throttled, unrouted=unrouted)
        return out_f, out_l, info


# ---------------------------------------------------------------------------
# fleet checkpoints: save once, restore any tenant subset

class TenantMappingError(ValueError):
    """A ``restore(tenants=...)`` was asked to resolve tenant IDS against a
    checkpoint whose recorded tenant-id -> slot/cohort mapping disagrees
    (or lacks the id): refused with both mappings named rather than
    returning another tenant's params."""


def fleet_mesh_spec(mesh=None) -> Dict:
    """A tenant mesh's topology in a checkpoint manifest (the JAX
    ``fleet_mesh_spec(mesh).to_dict()``: every state role over the tenant
    axis; ``mesh=None`` = one device)."""
    from gan_deeplearning4j_tpu_torch.parallel.fleet import (
        fleet_mesh_spec as spec,
    )

    return spec(mesh).to_dict()


class FleetCheckpointer:
    """Stacked-fleet checkpoints over ``checkpoint/TrainCheckpointer``.

    The stacked state rides the checkpointer's extras tree channel
    (``state_to_tree``) with an empty graph set, so manifest hashing,
    torn-write fallback and keep-rotation come from the one checkpointer;
    the on-disk form is the JAX module's, and a fleet checkpoint either
    package writes restores in the other bit for bit.  Each leaf is the
    full [N, ...] array (a sharded state is gathered first): **save once,
    restore any tenant subset**.  ``extra`` keys beside the state
    (``z_gen_state``) ride along.  The manifest records the writing tenant
    mesh; ``restore(target_mesh=)`` reshards onto another."""

    EXTRA_KEY = "fleet"
    MAP_KEY = "fleet_tenant_map"

    def __init__(self, directory: str, keep: int = 3,
                 sweep_debris: bool = True):
        from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
            TrainCheckpointer,
        )

        self._inner = TrainCheckpointer(directory, keep=keep,
                                        sweep_debris=sweep_debris)
        self.directory = directory

    def save(self, step: int, state, mesh=None,
             tenant_map: Optional[Dict] = None,
             extra: Optional[Dict] = None) -> str:
        """``state``: a stacked state, or a sharded one (a list of shard
        states, gathered to the host first) written under the tenant mesh
        ``mesh``.  ``tenant_map`` (lifecycle fleets): ``{"slots": [tenant
        id or None per slot], "cohorts": {...}}``, kept in the
        checkpoint's extras; with one on record ``restore(tenants=...)``
        resolves tenant IDS through it."""
        if isinstance(state, (list, tuple)) and not isinstance(
                state, ProtocolState):
            from gan_deeplearning4j_tpu_torch.parallel.fleet import (
                gather_fleet_state,
            )

            state = gather_fleet_state(state)
        out = dict(extra or {})
        out.update({self.EXTRA_KEY: state_to_tree(state),
                    "fleet_tenants": fleet_size(state)})
        if tenant_map is not None:
            out[self.MAP_KEY] = json.dumps(tenant_map, sort_keys=True)
        return self._inner.save(step, {}, extra=out,
                                mesh_spec=fleet_mesh_spec(mesh))

    def restore(self, step: Optional[int] = None, tenants=None,
                expect_map: Optional[Dict] = None, device="cpu",
                max_step: Optional[int] = None, target_mesh=_NO_TARGET):
        """Returns ``(step, state, extra)``, the state on ``device``.

        ``tenants``: ``None`` = the full fleet; an ``int`` = ONE tenant's
        state as a plain single-model ``ProtocolState``; a sequence = a
        subset fleet in the given order.  With a tenant map on record the
        values are tenant IDS resolved through it (an unknown id raises
        :class:`TenantMappingError`); without one, raw slot indices.
        ``expect_map``: the caller's belief about the mapping; a
        disagreeing stored map raises :class:`TenantMappingError`.

        ``target_mesh`` (the elastic path): a ``TenantMesh`` this restore
        lands on, or None for one device.  The full fleet comes back
        resharded onto it, a list of shard states
        (``parallel/fleet.shard_fleet_state``: gathered, split, placed;
        bit-equal per tenant); a checkpoint written under another mesh
        reports ``extra["__reshard__"]`` and marks the timeline.  A
        ``tenants`` subset comes back as one state on ``device`` whatever
        the target.  Without a target the full fleet is one state on
        ``device``."""
        from gan_deeplearning4j_tpu_torch.parallel import fleet as pfleet

        mesh = target_mesh
        spec = _NO_TARGET if mesh is _NO_TARGET else fleet_mesh_spec(mesh)
        step_out, extra = self._inner.restore(
            {}, step=step, max_step=max_step, target_mesh=spec)
        tree = extra.get(self.EXTRA_KEY)
        if tree is None:
            raise ValueError(
                f"checkpoint at step {step_out} in {self.directory} "
                "carries no fleet state (not a fleet checkpoint)")
        stored = extra.get(self.MAP_KEY)
        if isinstance(stored, str):
            stored = json.loads(stored)
            extra[self.MAP_KEY] = stored  # decoded for callers
        if expect_map is not None:
            want = json.loads(json.dumps(expect_map, sort_keys=True))
            if stored != want:
                raise TenantMappingError(
                    f"checkpoint at step {step_out} in {self.directory} "
                    f"records tenant map {stored!r} but the caller "
                    f"expects {want!r}: refusing to restore another "
                    "tenant's params")
        if tenants is None and mesh is not _NO_TARGET and mesh is not None:
            t0 = time.perf_counter()
            shards = pfleet.shard_fleet_state(state_from_tree(tree), mesh)
            info = extra.get("__reshard__")
            if info is not None:
                info["seconds"] += time.perf_counter() - t0
                telemetry_events.instant(
                    "reshard.restore", step=step_out,
                    from_devices=info["from"]["device_count"],
                    to_devices=info["to"]["device_count"],
                    seconds=round(info["seconds"], 4))
            return step_out, shards, extra
        state = state_from_tree(tree, device)
        if tenants is None:
            return step_out, state, extra

        def _slot(t) -> int:
            t = int(t)
            if stored is None:
                return t  # no map: raw slot index
            slots = stored.get("slots", [])
            try:
                return slots.index(t)
            except ValueError:
                raise TenantMappingError(
                    f"tenant id {t} is not in the tenant map recorded "
                    f"by the checkpoint at step {step_out} "
                    f"(slots={slots!r})") from None

        if isinstance(tenants, (int, np.integer)):
            return step_out, slice_tenant(state, _slot(tenants)), extra
        return (step_out, subset_state(state, [_slot(t) for t in tenants]),
                extra)

    # the inner checkpointer's discovery surface: the publisher and the
    # fleet serving bank walk fleet directories with the same verbs as
    # single-model ones
    def steps(self) -> list:
        return self._inner.steps()

    def verify(self, step: int) -> bool:
        return self._inner.verify(step)

    def latest_verified_step(self) -> Optional[int]:
        return self._inner.latest_verified_step()


# ---------------------------------------------------------------------------
# the fleet payload behind the shared supervision shell

@dataclasses.dataclass
class FleetConfig:
    """Knobs for a supervised fleet run (insurance-protocol tenants)."""

    num_tenants: int = 64
    num_iterations: int = 100
    batch_size: int = 16
    seed: int = prng.NUMBER_OF_THE_BEAST
    res_path: str = "outputs/fleet"
    # True: TenantRouter tables, one segment per tenant; False: one shared
    # resident table every tenant slices identically
    per_tenant_data: bool = True
    steps_per_call: int = 1
    print_every: int = 100
    checkpoint_every: int = 0
    keep_checkpoints: int = 3
    quarantine_budget: int = 100  # PER TENANT (TenantRouter)
    n_devices: Optional[int] = None  # tenant-mesh size; None = one device
    metrics_port: Optional[int] = None
    events: bool = True
    resume: bool = False
    watchdog: bool = False
    sanitize: bool = False
    # e.g. "SIGTERM": arm the shell's PreemptionGuard; the loop then drains
    # at the next step boundary — emergency fleet checkpoint,
    # PREEMPTED.json marker, PreemptionError (exit 75 protocol)
    preempt_signals: Optional[str] = None
    device: Optional[str] = None  # None = the card


# fault-injection seam (testing/chaos.py, scenario/trainer_child.py):
# called as _chaos_step_hook(step) at every fleet step boundary
_chaos_step_hook: Optional[Callable[[int], None]] = None


class FleetTrainer:
    """The fleet as a second payload behind the one supervision shell
    (train/shell.py): what differs from ``GANTrainer`` is only the stepped
    payload — one step that advances every tenant, on the card a replay of
    one captured CUDA graph (``graphed_fleet_step``), on the CPU the eager
    step with ``steps_per_call`` steps a call.

    Ops integration: the ``gan4j_fleet_*`` scrape series and the
    ``/healthz`` fleet block (``telemetry/exporter.observe_fleet``),
    per-tenant data routing with per-tenant quarantine budgets
    (TenantRouter), checkpoint cadence through FleetCheckpointer, the
    preemption drain, the watchdog and the events."""

    def __init__(self, config: FleetConfig):
        from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as M
        from gan_deeplearning4j_tpu_torch.telemetry.exporter import (
            MetricsRegistry,
        )

        self.c = config
        self.device = backend.resolve_device(config.device)
        # the tenant mesh (parallel/fleet.py): n_devices shards, formed
        # before any side effect so a fleet that does not divide it fails
        # first
        self.mesh = None
        if config.n_devices is not None:
            from gan_deeplearning4j_tpu_torch.parallel import fleet as pfleet

            self.mesh = pfleet.tenant_mesh(config.n_devices, self.device)
            pfleet.check_divisible(config.num_tenants, self.mesh)
        self._z_key = prng.stream_seed(config.seed, "fleet-z")
        os.makedirs(config.res_path, exist_ok=True)
        cfg = M.InsuranceConfig(seed=config.seed)
        self.model_cfg = cfg
        dis = M.build_discriminator(cfg, device=self.device)
        self.graphs = (dis, M.build_generator(cfg, device=self.device),
                       M.build_gan(cfg, device=self.device),
                       M.build_classifier(dis, cfg))
        self.maps = (M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER)
        self.registry = MetricsRegistry()
        self.health = resilient.DataHealth()
        self.registry.observe_data(self.health.report)
        self.registry.observe_fleet(self._fleet_report)
        self.router = TenantRouter(config.res_path, config.num_tenants,
                                   budget=config.quarantine_budget,
                                   health=self.health)
        self.checkpointer = (
            FleetCheckpointer(os.path.join(config.res_path, "checkpoints"),
                              keep=config.keep_checkpoints)
            if config.checkpoint_every else None)
        self.batch_counter = 0
        self.state: Optional[ProtocolState] = None
        self.last_losses = None
        self.graphed = None  # a GraphedStep, or GraphedShards on a mesh
        self.metrics_port: Optional[int] = None
        self._steps_per_sec = 0.0
        self._dispatch_ms = 0.0

    def _fleet_report(self) -> Dict:
        return {"tenants": self.c.num_tenants,
                "steps_per_sec": self._steps_per_sec,
                "dispatch_ms": self._dispatch_ms,
                "ok": self.health.report().get("ok", True)}

    @property
    def devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def train(self, features, labels,
              log: Optional[Callable[[str], None]] = print) -> Dict:
        """Train the fleet on ``(rows, F)`` features / ``(rows,)`` or
        ``(rows, 1)`` labels, supervised by the shared shell."""
        from gan_deeplearning4j_tpu_torch.train.shell import SupervisionShell

        c = self.c
        preempt_nums = ()
        if c.preempt_signals:
            from gan_deeplearning4j_tpu_torch.train.preemption import (
                parse_signals,
            )

            preempt_nums = parse_signals(c.preempt_signals)
        shell = SupervisionShell(
            self.registry, c.res_path,
            events_enabled=c.events, events_append=c.resume,
            watchdog=c.watchdog, sanitize=c.sanitize,
            metrics_port=c.metrics_port,
            preempt_signal_nums=preempt_nums, log=log)

        def _payload():
            self.metrics_port = shell.metrics_port
            return self._train_impl(features, labels, shell, log)

        return shell.run(_payload)

    # -- payload ------------------------------------------------------------

    def _save(self, state, z_gen) -> str:
        """A checkpoint of ``state`` (on a tenant mesh: the shards,
        gathered, under the live mesh; their latents need no state)."""
        if self.mesh is not None:
            return self.checkpointer.save(self.batch_counter, state,
                                          mesh=self.mesh)
        return self.checkpointer.save(
            self.batch_counter, state,
            extra={"z_gen_state": z_gen.get_state()})

    def _preempt_drain(self, state, z_gen, shell) -> None:
        """The latched preemption signal observed at a step boundary:
        fence, commit an emergency fleet checkpoint, and exit through the
        shared protocol (``preempt_exit``: PREEMPTED.json + PreemptionError,
        which the scenario child maps to exit 75)."""
        from gan_deeplearning4j_tpu_torch.train.preemption import preempt_exit

        device_lib.device_fence(state)
        path = None
        if self.checkpointer is not None:
            path = self._save(state, z_gen)
        preempt_exit(self.c.res_path, shell.guard,
                     local_step=self.batch_counter,
                     fleet_min_step=self.batch_counter, checkpoint=path)

    def _train_impl(self, features, labels, shell, log) -> Dict:
        c = self.c
        dev = self.device
        mesh = self.mesh
        if c.per_tenant_data:
            feats, labs = self.router.route(features, labels)
        else:
            feats = torch.from_numpy(np.asarray(features, np.float32))
            labs = np.asarray(labels, np.float32)
            labs = torch.from_numpy(labs[:, None] if labs.ndim == 1 else labs)
        if mesh is None:
            feats, labs = feats.to(dev), labs.to(dev)
        rows = int(feats.shape[1] if c.per_tenant_data else feats.shape[0])
        if rows // c.batch_size == 0:
            raise ValueError(
                f"{rows} rows per tenant cannot fill one batch of "
                f"{c.batch_size}")
        k = max(1, int(c.steps_per_call))
        graphed = dev.type == "cuda"
        step_kw = dict(z_size=self.model_cfg.z_size,
                       num_features=self.model_cfg.num_features,
                       per_tenant_data=c.per_tenant_data)
        if mesh is None or graphed:
            step = make_fleet_step(*self.graphs, *self.maps,
                                   steps_per_call=1 if graphed else k,
                                   **step_kw)
        else:
            from gan_deeplearning4j_tpu_torch.parallel import fleet as pfleet

            step = pfleet.make_sharded_fleet_step(
                *self.graphs, *self.maps, mesh=mesh, steps_per_call=k,
                **step_kw)
        B = c.batch_size
        # the reference's label softening, drawn once (as GANTrainer does)
        soften = prng.generator(c.seed, "soften")
        ones = torch.ones((B, 1), device=dev)
        y_real = ones + (0.05 * torch.randn((B, 1), generator=soften)).to(dev)
        y_fake = (0.05 * torch.randn((B, 1), generator=soften)).to(dev)
        z_gen = prng.generator(c.seed, "fleet-z", dev)

        start_step = 0
        state = None
        if self.checkpointer is not None and c.resume:
            from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
                NoVerifiedCheckpointError,
            )

            try:
                if mesh is not None:
                    # onto the live mesh: a checkpoint another world wrote
                    # reshards (the latents are keyed on global ids, so
                    # the trajectory goes on as if it had not)
                    start_step, state, _ = self.checkpointer.restore(
                        target_mesh=mesh)
                else:
                    start_step, state, extra = self.checkpointer.restore(
                        device=dev)
                    if "z_gen_state" in extra:
                        z_gen.set_state(torch.from_numpy(
                            np.asarray(extra["z_gen_state"], np.uint8)))
                    else:
                        # a JAX-written or tenant-mesh checkpoint: put the
                        # latents where an uninterrupted port run would be
                        for _ in range(2 * start_step):
                            torch.rand((c.num_tenants, B,
                                        self.model_cfg.z_size),
                                       generator=z_gen, device=dev)
                if log is not None:
                    log(f"[fleet] resumed {c.num_tenants} tenants at "
                        f"step {start_step} on {self.devices} device(s)")
            except (NoVerifiedCheckpointError, FileNotFoundError):
                state = None
        if state is None:
            state = replicate_state(
                fused_lib.state_from_graphs(*self.graphs), c.num_tenants)
            if mesh is not None:
                from gan_deeplearning4j_tpu_torch.parallel import (
                    fleet as pfleet,
                )

                state = pfleet.shard_fleet_state(state, mesh)
        self.batch_counter = start_step
        inputs = (feats, labs, y_real, y_fake, ones)
        if graphed and mesh is not None:
            from gan_deeplearning4j_tpu_torch.parallel import fleet as pfleet

            self.graphed = pfleet.GraphedShards(
                step, state, pfleet.split_inputs(mesh, *inputs,
                                                 c.per_tenant_data),
                pfleet.shard_tenant_ids(mesh, c.num_tenants), self._z_key,
                self.model_cfg.z_size)
            state = self.graphed.states
        elif graphed:
            self.graphed = graphed_fleet_step(step, state, *inputs,
                                              z_gen=z_gen)
            state = self.graphed.state
        telemetry_events.instant(
            "fleet.start", tenants=c.num_tenants, steps_per_call=k,
            devices=self.devices, graphed=graphed)
        last = None  # the newest call's losses: ring rows or [k, N] tensors
        window_t0 = time.perf_counter()
        window_steps = 0
        t_start = window_t0
        while self.batch_counter < c.num_iterations:
            if graphed:
                last = self.graphed.launch(k)
            elif mesh is not None:
                state, last = step(state, *inputs, key=self._z_key)
            else:
                state, last = step(state, *inputs, z_gen=z_gen)
            self.batch_counter += k
            window_steps += k
            if shell.watchdog is not None:
                shell.watchdog.beat(self.batch_counter)
            if shell.guard is not None and shell.guard.triggered:
                self._preempt_drain(state, z_gen, shell)
            if _chaos_step_hook is not None:
                _chaos_step_hook(self.batch_counter)
            at_print = (c.print_every
                        and self.batch_counter % c.print_every < k)
            at_ckpt = (self.checkpointer is not None
                       and self.batch_counter % c.checkpoint_every < k)
            if at_print or at_ckpt:
                # print/checkpoint cadence, not per iteration: the one
                # deliberate readback of the window
                losses = self._read_losses(last, k)
                dt = time.perf_counter() - window_t0
                if dt > 0 and window_steps:
                    self._steps_per_sec = window_steps / dt
                    self._dispatch_ms = (dt / window_steps) * k * 1e3
                self.registry.inc("gan4j_steps_total", window_steps)
                self.registry.set("gan4j_step", self.batch_counter)
                if at_print and log is not None:
                    log(f"[fleet] step {self.batch_counter}: "
                        f"{c.num_tenants} tenants, "
                        f"{self._steps_per_sec:.1f} steps/s "
                        f"(d_loss mean {float(losses[0].mean()):.4f})")
                if at_ckpt:
                    self._save(state, z_gen)
                window_t0 = time.perf_counter()
                window_steps = 0
        device_lib.device_fence(state)
        wall = time.perf_counter() - t_start
        steps_done = self.batch_counter - start_step
        if wall > 0 and steps_done:
            self._steps_per_sec = steps_done / wall
            self._dispatch_ms = (wall / steps_done) * k * 1e3
        self.state = state
        self.last_losses = None if last is None else self._read_losses(last, k)
        if self.checkpointer is not None:
            self._save(state, z_gen)
        telemetry_events.instant(
            "fleet.done", tenants=c.num_tenants, steps=self.batch_counter)
        return {"tenants": c.num_tenants, "steps": self.batch_counter,
                "steps_per_sec": self._steps_per_sec,
                "dispatch_ms": self._dispatch_ms,
                "tenants_steps_per_sec": (c.num_tenants
                                          * self._steps_per_sec),
                "graphed": graphed, "devices": self.devices,
                "quarantined": self.router.quarantined_total()}

    def _read_losses(self, last, k: int):
        """The newest step's (d, g, clf) losses, [N] numpy each: from the
        graphed step's loss ring (the rows of the newest launch) or the
        eager call's tensors ([N], or [k, N] with k steps a call)."""
        if self.mesh is not None and self.graphed is not None:
            return self.graphed.read_losses(last)
        if self.graphed is not None:
            ring = device_lib.readback(self.graphed.losses)
            row = np.asarray(ring)[last[-1]].reshape(-1, 3)
            return tuple(row[:, i] for i in range(3))
        return tuple(np.asarray(device_lib.readback(
            t if t.dim() == 1 else t[-1])) for t in last)
