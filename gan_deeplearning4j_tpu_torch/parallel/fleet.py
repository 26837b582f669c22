"""The fleet's tenant mesh: a fleet's tenant axis split over shards (torch
twin of ``gan_deeplearning4j_tpu/parallel/fleet.py``).

``train/fleet.py`` advances N stacked tenants with one step; here the
tenant axis is split over a mesh of ``world`` shards, each holding
``N / world`` tenants and running the same per-tenant step on its slice,
with **zero collectives**: tenants are independent, so nothing crosses
between shards.

The design is one process, as in the JAX package:

* a :class:`TenantMesh` of ``world`` shards is a tuple of
  ``torch.device``s, shard *i* on ``cuda:(i mod cards)``.  On a host with
  fewer cards than shards, shards share a card (the counterpart of the
  JAX scenario's ``--xla_force_host_platform_device_count``, with which
  it runs a world of 2 on one host); on the CPU every shard is on the
  CPU;
* a sharded state is a list of per-shard ``ProtocolState``s, shard *i*
  holding tenants ``[i * N / world, (i + 1) * N / world)`` on its device
  (:func:`shard_fleet_state`, through ``parallel/elastic.reshard``:
  gather to the host, split, place; bit-equal whatever world wrote it);
* each shard holds its own data table (``per_tenant_data`` splits the
  tables; otherwise each shard's device holds the shared table), and on
  the card its own ``GraphedStep`` (:class:`GraphedShards`); a call
  replays every shard's graph.

**Latents.**  A generator's state cannot be split between shards (nor two
merged on a 2 -> 1 reshard), so a fleet on a tenant mesh draws each
tenant's latents with ``train/fleet.tenant_latents``: a counter hash of
(key, GLOBAL tenant id, the tenant's step), device ops only, so a CUDA
graph records it.  A tenant's draws, and so the whole trajectory, do not
depend on the world: the sharded step at any world is bitwise the step at
world 1 (``tenant_mesh(1)``, the JAX ``tenant_mesh(1)``), and a fleet
resharded mid-run goes on as if it had not been.  A fleet with no tenant
mesh (``FleetConfig.n_devices=None``) keeps its one generator
(``z_gen``) and its bitwise resume through ``z_gen_state``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.parallel import elastic
from gan_deeplearning4j_tpu_torch.train import fleet as fleet_lib
from gan_deeplearning4j_tpu_torch.train import fused_step as fused_lib
from gan_deeplearning4j_tpu_torch.train.fused_step import ProtocolState
from gan_deeplearning4j_tpu_torch.utils import device as device_lib

# the one axis fleet states shard over
AXIS = "tenant"


@dataclasses.dataclass(frozen=True)
class TenantMesh:
    """``world`` shards, each a device (several may be one card)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS: self.size}


def tenant_mesh(n_devices: Optional[int] = None, device=None) -> TenantMesh:
    """A tenant mesh of ``n_devices`` shards on ``device`` (None = the
    card): shard *i* on ``cuda:(i mod cards)``; on the CPU every shard on
    the CPU.  ``n_devices=None``: one shard a card (one on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    cards = elastic.attached_devices(dev)
    if n_devices is None:
        n_devices = cards or 1
    if n_devices < 1:
        raise ValueError(f"a tenant mesh needs >= 1 shard, got {n_devices}")
    if dev.type == "cuda":
        if not cards:
            raise RuntimeError("a tenant mesh on the card needs a CUDA device")
        devs = tuple(torch.device("cuda", i % cards) for i in range(n_devices))
    else:
        devs = (dev,) * n_devices
    return TenantMesh(devs)


def check_divisible(num_tenants: int, mesh: TenantMesh) -> None:
    if num_tenants % mesh.size:
        raise ValueError(
            f"fleet of {num_tenants} tenants does not divide the "
            f"{mesh.size}-device tenant mesh — pad the fleet or shrink the "
            "mesh (every device carries num_tenants/world tenants)")


class FleetSharding:
    """The leading-dim tenant placement over a mesh (every state leaf,
    ``it`` included): ``place`` splits host arrays into one tree a shard,
    on the shard's device."""

    def __init__(self, mesh: TenantMesh):
        self.mesh = mesh

    def place(self, host_tree) -> List:
        leaves = []
        elastic.tree_map(leaves.append, host_tree)
        sizes = {a.shape[0] if a.ndim else None for a in leaves}
        if len(sizes) != 1 or None in sizes:
            raise ValueError(f"tenant-sharded leaves need one leading "
                             f"tenant axis, got sizes {sizes}")
        n = sizes.pop()
        check_divisible(n, self.mesh)
        per = n // self.mesh.size
        return [elastic.tree_map(
            lambda a, i=i, d=d: torch.from_numpy(
                a[i * per:(i + 1) * per].copy()).to(d),
            host_tree) for i, d in enumerate(self.mesh.devices)]


def fleet_sharding(mesh: TenantMesh) -> FleetSharding:
    return FleetSharding(mesh)


def fleet_mesh_spec(mesh: Optional[TenantMesh] = None) -> elastic.MeshSpec:
    """The fleet's MeshSpec for checkpoint manifests: unlike the
    data-parallel protocol, every state role shards over the tenant axis
    (``mesh=None``: one device)."""
    return elastic.MeshSpec.from_tenant_mesh(mesh)


def shard_fleet_state(state: ProtocolState,
                      mesh: TenantMesh) -> List[ProtocolState]:
    """A stacked fleet state split over the mesh through the elastic
    reshard (gather to the host, split, place): bit-equal, for a fresh
    stack, a live state, or one restored from another world."""
    check_divisible(fleet_lib.fleet_size(state), mesh)
    return elastic.reshard(state, fleet_sharding(mesh))


def gather_fleet_state(shards: Sequence[ProtocolState],
                       device="cpu") -> ProtocolState:
    """The stacked state of all shards, in global tenant order, on
    ``device`` (the save path's gather)."""
    dev = torch.device(device)

    def cat(*xs):
        if isinstance(xs[0], dict):
            return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
        if xs[0] is None:
            return None
        return torch.cat([x.detach().to(dev) for x in xs])

    return ProtocolState(*(cat(*vs) for vs in zip(*shards)))


def shard_tenant_ids(mesh: TenantMesh, num_tenants: int) -> List[torch.Tensor]:
    """Each shard's GLOBAL tenant ids [N / world], int64 on its device."""
    check_divisible(num_tenants, mesh)
    per = num_tenants // mesh.size
    return [torch.arange(i * per, (i + 1) * per, dtype=torch.int64, device=d)
            for i, d in enumerate(mesh.devices)]


def split_inputs(mesh: TenantMesh, real, labels, y_real, y_fake, ones,
                 per_tenant_data: bool, mask=None) -> List[tuple]:
    """One input tuple a shard, on its device: ``per_tenant_data`` tables
    (and a lifecycle ``mask``) split over the tenant axis; a shared table
    and the targets on every shard's device."""
    n = mesh.size
    out = []
    for i, d in enumerate(mesh.devices):
        def part(t):
            per = t.shape[0] // n
            return t[i * per:(i + 1) * per].to(d)

        r, lab = ((part(real), part(labels)) if per_tenant_data
                  else (real.to(d), labels.to(d)))
        row = (r, lab, y_real.to(d), y_fake.to(d), ones.to(d))
        if mask is not None:
            row += (part(mask),)
        out.append(row)
    return out


def make_sharded_fleet_step(dis, gen, gan, classifier, dis_to_gan, gan_to_gen,
                            dis_to_classifier, z_size: int, num_features: int,
                            mesh: TenantMesh, per_tenant_data: bool = False,
                            steps_per_call: int = 1, ema_decay: float = 0.0,
                            masked: bool = False):
    """The fleet step over a tenant mesh: the same per-tenant math as
    ``train/fleet.make_fleet_step`` (each shard runs that step on its
    slice), with zero collectives.

    (shards, real, labels, y_real, y_fake, ones, mask=None, *, key=None,
    z1=None, z2=None) -> (shards', (d_loss, g_loss, clf_loss)): ``shards``
    as :func:`shard_fleet_state` gives them; ``real``/``labels`` the global
    tables ([N, rows, ...] with ``per_tenant_data``, else one shared [rows,
    ...]), split or copied to each shard (a no-op where they already lie);
    the losses [N] ([K, N] with K steps a call) in global tenant order, on
    the first shard's device.  Latents: ``tenant_latents(key, global ids,
    it)``, or the global draws ``z1``/``z2`` ([N, B, z]; [K, N, B, z] with
    K > 1) split by tenant: tests inject the JAX package's draws so.

    ``masked``: the lifecycle form, ``mask`` [N] split like the tables; a
    lane that is off comes back bit-identical on its own shard."""
    one = fleet_lib.make_fleet_step(
        dis, gen, gan, classifier, dis_to_gan, gan_to_gen, dis_to_classifier,
        z_size=z_size, num_features=num_features,
        per_tenant_data=per_tenant_data, steps_per_call=1,
        ema_decay=ema_decay, masked=masked)
    K = int(steps_per_call)
    if K != steps_per_call or K < 1:
        raise ValueError(f"steps_per_call must be a positive int, got "
                         f"{steps_per_call}")
    n = mesh.size

    def step(shards: Sequence[ProtocolState], real, labels, y_real, y_fake,
             ones, mask: Optional[torch.Tensor] = None, *,
             key: Optional[int] = None, z1: Optional[torch.Tensor] = None,
             z2: Optional[torch.Tensor] = None):
        if len(shards) != n:
            raise ValueError(f"{len(shards)} shards on a {n}-shard mesh")
        if masked and mask is None:
            raise ValueError("a masked fleet step needs its [N] mask")
        if (z1 is None) != (z2 is None) or (z1 is None and key is None):
            raise ValueError("pass key, or both z1 and z2")
        N = sum(fleet_lib.fleet_size(s) for s in shards)
        B = ones.shape[0]
        inputs = split_inputs(mesh, real, labels, y_real, y_fake, ones,
                              per_tenant_data, mask)
        tids = shard_tenant_ids(mesh, N)
        per = N // n
        shards = list(shards)
        steps = []
        for k in range(K):
            outs = []
            for i, d in enumerate(mesh.devices):
                if z1 is None:
                    za, zb = fleet_lib.tenant_latents(
                        key, tids[i], shards[i].it, B, z_size)
                else:
                    za, zb = ((z if K == 1 else z[k])[i * per:(i + 1) * per]
                              .to(d) for z in (z1, z2))
                shards[i], out = one(shards[i], *inputs[i], z1=za, z2=zb)
                outs.append(out)
            dev0 = mesh.devices[0]
            steps.append(tuple(torch.cat([o[j].to(dev0) for o in outs])
                               for j in range(3)))
        if K == 1:
            return shards, steps[0]
        return shards, tuple(torch.stack(ls) for ls in zip(*steps))

    return step


class GraphedShards:
    """The unmasked fleet step on a tenant mesh as one CUDA graph a shard
    (``fused_step.GraphedStep``): a call replays every shard's graph, on
    the current stream of its card.  Each shard's graph draws its tenants'
    latents from ``tenant_latents(key, global ids, it)``, so it takes no
    generator; its loss ring holds (d, g, clf) for each of its tenants,
    and :meth:`read_losses` gathers the rings into global tenant order."""

    def __init__(self, step, shards: Sequence[ProtocolState], inputs,
                 tids: Sequence[torch.Tensor], key: int, z_size: int,
                 ring: int = fused_lib.MAX_STEPS_PER_CALL):
        def body(state, real, labels, y_real, y_fake, ones, ids, z_gen=None):
            z1, z2 = fleet_lib.tenant_latents(key, ids, state.it,
                                              ones.shape[0], z_size)
            return step(state, real, labels, y_real, y_fake, ones, z1=z1,
                        z2=z2)

        self.graphs = [
            fused_lib.GraphedStep(body, s, *inp, ids, ring=ring,
                                  n_losses=3 * fleet_lib.fleet_size(s))
            for s, inp, ids in zip(shards, inputs, tids)]

    @property
    def states(self) -> List[ProtocolState]:
        return [g.state for g in self.graphs]

    def launch(self, n: int) -> List[int]:
        rows = None
        for g in self.graphs:
            rows = g.launch(n)
        return rows

    def read_losses(self, rows: Sequence[int]):
        """The (d, g, clf) losses of ring row ``rows[-1]``, [N] numpy each,
        in global tenant order."""
        parts = [np.asarray(device_lib.readback(g.losses))[rows[-1]]
                 .reshape(-1, 3) for g in self.graphs]
        row = np.concatenate(parts)
        return tuple(row[:, i] for i in range(3))
