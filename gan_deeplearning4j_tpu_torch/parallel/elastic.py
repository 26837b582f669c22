"""Elastic worlds: reshard-on-restore and world-size-elastic recovery
(torch twin of ``gan_deeplearning4j_tpu/parallel/elastic.py``).

A checkpoint written by a world of 2 restores in a world of 1 (or 4), and
a run that lost a device re-forms over the survivors instead of demanding
its old world.  The port has two kinds of "mesh":

* the data-parallel world: ``world`` ranks, one process each
  (``parallel/mesh.py``), params and updater state replicated, the batch
  sharded over the ``data`` axis (:meth:`MeshSpec.from_world`);
* a tenant mesh (``parallel/fleet.py``): a fleet's tenant axis split over
  ``world`` shards in one process, every state role sharded over the
  ``tenant`` axis (:meth:`MeshSpec.from_tenant_mesh`).

The pieces:

* :class:`MeshSpec`: the saving topology, stamped into every checkpoint's
  ``MANIFEST.json`` in the JAX package's dict form, key for key.  A restore
  compares the saved spec with its target and reports the reshard on a
  mismatch (``checkpoint/checkpointer.py`` ``restore(target_mesh=...)``).
  A data-parallel world's state is replicated, so the checkpoint's load,
  which places it whole on the rank's device, is its reshard.
* :func:`reshard`: gather every leaf to the host, then split it over a
  tenant sharding (``parallel/fleet.fleet_sharding``), the leading axis
  over the shards.  Bytes move; values never round.
* :func:`pack_iter_state` / :func:`unpack_iter_state` /
  :func:`merge_iter_states` / :func:`split_iter_state`: the O(1) data
  cursor (``data/csv.py``'s state) across world changes, pure functions
  of their inputs (the JAX module's, held equal to them in
  tests/test_torch_elastic.py).  Checkpoints are stamped at step
  boundaries, where every rank's cursor is equal, so the pack broadcasts
  the local cursor; the restore-side merge checks that and resolves any
  disagreement to the lagging position, so a record may be re-fed but
  never dropped.

The global batch is held across a world change (it is part of the
protocol's math); a re-formed world is the largest divisor of it that the
survivors can carry (``train/gan_trainer.resolve_n_devices``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_log = logging.getLogger(__name__)

# the packed multi-host iterator-state wrapper's version
ITER_STATE_PACK_VERSION = 1

# the sharding roles a MeshSpec records: "replicated", or the axis name
# the role's leading dim shards over
ROLE_PARAMS = "params"
ROLE_OPT_STATE = "opt_state"
ROLE_BATCH = "batch"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The topology a checkpoint was written under: enough for a restore
    to decide "same world, load as is" or "reshard".  ``axes`` keeps the
    axis order; ``sharding`` maps each state role to ``"replicated"`` or
    the axis its leading dim shards over."""

    axes: Dict[str, int]
    device_count: int
    process_count: int = 1
    sharding: Dict[str, str] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_world(cls, world: int = 1, batch_axis: str = "data"
                   ) -> "MeshSpec":
        """A data-parallel world of ``world`` ranks (1: the single-device
        trainer): a 1-D ``data`` axis on one host, params and updater
        state replicated (the JAX ``MeshSpec.from_mesh``)."""
        return cls(axes={batch_axis: int(world)}, device_count=int(world),
                   process_count=1,
                   sharding={ROLE_PARAMS: "replicated",
                             ROLE_OPT_STATE: "replicated",
                             ROLE_BATCH: batch_axis})

    @classmethod
    def from_tenant_mesh(cls, mesh=None) -> "MeshSpec":
        """A tenant mesh (``parallel/fleet.TenantMesh``; None = one
        device): every state role sharded over the ``tenant`` axis."""
        from gan_deeplearning4j_tpu_torch.parallel.fleet import AXIS

        size = 1 if mesh is None else int(mesh.size)
        return cls(axes={AXIS: size}, device_count=size, process_count=1,
                   sharding={ROLE_PARAMS: AXIS, ROLE_OPT_STATE: AXIS,
                             ROLE_BATCH: AXIS})

    def to_dict(self) -> Dict:
        return {"axes": dict(self.axes),
                "device_count": int(self.device_count),
                "process_count": int(self.process_count),
                "sharding": dict(self.sharding)}

    @classmethod
    def from_dict(cls, doc: Dict) -> "MeshSpec":
        return cls(axes={str(k): int(v)
                         for k, v in (doc.get("axes") or {}).items()},
                   device_count=int(doc.get("device_count", 1)),
                   process_count=int(doc.get("process_count", 1)),
                   sharding={str(k): str(v) for k, v in
                             (doc.get("sharding") or {}).items()})

    def describe(self) -> str:
        """The shape for messages: ``{'data': 8} (8 devices, 1 process)``."""
        return (f"{self.axes} ({self.device_count} device"
                f"{'s' if self.device_count != 1 else ''}, "
                f"{self.process_count} process"
                f"{'es' if self.process_count != 1 else ''})")

    def same_topology(self, other: "MeshSpec") -> bool:
        """True when a checkpoint written under ``self`` loads onto
        ``other`` without a reshard (same axes and world)."""
        return (self.axes == other.axes
                and self.device_count == other.device_count
                and self.process_count == other.process_count)


def as_spec(spec) -> MeshSpec:
    """A MeshSpec from a spec or its dict form."""
    return spec if isinstance(spec, MeshSpec) else MeshSpec.from_dict(spec)


def attached_devices(device=None) -> Optional[int]:
    """How many devices this host attaches for a world on ``device``: the
    cards on the card; None on the CPU, where a world of gloo ranks or
    tenant shards has no device limit."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return None


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists, tuples and NamedTuple
    states (a None field stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # a NamedTuple state
        return type(tree)(*(None if v is None else tree_map(fn, v)
                            for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_host(tree):
    """Every leaf gathered to a host array (a tensor's dtype and bits)."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def reshard(tree, placement):
    """Every leaf of ``tree`` gathered to the host, then placed by
    ``placement``, a tenant sharding (``parallel/fleet.fleet_sharding``),
    whose ``place`` splits the leading axis over its shards and returns
    one tree a shard.  A leaf keeps its dtype and its bits."""
    return placement.place(to_host(tree))


# -- the iterator state across world sizes ---------------------------------


def pack_iter_state(state: Dict, process_count: int) -> Dict:
    """The checkpoint form of the O(1) iterator state: the bare
    ``data/csv.py`` state for one process (every pre-elastic checkpoint's
    form), else ``process_count`` copies of the boundary-aligned cursor
    (equal on every rank at a step boundary, so no collective is
    needed)."""
    if process_count <= 1:
        return dict(state)
    return {"__elastic_iter__": ITER_STATE_PACK_VERSION,
            "hosts": int(process_count),
            "states": [dict(state) for _ in range(process_count)]}


def is_packed_iter_state(raw: Dict) -> bool:
    return isinstance(raw, dict) and "__elastic_iter__" in raw


def merge_iter_states(states: Sequence[Dict]) -> Dict:
    """One position from the per-process cursors, never past any of them:
    the lagging one (the least (epoch, cursor)).  A shuffle contract that
    differs between processes is a configuration error and raises."""
    if not states:
        raise ValueError("merge_iter_states: no per-host states")
    first = states[0]
    for st in states[1:]:
        if (bool(st.get("shuffle", False))
                != bool(first.get("shuffle", False))
                or int(st.get("shuffle_seed", 0))
                != int(first.get("shuffle_seed", 0))):
            raise ValueError(
                "iterator state shuffle contract differs across hosts: "
                f"{first!r} vs {st!r} — the fleet was not running one "
                "run")
    merged = min(
        states,
        key=lambda st: (int(st.get("epoch", 0)), int(st.get("cursor", 0))))
    if any((int(st.get("epoch", 0)), int(st.get("cursor", 0)))
           != (int(merged.get("epoch", 0)), int(merged.get("cursor", 0)))
           for st in states):
        _log.warning(
            "per-host iterator cursors disagree (killed between "
            "boundaries); merging to the lagging position %r: some records "
            "will be re-fed, none dropped", merged)
    return dict(merged)


def split_iter_state(state: Dict, process_count: int) -> List[Dict]:
    """The merged position re-split for ``process_count`` processes: a
    broadcast (each consumes the same logical stream in lockstep)."""
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    return [dict(state) for _ in range(process_count)]


def unpack_iter_state(raw: Dict, process_count: int,
                      process_index: int = 0) -> Dict:
    """This process's iterator state from a checkpoint's (maybe packed)
    ``iter_state``, merged across a change of the process count.  A bare
    state passes through."""
    if not is_packed_iter_state(raw):
        return dict(raw)
    states = list(raw.get("states") or [])
    if not states:
        raise ValueError("packed iter_state carries no per-host states")
    saved_hosts = int(raw.get("hosts", len(states)))
    if saved_hosts == process_count and process_index < len(states):
        return dict(states[process_index])
    merged = merge_iter_states(states)
    return split_iter_state(merged, process_count)[
        min(process_index, process_count - 1)]
