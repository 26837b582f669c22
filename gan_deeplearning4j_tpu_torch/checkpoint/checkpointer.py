"""Multi-graph training-state checkpointer (torch twin of
``gan_deeplearning4j_tpu/checkpoint/checkpointer.py``, writing its on-disk
format: tests/test_torch_checkpoint.py restores each package's checkpoints
in the other and pins the bytes).

Layout: ``{dir}/ckpt_{step}/`` holds one ``{graph}_model.zip`` per graph
(``graph/serialization.py``, with the updater state), ``state.json`` (the
step, the graph names and the scalar extras), ``state.npz`` (the array
extras; a dict extra is flattened under its key) and ``MANIFEST.json``
(size and SHA-256 of every file, and the saving topology).

Crash-safety contract, as in the JAX package:

* ``save()`` is split into a **snapshot** half (``snapshot_state``: the
  copies of every device tensor to pinned host memory, started on the
  training thread behind one CUDA event, as the artifact dumps do) and a
  **serialize** half (``write_snapshot``: waits for the event, then bytes,
  fsync, atomic rename; safe on a background worker, see
  ``AsyncCheckpointer``).  The copies are enqueued on the compute stream,
  so a CUDA graph's next replay cannot overwrite what they read.
* Every file is fsynced, then ``MANIFEST.json`` is written and fsynced
  last, then the temp dir is renamed into place and the parent directory
  fsynced: a kill at any byte leaves either no ``ckpt_{step}`` entry or
  one whose manifest verifies.
* Re-saving an existing step swaps by rename, rename, rmtree: the step's
  data is never unlinked before its replacement is in place.
* ``restore()`` verifies the manifest and, when no step was asked for,
  falls back to the newest checkpoint that verifies and loads.
* ``__init__`` purges ``.ckpt_tmp_*`` / ``.ckpt_del_*`` debris and adopts
  an orphan whose manifest verifies when its step has no entry.

``_chaos_hook`` is the fault-injection seam: a callable that raises at a
named write/rename point (tests/test_torch_checkpoint.py walks each one).

Elastic restore (``parallel/elastic.py``, the JAX ``_load_elastic``): a
restore given the topology it lands on (``target_mesh``) whose saved
``mesh_spec`` differs reports ``extra["__reshard__"]`` and marks the
timeline.  The state a data-parallel world saves is replicated, so the
load, which places each graph's params and updater state whole on its
device, is the reshard: no bytes move after it.  A fleet splits its state
over the new world itself (``FleetCheckpointer``).  With no target the
plain load, whatever world wrote the checkpoint: the port forms a world of
any size on any host (ranks above the card count share a card over gloo,
``parallel/mesh.choose_backend``; tenant shards share a card,
``parallel/fleet.tenant_mesh``), so no saved topology is beyond this host.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.graph import serialization
from gan_deeplearning4j_tpu_torch.parallel import elastic
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.utils.async_dump import host_copy
from gan_deeplearning4j_tpu_torch.utils.device import wait_event

MANIFEST_NAME = "MANIFEST.json"

# fault-injection seam: called as _chaos_hook(event) at each named point of
# write_snapshot; a raised exception with ``simulates_kill = True`` is
# treated as a hard kill (no temp cleanup: what SIGKILL leaves behind)
_chaos_hook: Optional[Callable[[str], None]] = None

_log = logging.getLogger(__name__)

# ``restore``'s "no target topology" (None is a target: one device)
_NO_TARGET = object()


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested checkpoint failed manifest verification."""


class CheckpointMeshMismatchError(ValueError):
    """The checkpoint was written under a topology that the resuming
    program cannot take up (``roadmap_main``'s pair: its data and latent
    streams are per world).  A ValueError on purpose: the recovery wrapper
    classifies it fatal (a restart replays the same mismatch)."""


class NoVerifiedCheckpointError(FileNotFoundError):
    """No checkpoint in the directory verifies and loads."""


def _chaos(event: str) -> None:
    if _chaos_hook is not None:
        _chaos_hook(event)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds: rename is still atomic
    try:
        os.fsync(fd)
    except OSError:  # some filesystems refuse a directory fsync
        pass
    finally:
        os.close(fd)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def mesh_spec_dict(world: int = 1) -> Dict:
    """The saving topology in the JAX package's ``MeshSpec.to_dict`` form:
    a 1-D ``data`` mesh of ``world`` devices on one host (the port's
    ``world`` ranks; 1 = the single-device trainer)."""
    return elastic.MeshSpec.from_world(world).to_dict()


def _tree_tensors(tree: Dict, out: list) -> Dict:
    """``tree`` with each tensor leaf appended to ``out`` and replaced by
    its index there, and every other leaf by a host array."""
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res[k] = _tree_tensors(v, out)
        elif isinstance(v, torch.Tensor):
            out.append(v)
            res[k] = len(out) - 1
        else:
            res[k] = np.asarray(v)
    return res


def _tree_fill(tree: Dict, hosts: list) -> Dict:
    return {k: (_tree_fill(v, hosts) if isinstance(v, dict)
                else hosts[v] if isinstance(v, int) else v)
            for k, v in tree.items()}


def snapshot_state(graphs: Dict[str, object], step: int,
                   extra: Optional[Dict] = None,
                   mesh_spec: Optional[Dict] = None) -> Dict:
    """The training-thread half of a save: each graph's config and the
    copies to pinned host memory of every param, updater and tensor
    extra, started on the current stream behind one event.  After this
    returns the training may go on: the copies are ordered before any
    later work on the stream, and ``write_snapshot`` waits for the event.

    ``extra``: int/float/str/bool/None values go to ``state.json``; a
    dict is a nested tensor tree flattened under its key; a tensor or
    array goes to ``state.npz`` under its key."""
    tensors: list = []
    graph_parts = {
        name: (serialization.graph_config_to_dict(g),
               _tree_tensors(g.params, tensors),
               _tree_tensors(g.opt_state, tensors))
        for name, g in graphs.items()}
    scalars: Dict = {"step": step, "graphs": sorted(graphs.keys())}
    arrays: Dict = {}
    pytrees = []
    for k, v in (extra or {}).items():
        if isinstance(v, (int, float, str, bool)) or v is None:
            scalars[k] = v
        elif isinstance(v, dict):
            pytrees.append(k)
            arrays[k] = ("tree", _tree_tensors(v, tensors))
        elif isinstance(v, torch.Tensor):
            tensors.append(v)
            arrays[k] = ("tensor", len(tensors) - 1)
        else:
            arrays[k] = ("array", np.asarray(v))
    if pytrees:
        scalars["pytree_extras"] = sorted(pytrees)
    hosts, event = host_copy(tensors)
    if event is None:
        # host tensors: copies now, so a live tensor changed in place
        # later cannot reach a background serializer
        hosts = [t.clone() for t in hosts]
    snap = {"graphs": graph_parts, "scalars": scalars, "arrays": arrays,
            "hosts": hosts, "event": event}
    if mesh_spec is not None:
        snap["mesh_spec"] = dict(mesh_spec)
    return snap


def _host_arrays(snap: Dict):
    """Wait for the snapshot's copies -> ({graph: (config, flat params,
    flat updater)}, {key: array}) of C-contiguous host arrays."""
    # polled, so that the watchdog's raise reaches a waiting training
    # thread (a synchronous save waits here)
    wait_event(snap["event"])
    hosts = snap["hosts"]
    graphs = {name: (cfg, serialization._flatten(_tree_fill(p, hosts)),
                     serialization._flatten(_tree_fill(o, hosts)))
              for name, (cfg, p, o) in snap["graphs"].items()}
    arrays: Dict[str, np.ndarray] = {}
    for k, (kind, v) in snap["arrays"].items():
        if kind == "tree":
            arrays.update(serialization._flatten(_tree_fill(v, hosts),
                                                 f"{k}/"))
        elif kind == "tensor":
            arrays[k] = np.ascontiguousarray(hosts[v].numpy())
        else:
            arrays[k] = v
    return graphs, arrays


class TrainCheckpointer:
    def __init__(self, directory: str, keep: int = 3,
                 sweep_debris: bool = True):
        """``sweep_debris=False`` makes this a read-side handle (no debris
        purge or orphan adoption at init): anything that reads a directory
        another process is saving into (a data-parallel rank other than 0)
        must pass False, since the owner's in-flight ``.ckpt_tmp_*`` looks
        like crash debris."""
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        if sweep_debris:
            self._purge_debris()

    def _purge_debris(self) -> None:
        """Reclaim the temp/swap dirs a hard kill mid-save left behind.  An
        orphan whose manifest verifies is a complete checkpoint that missed
        its rename: when its step has no entry it is renamed into place
        (a ``.ckpt_tmp_`` orphan, the newer bytes of an interrupted re-save,
        before a ``.ckpt_del_`` one)."""
        debris = [n for n in sorted(os.listdir(self.directory))
                  if n.startswith((".ckpt_tmp_", ".ckpt_del_"))]
        changed = False
        adopted = set()
        for prefix in (".ckpt_tmp_", ".ckpt_del_"):
            for name in debris:
                if not name.startswith(prefix):
                    continue
                path = os.path.join(self.directory, name)
                step = self._orphan_step(path)
                if step is None:
                    continue
                final = os.path.join(self.directory, f"ckpt_{step}")
                if not os.path.exists(final):
                    _log.warning(
                        "adopting orphaned complete checkpoint %s as "
                        "ckpt_%d (killed before its rename)", name, step)
                    os.rename(path, final)
                    adopted.add(name)
                    changed = True
        for name in debris:
            if name in adopted:
                continue
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
            changed = True
        if changed:
            _fsync_dir(self.directory)

    def _orphan_step(self, path: str) -> Optional[int]:
        if not self._verify_dir(path):
            return None
        try:
            with open(os.path.join(path, MANIFEST_NAME)) as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, graphs: Dict[str, object],
             extra: Optional[Dict] = None,
             mesh_spec: Optional[Dict] = None) -> str:
        """Write ``ckpt_{step}`` atomically (manifest-verified, fsynced);
        prune beyond ``keep``.  Snapshot and serialize on this thread."""
        return self.write_snapshot(
            snapshot_state(graphs, step, extra, mesh_spec=mesh_spec))

    def write_snapshot(self, snap: Dict) -> str:
        """Serialize a ``snapshot_state`` result to ``ckpt_{step}``: file
        work only after the copies' event (background-thread safe).  Every
        file is fsynced; the manifest is written last; the final rename is
        the commit point.  The serialize/fsync and commit stages are the
        ``checkpoint.serialize`` / ``checkpoint.commit`` event spans, so a
        flight record names the stage a kill landed in."""
        step = snap["scalars"]["step"]
        graphs, arrays = _host_arrays(snap)
        final = os.path.join(self.directory, f"ckpt_{step}")
        tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=self.directory)
        try:
            entries: Dict[str, Dict] = {}

            def put(name: str, data: bytes) -> None:
                path = os.path.join(tmp, name)
                with open(path, "wb") as f:
                    f.write(data)
                _fsync_file(path)
                entries[name] = {"bytes": len(data),
                                 "sha256": hashlib.sha256(data).hexdigest()}
                _chaos(f"wrote:{name}")

            with events.span("checkpoint.serialize", step=step):
                for name, (cfg, flat_params, flat_updater) in sorted(
                        graphs.items()):
                    put(f"{name}_model.zip", serialization.model_zip_bytes(
                        cfg, flat_params, flat_updater))
                put("state.json",
                    json.dumps(snap["scalars"], indent=1).encode())
                if arrays:
                    put("state.npz", serialization.npz_bytes(arrays))
                mpath = os.path.join(tmp, MANIFEST_NAME)
                manifest: Dict = {"step": step, "files": entries}
                if snap.get("mesh_spec") is not None:
                    manifest["mesh_spec"] = snap["mesh_spec"]
                with open(mpath, "w") as f:
                    json.dump(manifest, f, indent=1)
                _fsync_file(mpath)
                _fsync_dir(tmp)
                _chaos("manifest")
            with events.span("checkpoint.commit", step=step):
                if os.path.exists(final):
                    # swap, never rmtree-then-rename: a kill between the
                    # renames loses the step's entry, never both copies
                    trash = tempfile.mkdtemp(prefix=".ckpt_del_",
                                             dir=self.directory)
                    os.rmdir(trash)
                    _chaos("pre_swap")
                    os.rename(final, trash)
                    _chaos("mid_swap")
                    os.rename(tmp, final)
                    _chaos("post_swap")
                    shutil.rmtree(trash, ignore_errors=True)
                else:
                    _chaos("pre_swap")
                    os.rename(tmp, final)
                    _chaos("post_swap")
                _fsync_dir(self.directory)
        except BaseException as e:
            # a simulated hard kill leaves the directory as a real one
            # would, debris and all (purged at the next init)
            if not getattr(e, "simulates_kill", False):
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"ckpt_{s}"),
                          ignore_errors=True)

    # -- verification --------------------------------------------------------

    def verify(self, step: int) -> bool:
        """True iff ``ckpt_{step}``'s manifest parses and every listed file
        exists with its size and SHA-256."""
        return self._verify_dir(os.path.join(self.directory, f"ckpt_{step}"))

    @staticmethod
    def _verify_dir(path: str) -> bool:
        try:
            with open(os.path.join(path, MANIFEST_NAME)) as f:
                manifest = json.load(f)
            files = manifest["files"]
            if "state.json" not in files:
                return False
            for name, meta in files.items():
                fp = os.path.join(path, name)
                if (not os.path.isfile(fp)
                        or os.path.getsize(fp) != meta["bytes"]
                        or _sha256(fp) != meta["sha256"]):
                    return False
            return True
        except (OSError, ValueError, KeyError, TypeError):
            return False  # torn manifest / pre-manifest layout

    @staticmethod
    def _is_legacy_dir(path: str) -> bool:
        """A committed checkpoint from before the manifest existed: no
        MANIFEST.json but a state.json (a torn save never leaves a
        committed entry).  Unverifiable, not corrupt: restored loudly."""
        return (not os.path.exists(os.path.join(path, MANIFEST_NAME))
                and os.path.isfile(os.path.join(path, "state.json")))

    def latest_verified_step(self) -> Optional[int]:
        for s in reversed(self.steps()):
            if self.verify(s):
                return s
        return None

    def mesh_spec(self, step: int) -> Optional[Dict]:
        """The saving topology in ``ckpt_{step}``'s manifest, or None."""
        path = os.path.join(self.directory, f"ckpt_{step}", MANIFEST_NAME)
        try:
            with open(path) as f:
                spec = json.load(f).get("mesh_spec")
        except (OSError, ValueError):
            return None
        return spec if isinstance(spec, dict) else None

    # -- restore -------------------------------------------------------------

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def prune_above(self, step: int) -> list:
        """Remove every committed checkpoint with a step above ``step``
        (a rollback's poisoned suffix) -> the pruned steps."""
        pruned = [s for s in self.steps() if s > step]
        for s in pruned:
            _log.warning("pruning checkpoint ckpt_%d (> restore point %d)",
                         s, step)
            shutil.rmtree(os.path.join(self.directory, f"ckpt_{s}"),
                          ignore_errors=True)
        if pruned:
            _fsync_dir(self.directory)
        return pruned

    def restore(self, graphs: Dict[str, object], step: Optional[int] = None,
                max_step: Optional[int] = None,
                target_mesh=_NO_TARGET) -> Tuple[int, Dict]:
        """Load params and updater state into ``graphs`` (in place, on each
        graph's device) -> (step, extra); extra arrays come back as numpy.

        ``step=None``: newest first, skipping (with a warning) every
        checkpoint that fails verification or does not load, then the
        pre-manifest ones; ``max_step`` bounds the walk.  Raises
        ``NoVerifiedCheckpointError`` when nothing is left.  An explicit
        ``step`` that fails verification raises
        ``CheckpointCorruptError``.  A structure mismatch (graph set,
        params or updater trees) raises ``ValueError``: the run was
        resumed with other flags.

        ``target_mesh`` (the elastic resume, ``parallel/elastic.py``): the
        topology this restore lands on, a ``MeshSpec`` or its dict
        (``mesh_spec_dict(world)``), None for one device.  When the
        checkpoint's recorded ``mesh_spec`` differs,
        ``extra["__reshard__"]`` reports ``{"from", "to", "seconds"}`` and,
        when graphs were loaded, a ``reshard.restore`` event marks the
        timeline.  The replicated state's load is its reshard, so
        ``seconds`` is 0.0 here; a caller that splits state over the new
        world adds the split's seconds.  Without a target, the plain load
        of any topology."""
        if step is not None:
            path = os.path.join(self.directory, f"ckpt_{step}")
            if not os.path.isdir(path):
                raise FileNotFoundError(
                    f"no checkpoint ckpt_{step} in {self.directory}")
            if not self.verify(step):
                if self._is_legacy_dir(path):
                    _log.warning("checkpoint ckpt_%d predates the manifest "
                                 "format (unverifiable, accepted)", step)
                else:
                    raise CheckpointCorruptError(
                        f"checkpoint ckpt_{step} in {self.directory} fails "
                        "manifest verification (torn or corrupt)")
            return self._load_elastic(step, graphs, target_mesh)
        candidates = self.steps()
        if max_step is not None:
            candidates = [s for s in candidates if s <= max_step]
        if not candidates:
            raise NoVerifiedCheckpointError(
                f"no checkpoints in {self.directory}"
                + (f" at or below step {max_step}"
                   if max_step is not None else ""))
        legacy = []
        for s in reversed(candidates):
            if not self.verify(s):
                if self._is_legacy_dir(
                        os.path.join(self.directory, f"ckpt_{s}")):
                    legacy.append(s)
                    continue
                _log.warning("checkpoint ckpt_%d fails verification (torn "
                             "or corrupt); falling back to the previous "
                             "one", s)
                continue
            try:
                return self._load_elastic(s, graphs, target_mesh)
            except ValueError:
                raise  # structure or topology mismatch: fatal
            except Exception as e:  # unreadable despite the manifest
                _log.warning("checkpoint ckpt_%d failed to load (%r); "
                             "falling back to the previous one", s, e)
        for s in legacy:
            _log.warning("checkpoint ckpt_%d predates the manifest format "
                         "(unverifiable); attempting restore", s)
            try:
                return self._load_elastic(s, graphs, target_mesh)
            except ValueError:
                raise
            except Exception as e:
                _log.warning("legacy checkpoint ckpt_%d failed to load "
                             "(%r)", s, e)
        raise NoVerifiedCheckpointError(
            f"no VERIFIED checkpoint in {self.directory} "
            f"(all of {candidates} torn or corrupt)")

    def _load_elastic(self, step: int, graphs: Dict[str, object],
                      target_mesh) -> Tuple[int, Dict]:
        """``_load``, then the elastic record when the target's topology
        differs from the saved one.  A checkpoint with no recorded spec
        (from before the elastic format) and a restore with no target keep
        the plain load."""
        saved = self.mesh_spec(step)
        step_out, extra = self._load(step, graphs)
        if saved is None or target_mesh is _NO_TARGET:
            return step_out, extra
        saved_spec = elastic.MeshSpec.from_dict(saved)
        target = (elastic.MeshSpec.from_world(1) if target_mesh is None
                  else elastic.as_spec(target_mesh))
        if saved_spec.same_topology(target):
            return step_out, extra
        extra["__reshard__"] = {"from": saved_spec.to_dict(),
                                "to": target.to_dict(), "seconds": 0.0}
        if graphs:
            # an extras-only restore (the fleet's) splits its state itself
            # and marks the timeline then
            _log.warning("resharded checkpoint ckpt_%d from %s onto %s "
                         "(replicated state: the load placed it)", step,
                         saved_spec.describe(), target.describe())
            events.instant("reshard.restore", step=step,
                           from_devices=saved_spec.device_count,
                           to_devices=target.device_count, seconds=0.0)
        return step_out, extra

    def _load(self, step: int, graphs: Dict[str, object]) -> Tuple[int, Dict]:
        path = os.path.join(self.directory, f"ckpt_{step}")
        with open(os.path.join(path, "state.json")) as f:
            scalars = json.load(f)
        saved, supplied = set(scalars["graphs"]), set(graphs.keys())
        if saved != supplied:
            raise ValueError(f"checkpoint graphs {sorted(saved)} != supplied "
                             f"{sorted(supplied)}")
        # load and check every graph before assigning any: a mismatch
        # never leaves a half-restored graph set
        loaded_all = {}
        for name, graph in graphs.items():
            loaded = serialization.read_model(
                os.path.join(path, f"{name}_model.zip"), graph.device)
            for field, hint in (
                    ("params", "different architecture"),
                    ("opt_state", "different updater configuration")):
                if _structure(getattr(loaded, field)) != _structure(
                        getattr(graph, field)):
                    raise ValueError(
                        f"checkpoint {field} structure for graph {name!r} "
                        f"does not match this run's ({hint}); resume with "
                        "the original run's flags")
            loaded_all[name] = loaded
        for name, graph in graphs.items():
            graph.params = loaded_all[name].params
            graph.opt_state = loaded_all[name].opt_state
        pytrees = set(scalars.pop("pytree_extras", []))
        extra = {k: v for k, v in scalars.items()
                 if k not in ("step", "graphs")}
        npz_path = os.path.join(path, "state.npz")
        if os.path.exists(npz_path):
            flat_trees: Dict[str, Dict] = {k: {} for k in pytrees}
            with np.load(npz_path) as z:
                for k in z.files:
                    root = k.split("/", 1)[0]
                    if root in pytrees:
                        flat_trees[root][k.split("/", 1)[1]] = z[k]
                    else:
                        extra[k] = z[k]
            for k, flat in flat_trees.items():
                extra[k] = _unflatten_numpy(flat)
        return scalars["step"], extra


def _structure(tree: Dict):
    """A tree's shape for the restore check: the key sets at every level
    (dict order aside, as a JAX tree structure compares them)."""
    return {k: _structure(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def _unflatten_numpy(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    return tree
