"""Data-parallel process groups and their collectives (torch twin of
``gan_deeplearning4j_tpu/parallel/mesh.py``: where the JAX package builds a
1-D ``data`` mesh over the attached devices, the port runs one process per
rank and joins them in a ``torch.distributed`` group).

  data_group(rank, world, init_method, device)  join the group
  all_reduce_sum_(t, group)                     in-place sum over ranks of one
                                                contiguous tensor (no copy)
  all_reduce_mean(tree, group)                  forward-only mean over ranks
                                                of a tensor / nested dict /
                                                tuple of tensors, one flat
                                                all-reduce
  all_reduce_mean_diff(t, group)                differentiable mean over
                                                ranks (``lax.pmean`` inside
                                                ``shard_map(check_vma=False)``)
  barrier(group)                                every rank waits for all
  agree_preemption(triggered, step, group)      (any rank triggered, the
                                                least step) in one
                                                all-reduce
  spawn(fn, world, args, device, timeout)       run ``fn`` in one process
                                                per rank and collect results

Backend: NCCL when every rank has a card of its own, gloo on the CPU and
when ranks share a card (NCCL refuses two ranks on one device).  gloo takes
CUDA tensors itself: it stages them through host memory, so a gloo group
on the card pays a device-to-host and a host-to-device copy per
collective; an NCCL group never copies.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gan_deeplearning4j_tpu_torch.runtime import backend as backend_lib
from gan_deeplearning4j_tpu_torch.telemetry import events


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the data-parallel group."""

    rank: int
    world: int
    device: torch.device
    backend: str

    def close(self) -> None:
        """Leave the group (destroys this process's default group)."""
        dist.destroy_process_group()


def choose_backend(device: torch.device, world: int) -> str:
    if device.type == "cpu":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def rank_device(device, rank: int) -> torch.device:
    """``cuda`` (or None) -> ``cuda:rank``, wrapped over the attached cards
    when there are more ranks than cards; ``cpu`` stays ``cpu``."""
    dev = backend_lib.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def data_group(rank: int, world: int, init_method: str,
               device=None) -> DataGroup:
    """Join the default process group as ``rank`` of ``world`` through the
    rendezvous ``init_method`` (``file://...`` or ``tcp://host:port``).
    ``device``: None = this rank's card."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of world {world}")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, world)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    # every rank's connections are up before any rank goes on: a rank that
    # finished early and left the group would otherwise close its sockets
    # under a peer still connecting to it (gloo: "Connection closed by
    # peer" in that peer's init_process_group)
    dist.barrier(device_ids=[dev.index] if backend == "nccl" else None)
    return DataGroup(rank=rank, world=world, device=dev, backend=backend)


def _all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the ranks of the default group."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_sum_(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """``t`` becomes its sum over the ranks of ``group``, in place: one
    collective and no other device work (sync-BN's moments go through it
    between the two kernels).  Returns ``t``.  Every rank passes a tensor
    of the same shape."""
    if not t.is_contiguous():
        raise ValueError(f"all_reduce_sum_ takes a contiguous tensor, got "
                         f"shape {tuple(t.shape)} strides {t.stride()} "
                         f"(rank {group.rank} of {group.world})")
    return _all_reduce_sum_(t)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"all_reduce_mean: unsupported leaf {type(tree)}")


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return type(tree)(_rebuild(v, it) for v in tree)


def all_reduce_mean(tree, group: DataGroup):
    """The mean over ranks of every tensor in ``tree`` (same structure
    out), outside autograd.  All leaves travel in one flat buffer: one
    collective per call.  Every rank must pass the same structure."""
    leaves = _leaves(tree)
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    _all_reduce_sum_(flat)
    flat /= group.world
    parts = iter(p.view_as(t) for p, t in
                 zip(flat.split([t.numel() for t in leaves]), leaves))
    return _rebuild(tree, parts)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its cotangent is summed over ranks too, so the
    cross-rank terms of a gradient (sync-BN's) reach every rank."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum_(g.contiguous().clone())


def all_reduce_mean_diff(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Mean over ranks with a gradient: the transpose of the mean is the
    mean of the cotangents, as ``lax.pmean``'s is under ``shard_map``."""
    return _AllReduceSum.apply(t) / group.world


def barrier(group: DataGroup) -> None:
    """Every rank of ``group`` waits here until all have arrived."""
    dist.barrier(device_ids=[group.device.index]
                 if group.backend == "nccl" else None)


def agree_preemption(triggered: bool, step: int,
                     group: DataGroup) -> Tuple[bool, int]:
    """The ranks' consensus at a boundary (the JAX package's
    ``multihost.agree_preemption``): one all-reduce of (triggered, -step)
    with MAX -> (whether any rank was signalled, the least step).  Every
    rank must enter it at every boundary while its guard is armed, so a
    signal that reaches one rank stops them all at the same step."""
    dev = group.device if group.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([int(bool(triggered)), -int(step)], dtype=torch.int64,
                     device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    flag, neg_step = t.tolist()
    return bool(flag), -int(neg_step)


def mesh_report(group: Optional[DataGroup]) -> Dict:
    """The scrape registry's mesh feed (``MetricsRegistry.observe_mesh``,
    the JAX trainer's ``_mesh_report``) of a run that keeps no reshard
    account (``roadmap_main``'s pair): the group's size.  ``GANTrainer``
    feeds its own, with the reshards of its restore."""
    return {"devices": group.world if group is not None else 1,
            "reshard_total": 0, "reshard_seconds": 0.0, "forming": False,
            "ok": True}


def aggregate_goodput(report: Dict, group: Optional[DataGroup]) -> Dict:
    """The ranks' goodput (the JAX package's
    ``multihost.aggregate_goodput``): the MEAN of every numeric entry of a
    ``GoodputTimer.report()`` over the ranks, one all-reduce; a straggler
    shows as everyone else's readback and ``other``.  Without a group (or
    at world 1) the report passes through.  Every rank must enter it."""
    if group is None or group.world == 1:
        return report
    keys = sorted(k for k, v in report.items()
                  if isinstance(v, (int, float)))
    dev = group.device if group.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([float(report[k]) for k in keys], dtype=torch.float64,
                     device=dev)
    with events.span("collective.aggregate_goodput", processes=group.world):
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    out = dict(report)
    out.update({k: round(float(v) / group.world, 6)
                for k, v in zip(keys, t.tolist())})
    out["aggregated_processes"] = group.world
    return out


def agree_max(values: Sequence[int], group: DataGroup) -> List[int]:
    """The ranks' element-wise maximum of small ints: one all-reduce.  The
    trainer's alarm consensus sends rank 0's trips (flags and steps) this
    way, the other ranks zeros; every rank must enter it at every boundary
    while an alarm is armed.  A rollback's budget check sends each value
    and its negation (the maximum and the minimum at once)."""
    dev = group.device if group.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [int(v) for v in t.tolist()]


def reducer(group: Optional[DataGroup]):
    """The ``reduce(loss, state_updates, grads)`` hook of
    ``ComputationGraph._train_step``: their mean over ranks (None without a
    group)."""
    if group is None:
        return None
    return lambda loss, updates, grads: all_reduce_mean(
        (loss, updates, grads), group)


# -- one process per rank ----------------------------------------------------

class RankFailedError(RuntimeError):
    """One or more ranks of a ``spawn`` raised.  ``failures`` holds, per
    failed rank, ``(rank, class names, traceback)``: the names are the
    exception's class and its bases (its MRO), so the parent can classify a
    failure by class across the process boundary, as ``isinstance`` would
    in the rank (``has_class``)."""

    def __init__(self, failures: Sequence[Tuple[int, Tuple[str, ...], str]]):
        self.failures = list(failures)
        super().__init__("data-parallel rank failed:\n" + "\n".join(
            f"rank {rank} ({names[0]}):\n{tb}"
            for rank, names, tb in self.failures))

    def has_class(self, *names: str) -> bool:
        """Whether any failed rank raised an instance of a class named in
        ``names`` (a subclass counts)."""
        return any(set(names) & set(cls) for _, cls, _ in self.failures)


def _failure(e: BaseException) -> Tuple[Tuple[str, ...], str]:
    return (tuple(c.__name__ for c in type(e).__mro__),
            traceback.format_exc())


def _rank_main(fn, rank, world, init_method, device, args, results):
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        group = data_group(rank, world, init_method, device)
    except BaseException as e:  # reported to the parent, which raises
        results.put((rank, "failed", _failure(e)))
        raise
    results.put((rank, "joined", None))
    try:
        out = fn(group, *args)
    except BaseException as e:
        # reported before the group is left: leaving may wait on peers
        # that sit in a collective with this rank
        results.put((rank, "failed", _failure(e)))
        raise
    finally:
        group.close()
    results.put((rank, "done", out))


# seconds a spawned rank may take from its start to joining the group: a
# fresh interpreter imports torch and the job's module first, slowly on a
# loaded host
JOIN_TIMEOUT_S = 300.0
# seconds the other ranks get, once one rank has failed or died, to report
# their own errors before they are killed
FAIL_GRACE_S = 5.0


def spawn(fn: Callable, world: int, args: Sequence = (), device=None,
          timeout: float = 600.0,
          forward_signals: Sequence[int] = ()) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` fresh processes (start method
    ``spawn``), rank r on ``device`` (``cpu``, or None/``cuda`` for
    ``cuda:r``), joined through a ``file://`` rendezvous in a temporary
    directory.  Returns the ranks' results in rank order.  ``fn`` and
    ``args`` are pickled: ``fn`` must be importable from a module that
    imports no more than the child needs.  The ranks have JOIN_TIMEOUT_S
    seconds from the start to join the group; ``timeout`` counts from the
    moment the last rank joined.  A child that fails, or misses either
    limit, fails the call: stragglers are killed, and no process outlives
    it.  The call fails fast: once one rank reports a failure or dies, the
    others get FAIL_GRACE_S seconds to report theirs (a rank left in a
    collective with the failed one never returns), then all are killed and
    ``RankFailedError`` names every failure with its class.
    ``forward_signals``: signals this process passes on to every live
    rank while it waits (a scheduler's SIGTERM to the parent reaches the
    ranks' preemption guards); call from the main thread."""
    import signal

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gan4j_rdv_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"gan4j-rank-{r}",
                         args=(fn, r, world, f"file://{tmp}/store", device,
                               tuple(args), results), daemon=False)
             for r in range(world)]
    joined, got, failed = set(), {}, []
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    grace = float("inf")

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signum)

    prev = {s: signal.signal(s, forward) for s in forward_signals}
    try:
        for p in procs:
            p.start()
        while len(got) + len(failed) < world:
            left = min(deadline, grace) - time.monotonic()
            if left <= 0:
                break
            try:
                rank, what, out = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    # a rank died without reporting
                    grace = min(grace, time.monotonic() + FAIL_GRACE_S)
                continue
            if what == "joined":
                joined.add(rank)
                if len(joined) == world:
                    deadline = time.monotonic() + timeout
            elif what == "done":
                got[rank] = out
            else:
                failed.append((rank, *out))
                grace = min(grace, time.monotonic() + FAIL_GRACE_S)
        if not failed:
            for p in procs:
                p.join(max(0.0, min(deadline, grace) - time.monotonic())
                       + 5.0)
    finally:
        for s, handler in prev.items():
            signal.signal(s, handler)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in alive:
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RankFailedError(failed)
    codes = {p.name: p.exitcode for p in procs}
    if len(joined) < world:
        raise RuntimeError(f"ranks {sorted(set(range(world)) - joined)} did "
                           f"not join the group within {JOIN_TIMEOUT_S} s "
                           f"(exit codes {codes})")
    missing = [r for r in range(world) if r not in got]
    if missing:
        raise RuntimeError(f"ranks {missing} did not finish within "
                           f"{timeout} s of joining (exit codes {codes})")
    return [got[r] for r in range(world)]

