"""In-graph numerics telemetry (torch twin of
``gan_deeplearning4j_tpu/telemetry/ingraph.py``): the signals that explain
a diverging GAN run before the FID collapses.

Everything here runs inside the training step itself, from values the
step already holds: global gradient norm, parameter norm and update ratio
per trained graph, plus a NaN/Inf counter over gradients and losses.  The
step returns them as a small fixed-shape block of device scalars beside
the losses; on one card they ride the CUDA graph and its single readback
(``train/fused_step.py`` ``GraphedStep``), so they cost no launch from
Python and no extra wait.  Under K steps a call they stack to [K] like the
losses.  The norms and counts are plain torch ops, as the JAX package
computes them outside any Pallas kernel.

Each tree is flattened into one f32 buffer (leaves in the JAX pytree
order, sorted keys) before it is reduced, so a graph's block is a handful
of launches whatever its leaf count.  Sums of squares accumulate in f32
whatever the leaves' dtype, as in the JAX package.

Host side, ``NanAlarm`` watches the records the metrics logger flushes and
trips on the first non-finite step; the trainer decides what a trip means
(warn / snapshot / abort / rollback, ``train/gan_trainer.py``).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional

import torch

# update_ratio's divide-by-zero guard; in f32 a param norm at this scale
# is indistinguishable from an all-zero network anyway
_EPS = 1e-12


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensor leaves of ``tree`` in the JAX pytree order (dict keys
    sorted); other leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


def _flat(tree) -> Optional[torch.Tensor]:
    """Every tensor leaf of ``tree`` as one f32 vector (None: no leaf)."""
    leaves = [t.reshape(-1).float() for t in _leaves(tree, [])]
    return torch.cat(leaves) if leaves else None


def _norm(flat: Optional[torch.Tensor]) -> torch.Tensor:
    # the sum of squares as one dot product: one pass over the buffer.
    # torch's CPU ``vector_norm`` accumulates a long f32 vector with a
    # relative error near 1e-4 at the CV graphs' ~8M elements; the dot's
    # stays near 1e-7
    if flat is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.dot(flat, flat))


def _count(flat: Optional[torch.Tensor]) -> torch.Tensor:
    if flat is None:
        return torch.zeros((), dtype=torch.int32)
    return (~torch.isfinite(flat)).sum(dtype=torch.int32)


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm over every tensor leaf of ``tree`` (f32 0-d)."""
    return _norm(_flat(tree))


def count_nonfinite(tree) -> torch.Tensor:
    """Total count of non-finite (NaN or +/-Inf) elements over every
    tensor leaf of ``tree`` (int32 0-d)."""
    return _count(_flat(tree))


def graph_telemetry(params, new_params, grads, loss) -> Dict[str, torch.Tensor]:
    """One trained graph's numerics block, from values the step holds:

    * ``grad_norm``: global L2 of the (cross-rank reduced) gradients;
    * ``param_norm``: global L2 of the UPDATED parameters (BN running
      statistics as the state updates overwrote them);
    * ``update_ratio``: ||new - old|| / ||old||, the per-step relative
      weight movement;
    * ``nonfinite``: the NaN/Inf count over the gradients and the loss.

    ``params`` and ``new_params`` have the same leaves."""
    new, old, g = _flat(new_params), _flat(params), _flat(grads)
    old_norm = _norm(old)
    update = None if new is None else new - old
    return {
        "grad_norm": _norm(g),
        "param_norm": _norm(new),
        "update_ratio": _norm(update) / (old_norm + _EPS),
        "nonfinite": _count(g) + _count(_flat(loss)),
    }


class NanAlarmError(RuntimeError):
    """Raised by the trainer when a ``NanAlarm`` with action="abort"
    trips (first training step with a non-finite loss/grad)."""


class NanAlarm:
    """First-bad-step detector over metrics records.

    Registered as the MetricsLogger's ``on_record`` hook, so it observes
    every record the logger flushes.  A record is "bad" when its
    ``nonfinite`` counter is positive or any telemetry/loss value is
    itself non-finite.  The first bad record arms ``tripped``/``step``/
    ``record`` (thread-safely, latched — later records don't overwrite
    the first occurrence) and fires the optional ``on_trip`` callback
    once.  The training loop polls ``tripped`` at its bookkeeping
    points and applies the configured action."""

    # keys whose own non-finiteness (not just nonfinite>0) means trouble
    _WATCH_SUFFIXES = ("_loss", "_norm", "_ratio")

    def __init__(self, on_trip: Optional[Callable[[Dict], None]] = None):
        self._lock = threading.Lock()
        self._on_trip = on_trip
        self.tripped = False
        self.step: Optional[int] = None
        self.record: Optional[Dict] = None

    @staticmethod
    def _is_bad(rec: Dict) -> bool:
        if rec.get("nonfinite", 0):
            return True
        for k, v in rec.items():
            if isinstance(v, float) and not math.isfinite(v) and (
                    k.endswith(NanAlarm._WATCH_SUFFIXES)):
                return True
        return False

    def observe(self, rec: Dict) -> None:
        """MetricsLogger ``on_record`` hook."""
        if self.tripped or not self._is_bad(rec):
            return
        with self._lock:
            if self.tripped:  # lost the race to an earlier bad record
                return
            self.step = rec.get("step")
            self.record = rec
            self.tripped = True
        if self._on_trip is not None:
            self._on_trip(rec)
