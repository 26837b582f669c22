"""Rollback-with-perturbation — heal a diverging run instead of dying
(torch twin of ``gan_deeplearning4j_tpu/train/rollback.py``).

``--nan-alarm abort`` is deliberately FATAL in the recovery wrapper: the
data order and the latent stream are functions of the seed and the step,
so a deterministic replay from the last checkpoint marches straight back
into the same NaN.  ``--nan-alarm rollback`` (shared by the divergence
sentinel, ``train/divergence.py``) does three things instead:

1. **restore** the last verified checkpoint from BEFORE the bad step,
   in-process (the trainer raises ``RollbackRequested``; the recovery
   wrapper rebuilds the trainer with ``resume=True``, and the resume
   restores with ``max_step`` excluding the poisoned suffix, then prunes
   it);
2. **cut the learning rate** by ``lr_factor`` (compounding per rollback);
3. **move the latent stream to another lineage**, so the replayed window
   draws DIFFERENT latents.  The JAX package folds a salt into its
   counter-based key; the port's latents come from a sequential generator
   (``z_gen``) whose state the restore sets, so the trainer reseeds it
   AFTER the restore (``perturb_z_gen``), to a state that is a pure
   function of the seed and the rollback epoch.  The protocol paths have
   no dropout stream to perturb (the insurance dropout has rate 0, the
   CV graphs have none).

Both the LR cut and the reseed happen before the step is captured: the
captured ``fused_update`` launches carry their rates as arguments, and
the graph replays the generator registered at capture.

The budget is progress-aware like the restart budget: a rollback at a
LATER step than the previous one resets the attempt counter, while
repeated rollbacks at the same step exhaust ``max_rollbacks`` and escalate
to ``RollbackError``, which the recovery wrapper classifies FATAL.

One ``RollbackManager`` must be shared across every trainer incarnation
of a run (``run_with_recovery`` owns it): the LR scale, the epoch and the
budget live on it.  In a data-parallel world each rank's
``run_with_recovery`` owns one and charges it in lockstep with the others
(every rank takes the agreed alarm at the same boundary; the trainer then
agrees on the budgets), and every rank rebuilds its trainer in place over
the same live group: no process is re-spawned.  A re-spawn of the world
(``--max-restarts``) starts fresh managers.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

from gan_deeplearning4j_tpu_torch.runtime import prng

_log = logging.getLogger(__name__)

# salt of the rollback lineages' stream names (the JAX package's
# fold_in salt); any constant works, it is reserved for this purpose
PERTURB_SALT = 0x5EED_BACC


class RollbackRequested(RuntimeError):
    """The trainer wants an in-process rollback: restore the last
    verified pre-failure checkpoint, apply the manager's perturbation,
    and continue.  ``train_with_recovery`` handles it WITHOUT burning
    the restart budget (the rollback budget is the manager's own)."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 rollbacks: int = 0):
        super().__init__(msg)
        self.step = step
        self.rollbacks = rollbacks


class RollbackError(RuntimeError):
    """The rollback budget is exhausted (same step keeps failing even
    with the LR cut and perturbed noise): escalate to fatal — the same
    end state ``--nan-alarm abort`` reaches immediately, after
    ``max_rollbacks`` genuine healing attempts."""


class RollbackManager:
    """Cross-incarnation rollback state: budget, LR scale, epoch.

    ``request(step, reason, bad_step=...)`` charges the (progress-aware)
    budget and records where the poison starts; a new trainer incarnation
    reads ``resume_max_step`` before its restore and calls ``apply`` (the
    LR cut) and, after a rollback restore, ``perturb_z_gen``."""

    def __init__(self, max_rollbacks: int = 3, lr_factor: float = 0.5):
        if not 0.0 < lr_factor <= 1.0:
            raise ValueError(
                f"lr_factor must be in (0, 1], got {lr_factor} "
                "(a factor > 1 would amplify the divergence being "
                "healed)")
        if max_rollbacks < 1:
            raise ValueError("max_rollbacks must be >= 1")
        self.max_rollbacks = int(max_rollbacks)
        self.lr_factor = float(lr_factor)
        self.total = 0              # lifetime count: LR compounding + epoch
        self.attempts = 0           # progress-aware budget window
        self.last_step: Optional[int] = None
        self.restore_before: Optional[int] = None
        self.last_reason: Optional[str] = None

    @property
    def lr_scale(self) -> float:
        return self.lr_factor ** self.total

    @property
    def exhausted(self) -> bool:
        return self.attempts > self.max_rollbacks

    @property
    def resume_max_step(self) -> Optional[int]:
        """The bound of the next restore: strictly before the first
        known-bad step (None when no rollback is pending)."""
        return (None if self.restore_before is None
                else self.restore_before - 1)

    def request(self, step: int, reason: str,
                bad_step: Optional[int] = None) -> bool:
        """Charge one rollback at ``step``.  ``bad_step``: the first
        step whose state is known-poisoned (the alarm step); the resume
        restores strictly before it.  Returns False when the budget is
        exhausted (the caller escalates to ``RollbackError``)."""
        if self.last_step is not None and step > self.last_step:
            self.attempts = 0  # progress since the last incident
        self.last_step = step
        self.attempts += 1
        self.total += 1
        self.restore_before = bad_step if bad_step is not None else step
        self.last_reason = reason
        return not self.exhausted

    def apply(self, trainer) -> None:
        """Install the LR cut on a fresh trainer incarnation: every
        trainable layer updater of its four graphs at ``lr_scale``.  Runs
        before the step is built or captured; a manager that has never
        rolled back is a no-op."""
        if not self.total:
            return
        scale = self.lr_scale
        scaled = sum(scale_graph_lr(g, scale)
                     for g in trainer._graphs().values())
        _log.warning("rollback #%d applied: lr x%.4g on %d layer updaters",
                     self.total, scale, scaled)


def perturb_z_gen(z_gen: torch.Generator, seed: int, epoch: int) -> None:
    """Move the latent generator to the ``epoch``-th rollback lineage: a
    reseed to a stream of ``seed`` named after the epoch, so the state is
    a pure function of (seed, epoch) — the same in every incarnation at
    that epoch, never the stream that produced the blowup."""
    z_gen.manual_seed(prng.stream_seed(
        seed, f"train-z/rollback-{PERTURB_SALT + epoch}"))


def _scaled_updater(up, scale: float):
    """One layer updater scaled by ``scale``, or None when there is
    nothing to scale (frozen lr-0 layers).  ``Scheduled`` wrappers take the
    scale on the schedule's ``initial_lr`` (a pure multiplier in every
    schedule kind, so the whole trajectory scales); the plain updaters
    (``RmsProp``, ``Adam``, ``Sgd``, ``Nesterovs``, ``AdaGrad``) are frozen
    dataclasses with a ``learning_rate`` field, replaced."""
    sched = getattr(up, "schedule", None)
    if sched is not None and getattr(sched, "initial_lr", None):
        return dataclasses.replace(
            up, schedule=dataclasses.replace(
                sched, initial_lr=sched.initial_lr * scale))
    lr = getattr(up, "learning_rate", None)
    if not lr:  # absent or 0.0 (frozen)
        return None
    return dataclasses.replace(up, learning_rate=lr * scale)


def scale_graph_lr(graph, scale: float) -> int:
    """Multiply every trainable layer updater's learning rate by
    ``scale`` (frozen lr-0 layers stay frozen).  The updaters are frozen
    dataclasses, so each is REPLACED in the graph's table, never mutated.
    Returns the number of layer updaters rescaled; an updater whose shape
    defeats scaling is skipped with a warning (crashing the healing path
    over one exotic layer would be worse than a partial LR cut)."""
    updater = getattr(graph, "updater", None)
    if updater is None:
        return 0
    ups = updater.layer_updaters
    n = 0
    for name, up in list(ups.items()):
        try:
            scaled = _scaled_updater(up, scale)
        except Exception as e:
            _log.warning("rollback LR cut skipped layer %r (updater %r: %r)",
                         name, type(up).__name__, e)
            continue
        if scaled is None:
            continue
        ups[name] = scaled
        n += 1
    return n
