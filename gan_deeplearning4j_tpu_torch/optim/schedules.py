"""Learning-rate schedules, DL4J's ``ISchedule`` set (torch twin of
``gan_deeplearning4j_tpu/optim/schedules.py``).

A schedule is a frozen dataclass called as ``t -> lr`` on a 0-d f32
tensor.  ``Scheduled`` lifts any per-leaf updater into a scheduled one:
its state is ``{"t": int32 0-d tensor, "inner": base state}``, and each
step runs the base rule at ``schedule(t)``, so the scheduled rate enters
the base rule's own recurrence (the JAX package's keys and dtypes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StepSchedule:
    """lr * decay^floor(t / step) — DL4J StepSchedule."""

    initial_lr: float
    decay_rate: float
    step: float

    def __call__(self, t):
        return self.initial_lr * torch.pow(
            self.decay_rate, torch.floor(t / self.step))


@dataclasses.dataclass(frozen=True)
class ExponentialSchedule:
    """lr * gamma^t — DL4J ExponentialSchedule."""

    initial_lr: float
    gamma: float

    def __call__(self, t):
        return self.initial_lr * torch.pow(self.gamma, t)


@dataclasses.dataclass(frozen=True)
class PolySchedule:
    """lr * (1 - t/max_iter)^power — DL4J PolySchedule."""

    initial_lr: float
    power: float
    max_iter: float

    def __call__(self, t):
        frac = torch.clamp(1.0 - t / self.max_iter, 0.0, 1.0)
        return self.initial_lr * torch.pow(frac, self.power)


@dataclasses.dataclass(frozen=True)
class SigmoidSchedule:
    """lr / (1 + exp(-gamma * (t - step))) — DL4J SigmoidSchedule (a
    negative gamma decays)."""

    initial_lr: float
    gamma: float
    step: float

    def __call__(self, t):
        return self.initial_lr / (
            1.0 + torch.exp(-self.gamma * (t - self.step)))


@dataclasses.dataclass(frozen=True)
class Scheduled:
    """A per-leaf updater whose learning rate follows ``schedule``."""

    base: object
    schedule: object

    @property
    def learning_rate(self) -> float:
        """The schedule's t = 0 value (the JAX ``lr_for`` summary)."""
        return float(self.schedule(torch.zeros((), dtype=torch.float32)))

    def init_leaf(self, p: torch.Tensor) -> Dict:
        return {"t": torch.zeros((), dtype=torch.int32, device=p.device),
                "inner": self.base.init_leaf(p)}

    def update_leaf(self, g: torch.Tensor, state: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
        lr = self.schedule(state["t"].to(torch.float32))
        update, inner = self.base.update_leaf(g, state["inner"], lr=lr)
        return update, {"t": state["t"] + 1, "inner": inner}
