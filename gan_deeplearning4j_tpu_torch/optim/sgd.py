"""Sgd and Nesterovs, DL4J's plain and momentum updaters (torch twin of
``gan_deeplearning4j_tpu/optim/sgd.py``):

    Sgd:        update = lr * g
    Nesterovs:  v' = mu * v - lr * g
                update = mu * v - (1 + mu) * v'

(``param -= update`` is DL4J's ``param += -mu * v + (1 + mu) * v'``.)
Defaults are DL4J's: lr 0.1, momentum 0.9.  Sgd keeps a 0-d f32 zero as
its per-leaf state, Nesterovs the velocity, the JAX package's shapes and
dtypes (the model zips carry them).  Both follow the per-leaf protocol of
``optim/adam.py``, ``lr`` included, so ``Scheduled`` wraps them; plain
torch ops, as the JAX package runs them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Sgd:
    learning_rate: float = 0.1

    def init_leaf(self, p: torch.Tensor) -> torch.Tensor:
        # stateless: a 0-d zero keeps the state tree's shape uniform
        return torch.zeros((), dtype=torch.float32, device=p.device)

    def update_leaf(self, g: torch.Tensor, state: torch.Tensor,
                    lr=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(update, state); ``lr`` (a 0-d tensor) overrides the learning
        rate — ``Scheduled`` passes its scheduled rate."""
        lr = self.learning_rate if lr is None else lr
        return lr * g, state


@dataclasses.dataclass(frozen=True)
class Nesterovs:
    learning_rate: float = 0.1
    momentum: float = 0.9

    def init_leaf(self, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)

    def update_leaf(self, g: torch.Tensor, v: torch.Tensor,
                    lr=None) -> Tuple[torch.Tensor, torch.Tensor]:
        lr = self.learning_rate if lr is None else lr
        v_new = self.momentum * v - lr * g
        update = self.momentum * v - (1.0 + self.momentum) * v_new
        return update, v_new
