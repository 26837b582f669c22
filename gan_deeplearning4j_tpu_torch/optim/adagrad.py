"""AdaGrad, DL4J's ``org.nd4j.linalg.learning.config.AdaGrad`` (torch twin
of ``gan_deeplearning4j_tpu/optim/adagrad.py``):

    h' = h + g^2
    update = lr * g / sqrt(h' + eps)

Defaults are DL4J's: lr 0.1, eps 1e-6.  The per-leaf state is the squared
gradient history; the per-leaf protocol of ``optim/adam.py``, ``lr``
included, so ``Scheduled`` wraps it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdaGrad:
    learning_rate: float = 0.1
    epsilon: float = 1e-6

    def init_leaf(self, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)

    def update_leaf(self, g: torch.Tensor, h: torch.Tensor,
                    lr=None) -> Tuple[torch.Tensor, torch.Tensor]:
        lr = self.learning_rate if lr is None else lr
        h_new = h + g * g
        return lr * g * torch.rsqrt(h_new + self.epsilon), h_new
