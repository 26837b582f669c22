"""Adam with the standard bias-corrected rule (torch twin of
``gan_deeplearning4j_tpu/optim/adam.py``), DL4J's ``Adam`` updater:

    m = b1*m + (1-b1)*g        mhat = m / (1 - b1^t)
    v = b2*v + (1-b2)*g^2      vhat = v / (1 - b2^t)
    update = lr * mhat / (sqrt(vhat) + eps)

The per-leaf state is ``{"m", "v", "t"}`` with ``t`` a 0-d f32 tensor, the
JAX package's keys and dtypes (the model zips and checkpoints carry them).
Every op runs on the leaf's device with no host read, so a CUDA graph can
record the update.  The JAX package computes this outside any Pallas
kernel, and so does the port: plain torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_leaf(self, p: torch.Tensor) -> State:
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p),
                "t": torch.zeros((), dtype=torch.float32, device=p.device)}

    def update_leaf(self, g: torch.Tensor, state: State,
                    lr=None) -> Tuple[torch.Tensor, State]:
        """(update, new state); ``lr`` (a 0-d tensor) overrides the
        learning rate — ``Scheduled`` passes its scheduled rate."""
        lr = self.learning_rate if lr is None else lr
        t = state["t"] + 1.0
        m = self.beta1 * state["m"] + (1.0 - self.beta1) * g
        v = self.beta2 * state["v"] + (1.0 - self.beta2) * g * g
        mhat = m / (1.0 - torch.pow(self.beta1, t))
        vhat = v / (1.0 - torch.pow(self.beta2, t))
        update = lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        return update, {"m": m, "v": v, "t": t}
