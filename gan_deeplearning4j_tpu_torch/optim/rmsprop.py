"""RmsProp with DL4J's parameterization (torch twin of
``gan_deeplearning4j_tpu/optim/rmsprop.py``).

    cache  = rmsDecay * cache + (1 - rmsDecay) * g^2
    update = lr * g / sqrt(cache + eps)

eps sits INSIDE the sqrt, so ``torch.optim.RMSprop`` (eps outside) is a
different rule.  With the reference's rmsDecay = 1e-8 the update is about
lr * sign(g).  "Frozen" layers are lr 0.0.  The rule itself runs inside the
updater chain (``ops.cuda.fused_update``); this is the per-layer config.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RmsProp:
    """Per-layer updater config (DL4J constructor argument order)."""

    learning_rate: float = 0.001
    rms_decay: float = 1e-8
    epsilon: float = 1e-8

    def init_leaf(self, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)
