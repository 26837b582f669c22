"""Weight initializers (torch twin of ``gan_deeplearning4j_tpu/ops/
initializers.py``).

DL4J ``WeightInit.XAVIER`` is a Gaussian N(0, 2/(fanIn+fanOut)), not
Glorot-uniform.  Draws come from an explicit ``torch.Generator``: the same
distribution as the JAX package, not the same bits (tests carry the JAX
params across instead).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def fan_in_out_conv(n_in: int, n_out: int, kernel: Sequence[int]) -> Tuple[int, int]:
    receptive = math.prod(kernel)
    return n_in * receptive, n_out * receptive


def xavier(gen: torch.Generator, shape: Sequence[int], fan_in: int,
           fan_out: int) -> torch.Tensor:
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device) * std


def xavier_uniform(gen: torch.Generator, shape: Sequence[int], fan_in: int,
                   fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                   device=gen.device)
    return u * (2 * limit) - limit


def zeros(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32)


def ones(shape: Sequence[int]) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32)
