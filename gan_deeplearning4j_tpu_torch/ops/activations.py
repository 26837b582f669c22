"""Activation functions by DL4J name (torch twin of
``gan_deeplearning4j_tpu/ops/activations.py``): the names the DCGAN graphs
use plus the elementwise set the fused BN kernel compiles in."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def identity(x):
    return x


def leaky_relu(x, alpha: float = 0.01):
    # jax.nn.leaky_relu: where(x >= 0, x, alpha * x)
    return torch.where(x >= 0, x, alpha * x)


_REGISTRY: dict[str, Activation] = {
    "identity": identity,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "relu": torch.relu,
    "leakyrelu": leaky_relu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get(name) -> Activation:
    if callable(name):
        return name
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; known: {sorted(_REGISTRY)}")
