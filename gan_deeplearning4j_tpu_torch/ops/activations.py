"""Activation functions by DL4J name (torch twin of
``gan_deeplearning4j_tpu/ops/activations.py``): the names the DCGAN graphs
use plus the elementwise set the fused BN kernel compiles in.

Off bf16 each is torch's own op.  On a bf16 tensor (``--mp``) each follows
``jax.nn``'s definition op for op, each op rounded to bf16 as a JAX op on
a bf16 array is, and its derivative JAX's rule (``jax/_src/lax/lax.py``,
``jax.nn.softmax``'s custom JVP), where torch's fused kernels would round
once: tanh's ``(g + g*y) * (1 - y)``, the logistic's ``1 / (1 + exp(-x))``
with ``g * (y * (1 - y))``, elu through ``expm1``, softmax as ``exp(x -
max) / sum`` differentiated through, and Python constants rounded to the
dtype first (JAX's weak typing).

``tail_stable(name)`` is the activation for a value whose bits must not
depend on the size of the tensor it sits in (a fleet's tenant, on a shard
of 2 tenants or of 4: ``parallel/fleet.py``): torch's vectorized CPU
kernels for the logistic and elu round the elements past the last full
vector another way than the rest, so on the CPU those two take the
``exp`` / ``expm1`` forms above (which do not); elsewhere torch's own."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def identity(x):
    return x


def _weak(c: float, dtype: torch.dtype) -> float:
    """A Python constant as a JAX op on a ``dtype`` array sees it: weakly
    typed, so rounded to ``dtype`` first (0.01 is 0.010009765625 against
    bf16); torch would use it unrounded.  The identity for f32."""
    return float(torch.tensor(c, dtype=dtype))


def leaky_relu(x, alpha: float = 0.01):
    # jax.nn.leaky_relu: where(x >= 0, x, alpha * x)
    return torch.where(x >= 0, x, _weak(alpha, x.dtype) * x)


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        a = g * (1 - y)
        return a + a * y


class _Logistic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def tanh(x):
    if x.dtype != torch.bfloat16:
        return torch.tanh(x)
    return _Tanh.apply(x)


def sigmoid(x):
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return _Logistic.apply(x)


def _elu_expm1(x):
    # jax.nn.elu: where(x > 0, x, alpha * expm1(where(x > 0, 0, x))),
    # alpha 1; torch's expm1 derivative g * (y + 1) is JAX's rule
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x)))


def elu(x):
    if x.dtype != torch.bfloat16:
        return F.elu(x)
    return _elu_expm1(x)


def softmax(x):
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=-1)
    # jax.nn.softmax's form; its gradient is autodiff's through it, as
    # the JAX package's is (its reduce of the bf16 cotangent sums in f32
    # here)
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.sum(-1, keepdim=True)


_REGISTRY: dict[str, Activation] = {
    "identity": identity,
    "tanh": tanh,
    "sigmoid": sigmoid,
    "elu": elu,
    "relu": torch.relu,
    "leakyrelu": leaky_relu,
    "softmax": softmax,
}


_TAIL_STABLE_CPU: dict[str, Activation] = {"sigmoid": _Logistic.apply,
                                            "elu": _elu_expm1}


def tail_stable(name) -> Activation:
    """``get(name)``, but on a CPU tensor the logistic and elu in their
    ``exp`` / ``expm1`` forms (see the module docstring)."""
    act = get(name)
    cpu = _TAIL_STABLE_CPU.get(name.lower()) if isinstance(name, str) \
        else None
    if cpu is None:
        return act

    def stable(x):
        return cpu(x) if x.device.type == "cpu" else act(x)

    return stable


def get(name) -> Activation:
    if callable(name):
        return name
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; known: {sorted(_REGISTRY)}")
