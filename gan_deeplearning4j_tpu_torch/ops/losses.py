"""The DL4J losses the DCGAN protocol uses and the WGAN-GP pair (torch twin
of ``gan_deeplearning4j_tpu/ops/losses.py``): sum over output units, mean
over the minibatch, on probabilities clipped at 1e-7.  ``nn.BCELoss`` is
not this function (it clamps the log at -100 instead)."""

from __future__ import annotations

import torch

_EPS = 1e-7


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with its gradient: max/min split the gradient in half where
    x sits exactly on a bound (a softmax saturated to 1.0 does), where
    torch.clamp would pass all of it.  The bounds are filled on x's device
    (a host tensor's copy could not be recorded into a CUDA graph)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def binary_xent(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """XENT on probabilities (post-sigmoid), as DL4J computes it."""
    p = _clip(probs, _EPS, 1.0 - _EPS)
    per_example = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return torch.mean(torch.sum(per_example, dim=-1))


def mcxent(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MCXENT on probabilities (post-softmax), labels one-hot."""
    p = _clip(probs, _EPS, 1.0)
    return torch.mean(-torch.sum(labels * torch.log(p), dim=-1))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum((pred - target) ** 2, dim=-1))


def wasserstein(critic_out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """WGAN critic loss: labels +1 for real, -1 for fake; minimize
    -label*D(x)."""
    return -torch.mean(critic_out * labels)


def gradient_penalty(critic_fn, real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """WGAN-GP penalty E[(||grad_x D(x_hat)||_2 - 1)^2] on the interpolates
    x_hat = alpha*real + (1-alpha)*fake, ``alpha`` [n, 1, ...] (or any
    shape of n elements) drawn U[0, 1) by the caller.

    The JAX package takes each example's gradient with ``vmap(grad)``; here
    one gradient of the summed critic output gives them all, which is the
    same only because ``critic_fn`` couples no examples (no BatchNorm, no
    MinibatchStdDev: ``GANPair`` checks).  ``create_graph`` keeps the
    penalty differentiable, so the caller's backward is the second-order
    one through the critic."""
    alpha = alpha.reshape((real.shape[0],) + (1,) * (real.dim() - 1)).to(
        real.dtype)
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic_fn(interp).sum(), interp,
                                   create_graph=True)
    norms = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                 dim=-1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


_REGISTRY = {"xent": binary_xent, "mcxent": mcxent, "mse": mse,
             "wasserstein": wasserstein}


def get(name):
    if callable(name):
        return name
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: {sorted(_REGISTRY)}")
