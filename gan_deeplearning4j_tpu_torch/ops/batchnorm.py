"""Batch normalization with explicit (gamma, beta, mean, var) state (torch
twin of ``gan_deeplearning4j_tpu/ops/batchnorm.py``).

The running statistics are params that the weight syncs copy between
graphs, so they are passed in and returned, never hidden in a module
buffer.  The batch variance is the biased E[x^2] - E[x]^2 and the running
update is decay*running + (1-decay)*batch — not ``F.batch_norm``'s running
update, which takes the unbiased variance.  2-D input normalizes per
feature, 4-D input [B, C, H, W] per channel.  The ``_cond`` pair takes a
per-sample gamma/beta [B, C] (conditional BN).  With a data-parallel group
the batch statistics are the global batch's (sync-BN).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gan_deeplearning4j_tpu_torch.parallel import mesh

DEFAULT_DECAY = 0.9
DEFAULT_EPS = 1e-5


def _reduce_dims(x: torch.Tensor) -> Tuple[int, ...]:
    if x.dim() == 2:
        return (0,)
    if x.dim() == 4:
        return (0, 2, 3)
    raise ValueError(f"batchnorm expects 2-D or 4-D input, got shape {tuple(x.shape)}")


def _shaped(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        return p.reshape(1, -1)
    return p.reshape(1, -1, 1, 1)


def batch_norm_train(x, gamma, beta, running_mean, running_var,
                     decay: float = DEFAULT_DECAY, eps: float = DEFAULT_EPS,
                     group: Optional[mesh.DataGroup] = None):
    """Returns (out, new_running_mean, new_running_var).

    ``group``: x is this rank's rows, and E[x], E[x^2] are averaged over the
    ranks (differentiably) before var = E[x^2] - E[x]^2, so a data-parallel
    step normalizes as the single-device step on the whole batch does,
    between-rank spread of the means included."""
    dims = _reduce_dims(x)
    mean = torch.mean(x, dim=dims)
    m2 = torch.mean(torch.square(x), dim=dims)
    if group is not None:
        stats = mesh.all_reduce_mean_diff(torch.stack([mean, m2]), group)
        mean, m2 = stats[0], stats[1]
    var = m2 - torch.square(mean)
    out = (x - _shaped(mean, x)) * torch.rsqrt(_shaped(var, x) + eps)
    out = out * _shaped(gamma, x) + _shaped(beta, x)
    new_mean = decay * running_mean + (1.0 - decay) * mean
    new_var = decay * running_var + (1.0 - decay) * var
    return out, new_mean, new_var


def batch_norm_inference(x, gamma, beta, running_mean, running_var,
                         eps: float = DEFAULT_EPS) -> torch.Tensor:
    out = (x - _shaped(running_mean, x)) * torch.rsqrt(_shaped(running_var, x) + eps)
    return out * _shaped(gamma, x) + _shaped(beta, x)


def _shaped_per_sample(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-sample scale/shift [B, C] broadcast against x."""
    if x.dim() == 2:
        return p
    return p.reshape(p.shape[0], p.shape[1], 1, 1)


def batch_norm_train_cond(x, gamma_b, beta_b, running_mean, running_var,
                          decay: float = DEFAULT_DECAY,
                          eps: float = DEFAULT_EPS,
                          group: Optional[mesh.DataGroup] = None):
    """Conditional BN (Dumoulin et al. 2017): batch-stat normalization with
    per-sample gamma/beta [B, C] (selected upstream by the condition).  The
    statistics are class-agnostic, one running mean/var as in plain BN;
    only the affine is conditioned.  Returns (out, new_mean, new_var)."""
    dims = _reduce_dims(x)
    mean = torch.mean(x, dim=dims)
    m2 = torch.mean(torch.square(x), dim=dims)
    if group is not None:
        stats = mesh.all_reduce_mean_diff(torch.stack([mean, m2]), group)
        mean, m2 = stats[0], stats[1]
    var = m2 - torch.square(mean)
    out = (x - _shaped(mean, x)) * torch.rsqrt(_shaped(var, x) + eps)
    out = out * _shaped_per_sample(gamma_b, x) + _shaped_per_sample(beta_b, x)
    new_mean = decay * running_mean + (1.0 - decay) * mean
    new_var = decay * running_var + (1.0 - decay) * var
    return out, new_mean, new_var


def batch_norm_inference_cond(x, gamma_b, beta_b, running_mean, running_var,
                              eps: float = DEFAULT_EPS) -> torch.Tensor:
    out = (x - _shaped(running_mean, x)) * torch.rsqrt(
        _shaped(running_var, x) + eps)
    return out * _shaped_per_sample(gamma_b, x) + _shaped_per_sample(beta_b, x)
