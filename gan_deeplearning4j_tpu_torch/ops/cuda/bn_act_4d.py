"""Train-mode per-channel BatchNorm + activation over [B, C, H, W].

Replaces ``fused_bn_act_train_4d`` / ``_fused_kernel_4d`` of
``gan_deeplearning4j_tpu/ops/pallas/bn_act.py``.  CUDA source:
``csrc/bn_act_4d.cu``.

    mean[c] = E[x[:, c]], var[c] = E[x[:, c]^2] - mean[c]^2   (biased)
    y       = act((x - mean) * rsqrt(var + eps) * gamma + beta)

Returns (y, mean[C], var[C]).  As in the JAX package it is an op with its
gradient and no caller on a model path: the BatchNorm layer sends only
2-D input to a kernel (the JAX ``graph/layers.py:298``), so every model's
4-D BNs — the DCGAN's C = 1 input BN, the CelebA-64 DCGAN's six — run
plain torch, as they run XLA there.  The TPU version falls
back to XLA when an 8-channel block exceeds VMEM (``supports_4d``); the
card's kernel takes every shape: a channel too large for its cluster's
shared memory takes the kernel's streamed branch, so there is no fallback.

Bound on the card: device memory, x read once and y written once (8 bytes
per element); at (128, 64, 32, 32) that is 67 MB, 20 us at 3.35 TB/s.  The
kernel is one launch that reads x once: each channel is split over a
thread-block cluster, kept in shared memory, reduced across the cluster
through distributed shared memory, and written from there
(``launch_plan`` sets the split).  The backward recomputes through the
plain version under autograd, as the JAX ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from gan_deeplearning4j_tpu_torch.ops import activations as act_lib
from gan_deeplearning4j_tpu_torch.ops.cuda import build
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
    ACT_CODES,
    MAX_DYNAMIC_SMEM,
    SMS,
    check_inputs,
    cluster_size,
    kernel_act,
    recompute_grads,
    sm_count,
)

_ARGTYPES = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
MAX_THREADS = 256  # csrc/bn_act_4d.cu kMaxThreads

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class Plan(NamedTuple):
    """How ``csrc/bn_act_4d.cu`` splits a [B, C, H, W] input (see
    launch_plan).  A unit is ``vec`` floats of one row of H*W."""

    cluster: int  # K blocks per channel
    units_per_block: int  # block rank r owns units [r*P, (r+1)*P) of B*H*W/vec
    threads: int
    vec: int  # 4: 16-byte loads and stores; 1: scalar
    grid: int  # C * K blocks
    smem_bytes: int  # dynamic shared memory: the block's units, 0 if streamed
    resident: bool  # False: the streamed branch reads x twice


def launch_plan(B: int, C: int, HW: int, data_ptr: int,
                sms: int = SMS) -> Plan:
    """The kernel's split of x [B, C, H, W] (HW = H*W): a cluster of K
    blocks per channel, each block a contiguous run of the channel's
    B*H*W elements in (b, hw) order, kept in shared memory (or streamed
    when the channel does not fit in K blocks).  ``data_ptr``: the
    addresses of x and y or-ed together; float4 units need both 16-byte
    aligned.  Small channels get fewer threads (at least 4 units each)
    rather than several channels per block."""
    vec = 4 if HW % 4 == 0 and data_ptr % 16 == 0 else 1
    units = B * HW // vec
    k = cluster_size(C, units, lambda k: -(-units // k) * vec * 4, sms)
    per_block = -(-units // k)
    smem = per_block * vec * 4
    resident = smem <= MAX_DYNAMIC_SMEM
    return Plan(cluster=k, units_per_block=per_block,
                threads=min(MAX_THREADS, 32 * -(-per_block // 128)), vec=vec,
                grid=C * k, smem_bytes=smem if resident else 0,
                resident=resident)


def bn_act_4d_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float, act_name: str) -> Triple:
    """The reference composition (bn_act.py ``_reference_4d``)."""
    mean = torch.mean(x, dim=(0, 2, 3))
    var = torch.mean(torch.square(x), dim=(0, 2, 3)) - torch.square(mean)
    y = (x - mean[None, :, None, None]) * torch.rsqrt(
        var[None, :, None, None] + eps)
    y = y * gamma[None, :, None, None] + beta[None, :, None, None]
    return act_lib.get(act_name)(y), mean, var


def _launch(x, gamma, beta, eps, act_name) -> Triple:
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(C, dtype=x.dtype, device=x.device)
    var = torch.empty(C, dtype=x.dtype, device=x.device)
    plan = launch_plan(B, C, H * W, x.data_ptr() | y.data_ptr(),
                       sm_count(x.device))
    fn = build.function("bn_act_4d", "gan4j_bn_act_4d", _ARGTYPES)
    code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
              mean.data_ptr(), var.data_ptr(), B, C, H * W, eps,
              ACT_CODES[act_name], plan.cluster, plan.units_per_block,
              plan.threads, plan.vec, plan.smem_bytes, int(plan.resident),
              torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fused_bn_act_train_4d")
    fused_bn_act_train_4d.launches += 1
    return y, mean, var


class _BnAct4d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act_name):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.act_name = eps, act_name
        return _launch(x, gamma, beta, eps, act_name)

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        grads = recompute_grads(ctx, (gy, gmean, gvar), bn_act_4d_plain,
                                ctx.eps, ctx.act_name)
        return (*grads, None, None)


def fused_bn_act_train_4d(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, eps: float = 1e-5,
                          act_name: str = "identity") -> Triple:
    """-> (act(bn(x)), mean[C], var[C]) for an f32 x [B, C, H, W].  A CPU x
    takes the plain version; a CUDA x launches the kernel."""
    check_inputs("fused_bn_act_train_4d", x, "B, C, H, W", gamma=gamma,
                 beta=beta)
    if x.device.type == "cpu":
        return bn_act_4d_plain(x, gamma, beta, eps, act_name.lower())
    name = kernel_act("fused_bn_act_train_4d", act_name)
    return _BnAct4d.apply(x.contiguous(), gamma.contiguous(),
                          beta.contiguous(), float(eps), name)


fused_bn_act_train_4d.launches = 0
