"""Train-mode BatchNorm + activation over [B, F], single device.

Replaces ``fused_bn_act_train`` / ``_fused_kernel`` (the ``axis_name=None``
path) of ``gan_deeplearning4j_tpu/ops/pallas/bn_act.py``.  CUDA source:
``csrc/bn_act.cu``.

    mean = E[x], var = E[x^2] - mean^2        (biased, per feature)
    y    = act((x - mean) * rsqrt(var + eps) * gamma + beta)

Returns (y, mean, var).  Bound on the card: device memory, x read once and
y written once (8 bytes per element); on the protocol step that is the
generator's [200, 6272] BN (10.0 MB, 3.0 us at 3.35 TB/s), the classifier's
[200, 1024] and the generator's [200, 2] input BN.  The kernel gives each
thread one feature column, so a warp reads neighbouring addresses of each
row, and keeps both sums in registers: one kernel, no intermediate in
device memory.  The TPU kernel has no backward kernel and neither does this
one: the backward recomputes through the plain version under autograd, as
the JAX ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gan_deeplearning4j_tpu_torch.ops import activations as act_lib
from gan_deeplearning4j_tpu_torch.ops.cuda import build

# the kernel's compile-time activation set (csrc/bn_act.cu enum Act)
ACT_CODES = {"identity": 0, "tanh": 1, "sigmoid": 2, "relu": 3, "elu": 4,
             "leakyrelu": 5}

_ARGTYPES = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]


def bn_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float, act_name: str
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference composition (bn_act.py ``_reference``) in torch ops."""
    mean = torch.mean(x, dim=0)
    m2 = torch.mean(torch.square(x), dim=0)
    var = m2 - torch.square(mean)
    y = (x - mean[None]) * torch.rsqrt(var[None] + eps)
    y = y * gamma[None] + beta[None]
    return act_lib.get(act_name)(y), mean, var


def _launch(x, gamma, beta, eps, act_name):
    B, F = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(F, dtype=x.dtype, device=x.device)
    var = torch.empty(F, dtype=x.dtype, device=x.device)
    fn = build.function("bn_act", "gan4j_bn_act", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
              mean.data_ptr(), var.data_ptr(), B, F, eps,
              ACT_CODES[act_name], stream)
    build.check(code, "fused_bn_act_train")
    fused_bn_act_train.launches += 1
    return y, mean, var


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act_name):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.act_name = eps, act_name
        return _launch(x, gamma, beta, eps, act_name)

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta)]
            outs = bn_act_plain(*leaves, ctx.eps, ctx.act_name)
            grads = torch.autograd.grad(outs, leaves, (gy, gmean, gvar))
        return (*grads, None, None)


def fused_bn_act_train(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-5,
                       act_name: str = "identity"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (act(bn(x)), batch_mean, batch_var) for a 2-D f32 x.  A CPU x
    takes the plain version; a CUDA x launches the kernel."""
    if x.dim() != 2:
        raise ValueError(f"fused_bn_act_train takes [B, F], got {tuple(x.shape)}")
    F = x.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (F,) or t.device != x.device:
            raise ValueError(f"fused_bn_act_train: {name} {tuple(t.shape)} on "
                             f"{t.device} does not match x {tuple(x.shape)} "
                             f"on {x.device}")
    if not (x.dtype == gamma.dtype == beta.dtype == torch.float32):
        raise TypeError("fused_bn_act_train takes float32 only, got "
                        f"{x.dtype}/{gamma.dtype}/{beta.dtype}")
    name = act_name.lower()
    if x.device.type == "cpu":
        return bn_act_plain(x, gamma, beta, eps, name)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_act_train: unsupported device {x.device}")
    if name not in ACT_CODES:
        raise ValueError(f"fused_bn_act_train: activation {act_name!r} is not "
                         f"elementwise-fusable; known: {sorted(ACT_CODES)}")
    return _BnAct.apply(x.contiguous(), gamma.contiguous(),
                        beta.contiguous(), float(eps), name)


fused_bn_act_train.launches = 0
