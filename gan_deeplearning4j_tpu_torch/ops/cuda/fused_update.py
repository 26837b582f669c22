"""The RmsProp update chain of one leaf: L2, clip, cache EMA, scaled step.

Replaces ``fused_rmsprop_chain`` / ``_chain_kernel`` of
``gan_deeplearning4j_tpu/ops/pallas/fused_update.py``.  CUDA source:
``csrc/fused_update.cu``.

    g  = clip(g + l2*p, +-clip)       # l2 only on W leaves (the caller's)
    c' = rho*c + (1-rho)*g^2
    p' = p - lr*g*rsqrt(c' + eps)

Bound on the card: device memory, 20 bytes per element (read p, g, c; write
p', c'); the DCGAN protocol step moves about 217 MB through it, 65 us at
3.35 TB/s.  The kernel is one grid-stride pass per leaf that touches each
byte once.  Every RmsProp leaf takes it on the card: the TPU package's
64K-element gate (a tile-padding threshold) is not carried over, since a
small leaf on plain torch would cost about six launches instead of one.
Out of place, so a leaf aliased by a weight sync keeps its old value.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gan_deeplearning4j_tpu_torch.ops.cuda import build

_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]


def rmsprop_chain_plain(p: torch.Tensor, g: torch.Tensor, c: torch.Tensor, *,
                        lr: float, rho: float, eps: float, l2: float = 0.0,
                        clip: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same chain in plain torch ops, in the kernel's order."""
    if l2:
        g = g + l2 * p
    if clip is not None:
        g = torch.clamp(g, -clip, clip)
    c2 = rho * c + (1.0 - rho) * g * g
    return p - lr * g * torch.rsqrt(c2 + eps), c2


def fused_rmsprop_chain(p: torch.Tensor, g: torch.Tensor, c: torch.Tensor, *,
                        lr: float, rho: float, eps: float, l2: float = 0.0,
                        clip: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p', c') for one f32 leaf of any shape.  A CPU leaf takes the plain
    version; a CUDA leaf launches the kernel."""
    for name, t in (("g", g), ("cache", c)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"fused_rmsprop_chain: {name} {tuple(t.shape)} on "
                             f"{t.device} does not match p {tuple(p.shape)} "
                             f"on {p.device}")
    if p.dtype != torch.float32 or g.dtype != p.dtype or c.dtype != p.dtype:
        raise TypeError(f"fused_rmsprop_chain takes float32 only, got "
                        f"{p.dtype}/{g.dtype}/{c.dtype}")
    if p.device.type == "cpu":
        return rmsprop_chain_plain(p, g, c, lr=lr, rho=rho, eps=eps, l2=l2,
                                   clip=clip)
    if p.device.type != "cuda":
        raise ValueError(f"fused_rmsprop_chain: unsupported device {p.device}")
    p, g, c = p.contiguous(), g.contiguous(), c.contiguous()
    p_out, c_out = torch.empty_like(p), torch.empty_like(c)
    fn = build.function("fused_update", "gan4j_fused_rmsprop", _ARGTYPES)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    code = fn(p.data_ptr(), g.data_ptr(), c.data_ptr(), p_out.data_ptr(),
              c_out.data_ptr(), p.numel(), lr, rho, 1.0 - rho, eps, l2,
              0.0 if clip is None else clip, int(clip is not None), stream)
    build.check(code, "fused_rmsprop_chain")
    fused_rmsprop_chain.launches += 1
    return p_out, c_out


fused_rmsprop_chain.launches = 0
