"""Upsampling2D — nearest-neighbour repeat — and the transposed
convolution (torch twin of ``gan_deeplearning4j_tpu/ops/upsample.py``).

The upsample forward is a plain repeat.  Its exact adjoint is the (sh, sw)
block sum of the cotangent.  The backward routes it by the cotangent's
dtype, as the JAX package's ``supports_upsample_bwd`` does: an f32
cotangent takes ``ops.cuda.upsample_bwd`` (the CUDA kernel on the card, its
plain version on the CPU); any other (bf16 under ``--mp``) takes the plain
block sum in torch ops, as the JAX package's f32-only Pallas kernel leaves
it to XLA's reduce.
The transposed convolution is cuDNN's, as the JAX package leaves it to
XLA's ``conv_general_dilated``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import (
    supports_upsample_bwd,
    upsample_bwd,
)


class _Upsample2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh: int, sw: int):
        ctx.sh, ctx.sw = sh, sw
        # the repeat as a broadcast copy: no output size to work out on the
        # host, so a CUDA graph can record it
        B, C, H, W = x.shape
        return x[:, :, :, None, :, None].expand(B, C, H, sh, W, sw).reshape(
            B, C, H * sh, W * sw)

    @staticmethod
    def backward(ctx, g):
        sh, sw = ctx.sh, ctx.sw
        if supports_upsample_bwd(g.shape, sh, sw, g.dtype):
            return upsample_bwd(g, sh, sw), None, None
        # the JAX fallback's reduce: summed in f32, rounded once (jnp.sum
        # and torch's sum both accumulate a bf16 input in f32)
        B, C, Hs, Ws = g.shape
        return (g.reshape(B, C, Hs // sh, sh, Ws // sw, sw).sum((3, 5)),
                None, None)


def upsample2d(x: torch.Tensor,
               size: Union[int, Sequence[int]] = 2) -> torch.Tensor:
    """x: [B, C, H, W] -> [B, C, H*sh, W*sw] by nearest-neighbour repeat."""
    sh, sw = (size, size) if isinstance(size, int) else size
    return _Upsample2d.apply(x, int(sh), int(sw))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     stride: Sequence[int] = (2, 2),
                     padding: Sequence[int] = (0, 0), *, bf16: bool = False
                     ) -> torch.Tensor:
    """Transposed conv, x: [B, I, H, W] -> [B, O, (H-1)*sh - 2*ph + kh,
    (W-1)*sw - 2*pw + kw].  ``w`` is the JAX package's [O, I, kh, kw] (I
    input channels to O output channels); ``F.conv_transpose2d`` takes
    [I, O, kh, kw], so the two leading axes are swapped — a reshape to that
    shape would keep the numbers in the wrong places.  ``bf16``, and the
    bias with bf16 operands: as ``conv2d``'s (the bias after the
    rounding)."""
    if not bf16 and x.dtype != torch.bfloat16:
        return F.conv_transpose2d(x, w.transpose(0, 1), b,
                                  stride=tuple(stride), padding=tuple(padding))
    lo = torch.bfloat16 if bf16 else x.dtype
    out = F.conv_transpose2d(
        x.to(lo), w.transpose(0, 1).to(lo), stride=tuple(stride),
        padding=tuple(padding)).to(x.dtype)
    return out if b is None else out + b.reshape(1, -1, 1, 1)
