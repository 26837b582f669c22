"""Upsampling2D — nearest-neighbour repeat — and the transposed
convolution (torch twin of ``gan_deeplearning4j_tpu/ops/upsample.py``).

The upsample forward is a plain repeat.  Its exact adjoint is the (sh, sw)
block sum of the cotangent, which the backward takes from ``ops.cuda.
upsample_bwd``: the CUDA kernel on the card, its plain version on the CPU.
The transposed convolution is cuDNN's, as the JAX package leaves it to
XLA's ``conv_general_dilated``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import upsample_bwd


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
        return upsample_bwd(g, ctx.sh, ctx.sw), None, None


def upsample2d(x: torch.Tensor,
               size: Union[int, Sequence[int]] = 2) -> torch.Tensor:
    """x: [B, C, H, W] -> [B, C, H*sh, W*sw] by nearest-neighbour repeat."""
    sh, sw = (size, size) if isinstance(size, int) else size
    return _Upsample2d.apply(x, int(sh), int(sw))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     stride: Sequence[int] = (2, 2),
                     padding: Sequence[int] = (0, 0)) -> torch.Tensor:
    """Transposed conv, x: [B, I, H, W] -> [B, O, (H-1)*sh - 2*ph + kh,
    (W-1)*sw - 2*pw + kw].  ``w`` is the JAX package's [O, I, kh, kw] (I
    input channels to O output channels); ``F.conv_transpose2d`` takes
    [I, O, kh, kw], so the two leading axes are swapped — a reshape to that
    shape would keep the numbers in the wrong places."""
    return F.conv_transpose2d(x, w.transpose(0, 1), b, stride=tuple(stride),
                              padding=tuple(padding))
