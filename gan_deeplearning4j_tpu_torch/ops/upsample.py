"""Upsampling2D — nearest-neighbour repeat (torch twin of
``gan_deeplearning4j_tpu/ops/upsample.py``).

The forward is a plain repeat.  Its exact adjoint is the (sh, sw) block
sum of the cotangent, which the backward takes from ``ops.cuda.
upsample_bwd``: the CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

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
