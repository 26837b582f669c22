"""2-D convolution with DL4J semantics (torch twin of
``gan_deeplearning4j_tpu/ops/conv.py``, the math only).

NCHW data, OIHW weights, explicit symmetric padding, bias per output
channel, and DL4J's Truncate arithmetic out = floor((in + 2p - k)/s) + 1:
trailing rows and columns that do not fill a window are dropped, which is
what ``F.conv2d`` does too.  The discriminator's shape chain is
28 -> 12 -> (pool) 11 -> 4 -> (pool) 3, flattened to 128*3*3 = 1152.  The
JAX package's space-to-depth rewrites are TPU layout tricks and have no
counterpart here; the convolution itself is left to cuDNN, as the JAX
package leaves it to XLA.  ``bf16``: bf16 operands, the result rounded
through bf16 and cast back to the input dtype, then the bias added.  With
bf16 operands (``--bf16``, or ``--mp``'s bf16 activations) the bias is
never passed into ``F.conv2d``, which would add it before the rounding:
the JAX op rounds the convolution, then adds the bias in the input dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def conv2d_out_size(in_size: int, kernel: int, stride: int, pad: int) -> int:
    """DL4J Truncate-mode output size (floor division)."""
    return (in_size + 2 * pad - kernel) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: Sequence[int] = (1, 1),
           padding: Sequence[int] = (0, 0), *, bf16: bool = False
           ) -> torch.Tensor:
    """x: [B, C, H, W]; w: [O, I, kh, kw]; b: [O] or None."""
    if not bf16 and x.dtype != torch.bfloat16:
        return F.conv2d(x, w, b, stride=tuple(stride), padding=tuple(padding))
    lo = torch.bfloat16 if bf16 else x.dtype
    out = F.conv2d(x.to(lo), w.to(lo), stride=tuple(stride),
                   padding=tuple(padding)).to(x.dtype)
    return out if b is None else out + b.reshape(1, -1, 1, 1)
