"""Dense (fully connected) op and dropout (torch twin of
``gan_deeplearning4j_tpu/ops/dense.py``).  W keeps DL4J's [n_in, n_out]
layout, so params carry between the packages unchanged.  ``bf16``: bf16
operands, the product rounded through bf16 and cast back to the input
dtype, then the bias added (the JAX op's order)."""

from __future__ import annotations

from typing import Optional

import torch


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None, *, bf16: bool = False
          ) -> torch.Tensor:
    """x: [B, F_in]; w: [F_in, F_out]; b: [F_out]."""
    if bf16:
        out = (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).to(x.dtype)
    else:
        out = x @ w
    if b is not None:
        out = out + b
    return out


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout.  rate 0.0 (the reference's unset DropoutLayer) is
    the identity and draws nothing."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
