"""Max pooling (torch twin of ``gan_deeplearning4j_tpu/ops/pool.py``).

The reference's pools are 2x2 with stride 1 (each spatial dim shrinks by
one).  The backward sends each output's gradient to the FIRST window
element equal to the maximum, in row-major window order — the JAX
package's rule (select-and-scatter's tie order).  ``F.max_pool2d`` records
that same element as its index (its scan replaces the running maximum only
on a strictly greater value), so its backward follows the rule;
tests/test_torch_ops.py pins it with tied inputs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel: Sequence[int] = (2, 2),
               stride: Sequence[int] = (2, 2),
               padding: Sequence[int] = (0, 0)) -> torch.Tensor:
    """x: [B, C, H, W]; DL4J Truncate (VALID after explicit padding)."""
    return F.max_pool2d(x, tuple(kernel), tuple(stride), tuple(padding))
