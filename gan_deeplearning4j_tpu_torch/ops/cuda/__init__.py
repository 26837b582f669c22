"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module each.

Each module holds the wrapper, the plain torch version of the same
function and a launch counter (an int attribute on the wrapper, raised by
one per kernel launch and nowhere else).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  Kernels build at
first use (build.py); importing this package compiles nothing.
``bn_apply_sums`` is a second entry of the apply kernel (it finishes the
moments from the all-reduced sums): its launches count as ``bn_apply``.
"""

from __future__ import annotations

from typing import Dict

from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
    bn_apply,
    bn_apply_sums,
    bn_moments,
    fused_bn_act_train,
)
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act_4d import fused_bn_act_train_4d
from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
    fused_rmsprop_chain,
    fused_rmsprop_chains,
)
from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import upsample_bwd

WRAPPERS = {
    "fused_update": fused_rmsprop_chains,
    "bn_act": fused_bn_act_train,
    "upsample_bwd": upsample_bwd,
    "bn_moments": bn_moments,
    "bn_apply": bn_apply,
    "bn_act_4d": fused_bn_act_train_4d,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["fused_bn_act_train", "fused_rmsprop_chain", "fused_rmsprop_chains",
           "upsample_bwd", "bn_moments", "bn_apply", "bn_apply_sums",
           "fused_bn_act_train_4d",
           "WRAPPERS", "reset_launch_counts", "launch_counts"]
