"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module each.

Each module holds the wrapper, the plain torch version of the same
function and a launch counter (an int attribute on the wrapper, raised by
one per kernel launch and nowhere else).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  Kernels build at
first use (build.py); importing this package compiles nothing.
``bn_apply_sums`` is a second entry of the apply kernel (it finishes the
moments from the all-reduced sums): its launches count as ``bn_apply``.
``bn_act_tenants`` is the fleet's tenant-batched BN (a second kernel of
``csrc/bn_act.cu``), counted apart from the [B, F] ``bn_act``, and
``bn_act_tenants_bwd`` its backward (a third).
A wrapper called while a CUDA graph captures records its kernel instead
of launching it: ``captured_launches`` takes those calls back off the
counters, and ``add_launches`` counts them once per replay.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
    bn_apply,
    bn_act_tenants_bwd,
    bn_apply_sums,
    bn_moments,
    fused_bn_act_train,
    fused_bn_act_train_tenants,
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
    "bn_act_tenants": fused_bn_act_train_tenants,
    "bn_act_tenants_bwd": bn_act_tenants_bwd,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


@contextlib.contextmanager
def captured_launches() -> Iterator[Dict[str, int]]:
    """The counters' graphed mode, part one: the wrapper calls inside the
    block are recorded into a CUDA graph (stream capture), not launched.
    Yields a dict that holds, once the block ends, each kernel's launches
    per replay of the graph; the counters themselves are put back as they
    were before the block."""
    before = launch_counts()
    seen: Dict[str, int] = {}
    try:
        yield seen
    finally:
        after = launch_counts()
        seen.update({name: after[name] - n for name, n in before.items()})
        for name, fn in WRAPPERS.items():
            fn.launches = before[name]


def add_launches(per_replay: Dict[str, int], replays: int) -> None:
    """Part two: ``replays`` replays of a graph launched each kernel
    ``per_replay[name]`` times apiece."""
    for name, n in per_replay.items():
        WRAPPERS[name].launches += n * replays


__all__ = ["fused_bn_act_train", "fused_rmsprop_chain", "fused_rmsprop_chains",
           "upsample_bwd", "bn_moments", "bn_apply", "bn_apply_sums",
           "fused_bn_act_train_4d", "fused_bn_act_train_tenants",
           "bn_act_tenants_bwd",
           "WRAPPERS", "reset_launch_counts", "launch_counts",
           "captured_launches", "add_launches"]
