"""Device resolution, the f32 parity switches and the precision policy.

Every entry point of the port (``ComputationGraph``, the trainer,
``cv_main``) resolves its device here: CUDA unless the caller asks for the
CPU, and a clear error — never a silent CPU run — when no card is present.
Resolving a CUDA device also turns TF32 off for cuDNN convolutions and
cuBLAS matmuls (cuDNN defaults to TF32), so the card computes the
reference's fixed float32, and keeps cuDNN to deterministic algorithms,
the fastest of them at each shape (timed at first use).

The precision policy is the JAX package's ``RuntimeConfig`` pair (torch
twin of ``gan_deeplearning4j_tpu/runtime/backend.py:101-173``), both off by
default (parity mode):
  - ``matmul_bf16`` (``--bf16``): every Dense, Output, Conv2D and
    ConvTranspose2D layer whose ``bf16_matmul`` is None casts both operands
    to bf16, rounds the product through bf16 and casts it back before the
    bias is added (``graph/layers.py`` ``_mxu_bf16``);
  - ``compute_bf16`` (``--mp``): the graph's forward runs on bf16 inputs,
    params and activations, BatchNorm and ConditionalBatchNorm carved out
    (f32 params and input), the loss in f32 (``graph/graph.py``).
The policy is read when a step is built (the JAX package reads it at
trace time), so set it before any graph or step is made.  TF32 stays off
in every mode: the JAX package has no TF32 mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The JAX ``RuntimeConfig``'s precision fields (the rest are TPU
    switches, or live elsewhere in the port: the device in
    ``resolve_device``, the seed in each model config)."""

    # bfloat16 operands into every contraction (conv, transposed conv,
    # dense); params/activations stay float32
    matmul_bf16: bool = False
    # full mixed precision: bf16 params/activations in forward and
    # backward; master params, optimizer state, BN and the loss stay f32
    compute_bf16: bool = False


_config = RuntimeConfig()

BF16_HELP = (
    "bfloat16 operands into every MXU contraction (conv, transposed conv, "
    "dense); params/activations stay float32, each op's result is rounded "
    "through bf16 once (the MXU accumulates partial products in f32 "
    "internally). Faster; deviates from the reference's fixed float32 "
    "numerics — see RESULTS.md for the measured speed/quality trade."
)


def add_bf16_flag(parser) -> None:
    """Register the shared --bf16 CLI flag (one help text, no drift)."""
    parser.add_argument("--bf16", action="store_true", help=BF16_HELP)


MP_HELP = (
    "full mixed precision (the TPU fast mode): forward/backward in "
    "bfloat16 params/activations with float32 master params, optimizer "
    "state, batch-norm statistics and loss.  Implies nothing about "
    "--bf16 (combine them for the fastest path).  Deviates further from "
    "the reference's fixed float32 numerics — quality spot-check in "
    "RESULTS.md."
)


def add_mp_flag(parser) -> None:
    """Register the shared --mp (compute_bf16) CLI flag."""
    parser.add_argument("--mp", action="store_true", help=MP_HELP)


def configure(**kwargs) -> RuntimeConfig:
    """Set global precision options (``matmul_bf16``, ``compute_bf16``)."""
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config


def config() -> RuntimeConfig:
    return _config


@contextlib.contextmanager
def configured(cfg: Optional[RuntimeConfig] = None,
               **kwargs) -> Iterator[RuntimeConfig]:
    """Run a block under ``cfg`` (default: the current config) with
    ``kwargs`` replaced, and put the previous config back after it."""
    global _config
    prev = _config
    _config = dataclasses.replace(prev if cfg is None else cfg, **kwargs)
    try:
        yield _config
    finally:
        _config = prev


def flag_policy(args) -> dict:
    """The JAX mains' handling of parsed ``--bf16`` / ``--mp``: a given flag
    turns its setting on, an absent one leaves it as configured."""
    out = {}
    if getattr(args, "bf16", False):
        out["matmul_bf16"] = True
    if getattr(args, "mp", False):
        out["compute_bf16"] = True
    return out


def set_f32_parity() -> None:
    """The one place the port sets the parity switches: TF32 off, and cuDNN
    restricted to deterministic algorithms (no atomics-ordered sums) and
    choosing among them by timing them at each shape's first use.  A step
    then gives the same bits on every run in a process, and the CUDA graph
    of a step the bits of the eager step; of the four policies
    ``train/cudnn_ab.py`` measures, this one is the fastest that does.
    The same in every precision mode; a bf16 GEMM sums its products in
    f32 (cuBLAS may otherwise reduce in bf16), as the JAX modes do."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = True


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for (explicitly
    or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default — pass device='cpu' (or --device cpu) to run its "
                "plain torch versions on the CPU")
        set_f32_parity()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
