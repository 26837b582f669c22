"""Device resolution and the f32 parity switches.

Every entry point of the port (``ComputationGraph``, the trainer,
``cv_main``) resolves its device here: CUDA unless the caller asks for the
CPU, and a clear error — never a silent CPU run — when no card is present.
Resolving a CUDA device also turns TF32 off for cuDNN convolutions and
cuBLAS matmuls (cuDNN defaults to TF32), so the card computes the
reference's fixed float32, and keeps cuDNN to deterministic algorithms,
the fastest of them at each shape (timed at first use).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_f32_parity() -> None:
    """The one place the port sets the parity switches: TF32 off, and cuDNN
    restricted to deterministic algorithms (no atomics-ordered sums) and
    choosing among them by timing them at each shape's first use.  A step
    then gives the same bits on every run in a process, and the CUDA graph
    of a step the bits of the eager step; of the four policies
    ``train/cudnn_ab.py`` measures, this one is the fastest that does."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
