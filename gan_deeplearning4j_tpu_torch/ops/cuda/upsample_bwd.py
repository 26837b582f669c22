"""Backward of the nearest-neighbour upsample: the (sh, sw) block sum.

Replaces ``upsample_bwd_dma`` / ``_bwd_kernel`` of
``gan_deeplearning4j_tpu/ops/pallas/dma_pipeline.py``.  CUDA source:
``csrc/upsample_bwd.cu``.

    dx[b, c, h, w] = sum_{i<sh, j<sw} g[b, c, h*sh + i, w*sw + j]

Bound on the card: device memory, g read once and dx written once.  On the
protocol step's G-step backward that is [200,128,14,14] -> [200,128,7,7]
(25.1 MB, 7.5 us at 3.35 TB/s) and [200,64,28,28] -> [200,64,14,14]
(50.2 MB, 15.0 us).  One thread per dx element sums its block in row-major
order; the TPU kernel's double-buffered DMA and 0/1-matrix dot are TPU
artifacts and are dropped.
"""

from __future__ import annotations

import ctypes

import torch

from gan_deeplearning4j_tpu_torch.ops.cuda import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def supports_upsample_bwd(g_shape, sh: int, sw: int, dtype) -> bool:
    """True iff the kernel takes this cotangent: f32, 4-D, each spatial
    dim a multiple of its factor (the JAX package's ``supports_upsample_bwd``
    without its TPU VMEM tiling test, which this kernel does not have).
    ``_Upsample2d.backward`` routes by it: a bf16 cotangent (``--mp``)
    takes the plain block sum, as the JAX package's does."""
    return (dtype == torch.float32 and len(g_shape) == 4
            and g_shape[2] % sh == 0 and g_shape[3] % sw == 0)


def upsample_bwd_plain(g: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """The block sum in plain torch ops, in the kernel's row-major order."""
    out = None
    for i in range(sh):
        for j in range(sw):
            part = g[:, :, i::sh, j::sw]
            out = part if out is None else out + part
    return out.contiguous()


def upsample_bwd(g: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """dx[B,C,H,W] from g[B,C,H*sh,W*sw] (f32).  A CPU g takes the plain
    version; a CUDA g launches the kernel."""
    if g.dim() != 4 or g.shape[2] % sh or g.shape[3] % sw:
        raise ValueError(f"upsample_bwd: g {tuple(g.shape)} is not a "
                         f"[B, C, H*{sh}, W*{sw}] cotangent")
    if g.dtype != torch.float32:
        raise TypeError(f"upsample_bwd takes float32 only, got {g.dtype}")
    if g.device.type == "cpu":
        return upsample_bwd_plain(g, sh, sw)
    if g.device.type != "cuda":
        raise ValueError(f"upsample_bwd: unsupported device {g.device}")
    g = g.contiguous()
    B, C, Hs, Ws = g.shape
    H, W = Hs // sh, Ws // sw
    dx = torch.empty((B, C, H, W), dtype=g.dtype, device=g.device)
    fn = build.function("upsample_bwd", "gan4j_upsample_bwd", _ARGTYPES)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    code = fn(g.data_ptr(), dx.data_ptr(), B * C, H, W, sh, sw, stream)
    build.check(code, "upsample_bwd")
    upsample_bwd.launches += 1
    return dx


upsample_bwd.launches = 0
