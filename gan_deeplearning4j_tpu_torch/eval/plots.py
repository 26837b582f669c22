"""Sample-grid mosaics of the roadmap families (torch twin of
``tile_grid`` and ``save_rgb_grid_png`` in ``gan_deeplearning4j_tpu/eval/
plots.py``).

``tile_grid`` is the JAX function's own copy.  The JAX renderer draws the
mosaic with matplotlib; this one writes the same ``tile_grid`` mosaic
itself, one PNG pixel per sample pixel, 8 bits per channel, with a small
stdlib encoder (``zlib`` + ``struct``): grayscale for one channel, RGB for
three.  A value v in ``value_range`` maps to round(255 * clip((v - lo) /
(hi - lo), 0, 1)); the 1-pixel gaps between tiles are 0.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np


def tile_grid(samples: np.ndarray, rows: int, cols: int,
              pad: int = 1) -> np.ndarray:
    """[n, H, W] -> one [rows*(H+pad), cols*(W+pad)] mosaic (row-major)."""
    n, h, w = samples.shape
    if n < rows * cols:
        raise ValueError(f"need {rows * cols} samples, got {n}")
    out = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad),
                   dtype=samples.dtype)
    for i in range(rows):
        for j in range(cols):
            out[i * (h + pad): i * (h + pad) + h,
                j * (w + pad): j * (w + pad) + w] = samples[i * cols + j]
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit PNG of ``img`` ([H, W] gray or [H, W, 3] RGB, uint8):
    filter 0 on every row, one IDAT chunk."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = b"".join(b"\x00" + rows[i].tobytes() for i in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def to_u8(x: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8, round half up."""
    return np.floor(np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def rgb_mosaic(samples: np.ndarray, sample_shape,
               grid_edge: Optional[int] = None,
               value_range=(-1.0, 1.0)) -> np.ndarray:
    """The mosaic ``save_rgb_grid_png`` writes, as uint8 [H', W'] (one
    channel) or [H', W', C]."""
    c, h, w = sample_shape
    arr = np.asarray(samples, dtype=np.float32).reshape(-1, c, h, w)
    lo, hi = value_range
    arr = np.clip((arr - lo) / (hi - lo), 0.0, 1.0)
    edge = grid_edge or int(round(np.sqrt(arr.shape[0])))
    mosaic = np.stack([tile_grid(arr[:, ch], edge, edge) for ch in range(c)],
                      axis=-1)
    return to_u8(mosaic[..., 0] if c == 1 else mosaic)


def save_rgb_grid_png(path: str, samples: np.ndarray, sample_shape,
                      grid_edge: Optional[int] = None,
                      value_range=(-1.0, 1.0)) -> str:
    """``samples`` [n, C*H*W], NCHW-flattened (the generators' flat output),
    ``sample_shape`` = (C, H, W), values in ``value_range`` (tanh heads give
    [-1, 1]) -> the mosaic PNG at ``path``."""
    data = png_bytes(rgb_mosaic(samples, sample_shape, grid_edge, value_range))
    with open(path, "wb") as f:
        f.write(data)
    return path
