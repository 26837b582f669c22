"""Grid renderings: the sample-grid mosaics of every program and the
reference's single-lattice pictures (torch twin of ``tile_grid``,
``save_grid_png``, ``save_lattice_example_pngs`` and ``save_rgb_grid_png``
in ``gan_deeplearning4j_tpu/eval/plots.py``).

``tile_grid`` is the JAX function's own copy.  The JAX renderers draw with
matplotlib, which the card's host does not have; these write the same
arrays themselves with a small stdlib encoder (``zlib`` + ``struct``), 8
bits per channel: grayscale for one channel, RGB for three.
  - ``save_rgb_grid_png``: one PNG pixel per sample pixel; a value v in
    ``value_range`` maps to round(255 * clip((v - lo) / (hi - lo), 0, 1));
    the 1-pixel gaps between tiles are 0.
  - ``save_grid_png`` (``DCGAN_Generated_Images.png``,
    ``DCGAN_Generated_Lattices.png``): the ``tile_grid`` mosaic scaled to
    [0, 1] over its own range (matplotlib's ``imshow`` default), blown up
    by nearest neighbour by an integer factor (``grid_scale``).
  - ``save_lattice_example_pngs``: one lattice as a gray blow-up, and as a
    viridis heatmap with each cell's value written in it (a 3x5 bitmap
    font of digits, ``.``, ``-`` and the letters of ``nan`` and ``inf``)
    and a colour bar.
A non-finite value (a diverged run's) is drawn as matplotlib draws its
masked cells over a white page: white, and left out of the range the
finite values are scaled over.  The pixels are not matplotlib's; the
files' names and the arrays they show are the JAX renderers'.
``read_png`` reads back what ``png_bytes`` writes.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

# matplotlib's viridis colormap, its 256 entries rounded to 8 bits (RGB)
_VIRIDIS_HEX = (
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725")
VIRIDIS = np.frombuffer(bytes.fromhex("".join(_VIRIDIS_HEX)),
                        np.uint8).reshape(256, 3)

# a 3x5 bitmap font: five rows of three bits a glyph, the top row first
_GLYPHS = {
    "0": (7, 5, 5, 5, 7), "1": (2, 6, 2, 2, 7), "2": (7, 1, 7, 4, 7),
    "3": (7, 1, 7, 1, 7), "4": (5, 5, 7, 1, 1), "5": (7, 4, 7, 1, 7),
    "6": (7, 4, 7, 5, 7), "7": (7, 1, 1, 1, 1), "8": (7, 5, 7, 5, 7),
    "9": (7, 5, 7, 1, 7), ".": (0, 0, 0, 0, 2), "-": (0, 0, 7, 0, 0),
    "n": (0, 0, 6, 5, 5), "a": (0, 0, 3, 5, 7), "i": (2, 0, 2, 2, 2),
    "f": (3, 2, 7, 2, 2)}
GRID_LONG_SIDE = 1200  # the grid PNG's long side, about, in pixels
LATTICE_CELL = 80      # a lattice cell's side in the example PNGs
FONT_SCALE = 3         # a font pixel's side


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


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray or RGB PNG of filter-0 rows (what ``png_bytes``
    writes) -> [H, W] or [H, W, 3] uint8.  Raises ``ValueError`` on a
    file that is not one, or on a chunk whose CRC is wrong."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    if hdr is None or hdr[2] != 8 or hdr[3] not in (0, 2):
        raise ValueError(f"{path}: not an 8-bit gray or RGB PNG ({hdr})")
    w, h, _, color = hdr[:4]
    ch = 1 if color == 0 else 3
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a row's filter is not 0")
    img = raw[:, 1:]
    return img if ch == 1 else img.reshape(h, w, 3)


def to_u8(x: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8, round half up; NaN -> 255 (white)."""
    x = np.where(np.isnan(x), 1.0, x)
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


def _matrix(grid_csv_or_array) -> np.ndarray:
    if isinstance(grid_csv_or_array, str):
        from gan_deeplearning4j_tpu_torch.data.csv import read_csv_matrix

        return read_csv_matrix(grid_csv_or_array)
    return np.asarray(grid_csv_or_array)


def grid_mosaic(grid_csv_or_array, sample_shape,
                grid_edge: Optional[int] = None) -> np.ndarray:
    """The ``tile_grid`` mosaic of a trainer grid dump ([n, H*W] rows, or
    the ``{name}_out_{k}.csv`` path), as the JAX renderer tiles it."""
    arr = _matrix(grid_csv_or_array)
    h, w = sample_shape
    edge = grid_edge or int(round(np.sqrt(arr.shape[0])))
    return tile_grid(arr.reshape(arr.shape[0], h, w), edge, edge)


def finite_range(a: np.ndarray) -> tuple:
    """(min, max) of ``a``'s finite values; (nan, nan) when it has none."""
    f = np.asarray(a, dtype=np.float64)
    f = f[np.isfinite(f)]
    return (float(f.min()), float(f.max())) if f.size else (np.nan, np.nan)


def normalize(a: np.ndarray) -> np.ndarray:
    """``a`` over the range of its finite values to [0, 1] (0 where they
    are constant); NaN where ``a`` is not finite."""
    a = np.asarray(a, dtype=np.float64)
    lo, hi = finite_range(a)
    out = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    return np.where(np.isfinite(a), out, np.nan)


def grid_scale(mosaic: np.ndarray) -> int:
    """The blow-up factor of a grid PNG: ~``GRID_LONG_SIDE`` on the long
    side, at least 1."""
    return max(1, GRID_LONG_SIDE // max(mosaic.shape))


def blow_up(img: np.ndarray, k: int) -> np.ndarray:
    """Nearest-neighbour blow-up of an image's first two axes by ``k``."""
    return np.repeat(np.repeat(img, k, axis=0), k, axis=1)


def grid_image(grid_csv_or_array, sample_shape,
               grid_edge: Optional[int] = None) -> np.ndarray:
    """The uint8 gray image ``save_grid_png`` writes."""
    mosaic = grid_mosaic(grid_csv_or_array, sample_shape, grid_edge)
    return blow_up(to_u8(normalize(mosaic)), grid_scale(mosaic))


def _write(path: str, img: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(png_bytes(img))
    return path


def save_grid_png(path: str, grid_csv_or_array, sample_shape,
                  grid_edge: Optional[int] = None) -> str:
    """A trainer grid dump as a PNG mosaic.  ``sample_shape``: (H, W) of
    one sample (28, 28 for MNIST; 4, 3 for the insurance lattices);
    ``grid_edge``: the mosaic's edge (default sqrt of the sample count)."""
    return _write(path, grid_image(grid_csv_or_array, sample_shape,
                                   grid_edge))


def text_width(text: str) -> int:
    return max(0, 4 * len(text) - 1) * FONT_SCALE


def draw_text(img: np.ndarray, text: str, top: int, left: int,
              color) -> None:
    """``text`` (the glyphs of ``_GLYPHS``) into ``img`` [H, W, 3] at (top,
    left), each font pixel ``FONT_SCALE`` pixels wide, one blank column
    between glyphs."""
    k = FONT_SCALE
    for n, ch in enumerate(text):
        for r, bits in enumerate(_GLYPHS[ch]):
            for c in range(3):
                if bits >> (2 - c) & 1:
                    y, x = top + r * k, left + (4 * n + c) * k
                    img[y:y + k, x:x + k] = color


def lattice_images(grid_csv_or_array, sample_shape=(4, 3),
                   index: int = 0) -> tuple:
    """The two uint8 images of ``save_lattice_example_pngs``: the raw gray
    blow-up [H*cell, W*cell] and the annotated heatmap [.., .., 3]."""
    h, w = sample_shape
    lattice = _matrix(grid_csv_or_array)[index].reshape(h, w)
    unit = normalize(lattice)
    cell = LATTICE_CELL
    raw = blow_up(to_u8(unit), cell)
    k = FONT_SCALE
    gap, bar_w = cell // 4, cell // 4
    lo, hi = finite_range(lattice)
    label_w = max(text_width(f"{v:.2f}") for v in (lo, hi))
    width = w * cell + gap + bar_w + gap // 2 + label_w + gap // 2
    plotted = np.full((h * cell, width, 3), 255, np.uint8)
    heat = VIRIDIS[to_u8(unit)]
    bad = ~np.isfinite(lattice)
    heat[bad] = 255
    plotted[:, :w * cell] = blow_up(heat, cell)
    for i in range(h):
        for j in range(w):
            t = f"{lattice[i, j]:.2f}"
            draw_text(plotted, t, i * cell + (cell - 5 * k) // 2,
                      j * cell + (cell - text_width(t)) // 2,
                      (0, 0, 0) if bad[i, j] else (255, 255, 255))
    # the colour bar: the colormap top (max) to bottom (min), its two
    # ends' values beside it
    x0 = w * cell + gap
    ramp = VIRIDIS[np.linspace(255, 0, h * cell).round().astype(np.intp)]
    plotted[:, x0:x0 + bar_w] = ramp[:, None]
    lx = x0 + bar_w + gap // 2
    draw_text(plotted, f"{hi:.2f}", 0, lx, (0, 0, 0))
    draw_text(plotted, f"{lo:.2f}", h * cell - 5 * k, lx, (0, 0, 0))
    return raw, plotted


def save_lattice_example_pngs(path_raw: str, path_plotted: str,
                              grid_csv_or_array, sample_shape=(4, 3),
                              index: int = 0) -> tuple:
    """The reference's single-lattice artifacts
    (``DCGAN_Generated_Lattice_Example.png`` and ``..._Plotted.png``):
    lattice ``index`` of a grid dump as a raw blow-up and as an annotated
    heatmap (period rows x transaction-type columns)."""
    raw, plotted = lattice_images(grid_csv_or_array, sample_shape, index)
    return _write(path_raw, raw), _write(path_plotted, plotted)
