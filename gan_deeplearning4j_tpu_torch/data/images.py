"""Image record reader, DataVec's image pipeline (own copy of
``gan_deeplearning4j_tpu/data/images.py``; numpy and PIL, no torch op).

A directory of images becomes an NCHW float32 table, with DataVec's
``ParentPathLabelGenerator`` convention (label = parent directory name)
when subdirectories hold images.  PIL decodes and resizes (bilinear), and
numpy lays out [N, C, H, W] scaled to [0, 1], or to [-1, 1] with
``tanh_range`` (the roadmap generators' output range).  PIL is imported
where an image is decoded, not with this module: without it a read raises
``ImportError`` naming ``--data-dir``, the one option that reads images.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading images (roadmap_main --data-dir) needs PIL (the pillow "
            "package), which is not installed") from e
    return Image


@dataclasses.dataclass(frozen=True)
class ImageRecordReader:
    """Decode images to [C, height, width] float32.

    ``channels``: 1 (grayscale) or 3 (RGB).  ``tanh_range``: scale to
    [-1, 1] instead of [0, 1].
    """

    height: int
    width: int
    channels: int = 3
    tanh_range: bool = False

    def read_image(self, path: str) -> np.ndarray:
        Image = _pil_image()
        with Image.open(path) as im:
            im = im.convert("L" if self.channels == 1 else "RGB")
            im = im.resize((self.width, self.height), Image.BILINEAR)
            arr = np.asarray(im, dtype=np.float32) / 255.0
        if self.channels == 1:
            arr = arr[None]                       # [1, H, W]
        else:
            arr = np.transpose(arr, (2, 0, 1))    # HWC -> CHW
        if self.tanh_range:
            arr = arr * 2.0 - 1.0
        return arr

    def read_folder(
        self, root: str, flatten: bool = True,
        limit: Optional[int] = None,
    ) -> Tuple[np.ndarray, Optional[np.ndarray], List[str]]:
        """Read a directory tree of images.

        Labelled (DataVec ParentPathLabelGenerator): ``root/<class>/img``
        -> (features, labels, class names), labels indexing the sorted
        class names; the classes interleave, so a ``limit`` keeps them
        balanced.  Unlabelled: images directly under ``root`` ->
        (features, None, []).  A directory counts as a class only if it
        holds images.  ``flatten``: [N, C*H*W] (the graphs' cnn_flat
        input layout) instead of [N, C, H, W].
        """
        def images_in(d: str) -> List[str]:
            return sorted(f for f in os.listdir(d)
                          if f.lower().endswith(_EXTENSIONS))

        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
            and images_in(os.path.join(root, d)))
        files: List[Tuple[str, int]] = []
        if classes:
            per_class = [
                [(os.path.join(root, cls, f), idx)
                 for f in images_in(os.path.join(root, cls))]
                for idx, cls in enumerate(classes)]
            longest = max(len(lst) for lst in per_class)
            for i in range(longest):
                for lst in per_class:
                    if i < len(lst):
                        files.append(lst[i])
        else:
            files = [(os.path.join(root, f), -1) for f in images_in(root)]
        if limit is not None:
            files = files[:limit]
        if not files:
            raise FileNotFoundError(f"no images under {root}")
        feats = np.stack([self.read_image(p) for p, _ in files])
        labels = (np.asarray([lab for _, lab in files], dtype=np.int64)
                  if classes else None)
        if flatten:
            feats = feats.reshape(feats.shape[0], -1)
        return feats, labels, classes
