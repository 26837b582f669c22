"""The frozen FID feature extractor (torch twin of the loading half of
``gan_deeplearning4j_tpu/eval/fid_extractor.py``).

The JAX package trained a small CNN classifier once under a pinned recipe
and committed it as ``gan_deeplearning4j_tpu/eval/assets/
fid_extractor_v1.zip`` (Conv2D, Conv2D, the 256-wide dense "feat",
softmax).  Every FID in that space loads the same weights, so the metric
is comparable across runs and across the two packages.  The port reads
that data file by its path in the checkout (it imports nothing of the
JAX package) through ``graph.serialization``.  The recipe and its
training, and the CIFAR and CelebA extractors, are not ported.
"""

from __future__ import annotations

import os

import numpy as np

from gan_deeplearning4j_tpu_torch.eval import fid as fid_lib
from gan_deeplearning4j_tpu_torch.graph import serialization

RECIPE_VERSION = 1
FEATURE_LAYER = "feat"
ASSET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gan_deeplearning4j_tpu", "eval", "assets",
    f"fid_extractor_v{RECIPE_VERSION}.zip")


def load_extractor(device=None):
    """The committed frozen extractor on ``device`` (None = the card).
    Raises FileNotFoundError when the asset is absent."""
    if not os.path.exists(ASSET_PATH):
        raise FileNotFoundError(
            f"{ASSET_PATH} missing — the frozen FID extractor is a data "
            "file of the JAX package's checkout")
    return serialization.read_model(ASSET_PATH, device)


def frozen_fid(real: np.ndarray, generated: np.ndarray, device=None,
               batch_size: int = 500) -> float:
    """FID between pixel sets in the FROZEN feature space."""
    return fid_lib.compute_fid(load_extractor(device), real, generated,
                               layer=FEATURE_LAYER, batch_size=batch_size)
