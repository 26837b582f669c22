"""The frozen FID feature extractor (torch twin of the loading half of
``gan_deeplearning4j_tpu/eval/fid_extractor.py``).

The JAX package trained a small CNN classifier once under a pinned recipe
and committed it as ``gan_deeplearning4j_tpu/eval/assets/
fid_extractor_v1.zip`` (Conv2D, Conv2D, the 256-wide dense "feat",
softmax).  Every FID in that space loads the same weights, so the metric
is comparable across runs and across the two packages.  The port reads
that data file by its path in the checkout (it imports nothing of the
JAX package) through ``graph.serialization``, and so it reads the 32x32
CIFAR extractor (the conditional family's per-class FID,
``eval/conditional.py``) and the 64x64 CelebA attribute extractor
(``frozen_fid_celeba``), committed beside it.  The recipes and their
training are not ported.
"""

from __future__ import annotations

import os

import numpy as np

from gan_deeplearning4j_tpu_torch.eval import fid as fid_lib
from gan_deeplearning4j_tpu_torch.graph import serialization

RECIPE_VERSION = 1
CIFAR_RECIPE_VERSION = 1
CELEBA_RECIPE_VERSION = 1
FEATURE_LAYER = "feat"
_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gan_deeplearning4j_tpu", "eval", "assets")
ASSET_PATH = os.path.join(_ASSET_DIR, f"fid_extractor_v{RECIPE_VERSION}.zip")
CIFAR_ASSET_PATH = os.path.join(
    _ASSET_DIR, f"fid_extractor_cifar_v{CIFAR_RECIPE_VERSION}.zip")
CELEBA_ASSET_PATH = os.path.join(
    _ASSET_DIR, f"fid_extractor_celeba_v{CELEBA_RECIPE_VERSION}.zip")


def _load(path: str, device):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing — the frozen FID extractors are data files of "
            "the JAX package's checkout")
    return serialization.read_model(path, device)


def load_extractor(device=None):
    """The committed frozen MNIST extractor on ``device`` (None = the
    card).  Raises FileNotFoundError when the asset is absent."""
    return _load(ASSET_PATH, device)


def load_extractor_cifar(device=None):
    """The committed frozen 32x32x3 extractor (3 stride-2 convs, the
    256-wide "feat", a 10-way softmax) on ``device``."""
    return _load(CIFAR_ASSET_PATH, device)


def load_extractor_celeba(device=None):
    """The committed frozen 64x64x3 attribute extractor (4 stride-2 convs,
    the 256-wide "feat", 8 sigmoid heads) on ``device``."""
    return _load(CELEBA_ASSET_PATH, device)


def frozen_fid(real: np.ndarray, generated: np.ndarray, device=None,
               batch_size: int = 500) -> float:
    """FID between pixel sets in the FROZEN feature space."""
    return fid_lib.compute_fid(load_extractor(device), real, generated,
                               layer=FEATURE_LAYER, batch_size=batch_size)


def frozen_fid_celeba(real: np.ndarray, generated: np.ndarray, device=None,
                      batch_size: int = 250) -> float:
    """FID between 64x64 pixel sets ([n, 3*64*64], tanh range) in the
    frozen CelebA feature space."""
    return fid_lib.compute_fid(load_extractor_celeba(device), real, generated,
                               layer=FEATURE_LAYER, batch_size=batch_size)
