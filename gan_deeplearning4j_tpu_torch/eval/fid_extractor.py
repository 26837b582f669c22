"""The frozen FID feature extractors (torch twin of
``gan_deeplearning4j_tpu/eval/fid_extractor.py``).

The JAX package trained three small CNN classifiers once under pinned
recipes and committed them under ``gan_deeplearning4j_tpu/eval/assets/``:
``fid_extractor_v1.zip`` (MNIST: Conv2D, Conv2D, the 256-wide dense
"feat", softmax), ``fid_extractor_cifar_v1.zip`` (the conditional family's
per-class FID, ``eval/conditional.py``) and ``fid_extractor_celeba_v1.zip``
(8 attribute heads, ``frozen_fid_celeba``).  Every FID in such a space
loads the same weights, so the metric is comparable across runs and
across the two packages.  The port reads those data files by their path in
the checkout (it imports nothing of the JAX package) through
``graph.serialization``.

The recipes are ported too (``build_extractor*``, ``train_extractor*``):
the same architectures, seeds, data budgets, batch orders
(``RandomState(seed).randint``), step counts and learning rates, on the
port's synthetic sets.  The port's init is drawn by torch, so a retrained
extractor is not the committed one; ``held_out_score`` holds the two to
each other on the JAX recipe's held-out set.  ``save_asset`` and ``main``
write where the caller says, by default under ``outputs/``, never into the
JAX package's assets:

    python -m gan_deeplearning4j_tpu_torch.eval.fid_extractor \
        --family {mnist,celeba,cifar} [--out PATH] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.eval import fid as fid_lib
from gan_deeplearning4j_tpu_torch.graph import serialization

RECIPE_VERSION = 1
CIFAR_RECIPE_VERSION = 1
CELEBA_RECIPE_VERSION = 1
FEATURE_LAYER = "feat"
FAMILIES = ("mnist", "celeba", "cifar")
# where save_asset and main write by default (relative to the working
# directory), never the JAX package's assets
DEFAULT_OUT_DIR = os.path.join("outputs", "fid_extractors")
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


# -- the pinned recipes (the JAX module's constants; changing any of them
# bumps that family's recipe version) -----------------------------------------

_SEED = 666
_N_TRAIN = 20000
_BATCH = 200
_STEPS = 1500
_LR = 1e-3
_CELEBA_SEED = 666
_CELEBA_N_TRAIN = 8000
_CELEBA_BATCH = 100
_CELEBA_STEPS = 600
_CELEBA_LR = 1e-3
_CIFAR_SEED = 666
_CIFAR_N_TRAIN = 8000
_CIFAR_BATCH = 100
_CIFAR_STEPS = 600
_CIFAR_LR = 1e-3
# family -> (seed, rows, batch, steps, log cadence, tag)
RECIPES = {
    "mnist": (_SEED, _N_TRAIN, _BATCH, _STEPS, 300, "fid-extractor"),
    "celeba": (_CELEBA_SEED, _CELEBA_N_TRAIN, _CELEBA_BATCH, _CELEBA_STEPS,
               100, "fid-extractor-celeba"),
    "cifar": (_CIFAR_SEED, _CIFAR_N_TRAIN, _CIFAR_BATCH, _CIFAR_STEPS, 100,
              "fid-extractor-cifar"),
}
ASSET_PATHS = {"mnist": ASSET_PATH, "celeba": CELEBA_ASSET_PATH,
               "cifar": CIFAR_ASSET_PATH}


def _conv_graph(seed: int, lr: float, h: int, w: int, c: int):
    from gan_deeplearning4j_tpu_torch.graph import GraphBuilder, InputSpec
    from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp

    b = GraphBuilder(seed=seed, l2=1e-4, activation="relu",
                     weight_init="xavier", clip_threshold=1.0)
    b.add_inputs("in")
    b.set_input_types(InputSpec.convolutional_flat(h, w, c))
    return b, RmsProp(lr, 1e-8, 1e-8)


def _head(b, updater, prev: str, n_out: int, loss: str, activation: str,
          device):
    from gan_deeplearning4j_tpu_torch.graph import Dense, Output

    b.add_layer(FEATURE_LAYER, Dense(n_out=256, updater=updater), prev)
    b.add_layer("out", Output(n_out=n_out, loss=loss, activation=activation,
                              updater=updater), FEATURE_LAYER)
    b.set_outputs("out")
    return b.build(device).init()


def _strided_convs(b, updater, chans, kernel, padding) -> str:
    from gan_deeplearning4j_tpu_torch.graph import Conv2D

    prev = "in"
    for i in range(len(chans) - 1):
        name = f"conv{i + 1}"
        b.add_layer(name, Conv2D(kernel=kernel, stride=(2, 2),
                                 padding=padding, n_in=chans[i],
                                 n_out=chans[i + 1], updater=updater), prev)
        prev = name
    return prev


def build_extractor(device=None):
    """The MNIST architecture: 2 strided 5x5 convs (1->16->32) -> the
    256-wide dense "feat" -> 10-way softmax (XENT), on ``device`` (None =
    the card)."""
    b, lr = _conv_graph(_SEED, _LR, 28, 28, 1)
    prev = _strided_convs(b, lr, [1, 16, 32], (5, 5), (0, 0))
    return _head(b, lr, prev, 10, "xent", "softmax", device)


def build_extractor_celeba(device=None):
    """The 64x64 architecture: 4 stride-2 4x4 convs, pad 1
    (3->16->32->64->128) -> "feat" -> 8 sigmoid attribute heads."""
    b, lr = _conv_graph(_CELEBA_SEED, _CELEBA_LR, 64, 64, 3)
    prev = _strided_convs(b, lr, [3, 16, 32, 64, 128], (4, 4), (1, 1))
    return _head(b, lr, prev, 8, "xent", "sigmoid", device)


def build_extractor_cifar(device=None):
    """The 32x32x3 architecture: 3 stride-2 4x4 convs, pad 1
    (3->16->32->64) -> "feat" -> 10-way softmax (MCXENT)."""
    b, lr = _conv_graph(_CIFAR_SEED, _CIFAR_LR, 32, 32, 3)
    prev = _strided_convs(b, lr, [3, 16, 32, 64], (4, 4), (1, 1))
    return _head(b, lr, prev, 10, "mcxent", "softmax", device)


BUILDERS = {"mnist": build_extractor, "celeba": build_extractor_celeba,
            "cifar": build_extractor_cifar}


def batch_order(family: str, steps=None):
    """The recipe's batch indices, step by step: ``RandomState(seed)
    .randint(0, rows, batch)`` once a step, the JAX recipe's stream."""
    seed, n, batch, n_steps = RECIPES[family][:4]
    order = np.random.RandomState(seed)
    for _ in range(n_steps if steps is None else steps):
        yield order.randint(0, n, batch)


def recipe_data(family: str):
    """The recipe's training set: (features, targets) as float32 arrays
    (one-hot classes; CelebA's 8 binary attributes)."""
    from gan_deeplearning4j_tpu_torch.data import datasets

    seed, n = RECIPES[family][:2]
    if family == "celeba":
        return datasets.synthetic_celeba(n, seed=seed, return_attrs=True)
    if family == "cifar":
        x, y = datasets.synthetic_cifar10(n, seed=seed,
                                          difficulty="calibrated")
    else:
        x, y = datasets.synthetic_mnist(n, seed=seed)
    return x, np.eye(10, dtype=np.float32)[y]


def _train(family: str, graph, log, steps=None, data=None):
    x, t = recipe_data(family) if data is None else data
    tag, every = RECIPES[family][5], RECIPES[family][4]
    n_steps = RECIPES[family][3] if steps is None else steps
    x = torch.from_numpy(np.ascontiguousarray(x)).to(graph.device)
    t = torch.from_numpy(np.ascontiguousarray(t)).to(graph.device)
    for step, idx in enumerate(batch_order(family, n_steps)):
        idx = torch.from_numpy(idx).to(graph.device)
        loss = graph.fit(x.index_select(0, idx), t.index_select(0, idx))
        if log and (step + 1) % every == 0:
            log(f"[{tag}] step {step + 1}/{n_steps} loss {float(loss):.4f}")
    return graph


def train_extractor(device=None, log=print, steps=None, data=None):
    """The pinned MNIST recipe: the calibrated surrogate's 20,000 rows,
    seed-666 batches of 200, 1,500 steps (``steps`` cuts it; ``data``
    replaces the training set, as ``recipe_data`` gives it)."""
    return _train("mnist", build_extractor(device), log, steps, data)


def train_extractor_celeba(device=None, log=print, steps=None, data=None):
    """The pinned CelebA recipe: the attribute-labeled surrogate's 8,000
    rows, seed-666 batches of 100, 600 steps."""
    return _train("celeba", build_extractor_celeba(device), log, steps, data)


def train_extractor_cifar(device=None, log=print, steps=None, data=None):
    """The pinned CIFAR recipe: the calibrated surrogate's 8,000 rows,
    seed-666 batches of 100, 600 steps."""
    return _train("cifar", build_extractor_cifar(device), log, steps, data)


TRAINERS = {"mnist": train_extractor, "celeba": train_extractor_celeba,
            "cifar": train_extractor_cifar}


def held_out_set(family: str):
    """The JAX recipe's held-out self-check set (seed + 1 = 667): MNIST
    4,000 rows, CIFAR 2,000 (calibrated), CelebA 2,000 with attributes."""
    from gan_deeplearning4j_tpu_torch.data import datasets

    seed = RECIPES[family][0] + 1
    if family == "celeba":
        return datasets.synthetic_celeba(2000, seed=seed, return_attrs=True)
    if family == "cifar":
        return datasets.synthetic_cifar10(2000, seed=seed,
                                          difficulty="calibrated")
    return datasets.synthetic_mnist(4000, seed=seed)


def held_out_score(graph, family: str, data=None,
                   batch_size: int = 500) -> float:
    """The recipe's held-out score of ``graph``: accuracy (MNIST, CIFAR) or
    the mean per-attribute accuracy (CelebA)."""
    x, y = held_out_set(family) if data is None else data
    out = []
    for lo in range(0, x.shape[0], batch_size):
        xb = torch.from_numpy(np.ascontiguousarray(x[lo:lo + batch_size]))
        out.append(graph.output(xb.to(graph.device))[0].float().cpu().numpy())
    pred = np.concatenate(out)
    if family == "celeba":
        return float(((pred > 0.5) == (y > 0.5)).mean(axis=0).mean())
    return float((pred.argmax(axis=1) == y).mean())


def default_asset_path(family: str) -> str:
    """Where ``save_asset`` and ``main`` write a family's retrained
    extractor unless told: under ``DEFAULT_OUT_DIR``, with the committed
    asset's file name."""
    return os.path.join(DEFAULT_OUT_DIR, os.path.basename(ASSET_PATHS[family]))


def save_asset(graph, path=None, family: str = "mnist") -> str:
    """Write ``graph`` (params only, as the JAX recipe writes it) to
    ``path`` (default ``default_asset_path(family)``)."""
    path = default_asset_path(family) if path is None else path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    serialization.write_model(graph, path, save_updater=False)
    return path


def main(argv=None) -> dict:
    """Retrain one family's extractor from its pinned recipe, score it and
    the committed asset on the held-out set, and write it -> the result
    (also printed as one JSON line)."""
    import argparse
    import json
    import time

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--family", choices=FAMILIES, default="mnist")
    p.add_argument("--out", default=None,
                   help="asset path (default: outputs/fid_extractors/)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "torch versions of the kernels)")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    graph = TRAINERS[args.family](args.device)
    seconds = time.perf_counter() - t0
    held = held_out_set(args.family)
    score = held_out_score(graph, args.family, held)
    committed = held_out_score(_load(ASSET_PATHS[args.family], graph.device),
                               args.family, held)
    path = save_asset(graph, args.out, args.family)
    res = {"family": args.family, "path": path, "train_seconds": seconds,
           "held_out_score": score, "committed_score": committed}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
