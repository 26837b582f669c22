"""Conditional fidelity: does a conditional generator obey its label?
(torch twin of ``gan_deeplearning4j_tpu/eval/conditional.py``).

A probe classifier is trained on the real labeled table; the generator then
makes ``n_per_class`` samples per class and the metric is the share whose
probe prediction is the class they were conditioned on.  A class-collapsed
generator scores ~1/K however sharp its surviving modes look.  Beside it,
``conditional_class_metrics`` gives the per-class FID and the intra-class
diversity ratio in the frozen CIFAR feature space (``fid_extractor``),
which keep discriminating when the agreement sits at the probe's ceiling.

The probe's batches come from ``np.random.RandomState(seed)``, a stream
both packages share; its init and the latents come from the port's own
streams (torch cannot reproduce threefry), so tests inject the JAX side's
probe params and latents (``probe=``, ``z=``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.graph import (
    Conv2D,
    Dense,
    GraphBuilder,
    InputSpec,
    Output,
)
from gan_deeplearning4j_tpu_torch.optim.adam import Adam
from gan_deeplearning4j_tpu_torch.runtime import prng


def build_probe(channels: int, height: int, width: int, num_classes: int,
                seed: int = prng.NUMBER_OF_THE_BEAST, device=None):
    """Small conv classifier: two stride-2 convs, dense 128, softmax;
    Adam(1e-3, 0.9, 0.999)."""
    lr = Adam(1e-3, 0.9, 0.999)
    b = GraphBuilder(seed=seed, activation="relu", weight_init="xavier")
    b.add_inputs("in")
    b.set_input_types(InputSpec.convolutional(channels, height, width))
    b.add_layer("p_conv1", Conv2D(kernel=(3, 3), stride=(2, 2),
                                  padding=(1, 1), n_in=channels, n_out=32,
                                  updater=lr), "in")
    b.add_layer("p_conv2", Conv2D(kernel=(3, 3), stride=(2, 2),
                                  padding=(1, 1), n_in=32, n_out=64,
                                  updater=lr), "p_conv1")
    b.add_layer("p_dense", Dense(n_out=128, updater=lr), "p_conv2")
    b.add_layer("p_out", Output(n_out=num_classes, n_in=128, loss="mcxent",
                                activation="softmax", updater=lr), "p_dense")
    b.set_outputs("p_out")
    return b.build(device).init()


def _gen_params(gen, use_ema: bool):
    if not use_ema:
        return None
    params = getattr(gen, "ema_params", None)
    if params is None:
        raise ValueError("use_ema=True but the generator carries no "
                         "ema_params")
    return params


def _latents(seed: int, stream: str, n: int, z_size: int) -> torch.Tensor:
    return (torch.rand((n, z_size), generator=prng.generator(seed, stream))
            * 2.0 - 1.0)


def conditional_fidelity(
    gen,
    x: np.ndarray,
    y_onehot: np.ndarray,
    *,
    sample_shape,
    z_size: int,
    n_per_class: int = 64,
    probe_steps: int = 400,
    probe_batch: int = 128,
    seed: int = prng.NUMBER_OF_THE_BEAST,
    use_ema: bool = False,
    probe=None,
    z: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """Train the probe on (x, y) on the generator's device, then score the
    label agreement of the generator's conditioned samples.

    ``x``: real features, flat [n, C*H*W]; ``y_onehot``: [n, K].
    ``use_ema``: score ``gen.ema_params``.  ``probe``: a trained probe
    from an earlier call (it depends only on (x, y, seed)), not trained
    again.  ``z``: the [K * n_per_class, z_size] latents (default: the
    ``fidelity-z`` stream).  Returns {fidelity, per_class,
    probe_train_acc, n_per_class, probe}."""
    c, h, w = sample_shape
    k = y_onehot.shape[1]
    dev = gen.device
    x4 = np.asarray(x, np.float32).reshape(-1, c, h, w)
    y = np.asarray(y_onehot, np.float32)
    if probe is None:
        probe = build_probe(c, h, w, k, seed=seed, device=dev)
        rng = np.random.RandomState(seed)
        for _ in range(probe_steps):
            idx = rng.randint(0, x4.shape[0], probe_batch)
            probe.fit(torch.from_numpy(x4[idx]).to(dev),
                      torch.from_numpy(y[idx]).to(dev))
    # the probe's own accuracy on (a capped slice of) its training set
    n_eval = min(2000, x4.shape[0])
    pred_real = probe.output(torch.from_numpy(x4[:n_eval]).to(dev))[0]
    probe_acc = float(np.mean(pred_real.argmax(1).cpu().numpy()
                              == np.argmax(y[:n_eval], axis=1)))
    labels = np.repeat(np.arange(k), n_per_class)
    cond = torch.from_numpy(np.eye(k, dtype=np.float32)[labels]).to(dev)
    zt = (_latents(seed, "fidelity-z", labels.size, z_size) if z is None
          else torch.tensor(np.asarray(z), dtype=torch.float32)).to(dev)
    samples = gen.output(zt, cond, params=_gen_params(gen, use_ema))[0]
    pred = probe.output(samples.reshape(-1, c, h, w))[0].argmax(1)
    agree = pred.cpu().numpy() == labels
    return {
        "fidelity": float(np.mean(agree)),
        "per_class": [float(np.mean(agree[labels == i])) for i in range(k)],
        "probe_train_acc": probe_acc,
        "n_per_class": n_per_class,
        "probe": probe,
    }


def conditional_class_metrics(
    gen,
    x: np.ndarray,
    y_onehot: np.ndarray,
    *,
    sample_shape,
    z_size: int,
    frozen=None,
    n_per_class: int = 400,
    real_cap: int = 1000,
    seed: int = prng.NUMBER_OF_THE_BEAST,
    use_ema: bool = False,
    batch_size: int = 250,
    real_features=None,
    z: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """Per-class frozen-space FID and intra-class diversity.

    ``frozen``: the feature extractor graph (default: the committed CIFAR
    asset on the generator's device, ``fid_extractor.load_extractor_cifar``).
    For each class, the FID between the real rows of that class (at most
    ``real_cap``) and ``n_per_class`` conditioned samples in the 256-wide
    feature space, and the generated class's mean per-feature std over the
    real class's (~1 healthy, -> 0 under within-class collapse).
    ``real_features``: an earlier call's ``_real_features`` (the real side
    depends only on (x, y, frozen)).  ``z``: the [K * n_per_class,
    z_size] latents (default: the ``class-metrics-z`` stream).  Returns
    {per_class_fid, mean_class_fid, diversity_ratio, mean_diversity_ratio,
    _real_features}."""
    from gan_deeplearning4j_tpu_torch.eval import fid as fid_lib
    from gan_deeplearning4j_tpu_torch.eval import fid_extractor as fx

    dev = gen.device
    if frozen is None:
        frozen = fx.load_extractor_cifar(dev)
    k = y_onehot.shape[1]
    y = np.argmax(np.asarray(y_onehot), axis=1)
    x = np.asarray(x, np.float32)
    params = _gen_params(gen, use_ema)
    labels = np.repeat(np.arange(k), n_per_class)
    cond = torch.from_numpy(np.eye(k, dtype=np.float32)[labels]).to(dev)
    zt = (_latents(seed, "class-metrics-z", labels.size, z_size)
          if z is None else torch.tensor(np.asarray(z), dtype=torch.float32)
          ).to(dev)
    outs = []
    for i in range(0, labels.size, batch_size):
        j = min(i + batch_size, labels.size)
        out = gen.output(zt[i:j], cond[i:j], params=params)[0]
        outs.append(out.reshape(j - i, -1))
    gen_rows = torch.cat(outs).float().cpu().numpy()  # bf16 under --mp
    f_gen = fid_lib.extract_features(frozen, gen_rows, fx.FEATURE_LAYER,
                                     batch_size=batch_size)
    if real_features is None:
        real_features = [
            fid_lib.extract_features(frozen, x[y == cls][:real_cap],
                                     fx.FEATURE_LAYER, batch_size=batch_size)
            for cls in range(k)]
    per_fid, div_ratio = [], []
    for cls in range(k):
        f_real = real_features[cls]
        f_g = f_gen[labels == cls]
        per_fid.append(float(fid_lib.fid_from_features(f_real, f_g)))
        div_ratio.append(float(f_g.std(axis=0).mean()
                               / max(f_real.std(axis=0).mean(), 1e-9)))
    return {
        "per_class_fid": per_fid,
        "mean_class_fid": float(np.mean(per_fid)),
        "diversity_ratio": div_ratio,
        "mean_diversity_ratio": float(np.mean(div_ratio)),
        "_real_features": real_features,
    }
