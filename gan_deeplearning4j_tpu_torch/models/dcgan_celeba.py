"""CelebA 64x64 DCGAN, the roadmap's CelebA config (torch twin of
``gan_deeplearning4j_tpu/models/dcgan_celeba.py``: the same builders,
config and layer names).

Standard 64x64 DCGAN shapes (Radford et al. 2015): z(100) -> dense
4x4x(8f) -> BN -> four stride-2 transposed convs (BN after the first
three) -> 64x64x3 tanh; the mirror conv stack with LeakyReLU and BN for
the discriminator, a ``MinibatchStdDev`` channel before its sigmoid head.
Adam(2e-4 G / 1e-4 D, 0.5, 0.999), elementwise clip 1.0; with
``decay_steps`` both networks' Adam runs under a hold-then-sigmoid-decay
schedule.  ``bf16``: None (default) follows the precision policy
(``backend.configure(matmul_bf16=...)``); True/False pins every
contraction layer of the model (gen_dense, the transposed convs, the
convs and dis_out) regardless of it.  Every builder takes ``device``
(None = the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gan_deeplearning4j_tpu_torch.graph import (
    BatchNorm,
    Conv2D,
    ConvTranspose2D,
    Dense,
    FeedForwardToCnn,
    GraphBuilder,
    InputSpec,
    MinibatchStdDev,
    Output,
)
from gan_deeplearning4j_tpu_torch.optim.adam import Adam
from gan_deeplearning4j_tpu_torch.optim.schedules import Scheduled, SigmoidSchedule
from gan_deeplearning4j_tpu_torch.runtime import prng


@dataclasses.dataclass(frozen=True)
class CelebAConfig:
    seed: int = prng.NUMBER_OF_THE_BEAST
    height: int = 64
    width: int = 64
    channels: int = 3
    z_size: int = 100
    base_filters: int = 64
    learning_rate: float = 0.0002
    d_learning_rate: float = 0.0001  # TTUR
    real_label: float = 0.9  # one-sided label smoothing
    clip: float = 1.0
    bf16: Optional[bool] = None  # None = the precision policy
    decay_steps: Optional[int] = None
    minibatch_stddev: bool = True
    ms_weight: float = 0.0


def _lr(rate: float, cfg: CelebAConfig):
    adam = Adam(rate, 0.5, 0.999)
    if cfg.decay_steps:
        return Scheduled(adam, SigmoidSchedule(
            rate, gamma=-1.0 / (0.06 * cfg.decay_steps),
            step=0.7 * cfg.decay_steps))
    return adam


def build_generator(cfg: CelebAConfig = CelebAConfig(), device=None):
    lr = _lr(cfg.learning_rate, cfg)
    f = cfg.base_filters
    b = GraphBuilder(seed=cfg.seed, activation="relu", weight_init="xavier",
                     clip_threshold=cfg.clip)
    b.add_inputs("z")
    b.set_input_types(InputSpec.feed_forward(cfg.z_size))
    b.add_layer("gen_dense", Dense(n_out=4 * 4 * 8 * f, updater=lr,
                                   bf16_matmul=cfg.bf16), "z")
    b.add_layer("gen_bn0", BatchNorm(updater=lr), "gen_dense")
    chans = [8 * f, 4 * f, 2 * f, f]
    prev = "gen_bn0"
    for i in range(3):
        name = f"gen_deconv{i + 1}"
        b.add_layer(name, ConvTranspose2D(kernel=(4, 4), stride=(2, 2),
                                          padding=(1, 1), n_in=chans[i],
                                          n_out=chans[i + 1], updater=lr,
                                          bf16_matmul=cfg.bf16),
                    prev)
        if i == 0:
            b.input_preprocessor(name, FeedForwardToCnn(4, 4, 8 * f))
        bn = f"gen_bn{i + 1}"
        b.add_layer(bn, BatchNorm(updater=lr), name)
        prev = bn
    b.add_layer("gen_deconv4",
                ConvTranspose2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                                n_in=f, n_out=cfg.channels, activation="tanh",
                                updater=lr, bf16_matmul=cfg.bf16),
                prev)
    b.set_outputs("gen_deconv4")
    return b.build(device).init()


def build_discriminator(cfg: CelebAConfig = CelebAConfig(), device=None):
    lr = _lr(cfg.d_learning_rate, cfg)
    f = cfg.base_filters
    b = GraphBuilder(seed=cfg.seed, activation="leakyrelu",
                     weight_init="xavier", clip_threshold=cfg.clip)
    b.add_inputs("image")
    b.set_input_types(
        InputSpec.convolutional_flat(cfg.height, cfg.width, cfg.channels))
    chans = [cfg.channels, f, 2 * f, 4 * f, 8 * f]
    prev = "image"
    for i in range(4):
        name = f"dis_conv{i + 1}"
        b.add_layer(name, Conv2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                                 n_in=chans[i], n_out=chans[i + 1],
                                 updater=lr, bf16_matmul=cfg.bf16),
                    prev)
        prev = name
        if i > 0:
            bn = f"dis_bn{i + 1}"
            b.add_layer(bn, BatchNorm(updater=lr), name)
            prev = bn
    n_in = 8 * f * 4 * 4
    if cfg.minibatch_stddev:
        b.add_layer("dis_mbstd", MinibatchStdDev(), prev)
        prev = "dis_mbstd"
        n_in = (8 * f + 1) * 4 * 4
    b.add_layer("dis_out", Output(n_out=1, n_in=n_in, loss="xent",
                                  activation="sigmoid", updater=lr,
                                  bf16_matmul=cfg.bf16),
                prev)
    b.set_outputs("dis_out")
    return b.build(device).init()
