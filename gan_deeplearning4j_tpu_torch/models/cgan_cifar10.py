"""Conditional GAN on CIFAR-10 32x32x3, the roadmap's conditional config
(torch twin of ``gan_deeplearning4j_tpu/models/cgan_cifar10.py``: the same
builders, config and layer names).

  - generator: Merge(z, one-hot label) -> dense 4x4x(4f) -> BN -> three
    stride-2 transposed convs (4f -> 2f -> f -> 3, BN after the first two)
    -> 32x32x3 tanh.  With ``conditional_bn`` every BN is a
    ``ConditionalBatchNorm`` on (x, label): per-class gamma/beta.
  - discriminator: conv stride-2 stack (3 -> f -> 2f -> 4f, LeakyReLU, a
    4-D BN after the second), a ``MinibatchStdDev`` channel
    (``minibatch_stddev``), dense 512, then the projection head
    ``ProjectionOutput`` on (features, label) (``projection_d``) or a
    Merge with the label and a sigmoid ``Output``.
Adam(2e-4 G / 1e-4 D, 0.5, 0.999), elementwise clip 1.0, one-sided label
smoothing 0.9; with ``decay_steps`` both networks' Adam runs under a
hold-then-sigmoid-decay schedule.  Every builder takes ``device`` (None =
the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gan_deeplearning4j_tpu_torch.graph import (
    BatchNorm,
    ConditionalBatchNorm,
    Conv2D,
    ConvTranspose2D,
    Dense,
    FeedForwardToCnn,
    GraphBuilder,
    InputSpec,
    Merge,
    MinibatchStdDev,
    Output,
    ProjectionOutput,
)
from gan_deeplearning4j_tpu_torch.optim.adam import Adam
from gan_deeplearning4j_tpu_torch.optim.schedules import Scheduled, SigmoidSchedule
from gan_deeplearning4j_tpu_torch.runtime import prng


@dataclasses.dataclass(frozen=True)
class CGANConfig:
    seed: int = prng.NUMBER_OF_THE_BEAST
    height: int = 32
    width: int = 32
    channels: int = 3
    num_classes: int = 10
    z_size: int = 64
    base_filters: int = 64
    learning_rate: float = 0.0002
    d_learning_rate: float = 0.0001  # TTUR
    real_label: float = 0.9  # one-sided label smoothing
    l2: float = 0.0
    clip: float = 1.0
    decay_steps: Optional[int] = None
    conditional_bn: bool = True
    projection_d: bool = True
    minibatch_stddev: bool = True
    ms_weight: float = 0.0


def _lr(rate: float, cfg: CGANConfig):
    adam = Adam(rate, 0.5, 0.999)
    if cfg.decay_steps:
        # ~rate until 0.4 H, rate/2 at 0.7 H, ~0 at H (H = decay_steps)
        return Scheduled(adam, SigmoidSchedule(
            rate, gamma=-1.0 / (0.06 * cfg.decay_steps),
            step=0.7 * cfg.decay_steps))
    return adam


def build_generator(cfg: CGANConfig = CGANConfig(), device=None):
    lr = _lr(cfg.learning_rate, cfg)
    f = cfg.base_filters
    b = GraphBuilder(seed=cfg.seed, l2=cfg.l2, activation="relu",
                     weight_init="xavier", clip_threshold=cfg.clip)
    b.add_inputs("z", "label")
    b.set_input_types(InputSpec.feed_forward(cfg.z_size),
                      InputSpec.feed_forward(cfg.num_classes))
    b.add_layer("gen_merge", Merge(), "z", "label")
    b.add_layer("gen_dense", Dense(n_out=4 * 4 * (4 * f), updater=lr),
                "gen_merge")

    def bn(name, inp, n):
        """Per-class gamma/beta (conditional_bn) or plain BN."""
        if cfg.conditional_bn:
            b.add_layer(name, ConditionalBatchNorm(
                num_classes=cfg.num_classes, n=n, updater=lr), inp, "label")
        else:
            b.add_layer(name, BatchNorm(updater=lr), inp)

    bn("gen_bn0", "gen_dense", 4 * 4 * (4 * f))
    b.add_layer("gen_deconv1",
                ConvTranspose2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                                n_in=4 * f, n_out=2 * f, updater=lr),
                "gen_bn0")
    b.input_preprocessor("gen_deconv1", FeedForwardToCnn(4, 4, 4 * f))
    bn("gen_bn1", "gen_deconv1", 2 * f)
    b.add_layer("gen_deconv2",
                ConvTranspose2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                                n_in=2 * f, n_out=f, updater=lr),
                "gen_bn1")
    bn("gen_bn2", "gen_deconv2", f)
    b.add_layer("gen_deconv3",
                ConvTranspose2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                                n_in=f, n_out=cfg.channels, activation="tanh",
                                updater=lr),
                "gen_bn2")
    b.set_outputs("gen_deconv3")
    return b.build(device).init()


def build_discriminator(cfg: CGANConfig = CGANConfig(), device=None):
    lr = _lr(cfg.d_learning_rate, cfg)
    f = cfg.base_filters
    b = GraphBuilder(seed=cfg.seed, l2=cfg.l2, activation="leakyrelu",
                     weight_init="xavier", clip_threshold=cfg.clip)
    b.add_inputs("image", "label")
    b.set_input_types(
        InputSpec.convolutional_flat(cfg.height, cfg.width, cfg.channels),
        InputSpec.feed_forward(cfg.num_classes))
    b.add_layer("dis_conv1",
                Conv2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                       n_in=cfg.channels, n_out=f, updater=lr), "image")
    b.add_layer("dis_conv2",
                Conv2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                       n_in=f, n_out=2 * f, updater=lr), "dis_conv1")
    b.add_layer("dis_bn2", BatchNorm(updater=lr), "dis_conv2")
    b.add_layer("dis_conv3",
                Conv2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                       n_in=2 * f, n_out=4 * f, updater=lr), "dis_bn2")
    dense_in = "dis_conv3"
    if cfg.minibatch_stddev:
        b.add_layer("dis_mbstd", MinibatchStdDev(), "dis_conv3")
        dense_in = "dis_mbstd"
    b.add_layer("dis_dense", Dense(n_out=512, updater=lr), dense_in)
    if cfg.projection_d:
        b.add_layer("dis_out",
                    ProjectionOutput(n_in=512, num_classes=cfg.num_classes,
                                     loss="xent", activation="sigmoid",
                                     updater=lr),
                    "dis_dense", "label")
    else:
        b.add_layer("dis_merge", Merge(), "dis_dense", "label")
        b.add_layer("dis_out",
                    Output(n_out=1, n_in=512 + cfg.num_classes, loss="xent",
                           activation="sigmoid", updater=lr),
                    "dis_merge")
    b.set_outputs("dis_out")
    return b.build(device).init()
