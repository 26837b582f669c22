"""WGAN-GP, the roadmap's second-order stress config (torch twin of
``gan_deeplearning4j_tpu/models/wgan_gp.py``: the same builders, config
and layer names).

Critic (Gulrajani et al. 2017 conventions): two 5x5 stride-2 convs, a
dense 256, a linear head with the ``wasserstein`` loss, and NO BatchNorm:
the gradient penalty is per example, and batch coupling would break it.
Generator: z(64) -> dense 7x7x4f -> BN -> two stride-2 transposed convs ->
28x28x1 sigmoid.  Adam(1e-4, 0.5, 0.9) on both, no clipping, n_critic 5,
penalty weight 10.  Every builder takes ``device`` (None = the card).
"""

from __future__ import annotations

import dataclasses

from gan_deeplearning4j_tpu_torch.graph import (
    BatchNorm,
    Conv2D,
    ConvTranspose2D,
    Dense,
    FeedForwardToCnn,
    GraphBuilder,
    InputSpec,
    Output,
)
from gan_deeplearning4j_tpu_torch.optim.adam import Adam
from gan_deeplearning4j_tpu_torch.runtime import prng


@dataclasses.dataclass(frozen=True)
class WGANGPConfig:
    seed: int = prng.NUMBER_OF_THE_BEAST
    height: int = 28
    width: int = 28
    channels: int = 1
    z_size: int = 64
    base_filters: int = 32
    learning_rate: float = 0.0001
    gp_weight: float = 10.0
    n_critic: int = 5            # critic steps per generator step
    clip: float = 0.0            # no clipping; the penalty regularizes


def build_critic(cfg: WGANGPConfig = WGANGPConfig(), device=None):
    """Conv critic, no BatchNorm, linear head, Wasserstein loss."""
    lr = Adam(cfg.learning_rate, 0.5, 0.9)
    f = cfg.base_filters
    b = GraphBuilder(seed=cfg.seed, activation="leakyrelu",
                     weight_init="xavier", clip_threshold=cfg.clip or None)
    b.add_inputs("image")
    b.set_input_types(
        InputSpec.convolutional_flat(cfg.height, cfg.width, cfg.channels))
    b.add_layer("crit_conv1", Conv2D(kernel=(5, 5), stride=(2, 2),
                                     padding=(2, 2), n_in=cfg.channels,
                                     n_out=f, updater=lr), "image")
    b.add_layer("crit_conv2", Conv2D(kernel=(5, 5), stride=(2, 2),
                                     padding=(2, 2), n_in=f, n_out=2 * f,
                                     updater=lr), "crit_conv1")
    b.add_layer("crit_dense", Dense(n_out=256, updater=lr), "crit_conv2")
    b.add_layer("crit_out", Output(n_out=1, n_in=256, loss="wasserstein",
                                   activation="identity", updater=lr),
                "crit_dense")
    b.set_outputs("crit_out")
    return b.build(device).init()


def build_generator(cfg: WGANGPConfig = WGANGPConfig(), device=None):
    """z -> dense 7*7*4f -> BN -> deconv x2 -> 28x28."""
    lr = Adam(cfg.learning_rate, 0.5, 0.9)
    f = cfg.base_filters
    b = GraphBuilder(seed=cfg.seed, activation="relu", weight_init="xavier",
                     clip_threshold=cfg.clip or None)
    b.add_inputs("z")
    b.set_input_types(InputSpec.feed_forward(cfg.z_size))
    b.add_layer("gen_dense", Dense(n_out=7 * 7 * 4 * f, updater=lr), "z")
    b.add_layer("gen_bn0", BatchNorm(updater=lr), "gen_dense")
    b.add_layer("gen_deconv1",
                ConvTranspose2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                                n_in=4 * f, n_out=2 * f, updater=lr),
                "gen_bn0")
    b.input_preprocessor("gen_deconv1", FeedForwardToCnn(7, 7, 4 * f))
    b.add_layer("gen_bn1", BatchNorm(updater=lr), "gen_deconv1")
    b.add_layer("gen_deconv2",
                ConvTranspose2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                                n_in=2 * f, n_out=cfg.channels,
                                activation="sigmoid", updater=lr),
                "gen_bn1")
    b.set_outputs("gen_deconv2")
    return b.build(device).init()
