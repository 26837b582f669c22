"""DCGAN-on-MNIST model family (torch twin of ``gan_deeplearning4j_tpu/
models/dcgan_mnist.py``): the reference's CV workload graphs, layer for
layer and name for name.

  - discriminator: 28x28x1 -> BN -> conv5x5 s2 (1->64) -> maxpool2x2 s1 ->
    conv5x5 s2 (64->128) -> maxpool2x2 s1 -> dense 1024 -> sigmoid(1),
    XENT; global TANH, Xavier, per-layer RmsProp(lr, 1e-8, 1e-8), clip
    1.0, L2 1e-4.
  - generator: z(2) -> BN -> dense 1024 -> dense 7*7*128 -> BN -> reshape
    7x7x128 -> upsample x2 -> conv5x5 s1 p2 (128->64) -> upsample x2 ->
    conv5x5 s1 p2 (64->1) sigmoid.
  - stacked gan: generator layers at gen lr, discriminator copy at lr 0.0.
  - transfer classifier: freeze through dis_dense_layer_6, replace the head
    with BN(1024) + softmax(10), MCXENT.

Every builder takes ``device`` (None = the card).
"""

from __future__ import annotations

import dataclasses

from gan_deeplearning4j_tpu_torch.graph import (
    BatchNorm,
    Conv2D,
    Dense,
    FeedForwardToCnn,
    FineTuneConfiguration,
    GraphBuilder,
    InputSpec,
    MaxPool2D,
    Output,
    TransferLearning,
    Upsampling2D,
)
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp
from gan_deeplearning4j_tpu_torch.runtime import prng


@dataclasses.dataclass(frozen=True)
class CVConfig:
    """The reference's constants block (dl4jGANComputerVision.java:59-85)."""

    seed: int = prng.NUMBER_OF_THE_BEAST
    height: int = 28
    width: int = 28
    channels: int = 1
    num_features: int = 784
    z_size: int = 2
    num_classes: int = 10
    dis_learning_rate: float = 0.002
    gen_learning_rate: float = 0.004
    frozen_learning_rate: float = 0.0
    l2: float = 1e-4
    clip: float = 1.0


def _builder(cfg: CVConfig) -> GraphBuilder:
    return GraphBuilder(seed=cfg.seed, l2=cfg.l2, activation="tanh",
                        weight_init="xavier", clip_threshold=cfg.clip)


def build_discriminator(cfg: CVConfig = CVConfig(), device=None):
    lr = RmsProp(cfg.dis_learning_rate, 1e-8, 1e-8)
    b = _builder(cfg)
    b.add_inputs("dis_input_layer_0")
    b.set_input_types(InputSpec.convolutional_flat(cfg.height, cfg.width, cfg.channels))
    b.add_layer("dis_batch_layer_1", BatchNorm(updater=lr), "dis_input_layer_0")
    b.add_layer("dis_conv2d_layer_2",
                Conv2D(kernel=(5, 5), stride=(2, 2), n_in=1, n_out=64, updater=lr),
                "dis_batch_layer_1")
    b.add_layer("dis_maxpool_layer_3", MaxPool2D(kernel=(2, 2), stride=(1, 1)),
                "dis_conv2d_layer_2")
    b.add_layer("dis_conv2d_layer_4",
                Conv2D(kernel=(5, 5), stride=(2, 2), n_in=64, n_out=128, updater=lr),
                "dis_maxpool_layer_3")
    b.add_layer("dis_maxpool_layer_5", MaxPool2D(kernel=(2, 2), stride=(1, 1)),
                "dis_conv2d_layer_4")
    b.add_layer("dis_dense_layer_6", Dense(n_out=1024, updater=lr),
                "dis_maxpool_layer_5")
    b.add_layer("dis_output_layer_7",
                Output(n_out=1, loss="xent", activation="sigmoid", updater=lr),
                "dis_dense_layer_6")
    b.set_outputs("dis_output_layer_7")
    return b.build(device).init()


def _add_generator_layers(b: GraphBuilder, lr: RmsProp, prefix: str,
                          input_name: str) -> str:
    """The generator stack, shared by the standalone gen graph and the
    stacked gan graph (names differ only by prefix)."""
    b.add_layer(f"{prefix}_batch_1", BatchNorm(updater=lr), input_name)
    b.add_layer(f"{prefix}_dense_layer_2", Dense(n_out=1024, updater=lr),
                f"{prefix}_batch_1")
    b.add_layer(f"{prefix}_dense_layer_3", Dense(n_out=7 * 7 * 128, updater=lr),
                f"{prefix}_dense_layer_2")
    b.add_layer(f"{prefix}_batch_4", BatchNorm(updater=lr), f"{prefix}_dense_layer_3")
    b.add_layer(f"{prefix}_deconv2d_5", Upsampling2D(size=2), f"{prefix}_batch_4")
    b.input_preprocessor(f"{prefix}_deconv2d_5", FeedForwardToCnn(7, 7, 128))
    b.add_layer(f"{prefix}_conv2d_6",
                Conv2D(kernel=(5, 5), stride=(1, 1), padding=(2, 2),
                       n_in=128, n_out=64, updater=lr),
                f"{prefix}_deconv2d_5")
    b.add_layer(f"{prefix}_deconv2d_7", Upsampling2D(size=2), f"{prefix}_conv2d_6")
    b.add_layer(f"{prefix}_conv2d_8",
                Conv2D(kernel=(5, 5), stride=(1, 1), padding=(2, 2),
                       n_in=64, n_out=1, activation="sigmoid", updater=lr),
                f"{prefix}_deconv2d_7")
    return f"{prefix}_conv2d_8"


def build_generator(cfg: CVConfig = CVConfig(), device=None):
    """Standalone generator, frozen (lr 0.0) — for synthesis only; its
    weights are overwritten from the gan graph each iteration."""
    lr = RmsProp(cfg.frozen_learning_rate, 1e-8, 1e-8)
    b = _builder(cfg)
    b.add_inputs("gen_input_layer_0")
    b.set_input_types(InputSpec.feed_forward(cfg.z_size))
    b.set_outputs(_add_generator_layers(b, lr, "gen", "gen_input_layer_0"))
    return b.build(device).init()


def build_gan(cfg: CVConfig = CVConfig(), device=None):
    """Stacked G+D: generator at gen lr 0.004, discriminator tail at lr 0.0."""
    gen_lr = RmsProp(cfg.gen_learning_rate, 1e-8, 1e-8)
    frz = RmsProp(cfg.frozen_learning_rate, 1e-8, 1e-8)
    b = _builder(cfg)
    b.add_inputs("gan_input_layer_0")
    b.set_input_types(InputSpec.feed_forward(cfg.z_size))
    gen_out = _add_generator_layers(b, gen_lr, "gan", "gan_input_layer_0")
    b.add_layer("gan_dis_batch_layer_9", BatchNorm(updater=frz), gen_out)
    b.add_layer("gan_dis_conv2d_layer_10",
                Conv2D(kernel=(5, 5), stride=(2, 2), n_in=1, n_out=64, updater=frz),
                "gan_dis_batch_layer_9")
    b.add_layer("gan_dis_maxpool_layer_11", MaxPool2D(kernel=(2, 2), stride=(1, 1)),
                "gan_dis_conv2d_layer_10")
    b.add_layer("gan_dis_conv2d_layer_12",
                Conv2D(kernel=(5, 5), stride=(2, 2), n_in=64, n_out=128, updater=frz),
                "gan_dis_maxpool_layer_11")
    b.add_layer("gan_dis_maxpool_layer_13", MaxPool2D(kernel=(2, 2), stride=(1, 1)),
                "gan_dis_conv2d_layer_12")
    b.add_layer("gan_dis_dense_layer_14", Dense(n_out=1024, updater=frz),
                "gan_dis_maxpool_layer_13")
    b.add_layer("gan_dis_output_layer_15",
                Output(n_out=1, loss="xent", activation="sigmoid", updater=frz),
                "gan_dis_dense_layer_14")
    b.set_outputs("gan_dis_output_layer_15")
    return b.build(device).init()


def build_classifier(dis, cfg: CVConfig = CVConfig()):
    """Transfer-learned 10-class classifier on discriminator features, on
    the discriminator's device."""
    lr = RmsProp(cfg.dis_learning_rate, 1e-8, 1e-8)
    return (
        TransferLearning(dis)
        .fine_tune_configuration(FineTuneConfiguration(
            seed=cfg.seed, l2=cfg.l2, activation="tanh", weight_init="xavier",
            updater=lr, clip_threshold=cfg.clip))
        .set_feature_extractor("dis_dense_layer_6")
        .remove_vertex_keep_connections("dis_output_layer_7")
        .add_layer("dis_batch", BatchNorm(n=1024, updater=lr), "dis_dense_layer_6")
        .add_layer("dis_output_layer_7",
                   Output(n_out=cfg.num_classes, n_in=1024, loss="mcxent",
                          activation="softmax", updater=lr),
                   "dis_batch")
        .build()
    )


# Cross-graph weight-sync maps: (dst_layer, src_layer, param names) — the
# reference's setParam copies (dl4jGANComputerVision.java:404-471) as data.
BN_PARAMS = ("gamma", "beta", "mean", "var")
WB_PARAMS = ("W", "b")

DIS_TO_GAN = [
    ("gan_dis_batch_layer_9", "dis_batch_layer_1", BN_PARAMS),
    ("gan_dis_conv2d_layer_10", "dis_conv2d_layer_2", WB_PARAMS),
    ("gan_dis_conv2d_layer_12", "dis_conv2d_layer_4", WB_PARAMS),
    ("gan_dis_dense_layer_14", "dis_dense_layer_6", WB_PARAMS),
    ("gan_dis_output_layer_15", "dis_output_layer_7", WB_PARAMS),
]

GAN_TO_GEN = [
    ("gen_batch_1", "gan_batch_1", BN_PARAMS),
    ("gen_dense_layer_2", "gan_dense_layer_2", WB_PARAMS),
    ("gen_dense_layer_3", "gan_dense_layer_3", WB_PARAMS),
    ("gen_batch_4", "gan_batch_4", BN_PARAMS),
    ("gen_conv2d_6", "gan_conv2d_6", WB_PARAMS),
    ("gen_conv2d_8", "gan_conv2d_8", WB_PARAMS),
]

DIS_TO_CLASSIFIER = [
    ("dis_batch_layer_1", "dis_batch_layer_1", BN_PARAMS),
    ("dis_conv2d_layer_2", "dis_conv2d_layer_2", WB_PARAMS),
    ("dis_conv2d_layer_4", "dis_conv2d_layer_4", WB_PARAMS),
    ("dis_dense_layer_6", "dis_dense_layer_6", WB_PARAMS),
]


def sync_params(dst, src, mapping) -> None:
    """Apply a weight-sync map: tensor aliasing, no device copies."""
    for dst_layer, src_layer, names in mapping:
        dst.set_layer_params(
            dst_layer, {n: src.get_param(src_layer, n) for n in names})
