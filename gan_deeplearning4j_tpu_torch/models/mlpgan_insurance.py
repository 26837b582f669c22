"""MLP-GAN on 4x3 transaction lattices (torch twin of
``gan_deeplearning4j_tpu/models/mlpgan_insurance.py``): the reference's
insurance workload graphs, layer for layer and name for name.

  - discriminator: 12 -> BN -> dense 100 (global ELU) -> dropout (rate 0,
    the identity) -> sigmoid(1), XENT; RmsProp(2e-4, 1e-8, 1e-8), clip
    1.0, L2 1e-4, Xavier.  No input type: the input's size is inferred
    from the BN layer's n = 12.
  - generator: z(2) -> BN -> dense 100 x ``gen_layers`` -> dense 12
    sigmoid; global TANH.
  - stacked gan: the generator layers at lr 4e-4, a discriminator copy at
    lr 0.0 whose layers set ELU explicitly (the gan graph's global
    activation is TANH).
  - transfer classifier: freeze through dis_dropout_layer_3, new BN(100) +
    sigmoid(1) XENT head.

Every builder takes ``device`` (None = the card).
"""

from __future__ import annotations

import dataclasses

from gan_deeplearning4j_tpu_torch.graph import (
    BatchNorm,
    Dense,
    Dropout,
    FineTuneConfiguration,
    GraphBuilder,
    InputSpec,
    Output,
    TransferLearning,
)
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp
from gan_deeplearning4j_tpu_torch.runtime import prng


@dataclasses.dataclass(frozen=True)
class InsuranceConfig:
    """The reference's constants block (dl4jGANInsurance.java:58-84)."""

    seed: int = prng.NUMBER_OF_THE_BEAST
    lattice_rows: int = 4     # periods
    lattice_cols: int = 3     # transaction types
    num_features: int = 12
    z_size: int = 2
    hidden: int = 100
    # generator hidden-dense depth (the reference's is 3); other depths
    # need ``gan_to_gen_map(cfg)`` instead of the literal ``GAN_TO_GEN``
    gen_layers: int = 3
    dis_learning_rate: float = 0.0002
    gen_learning_rate: float = 0.0004
    frozen_learning_rate: float = 0.0
    l2: float = 1e-4
    clip: float = 1.0


def _builder(cfg: InsuranceConfig, activation: str) -> GraphBuilder:
    return GraphBuilder(seed=cfg.seed, l2=cfg.l2, activation=activation,
                        weight_init="xavier", clip_threshold=cfg.clip)


def build_discriminator(cfg: InsuranceConfig = InsuranceConfig(), device=None):
    lr = RmsProp(cfg.dis_learning_rate, 1e-8, 1e-8)
    b = _builder(cfg, "elu")
    b.add_inputs("dis_input_layer_0")
    # no input type, as in the reference: inferred from the BN's n = 12
    b.add_layer("dis_batch_layer_1", BatchNorm(n=cfg.num_features, updater=lr),
                "dis_input_layer_0")
    b.add_layer("dis_dense_layer_2",
                Dense(n_out=cfg.hidden, n_in=cfg.num_features, updater=lr),
                "dis_batch_layer_1")
    b.add_layer("dis_dropout_layer_3", Dropout(rate=0.0), "dis_dense_layer_2")
    b.add_layer("dis_output_layer_4",
                Output(n_out=1, n_in=cfg.hidden, loss="xent",
                       activation="sigmoid", updater=lr),
                "dis_dropout_layer_3")
    b.set_outputs("dis_output_layer_4")
    return b.build(device).init()


def _add_generator_layers(b: GraphBuilder, cfg: InsuranceConfig, lr: RmsProp,
                          prefix: str, input_name: str) -> str:
    """The generator stack, shared by the standalone gen graph and the
    stacked gan graph (names differ only by prefix): at the reference depth
    the denses are ``dense_layer_2..4`` and the output ``dense_layer_5``."""
    if cfg.gen_layers < 1:
        raise ValueError(f"gen_layers must be >= 1, got {cfg.gen_layers}")
    b.add_layer(f"{prefix}_batch_1", BatchNorm(updater=lr), input_name)
    prev = f"{prefix}_batch_1"
    for i in range(2, cfg.gen_layers + 2):
        name = f"{prefix}_dense_layer_{i}"
        b.add_layer(name, Dense(n_out=cfg.hidden, updater=lr), prev)
        prev = name
    out = f"{prefix}_dense_layer_{cfg.gen_layers + 2}"
    b.add_layer(out, Dense(n_out=cfg.num_features, n_in=cfg.hidden,
                           activation="sigmoid", updater=lr), prev)
    return out


def build_generator(cfg: InsuranceConfig = InsuranceConfig(), device=None):
    """Standalone generator, frozen (lr 0.0) — for synthesis only; its
    weights are overwritten from the gan graph each iteration."""
    lr = RmsProp(cfg.frozen_learning_rate, 1e-8, 1e-8)
    b = _builder(cfg, "tanh")
    b.add_inputs("gen_input_layer_0")
    b.set_input_types(InputSpec.feed_forward(cfg.z_size))
    b.set_outputs(_add_generator_layers(b, cfg, lr, "gen", "gen_input_layer_0"))
    return b.build(device).init()


def build_gan(cfg: InsuranceConfig = InsuranceConfig(), device=None):
    """Stacked G+D: generator at gen lr 4e-4, discriminator tail at lr 0.0
    with ELU set per layer (the graph's global activation is TANH)."""
    gen_lr = RmsProp(cfg.gen_learning_rate, 1e-8, 1e-8)
    frz = RmsProp(cfg.frozen_learning_rate, 1e-8, 1e-8)
    b = _builder(cfg, "tanh")
    b.add_inputs("gan_input_layer_0")
    b.set_input_types(InputSpec.feed_forward(cfg.z_size))
    gen_out = _add_generator_layers(b, cfg, gen_lr, "gan", "gan_input_layer_0")
    b.add_layer("gan_dis_batch_layer_6",
                BatchNorm(activation="elu", updater=frz), gen_out)
    b.add_layer("gan_dis_dense_layer_7",
                Dense(n_out=cfg.hidden, n_in=cfg.num_features,
                      activation="elu", updater=frz),
                "gan_dis_batch_layer_6")
    b.add_layer("gan_dis_dropout_layer_8", Dropout(rate=0.0),
                "gan_dis_dense_layer_7")
    b.add_layer("gan_dis_output_layer_9",
                Output(n_out=1, loss="xent", activation="sigmoid", updater=frz),
                "gan_dis_dropout_layer_8")
    b.set_outputs("gan_dis_output_layer_9")
    return b.build(device).init()


def build_classifier(dis, cfg: InsuranceConfig = InsuranceConfig()):
    """Loss-risk classifier on discriminator features, on the
    discriminator's device."""
    lr = RmsProp(cfg.dis_learning_rate, 1e-8, 1e-8)
    return (
        TransferLearning(dis)
        .fine_tune_configuration(FineTuneConfiguration(
            seed=cfg.seed, l2=cfg.l2, activation="elu", weight_init="xavier",
            updater=lr, clip_threshold=cfg.clip))
        .set_feature_extractor("dis_dropout_layer_3")
        .remove_vertex_keep_connections("dis_output_layer_4")
        .add_layer("dis_batch", BatchNorm(n=cfg.hidden, updater=lr),
                   "dis_dropout_layer_3")
        .add_layer("dis_output_layer_4",
                   Output(n_out=1, n_in=cfg.hidden, loss="xent",
                          activation="sigmoid", updater=lr),
                   "dis_batch")
        .build()
    )


# Cross-graph weight-sync maps: (dst_layer, src_layer, param names), with
# the JAX package's layer names (the model zips key on them)
BN_PARAMS = ("gamma", "beta", "mean", "var")
WB_PARAMS = ("W", "b")

DIS_TO_GAN = [
    ("gan_dis_batch_layer_6", "dis_batch_layer_1", BN_PARAMS),
    ("gan_dis_dense_layer_7", "dis_dense_layer_2", WB_PARAMS),
    ("gan_dis_output_layer_9", "dis_output_layer_4", WB_PARAMS),
]


def gan_to_gen_map(cfg: InsuranceConfig = InsuranceConfig()):
    """The gan -> generator sync map for ``cfg``'s depth (``GAN_TO_GEN`` is
    the reference depth's)."""
    out = [("gen_batch_1", "gan_batch_1", BN_PARAMS)]
    for i in range(2, cfg.gen_layers + 3):
        out.append((f"gen_dense_layer_{i}", f"gan_dense_layer_{i}", WB_PARAMS))
    return out


GAN_TO_GEN = gan_to_gen_map()

DIS_TO_CLASSIFIER = [
    ("dis_batch_layer_1", "dis_batch_layer_1", BN_PARAMS),
    ("dis_dense_layer_2", "dis_dense_layer_2", WB_PARAMS),
]
