"""Ops layer of the port: plain torch for what the JAX package leaves to
XLA, and ``ops.cuda`` for what it wrote as Pallas kernels."""

from gan_deeplearning4j_tpu_torch.ops import activations, clipping, initializers, losses
from gan_deeplearning4j_tpu_torch.ops.batchnorm import (
    batch_norm_inference,
    batch_norm_inference_cond,
    batch_norm_train,
    batch_norm_train_cond,
)
from gan_deeplearning4j_tpu_torch.ops.conv import conv2d, conv2d_out_size
from gan_deeplearning4j_tpu_torch.ops.dense import dense, dropout
from gan_deeplearning4j_tpu_torch.ops.pool import max_pool2d
from gan_deeplearning4j_tpu_torch.ops.upsample import conv_transpose2d, upsample2d

__all__ = [
    "activations",
    "clipping",
    "initializers",
    "losses",
    "batch_norm_inference",
    "batch_norm_inference_cond",
    "batch_norm_train",
    "batch_norm_train_cond",
    "conv2d",
    "conv2d_out_size",
    "conv_transpose2d",
    "dense",
    "dropout",
    "max_pool2d",
    "upsample2d",
]
