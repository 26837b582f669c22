"""Migration shims for the reference stack's idioms (DL4J / ND4J); torch
twin of ``gan_deeplearning4j_tpu/compat``."""

from gan_deeplearning4j_tpu_torch.compat.nd4j import INDArray, Nd4j

__all__ = ["INDArray", "Nd4j"]
