"""PyTorch/CUDA port of ``gan_deeplearning4j_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``optim/``, ``graph/``,
``models/``, ``train/``, ``data/``, ``runtime/``) and never imports it or
jax.  The JAX package's Pallas kernels become hand-written CUDA kernels
under ``csrc/``, wrapped in ``ops/cuda/``.  Entry points run on the GPU
unless the caller asks for the CPU.
"""
