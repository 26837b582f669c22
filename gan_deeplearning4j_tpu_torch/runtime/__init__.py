from gan_deeplearning4j_tpu_torch.runtime import backend, prng  # noqa: F401
