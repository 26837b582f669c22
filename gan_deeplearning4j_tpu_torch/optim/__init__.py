from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp  # noqa: F401
from gan_deeplearning4j_tpu_torch.optim.updater import GraphUpdater  # noqa: F401
