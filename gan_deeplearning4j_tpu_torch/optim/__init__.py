from gan_deeplearning4j_tpu_torch.optim.adagrad import AdaGrad  # noqa: F401
from gan_deeplearning4j_tpu_torch.optim.adam import Adam  # noqa: F401
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp  # noqa: F401
from gan_deeplearning4j_tpu_torch.optim.schedules import (  # noqa: F401
    ExponentialSchedule,
    PolySchedule,
    Scheduled,
    SigmoidSchedule,
    StepSchedule,
)
from gan_deeplearning4j_tpu_torch.optim.sgd import Nesterovs, Sgd  # noqa: F401
from gan_deeplearning4j_tpu_torch.optim.updater import GraphUpdater  # noqa: F401
