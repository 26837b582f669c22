from gan_deeplearning4j_tpu_torch.graph.graph import (  # noqa: F401
    ComputationGraph,
    GraphBuilder,
    InputSpec,
)
from gan_deeplearning4j_tpu_torch.graph.layers import (  # noqa: F401
    BatchNorm,
    ConditionalBatchNorm,
    Conv2D,
    ConvTranspose2D,
    Dense,
    Dropout,
    ElementWise,
    MaxPool2D,
    Merge,
    MinibatchStdDev,
    Output,
    ProjectionOutput,
    Upsampling2D,
)
from gan_deeplearning4j_tpu_torch.graph.preprocessors import FeedForwardToCnn  # noqa: F401
from gan_deeplearning4j_tpu_torch.graph.transfer import (  # noqa: F401
    FineTuneConfiguration,
    TransferLearning,
)
