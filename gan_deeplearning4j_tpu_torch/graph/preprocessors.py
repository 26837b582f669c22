"""Input preprocessors (torch twin of ``gan_deeplearning4j_tpu/graph/
preprocessors.py``): pure reshapes."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FeedForwardToCnn:
    """[B, h*w*c] -> [B, c, h, w] (DL4J argument order: height, width, channels)."""

    height: int
    width: int
    channels: int

    def out_shape(self, in_shape):
        return (self.channels, self.height, self.width)

    def __call__(self, x):
        return x.reshape(x.shape[0], self.channels, self.height, self.width)
