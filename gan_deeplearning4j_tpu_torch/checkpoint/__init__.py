"""Checkpoint / resume (torch twin of ``gan_deeplearning4j_tpu/checkpoint``,
in its on-disk format): periodic multi-graph training-state checkpoints
with pruning, a SHA-256 manifest written last, atomic commits, verified
restore with fallback to the newest good checkpoint, and a background
serializer (``AsyncCheckpointer``)."""

from gan_deeplearning4j_tpu_torch.checkpoint.async_checkpointer import (
    AsyncCheckpointer,
)
from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
    CheckpointCorruptError,
    CheckpointMeshMismatchError,
    NoVerifiedCheckpointError,
    TrainCheckpointer,
)

__all__ = ["AsyncCheckpointer", "CheckpointCorruptError",
           "CheckpointMeshMismatchError", "NoVerifiedCheckpointError",
           "TrainCheckpointer"]
