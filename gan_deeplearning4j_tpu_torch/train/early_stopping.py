"""Early stopping — DL4J's ``EarlyStoppingGraphTrainer`` equivalent (torch
twin of ``gan_deeplearning4j_tpu/train/early_stopping.py``).

Trains a ``ComputationGraph`` epoch by epoch from a
``RecordReaderDataSetIterator`` (each batch through the eager ``fit``, so
the graph's listeners fire), scores each epoch on a held-out iterator by
the graph's inference-mode loss (``score_on``, DL4J
``ComputationGraph.score(DataSet)``), tracks the best epoch, stops on
no-improvement patience, a score explosion or max epochs, and restores
(and, with ``save_path``, persists through ``graph/serialization.py``) the
best model:

    result = EarlyStoppingGraphTrainer(
        graph, train_iter, val_iter,
        EarlyStoppingConfig(max_epochs=50, patience=5)).fit()
    result.best_epoch, result.best_score, result.reason

The iterators yield numpy batches; ``fit`` and ``score_on`` move them to
the graph's device.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, NamedTuple, Optional


@dataclasses.dataclass(frozen=True)
class EarlyStoppingConfig:
    """Termination conditions — DL4J's MaxEpochsTermination,
    ScoreImprovementEpochTermination(patience, minImprovement) and
    MaxScoreIterationTermination as one flat config."""

    max_epochs: int = 100
    patience: Optional[int] = None     # epochs without improvement; None = off
    min_improvement: float = 0.0       # improvement smaller than this is none
    max_score: Optional[float] = None  # abort when val score explodes past this
    save_path: Optional[str] = None    # persist the best model zip


class EarlyStoppingResult(NamedTuple):
    reason: str          # "max_epochs" | "patience" | "max_score" | "nan_score"
    details: str
    best_epoch: int
    best_score: float
    total_epochs: int


class EarlyStoppingGraphTrainer:
    """``score_fn``: optional override for the per-epoch validation score
    (graph -> float, lower is better); default = mean inference-mode loss
    over the validation iterator's batches."""

    def __init__(self, graph, train_iter, val_iter=None,
                 config: EarlyStoppingConfig = EarlyStoppingConfig(),
                 score_fn: Optional[Callable] = None):
        if val_iter is None and score_fn is None:
            raise ValueError("need a validation iterator or a score_fn")
        self.graph = graph
        self.train_iter = train_iter
        self.val_iter = val_iter
        self.config = config
        self.score_fn = score_fn

    def _epoch_score(self) -> float:
        if self.score_fn is not None:
            return float(self.score_fn(self.graph))
        total, n = 0.0, 0
        self.val_iter.reset()
        while self.val_iter.has_next():
            ds = self.val_iter.next()
            total += self.graph.score_on(ds.features, ds.labels)
            n += 1
        return total / max(n, 1)

    def fit(self) -> EarlyStoppingResult:
        c = self.config
        best_score = math.inf
        best_epoch = -1
        best_params = None
        stale = 0
        reason, details = "max_epochs", f"completed {c.max_epochs} epochs"
        epoch = 0
        for epoch in range(1, c.max_epochs + 1):
            self.train_iter.reset()
            while self.train_iter.has_next():
                ds = self.train_iter.next()
                self.graph.fit(ds.features, ds.labels)
            score = self._epoch_score()
            if math.isnan(score):
                # NaN compares False against every bound — without this
                # a diverged run would silently train to max_epochs
                reason = "nan_score"
                details = f"validation score NaN at epoch {epoch}"
                break
            if c.max_score is not None and score > c.max_score:
                reason = "max_score"
                details = f"score {score:.6f} > max_score {c.max_score}"
                break
            if score < best_score - c.min_improvement:
                best_score, best_epoch, stale = score, epoch, 0
                # a copy: the next fit replaces every leaf with a new
                # tensor, but a copy holds the best state whatever a
                # later step does to the leaves
                best_params = {layer: {k: v.detach().clone()
                                       for k, v in lp.items()}
                               for layer, lp in self.graph.params.items()}
            else:
                stale += 1
                if c.patience is not None and stale > c.patience:
                    reason = "patience"
                    details = (f"no improvement > {c.min_improvement} for "
                               f"{stale} epochs (best {best_score:.6f} at "
                               f"epoch {best_epoch})")
                    break
        if best_params is not None:
            self.graph.params = best_params
            if c.save_path:
                from gan_deeplearning4j_tpu_torch.graph import serialization

                os.makedirs(os.path.dirname(c.save_path) or ".",
                            exist_ok=True)
                serialization.write_model(self.graph, c.save_path)
        return EarlyStoppingResult(
            reason=reason, details=details, best_epoch=best_epoch,
            best_score=best_score, total_epochs=epoch)
