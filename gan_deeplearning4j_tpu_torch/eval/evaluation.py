"""Batch-accumulating classifier evaluation, DL4J's ``Evaluation`` class
(own copy of ``gan_deeplearning4j_tpu/eval/evaluation.py``, numpy only;
tests/test_torch_eval.py pins its ``stats()`` text to the JAX package's).

Feed ``eval(labels, predictions)`` batch by batch, then read accuracy,
per-class precision / recall / F1 and a printable stats block off the
accumulated confusion matrix.  Macro averages follow DL4J's
``EvaluationAveraging.Macro``: classes whose denominator is zero are
EXCLUDED from the average, not counted as 0; F1 averages over classes
with any tp/fp/fn at all (2tp+fp+fn > 0).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Evaluation:
    def __init__(self, num_classes: int):
        self.num_classes = int(num_classes)
        self._confusion = np.zeros((num_classes, num_classes), dtype=np.int64)

    # -- accumulation --------------------------------------------------------

    def eval(self, labels, predictions) -> None:
        """Accumulate one batch.  ``labels``: [N] class ids or [N, C]
        one-hot/probabilities; ``predictions``: [N, C] scores (argmax is
        taken, like DL4J) or [N] class ids."""
        y = np.asarray(labels)
        p = np.asarray(predictions)
        # [N,1] columns are NOT one-hot: a label column holds class ids;
        # a single-column prediction is a binary sigmoid score (DL4J
        # thresholds it at 0.5).  argmax over one column would silently
        # map everything to class 0.
        if y.ndim == 2 and y.shape[1] == 1:
            y = y.ravel()
        if p.ndim == 2 and p.shape[1] == 1:
            if self.num_classes != 2:
                raise ValueError(
                    "single-column predictions are binary sigmoid scores; "
                    f"this Evaluation has num_classes={self.num_classes}")
            p = (p.ravel() >= 0.5).astype(np.int64)
        if y.ndim == 2:
            y = y.argmax(axis=1)
        if p.ndim == 2:
            p = p.argmax(axis=1)
        y = y.astype(np.int64).ravel()
        p = p.astype(np.int64).ravel()
        if y.shape != p.shape:
            raise ValueError(f"labels {y.shape} vs predictions {p.shape}")
        np.add.at(self._confusion, (y, p), 1)

    # -- scalar metrics ------------------------------------------------------

    def confusion_matrix(self) -> np.ndarray:
        """[true, predicted] counts."""
        return self._confusion.copy()

    def num_examples(self) -> int:
        return int(self._confusion.sum())

    def accuracy(self) -> float:
        n = self._confusion.sum()
        return float(np.trace(self._confusion) / n) if n else 0.0

    def _per_class(self, numer: np.ndarray, denom: np.ndarray) -> np.ndarray:
        out = np.zeros(self.num_classes)
        nz = denom > 0
        out[nz] = numer[nz] / denom[nz]
        return out

    def precision(self, cls: Optional[int] = None) -> float:
        tp = np.diag(self._confusion).astype(float)
        pred_pos = self._confusion.sum(axis=0).astype(float)
        per = self._per_class(tp, pred_pos)
        if cls is not None:
            return float(per[cls])
        return self._macro(per, defined=pred_pos > 0)

    def recall(self, cls: Optional[int] = None) -> float:
        tp = np.diag(self._confusion).astype(float)
        actual_pos = self._confusion.sum(axis=1).astype(float)
        per = self._per_class(tp, actual_pos)
        if cls is not None:
            return float(per[cls])
        return self._macro(per, defined=actual_pos > 0)

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        per = np.array([self.f1(c) for c in range(self.num_classes)])
        return self._macro(per)

    def _macro(self, per_class: np.ndarray,
               defined: Optional[np.ndarray] = None) -> float:
        """DL4J Macro averaging: mean over classes where the metric is
        DEFINED (nonzero denominator), skipping the rest entirely.  The
        default mask (classes appearing in labels or predictions at all)
        is F1's definedness condition, 2tp+fp+fn > 0."""
        if defined is None:
            defined = (self._confusion.sum(axis=0)
                       + self._confusion.sum(axis=1)) > 0
        return float(per_class[defined].mean()) if defined.any() else 0.0

    # -- report --------------------------------------------------------------

    def stats(self) -> str:
        """DL4J-style printable block: headline metrics + the confusion
        matrix (predicted columns, actual rows)."""
        lines = [
            f"Examples: {self.num_examples()}  Classes: {self.num_classes}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall:    {self.recall():.4f}",
            f"F1 Score:  {self.f1():.4f}",
            "Confusion matrix (rows = actual, cols = predicted):",
        ]
        width = max(5, len(str(self._confusion.max())) + 1)
        header = " " * 6 + "".join(f"{c:>{width}}" for c in range(self.num_classes))
        lines.append(header)
        for r in range(self.num_classes):
            row = "".join(f"{v:>{width}}" for v in self._confusion[r])
            lines.append(f"{r:>5} {row}")
        return "\n".join(lines)
