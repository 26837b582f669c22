"""Metric computations matching the notebook's scoring cells (torch twin of
``gan_deeplearning4j_tpu/eval/metrics.py``, the CV half).

``gan.ipynb`` cell 7: read the test CSV's label column and the trainer's
``mnist_test_predictions_{k}.csv``, take argmax over the 10 softmax
columns, compare.  ``write_evaluation_report`` writes the DL4J-style
``evaluation_stats.txt``; the JAX package's loss-curve PNG needs
matplotlib and is not ported.
"""

from __future__ import annotations

import os

import numpy as np

from gan_deeplearning4j_tpu_torch.eval.evaluation import Evaluation


def accuracy_from_predictions(predictions: np.ndarray,
                              labels: np.ndarray) -> float:
    """argmax-match accuracy; ``predictions`` [N, C] scores, ``labels`` [N]."""
    pred = np.asarray(predictions).argmax(axis=1)
    return float((pred == np.asarray(labels).astype(np.int64)).mean())


def write_evaluation_report(res_path: str, predictions, labels,
                            num_classes: int, f1_cls=None) -> dict:
    """DL4J-style Evaluation over the final prediction dump, its stats block
    written to ``evaluation_stats.txt``.  Returns {"test_f1": ...} (class
    ``f1_cls`` if given, else macro)."""
    ev = Evaluation(num_classes)
    ev.eval(labels, predictions)
    with open(os.path.join(res_path, "evaluation_stats.txt"), "w") as f:
        f.write(ev.stats() + "\n")
    return {"test_f1": ev.f1(f1_cls) if f1_cls is not None else ev.f1()}
