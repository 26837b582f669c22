"""Metric computations matching the notebook's scoring cells (torch twin of
``gan_deeplearning4j_tpu/eval/metrics.py``).

``gan.ipynb`` cell 7: read the test CSV's label column and the trainer's
``mnist_test_predictions_{k}.csv``, take argmax over the 10 softmax
columns, compare.  Cell 10: the weighted AUROC of
``insurance_test_predictions_{k}.csv`` against the test labels (the JAX
package calls sklearn's ``roc_auc_score``; here it is the Mann-Whitney
statistic in numpy, sklearn being absent on the card's host).
``write_evaluation_report`` writes the DL4J-style ``evaluation_stats.txt``;
the JAX package's loss-curve PNG needs matplotlib and is not ported.
"""

from __future__ import annotations

import os

import numpy as np

from gan_deeplearning4j_tpu_torch.data.csv import read_csv_matrix
from gan_deeplearning4j_tpu_torch.eval.evaluation import Evaluation


def accuracy_from_predictions(predictions: np.ndarray,
                              labels: np.ndarray) -> float:
    """argmax-match accuracy; ``predictions`` [N, C] scores, ``labels`` [N]."""
    pred = np.asarray(predictions).argmax(axis=1)
    return float((pred == np.asarray(labels).astype(np.int64)).mean())


def _midranks(a: np.ndarray) -> np.ndarray:
    """1-based ranks of ``a``, ties given the mean of the ranks they span."""
    order = np.argsort(a, kind="mergesort")
    sorted_a = a[order]
    # the first position of each run of equal values, and the run's end
    starts = np.flatnonzero(np.r_[True, sorted_a[1:] != sorted_a[:-1]])
    ends = np.r_[starts[1:], a.size]
    run_rank = (starts + ends + 1) / 2.0  # mean of ranks starts+1 .. ends
    ranks = np.empty(a.size, dtype=np.float64)
    ranks[order] = np.repeat(run_rank, ends - starts)
    return ranks


def auroc_from_predictions(scores: np.ndarray, labels: np.ndarray,
                           average: str = "weighted") -> float:
    """The notebook's cell-10 AUROC, ``roc_auc_score(labels, scores,
    average="weighted")`` for binary labels: the Mann-Whitney U over
    n_pos * n_neg, ties counted half (midranks).  For binary labels every
    ``average`` gives this one AUC.  Raises ``ValueError`` when ``labels``
    hold one class only, as sklearn does."""
    if average not in ("weighted", "macro", "micro", "samples", None):
        raise ValueError(f"unknown average {average!r}")
    y = np.asarray(labels).astype(np.int64).ravel()
    s = np.asarray(scores, dtype=np.float64).ravel()
    if y.shape != s.shape:
        raise ValueError(f"labels {y.shape} vs scores {s.shape}")
    classes = np.unique(y)
    if classes.size != 2:
        raise ValueError(
            "Only one class present in y_true. ROC AUC score is not defined "
            "in that case." if classes.size < 2 else
            f"AUROC takes binary labels, got classes {classes.tolist()}")
    pos = y == classes[1]
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    u = _midranks(s)[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def insurance_auroc(predictions_csv: str, test_csv: str,
                    label_index: int = 12) -> float:
    scores = read_csv_matrix(predictions_csv)
    labels = read_csv_matrix(test_csv)[:, label_index]
    return auroc_from_predictions(scores, labels)


def grid_to_lattices(grid_csv_or_array, rows: int, cols: int) -> np.ndarray:
    """Reshape a latent-grid dump [n^2, rows*cols] into [n^2, rows, cols]
    lattices (the notebook's plotting layout)."""
    arr = (read_csv_matrix(grid_csv_or_array)
           if isinstance(grid_csv_or_array, str)
           else np.asarray(grid_csv_or_array))
    return arr.reshape(arr.shape[0], rows, cols)


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
