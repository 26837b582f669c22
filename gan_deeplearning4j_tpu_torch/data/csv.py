"""CSV record pipeline, the DataVec equivalent (own copy of
``gan_deeplearning4j_tpu/data/csv.py``, numpy only; tests/test_torch_data.py
pins its tables, batches and files to the JAX package's).

The reference decodes its features+label CSV with DataVec's
``CSVRecordReader`` + ``RecordReaderDataSetIterator``.  Here the whole file
is decoded once into a host numpy array by numpy's C parser, and batches
are views of it; the trainer then moves the table to the card once.

Semantics matched:
  - ``label_index`` column split (``labelIndex=784``)
  - ``num_classes >= 2`` -> one-hot labels; ``num_classes == 1`` -> the
    raw single-column label
  - the ``has_next``/``next``/``reset`` wraparound protocol: a partial
    final batch IS served, as DL4J does; ``strict=True`` raises at
    construction when the row count is not a multiple of the batch size
  - ``shuffle``: a per-epoch permutation that is a pure function of
    (``shuffle_seed``, epoch), so ``state()`` is O(1)

With a ``quarantine`` (``data/resilient.py`` ``RecordQuarantine``) the
decode is row-tolerant: malformed records (wrong width, unparseable,
non-finite, an out-of-range label) are skipped and charged with file:line
(or row) provenance.  The JAX reader's native C++ parser is not ported.
"""

from __future__ import annotations

import dataclasses
import io
import os
from collections import Counter
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataSet:
    """Features+labels pair — DL4J ``org.nd4j.linalg.dataset.DataSet``."""

    features: np.ndarray
    labels: np.ndarray

    def num_examples(self) -> int:
        return self.features.shape[0]


class CSVRowError(ValueError):
    """A malformed CSV record, with file:line provenance."""

    def __init__(self, path: str, line: int, reason: str, raw: str = ""):
        self.path = path
        self.line = line
        self.reason = reason
        self.raw = raw
        super().__init__(
            f"{path}:{line}: {reason}"
            + (f" (row: {raw[:120]!r})" if raw else ""))


class CSVRecordReader:
    """DataVec ``CSVRecordReader(numLinesToSkip, delimiter)`` equivalent:
    decodes the entire file eagerly with numpy's C parser.  A malformed
    record raises ``CSVRowError`` naming its file:line; with a
    ``quarantine`` it is skipped and charged instead (the row parser)."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def read(self, path: str, dtype=np.float32,
             quarantine=None) -> np.ndarray:
        if quarantine is not None:
            return self._read_rows(path, dtype, quarantine.charge)
        try:
            # comments=None: the contract is pure numeric CSV — without it
            # numpy silently DROPS any '#'-prefixed line
            return np.loadtxt(path, delimiter=self.delimiter,
                              skiprows=self.skip_lines, dtype=dtype,
                              ndmin=2, comments=None)
        except ValueError:
            # re-parse row by row to name the first bad record
            def raise_row(file, line=None, row=None, reason="", raw=""):
                raise CSVRowError(file, line, reason, raw)

            return self._read_rows(path, dtype, raise_row)

    def _read_rows(self, path: str, dtype, on_bad_row) -> np.ndarray:
        """Per-record validation: float parse and finiteness per line, then
        the column count against the MAJORITY width of the parseable rows
        (ties go to the width seen first).  Bad records go to
        ``on_bad_row(file, line=, reason=, raw=)`` in line order."""
        parsed = []   # (lineno, vals, raw) — parseable AND finite
        bad = []      # (lineno, reason, raw)
        with open(path, "r") as f:
            for lineno, line in enumerate(f, start=1):
                if lineno <= self.skip_lines:
                    continue
                s = line.strip()
                if not s:
                    continue  # blank line: numpy skips these too
                try:
                    vals = np.asarray(s.split(self.delimiter), dtype=np.float64)
                except ValueError:
                    bad.append((lineno, "unparseable field", s))
                    continue
                if not np.all(np.isfinite(vals)):
                    bad.append((lineno, "non-finite value", s))
                    continue
                parsed.append((lineno, vals, s))
        ncols = None
        if parsed:
            widths = Counter(v.shape[0] for _, v, _ in parsed)
            best = max(widths.values())
            ncols = next(v.shape[0] for _, v, _ in parsed
                         if widths[v.shape[0]] == best)
            bad.extend(
                (ln, f"expected {ncols} columns, got {v.shape[0]}", s)
                for ln, v, s in parsed if v.shape[0] != ncols)
        for lineno, reason, raw in sorted(bad):
            on_bad_row(path, line=lineno, reason=reason, raw=raw)
        rows = [v.astype(dtype) for _, v, _ in parsed if v.shape[0] == ncols]
        if not rows:
            raise ValueError(
                f"{path}: no valid rows survived the tolerant decode")
        return np.stack(rows)


class RecordReaderDataSetIterator:
    """DL4J ``RecordReaderDataSetIterator(reader, batch, labelIndex,
    numClasses)``: fixed-size batches over a decoded table; ``reset()``
    rewinds.  ``source`` is a CSV path or a 2-D array (the table itself,
    label column included).  ``quarantine``: bad records (and, for an
    array source, rows with a non-finite value; for a one-hot label, rows
    whose label is outside [0, num_classes)) are skipped and charged."""

    def __init__(self, source, batch_size: int,
                 label_index: Optional[int] = None, num_classes: int = 1,
                 reader: Optional[CSVRecordReader] = None, dtype=np.float32,
                 strict: bool = False, shuffle: bool = False,
                 shuffle_seed: int = 0, quarantine=None):
        src_name = "<array>"
        if isinstance(source, (str, os.PathLike)):
            src_name = str(source)
            reader = reader or CSVRecordReader()
            if quarantine is not None:
                table = reader.read(str(source), dtype=dtype,
                                    quarantine=quarantine)
            else:
                table = reader.read(str(source), dtype=dtype)
        else:
            table = np.asarray(source, dtype=dtype)
            if table.ndim != 2:
                raise ValueError(f"expected 2-D table, got shape {table.shape}")
            if quarantine is not None:
                bad = ~np.isfinite(table).all(axis=1)
                if bad.any():
                    for i in np.nonzero(bad)[0]:
                        quarantine.charge(src_name, row=int(i),
                                          reason="non-finite value")
                    table = np.ascontiguousarray(table[~bad])
        if strict and table.shape[0] % batch_size != 0:
            raise ValueError(
                f"{table.shape[0]} rows is not a multiple of "
                f"batch_size={batch_size}")
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        if label_index is not None and num_classes >= 2 \
                and quarantine is not None and table.shape[0]:
            # a label outside [0, num_classes) is a corrupt record
            raw = table[:, label_index]
            idx = raw.astype(np.int64)
            bad = (idx < 0) | (idx >= num_classes)
            if bad.any():
                for i in np.nonzero(bad)[0]:
                    quarantine.charge(
                        src_name, row=int(i),
                        reason=f"label {raw[i]!r} outside "
                               f"[0, {num_classes})")
                table = np.ascontiguousarray(table[~bad])
        if label_index is None:
            self._features = table
            self._labels = None
        else:
            self._features = np.ascontiguousarray(
                np.delete(table, label_index, axis=1))
            raw = table[:, label_index]
            if num_classes >= 2:
                idx = raw.astype(np.int64)
                if table.shape[0] and (
                        idx.min() < 0 or idx.max() >= num_classes):
                    raise ValueError(
                        f"label column has values outside [0, {num_classes})")
                labels = np.zeros((table.shape[0], num_classes), dtype=dtype)
                labels[np.arange(table.shape[0]), idx] = 1.0
                self._labels = labels
            else:
                self._labels = raw.reshape(-1, 1).astype(dtype)
        self._cursor = 0
        self._epoch = 0
        self._shuffle = bool(shuffle)
        self._shuffle_seed = int(shuffle_seed)
        self._order = self._epoch_order(0) if self._shuffle else None
        self._preprocessor = None

    @property
    def features(self) -> np.ndarray:
        return self._features

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self._labels

    def num_examples(self) -> int:
        return self._features.shape[0]

    def has_next(self) -> bool:
        return self._cursor < self._features.shape[0]

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        lo = self._cursor
        hi = min(lo + self.batch_size, self._features.shape[0])
        self._cursor = hi
        rows = self._order[lo:hi] if self._order is not None else slice(lo, hi)
        feats = self._features[rows]
        labels = (self._labels[rows] if self._labels is not None
                  else np.zeros((hi - lo, 0), dtype=feats.dtype))
        ds = DataSet(feats, labels)
        if self._preprocessor is not None:
            # contract: preprocess REPLACES ds.features (the normalizers
            # do), never mutates it — feats may be a view of the table
            self._preprocessor.preprocess(ds)
        return ds

    @property
    def preprocessor(self):
        return self._preprocessor

    def set_preprocessor(self, preprocessor) -> None:
        """ND4J ``iterator.setPreProcessor(normalizer)``: applied to every
        ``next()``'s DataSet (``data/normalizers.py``, or any object with
        ``preprocess(DataSet)`` that REPLACES ``features`` rather than
        mutating the passed view)."""
        self._preprocessor = preprocessor

    def reset(self) -> None:
        """Rewind for the next pass; a shuffled iterator re-permutes."""
        self._cursor = 0
        self._epoch += 1
        if self._shuffle:
            self._order = self._epoch_order(self._epoch)

    # -- O(1) resumable state --------------------------------------------------

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """Row permutation for ``epoch``: a pure function of
        (shuffle_seed, epoch)."""
        rng = np.random.RandomState(
            (self._shuffle_seed * 1000003 + epoch) % (2 ** 31 - 1))
        return rng.permutation(self._features.shape[0])

    def state(self) -> dict:
        """(epoch, cursor) plus the shuffle contract; an exhausted position
        normalizes to the next epoch's start."""
        n = self._features.shape[0]
        epoch, cursor = self._epoch, self._cursor
        if n and cursor >= n:
            epoch, cursor = epoch + 1, 0
        return {"v": 1, "epoch": int(epoch), "cursor": int(cursor),
                "shuffle": self._shuffle,
                "shuffle_seed": self._shuffle_seed}

    def restore_state(self, state: dict) -> None:
        """Resume at a ``state()``/``state_for_step()`` position; the
        shuffle contract must match."""
        if state.get("v") != 1:
            raise ValueError(f"unknown iterator state version: {state!r}")
        if bool(state.get("shuffle", False)) != self._shuffle or (
                self._shuffle
                and int(state.get("shuffle_seed", 0)) != self._shuffle_seed):
            raise ValueError(
                "iterator state shuffle contract mismatch: checkpoint "
                f"carries shuffle={state.get('shuffle')}/"
                f"seed={state.get('shuffle_seed')}, iterator is "
                f"shuffle={self._shuffle}/seed={self._shuffle_seed}")
        self._epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        if self._shuffle:
            self._order = self._epoch_order(self._epoch)

    def state_for_step(self, step: int) -> dict:
        """The ``state()`` after ``step`` full batches under the training
        loops' pattern (partial tails consumed and skipped, exhaustion
        wraps), by arithmetic."""
        n = self._features.shape[0]
        full = n // self.batch_size
        if full <= 0:
            raise ValueError(
                f"no full batch of {self.batch_size} in {n} rows — the "
                "consumption pattern never advances")
        return {"v": 1, "epoch": int(step // full),
                "cursor": int((step % full) * self.batch_size),
                "shuffle": self._shuffle,
                "shuffle_seed": self._shuffle_seed}


def write_csv_matrix(path: str, matrix, delimiter: str = ",",
                     fmt: str = "%.8g") -> None:
    """Dump a 2-D array as CSV in the reference's artifact format (comma
    delimiter, no trailing newline)."""
    m = np.asarray(matrix)
    if m.ndim == 1:
        m = m.reshape(1, -1)
    buf = io.StringIO()
    np.savetxt(buf, m, delimiter=delimiter, fmt=fmt)
    with open(path, "w") as f:
        f.write(buf.getvalue().rstrip("\n"))


def read_csv_matrix(path: str, delimiter: str = ",") -> np.ndarray:
    return np.loadtxt(path, delimiter=delimiter, ndmin=2)
