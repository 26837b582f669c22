"""Dataset normalizers — ND4J's ``DataNormalization`` preprocessors (torch
twin of ``gan_deeplearning4j_tpu/data/normalizers.py``, numpy-only and
written again here: the JAX package is not imported).

``NormalizerMinMaxScaler`` and ``NormalizerStandardize`` are fit on the
TRAIN split and applied to every ``DataSet`` an iterator yields:

    scaler = NormalizerMinMaxScaler()
    scaler.fit(iter_train)                # train-split stats only
    iter_train.set_preprocessor(scaler)   # applied to every next()
    iter_test.set_preprocessor(scaler)    # test scaled by TRAIN stats

Both save to and load from a small ``.npz`` whose bytes are the JAX
package's, so a file written by either package restores in the other.
"""

from __future__ import annotations

import numpy as np


class _FitNormalizer:
    """fit over an iterator or array; transform features on a DataSet
    (labels untouched, like ND4J's default).

    ``preprocess`` REPLACES ``dataset.features`` with a new array — it
    must not mutate the passed array, which may be a view of the
    iterator's backing table."""

    _STAT_NAMES: tuple = ()     # fitted arrays persisted in save()
    _CONFIG_NAMES: tuple = ()   # constructor scalars persisted in save()

    def __init__(self):
        for n in self._STAT_NAMES:
            setattr(self, n, None)

    # -- fitting -------------------------------------------------------------

    def fit(self, data) -> "_FitNormalizer":
        """``data``: a DataSetIterator or a [N, F] array.  Stats are
        always computed on the RAW features — an iterator's backing table
        is read directly, so a preprocessor already attached to it (even
        this one) cannot leak into the fit."""
        if hasattr(data, "features") and not isinstance(data, np.ndarray):
            x = np.asarray(data.features)
        elif hasattr(data, "reset") and hasattr(data, "next"):
            data.reset()
            batches = []
            while data.has_next():
                batches.append(np.asarray(data.next().features))
            data.reset()
            x = np.concatenate(batches, axis=0)
        else:
            x = np.asarray(data)
        self._fit_array(x)
        return self

    def _fit_array(self, x: np.ndarray) -> None:
        raise NotImplementedError

    def _check_fit(self) -> None:
        if getattr(self, self._STAT_NAMES[0]) is None:
            raise ValueError(f"{type(self).__name__} must be fit first")

    # -- application ---------------------------------------------------------

    def transform(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def revert(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def preprocess(self, dataset) -> None:
        """In-place DataSet preprocessing — ND4J ``preProcess(DataSet)``."""
        dataset.features = self.transform(dataset.features)

    def __call__(self, dataset):
        self.preprocess(dataset)
        return dataset

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        self._check_fit()
        np.savez(path, __type__=type(self).__name__,
                 **{n: getattr(self, n)
                    for n in self._STAT_NAMES + self._CONFIG_NAMES})

    @staticmethod
    def load(path: str) -> "_FitNormalizer":
        with np.load(path) as f:
            kind = str(f["__type__"])
            cls = {c.__name__: c for c in
                   (NormalizerMinMaxScaler, NormalizerStandardize)}[kind]
            out = cls()
            for n in cls._STAT_NAMES:
                setattr(out, n, f[n])
            for n in cls._CONFIG_NAMES:
                if n in f:  # older files lack config scalars
                    setattr(out, n, float(f[n]))
        return out


class NormalizerMinMaxScaler(_FitNormalizer):
    """Scale features to [min_range, max_range] by train-split min/max —
    ND4J NormalizerMinMaxScaler (the notebook's insurance scaling)."""

    _STAT_NAMES = ("data_min", "data_max")
    _CONFIG_NAMES = ("min_range", "max_range")

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        super().__init__()
        self.min_range = float(min_range)
        self.max_range = float(max_range)

    def _fit_array(self, x):
        self.data_min = x.min(axis=0)
        self.data_max = x.max(axis=0)

    def _scale(self):
        span = self.data_max - self.data_min
        return np.where(span == 0, 1.0, span)  # constant columns -> min_range

    def transform(self, features):
        self._check_fit()
        unit = (np.asarray(features) - self.data_min) / self._scale()
        return (unit * (self.max_range - self.min_range)
                + self.min_range).astype(np.float32)

    def revert(self, features):
        self._check_fit()
        unit = (np.asarray(features) - self.min_range) / (
            self.max_range - self.min_range)
        return (unit * self._scale() + self.data_min).astype(np.float32)


class NormalizerStandardize(_FitNormalizer):
    """Zero-mean unit-variance by train-split stats — ND4J
    NormalizerStandardize."""

    _STAT_NAMES = ("mean", "std")

    def _fit_array(self, x):
        self.mean = x.mean(axis=0)
        std = x.std(axis=0)
        self.std = np.where(std == 0, 1.0, std)  # constant columns pass through

    def transform(self, features):
        self._check_fit()
        return ((np.asarray(features) - self.mean) / self.std).astype(
            np.float32)

    def revert(self, features):
        self._check_fit()
        return (np.asarray(features) * self.std + self.mean).astype(np.float32)
