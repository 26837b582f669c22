"""Resilient ingestion: retries, quarantine and health for the data plane
(own copy of ``gan_deeplearning4j_tpu/data/resilient.py``, numpy and the
stdlib only; tests/test_torch_resilient.py holds it to the JAX module: the
same ``quarantine.jsonl`` bytes, retry counts and error classes).

* ``RetryingSource`` / ``RetryingReader`` wrap a record source (the
  ``has_next``/``next``/``reset`` protocol) or a CSV reader with bounded
  retries and exponential backoff plus jitter on transient errors
  (``OSError``/``EOFError``); exhaustion raises ``DataSourceError``, which
  ``train_with_recovery`` classifies as retryable.
* ``RecordQuarantine`` / ``ValidatingSource`` validate each record at
  ingest (shape, finite values); a bad record is skipped, logged to
  ``quarantine.jsonl`` with file:line (or stream/row) provenance and
  charged against a ``--max-quarantine`` budget; exceeding it raises
  ``DataQuarantineError``, fatal in the recovery wrapper.
* ``DataHealth``: thread-safe counters of both.

The JAX module also emits ``data.retry`` / ``data.quarantine`` events and
feeds a scrape registry; those wait for the telemetry slice.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

# the transient-error class: I/O faults surface as OSError, a truncated read
# of a framed format as EOFError.  A ValueError (a parse failure) replays
# identically, so it goes to quarantine instead
TRANSIENT_ERRORS = (OSError, EOFError)

QUARANTINE_NAME = "quarantine.jsonl"


class DataSourceError(RuntimeError):
    """A data source failed even after bounded retries.  Retryable in
    ``train_with_recovery``: the restart rebuilds the readers with fresh
    file handles and resumes from the last checkpoint."""


class DataQuarantineError(RuntimeError):
    """The corrupt-record quarantine budget is exhausted.  Fatal in
    ``train_with_recovery``: a restart re-reads the same data;
    ``quarantine.jsonl`` names every record."""


class DataHealth:
    """Thread-safe data-plane counters: retries, quarantined records, the
    last error and whether a budget ran out."""

    def __init__(self):
        self._lock = threading.Lock()
        self._retries = 0
        self._quarantined = 0
        self._last_error_wall: Optional[float] = None
        self._last_error: Optional[str] = None
        self._exhausted = False

    def record_retry(self, error: BaseException) -> None:
        with self._lock:
            self._retries += 1
            self._last_error_wall = time.time()
            self._last_error = repr(error)

    def record_quarantine(self, n: int = 1, reason: str = "") -> None:
        with self._lock:
            self._quarantined += n
            self._last_error_wall = time.time()
            if reason:
                self._last_error = reason

    def mark_exhausted(self) -> None:
        with self._lock:
            self._exhausted = True

    @property
    def retries_total(self) -> int:
        with self._lock:
            return self._retries

    @property
    def quarantined_total(self) -> int:
        with self._lock:
            return self._quarantined

    def report(self) -> Dict:
        with self._lock:
            age = (None if self._last_error_wall is None
                   else round(time.time() - self._last_error_wall, 3))
            return {"retries_total": self._retries,
                    "quarantined_total": self._quarantined,
                    "last_error_age_s": age,
                    "last_error": self._last_error,
                    "ok": not self._exhausted}


class RecordQuarantine:
    """Budgeted corrupt-record sink: every charged record lands as one JSON
    line in ``path`` (provenance, reason, a raw excerpt); the charge that
    exceeds ``budget`` raises ``DataQuarantineError``."""

    def __init__(self, path: str, budget: int,
                 health: Optional[DataHealth] = None):
        if budget < 0:
            raise ValueError(f"quarantine budget must be >= 0, got {budget}")
        self.path = path
        self.budget = budget
        self.health = health
        self._lock = threading.Lock()
        self._count = 0
        # charges are idempotent per provenance key: a re-read after a
        # transient error meets the same records again
        self._seen = set()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def charge(self, file: str, line: Optional[int] = None,
               row: Optional[int] = None, reason: str = "",
               raw: str = "") -> None:
        """Quarantine one bad record: append its provenance line, feed the
        health counters, and raise once the budget is exceeded.  A record
        already charged (same file, line, row) is a no-op.  The jsonl write
        is best-effort; the budget accounting is not."""
        key = (file, line, row)
        with self._lock:
            if line is not None or row is not None:
                if key in self._seen:
                    return
                self._seen.add(key)
            self._count += 1
            n = self._count
        entry = {"wall": round(time.time(), 3), "file": file,
                 "line": line, "row": row, "reason": reason,
                 "raw": raw[:200], "n": n, "budget": self.budget}
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        except OSError:  # provenance is diagnostics; the charge is not
            pass
        if self.health is not None:
            self.health.record_quarantine(
                reason=f"quarantined {file}:{line or row}: {reason}")
        if n > self.budget:
            if self.health is not None:
                self.health.mark_exhausted()
            raise DataQuarantineError(
                f"quarantine budget exhausted ({n - 1}/{self.budget} "
                f"records already quarantined) at {file}"
                + (f":{line}" if line is not None else "")
                + (f" row {row}" if row is not None else "")
                + f": {reason} — see {self.path}")


def read_quarantine(path: str) -> list:
    """Decode a ``quarantine.jsonl`` back into dicts."""
    out = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if ln:
                out.append(json.loads(ln))
    return out


def call_with_retries(fn: Callable, what: str, retries: int = 3,
                      backoff_s: float = 0.1, max_backoff_s: float = 5.0,
                      health: Optional[DataHealth] = None,
                      rng: Optional[random.Random] = None,
                      sleep: Callable[[float], None] = time.sleep):
    """``fn()`` with bounded retries on ``TRANSIENT_ERRORS``: backoff
    ``backoff_s * 2^attempt`` (capped) with jitter x[0.5, 1.5).  Each
    failed attempt feeds ``health``; exhaustion raises ``DataSourceError``
    chained on the last error."""
    rng = rng or random
    attempt = 0
    while True:
        try:
            return fn()
        except TRANSIENT_ERRORS as e:
            attempt += 1
            if health is not None:
                health.record_retry(e)
            if attempt > retries:
                raise DataSourceError(
                    f"{what} still failing after {retries} retries: "
                    f"{e!r}") from e
            delay = min(max_backoff_s, backoff_s * (2 ** (attempt - 1)))
            if delay > 0:
                sleep(delay * (0.5 + rng.random()))


class RetryingReader:
    """CSV-reader wrapper: ``read()`` goes through ``call_with_retries``
    (each attempt re-opens the file); everything else delegates."""

    def __init__(self, reader, retries: int = 3, backoff_s: float = 0.1,
                 max_backoff_s: float = 5.0,
                 health: Optional[DataHealth] = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        self.reader = reader
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.health = health
        self._rng = random.Random(seed)
        self._sleep = sleep

    def read(self, path, *a, **kw):
        return call_with_retries(
            lambda: self.reader.read(path, *a, **kw),
            what=f"read {path}", retries=self.retries,
            backoff_s=self.backoff_s, max_backoff_s=self.max_backoff_s,
            health=self.health, rng=self._rng, sleep=self._sleep)

    def __getattr__(self, name):
        return getattr(self.reader, name)


class RetryingSource:
    """DataSet-iterator wrapper: ``has_next``/``next``/``reset`` retry
    transient errors; everything else (``state``, ``restore_state``,
    ``features``, ...) delegates."""

    def __init__(self, source, retries: int = 3, backoff_s: float = 0.1,
                 max_backoff_s: float = 5.0,
                 health: Optional[DataHealth] = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        self.source = source
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.health = health
        self._rng = random.Random(seed)
        self._sleep = sleep

    def _retry(self, fn, what):
        return call_with_retries(
            fn, what=what, retries=self.retries, backoff_s=self.backoff_s,
            max_backoff_s=self.max_backoff_s, health=self.health,
            rng=self._rng, sleep=self._sleep)

    def has_next(self):
        return self._retry(self.source.has_next, "source.has_next")

    def next(self):
        return self._retry(self.source.next, "source.next")

    def reset(self):
        return self._retry(self.source.reset, "source.reset")

    def __getattr__(self, name):
        return getattr(self.source, name)


class ValidatingSource:
    """DataSet-iterator wrapper enforcing the per-record contract at
    ingest: features 2-D of the expected width, every value finite (labels
    included).  A bad row is removed from its batch and charged with
    stream/row provenance; a structurally broken batch is charged once and
    replaced by an empty one.  An undersized batch then takes the prefetch
    layer's skip-and-wrap path, as a partial epoch tail does."""

    def __init__(self, source, quarantine: RecordQuarantine,
                 num_features: Optional[int] = None,
                 name: str = "<stream>"):
        self.source = source
        self.quarantine = quarantine
        self.num_features = num_features
        self.name = name
        self._rows_seen = 0

    def has_next(self):
        return self.source.has_next()

    def reset(self):
        self._rows_seen = 0
        return self.source.reset()

    def next(self):
        from gan_deeplearning4j_tpu_torch.data.csv import DataSet

        ds = self.source.next()
        feats = np.asarray(ds.features)
        labels = np.asarray(ds.labels)
        row0 = self._rows_seen
        self._rows_seen += 0 if feats.ndim != 2 else feats.shape[0]
        if feats.ndim != 2 or (self.num_features is not None
                               and feats.shape[1] != self.num_features):
            want = (self.num_features if self.num_features is not None
                    else "2-D")
            self.quarantine.charge(
                self.name, row=row0,
                reason=f"batch shape {feats.shape} does not match the "
                       f"expected ({want}-wide) record contract")
            width = self.num_features or 0
            return DataSet(np.zeros((0, width), dtype=np.float32),
                           np.zeros((0,) + labels.shape[1:],
                                    dtype=labels.dtype if labels.size
                                    else np.float32))
        bad = ~np.isfinite(feats).all(axis=1)
        if labels.ndim == 2 and labels.shape[0] == feats.shape[0] \
                and labels.size:
            bad |= ~np.isfinite(labels).all(axis=1)
        if not bad.any():
            return ds
        for i in np.nonzero(bad)[0]:
            self.quarantine.charge(self.name, row=row0 + int(i),
                                   reason="non-finite value in record")
        keep = ~bad
        return DataSet(np.ascontiguousarray(feats[keep]),
                       np.ascontiguousarray(labels[keep]))

    def __getattr__(self, name):
        return getattr(self.source, name)
