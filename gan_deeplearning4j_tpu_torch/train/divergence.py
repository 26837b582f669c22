"""Divergence sentinel — trip on the blowup BEFORE the NaNs (own copy of
``gan_deeplearning4j_tpu/train/divergence.py``, stdlib only).

The NaN alarm (telemetry/ingraph.py) fires on the first non-finite
value, which for a diverging GAN is the LAST act: losses and gradient
norms explode for tens of steps first (the classic D-overpowers-G
spiral, the reference papers over it with hand-tuned fixed LRs).  By
the time a NaN materializes, every checkpoint of the blowup window
holds half-cooked weights.  ``DivergenceSentinel`` watches the SAME
metrics stream the NaN alarm rides (``MetricsLogger.on_record``, at the
logger's flush) and trips while the numbers are still finite, so the
rollback/snapshot happens with more healthy checkpoints to fall back
to.

Detection is windowed and robust, per watched series (losses and the
in-graph grad norms):

* keep a rolling window of the last ``window`` finite values;
* once ``min_history`` values exist, a value whose magnitude exceeds
  ``factor`` x the window MEDIAN magnitude (floored at ``floor`` so an
  early near-zero loss cannot make any value look explosive) counts as
  an outlier;
* ``patience`` CONSECUTIVE outliers on one series trip the sentinel —
  a single lucky batch does not.

The sentinel is latched like the NaN alarm (first trip wins, thread
safe) and the trainer decides what a trip means — warn / snapshot /
abort / rollback, the same action vocabulary (train/gan_trainer.py).
``DivergenceError`` (the abort action) is FATAL in
``train_with_recovery``: a deterministic replay from the last
checkpoint marches into the same divergence, exactly the NaN-abort
rationale; the ``rollback`` action is the one that heals
(train/rollback.py — restore an earlier checkpoint, cut the LR,
perturb the noise stream).
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Callable, Dict, Optional

# series suffixes the sentinel watches: the three protocol losses and
# the in-graph global grad norms (d_/g_/clf_ prefixed, telemetry/ingraph)
_WATCH_SUFFIXES = ("_loss", "_grad_norm")


class DivergenceError(RuntimeError):
    """Raised by the trainer when the divergence sentinel trips with
    action="abort".  Fatal in the recovery wrapper (deterministic
    replay re-diverges identically); use the rollback action to heal
    instead."""


class DivergenceSentinel:
    """Windowed loss-explosion / grad-norm-blowup detector over
    materialized metrics records.  See module docstring for the
    detection rule; ``observe`` runs where the MetricsLogger flushes;
    everything it does is O(window) python-float work."""

    def __init__(self, window: int = 64, factor: float = 20.0,
                 patience: int = 3, min_history: int = 8,
                 floor: float = 1e-3,
                 on_trip: Optional[Callable[[Dict], None]] = None):
        if window < min_history:
            raise ValueError(
                f"divergence window ({window}) must be >= min_history "
                f"({min_history})")
        if factor <= 1.0:
            raise ValueError("divergence factor must be > 1")
        if patience < 1:
            raise ValueError("divergence patience must be >= 1")
        self.window = int(window)
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_history = int(min_history)
        self.floor = float(floor)
        self._lock = threading.Lock()
        self._on_trip = on_trip
        self._hist: Dict[str, deque] = {}
        self._streak: Dict[str, int] = {}
        self.tripped = False
        self.step: Optional[int] = None
        self.key: Optional[str] = None
        self.value: Optional[float] = None
        self.baseline: Optional[float] = None
        self.record: Optional[Dict] = None

    @staticmethod
    def _median_abs(values) -> float:
        s = sorted(abs(v) for v in values)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def observe(self, rec: Dict) -> None:
        """MetricsLogger ``on_record`` hook.  Non-finite
        values are the NaN alarm's jurisdiction and are skipped here
        (they would also poison the medians).  The history/streak tables
        mutate under the lock — two threads that flush records must not
        tear a streak and miss (or double-fire) a trip."""
        if self.tripped:
            return
        trip = None
        with self._lock:
            for k, v in rec.items():
                if not isinstance(v, (int, float)) or not k.endswith(
                        _WATCH_SUFFIXES):
                    continue
                v = float(v)
                if not math.isfinite(v):
                    continue
                hist = self._hist.get(k)
                if hist is None:
                    hist = self._hist[k] = deque(maxlen=self.window)
                    self._streak[k] = 0
                if len(hist) >= self.min_history:
                    baseline = max(self._median_abs(hist), self.floor)
                    if abs(v) > self.factor * baseline:
                        self._streak[k] += 1
                        if self._streak[k] >= self.patience:
                            trip = (rec, k, v, baseline)
                            break
                    else:
                        self._streak[k] = 0
                hist.append(v)
        if trip is not None:
            self._trip(*trip)

    def _trip(self, rec: Dict, key: str, value: float,
              baseline: float) -> None:
        with self._lock:
            if self.tripped:  # lost the race to another record
                return
            self.step = rec.get("step")
            self.key = key
            self.value = value
            self.baseline = baseline
            self.record = rec
            self.tripped = True
        if self._on_trip is not None:
            self._on_trip(rec)

    def describe(self) -> str:
        return (f"divergence: {self.key}={self.value:.6g} exceeded "
                f"{self.factor:g}x the rolling median magnitude "
                f"({self.baseline:.6g}) for {self.patience} consecutive "
                f"records, first at step {self.step}")
