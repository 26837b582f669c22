"""Fault injectors for the supervision paths (own copies of three of
``gan_deeplearning4j_tpu/testing/chaos.py``'s; the rest of that module is
ROADMAP Queue 1 item 11.3):

* ``HangingSource``: a data source whose ``next()`` never returns (a dead
  storage layer);
* ``NanSource``: a data source that poisons one batch with a NaN (a bad
  record reaching the gradient path);
* ``ReadbackHang`` (the JAX ``hang_at_readback``): a device readback
  that never completes, through ``utils/device.py``'s
  ``_chaos_readback_hook``.

Each hang sleeps in small increments, so the monitored thread stays
interruptible at bytecode boundaries: the only way out is the hang
watchdog (``train/watchdog.py``).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

import numpy as np


class HangingSource:
    """DataSet-iterator wrapper whose ``next()`` blocks FOREVER at the
    ``hang_at``-th call.  One-shot per source: a source constructed fresh
    for a restarted incarnation hangs again, so tests wrap only the first
    incarnation's iterator.  ``hung`` is set once a consumer is stuck."""

    def __init__(self, source, hang_at: int = 0):
        self.source = source
        self.hang_at = hang_at
        self.calls = 0
        self.hung = threading.Event()

    def has_next(self):
        return self.source.has_next()

    def reset(self):
        return self.source.reset()

    def next(self):
        self.calls += 1
        if self.calls - 1 == self.hang_at:
            self.hung.set()
            while True:  # never released — the watchdog's problem now
                time.sleep(0.05)
        return self.source.next()

    def __getattr__(self, name):
        return getattr(self.source, name)


class NanSource:
    """DataSet-iterator wrapper that poisons the features of the
    ``nan_at``-th emitted batch with one NaN (at a position drawn from
    ``rng``)."""

    def __init__(self, source, nan_at: int,
                 rng: Optional[random.Random] = None):
        self.source = source
        self.nan_at = nan_at
        self.emitted = 0
        self.rng = rng or random.Random(0)

    def has_next(self):
        return self.source.has_next()

    def reset(self):
        return self.source.reset()

    def next(self):
        ds = self.source.next()
        if self.emitted == self.nan_at:
            feats = np.array(ds.features, copy=True)
            flat = feats.reshape(-1)
            flat[self.rng.randrange(flat.size)] = np.nan
            ds.features = feats
        self.emitted += 1
        return ds

    def __getattr__(self, name):
        return getattr(self.source, name)


class ReadbackHang:
    """Parks the ``at``-th readback (``device_fence`` or ``readback``) of
    ``utils/device.py`` until the watchdog unwinds it, or ``__exit__``
    releases it.  One-shot.  ``hung`` is set when the readback is stuck;
    ``t_hung`` and ``t_raised`` (``time.perf_counter``) say when it stuck
    and when an exception (the watchdog's) reached it."""

    def __init__(self, at: int):
        self.at = at
        self.calls = 0
        self.fired = False
        self.hung = threading.Event()
        self.t_hung: Optional[float] = None
        self.t_raised: Optional[float] = None
        self._release = threading.Event()
        self._prev = None

    def _hook(self) -> None:
        if self.fired:
            return
        if self.calls == self.at:
            self.fired = True
            self.t_hung = time.perf_counter()
            self.hung.set()
            try:
                while not self._release.is_set():
                    time.sleep(0.05)
            except BaseException:
                self.t_raised = time.perf_counter()
                raise
        self.calls += 1

    def __enter__(self) -> "ReadbackHang":
        from gan_deeplearning4j_tpu_torch.utils import device as device_mod

        self._device_mod = device_mod
        self._prev = device_mod._chaos_readback_hook
        device_mod._chaos_readback_hook = self._hook
        return self

    def __exit__(self, *exc) -> None:
        self._device_mod._chaos_readback_hook = self._prev
        self._release.set()  # free any thread still parked in the hook

