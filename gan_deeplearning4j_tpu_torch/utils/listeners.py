"""Training listeners — DL4J's ``TrainingListener`` attachment surface
(torch twin of ``gan_deeplearning4j_tpu/utils/listeners.py``).

DL4J models expose ``setListeners(new ScoreIterationListener(100), ...)``
and call ``iterationDone(model, iteration, epoch)`` after every fit.  The
reference attaches none, so this is migration surface, not protocol
parity.

The JAX package's deliberate signature difference holds: the third
``iteration_done`` argument is the step's SCORE, not DL4J's epoch (the GAN
protocol is a single pass over iterations), and the score arrives as a
DEVICE SCALAR (a 0-d tensor on the graph's device).  Reading it
(``float(score)``) synchronizes the host with the card, so the listeners
here read it only at their reporting boundary (every ``print_every`` /
``frequency`` iterations).  Listeners fire on the eager
``ComputationGraph.fit``; the captured multistep paths report through
``utils/metrics.py`` chunk records instead, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple


class TrainingListener:
    """Base: override ``iteration_done``.  ``model`` is the graph that
    just stepped, ``score`` its loss as a device scalar."""

    def iteration_done(self, model, iteration: int, score) -> None:
        raise NotImplementedError


class ScoreIterationListener(TrainingListener):
    """DL4J ScoreIterationListener: log the score every N iterations."""

    def __init__(self, print_every: int = 10,
                 log: Callable[[str], None] = print):
        self.print_every = max(1, print_every)
        self.log = log

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.print_every == 0:
            self.log(f"Score at iteration {iteration} is {float(score)}")


class PerformanceListener(TrainingListener):
    """DL4J PerformanceListener: iterations/sec (and examples/sec when
    the listener can see a batch size) every N iterations."""

    def __init__(self, frequency: int = 10, batch_size: Optional[int] = None,
                 log: Callable[[str], None] = print):
        self.frequency = max(1, frequency)
        self.batch_size = batch_size
        self.log = log
        self._last: Optional[Tuple[int, float]] = None

    def iteration_done(self, model, iteration: int, score) -> None:
        now = time.perf_counter()
        if self._last is None:
            # baseline at the first OBSERVED step (not iteration 0):
            # attaching to an already-trained graph must not fold the
            # unobserved history into the first window's rate
            self._last = (iteration, now)
            return
        if iteration % self.frequency:
            return
        it0, t0 = self._last
        if iteration == it0:
            return
        dt = max(now - t0, 1e-9)
        rate = (iteration - it0) / dt
        msg = f"iteration {iteration}: {rate:.1f} it/s"
        if self.batch_size:
            msg += f", {rate * self.batch_size:.1f} examples/s"
        self.log(msg)
        self._last = (iteration, now)


class CollectScoresListener(TrainingListener):
    """DL4J CollectScoresIterationListener: record (iteration, score)
    pairs every N iterations (each record is a host readback)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))
