"""Admission control — the bounded front door of the serving plane
(torch twin of ``gan_deeplearning4j_tpu/serve/admission.py``, a copy:
numpy and the stdlib only).

An unbounded request queue converts overload into unbounded latency
(every admitted request waits behind everything before it) and
eventually into an OOM; the production behavior is to REJECT work the
service provably cannot finish inside its latency budget, loudly and
immediately, so the caller can retry elsewhere.  ``AdmissionQueue``
implements exactly that:

* **bounded depth** — more than ``max_depth`` queued requests is a shed
  regardless of rate (the backstop when no service rate is measured
  yet);
* **deadline budget** — once the dispatch loop has measured its service
  rate (a rows/sec EWMA fed by ``note_dispatch``), a request whose
  estimated queue wait ``(queued_rows + rows) / rate`` exceeds
  ``deadline_ms`` is shed on arrival: admitting it would only convert
  one fast failure into one guaranteed SLO miss.

A shed raises ``ShedError`` — a TYPED rejection carrying the depth,
the wait estimate, and the budget — and emits a ``serve.shed`` instant;
it never blocks.  The queue itself
never blocks either: ``submit`` and ``drain`` are lock-and-go, and the
engine's idle wait parks on the ``wake`` event OUTSIDE any lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.telemetry import events

# weight of the newest rows/sec sample in the service-rate EWMA: high
# enough to track a hot-swap or bucket-mix change within a few
# batches, low enough that one slow (compile-paying) dispatch does not
# flip the admission verdict
_RATE_ALPHA = 0.2


class ShedError(RuntimeError):
    """Typed load-shed rejection: the queue is past its depth bound or
    the estimated wait exceeds the deadline budget.  Carries the
    numbers so callers (and tests) can tell WHICH bound tripped."""

    def __init__(self, message: str, *, depth: int,
                 est_wait_ms: Optional[float], budget_ms: float):
        super().__init__(message)
        self.depth = depth
        self.est_wait_ms = est_wait_ms
        self.budget_ms = budget_ms


class Request:
    """One generation request: host-side inputs in, a ``done`` event
    and either ``outputs`` or a typed ``error`` out.  No lock — the
    dispatch thread owns every mutable field until ``done.set()``, the
    submitter only reads after ``done`` (the event IS the barrier)."""

    __slots__ = ("xs", "rows", "done", "outputs", "error",
                 "t_submit", "t_done", "trace")

    def __init__(self, xs: Tuple, trace=None):
        self.xs = tuple(np.asarray(x) for x in xs)
        if not self.xs:
            raise ValueError("a request needs at least one input array")
        self.rows = int(self.xs[0].shape[0])
        if self.rows <= 0:
            raise ValueError("a request needs at least one row")
        self.done = threading.Event()
        self.outputs = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        # a ``tracing.TraceContext``: the engine cuts this request's
        # ``trace.*`` stage spans under it (None records nothing)
        self.trace = trace

    def result(self, timeout: Optional[float] = None) -> List:
        """Block (bounded) for completion; return the output arrays or
        raise the typed error the engine attached."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"request ({self.rows} rows) not served within "
                f"{timeout}s — see /healthz and gan4j_serve_* for why")
        if self.error is not None:
            raise self.error
        return self.outputs

    @property
    def latency_ms(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1000.0


class AdmissionQueue:
    """Bounded FIFO with deadline-budget load shedding.

    ``max_depth``: hard cap on queued requests.  ``deadline_ms``: the
    latency budget — arrivals whose estimated queue wait exceeds it are
    shed once a service rate is measured.  ``wake`` is the engine's
    parking event: set on every admit, cleared when a drain empties the
    queue (the engine waits on it OUTSIDE any lock)."""

    def __init__(self, max_depth: int = 256,
                 deadline_ms: float = 1000.0):
        if max_depth <= 0:
            raise ValueError("max_depth must be > 0")
        if deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")
        self.max_depth = int(max_depth)
        self.deadline_ms = float(deadline_ms)
        self.wake = threading.Event()
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._queued_rows = 0
        self._closed = False
        self._admitted_total = 0
        self._shed_total = 0
        self._rate_rows_per_s: Optional[float] = None

    # -- producer side (any thread) -------------------------------------------

    def submit(self, request: Request) -> Request:
        """Admit ``request`` or raise ``ShedError``.  Never blocks.
        Raises ``RuntimeError`` once the queue is closed — the check
        happens under the SAME lock as the enqueue, so a submit racing
        ``close()`` either lands before the shutdown sweep (and is
        failed by it) or raises; it can never slip in after the sweep
        and strand until the caller's ``result()`` timeout."""
        with self._lock:
            closed = self._closed
            depth = len(self._queue)
            rate = self._rate_rows_per_s
            est_wait_ms = None
            if rate is not None and rate > 0:
                est_wait_ms = ((self._queued_rows + request.rows)
                               / rate * 1000.0)
            if closed:
                reason = None
            elif depth >= self.max_depth:
                reason = (f"queue depth {depth} at the max_depth "
                          f"{self.max_depth} bound")
            elif est_wait_ms is not None \
                    and est_wait_ms > self.deadline_ms:
                reason = (f"estimated wait {est_wait_ms:.0f}ms exceeds "
                          f"the {self.deadline_ms:.0f}ms deadline "
                          f"budget at depth {depth}")
            else:
                self._queue.append(request)
                self._queued_rows += request.rows
                self._admitted_total += 1
                reason = None
            if reason is not None:
                self._shed_total += 1
                shed_total = self._shed_total
        if closed:
            # a closed queue is a STOPPED service, not load shedding:
            # raise the engine's "not running" error, don't count a shed
            raise RuntimeError(
                "admission queue is closed (serve engine stopped)")
        if reason is not None:
            # event + raise OUTSIDE the lock: the recorder may write
            events.instant("serve.shed", depth=depth, rows=request.rows,
                           est_wait_ms=est_wait_ms,
                           budget_ms=self.deadline_ms,
                           shed_total=shed_total)
            raise ShedError(f"request shed: {reason}", depth=depth,
                            est_wait_ms=est_wait_ms,
                            budget_ms=self.deadline_ms)
        self.wake.set()
        return request

    def close(self) -> None:
        """Refuse all further admits: post-close ``submit`` raises
        ``RuntimeError`` under the queue lock instead of enqueueing.
        ``ServeEngine.stop`` closes the queue BEFORE its ``fail_all``
        sweep so nothing can be admitted after the sweep and strand."""
        with self._lock:
            self._closed = True

    def reopen(self) -> None:
        """Accept admits again (an engine restart after ``stop``)."""
        with self._lock:
            self._closed = False

    # -- consumer side (the dispatch thread) -----------------------------------

    def drain(self, max_rows: int) -> List[Request]:
        """Pop queued requests FIFO up to ``max_rows`` total rows —
        requests are never split, and the FIRST one is always taken
        even when larger than ``max_rows`` (the oversized path chunks
        downstream in ``ParallelInference.output``).  Never blocks."""
        with self._lock:
            out: List[Request] = []
            rows = 0
            while self._queue and (
                    not out or rows + self._queue[0].rows <= max_rows):
                r = self._queue.popleft()
                out.append(r)
                rows += r.rows
            self._queued_rows -= rows
            if not self._queue:
                self.wake.clear()
        return out

    def note_dispatch(self, rows: int, seconds: float) -> None:
        """Feed one completed dispatch into the service-rate EWMA —
        the number the deadline-budget shed is computed from."""
        if seconds <= 0 or rows <= 0:
            return
        inst = rows / seconds
        with self._lock:
            prev = self._rate_rows_per_s
            self._rate_rows_per_s = (
                inst if prev is None
                else _RATE_ALPHA * inst + (1.0 - _RATE_ALPHA) * prev)

    def fail_all(self, error: BaseException) -> List[Request]:
        """Pop EVERY queued request and complete it with ``error`` —
        the shutdown / watchdog-timeout path ("never hang": a queued
        request always gets an answer).  Returns the failed requests."""
        with self._lock:
            taken = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            self.wake.clear()
        for r in taken:
            r.error = error
            r.done.set()
        return taken

    # -- introspection ---------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def report(self) -> Dict:
        with self._lock:
            return {"depth": len(self._queue),
                    "queued_rows": self._queued_rows,
                    "admitted_total": self._admitted_total,
                    "shed_total": self._shed_total,
                    "rate_rows_per_s": self._rate_rows_per_s,
                    "deadline_ms": self.deadline_ms,
                    "max_depth": self.max_depth}
