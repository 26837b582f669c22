"""Hang watchdog — turn a silent stall into a retryable failure (torch
twin of ``gan_deeplearning4j_tpu/train/watchdog.py``).

An exception-driven recovery loop only fires on EXCEPTIONS.  A wedged
collective, a data source that never returns from ``next()``, or a
device readback that never completes raises nothing — the run just stops
making progress forever, which at fleet scale is worse than a crash (a
crash at least frees the accelerator).  ``HeartbeatWatchdog`` closes that
gap:

* the monitored thread **beats** at every step/chunk boundary and at the
  entry/exit of every blocking region (``region()``), so the region name
  in flight is always known;
* a daemon thread checks the age of the last beat against a deadline
  **auto-scaled from the measured steady-state inter-beat interval**
  (``scale`` x a robust median, floored at ``min_deadline_s``) — a loop
  whose cycles legitimately take 30s gets a proportionally longer leash
  than one cycling every 10ms.  Until enough intervals are measured (the
  first cycle pays its one-off builds and captures here) the generous
  ``warmup_s`` deadline applies.  An explicit ``deadline_s`` overrides
  auto-scaling.

On expiry the watchdog, in order: records a ``watchdog.timeout``
instant and dumps the flight-recorder ring (``telemetry/events.py``)
while the stalled state is still in it; runs the ``on_timeout`` callback
(the trainer passes its best-effort emergency checkpoint) on a
SACRIFICIAL thread with a bounded join — if the device is the thing that
hung, the callback hangs with it and is abandoned, never the watchdog;
then raises ``WatchdogTimeout`` **on the monitored thread** via
``PyThreadState_SetAsyncExc``, so the hang unwinds like any other
retryable failure.

Async-raise reaches the target thread at its next bytecode boundary — a
thread blocked inside a C call does not see it until that call returns.
The port's own blocking waits are therefore written as bounded polls
(``utils/device.py`` polls ``event.query()`` instead of synchronizing),
which converts "blocked in C forever" into "interruptible within a poll
tick".  The raise is re-attempted a few times (``max_raises``) in case
the first lands while the thread is briefly inside such a call.

The trainer (``--watchdog``, armed by ``train/shell.py``) beats at every
call boundary and around every blocking region, and
``train_with_recovery`` retries a ``WatchdogTimeout``; the serving engine
(``serve/engine.py``) supervises its dispatch thread with it.
"""

from __future__ import annotations

import ctypes
import logging
import threading
import time
from typing import Callable, Dict, Optional

from gan_deeplearning4j_tpu_torch.telemetry import events

_log = logging.getLogger(__name__)


class WatchdogTimeout(RuntimeError):
    """No heartbeat landed within the watchdog deadline: the run is
    hung (data source, readback, collective, ...).  Raised ON the
    training thread by the watchdog; ``train_with_recovery`` classifies
    it RETRYABLE — a hang becomes a restart-from-checkpoint, not a
    forever-wedged process.  Diagnostics (region in flight, beat age,
    deadline) are in the ``watchdog.timeout`` event and the
    ``flight_record_watchdog_timeout.json`` dump, not on this
    exception: async-raise delivers a bare exception CLASS."""


def _async_raise(thread_ident: int, exc_type) -> bool:
    """Schedule ``exc_type`` on the thread with ``thread_ident``
    (delivered at its next bytecode boundary).  Returns True when
    exactly one thread state was modified."""
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(exc_type))
    if res > 1:  # "should never happen" per CPython docs: undo
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident), None)
        return False
    return res == 1


class HeartbeatWatchdog:
    """Deadline supervisor over one monitored (training) thread.

    ``deadline_s``: explicit fixed deadline; None = auto-scale
    (``scale`` x EWMA of inter-beat intervals, floored at
    ``min_deadline_s``; ``warmup_s`` until ``min_intervals`` beats have
    been measured — the allowance for first-use builds and captures).
    ``on_timeout``: called once on expiry (bounded by
    ``emergency_timeout_s`` on a sacrificial thread).  ``res_path``: where
    the flight record lands.

    Thread-discipline: only beats from the MONITORED thread count (a
    checkpoint worker or the emergency-save thread reporting progress
    must not mask a hung training thread)."""

    # regions that legitimately block for much longer than a steady
    # step the FIRST time they run (a synchronous checkpoint's
    # zip+fsync, a dispatch that pays a CUDA graph capture mid-run): the
    # effective deadline while such a region is open is floored at the
    # region's value — the hang is still detected, just on a leash
    # sized to the region's honest worst case.  data_wait / readback /
    # collective regions (the common hang sites) keep the tight
    # auto-scaled deadline.
    DEFAULT_REGION_FLOORS = {"checkpoint": 120.0, "dispatch": 60.0,
                             "eval": 60.0}

    def __init__(self, deadline_s: Optional[float] = None,
                 warmup_s: float = 300.0, scale: float = 20.0,
                 min_deadline_s: float = 5.0, poll_s: float = 0.25,
                 min_intervals: int = 3,
                 on_timeout: Optional[Callable[[], None]] = None,
                 emergency_timeout_s: float = 30.0,
                 max_raises: int = 3,
                 region_floors: Optional[Dict[str, float]] = None,
                 res_path: Optional[str] = None):
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("watchdog deadline_s must be > 0")
        self.deadline_s = deadline_s
        self.warmup_s = float(warmup_s)
        self.scale = float(scale)
        self.min_deadline_s = float(min_deadline_s)
        self.poll_s = float(poll_s)
        self.min_intervals = int(min_intervals)
        self.on_timeout = on_timeout
        self.res_path = res_path
        self.emergency_timeout_s = float(emergency_timeout_s)
        self.max_raises = int(max_raises)
        self.region_floors = (dict(self.DEFAULT_REGION_FLOORS)
                              if region_floors is None
                              else dict(region_floors))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._monitored_ident: Optional[int] = None
        self._monitored_thread: Optional[threading.Thread] = None
        self._last_beat: Optional[float] = None
        self._last_step: Optional[int] = None
        from collections import deque

        self._samples: "deque" = deque(maxlen=64)
        self._intervals = 0
        self._saw_step_beat = False
        self._region: Optional[str] = None
        self.fired = False
        self.timeouts = 0

    # -- heartbeat (monitored thread) -----------------------------------------

    def beat(self, step: Optional[int] = None) -> None:
        """Record a heartbeat.  Beats from any OTHER thread are ignored
        — progress elsewhere is not progress of the training thread."""
        if self._monitored_ident is not None \
                and threading.get_ident() != self._monitored_ident:
            return
        now = time.perf_counter()
        with self._lock:
            if self._last_beat is not None:
                # rolling MEDIAN of recent inter-beat intervals: robust
                # to the occasional slow outlier (a capture, a sync
                # save) in both directions — the deadline tracks the
                # TYPICAL cadence, `scale` buys the variance
                self._samples.append(now - self._last_beat)
                self._intervals += 1
            self._last_beat = now
            if step is not None:
                # a step-carrying beat means a full protocol step (and
                # therefore the builds and capture the first one pays)
                # completed — the signal that ends the warmup deadline
                self._last_step = step
                self._saw_step_beat = True

    def region(self, name: str):
        """Context manager around a blocking region: beat on entry and
        exit, and remember the region name so a timeout names what was
        in flight."""
        return _Region(self, name)

    # -- deadline math ---------------------------------------------------------

    def effective_deadline(self) -> float:
        with self._lock:
            return self._deadline_locked()

    def _deadline_locked(self) -> float:
        if self.deadline_s is not None:
            # an EXPLICIT deadline is exactly that — the operator's
            # number, not raised by region floors (the config and docs
            # promise "a fixed deadline in seconds"; floors exist to
            # protect the AUTO deadline from legitimately slow regions)
            return self.deadline_s
        floor = 0.0
        if self._region is not None:
            floor = self.region_floors.get(self._region, 0.0)
        # warmup holds until steady state is OBSERVABLE: enough
        # intervals measured AND at least one completed step (the first
        # dispatch pays its capture before any step beat can land —
        # a tight deadline armed from the fast pre-capture beats would
        # false-fire on the capture itself)
        if (self._intervals < self.min_intervals
                or not self._saw_step_beat):
            return max(self.warmup_s, self.min_deadline_s, floor)
        s = sorted(self._samples)
        mid = len(s) // 2
        median = s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])
        return max(self.min_deadline_s, self.scale * median, floor)

    def last_beat_age(self) -> Optional[float]:
        with self._lock:
            if self._last_beat is None:
                return None
            return time.perf_counter() - self._last_beat

    @property
    def stalled(self) -> bool:
        """True once the heartbeat is quiet past the deadline (the
        /healthz 503 signal) — set the instant the deadline passes,
        whether or not the raise has taken effect yet."""
        if self._stop.is_set():
            return False
        with self._lock:
            if self._last_beat is None:
                return False
            age = time.perf_counter() - self._last_beat
            return age > self._deadline_locked()

    def report(self) -> Dict:
        """The watchdog's state (the JAX package's exporter feed)."""
        with self._lock:
            age = (None if self._last_beat is None
                   else time.perf_counter() - self._last_beat)
            deadline = self._deadline_locked()
        return {"last_beat_age_s": age, "deadline_s": deadline,
                "timeouts_total": self.timeouts,
                "stalled": self.stalled, "step": self._last_step}

    # -- lifecycle -------------------------------------------------------------

    def start(self, thread: Optional[threading.Thread] = None
              ) -> "HeartbeatWatchdog":
        """Arm over ``thread`` (default: the calling thread) and start
        the poll loop.  The first beat is implicit — the warmup clock
        starts now, not at the first explicit beat."""
        with self._lock:
            self._monitored_thread = thread or threading.current_thread()
            self._monitored_ident = self._monitored_thread.ident
            self._last_beat = time.perf_counter()
            self._thread = threading.Thread(
                target=self._poll_loop, name="gan4j-watchdog", daemon=True)
            poll_thread = self._thread
        poll_thread.start()
        return self

    def stop(self) -> None:
        """Disarm; no raise is attempted after this returns (the poll
        loop checks the flag immediately before every raise)."""
        self._stop.set()
        with self._lock:
            poll_thread, self._thread = self._thread, None
        if poll_thread is not None:
            # join OUTSIDE the lock: the poll loop takes it every cycle
            poll_thread.join(timeout=self.poll_s * 8 + 1.0)

    def __enter__(self) -> "HeartbeatWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- expiry ----------------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                if self._last_beat is None:
                    continue
                age = time.perf_counter() - self._last_beat
                deadline = self._deadline_locked()
                region, step = self._region, self._last_step
            if age <= deadline:
                continue
            if not self._monitored_alive():
                return  # the run is already unwinding
            self._fire(age, deadline, region, step)
            return

    def _monitored_alive(self) -> bool:
        t = self._monitored_thread
        return t is not None and t.is_alive()

    def _fire(self, age: float, deadline: float,
              region: Optional[str], step: Optional[int]) -> None:
        with self._lock:
            self.fired = True
            self.timeouts += 1
        _log.error(
            "watchdog: no heartbeat for %.1fs (deadline %.1fs, region "
            "%s, step %s) — dumping flight record and raising "
            "WatchdogTimeout on the monitored thread",
            age, deadline, region or "?", step)
        try:
            events.instant("watchdog.timeout", step=step, region=region,
                           age_s=round(age, 3),
                           deadline_s=round(deadline, 3))
            if self.res_path:
                events.dump_flight_record(
                    self.res_path, "watchdog_timeout",
                    extra={"step": step, "region": region,
                           "age_s": round(age, 3),
                           "deadline_s": round(deadline, 3)})
        except Exception:  # diagnostics must never block the raise
            pass
        if self.on_timeout is not None:
            # sacrificial thread: if the DEVICE is what hung, the
            # emergency save hangs on it too — bound it and move on
            done = threading.Event()

            def run() -> None:
                try:
                    self.on_timeout()
                except Exception as e:
                    _log.warning(
                        "watchdog emergency action failed (%r); the "
                        "restart falls back to the last periodic "
                        "checkpoint", e)
                finally:
                    done.set()

            t = threading.Thread(target=run, daemon=True,
                                 name="gan4j-watchdog-emergency")
            t.start()
            if not done.wait(self.emergency_timeout_s):
                _log.warning(
                    "watchdog emergency action still blocked after "
                    "%.0fs — abandoned (the device hang it was racing "
                    "got it too)", self.emergency_timeout_s)
        # raise, then re-raise on a grace cadence in case the first
        # delivery landed while the thread sat inside a C call; a beat
        # (the thread came back to life) or stop() cancels the rest
        for attempt in range(self.max_raises):
            if self._stop.is_set() or not self._monitored_alive():
                return
            with self._lock:
                revived = (self._last_beat is not None
                           and time.perf_counter() - self._last_beat
                           <= deadline)
            if revived:
                return
            _async_raise(self._monitored_ident, WatchdogTimeout)
            if self._stop.wait(max(self.poll_s * 4, 1.0)):
                return


class _Region:
    def __init__(self, wd: HeartbeatWatchdog, name: str):
        self._wd = wd
        self._name = name
        self._prev: Optional[str] = None

    def __enter__(self) -> "_Region":
        wd = self._wd
        if threading.get_ident() == wd._monitored_ident \
                or wd._monitored_ident is None:
            with wd._lock:
                self._prev = wd._region
                wd._region = self._name
        wd.beat()
        return self

    def __exit__(self, *exc) -> None:
        wd = self._wd
        if threading.get_ident() == wd._monitored_ident \
                or wd._monitored_ident is None:
            with wd._lock:
                wd._region = self._prev
        wd.beat()
