"""The supervision shell around a training payload (torch twin of
``gan_deeplearning4j_tpu/train/shell.py``).

``GANTrainer.train()`` runs its loop behind an install/teardown bracket
whose order matters: the event recorder installs BEFORE the watchdog so a
watchdog timeout lands in this run's timeline, and the watchdog disarms
FIRST on the way out so no async raise lands mid-teardown.  The bracket
lives here once; a payload is any zero-arg callable, and the shell tears
down fully on every exit path, including a failure of a later install
stage.

Of the JAX shell's five stages the port has four: the preemption guard,
the recorder, the watchdog and the ``/metrics`` exporter.  The recompile
sentinel (``sanitize``) raises when asked for (ROADMAP Queue 1 item
11.4).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional, Sequence, TypeVar

from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.telemetry.exporter import serve_exporter
from gan_deeplearning4j_tpu_torch.train.preemption import PreemptionGuard
from gan_deeplearning4j_tpu_torch.train.watchdog import HeartbeatWatchdog

T = TypeVar("T")

_log = logging.getLogger(__name__)


class SupervisionShell:
    """Install order (teardown is the exact reverse, watchdog first):

    1. preemption guard (``preempt_signal_nums``) — main-thread only; a
       worker-thread trainer runs unguarded, with a warning;
    2. event recorder → ``events.install`` (the process-wide current
       recorder for the run: ``res_path/events.jsonl`` when
       ``events_enabled`` and a ``res_path``, else the ring alone);
    3. heartbeat watchdog over the calling thread (and its ``/healthz``
       feed in ``registry``);
    4. the ``/metrics`` + ``/healthz`` exporter over ``registry``
       (``telemetry/exporter.py``) when ``metrics_port`` is set (0 =
       ephemeral; the resolved port on ``self.metrics_port`` while the
       payload runs).

    After :meth:`run` installs everything it calls ``payload()`` and
    returns its result.  The live handles (``recorder``, ``watchdog``,
    ``guard``, ``metrics_port``) stay readable on the shell while the
    payload runs — and ``recorder`` stays readable after exit too, so a
    recovery wrapper can still dump the flight record of a failed run (only
    the file sink is closed)."""

    def __init__(
        self,
        registry=None,
        res_path: Optional[str] = None,
        *,
        events_enabled: bool = True,
        events_append: bool = False,
        watchdog: bool = False,
        watchdog_deadline_s: Optional[float] = None,
        watchdog_warmup_s: float = 300.0,
        watchdog_scale: float = 20.0,
        watchdog_min_deadline_s: float = 5.0,
        watchdog_on_timeout: Optional[Callable] = None,
        sanitize: bool = False,
        metrics_port: Optional[int] = None,
        preempt_signal_nums: Sequence[int] = (),
        log: Optional[Callable[[str], None]] = print,
    ):
        if sanitize:
            raise NotImplementedError(
                "the recompile sentinel (sanitize) is not ported yet "
                "(ROADMAP Queue 1 item 11.4)")
        if metrics_port is not None and registry is None:
            raise ValueError("metrics_port needs the registry it serves")
        self._res_path = res_path
        self._events_enabled = events_enabled
        self._events_append = events_append
        self._watchdog_cfg = dict(
            enabled=watchdog, deadline_s=watchdog_deadline_s,
            warmup_s=watchdog_warmup_s, scale=watchdog_scale,
            min_deadline_s=watchdog_min_deadline_s,
            on_timeout=watchdog_on_timeout)
        self._preempt_signal_nums = tuple(preempt_signal_nums or ())
        self._registry = registry
        self._metrics_port_cfg = metrics_port
        self._log = log
        # live handles, populated by run() for the payload's duration
        self.recorder: Optional[events.EventRecorder] = None
        self.watchdog: Optional[HeartbeatWatchdog] = None
        self.guard: Optional[PreemptionGuard] = None
        self.metrics_port: Optional[int] = None

    def run(self, payload: Callable[[], T],
            on_recorder: Optional[Callable] = None) -> T:
        """Bracket ``payload()`` with the full install/teardown.

        ``on_recorder(recorder)`` fires right after the recorder is
        installed (before the watchdog arms): the hook a trainer uses to
        expose the recorder for post-mortem flight-record dumps even when
        a later setup stage fails."""
        guard = None
        if self._preempt_signal_nums:
            guard = PreemptionGuard(self._preempt_signal_nums)
            try:
                guard.install()
            except ValueError:
                # signal handlers are a main-thread privilege; a run
                # driven from a worker thread trains unguarded, loudly
                _log.warning(
                    "preempt_signals configured but not on the main "
                    "thread; preemption guard NOT armed")
                guard = None
        self.guard = guard
        prev_recorder = None
        stop_exporter = None
        try:
            # a resumed run APPENDS to its own event history (as its
            # metrics JSONL does): the pre-crash timeline stays one file
            path = (os.path.join(self._res_path, events.EVENTS_NAME)
                    if self._events_enabled and self._res_path else None)
            self.recorder = events.EventRecorder(
                path=path, enabled=self._events_enabled,
                append=self._events_append)
            prev_recorder = events.install(self.recorder)
            if on_recorder is not None:
                on_recorder(self.recorder)
            wd = self._watchdog_cfg
            if wd["enabled"]:
                # armed AFTER the recorder install so the timeout event
                # and flight record land in this run's timeline
                self.watchdog = HeartbeatWatchdog(
                    deadline_s=wd["deadline_s"],
                    warmup_s=wd["warmup_s"],
                    scale=wd["scale"],
                    min_deadline_s=wd["min_deadline_s"],
                    on_timeout=wd["on_timeout"],
                    res_path=self._res_path)
                self.watchdog.start()
                if self._registry is not None:
                    self._registry.observe_watchdog(self.watchdog.report)
            if self._metrics_port_cfg is not None:
                stop_exporter = serve_exporter(self._registry,
                                               self._metrics_port_cfg)
                self.metrics_port = stop_exporter.port
                if self._log is not None:
                    self._log(f"[metrics] serving /metrics + /healthz on "
                              f"http://127.0.0.1:{stop_exporter.port}")
            return payload()
        finally:
            if self.watchdog is not None:
                # disarm FIRST: no async raise may land while the
                # teardown below runs (stop() joins the poll thread)
                self.watchdog.stop()
                self.watchdog = None
            if stop_exporter is not None:
                stop_exporter()
                self.metrics_port = None
            if prev_recorder is not None:
                events.install(prev_recorder)
            if self.recorder is not None:
                # close the file sink only — the ring stays readable for
                # post-mortem flight-record dumps
                self.recorder.close()
            if guard is not None:
                guard.uninstall()
            self.guard = None
