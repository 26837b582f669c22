"""Preemption handling: a signal becomes a checkpoint, not a lost run (own
copy of ``gan_deeplearning4j_tpu/train/preemption.py``, stdlib only).

A scheduler that evicts a job sends a signal (SIGTERM; some use SIGUSR1)
and allows a grace window.  ``PreemptionGuard`` turns the signal into a
latched flag; the trainer polls it at each call boundary (after the call's
readback), takes an emergency checkpoint through its one save path, writes
a resumable ``PREEMPTED.json`` marker (``preempt_exit``) and raises
``PreemptionError``, which the recovery wrapper re-raises and the mains
turn into exit code 75 (EX_TEMPFAIL: requeue me).  The handler only sets
the flag.  Data-parallel ranks agree at every boundary while the guard is
armed (``parallel/mesh.agree_preemption``), so a signal that reaches one
rank stops them all at the same step.

The JAX module's preemption events and flight record wait for the
telemetry slice.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, Iterable, Optional, Union

# the conventional "temporary failure, requeue me" exit status
EXIT_PREEMPTED = 75

MARKER_NAME = "PREEMPTED.json"


class PreemptionError(RuntimeError):
    """Training was interrupted by a preemption signal after an emergency
    checkpoint was committed; the run resumes with ``--resume``."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 checkpoint: Optional[str] = None):
        super().__init__(msg)
        self.step = step
        self.checkpoint = checkpoint


def _resolve(sig: Union[int, str]) -> int:
    if isinstance(sig, int):
        return sig
    name = sig.strip().upper()
    if not name.startswith("SIG"):
        name = "SIG" + name
    try:
        return getattr(signal, name)
    except AttributeError:
        raise ValueError(
            f"unknown signal {sig!r} (expected e.g. 'SIGTERM', 'SIGUSR1')"
        ) from None


def parse_signals(spec: Union[str, Iterable[Union[int, str]]]) -> tuple:
    """``"SIGTERM,SIGUSR1"`` / ``["TERM", signal.SIGUSR1]`` -> signal
    numbers, validated now (an unknown or uncatchable name fails at
    configuration, not inside the grace window)."""
    if isinstance(spec, str):
        spec = [s for s in spec.split(",") if s.strip()]
    nums = tuple(_resolve(s) for s in spec)
    uncatchable = {getattr(signal, n) for n in ("SIGKILL", "SIGSTOP")
                   if hasattr(signal, n)}
    for n in nums:
        if n in uncatchable:
            raise ValueError(
                f"unknown signal (uncatchable): {signal.Signals(n).name} "
                "cannot have a handler — a hard kill is what the checkpoint "
                "write protocol survives, not what a guard can intercept")
    return nums


def preempt_exit(res_path: str, guard: "PreemptionGuard", *,
                 local_step: int, fleet_min_step: int,
                 checkpoint: Optional[str], run_id: Optional[str] = None):
    """Write the resumable ``PREEMPTED.json`` marker (fsynced) and raise
    ``PreemptionError``.  ``step`` is the step this process's emergency
    checkpoint holds; ``fleet_min_step`` the ranks' agreed step."""
    marker = {
        "step": local_step,
        "fleet_min_step": fleet_min_step,
        "signal": guard.signal_name(),
        "received_at": guard.received_at,
        "checkpoint": checkpoint,
        "run_id": run_id,
    }
    mpath = os.path.join(res_path, MARKER_NAME)
    with open(mpath, "w") as f:
        json.dump(marker, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    raise PreemptionError(
        f"preempted by {guard.signal_name()} at step {local_step}; "
        f"emergency checkpoint at {checkpoint} (resume with --resume)",
        step=local_step, checkpoint=checkpoint)


class PreemptionGuard:
    """Latched signal flag with handler install/uninstall.  ``install()``
    works on the main thread only (and says so elsewhere); the previous
    handlers come back at ``uninstall()``/context exit and are not chained
    on delivery (for SIGTERM that would be "terminate")."""

    def __init__(self, signals: Union[str, Iterable] = ("SIGTERM",)):
        self.signals = parse_signals(signals)
        self._event = threading.Event()
        self._prev: Dict[int, object] = {}
        self.signum: Optional[int] = None
        self.received_at: Optional[float] = None

    def _handler(self, signum, frame) -> None:
        if self.signum is None:
            self.signum = signum
            self.received_at = time.time()
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def signal_name(self) -> Optional[str]:
        if self.signum is None:
            return None
        try:
            return signal.Signals(self.signum).name
        except ValueError:
            return str(self.signum)

    def install(self) -> "PreemptionGuard":
        """Install the handlers; a failure part-way restores those already
        swapped before re-raising."""
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
        except BaseException:
            self.uninstall()
            raise
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError, OSError):  # handlers already gone
                pass
        self._prev.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
