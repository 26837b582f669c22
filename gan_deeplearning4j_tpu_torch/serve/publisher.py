"""Checkpoint publication: the train→serve bridge (torch twin of
``gan_deeplearning4j_tpu/serve/publisher.py``).

``CheckpointPublisher`` watches a trainer's checkpoint directory
(single-model or fleet — both write ``ckpt_{step}`` entries under the
same manifest protocol) and drives every VERIFIED new step through the
control plane's canary deployment, so weights flow from the training
plane to the serving plane with zero manual steps:

* **Verification before announcement** — a step is published only
  after (1) its manifest verifies (SHA-256 over every file: the
  checkpointer's own torn/corrupt detector) and (2) a finite-params
  probe: every float array in the checkpoint's model zips and
  ``state.npz`` must be finite.  A poisoned or torn checkpoint is
  rejected AT PUBLICATION — it never reaches a replica, the canary
  never sees it (``publish.rejected`` event,
  ``gan4j_publish_rejected_total``).
* **The newest step gets the benefit of the doubt** — an unverifiable
  NEWEST step may simply be mid-write (the manifest is the commit
  point); the watcher skips it and re-polls.  An unverifiable step
  with a newer sibling already committed is torn forever: rejected.
* **Canary, not blind push** — publication calls
  ``ControlPlane.deploy(directory, step=N)`` (the step PIN: the exact
  checkpoint the publisher verified is the one that canaries) and
  waits for the deployment to settle.  The control plane's existing
  machinery does the rest: probe baseline → canary hotswap →
  SLO-clean hold window → promote to the mesh, auto-rollback on
  regression.
* **Graceful degradation** — while the trainer is down (preempted,
  rolling back, crashed) no new steps appear; replicas keep serving
  the last promoted weights and ``report()`` turns ``stale`` once the
  promoted checkpoint's age exceeds ``stale_after_s`` — surfaced as
  ``serving_stale`` in ``/healthz`` and the
  ``gan4j_publish_age_seconds`` gauge.
* **Restart without a re-deploy storm** — the publisher persists
  ``{promoted step, rejected/rolled-back steps}`` to
  ``PUBLISHED.json`` (atomic tmp+fsync+rename, same discipline as the
  checkpoints it watches); a restarted publisher resumes from the
  last promoted step instead of replaying history.
* **Rollback is sticky** — a step the canary rolled back is not
  auto-retried (the weights did not change; neither would the
  verdict).  ``republish(step)`` is the explicit operator override.

The checkpoints are the JAX on-disk format either package writes;
tests/test_torch_publisher.py pins the edge cases (torn manifest
mid-write, checkpoint deleted between discovery and verify,
rollback-then-republish, restart resume).
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import zipfile
from typing import Callable, Dict, List, Optional

import numpy as np

from gan_deeplearning4j_tpu_torch.telemetry import events

STATE_NAME = "PUBLISHED.json"

# deployment outcomes _publish understands; "busy"/"failed"/"timeout"
# are transient (retried on a later poll), the rest are recorded
_TERMINAL = ("promoted", "rolled_back", "fatal")


def finite_params_probe(path: str) -> Optional[str]:
    """Probe every float array in ``path``'s model zips (``params.npz``
    members) and ``state.npz`` for non-finite values.  Returns None
    when clean, else a reason naming the offending file/array.  Raises
    ``FileNotFoundError`` when the checkpoint vanished under us (keep
    rotation) — the caller treats "gone" as skip, not reject.

    File-level and graph-free on purpose: the publisher must not need
    a model definition to veto a checkpoint, and the same probe covers
    single-model checkpoints (poisoned zip params) and fleet
    checkpoints (a poisoned tenant slice lives in ``state.npz``).
    """
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    try:
        names = sorted(os.listdir(path))
    except OSError:
        raise FileNotFoundError(path) from None
    for name in names:
        if not name.endswith("_model.zip"):
            continue
        full = os.path.join(path, name)
        try:
            with zipfile.ZipFile(full) as zf:
                if "params.npz" not in zf.namelist():
                    continue
                raw = zf.read("params.npz")
        except FileNotFoundError:
            raise
        except (OSError, zipfile.BadZipFile, KeyError) as e:
            return f"{name} unreadable: {e!r}"
        why = _probe_npz_bytes(raw, f"{name}:params.npz")
        if why:
            return why
    state_path = os.path.join(path, "state.npz")
    if os.path.isfile(state_path):
        try:
            with open(state_path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raise
        except OSError as e:
            return f"state.npz unreadable: {e!r}"
        why = _probe_npz_bytes(raw, "state.npz")
        if why:
            return why
    return None


def _probe_npz_bytes(raw: bytes, label: str) -> Optional[str]:
    try:
        with np.load(io.BytesIO(raw)) as data:
            for key in data.files:
                arr = data[key]
                if (np.issubdtype(arr.dtype, np.floating)
                        and not bool(np.isfinite(arr).all())):
                    return (f"{label}:{key} holds non-finite values "
                            f"(poisoned or corrupt)")
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        return f"{label} unreadable: {e!r}"
    return None


class CheckpointPublisher:
    """Watch ``directory`` for new verified checkpoints and publish
    each through the control plane's canary deployment.

    Exactly one of ``controlplane``/``deploy_fn`` drives deployment:
    ``deploy_fn(directory, step)`` must return one of ``"promoted"``,
    ``"rolled_back"``, ``"failed"``, ``"busy"``, ``"fatal"`` (or a
    ``(outcome, detail)`` pair) — the seam the edge-case tests use.
    ``poll_once()`` is the synchronous unit of work (deterministic
    tests); ``start()`` runs it on the ``gan4j-publisher`` thread
    every ``poll_s`` seconds.
    """

    def __init__(self, directory: str, *,
                 controlplane=None,
                 deploy_fn: Optional[Callable] = None,
                 poll_s: float = 0.5,
                 stale_after_s: float = 120.0,
                 deploy_timeout_s: float = 120.0,
                 state_path: Optional[str] = None):
        if (controlplane is None) == (deploy_fn is None):
            raise ValueError(
                "exactly one of controlplane/deploy_fn is required")
        self.directory = str(directory)
        self.controlplane = controlplane
        self._deploy_fn = deploy_fn
        self.poll_s = float(poll_s)
        self.stale_after_s = float(stale_after_s)
        self.deploy_timeout_s = float(deploy_timeout_s)
        self.state_path = (state_path if state_path is not None
                           else os.path.join(self.directory,
                                             STATE_NAME))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._promoted_step: Optional[int] = None
        self._last_promote_wall: Optional[float] = None
        self._promoted_steps: List[int] = []
        self._rejected: Dict[int, str] = {}
        self._rolled_back: Dict[int, str] = {}
        self._gone: set = set()
        self._force: set = set()
        self._rejected_total = 0
        self._promoted_total = 0
        self._rollback_total = 0
        self._errors_total = 0
        self._fatal: Optional[str] = None
        self._started_wall = time.time()
        self._load_state()

    # -- persisted state -------------------------------------------------------

    def _load_state(self) -> None:
        try:
            with open(self.state_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            # no/corrupt state file means a fresh publisher; first run on a
            # fresh checkout must not fail
            return
        if not isinstance(doc, dict):
            return
        step = doc.get("promoted_step")
        wall = doc.get("promoted_wall")
        with self._lock:
            if isinstance(step, int):
                self._promoted_step = step
            if isinstance(wall, (int, float)):
                self._last_promote_wall = float(wall)
        for key, sink in (("rejected", self._rejected),
                          ("rolled_back", self._rolled_back)):
            entries = doc.get(key)
            if isinstance(entries, dict):
                for s, why in entries.items():
                    try:
                        sink[int(s)] = str(why)
                    except ValueError:
                        # a non-numeric key in a hand-edited state file must
                        # not kill the publisher
                        continue

    def _save_state(self) -> None:
        with self._lock:
            doc = {
                "promoted_step": self._promoted_step,
                "promoted_wall": self._last_promote_wall,
                "rejected": {str(k): v
                             for k, v in self._rejected.items()},
                "rolled_back": {str(k): v
                                for k, v in self._rolled_back.items()},
            }
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "CheckpointPublisher":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("publisher already started")
            t = threading.Thread(
                target=self._run, name="gan4j-publisher", daemon=True)
            self._thread = t
        t.start()
        events.instant("publish.start", directory=self.directory)
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.deploy_timeout_s + 10.0)
        events.instant("publish.stop", directory=self.directory)

    def __enter__(self) -> "CheckpointPublisher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:
                # the watcher thread must survive any single poll (dir
                # vanishing mid-listdir, a deploy raising unexpectedly); the
                # error is counted and on the timeline
                with self._lock:
                    self._errors_total += 1
                events.instant("publish.error", error=repr(e))
            self._stop.wait(self.poll_s)

    # -- the watch loop --------------------------------------------------------

    def _checkpointer(self):
        from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
            TrainCheckpointer,
        )
        # read-side handle: the trainer is ACTIVELY saving into this
        # directory — a sweeping observer would tear its in-flight tmp
        return TrainCheckpointer(self.directory, sweep_debris=False)

    def _candidate(self, step: int) -> bool:
        with self._lock:
            if step in self._force:
                return True
            if step in self._rejected or step in self._rolled_back:
                return False
            if step in self._gone:
                # "gone" is an observation, not a verdict: a re-save of
                # an existing step (emergency preempt checkpoint over a
                # cadence one) swaps via rename/rename, and a poll
                # landing between the renames sees the dir absent for
                # one cycle — when it reappears, reconsider it
                if not os.path.isdir(os.path.join(
                        self.directory, f"ckpt_{step}")):
                    return False
                self._gone.discard(step)
            if (self._promoted_step is not None
                    and step <= self._promoted_step):
                return False
        return True

    def poll_once(self) -> None:
        """One synchronous watch cycle: discover, verify, probe, and
        publish every new step (oldest first — every verified step
        reaches serving, not just the newest).  Stops early when a
        deploy reports busy/failed (retried next cycle) or the newest
        step is still mid-write."""
        if self._fatal is not None:
            return
        try:
            ck = self._checkpointer()
            steps = ck.steps()
        except OSError:
            # the checkpoint dir not existing yet (trainer still booting) is
            # the steady state of a fresh scenario, not an error
            return
        if not steps:
            return
        newest = steps[-1]
        for step in steps:
            if self._stop.is_set():
                return
            if not self._candidate(step):
                continue
            if not self._consider(ck, step, newest):
                return

    def _consider(self, ck, step: int, newest: int) -> bool:
        """Returns False to stop this cycle's scan (mid-write newest,
        busy control plane)."""
        path = os.path.join(self.directory, f"ckpt_{step}")
        if not os.path.isdir(path):
            self._mark_gone(step)
            return True
        try:
            verified = bool(ck.verify(step))
        except Exception as e:
            # verify() reading a dir being deleted under it can raise anything;
            # unverifiable is the answer either way
            events.instant("publish.verify_error", step=step,
                           error=repr(e))
            verified = False
        if not verified:
            if step < newest:
                # a newer sibling committed after this one: this
                # manifest will never complete — torn forever
                self._reject(step, "fails manifest verification "
                                   "(torn or corrupt)")
                return True
            # the newest step may simply be mid-write (the manifest
            # rename is the commit point): skip, re-poll
            events.instant("publish.pending", step=step,
                           reason="newest step unverified "
                                  "(possibly mid-write)")
            return False
        try:
            why = finite_params_probe(path)
        except FileNotFoundError:
            self._mark_gone(step)
            return True
        if why is not None:
            self._reject(step, why)
            return True
        return self._publish(step)

    def _mark_gone(self, step: int) -> None:
        with self._lock:
            self._gone.add(step)
        events.instant("publish.skipped", step=step,
                       reason="checkpoint deleted between discovery "
                              "and verification (keep rotation)")

    def _reject(self, step: int, reason: str) -> None:
        with self._lock:
            self._rejected[step] = reason
            self._rejected_total += 1
        self._save_state()
        events.instant("publish.rejected", step=step, reason=reason,
                       directory=self.directory)

    # -- deployment ------------------------------------------------------------

    def _publish(self, step: int) -> bool:
        """Deploy one verified step; returns False when the cycle
        should stop scanning (busy/transient failure)."""
        events.instant("publish.deploy", step=step,
                       directory=self.directory)
        if self._deploy_fn is not None:
            outcome = self._deploy_fn(self.directory, step)
        else:
            outcome = self._deploy_via_controlplane(step)
        detail = ""
        if isinstance(outcome, tuple):
            outcome, detail = outcome[0], str(outcome[1])
        if outcome == "promoted":
            now = time.time()
            with self._lock:
                self._promoted_step = step
                self._last_promote_wall = now
                self._promoted_total += 1
                self._promoted_steps.append(step)
                self._force.discard(step)
                self._rolled_back.pop(step, None)
            self._save_state()
            events.instant("publish.promoted", step=step,
                           directory=self.directory)
            return True
        if outcome == "rolled_back":
            with self._lock:
                self._rolled_back[step] = detail or "canary rollback"
                self._rollback_total += 1
                self._force.discard(step)
            self._save_state()
            events.instant("publish.rolled_back", step=step,
                           reason=detail or "canary rollback")
            return True
        if outcome == "fatal":
            with self._lock:
                self._fatal = detail or "deployment budget exhausted"
            events.instant("publish.fatal",
                           reason=detail or "deployment budget "
                                            "exhausted")
            return False
        # busy / failed / timeout: transient — nothing recorded, the
        # step stays a candidate for the next cycle
        events.instant("publish.retry", step=step,
                       outcome=str(outcome), reason=detail)
        return False

    def _deploy_via_controlplane(self, step: int):
        from gan_deeplearning4j_tpu_torch.serve.controlplane import (
            DeploymentRollbackError,
        )
        cp = self.controlplane
        try:
            cp.deploy(self.directory, step=step)
        except DeploymentRollbackError as e:
            return ("fatal", str(e))
        except RuntimeError as e:
            return ("busy", str(e))
        deadline = time.monotonic() + self.deploy_timeout_s
        while time.monotonic() < deadline:
            status = cp.deployment_status()
            state = status.get("state")
            if state == "promoted":
                return "promoted"
            if state == "rolled_back":
                if status.get("environmental"):
                    # the canary DIED (chaos, preemption) before the
                    # SLO probes could refute the weights — nothing
                    # was learned about the artifact, so retry it
                    # next cycle instead of stickying it
                    return ("failed",
                            "environmental rollback: "
                            + str(status.get("reason", "")))
                return ("rolled_back", str(status.get("reason", "")))
            if state == "failed":
                return ("failed", str(status.get("reason", "")))
            if state == "failed_fatal":
                return ("fatal", str(status.get("reason", "")))
            if self._stop.wait(min(0.05, self.poll_s)):
                break
        return ("timeout", f"deployment of step {step} did not "
                           f"settle in {self.deploy_timeout_s:.0f}s")

    # -- operator surface ------------------------------------------------------

    def republish(self, step: int) -> None:
        """Clear a step's rejected/rolled-back verdict so the next
        poll re-deploys it — the explicit override for weights an
        operator has inspected (rollback is otherwise sticky: the
        bytes did not change, neither would the canary's verdict)."""
        step = int(step)
        with self._lock:
            self._rejected.pop(step, None)
            self._rolled_back.pop(step, None)
            self._gone.discard(step)
            self._force.add(step)
        self._save_state()
        events.instant("publish.republish", step=step)

    def report(self) -> Dict:
        """Scrape feed for ``MetricsRegistry.observe_publication``
        (the ``gan4j_publish_*`` series and the ``/healthz``
        ``publication`` block)."""
        now = time.time()
        with self._lock:
            anchor = (self._last_promote_wall
                      if self._last_promote_wall is not None
                      else self._started_wall)
            age = max(0.0, now - anchor)
            return {
                "last_step": int(self._promoted_step or 0),
                "age_seconds": round(age, 3),
                "stale": bool(age > self.stale_after_s),
                "promoted_total": self._promoted_total,
                "rejected_total": self._rejected_total,
                "rollback_total": self._rollback_total,
                "errors_total": self._errors_total,
                "promoted_steps": list(self._promoted_steps),
                "fatal": self._fatal,
                "ok": self._fatal is None,
            }
