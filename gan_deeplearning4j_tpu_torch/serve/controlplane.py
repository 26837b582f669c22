"""The self-healing control plane over the serving mesh (torch twin of
``gan_deeplearning4j_tpu/serve/controlplane.py``; its replicas are the
port's replica processes, on the card unless the launcher is told
``device="cpu"``).

serve/replica.py gives us replicas as PROCESSES and serve/mesh.py
routes over them; this module closes the loop so the fleet manages
itself.  One named control thread (``gan4j-controlplane``) ticks
three concerns:

1. **self-heal** — a replica process that died (SIGKILL, OOM, crash)
   is removed from the mesh and a replacement is spawned; the mesh's
   ejection already drained its traffic to the survivors.
2. **autoscale** — ``Autoscaler`` turns the mesh's probe aggregate
   (queue-depth sum, p99 max, shed trend) into +1/-1/0 decisions with
   hysteresis: ``up_after`` consecutive hot ticks before growing,
   ``down_after`` idle ticks before shrinking, a cooldown after every
   action, hard ``min/max`` bounds — a noisy metric trace must NOT
   flap the fleet.
3. **deploy** — ``deploy(directory)`` runs the rolling weight
   rollout: hotswap ONE canary replica, hold it under live traffic
   for ``hold_ticks`` SLO-clean probes (finite outputs, no error
   growth, probe latency within ``p99_factor`` of the pre-swap
   baseline), then promote fleet-wide — or auto-rollback the canary
   to the pre-deploy step on any regression.  Every rollback charges
   a ``RollbackManager`` budget keyed to PROMOTED progress, so a
   persistently poisoned checkpoint exhausts the budget and becomes a
   typed fatal (``DeploymentRollbackError``) instead of an infinite
   canary/rollback flap.

Lock discipline: the control-plane lock guards counters and the
deployment record ONLY — every spawn, SIGTERM/SIGKILL, probe, admin call
and event write runs outside it.  A tick that
throws is counted and recorded, never silently lost, and never kills
the loop.
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.serve.client import GatewayHTTPError
from gan_deeplearning4j_tpu_torch.serve.mesh import (
    MeshRouter,
    RemoteReplica,
    ReplicaProbeError,
)
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.train.rollback import (
    RollbackError,
    RollbackManager,
)

# the directory that holds the package: a spawned replica imports it from
# there whatever the caller's working directory
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplicaSpawnError(RuntimeError):
    """The replica subprocess did not produce its ready line — it
    exited, closed stdout, or ran past the ready deadline.  Carries
    the log path so the post-mortem is one ``cat`` away."""

    def __init__(self, message: str, *, log_path: Optional[str] = None):
        super().__init__(message)
        self.log_path = log_path


class DeploymentRollbackError(RollbackError):
    """The deployment budget is exhausted: every canary of this
    checkpoint rolled back and no promote advanced the fleet — the
    checkpoint is POISONED and a human must look.  Typed fatal: the
    control plane refuses further deploys until the budget owner
    decides."""


class ReplicaProcess:
    """One spawned replica subprocess: the Popen handle, the
    host/port its ready line declared, its log path and the seconds
    from the spawn to the ready line.  No lock — the control thread
    owns it; ``alive()`` is a poll."""

    def __init__(self, proc: subprocess.Popen, host: str, port: int,
                 log_path: str, ready_s: Optional[float] = None):
        self.proc = proc
        self.host = host
        self.port = int(port)
        self.log_path = log_path
        self.ready_s = ready_s

    @property
    def name(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL + bounded reap (a zombie holds the pid table)."""
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            # a SIGKILLed child the kernel will not reap within 10s is
            # not a hang waiting longer fixes; alive() keeps reporting it
            pass

    def stop(self, timeout_s: float = 10.0) -> None:
        """SIGTERM (the replica's drain path), bounded wait, then
        SIGKILL — retirement must terminate either way."""
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.kill()


class ReplicaLauncher:
    """Factory for replica subprocesses.

    ``spawn()`` runs ``python -m gan_deeplearning4j_tpu_torch.serve.replica
    --port 0 ...``, waits (bounded) for the ready line on the child's
    stdout to learn the REAL port, then hands the remaining stdout to
    a named daemon pump thread appending into the per-replica log
    (stderr writes there directly).  ``checkpoint`` is the directory
    new replicas boot from (the stable weights — NOT a canary
    directory); ``env`` overrides land on top of the parent's.
    ``device``: None = the card (a host without one makes the child
    exit non-zero: ``ReplicaSpawnError``); any other value is
    forwarded as ``--device``, e.g. ``"cpu"``."""

    def __init__(self, *, checkpoint: Optional[str] = None,
                 buckets: Sequence[int] = (8, 32, 64),
                 log_dir: str = ".", host: str = "127.0.0.1",
                 ready_timeout_s: float = 120.0,
                 env: Optional[Dict[str, str]] = None,
                 events_dir: Optional[str] = None,
                 args: Sequence[str] = (),
                 device: Optional[str] = None):
        self.device = None if device is None else str(device)
        self.checkpoint = checkpoint
        self.buckets = tuple(int(b) for b in buckets)
        self.log_dir = log_dir
        self.host = host
        self.ready_timeout_s = float(ready_timeout_s)
        self.env = dict(env or {})
        # extra CLI args EVERY spawn gets (e.g. ``--fleet``/
        # ``--fleet-tenants N``) — unlike per-spawn ``extra_args``,
        # these survive the control plane's heal/scale respawns
        self.args = tuple(str(a) for a in args)
        # when set, each replica writes its own events timeline there
        # (``replica_{seq}.events.jsonl``) — the per-process files
        # telemetry.tracing.merge_trace_files joins into one
        # cross-process trace view
        self.events_dir = events_dir
        self._seq = 0

    def _read_ready_line(self, proc: subprocess.Popen,
                         log_path: str) -> Dict:
        """Bounded read of the first stdout line (select-polled so a
        wedged child cannot hang the spawner)."""
        deadline = time.monotonic() + self.ready_timeout_s
        buf = b""
        while b"\n" not in buf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._reap(proc)
                raise ReplicaSpawnError(
                    f"replica pid {proc.pid} produced no ready line "
                    f"within {self.ready_timeout_s:.0f}s",
                    log_path=log_path)
            ready, _, _ = select.select([proc.stdout], [], [],
                                        min(remaining, 0.25))
            if not ready:
                if proc.poll() is not None:
                    raise ReplicaSpawnError(
                        f"replica pid {proc.pid} exited rc="
                        f"{proc.returncode} before its ready line",
                        log_path=log_path)
                continue
            chunk = proc.stdout.read1(4096)
            if not chunk:
                self._reap(proc)
                raise ReplicaSpawnError(
                    f"replica pid {proc.pid} closed stdout before "
                    f"its ready line (rc={proc.poll()})",
                    log_path=log_path)
            buf += chunk
        line = buf.split(b"\n", 1)[0]
        try:
            info = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            self._reap(proc)
            raise ReplicaSpawnError(
                f"replica pid {proc.pid} ready line is not JSON "
                f"({e}): {line[:200]!r}", log_path=log_path) from None
        if info.get("event") != "replica_ready" or "port" not in info:
            self._reap(proc)
            raise ReplicaSpawnError(
                f"replica pid {proc.pid} ready line malformed: "
                f"{info!r}", log_path=log_path)
        return info

    @staticmethod
    def _reap(proc: subprocess.Popen) -> None:
        if proc.poll() is None:
            proc.kill()
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass  # the raised ReplicaSpawnError carries the diagnosis

    def spawn(self, *, checkpoint: Optional[str] = None,
              extra_args: Sequence[str] = ()) -> ReplicaProcess:
        """Spawn one replica; returns once it is serving.  Raises
        ``ReplicaSpawnError`` (typed, log path attached) otherwise."""
        self._seq += 1
        seq = self._seq
        log_path = os.path.join(self.log_dir, f"replica_{seq}.log")
        ckpt = checkpoint if checkpoint is not None else self.checkpoint
        cmd = [sys.executable, "-m",
               "gan_deeplearning4j_tpu_torch.serve.replica",
               "--port", "0", "--host", self.host,
               "--buckets", ",".join(str(b) for b in self.buckets)]
        if self.device is not None:
            cmd += ["--device", self.device]
        if ckpt:
            cmd += ["--checkpoint", str(ckpt)]
        if self.events_dir:
            cmd += ["--events", os.path.join(
                self.events_dir, f"replica_{seq}.events.jsonl")]
        cmd += list(self.args) + list(extra_args)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        env.update(self.env)
        t0 = time.perf_counter()
        with open(log_path, "ab") as log_f:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=log_f, env=env)
        info = self._read_ready_line(proc, log_path)
        ready_s = time.perf_counter() - t0
        pump = threading.Thread(
            target=self._pump_stdout, args=(proc, log_path),
            name=f"gan4j-replica-pump-{seq}", daemon=True)
        pump.start()
        events.instant("controlplane.replica_spawned",
                       pid=proc.pid, port=int(info["port"]),
                       log=log_path, ready_s=ready_s)
        return ReplicaProcess(proc, self.host, int(info["port"]),
                              log_path, ready_s)

    @staticmethod
    def _pump_stdout(proc: subprocess.Popen, log_path: str) -> None:
        with open(log_path, "ab") as f:
            for chunk in iter(lambda: proc.stdout.read1(4096), b""):
                f.write(chunk)
                f.flush()


class Autoscaler:
    """Pure hysteresis: metrics aggregate in, +1/-1/0 out.  No locks,
    no I/O — the control thread is its only caller, and the unit
    tests drive it with synthetic traces.

    Hot = queue depth, p99, OR the shed delta since the last tick at
    or past its ``up_*`` threshold; ``up_after`` consecutive hot
    ticks grow the fleet.  Idle = depth 0, no sheds, p99 under
    ``down_p99_ms``; ``down_after`` consecutive idle ticks shrink it.
    Any action arms ``cooldown_ticks`` of forced no-ops and resets
    both streaks; bounds always win."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 up_queue_depth: float = 4.0, up_p99_ms: float = 500.0,
                 up_shed_delta: int = 1, up_after: int = 2,
                 down_p99_ms: Optional[float] = None,
                 down_after: int = 10, cooldown_ticks: int = 4):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_queue_depth = float(up_queue_depth)
        self.up_p99_ms = float(up_p99_ms)
        self.up_shed_delta = int(up_shed_delta)
        self.up_after = int(up_after)
        self.down_p99_ms = (float(up_p99_ms) / 4.0
                            if down_p99_ms is None
                            else float(down_p99_ms))
        self.down_after = int(down_after)
        self.cooldown_ticks = int(cooldown_ticks)
        self._hot_streak = 0
        self._idle_streak = 0
        self._cooldown = 0
        self._last_shed: Optional[int] = None

    def tick(self, metrics: Dict, n_replicas: int) -> int:
        """Feed one aggregate (keys ``queue_depth``/``p99_ms``/
        ``shed_total``); returns the scale decision."""
        depth = float(metrics.get("queue_depth") or 0)
        p99 = float(metrics.get("p99_ms") or 0.0)
        shed = int(metrics.get("shed_total") or 0)
        shed_delta = (0 if self._last_shed is None
                      else max(0, shed - self._last_shed))
        self._last_shed = shed
        hot = (depth >= self.up_queue_depth
               or p99 >= self.up_p99_ms
               or shed_delta >= self.up_shed_delta)
        idle = (depth <= 0 and shed_delta == 0
                and p99 <= self.down_p99_ms)
        self._hot_streak = self._hot_streak + 1 if hot else 0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        if (self._hot_streak >= self.up_after
                and n_replicas < self.max_replicas):
            self._hot_streak = 0
            self._idle_streak = 0
            self._cooldown = self.cooldown_ticks
            return 1
        if (self._idle_streak >= self.down_after
                and n_replicas > self.min_replicas):
            self._hot_streak = 0
            self._idle_streak = 0
            self._cooldown = self.cooldown_ticks
            return -1
        return 0


class CanaryDeployment:
    """Pure per-deploy state machine: one SLO probe observation in,
    ``hold`` / ``promote`` / ``rollback`` out.

    Clean = finite outputs, no typed-error growth, probe latency
    within ``max(p99_floor_ms, baseline * p99_factor)``.
    ``hold_ticks`` consecutive clean observations promote; ONE dirty
    observation rolls back (a canary exists to be paranoid — the
    budget, not the window, is what bounds flapping)."""

    def __init__(self, directory: str, step: int, *,
                 baseline_ms: Optional[float],
                 hold_ticks: int = 3, p99_factor: float = 3.0,
                 p99_floor_ms: float = 250.0):
        self.directory = directory
        self.step = int(step)
        self.baseline_ms = baseline_ms
        self.hold_ticks = int(hold_ticks)
        self.p99_factor = float(p99_factor)
        self.p99_floor_ms = float(p99_floor_ms)
        self.clean = 0
        self.state = "canary"
        self.reason: Optional[str] = None

    def _bound_ms(self) -> Optional[float]:
        if self.baseline_ms is None:
            return None
        return max(self.p99_floor_ms,
                   self.baseline_ms * self.p99_factor)

    def observe(self, *, probe_ms: Optional[float], finite: bool,
                errors_delta: int = 0,
                failure: Optional[str] = None) -> str:
        """One observation of the canary under live traffic."""
        if self.state != "canary":
            return self.state
        dirty = failure
        if dirty is None and not finite:
            dirty = "non-finite outputs from the canary weights"
        if dirty is None and errors_delta > 0:
            dirty = (f"typed error count grew by {errors_delta} "
                     f"under the canary")
        bound = self._bound_ms()
        if dirty is None and probe_ms is not None \
                and bound is not None and probe_ms > bound:
            dirty = (f"probe latency {probe_ms:.0f}ms exceeds the "
                     f"{bound:.0f}ms SLO bound "
                     f"(baseline {self.baseline_ms:.0f}ms x "
                     f"{self.p99_factor:g})")
        if dirty is not None:
            self.state = "rolled_back"
            self.reason = dirty
            return "rollback"
        self.clean += 1
        if self.clean >= self.hold_ticks:
            self.state = "promoted"
            return "promote"
        return "hold"


class ControlPlane:
    """Owns the launcher, the mesh, the autoscaler, and the deploy
    budget; runs the tick loop on its named thread.  ``start()``
    spawns up to ``min_replicas`` before returning, so a started
    control plane is a SERVING control plane."""

    def __init__(self, launcher: ReplicaLauncher, *,
                 mesh: Optional[MeshRouter] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 tick_s: float = 0.5,
                 hold_ticks: int = 3, p99_factor: float = 3.0,
                 p99_floor_ms: float = 250.0,
                 max_rollbacks: int = 2,
                 probe_rows: int = 4, probe_timeout_s: float = 30.0):
        self.launcher = launcher
        self.mesh = mesh if mesh is not None else MeshRouter()
        self.autoscaler = autoscaler if autoscaler is not None \
            else Autoscaler()
        self.tick_s = float(tick_s)
        self.hold_ticks = int(hold_ticks)
        self.p99_factor = float(p99_factor)
        self.p99_floor_ms = float(p99_floor_ms)
        self.probe_rows = int(probe_rows)
        self.probe_timeout_s = float(probe_timeout_s)
        self._budget = RollbackManager(max_rollbacks=max_rollbacks)
        self._lock = threading.Lock()
        self._procs: Dict[str, ReplicaProcess] = {}
        self._canary_name: Optional[str] = None
        self._canary: Optional[CanaryDeployment] = None
        self._pending_deploy: Optional[Tuple[str, Optional[int]]] = None
        self._deploy_state: Dict = {"state": "idle"}
        self._fatal: Optional[str] = None
        self._scale_up_total = 0
        self._scale_down_total = 0
        self._replaced_total = 0
        self._rollbacks_total = 0
        self._promoted_total = 0
        self._deploy_failed_total = 0
        self._tick_errors_total = 0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "ControlPlane":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("control plane already started")
        # reach min_replicas BEFORE the loop starts: a started
        # control plane is a serving one.  Bounded attempts — a
        # persistently failing spawn is a typed error, not a hang.
        attempts = 0
        while len(self.mesh.names()) < self.autoscaler.min_replicas:
            if attempts >= 2 * self.autoscaler.min_replicas:
                raise ReplicaSpawnError(
                    f"could not reach min_replicas="
                    f"{self.autoscaler.min_replicas} after "
                    f"{attempts} spawn attempts (see replica logs "
                    f"in {self.launcher.log_dir})")
            attempts += 1
            self._spawn_one()
        thread = threading.Thread(
            target=self._run, name="gan4j-controlplane", daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        events.instant("controlplane.start",
                       replicas=len(self.mesh.names()))
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        with self._lock:
            thread, self._thread = self._thread, None
            procs = list(self._procs.values())
            self._procs = {}
        if thread is not None:
            thread.join(timeout=30.0)
        for p in procs:
            self.mesh.remove(p.name)
            p.stop()
        events.instant("controlplane.stop")

    def __enter__(self) -> "ControlPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- public API ------------------------------------------------------------

    def deploy(self, directory: str,
               step: Optional[int] = None) -> None:
        """Queue a rolling deployment of ``directory`` (picked up on
        the next tick).  ``step`` pins the EXACT checkpoint to canary
        (a caller that verified a step deploys exactly that step —
        "newest verified" could silently pick up a younger save it
        never probed).  Raises
        ``DeploymentRollbackError`` once the budget is exhausted,
        ``RuntimeError`` while another deploy is still in flight."""
        with self._lock:
            if self._fatal is not None:
                raise DeploymentRollbackError(self._fatal)
            busy = (self._pending_deploy is not None
                    or self._canary is not None)
            if busy:
                raise RuntimeError(
                    "a deployment is already in flight; wait for "
                    "deployment_status() to settle")
            self._pending_deploy = (
                str(directory), None if step is None else int(step))
            self._deploy_state = {"state": "pending",
                                  "directory": str(directory)}
            if step is not None:
                self._deploy_state["step"] = int(step)

    def deployment_status(self) -> Dict:
        with self._lock:
            return dict(self._deploy_state)

    def report(self) -> Dict:
        """Scrape feed for ``MetricsRegistry.observe_controlplane``
        (the ``gan4j_controlplane_*`` series and the ``/healthz``
        controlplane block)."""
        with self._lock:
            out = {
                "replicas": len(self._procs),
                "scale_up_total": self._scale_up_total,
                "scale_down_total": self._scale_down_total,
                "replaced_total": self._replaced_total,
                "rollbacks_total": self._rollbacks_total,
                "promoted_total": self._promoted_total,
                "deploy_failed_total": self._deploy_failed_total,
                "tick_errors_total": self._tick_errors_total,
                "deploy_state": self._deploy_state.get("state"),
                "fatal": self._fatal,
                "ok": self._fatal is None,
            }
        return out

    def replica_names(self) -> List[str]:
        with self._lock:
            return list(self._procs)

    def process(self, name: str) -> Optional[ReplicaProcess]:
        """The live ``ReplicaProcess`` behind ``name`` (the chaos
        harness surface — ``kill_replica_process`` takes this)."""
        with self._lock:
            return self._procs.get(name)

    # -- the tick loop ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop_evt.wait(self.tick_s):
            try:
                self._tick()
            except Exception as e:
                # a broken tick is COUNTED and recorded, never lost,
                # and never kills the loop — the next tick retries
                with self._lock:
                    self._tick_errors_total += 1
                events.instant("controlplane.tick_error",
                               error=repr(e))

    def _tick(self) -> None:
        self._heal()
        if self._stop_evt.is_set():
            return
        agg = self.mesh.poll()
        self._autoscale(agg)
        if self._stop_evt.is_set():
            return
        self._advance_deploy()

    # -- self-heal -------------------------------------------------------------

    def _heal(self) -> None:
        with self._lock:
            dead = [(name, p) for name, p in self._procs.items()
                    if not p.alive()]
        for name, proc in dead:
            with self._lock:
                self._procs.pop(name, None)
                self._replaced_total += 1
                canary_died = (self._canary_name == name
                               and self._canary is not None)
            self.mesh.remove(name)
            events.instant("controlplane.replica_replaced",
                           replica=name, pid=proc.pid,
                           rc=proc.proc.returncode)
            if canary_died:
                self._finish_rollback(
                    "canary replica process died mid-hold",
                    environmental=True)
            self._spawn_one()

    def _spawn_one(self) -> Optional[ReplicaProcess]:
        try:
            proc = self.launcher.spawn()
        except ReplicaSpawnError as e:
            events.instant("controlplane.spawn_failed", error=str(e),
                           log=e.log_path)
            return None
        self.mesh.add(RemoteReplica(proc.host, proc.port))
        with self._lock:
            self._procs[proc.name] = proc
        return proc

    # -- autoscale -------------------------------------------------------------

    def _autoscale(self, agg: Dict) -> None:
        with self._lock:
            n = len(self._procs)
        delta = self.autoscaler.tick(agg, n)
        if delta > 0:
            proc = self._spawn_one()
            if proc is not None:
                with self._lock:
                    self._scale_up_total += 1
                events.instant("controlplane.scale_up",
                               replica=proc.name,
                               queue_depth=agg.get("queue_depth"),
                               p99_ms=agg.get("p99_ms"))
        elif delta < 0:
            victim = self._pick_retire_victim()
            if victim is None:
                return
            with self._lock:
                proc = self._procs.pop(victim, None)
                self._scale_down_total += 1
            self.mesh.remove(victim)
            if proc is not None:
                proc.stop()
            events.instant("controlplane.scale_down", replica=victim)

    def _pick_retire_victim(self) -> Optional[str]:
        """Newest non-canary replica (dict order = spawn order)."""
        with self._lock:
            names = [n for n in self._procs
                     if n != self._canary_name]
        return names[-1] if names else None

    # -- deployment ------------------------------------------------------------

    def _probe_canary(self, replica: RemoteReplica
                      ) -> Tuple[Optional[float], bool,
                                 Optional[str]]:
        """One live-traffic SLO probe: a small real generate.
        Returns ``(latency_ms, finite, typed_failure)``."""
        xs = [np.zeros((self.probe_rows, 2), np.float32)]
        t0 = time.perf_counter()
        try:
            outs = replica.generate(xs)
        except (GatewayHTTPError, ReplicaProbeError, OSError) as e:
            return None, True, f"canary probe failed: {e}"
        ms = (time.perf_counter() - t0) * 1000.0
        finite = all(bool(np.isfinite(np.asarray(o)).all())
                     for o in outs)
        return ms, finite, None

    def _advance_deploy(self) -> None:
        with self._lock:
            pending = self._pending_deploy
            self._pending_deploy = None
            canary = self._canary
            canary_name = self._canary_name
        if pending is not None and canary is None:
            self._start_canary(*pending)
            return
        if canary is None:
            return
        replica = self.mesh.get(canary_name) \
            if canary_name is not None else None
        if replica is None:
            self._finish_rollback("canary replica left the mesh",
                                  environmental=True)
            return
        probe_ms, finite, failure = self._probe_canary(replica)
        errors_delta = 0
        verdict = canary.observe(probe_ms=probe_ms, finite=finite,
                                 errors_delta=errors_delta,
                                 failure=failure)
        events.instant("controlplane.canary_observe",
                       verdict=verdict, probe_ms=probe_ms,
                       finite=finite, failure=failure)
        if verdict == "promote":
            self._finish_promote(canary)
        elif verdict == "rollback":
            environmental = False
            if failure is not None:
                # the probe never got an answer out of the canary
                # (connection reset, refused, timeout).  That refutes
                # the WEIGHTS only if the process behind it is still
                # standing; if it died under us (chaos, preemption)
                # the wire error is just the death seen from the
                # client side — same environmental verdict as the
                # canary-died scan path
                proc = self.process(canary_name) \
                    if canary_name is not None else None
                environmental = proc is None or not proc.alive()
            self._finish_rollback(canary.reason or "slo regression",
                                  environmental=environmental)

    def _start_canary(self, directory: str,
                      step: Optional[int] = None) -> None:
        names = self.mesh.names()
        replica = None
        for name in names:
            replica = self.mesh.get(name)
            if replica is not None:
                break
        if replica is None:
            with self._lock:
                self._deploy_failed_total += 1
                self._deploy_state = {
                    "state": "failed", "directory": directory,
                    "reason": "no replica available to canary"}
            return
        baseline_ms, _, fail = self._probe_canary(replica)
        if fail is not None:
            baseline_ms = None
        body = {"directory": directory}
        if step is not None:
            body["step"] = int(step)
        try:
            result = replica.admin("hotswap", body)
        except (GatewayHTTPError, ReplicaProbeError, OSError) as e:
            with self._lock:
                self._deploy_failed_total += 1
                self._deploy_state = {
                    "state": "failed", "directory": directory,
                    "reason": f"canary hotswap failed: {e}"}
            events.instant("controlplane.deploy_failed",
                           directory=directory, reason=str(e))
            return
        step = int(result["step"])
        canary = CanaryDeployment(
            directory, step, baseline_ms=baseline_ms,
            hold_ticks=self.hold_ticks, p99_factor=self.p99_factor,
            p99_floor_ms=self.p99_floor_ms)
        with self._lock:
            self._canary = canary
            self._canary_name = replica.name
            self._deploy_state = {"state": "canary",
                                  "directory": directory,
                                  "step": step,
                                  "replica": replica.name}
        events.instant("controlplane.canary_start",
                       directory=directory, step=step,
                       replica=replica.name,
                       baseline_ms=baseline_ms)

    def _finish_promote(self, canary: CanaryDeployment) -> None:
        with self._lock:
            canary_name = self._canary_name
        failures = []
        for name in self.mesh.names():
            if name == canary_name:
                continue
            replica = self.mesh.get(name)
            if replica is None:
                continue
            try:
                replica.admin("hotswap",
                              {"directory": canary.directory,
                               "max_step": canary.step})
            except (GatewayHTTPError, ReplicaProbeError,
                    OSError) as e:
                failures.append(f"{name}: {e}")
        with self._lock:
            self._canary = None
            self._canary_name = None
            self._promoted_total += 1
            self._deploy_state = {
                "state": "promoted", "directory": canary.directory,
                "step": canary.step,
                "fleet_failures": list(failures)}
        events.instant("controlplane.promoted",
                       directory=canary.directory, step=canary.step,
                       fleet_failures=len(failures))

    def _finish_rollback(self, reason: str, *,
                         environmental: bool = False) -> None:
        """``environmental=True`` marks a rollback that says nothing
        about the ARTIFACT — the canary process died or left the mesh
        mid-hold (chaos, preemption, OOM) before the SLO probes could
        refute the weights.  The flag rides the deployment status so
        a caller can retry the step once the mesh heals instead of
        writing off weights that were never proven bad."""
        with self._lock:
            canary = self._canary
            canary_name = self._canary_name
            self._canary = None
            self._canary_name = None
            if canary is None:
                return
            self._rollbacks_total += 1
            # budget keyed to PROMOTED progress: repeated rollbacks
            # with no promote in between accumulate and exhaust; a
            # promote resets the window (the fleet is getting
            # somewhere, each incident taxes it once)
            progress = self._promoted_total
        ok = self._budget.request(progress, reason,
                                  bad_step=canary.step)
        replica = self.mesh.get(canary_name) \
            if canary_name is not None else None
        restored: Optional[int] = None
        if replica is not None:
            try:
                result = replica.admin(
                    "hotswap", {"directory": canary.directory,
                                "max_step": canary.step - 1})
                restored = int(result["step"])
            except (GatewayHTTPError, ReplicaProbeError,
                    OSError) as e:
                events.instant("controlplane.rollback_restore_failed",
                               replica=canary_name, error=str(e))
        events.instant("controlplane.rollback",
                       directory=canary.directory, step=canary.step,
                       restored_step=restored, reason=reason,
                       environmental=environmental, budget_ok=ok,
                       budget_attempts=self._budget.attempts)
        if ok:
            with self._lock:
                self._deploy_failed_total += 1
                self._deploy_state = {
                    "state": "rolled_back",
                    "directory": canary.directory,
                    "step": canary.step, "restored_step": restored,
                    "reason": reason,
                    "environmental": bool(environmental)}
            return
        fatal = (f"deployment rollback budget exhausted "
                 f"({self._budget.attempts} rollbacks, max "
                 f"{self._budget.max_rollbacks}) — {canary.directory}"
                 f" is persistently failing its canary: {reason}")
        with self._lock:
            self._deploy_failed_total += 1
            self._fatal = fatal
            self._deploy_state = {
                "state": "failed_fatal",
                "directory": canary.directory,
                "step": canary.step, "restored_step": restored,
                "reason": reason}
        events.instant("controlplane.deploy_fatal",
                       directory=canary.directory, reason=reason)
