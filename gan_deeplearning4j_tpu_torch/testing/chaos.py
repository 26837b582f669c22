"""Fault injectors (own copies of part of
``gan_deeplearning4j_tpu/testing/chaos.py``; the rest of that module is
ROADMAP Queue 1 item 11.3).  For the supervision paths:

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

For the serving plane's network path and its replica processes:

* ``SlowLorisClient`` drips a request body one tiny chunk at a time (the
  gateway's TOTAL body-read deadline must answer 408 in bounded time);
  ``mid_body_disconnect`` sends part of a declared body and hangs up;
* ``kill_replica`` stops one engine of a live ``Router``;
  ``kill_replica_process`` SIGKILLs a spawned replica process (the
  control plane must replace it, the mesh drain to the survivors);
  ``wedge_replica`` makes a replica report unhealthy while it still
  listens (``POST /admin/chaos/wedge``);
* ``poison_checkpoint_dir`` forges a newest checkpoint that VERIFIES but
  serves NaN: only the canary's SLO probe can catch it, and the rollback
  must land on the step before it.  The forged directory is written in
  the JAX on-disk format, so the JAX checkpointer verifies and loads it
  exactly as the port's does.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import random
import select
import signal as _signal
import socket
import subprocess
import tempfile
import threading
import time
import zipfile
from http.client import HTTPConnection
from typing import Dict, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.checkpoint import checkpointer as _ckpt_mod
from gan_deeplearning4j_tpu_torch.graph import serialization


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


# -- network-path injectors (serve/gateway.py) ------------------------------

_DEFAULT_LORIS_BODY = b'{"inputs": [[[0.0, 0.0]]]}'


def _request_head(path: str, body_len: int, content_type: str) -> bytes:
    return (f"POST {path} HTTP/1.1\r\n"
            f"Host: chaos\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {body_len}\r\n"
            f"Connection: close\r\n\r\n").encode("ascii")


def _read_status(sock: socket.socket) -> Optional[int]:
    """Best-effort read of the response status line from a raw socket
    (the peer may have closed already — that's a legitimate outcome
    for an abusive client)."""
    try:
        sock.settimeout(2.0)
        data = b""
        while b"\r\n" not in data and len(data) < 4096:
            chunk = sock.recv(1024)
            if not chunk:
                break
            data += chunk
        parts = data.split(b" ", 2)
        return int(parts[1]) if len(parts) >= 2 else None
    except (OSError, ValueError, IndexError):
        return None


class SlowLorisClient:
    """Raw-socket client that sends complete headers declaring the full
    ``Content-Length``, then drips the body ``drip_bytes`` at a time
    every ``drip_interval_s`` — the connection-starvation abuse
    pattern.  A per-recv socket timeout on the server is USELESS here
    (every drip resets it); only a TOTAL body-read deadline bounds the
    connection hold time, which is exactly what the test asserts:
    ``run()`` returns as soon as the server answers (or resets), and
    the elapsed time must be far below the full drip duration.

    ``run(max_s)`` returns ``(status, elapsed_s, sent_bytes)`` —
    ``status`` is the HTTP status the server managed to send (408 from
    a well-behaved gateway) or None if the connection just died."""

    def __init__(self, host: str, port: int, path: str = "/v1/generate",
                 body: bytes = _DEFAULT_LORIS_BODY,
                 content_type: str = "application/json",
                 drip_bytes: int = 1, drip_interval_s: float = 0.1):
        if drip_bytes <= 0 or drip_interval_s < 0:
            raise ValueError("drip_bytes must be > 0 and "
                             "drip_interval_s >= 0")
        self.host = host
        self.port = int(port)
        self.path = path
        self.body = bytes(body)
        self.content_type = content_type
        self.drip_bytes = int(drip_bytes)
        self.drip_interval_s = float(drip_interval_s)

    def run(self, max_s: float = 30.0
            ) -> Tuple[Optional[int], float, int]:
        t0 = time.monotonic()
        sent = 0
        status: Optional[int] = None
        with socket.create_connection((self.host, self.port),
                                      timeout=5.0) as sock:
            sock.sendall(_request_head(self.path, len(self.body),
                                       self.content_type))
            while sent < len(self.body) \
                    and time.monotonic() - t0 < max_s:
                # an early answer (the 408) ends the abuse: a loris
                # that keeps dripping into a closed window just eats
                # a reset
                readable, _, _ = select.select([sock], [], [], 0)
                if readable:
                    break
                try:
                    sock.sendall(
                        self.body[sent:sent + self.drip_bytes])
                    sent += self.drip_bytes
                except OSError:
                    # a server reset mid-drip IS a result: stop
                    # dripping and read whatever status was sent
                    break
                time.sleep(self.drip_interval_s)
            status = _read_status(sock)
        return status, time.monotonic() - t0, min(sent, len(self.body))


def mid_body_disconnect(host: str, port: int,
                        path: str = "/v1/generate",
                        body: bytes = _DEFAULT_LORIS_BODY,
                        content_type: str = "application/json",
                        frac: float = 0.5) -> int:
    """Send complete headers declaring ``len(body)`` bytes, then only
    ``frac`` of the body, then hang up — the vanished-caller case.
    The gateway must count it and release the connection thread; there
    is nobody left to answer.  Returns the body bytes actually sent."""
    if not 0 <= frac < 1:
        raise ValueError("frac must be in [0, 1)")
    cut = int(len(body) * frac)
    with socket.create_connection((host, port), timeout=5.0) as sock:
        sock.sendall(_request_head(path, len(body), content_type))
        if cut:
            sock.sendall(body[:cut])
    return cut


def kill_replica(router, index: int):
    """Stop one engine of a live ``Router`` replica set — the
    mid-load replica death the router must absorb: the dead replica is
    ejected on its next probe/submit and requests drain to the
    survivors with only TYPED failures.  Returns the stopped engine
    (restartable with ``engine.start()`` to exercise recovery)."""
    eng = router.replicas[index]
    eng.stop()
    return eng


# -- process-level injectors (the mesh/control-plane chaos set) ---------------


def kill_replica_process(proc) -> int:
    """SIGKILL a spawned replica subprocess — the process-level
    variant of ``kill_replica``: no drain, no goodbye, no python
    frames unwound.  The control plane must notice the corpse, eject
    it from the mesh, spawn a replacement, and keep every in-flight
    failure TYPED.  Accepts a ``controlplane.ReplicaProcess`` or a
    raw ``Popen``; reaps (bounded) and returns the pid."""
    popen = getattr(proc, "proc", proc)
    pid = popen.pid
    if popen.poll() is None:
        os.kill(pid, _signal.SIGKILL)
    try:
        popen.wait(timeout=10.0)
    except subprocess.TimeoutExpired:
        pass  # the caller's alive() polling still sees the truth
    return pid


def wedge_replica(host: str, port: int,
                  seconds: float = 5.0) -> Dict:
    """Make a replica report UNHEALTHY for ``seconds`` while its
    socket keeps accepting — the stalled-but-listening failure mode
    (a dead socket is ejected by a refused connect; a wedged replica
    must be ejected by its 503 /healthz, which is a different code
    path).  Drives the replica's ``POST /admin/chaos/wedge`` verb;
    returns the replica's acknowledgment."""
    conn = HTTPConnection(host, port, timeout=10.0)
    try:
        body = json.dumps({"seconds": float(seconds)}).encode("utf-8")
        conn.request("POST", "/admin/chaos/wedge", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(
            f"wedge_replica: HTTP {resp.status} from {host}:{port}: "
            f"{data[:200]!r}")
    return json.loads(data.decode("utf-8"))["result"]


def poison_checkpoint_dir(directory: str, name: str = "gen") -> int:
    """Forge a VERIFYING-but-poisoned newest checkpoint: copy the
    newest verified ``ckpt_N`` to ``ckpt_{N+1}`` with every float
    param of graph ``name`` NaN'd and the manifest REBUILT over the
    new bytes.  Manifest verification passes — this is not a torn
    write but a semantically bad save (the artifact of a diverged run
    or a bad export), so only the control plane's canary SLO probe
    (finite outputs) can catch it, and rollback must land on step N.
    Returns the poisoned step."""
    ckpt = _ckpt_mod.TrainCheckpointer(directory, sweep_debris=False)
    steps = ckpt.steps()
    base = None
    for s in reversed(steps):
        if ckpt.verify(s):
            base = s
            break
    if base is None:
        raise FileNotFoundError(
            f"no verified checkpoint in {directory} to poison")
    new_step = max(steps) + 1
    src = os.path.join(directory, f"ckpt_{base}")
    with open(os.path.join(src, _ckpt_mod.MANIFEST_NAME)) as f:
        src_manifest = json.load(f)
    model_file = f"{name}_model.zip"
    if model_file not in src_manifest["files"]:
        raise FileNotFoundError(
            f"ckpt_{base} has no graph {name!r} "
            f"(files: {sorted(src_manifest['files'])})")
    with zipfile.ZipFile(os.path.join(src, model_file)) as z:
        cfg = json.loads(z.read("config.json").decode("utf-8"))
        with np.load(io.BytesIO(z.read("params.npz")),
                     allow_pickle=False) as f:
            params = {k: np.asarray(f[k]) for k in f.files}
        updater = None
        if "updater.npz" in z.namelist():
            with np.load(io.BytesIO(z.read("updater.npz")),
                         allow_pickle=False) as f:
                updater = {k: np.asarray(f[k]) for k in f.files}
    poisoned = {k: (np.full_like(v, np.nan)
                    if np.issubdtype(v.dtype, np.floating) else v)
                for k, v in params.items()}
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    entries: Dict[str, Dict] = {}

    def put(fname: str, data: bytes) -> None:
        path = os.path.join(tmp, fname)
        with open(path, "wb") as fh:
            fh.write(data)
        _ckpt_mod._fsync_file(path)
        entries[fname] = {"bytes": len(data),
                          "sha256": hashlib.sha256(data).hexdigest()}

    put(model_file,
        serialization.model_zip_bytes(cfg, poisoned, updater))
    for fname in src_manifest["files"]:
        if fname == model_file:
            continue
        with open(os.path.join(src, fname), "rb") as fh:
            data = fh.read()
        if fname == "state.json":
            scalars = json.loads(data.decode("utf-8"))
            scalars["step"] = new_step
            data = json.dumps(scalars, indent=1).encode("utf-8")
        put(fname, data)
    manifest: Dict = {"step": new_step, "files": entries}
    if "mesh_spec" in src_manifest:
        manifest["mesh_spec"] = src_manifest["mesh_spec"]
    mpath = os.path.join(tmp, _ckpt_mod.MANIFEST_NAME)
    with open(mpath, "w") as fh:
        json.dump(manifest, fh, indent=1)
    _ckpt_mod._fsync_file(mpath)
    _ckpt_mod._fsync_dir(tmp)
    os.rename(tmp, os.path.join(directory, f"ckpt_{new_step}"))
    _ckpt_mod._fsync_dir(directory)
    return new_step
