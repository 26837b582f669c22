"""Fault injection (torch twin of ``gan_deeplearning4j_tpu/testing/
chaos.py``): prove the fault-tolerance contract, don't assert it.  Every
injector is parameterized by an explicit seed, so a chaos failure replays
exactly.

For the training plane:

* kill-during-save: ``ChaosInjector.kill_at_save_event`` hooks the
  checkpointer's enumerated write / rename points
  (``checkpoint/checkpointer.py`` ``_chaos_hook``) and raises
  ``InjectedCrash`` at the chosen one, which leaves the directory as a
  SIGKILL would; ``count_save_events`` enumerates the points;
* corruption: ``corrupt_one_file`` flips one seeded byte of a committed
  checkpoint, ``truncate_file`` cuts a seeded tail off, ``delete_file``
  removes one, ``corrupt_csv_rows`` rewrites seeded CSV lines as garbage
  (the quarantine must name them back);
* lose part of the devices: ``shrink_world`` / ``lost_device`` hook the
  trainer's step-boundary seam (``train/gan_trainer.py``
  ``_chaos_step_hook``) and raise ``DeviceLostError`` at a seeded step;
  ``world_size()`` then reports the survivors, over which the next
  incarnation re-forms its world and reshards its checkpoint
  (``parallel/elastic.py``);
* data sources: ``StallingSource`` blocks in ``next()`` until released,
  ``HangingSource`` never returns (a dead storage layer: the watchdog's
  case), ``FlakySource`` / ``FlakyReader`` raise transient ``OSError``s
  (the retry layer's case), ``CorruptRecordSource`` yields malformed
  batches and ``NanSource`` one NaN (the quarantine's and the NaN alarm's
  cases);
* hangs: ``hang_at_readback`` (``ReadbackHang``) parks a readback of
  ``utils/device.py`` (``_chaos_readback_hook``), ``hang_at_dispatch``
  a serving batch dispatch (``serve/engine.py`` ``_chaos_dispatch_hook``).
  Each hang sleeps in small increments, so the monitored thread stays
  interruptible at bytecode boundaries: the way out is the watchdog.

For the serving plane:

* ``SlowRequestSource`` injects oversized request sizes into a load
  harness's size stream (the chunked dispatch path under live traffic);
  ``LeakyDispatchSource`` hoards memory on every dispatch (what a leak
  gate must flag);
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

* ``poison_fleet_checkpoint_dir`` forges a verifying newest FLEET
  checkpoint with one tenant's generator NaN: the publisher's
  finite-params probe must reject it at publication.

Across the planes, ``ChaosSchedule`` fires a seeded timeline of such
injections and writes the resolved timeline into the events up front.
The lifecycle poisoners strike one tenant of a ``train/lifecycle.py``
fleet: ``poison_tenant_params`` queues a NaN param-poison of its lane for
the next window boundary, and ``TenantFeedPoisoner`` turns its segment's
rows NaN once armed; the per-tenant sentinel or quarantine budget must
then take out exactly that tenant.
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
from typing import Dict, List, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.checkpoint import checkpointer as _ckpt_mod
from gan_deeplearning4j_tpu_torch.graph import serialization


class InjectedCrash(RuntimeError):
    """A simulated hard kill.  ``simulates_kill`` tells the checkpointer
    to leave the directory un-cleaned (debris and all), exactly as a
    real SIGKILL would; the recovery wrapper still classifies it as a
    retryable failure (it is a RuntimeError, not a config error)."""

    simulates_kill = True


class DeviceLostError(RuntimeError):
    """A simulated loss of part of the device fleet mid-run (a spot
    eviction, a failed chip).  A plain RuntimeError on purpose: the
    recovery wrapper classifies it RETRYABLE — the restart is exactly
    where the elastic layer re-forms the mesh over the survivors and
    reshards the checkpoint onto it."""


class ChaosInjector:
    """Seeded injector; one instance per test scenario."""

    def __init__(self, seed: int):
        self.seed = seed
        self.rng = random.Random(seed)

    # -- kill-during-save ------------------------------------------------------

    def count_save_events(self, save_fn) -> List[str]:
        """Run ``save_fn()`` with a recording hook; return the ordered
        list of chaos events it passed (the enumerable kill points)."""
        events: List[str] = []
        prev = _ckpt_mod._chaos_hook
        _ckpt_mod._chaos_hook = events.append
        try:
            save_fn()
        finally:
            _ckpt_mod._chaos_hook = prev
        return events

    def kill_at_save_event(self, index: int,
                           after_times: int = 0) -> "_KillPoint":
        """Context manager: the ``index``-th chaos event of the
        (``after_times``+1)-th save inside the block raises
        ``InjectedCrash``.  ``after_times`` lets a test crash the Nth
        save of a run while earlier ones succeed."""
        return _KillPoint(index, after_times)

    # -- corruption ------------------------------------------------------------

    def corrupt_one_file(self, ckpt_dir: str,
                         exclude_manifest: bool = False) -> tuple:
        """Flip one seeded byte of one seeded file under ``ckpt_dir``
        (committed checkpoint).  Returns (path, offset).  With
        ``exclude_manifest`` the manifest itself stays intact — the
        harder case: the corruption is only discoverable by hashing."""
        files = sorted(
            f for f in os.listdir(ckpt_dir)
            if os.path.isfile(os.path.join(ckpt_dir, f))
            and not (exclude_manifest and f == _ckpt_mod.MANIFEST_NAME))
        name = self.rng.choice(files)
        path = os.path.join(ckpt_dir, name)
        data = bytearray(open(path, "rb").read())
        off = self.rng.randrange(len(data))
        data[off] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(data))
        return path, off

    def truncate_file(self, ckpt_dir: str) -> tuple:
        """Cut a seeded non-empty tail off one seeded data file (torn
        write).  Returns (path, new_size)."""
        files = sorted(
            f for f in os.listdir(ckpt_dir)
            if os.path.isfile(os.path.join(ckpt_dir, f))
            and f != _ckpt_mod.MANIFEST_NAME)
        name = self.rng.choice(files)
        path = os.path.join(ckpt_dir, name)
        size = os.path.getsize(path)
        new_size = self.rng.randrange(max(1, size))  # strictly shorter
        with open(path, "rb+") as f:
            f.truncate(new_size)
        return path, new_size

    def delete_file(self, ckpt_dir: str, name: str) -> str:
        """Remove one named file of a committed checkpoint (e.g.
        ``state.npz`` lost to a filesystem fault)."""
        path = os.path.join(ckpt_dir, name)
        os.remove(path)
        return path

    def corrupt_csv_rows(self, path: str, n_rows: int = 1,
                         skip_lines: int = 0) -> List[int]:
        """Rewrite ``n_rows`` seeded data lines of an on-disk CSV as
        unparseable garbage (silent upstream-producer corruption /
        bit-rot that still splits into lines).  Returns the 1-based
        line numbers hit — exactly what ``quarantine.jsonl`` must name
        back."""
        with open(path) as f:
            lines = f.read().splitlines()
        eligible = list(range(skip_lines, len(lines)))
        hit = sorted(self.rng.sample(eligible, min(n_rows, len(eligible))))
        for i in hit:
            lines[i] = f"#CORRUPT#,{self.rng.random()},###"
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return [i + 1 for i in hit]

    # -- device loss / world shrink --------------------------------------------

    def shrink_world(self, kill_step: int, before: int, after: int,
                     marker: Optional[str] = None) -> "_ShrinkWorld":
        """Context manager: the run loses ``before - after`` devices at
        the first step boundary >= ``kill_step`` — the trainer's step
        seam raises ``DeviceLostError`` (one-shot; the restarted
        incarnation trains normally) and ``world_size()`` flips from
        ``before`` to ``after``.  The next incarnation forms its world at
        ``world_size()`` (``resolve_n_devices``' elastic clamp) and its
        restore reshards the checkpoint onto it.

        The port's ranks are processes: the rank function enters the
        injector, and ``marker`` (a file path) carries the one-shot firing
        across them and back to the parent, whose ``world_size()`` then
        reads ``after``."""
        if not 0 < after < before:
            raise ValueError(
                f"shrink_world needs 0 < after < before, got "
                f"{before} -> {after}")
        return _ShrinkWorld(kill_step, before, after, marker)

    def lost_device(self, kill_step: int, before: int,
                    lose: int = 1) -> "_ShrinkWorld":
        """``shrink_world`` phrased as "K devices died": drop ``lose``
        of the ``before`` devices at the seeded kill step."""
        return self.shrink_world(kill_step, before, before - lose)

    # -- hangs -----------------------------------------------------------------

    def hang_at_readback(self, at: int = 0) -> "ReadbackHang":
        """Context manager: the ``at``-th ``device_fence`` call inside
        the block hangs indefinitely (a wedged device readback /
        tunnel).  One-shot — a restarted run's fences proceed normally,
        so a watchdog-driven restart can finish.  The hang sleeps in
        small increments, which keeps the hung thread interruptible at
        bytecode boundaries — exactly the property a real C-level hang
        lacks until its call returns, and the reason the watchdog also
        dumps diagnostics and checkpoints from its OWN thread."""
        return ReadbackHang(at)

    def hang_at_dispatch(self, at: int = 0) -> "_DispatchHang":
        """Context manager: the ``at``-th serving batch dispatch inside
        the block hangs indefinitely (``serve/engine.py``'s chaos seam
        — a wedged card under the serving plane).  One-shot: after
        the watchdog fails the in-flight requests and re-arms, later
        dispatches proceed normally, so the "degrade, recover, keep
        serving" contract is what the test observes.  Sleeps in small
        increments for the same bytecode-boundary interruptibility as
        ``hang_at_readback``."""
        return _DispatchHang(at)


class SlowRequestSource:
    """Request-size iterator wrapper that injects OVERSIZED sizes at
    seeded emitted indices — the serving-plane burst/abuse pattern: a
    caller whose batches exceed the largest declared bucket forces the
    chunked dispatch path under live traffic.  Wraps any iterable of
    row counts (e.g. the load harness's size stream); ``factor`` scales
    the hit sizes past ``largest_bucket``."""

    def __init__(self, sizes, largest_bucket: int, slow_at=(0,),
                 factor: int = 2):
        if factor < 1:
            raise ValueError("factor must be >= 1")
        self._sizes = iter(sizes)
        self.largest_bucket = int(largest_bucket)
        self.slow_at = frozenset(slow_at)
        self.factor = int(factor)
        self.emitted = 0
        self.injected = 0

    def __iter__(self) -> "SlowRequestSource":
        return self

    def __next__(self) -> int:
        size = next(self._sizes)
        if self.emitted in self.slow_at:
            self.injected += 1
            size = self.largest_bucket * self.factor + size
        self.emitted += 1
        return size


class _ShrinkWorld:
    """Seeded device-loss injector (``ChaosInjector.shrink_world``).
    Installs the trainer step-boundary hook for the with-block; fires
    ONCE at the first boundary at or past ``kill_step`` (chunked paths
    only visit multiples of steps_per_call, so "at or past" is the
    honest contract), then reports the shrunken world.  With a
    ``marker`` file the firing is seen by every process that holds the
    injector (a rank fires, the parent re-forms the world)."""

    def __init__(self, kill_step: int, before: int, after: int,
                 marker: Optional[str] = None):
        self.kill_step = kill_step
        self.before = before
        self.after = after
        self.marker = marker
        self._fired = False          # one-shot, like _KillPoint
        self.killed_at: Optional[int] = None
        self._prev = None

    @property
    def fired(self) -> bool:
        return self._fired or bool(self.marker
                                   and os.path.exists(self.marker))

    def world_size(self) -> int:
        """Devices alive right now: ``before`` until the kill fires,
        ``after`` from then on — what an elastic world formation reads."""
        return self.after if self.fired else self.before

    def _hook(self, step: int) -> None:
        if self._fired or step < self.kill_step:
            return
        if self.marker:
            # one process of the run fires (it claims the marker); a rank
            # left in a collective with it is failed by ``mesh.spawn``
            try:
                fd = os.open(self.marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return
            with os.fdopen(fd, "w") as f:
                f.write(str(step))
        self._fired = True
        self.killed_at = step
        raise DeviceLostError(
            f"injected device loss at step {step}: fleet shrank "
            f"{self.before} -> {self.after} devices")

    def __enter__(self) -> "_ShrinkWorld":
        from gan_deeplearning4j_tpu_torch.train import gan_trainer as _gt_mod

        self._gt_mod = _gt_mod
        self._prev = _gt_mod._chaos_step_hook
        _gt_mod._chaos_step_hook = self._hook
        return self

    def __exit__(self, *exc) -> None:
        self._gt_mod._chaos_step_hook = self._prev


class _KillPoint:
    def __init__(self, index: int, after_times: int):
        self.index = index
        self.after_times = after_times
        self.fired = False  # one-shot: a killed process stays dead once
        self._events = 0
        self._saves_seen = 0
        self._prev = None

    def _hook(self, event: str) -> None:
        if self.fired:
            return  # the "process" already died; later saves (the
            # restarted run's) proceed normally
        if self._saves_seen < self.after_times:
            if event == "post_swap":  # one per completed save
                self._saves_seen += 1
            return
        if self._events == self.index:
            self.fired = True
            raise InjectedCrash(
                f"injected kill at save event #{self.index} ({event!r})")
        self._events += 1

    def __enter__(self) -> "_KillPoint":
        self._prev = _ckpt_mod._chaos_hook
        _ckpt_mod._chaos_hook = self._hook
        return self

    def __exit__(self, *exc) -> None:
        _ckpt_mod._chaos_hook = self._prev


class StallingSource:
    """DataSet-iterator wrapper whose ``next()`` blocks at the
    ``stall_at``-th call until ``release()`` (or forever) — a wedged
    storage layer under the prefetch worker."""

    def __init__(self, source, stall_at: int):
        self.source = source
        self.stall_at = stall_at
        self.calls = 0
        self.stalled = threading.Event()   # observable: worker is stuck
        self._release = threading.Event()

    def release(self) -> None:
        self._release.set()

    def has_next(self):
        return self.source.has_next()

    def reset(self):
        return self.source.reset()

    def next(self):
        self.calls += 1
        if self.calls - 1 == self.stall_at:
            self.stalled.set()
            self._release.wait()  # block until the test releases us
        return self.source.next()

    def __getattr__(self, name):
        return getattr(self.source, name)


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


class FlakySource:
    """DataSet-iterator wrapper whose ``next()`` raises a TRANSIENT
    ``OSError`` on ``failures`` consecutive calls starting at call
    index ``at``, then succeeds forever — an NFS blip / flaky disk
    under the reader.  The failure happens BEFORE the delegate is
    touched, so a retried call replays the exact same batch sequence
    (the property the bit-identical-resume tests lean on).  Seeded:
    the error payload carries the seed so a chaos failure replays
    exactly."""

    def __init__(self, source, failures: int = 1, at: int = 0,
                 seed: int = 0):
        self.source = source
        self.failures = failures
        self.at = at
        self.seed = seed
        self.calls = 0
        self.raised = 0

    def has_next(self):
        return self.source.has_next()

    def reset(self):
        return self.source.reset()

    def next(self):
        call = self.calls
        self.calls += 1
        if self.at <= call < self.at + self.failures:
            self.raised += 1
            raise OSError(
                f"injected transient read failure "
                f"{self.raised}/{self.failures} (seed {self.seed})")
        return self.source.next()

    def __getattr__(self, name):
        return getattr(self.source, name)


class FlakyReader:
    """CSV-reader wrapper whose ``read()`` raises a transient
    ``OSError`` the first ``failures`` calls, then delegates — the
    ingest-time counterpart of ``FlakySource`` (drives
    ``RetryingReader``)."""

    def __init__(self, reader, failures: int = 1, seed: int = 0):
        self.reader = reader
        self.failures = failures
        self.seed = seed
        self.calls = 0

    def read(self, *a, **kw):
        call = self.calls
        self.calls += 1
        if call < self.failures:
            raise OSError(
                f"injected transient decode failure "
                f"{call + 1}/{self.failures} (seed {self.seed})")
        return self.reader.read(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.reader, name)


class CorruptRecordSource:
    """DataSet-iterator wrapper that yields MALFORMED batches at the
    chosen emitted indices — the runtime-corruption counterpart of
    ``corrupt_csv_rows``.  ``mode="nan"`` poisons one seeded row per
    hit batch with NaNs (a bad record that parsed); ``mode="shape"``
    emits the batch with an extra feature column (a producer schema
    break).  Drives the quarantine layer (data/resilient.py
    ``ValidatingSource``): NaN rows must be skipped-and-charged
    row-by-row, shape breaks quarantined as a batch."""

    def __init__(self, source, corrupt_at=(0,), mode: str = "nan",
                 rng: Optional[random.Random] = None):
        if mode not in ("nan", "shape"):
            raise ValueError(f"unknown corruption mode {mode!r}")
        self.source = source
        self.corrupt_at = frozenset(corrupt_at)
        self.mode = mode
        self.rng = rng or random.Random(0)
        self.emitted = 0
        self.corrupted = 0

    def has_next(self):
        return self.source.has_next()

    def reset(self):
        return self.source.reset()

    def next(self):
        ds = self.source.next()
        if self.emitted in self.corrupt_at:
            self.corrupted += 1
            feats = np.array(ds.features, copy=True)
            if self.mode == "nan":
                feats[self.rng.randrange(max(1, feats.shape[0]))] = np.nan
            else:  # "shape": one extra column — the record width broke
                feats = np.concatenate(
                    [feats, np.zeros((feats.shape[0], 1), feats.dtype)],
                    axis=1)
            ds.features = feats
        self.emitted += 1
        return ds

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


class _DispatchHang:
    """Seeded serving-dispatch hang (``ChaosInjector.hang_at_dispatch``):
    parks the ``at``-th batch dispatch of ``serve/engine.py`` until the
    watchdog unwinds it (or ``__exit__`` releases the parked thread on
    cleanup).  Structured exactly like ``_ReadbackHang`` — observable
    ``hung`` event, one-shot ``fired`` flag, released on exit."""

    def __init__(self, at: int):
        self.at = at
        self.calls = 0
        self.fired = False                  # one-shot, like _ReadbackHang
        self.hung = threading.Event()       # observable: dispatch stuck
        self._release = threading.Event()   # set on __exit__ (cleanup)
        self._prev = None

    def _hook(self) -> None:
        if self.fired:
            return
        if self.calls == self.at:
            self.fired = True
            self.hung.set()
            while not self._release.is_set():
                time.sleep(0.05)
        self.calls += 1

    def __enter__(self) -> "_DispatchHang":
        from gan_deeplearning4j_tpu_torch.serve import engine as _serve_mod

        self._serve_mod = _serve_mod
        self._prev = _serve_mod._chaos_dispatch_hook
        _serve_mod._chaos_dispatch_hook = self._hook
        return self

    def __exit__(self, *exc) -> None:
        self._serve_mod._chaos_dispatch_hook = self._prev
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


def poison_fleet_checkpoint_dir(directory: str, tenant: int = 0) -> int:
    """Fleet variant of :func:`poison_checkpoint_dir`: forge a VERIFYING
    newest fleet checkpoint whose ``gen_params`` are NaN for ONE tenant's
    slice.  The forgery goes through ``FleetCheckpointer.save`` itself
    (restore the newest verified, NaN the slice, save as step N+1), so the
    manifest hashing is genuine: only a semantic probe catches it, the
    publisher's finite-params probe over ``state.npz`` (rejection at
    publication) or the canary's finite-output probe against the tenant's
    engine.  Returns the poisoned step."""
    from gan_deeplearning4j_tpu_torch.train.fleet import FleetCheckpointer

    # keep ALL existing checkpoints (the forge must not prune the live
    # trainer's history) and never sweep the owner's in-flight tmps
    ck = FleetCheckpointer(directory, keep=10 ** 9, sweep_debris=False)
    steps = ck.steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory} to poison")
    _, state, _ = ck.restore()
    n = int(state.it.shape[0])
    if not 0 <= int(tenant) < n:
        raise ValueError(f"tenant {tenant} outside fleet of {n}")

    def nan_slice(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = nan_slice(v)
            else:
                v = v.clone()
                if v.is_floating_point():
                    v[int(tenant)] = float("nan")
                out[k] = v
        return out

    new_step = max(steps) + 1
    ck.save(new_step, state._replace(gen_params=nan_slice(state.gen_params)))
    return new_step


class ChaosSchedule:
    """A seeded CROSS-PLANE chaos timeline: one coordinator firing
    injections against the training plane (preemption signal, world
    shrink, corrupt tenant rows) and the serving plane (replica kill,
    slow-loris, wedge) in the same run — the combined-chaos scenario's
    conductor (``scenario/runner.py``).

    Determinism contract: actions are registered with ``add(at_s,
    name, fn)`` in a fixed caller order; per-entry jitter (when
    ``jitter_s`` > 0) is drawn from ``random.Random(seed)`` in that
    order, so the same seed + same registration sequence yields the
    same resolved timeline, every run.  The resolved timeline is
    written into the events stream UP FRONT (``chaos.schedule``) and
    every firing lands a ``chaos.fire`` event with the action's
    outcome — an action's exception is captured and counted, never
    allowed to kill the coordinator thread (chaos that crashes the
    chaos harness proves nothing)."""

    def __init__(self, seed: int, *, jitter_s: float = 0.0):
        self.seed = int(seed)
        self.jitter_s = float(jitter_s)
        self._rng = random.Random(self.seed)
        self._entries: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.fired: list = []

    def add(self, at_s: float, name: str, fn, **attrs) -> float:
        """Register ``fn`` to fire ``at_s`` seconds (plus seeded
        jitter) after ``start()``.  Returns the resolved offset."""
        if self._thread is not None:
            raise RuntimeError("schedule already started")
        at = float(at_s)
        if self.jitter_s > 0:
            at += self._rng.uniform(0.0, self.jitter_s)
        self._entries.append({"at_s": round(at, 3), "name": str(name),
                              "fn": fn, "attrs": dict(attrs)})
        return at

    def timeline(self) -> list:
        """The resolved deterministic timeline (no callables — the
        JSON-safe form written to events and verdicts)."""
        return [{"at_s": e["at_s"], "name": e["name"], **e["attrs"]}
                for e in sorted(self._entries,
                                key=lambda e: e["at_s"])]

    def start(self) -> "ChaosSchedule":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("schedule already started")
            t = threading.Thread(
                target=self._run, name="gan4j-chaos-schedule",
                daemon=True)
            self._thread = t
        from gan_deeplearning4j_tpu_torch.telemetry import events

        events.instant("chaos.schedule", seed=self.seed,
                       jitter_s=self.jitter_s,
                       timeline=self.timeline())
        t.start()
        return self

    def _run(self) -> None:
        from gan_deeplearning4j_tpu_torch.telemetry import events

        t0 = time.monotonic()
        for entry in sorted(self._entries, key=lambda e: e["at_s"]):
            delay = t0 + entry["at_s"] - time.monotonic()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            rec = {"name": entry["name"], "at_s": entry["at_s"],
                   "error": None}
            try:
                entry["fn"]()
            except Exception as e:
                # an injection that raises (its target already dead, a
                # race with the plane it attacks) is an outcome to record,
                # not a crash of the coordinator
                rec["error"] = repr(e)
            with self._lock:
                self.fired.append(rec)
            events.instant("chaos.fire", action=rec["name"],
                           at_s=rec["at_s"], error=rec["error"])

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)

    def __enter__(self) -> "ChaosSchedule":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def report(self) -> Dict:
        with self._lock:
            fired = list(self.fired)
        return {"seed": self.seed,
                "planned": len(self._entries),
                "fired": len(fired),
                "errors": sum(1 for f in fired if f["error"]),
                "timeline": self.timeline(),
                "outcomes": fired}


class LeakyDispatchSource:
    """Reference-hoarding leak injector for the soak gate
    (the JAX ``bench --soak --soak-leak``): hooks the serving engine's
    per-batch dispatch (``serve/engine._chaos_dispatch_hook``, the
    same seam ``hang_at_dispatch`` uses) and APPENDS
    ``bytes_per_dispatch`` of live memory to an internal hoard on
    every batch — the classic "a callback captured a buffer and the
    list never drains" production leak.  RSS then grows linearly with
    served load, which is exactly the signature
    ``telemetry/resources.leak_verdict`` must flag; the CI soak lane
    uses this to prove the leak gate CAN fail."""

    def __init__(self, bytes_per_dispatch: int = 256 << 10):
        if bytes_per_dispatch <= 0:
            raise ValueError("bytes_per_dispatch must be > 0")
        self.bytes_per_dispatch = int(bytes_per_dispatch)
        self.hoard: list = []   # the leak: grows forever, never read
        self.dispatches = 0
        self._prev = None
        self._serve_mod = None

    def _hook(self) -> None:
        # bytearray, not bytes: guarantees fresh, non-interned pages
        self.hoard.append(bytearray(self.bytes_per_dispatch))
        self.dispatches += 1

    def install(self) -> "LeakyDispatchSource":
        from gan_deeplearning4j_tpu_torch.serve import engine as _serve_mod

        self._serve_mod = _serve_mod
        self._prev = _serve_mod._chaos_dispatch_hook
        _serve_mod._chaos_dispatch_hook = self._hook
        return self

    def uninstall(self) -> None:
        if self._serve_mod is not None:
            self._serve_mod._chaos_dispatch_hook = self._prev
            self._serve_mod = None
        self.hoard.clear()

    def __enter__(self) -> "LeakyDispatchSource":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def poison_tenant_params(manager, tenant: int) -> None:
    """Queue a NaN param-poison of ONE tenant's lane for the next window
    boundary (``FleetManager.request`` -> ``poison_params``): the
    per-tenant health sentinel must quarantine exactly that tenant, and
    its cohort-mates' losses stay bitwise those of an undisturbed control.
    Queued, because membership and state surgery happen only between
    windows."""
    manager.request(lambda: manager.poison_params(int(tenant)))


class TenantFeedPoisoner:
    """Flag-guarded per-tenant feed corruption for lifecycle fleets.

    Wraps a feed ``feed(window) -> (features, labels)``; once armed,
    every row of ``tenant``'s segment (``row % num_segments == tenant``,
    the ``TenantRouter``'s ownership rule) comes back NaN.  The router's
    per-tenant quarantine budget then trips that tenant
    (``raise_on_budget=False``: a ``tripped`` marker, never an exception
    through the loop) while every other segment's rows pass through
    byte-identical to the unwrapped feed."""

    def __init__(self, feed, tenant: int, num_segments: int):
        self._feed = feed
        self.tenant = int(tenant)
        self.num_segments = int(num_segments)
        self._armed = threading.Event()
        self.windows_poisoned = 0

    def arm(self) -> None:
        self._armed.set()

    def disarm(self) -> None:
        self._armed.clear()

    @property
    def armed(self) -> bool:
        return self._armed.is_set()

    def __call__(self, window: int):
        feats, labs = self._feed(window)
        if not self._armed.is_set():
            return feats, labs
        feats = np.array(np.asarray(feats), np.float32, copy=True)
        rows = np.arange(feats.shape[0])
        feats[rows % self.num_segments == self.tenant] = np.nan
        self.windows_poisoned += 1
        return feats, labs
