"""Crash-safe asynchronous checkpointing (torch twin of
``gan_deeplearning4j_tpu/checkpoint/async_checkpointer.py``): the training
thread pays only the snapshot.

  training thread:  ``snapshot_state``  the copies to pinned host memory,
                    started behind one event, then the hand-off
  worker thread:    ``write_snapshot``  waits for the event, serializes,
                    fsyncs, renames, prunes

The bytes on disk are those of a synchronous save of the same state
(deterministic serialization), manifest hashes included.

Barriers: at the next ``save()`` (one save in flight at most, so a
checkpoint is never overtaken by its successor), at every read
(``restore``/``steps``/``latest_step``/``verify``/...), and at
``wait()``/``close()`` and interpreter exit.  A worker failure is re-raised
on the training thread at the next barrier.
"""

from __future__ import annotations

import atexit
import os
import queue
import threading
import weakref
from typing import Dict, Optional

from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
    TrainCheckpointer,
    snapshot_state,
)

_OPEN: "weakref.WeakSet" = weakref.WeakSet()
_ATEXIT_REGISTERED = False


def _close_open() -> None:
    for ck in list(_OPEN):
        try:
            ck.close()
        except Exception:  # interpreter exit: never raise from atexit
            pass


class AsyncCheckpointer:
    """Background-serializing wrapper around a ``TrainCheckpointer``:
    ``save`` returns after the snapshot; everything else barriers first,
    so what a caller observes of the directory is the synchronous
    checkpointer's."""

    def __init__(self, inner: TrainCheckpointer):
        self.inner = inner
        self._q: "queue.Queue[Optional[Dict]]" = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, name="gan4j-ckpt-writer", daemon=True)
        self._thread.start()
        global _ATEXIT_REGISTERED
        _OPEN.add(self)
        if not _ATEXIT_REGISTERED:
            atexit.register(_close_open)
            _ATEXIT_REGISTERED = True

    @property
    def directory(self) -> str:
        return self.inner.directory

    @property
    def keep(self) -> int:
        return self.inner.keep

    # -- worker --------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            snap = self._q.get()
            try:
                if snap is None:
                    return
                self.inner.write_snapshot(snap)
            except BaseException as e:  # re-raised at the next barrier
                if self._error is None:
                    self._error = e
            finally:
                self._q.task_done()

    def _reraise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- API -----------------------------------------------------------------

    def save(self, step: int, graphs: Dict[str, object],
             extra: Optional[Dict] = None,
             mesh_spec: Optional[Dict] = None) -> str:
        """Barrier on the previous save, snapshot on this thread, enqueue
        the serialization -> the checkpoint's final path (durable once
        the worker commits it: ``wait()``)."""
        self.wait()
        snap = snapshot_state(graphs, step, extra, mesh_spec=mesh_spec)
        if self._closed:  # after close (atexit ordering): synchronous
            return self.inner.write_snapshot(snap)
        self._q.put(snap)
        return os.path.join(self.inner.directory, f"ckpt_{step}")

    def wait(self) -> None:
        """Block until every enqueued save is durable; surface any worker
        error."""
        self._q.join()
        self._reraise()

    def close(self) -> None:
        """Drain, stop the worker, surface pending errors.  Idempotent; the
        instance saves synchronously afterwards."""
        if not self._closed:
            self._q.join()
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout=10)
            _OPEN.discard(self)
        self._reraise()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.close()
        except BaseException:
            if exc == (None, None, None):
                raise

    # -- barriered reads -----------------------------------------------------

    def steps(self) -> list:
        self.wait()
        return self.inner.steps()

    def latest_step(self) -> Optional[int]:
        self.wait()
        return self.inner.latest_step()

    def latest_verified_step(self) -> Optional[int]:
        self.wait()
        return self.inner.latest_verified_step()

    def verify(self, step: int) -> bool:
        self.wait()
        return self.inner.verify(step)

    def restore(self, graphs: Dict[str, object], step: Optional[int] = None,
                max_step: Optional[int] = None,
                mesh_spec: Optional[Dict] = None):
        self.wait()
        return self.inner.restore(graphs, step, max_step=max_step,
                                  mesh_spec=mesh_spec)

    def mesh_spec(self, step: int) -> Optional[Dict]:
        self.wait()
        return self.inner.mesh_spec(step)

    def prune_above(self, step: int) -> list:
        self.wait()
        return self.inner.prune_above(step)
