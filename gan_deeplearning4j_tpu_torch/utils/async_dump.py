"""Asynchronous artifact writer (own copy of
``gan_deeplearning4j_tpu/utils/async_dump.py``): overlap artifact readback
and CSV IO with training.

The reference writes its periodic artifacts synchronously on the training
thread.  Here the trainer enqueues an artifact's device work on the compute
stream at the step boundary (so the values are an exact snapshot of that
step) and starts its copy to pinned host memory; a single background
worker waits for the copy and formats and writes the file.  The queue is
bounded: each pending job holds its host buffer, so a blocking ``submit``
caps what a slow disk can pile up.

Failure semantics: a worker exception is captured and re-raised on the
training thread at the next ``submit``/``flush``/``close``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional, Sequence

import torch


def host_copy(ts: Sequence[torch.Tensor]):
    """Start each tensor's copy to host memory on the current stream ->
    (host tensors, event or None); the event completes with the copies.
    Tensors already on the host come back detached, uncopied.  A bf16
    tensor (a head under ``--mp``) is converted to f32 first, exactly:
    numpy has no bf16, and the JAX callers convert so too."""
    ts = [t.float() if t.dtype == torch.bfloat16 else t for t in ts]
    if not any(t.device.type == "cuda" for t in ts):
        return [t.detach() for t in ts], None
    hosts = []
    for t in ts:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    event = torch.cuda.Event()
    event.record()
    return hosts, event


class AsyncArtifactWriter:
    """Run zero-arg write jobs on a background thread, in submit order.

    ``synchronous=True`` degrades to running each job inline at ``submit``
    (the reference's behavior, and the fallback for debugging or
    single-threaded environments); the API is identical either way.
    """

    def __init__(self, max_pending: int = 4, synchronous: bool = False):
        self._synchronous = synchronous
        self._error: Optional[BaseException] = None
        if synchronous:
            return
        self._closed = False
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue(
            maxsize=max_pending)
        self._thread = threading.Thread(
            target=self._worker, name="gan4j-artifact-writer", daemon=True)
        self._thread.start()

    # -- worker --------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                if self._error is None:  # fail fast: skip jobs after error
                    job()
            except BaseException as e:  # noqa: BLE001 — reraised on main thread
                if self._error is None:
                    self._error = e
            finally:
                self._q.task_done()

    def _reraise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- API -----------------------------------------------------------------

    def submit(self, job: Callable[[], None],
               timeout: float = 600.0) -> None:
        """Enqueue a write job (blocking when ``max_pending`` jobs wait).

        Bounded: a worker wedged on a stalled disk/readback surfaces as
        the same 'artifact writer stalled' RuntimeError that flush()/
        close() raise, instead of deadlocking the training thread at the
        next submit."""
        self._reraise()
        if self._synchronous or self._closed:
            # after close() the worker is gone — run inline rather than
            # letting the job vanish into a dead queue
            job()
            return
        try:
            self._q.put(job, timeout=timeout)
        except queue.Full:
            raise RuntimeError(
                f"artifact writer stalled: queue full ({self._q.maxsize} "
                f"pending) after {timeout:.0f}s") from None

    def _drain(self, timeout: float) -> None:
        """queue.join with a deadline: a hung write job (stalled disk,
        wedged readback) surfaces as a RuntimeError on the training
        thread instead of deadlocking the run."""
        deadline = time.monotonic() + timeout
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        f"artifact writer stalled: {self._q.unfinished_tasks}"
                        f" job(s) still pending after {timeout:.0f}s")
                self._q.all_tasks_done.wait(remaining)

    def flush(self, timeout: float = 600.0) -> None:
        """Block until every submitted job has run (raising if the worker
        stalls past ``timeout``); surface worker errors."""
        if not self._synchronous:
            self._drain(timeout)
        self._reraise()

    def close(self, timeout: float = 600.0) -> None:
        """Flush, stop the worker, and surface any pending error."""
        if self._synchronous:
            self._reraise()
            return
        if not self._closed:
            # drain BEFORE marking closed: a drain timeout leaves the
            # writer open (the worker may still be wedged on a job), so a
            # retry of close() drains again instead of silently
            # succeeding while jobs are pending — and submit() keeps
            # queueing rather than racing the stuck worker inline
            self._drain(timeout)
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout=10)
        self._reraise()

    def __enter__(self) -> "AsyncArtifactWriter":
        return self

    def __exit__(self, *exc) -> None:
        # on an exception in the with-body, still drain (artifacts already
        # snapshotted are valid) but let the body's exception win
        try:
            self.close()
        except BaseException:
            if exc == (None, None, None):
                raise
