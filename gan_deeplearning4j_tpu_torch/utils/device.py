"""Device-to-host transfer helpers (torch twin of
``gan_deeplearning4j_tpu/utils/device.py``).

``overlap_device_get`` starts every device-to-host copy of a tree at once,
non-blocking into pinned memory behind one CUDA event, then waits for that
event and reads: one wait for the whole tree, not one per tensor
(``start_host_copy`` and ``read_host_copy`` are its two halves, for a
caller with other work to enqueue between them).  ``device_fence`` waits
for the work already enqueued on a stream; ``readback`` is a fence and a
copy in one (the trainer's per-call readback of its losses).  A pinned buffer is never
written twice: each copy takes a fresh one from torch's caching host
allocator, which does not hand a block out again before the copy that
used it has completed.

Every wait here is a bounded poll of ``event.query()`` with a short sleep,
never ``Event.synchronize()``, ``torch.cuda.synchronize()`` or a blocking
``tensor.cpu()``.  The hang watchdog (``train/watchdog.py``) raises into
the waiting thread with ``PyThreadState_SetAsyncExc``, which lands only at
a bytecode boundary: a thread parked inside a blocking CUDA call would
never see it, and a hung device would hang the server with it.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from gan_deeplearning4j_tpu_torch.utils.async_dump import host_copy

# fault-injection seam: called at the top of device_fence and readback so
# a chaos test can simulate a device readback that never completes — the
# hang class the watchdog exists to catch.  None in production.
_chaos_readback_hook: Optional[Callable[[], None]] = None

# the poll's sleep: the readback of a serving batch waits ~0.1-1 ms, so a
# coarser tick would add to every request's latency
POLL_S = 5e-5


def wait_event(event: Optional[torch.cuda.Event]) -> None:
    """Wait for ``event`` (None: nothing to wait for) by polling, so an
    async raise reaches this thread within one tick."""
    if event is None:
        return
    while not event.query():
        time.sleep(POLL_S)


def _leaves(tree: Any, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


def start_host_copy(tree: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """Begin the copy to host of every tensor leaf of ``tree`` WITHOUT
    waiting: each into a fresh pinned buffer on the current stream, all
    behind one event -> (the tree with the host tensors in place of the
    leaves, the event; None when nothing was on a card).  Call it right
    after enqueueing the work that produces the leaves: the copies then
    run before anything enqueued later on that stream."""
    hosts, event = host_copy(_leaves(tree, []))
    return _rebuild(tree, iter(hosts)), event


def read_host_copy(started: Tuple[Any, Optional[torch.cuda.Event]]) -> Any:
    """Wait (polled) for a ``start_host_copy`` and return its tree with
    numpy arrays in place of the host tensors; each array keeps its
    pinned buffer alive."""
    tree, event = started
    wait_event(event)
    return _rebuild(tree, iter(t.numpy() for t in _leaves(tree, [])))


def overlap_device_get(tree: Any) -> Any:
    """Every tensor leaf of ``tree`` (dicts, lists and tuples) as a numpy
    array, with the copies overlapped: all are started on the current
    stream, then one event is awaited.  Other leaves pass through."""
    return read_host_copy(start_host_copy(tree))


def stream_fence(stream: torch.cuda.Stream) -> None:
    """Wait (polled) for the work already enqueued on ``stream``."""
    event = torch.cuda.Event()
    event.record(stream)
    wait_event(event)


def device_fence(tree: Any, stream: Optional[torch.cuda.Stream] = None
                 ) -> None:
    """Wait for the work that produces the tensor leaves of ``tree``: an
    event recorded on ``stream`` (default: the current stream of the
    leaves' card) after everything already enqueued there, polled."""
    if _chaos_readback_hook is not None:
        _chaos_readback_hook()
    streams = [stream] if stream is not None else [
        torch.cuda.current_stream(d)
        for d in {t.device for t in _leaves(tree, [])
                  if t.device.type == "cuda"}]
    for s in streams:
        stream_fence(s)


def readback(tree: Any) -> Any:
    """Every tensor leaf of ``tree`` as a numpy array once the work that
    produces it is done: ``overlap_device_get`` behind the fault-injection
    hook, as ``device_fence`` runs it.  A leaf on the host comes back as a
    view of the tensor itself."""
    if _chaos_readback_hook is not None:
        _chaos_readback_hook()
    return overlap_device_get(tree)
