"""Prefetching batch iterators: overlap host IO with device compute (torch
twin of ``PrefetchIterator`` and ``ChunkPrefetchIterator`` in
``gan_deeplearning4j_tpu/data/prefetch.py``, without the dedup tier).

``PrefetchIterator`` runs a background thread ``prefetch_depth`` batches
ahead of the consumer over any iterator with the ``has_next``/``next``/
``reset`` protocol, skipping partial epoch tails (``min_rows``) and
wrapping on exhaustion (``loop``), and yields host numpy batches.

``ChunkPrefetchIterator`` assembles ``chunk_batches`` full batches into one
chunk per call of the K-step program and stages it on the card: the worker
fills a pinned host buffer, copies it on a side stream into a device
staging buffer and records an event.  The consumer (``next_into``) makes
the compute stream wait for that event and copies the staging buffer into
the buffers the captured step reads (one device-to-device copy on the
compute stream), so chunk k+1 crosses the host link while chunk k trains.
A staging slot goes back to the worker only after that copy: the worker
waits on the event the consumer recorded behind it before refilling the
slot.  On the CPU the same protocol runs with plain host arrays.

``restore_state`` repositions either pipeline at a source state (a
checkpoint's ``iter_state``): the staged batches are dropped and a fresh
worker starts there.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch


class PrefetchIterator:
    """Double (or deeper) buffered wrapper around a DataSet iterator.

    ``loop``: wrap around on exhaustion forever (the GAN trainers'
    multi-epoch semantics); otherwise one pass.  ``min_rows``: skip
    batches with fewer rows (the reference's skip-and-wrap of a partial
    epoch tail).  ``state()`` is the source's ``state()`` as of the
    batches already delivered to the consumer."""

    def __init__(self, source, prefetch_depth: int = 2, loop: bool = False,
                 min_rows: Optional[int] = None):
        if prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        self.source = source
        self.loop = loop
        self.min_rows = min_rows
        self.prefetch_depth = prefetch_depth
        # the first worker exception, kept out of band as well as enqueued
        # so that a close() that drains the queue cannot drop it
        self.error: Optional[BaseException] = None
        self._consumed_state = self._source_state()
        self._q: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker,
                                        name="gan4j-prefetch", daemon=True)
        self._thread.start()

    def _source_state(self):
        fn = getattr(self.source, "state", None)
        return None if fn is None else fn()

    def _pull(self):
        """The next full batch of the source, wrapping when ``loop``;
        None when the stream ends (a pass that yields no full batch ends
        it rather than spinning)."""
        while not self._stop.is_set():
            if not self.source.has_next():
                if not (self.loop and self._emitted_this_pass):
                    return None
                self.source.reset()
                self._emitted_this_pass = 0
                if not self.source.has_next():
                    return None
                continue
            ds = self.source.next()
            if self.min_rows and ds.num_examples() < self.min_rows:
                continue  # partial tail: skip (wraps via has_next above)
            self._emitted_this_pass += 1
            return ds
        return None

    def _produce(self) -> None:
        while True:
            ds = self._pull()
            if ds is None:
                return
            item = ((np.asarray(ds.features), np.asarray(ds.labels)),
                    self._source_state())
            if not self._put_stop_aware(item):
                return

    def _worker(self) -> None:
        self._emitted_this_pass = 0
        try:
            self._produce()
            self._put_stop_aware(None)  # sentinel: exhausted
        except BaseException as e:  # surface errors to the consumer
            if self.error is None:
                self.error = e
            self._put_stop_aware(e)

    def _put_stop_aware(self, item) -> bool:
        """put() that gives up once close() sets the stop flag."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.25)
                break
            except queue.Empty:
                continue
        if item is None:
            if self.error is not None:
                err, self.error = self.error, None
                raise err
            raise StopIteration
        if isinstance(item, BaseException):
            if item is self.error:
                self.error = None  # delivered; don't re-raise at close
            raise item
        payload, st = item
        if st is not None:
            self._consumed_state = st
        return payload

    def state(self):
        """The source's state after the batches already delivered."""
        return self._consumed_state

    def _discard(self, item) -> None:
        """Drop a staged item that a restore made stale."""

    def restore_state(self, state) -> None:
        """Reposition the whole pipeline at ``state``: stop the worker,
        discard everything staged (it predates the restore point), restore
        the source, and start a fresh worker from there.  The source must
        implement ``restore_state``."""
        restore = getattr(self.source, "restore_state", None)
        if restore is None:
            raise AttributeError(f"{type(self.source).__name__} does not "
                                 "expose restore_state")
        self._stop.set()
        try:
            while True:  # unblock a worker parked mid-put; drop staged
                item = self._q.get_nowait()
                if isinstance(item, tuple):
                    self._discard(item)
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("prefetch worker did not quiesce for "
                               "restore_state (source wedged in next()?)")
        self.error = None  # pre-restore failures died with the worker
        restore(state)
        self._consumed_state = self._source_state()
        self._q = queue.Queue(maxsize=self.prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker,
                                        name="gan4j-prefetch", daemon=True)
        self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker; a worker exception still queued is kept on
        ``error``."""
        self._stop.set()
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, BaseException) and self.error is None:
                    self.error = item
        except queue.Empty:
            pass
        try:
            self._q.put_nowait(None)  # release a reader blocked in __next__
        except queue.Full:
            pass
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ChunkPrefetchIterator(PrefetchIterator):
    """Stages ``chunk_batches`` consecutive full batches as one
    (K*B, F) features / (K*B, C) labels chunk on ``device`` (None or the
    CPU: host arrays).  Epoch semantics are the streaming loop's: partial
    tails skipped, exhaustion wraps.  ``encode_features`` (e.g. the u8x100
    codec's encoder) maps the assembled feature chunk on the host before
    it is staged; ``feature_dtype`` is then the encoded dtype.

    Consume with ``next_into(features, labels)``, which fills the given
    device buffers from the next chunk in the compute stream's order."""

    def __init__(self, source, chunk_batches: int, batch_size: int,
                 prefetch_depth: int = 1, device=None,
                 encode_features: Optional[Callable] = None,
                 feature_dtype=np.float32):
        if chunk_batches < 1:
            raise ValueError("chunk_batches must be >= 1")
        self.chunk_batches = chunk_batches
        self.encode_features = encode_features
        self.device = torch.device(device) if device is not None else None
        self._cuda = self.device is not None and self.device.type == "cuda"
        rows = chunk_batches * batch_size
        n_feat = source.features.shape[1]
        n_lab = source.labels.shape[1]
        # prefetch_depth queued + one staging + one being consumed
        n_slots = prefetch_depth + 2
        self._free: queue.Queue = queue.Queue()
        self._host: List = []
        self._staged: List = []
        self._ready: List = []
        self._done: List = []
        for s in range(n_slots):
            hf = torch.from_numpy(np.empty((rows, n_feat), feature_dtype))
            hl = torch.from_numpy(np.empty((rows, n_lab), np.float32))
            if self._cuda:
                hf, hl = hf.pin_memory(), hl.pin_memory()
            self._host.append((hf, hl))
            if self._cuda:
                self._staged.append((torch.empty_like(hf, device=self.device),
                                     torch.empty_like(hl, device=self.device)))
                self._ready.append(torch.cuda.Event())
                self._done.append(torch.cuda.Event())
            self._free.put(s)
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._used = [False] * n_slots
        super().__init__(source, prefetch_depth=prefetch_depth, loop=True,
                         min_rows=batch_size)

    def _take_slot(self) -> Optional[int]:
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _produce(self) -> None:
        while True:
            feats, labs = [], []
            while len(feats) < self.chunk_batches:
                ds = self._pull()
                if ds is None:
                    return
                feats.append(np.asarray(ds.features))
                labs.append(np.asarray(ds.labels))
            st = self._source_state()  # position after the chunk
            s = self._take_slot()
            if s is None:
                return
            if self._cuda and self._used[s]:
                # the slot's last device-to-device copy (and so its last
                # upload from the pinned buffer) must be done
                self._done[s].synchronize()
            f_chunk = np.concatenate(feats)
            if self.encode_features is not None:
                f_chunk = self.encode_features(f_chunk)
            hf, hl = self._host[s]
            hf.numpy()[...] = f_chunk
            np.concatenate(labs, out=hl.numpy())
            if self._cuda:
                df, dl = self._staged[s]
                with torch.cuda.stream(self._side):
                    df.copy_(hf, non_blocking=True)
                    dl.copy_(hl, non_blocking=True)
                    self._ready[s].record(self._side)
            if not self._put_stop_aware((s, st)):
                self._free.put(s)
                return

    def _discard(self, item) -> None:
        self._free.put(item[0])  # the staged chunk's slot

    def next_into(self, features: torch.Tensor, labels: torch.Tensor) -> None:
        """Copy the next chunk into ``features``/``labels`` (raises
        StopIteration when the stream has ended)."""
        s = self.__next__()
        if self._cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self._ready[s])
            src = self._staged[s]
        else:
            src = self._host[s]
        features.copy_(src[0])
        labels.copy_(src[1])
        if self._cuda:
            self._done[s].record(cur)
            self._used[s] = True
        self._free.put(s)
