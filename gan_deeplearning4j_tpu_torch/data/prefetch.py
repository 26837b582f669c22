"""Prefetching batch iterators: overlap host IO with device compute (torch
twin of ``PrefetchIterator`` and ``ChunkPrefetchIterator`` in
``gan_deeplearning4j_tpu/data/prefetch.py``, with its dedup tier).

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

``ChunkPrefetchIterator(dedup=True)`` is the adaptive epoch-in-chunk
tier: when one chunk covers at least a full pass of a deterministic
source, the distinct rows (the first pass's batches, each later pass held
to them by exact comparison) cross the link once, as one table, and each
chunk ships only its [K*B] int32 row-index schedule into the table; the
step (``fused_step`` ``chunk_indexed``) gathers its batch through it.  A
pass that outgrows the shipped table, or a batch that differs from the
first pass's at its position, raises; the tier never falls back.

``restore_state`` repositions either pipeline at a source state (a
checkpoint's ``iter_state``): the staged batches are dropped and a fresh
worker starts there.  The dedup tier refuses (its table is assembled from
the pass the worker has seen); restore the source before wrapping it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.telemetry import events

# a consumer wait at least this long is a ``data.prefetch_stall`` event
STALL_EVENT_S = 0.05


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
        try:  # fast path: the worker stayed ahead, no stall to record
            item = self._q.get_nowait()
        except queue.Empty:
            t0 = time.perf_counter()
            # a polled wait, never a bare blocking get: the watchdog's
            # async raise lands only between bytecodes
            while True:
                try:
                    item = self._q.get(timeout=0.25)
                    break
                except queue.Empty:
                    continue
            waited = time.perf_counter() - t0
            if waited >= STALL_EVENT_S:
                events.instant("data.prefetch_stall",
                               seconds=round(waited, 6))
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
        implement ``restore_state``; the dedup chunk tier refuses."""
        if getattr(self, "dedup", False):
            raise RuntimeError(
                "restore_state is not supported in dedup chunk mode — "
                "restore the raw source before wrapping instead")
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
    device buffers from the next chunk in the compute stream's order.

    ``dedup``: the epoch-in-chunk tier (the module docstring).  The chunk
    is then the [K*B] int32 schedule of rows into the distinct-row table,
    and ``next_into(features, labels, row_idx)`` fills the table buffers
    (the first call only; ``decode_features`` maps the staged encoded
    table into ``features``) and ``row_idx``.  ``start_batch``: the pass
    position of the source's next batch (a resumed run's source starts
    mid-pass; the table then holds the batches in the order first met, and
    the schedule points into it)."""

    def __init__(self, source, chunk_batches: int, batch_size: int,
                 prefetch_depth: int = 1, device=None,
                 encode_features: Optional[Callable] = None,
                 feature_dtype=np.float32, dedup: bool = False,
                 start_batch: int = 0,
                 decode_features: Optional[Callable] = None):
        if chunk_batches < 1:
            raise ValueError("chunk_batches must be >= 1")
        self.chunk_batches = chunk_batches
        self.encode_features = encode_features
        self.decode_features = decode_features
        self.dedup = dedup
        self.start_batch = start_batch
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
            if dedup:
                bufs = (torch.empty(rows, dtype=torch.int32),)
            else:
                bufs = (torch.from_numpy(np.empty((rows, n_feat),
                                                  feature_dtype)),
                        torch.from_numpy(np.empty((rows, n_lab), np.float32)))
            if self._cuda:
                bufs = tuple(b.pin_memory() for b in bufs)
            self._host.append(bufs)
            if self._cuda:
                self._staged.append(tuple(
                    torch.empty_like(b, device=self.device) for b in bufs))
                self._ready.append(torch.cuda.Event())
                self._done.append(torch.cuda.Event())
            self._free.put(s)
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._used = [False] * n_slots
        # the dedup tier's table: staged once by the worker (host, device
        # copy, its event), copied into the consumer's buffers once
        self._table = None
        self._table_taken = False
        # bytes the worker put on the link: the table once, every chunk
        self.table_bytes = 0
        self.chunk_bytes = 0
        super().__init__(source, prefetch_depth=prefetch_depth, loop=True,
                         min_rows=batch_size)

    def _take_slot(self) -> Optional[int]:
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _stage(self, arrays, st) -> bool:
        """Fill a free slot's pinned buffers with ``arrays``, start their
        upload on the side stream and queue the slot; False once stopped."""
        s = self._take_slot()
        if s is None:
            return False
        if self._cuda and self._used[s]:
            # the slot's last device-to-device copy (and so its last
            # upload from the pinned buffer) must be done
            self._done[s].synchronize()
        for h, a in zip(self._host[s], arrays):
            h.numpy()[...] = a
        self.chunk_bytes = sum(h.numel() * h.element_size()
                               for h in self._host[s])
        if self._cuda:
            with torch.cuda.stream(self._side):
                for d, h in zip(self._staged[s], self._host[s]):
                    d.copy_(h, non_blocking=True)
                self._ready[s].record(self._side)
        if not self._put_stop_aware((s, st)):
            self._free.put(s)
            return False
        return True

    def _produce(self) -> None:
        if self.dedup:
            return self._produce_dedup()
        while True:
            feats, labs = [], []
            while len(feats) < self.chunk_batches:
                ds = self._pull()
                if ds is None:
                    return
                feats.append(np.asarray(ds.features))
                labs.append(np.asarray(ds.labels))
            st = self._source_state()  # position after the chunk
            f_chunk = np.concatenate(feats)
            if self.encode_features is not None:
                f_chunk = self.encode_features(f_chunk)
            if not self._stage((f_chunk, np.concatenate(labs)), st):
                return

    def _ship_table(self, feats: List, labs: List) -> None:
        """The distinct-row table, on the link once (the worker's first
        chunk): pinned host copies and, on the card, their upload on the
        side stream behind an event."""
        tf = np.concatenate(feats)
        if self.encode_features is not None:
            tf = self.encode_features(tf)
        host = (torch.from_numpy(np.ascontiguousarray(tf)),
                torch.from_numpy(np.concatenate(labs)))
        self.table_bytes = sum(h.numel() * h.element_size() for h in host)
        if not self._cuda:
            self._table = (host, None)
            return
        host = tuple(h.pin_memory() for h in host)
        ready = torch.cuda.Event()
        with torch.cuda.stream(self._side):
            dev = tuple(h.to(self.device, non_blocking=True) for h in host)
            ready.record(self._side)
        self._table = (dev, ready)

    def _produce_dedup(self) -> None:
        """The JAX worker's ``_worker_dedup``: the first pass's batches
        become the table, every later batch is held to the one at its pass
        position, and each chunk ships the table rows of its K batches."""
        feats: List = []   # distinct batches, in the order first met
        labs: List = []
        slot_of = {}       # pass position -> index into feats
        n_pass = None      # batches a pass, known at the first wrap
        pos = self.start_batch
        parts: List = []
        while not self._stop.is_set():
            if not self.source.has_next():
                if not feats:
                    return  # empty (or all-partial) dataset
                if n_pass is None:
                    n_pass = pos
                self.source.reset()
                pos = 0
                if not self.source.has_next():
                    return
                continue
            ds = self.source.next()
            if self.min_rows and ds.num_examples() < self.min_rows:
                continue  # partial epoch tail: skip-and-wrap
            f, lab = np.asarray(ds.features), np.asarray(ds.labels)
            slot = slot_of.get(pos)
            if slot is None and (n_pass is None or pos < n_pass):
                if self._table is not None:
                    # the table already shipped while the first pass is
                    # still producing new batches: the chunk does not
                    # cover a pass, and later indices would leave the table
                    raise RuntimeError(
                        "dedup=True requires chunk_batches >= batches per "
                        f"pass (the shipped distinct-row table held "
                        f"{len(feats)} batches but the first pass keeps "
                        "going); use plain chunking for "
                        "chunk-smaller-than-epoch streams")
                slot_of[pos] = slot = len(feats)
                feats.append(f)
                labs.append(lab)
            elif slot is None or not (np.array_equal(f, feats[slot])
                                      and np.array_equal(lab, labs[slot])):
                raise RuntimeError(
                    "dedup chunk streaming requires a deterministic "
                    f"source: batch at pass position {pos} differs from "
                    "(or extends) the first pass; disable dedup for "
                    "shuffling/nondeterministic iterators")
            B = f.shape[0]
            parts.append(np.arange(slot * B, (slot + 1) * B, dtype=np.int32))
            pos += 1
            if len(parts) < self.chunk_batches:
                continue
            if self._table is None:
                # the chunk covers >= one full pass: the table is whole
                self._ship_table(feats, labs)
            st = self._source_state()  # position after the chunk
            idx, parts = np.concatenate(parts), []
            if not self._stage((idx,), st):
                return

    def _discard(self, item) -> None:
        self._free.put(item[0])  # the staged chunk's slot

    def next_into(self, features: torch.Tensor, labels: torch.Tensor,
                  row_idx: Optional[torch.Tensor] = None) -> None:
        """Copy the next chunk into ``features``/``labels`` (dedup: the
        table, on the first call, and the schedule into ``row_idx``);
        raises StopIteration when the stream has ended."""
        s = self.__next__()
        cur = torch.cuda.current_stream(self.device) if self._cuda else None
        if self.dedup and not self._table_taken:
            (tf, tl), ready = self._table
            if ready is not None:
                cur.wait_event(ready)
            if self.decode_features is not None:
                tf = self.decode_features(tf)
            features.copy_(tf)
            labels.copy_(tl)
            self._table_taken = True
        if self._cuda:
            cur.wait_event(self._ready[s])
            src = self._staged[s]
        else:
            src = self._host[s]
        dst = (row_idx,) if self.dedup else (features, labels)
        for d, a in zip(dst, src):
            d.copy_(a)
        if self._cuda:
            self._done[s].record(cur)
            self._used[s] = True
        self._free.put(s)
