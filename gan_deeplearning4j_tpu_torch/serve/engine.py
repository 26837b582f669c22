"""The continuous-batching dispatch engine (torch twin of
``gan_deeplearning4j_tpu/serve/engine.py``).

One dedicated thread (``gan4j-serve-dispatch``) drains the admission
queue each cycle, coalesces whatever arrived into ONE batch, pads it
host-side to the serving buckets (``parallel/inference.py`` — the engine
never invents a dispatch shape, so on a card every dispatch replays one
of the CUDA graphs captured at warm-up), and overlaps host work with
device work at pipeline depth 1: while batch N runs on the device, the
loop is already draining and coalescing batch N+1; N's outputs are fenced
and fanned back to their requests only after N+1 is dispatched.  Every
upload, replay and copy runs on the inference's one serving stream; each
batch's copy to pinned host memory is enqueued right behind its replays,
so batch N+1's replay of the same bucket cannot overwrite it, and the
fence is a polled event (``utils/device.py``).

Supervision: a ``HeartbeatWatchdog`` (train/watchdog.py) watches the
dispatch thread through the beat/region API.  A hang anywhere in the
cycle (a wedged dispatch, a dead device) becomes a ``WatchdogTimeout``
raised ON the dispatch thread; the loop fails every in-flight and queued
request with the typed error (never a silent hang), re-arms a fresh
watchdog, and keeps serving.  A cycle that RAISES rather than hangs (a
malformed coalesced batch that slipped past submit validation, a device
failure) fails that batch's in-flight requests with a typed
``DispatchError`` and keeps serving — the dispatch thread never dies
while ``submit`` keeps admitting; if it somehow still does, the exit
path closes the admission queue and answers everything outstanding.

Weight hot-swap: ``refresh()`` flags the loop to copy the graph's params
into the captured snapshot (``ParallelInference.refresh_params``) between
batches — same shapes, same graphs, zero captures; ``hotswap_from`` first
loads the newest VERIFIED checkpoint (the JAX on-disk format, through
``checkpoint/checkpointer.py``) into the graph and then flags the
refresh.

Ops surface: ``report()`` carries the JAX engine's keys (the feed of
``MetricsRegistry.observe_serve``); ``stage_report()`` sums the host's
time per dispatch cycle by stage.  Every cycle is a ``serve.dispatch``
span on the events timeline, and hot swaps, timeouts and raised cycles
are ``serve.*`` instants.  A request submitted with a trace context gets
its ``trace.*`` stage spans (queue wait, coalesce, bucket pad, dispatch,
readback), cut from the same timestamps ``stage_report`` sums: the
dispatch span brackets the uploads, the graph replays and the copies'
enqueue, the readback span the fence that ends the copy to host memory.
Untraced requests record nothing per request.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.parallel.inference import (
    DEFAULT_SERVING_BUCKETS,
    ParallelInference,
)
from gan_deeplearning4j_tpu_torch.serve.admission import AdmissionQueue, Request
from gan_deeplearning4j_tpu_torch.serve.loadgen import percentiles
from gan_deeplearning4j_tpu_torch.telemetry import events, tracing
from gan_deeplearning4j_tpu_torch.train.watchdog import (
    HeartbeatWatchdog,
    WatchdogTimeout,
)
from gan_deeplearning4j_tpu_torch.utils.device import (
    device_fence,
    read_host_copy,
    start_host_copy,
)

_log = logging.getLogger(__name__)

# fault-injection seam: called at the top of every batch dispatch so a
# chaos test can simulate a dispatch that never completes — the
# serving-plane hang class the watchdog converts into typed request
# failures.  None in production.
_chaos_dispatch_hook: Optional[Callable[[], None]] = None

# one in-flight batch: (requests, its segments' outputs as started host
# copies, dispatch-start time, real rows, padded device rows, stage
# timings and the timestamps trace spans are cut from)
_Batch = Tuple[List[Request], Tuple, float, int, int, Dict]

# the host's time per dispatch cycle, by stage (stage_report)
STAGES = ("coalesce_s", "bucket_pad_s", "dispatch_s", "readback_s",
          "fanout_s")


class DispatchError(RuntimeError):
    """A dispatch cycle raised on the serving thread (malformed
    coalesced batch, device failure) — NOT a hang.  Attached to every
    in-flight request of the failed batch as its typed answer; queued
    requests are untouched and the engine keeps serving (the blast
    radius of a poison batch is that batch).  The original exception is
    chained as ``__cause__``."""


def _array_trailing(spec) -> Tuple[int, ...]:
    """The trailing (non-batch) shape of the HOST array a graph input
    spec expects: flat inputs arrive flattened (``_forward`` reshapes
    ``cnn_flat`` to NCHW itself), everything else arrives as the spec's
    declared shape."""
    if spec.kind == "cnn_flat":
        h, w, c = spec.shape
        return (h * w * c,)
    return tuple(spec.shape)


class ServeEngine:
    """Continuous-batching generation service over one bucketed
    ``ParallelInference``.

    ``graph``: the generator ``ComputationGraph`` to serve.
    ``buckets``: the closed dispatch-shape set (defaults to
    ``DEFAULT_SERVING_BUCKETS``).  ``admission``: the bounded front door
    (default: an ``AdmissionQueue()``).  ``watchdog_deadline_s``:
    explicit hang deadline for the dispatch loop (None = the watchdog's
    auto-scaled deadline); ``supervise=False`` disables the watchdog
    entirely (single-threaded tests)."""

    def __init__(self, graph=None, mesh=None,
                 buckets: Sequence[int] = DEFAULT_SERVING_BUCKETS,
                 admission: Optional[AdmissionQueue] = None,
                 supervise: bool = True,
                 watchdog_deadline_s: Optional[float] = None,
                 idle_poll_s: float = 0.01,
                 latency_window: int = 4096,
                 infer: Optional[ParallelInference] = None):
        if infer is not None:
            if infer.buckets is None:
                raise ValueError(
                    "the engine needs a bucketed ParallelInference — "
                    "an unbucketed one has no closed dispatch-shape "
                    "set to serve from")
            self._infer = infer
            graph = infer.graph
        else:
            if graph is None:
                raise ValueError("ServeEngine needs a graph or a "
                                 "prebuilt ParallelInference")
            self._infer = ParallelInference(graph, mesh=mesh,
                                            buckets=buckets)
        self.admission = admission if admission is not None \
            else AdmissionQueue()
        self._supervise = bool(supervise)
        self._wd_deadline_s = watchdog_deadline_s
        self._idle_poll_s = float(idle_poll_s)
        self._max_rows = self._infer.buckets[-1]
        self._n_inputs = len(graph.input_names)
        self._input_names = list(graph.input_names)
        # per-input admission contract: the trailing (non-batch) array
        # shape from the graph's InputSpec and the served dtype (float32
        # until warmup captures the real one from its examples).
        # submit() rejects a mismatch BEFORE admission: one tenant's
        # malformed request must fail that tenant's call, never reach the
        # shared dispatch thread's coalescing — and a novel dtype or
        # trailing shape would also need a novel graph.
        self._input_trailing: List[Optional[Tuple[int, ...]]] = []
        self._input_dtypes: List[np.dtype] = []
        specs = getattr(graph, "input_specs", {}) or {}
        for name in self._input_names:
            spec = specs.get(name)
            self._input_trailing.append(
                None if spec is None else _array_trailing(spec))
            self._input_dtypes.append(np.dtype(np.float32))
        self._lock = threading.Lock()
        # the swap lock serializes host-side param mutation (a checkpoint
        # restore on a caller thread) against the dispatch thread's
        # refresh; it nests with NOTHING (engine lock, admission lock and
        # swap lock are pairwise disjoint)
        self._swap_lock = threading.Lock()
        # recorded behind a swap's writes on the swapping thread's stream;
        # the refresh waits for it on the serving stream
        self._swap_ready: Optional[torch.cuda.Event] = None
        self._stop = threading.Event()
        self._refresh = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[HeartbeatWatchdog] = None
        self._open: List[Request] = []
        self._latencies: deque = deque(maxlen=int(latency_window))
        self._fills: deque = deque(maxlen=256)
        self._requests_total = 0
        self._batches_total = 0
        self._timeouts_total = 0
        self._errors_total = 0
        self._stage_s = dict.fromkeys(STAGES, 0.0)

    @property
    def infer(self) -> ParallelInference:
        return self._infer

    # -- producer API (any thread) ---------------------------------------------

    def submit(self, *xs, trace=None) -> Request:
        """Enqueue one generation request; returns the ``Request`` (its
        ``result()`` blocks for the outputs).  Raises ``ValueError``
        when the inputs don't match the served graph's input spec
        (count, trailing shape, dtype — rejected BEFORE admission so a
        malformed request can never poison the shared coalesced batch),
        ``ShedError`` when admission control rejects it,
        ``RuntimeError`` when the engine is not running (a dead engine
        must never accept work it can't finish).

        ``trace``: optional ``tracing.TraceContext`` — when set, the
        dispatch loop decomposes this request into ``trace.*`` stage
        spans (queue wait, coalesce, bucket pad, dispatch, readback)
        parented under it (``TypeError`` for anything else).  Untraced
        requests record nothing extra."""
        if trace is not None and not isinstance(trace, tracing.TraceContext):
            raise TypeError(f"trace must be a tracing.TraceContext, not "
                            f"{type(trace).__name__}")
        if not self.running:
            raise RuntimeError("serve engine is not running")
        req = Request(xs, trace=trace)
        self._validate(req)
        return self.admission.submit(req)

    def _validate(self, req: Request) -> None:
        if len(req.xs) != self._n_inputs:
            raise ValueError(
                f"request carries {len(req.xs)} input(s); the served "
                f"graph takes {self._n_inputs}")
        for i, x in enumerate(req.xs):
            want = self._input_trailing[i]
            if want is not None and tuple(x.shape[1:]) != want:
                raise ValueError(
                    f"input {i} ({self._input_names[i]!r}): trailing "
                    f"shape {tuple(x.shape[1:])} does not match the "
                    f"served graph's expected {want}")
            dt = self._input_dtypes[i]
            if np.dtype(x.dtype) != dt:
                raise ValueError(
                    f"input {i} ({self._input_names[i]!r}): dtype "
                    f"{np.dtype(x.dtype)} does not match the served "
                    f"{dt} — a novel dtype would be a novel compile "
                    f"shape")

    def generate(self, *xs, timeout: Optional[float] = 60.0) -> List:
        """Synchronous convenience: submit + bounded wait."""
        return self.submit(*xs).result(timeout=timeout)

    def refresh(self) -> None:
        """Flag a zero-capture weight refresh: the dispatch loop runs
        ``refresh_params`` between batches (same shapes, same graphs)."""
        self._refresh.set()

    def _swapped(self) -> None:
        """Mark a swap's writes (call under the swap lock, on the swapping
        thread) and flag the refresh."""
        if self._infer.stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._infer.device))
            self._swap_ready = ready
        self.refresh()

    def hotswap_from(self, directory: str, name: str = "gen", *,
                     step: Optional[int] = None,
                     max_step: Optional[int] = None) -> int:
        """Load the newest VERIFIED checkpoint under ``directory`` into
        the served graph, then flag the refresh.  Returns the restored
        step.

        A corrupt/unverifiable newest checkpoint is SKIPPED (logged with
        its step and why) and the walk falls back to the newest verified
        one, so a torn save landing mid-swap degrades the swap to the
        previous weights instead of failing it.  Raises
        ``NoVerifiedCheckpointError`` when nothing verifiable exists (the
        engine keeps serving the old weights).  Structure mismatches
        (``ValueError``) are a caller bug, not corruption, and always
        propagate.

        ``step``: explicit pin — verification failure raises
        ``CheckpointCorruptError``, no silent substitution.
        ``max_step``: bound the newest-first walk."""
        from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
            NoVerifiedCheckpointError,
            TrainCheckpointer,
        )

        # read-side handle: this engine only OBSERVES the trainer's
        # directory; sweeping would tear an in-flight save's tmp dir
        ckpt = TrainCheckpointer(directory, sweep_debris=False)
        if step is not None:
            with self._swap_lock:
                got, _ = ckpt.restore({name: self._infer.graph}, step=step)
                self._swapped()
            events.instant("serve.hotswap", step=got, directory=directory)
            return got
        candidates = ckpt.steps()
        if max_step is not None:
            candidates = [s for s in candidates if s <= max_step]
        for s in reversed(candidates):
            # verify OUTSIDE the swap lock (sha256 over every file); only
            # the in-place load itself excludes the dispatch loop's refresh
            if not ckpt.verify(s):
                events.instant("serve.hotswap_rejected", step=s,
                               directory=directory,
                               reason="fails manifest verification "
                                      "(torn or corrupt)")
                continue
            try:
                with self._swap_lock:
                    got, _ = ckpt.restore({name: self._infer.graph}, step=s)
                    self._swapped()
            except ValueError:
                raise  # structure mismatch: fatal, not corruption
            except Exception as e:  # unreadable despite the manifest
                events.instant("serve.hotswap_rejected", step=s,
                               directory=directory,
                               reason=f"failed to load: {e!r}")
                continue
            events.instant("serve.hotswap", step=got, directory=directory)
            return got
        raise NoVerifiedCheckpointError(
            f"no VERIFIED checkpoint in {directory}"
            + (f" at or below step {max_step}"
               if max_step is not None else "")
            + f" (candidates: {candidates})")

    def hotswap_params(self, params) -> None:
        """Swap an already-materialized parameter tree (tensors on the
        served graph's device, the same structure and shapes) into the
        served graph, then flag the refresh — the in-memory sibling of
        ``hotswap_from``, keeping the engine object (and every router
        holding it) stable across the swap."""
        with self._swap_lock:
            self._infer.graph.params = params
            self._swapped()

    # -- lifecycle -------------------------------------------------------------

    def warmup(self, *example_xs) -> None:
        """Capture every bucket before taking traffic: one dispatch per
        declared bucket, largest first (the graphs share one memory
        pool), with zero-filled inputs shaped like ``example_xs`` (any row
        count; only trailing dims and dtypes matter).  After this,
        steady-state serving captures nothing (``infer.captures`` stays
        at the bucket count)."""
        if len(example_xs) != self._n_inputs:
            raise ValueError(
                f"warmup needs {self._n_inputs} example input(s)")
        examples = [np.asarray(x) for x in example_xs]
        trailing = list(self._input_trailing)
        dtypes = list(self._input_dtypes)
        for i, x in enumerate(examples):
            want = trailing[i]
            if want is not None and tuple(x.shape[1:]) != want:
                raise ValueError(
                    f"warmup example {i} ({self._input_names[i]!r}): "
                    f"trailing shape {tuple(x.shape[1:])} does not "
                    f"match the graph's input spec {want}")
            trailing[i] = tuple(x.shape[1:])
            dtypes[i] = np.dtype(x.dtype)
        # the warmed shapes/dtypes ARE the captured set: they become the
        # admission contract submit() enforces
        with self._lock:
            self._input_trailing = trailing
            self._input_dtypes = dtypes
        outs = None
        for b in reversed(self._infer.buckets):
            xs = [np.zeros((b,) + tuple(x.shape[1:]), dtype=x.dtype)
                  for x in examples]
            outs = self._infer.output(*xs)
        if outs is not None:
            device_fence(outs)

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    @property
    def stalled(self) -> bool:
        """True while the dispatch loop is past its watchdog deadline
        (the ``/healthz`` serve block's failure condition).  Cheap — one
        lock and a flag read — so the router's per-request health probe
        can call it on the hot path."""
        with self._lock:
            wd = self._watchdog
        return bool(wd is not None and wd.stalled)

    def start(self) -> "ServeEngine":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("serve engine already started")
            self._stop.clear()
            thread = threading.Thread(
                target=self._loop, name="gan4j-serve-dispatch",
                daemon=True)
            self._thread = thread
        self.admission.reopen()  # a restart after stop() serves again
        thread.start()
        self._arm_watchdog(thread)
        return self

    def stop(self) -> None:
        """Stop the dispatch loop (bounded join) and fail anything still
        queued with a typed error — a stopped engine answers every
        outstanding request, it never strands one.  The admission queue
        is closed FIRST (under its own lock), so a submit racing this
        method either lands before the fail_all sweep (and is failed by
        it) or raises."""
        self._stop.set()
        self.admission.close()
        self.admission.wake.set()  # break the idle park
        with self._lock:
            thread, self._thread = self._thread, None
            wd, self._watchdog = self._watchdog, None
        if wd is not None:
            wd.stop()
        if thread is not None:
            thread.join(timeout=30.0)
        err = RuntimeError("serve engine stopped")
        self.admission.fail_all(err)
        with self._lock:
            leftovers, self._open = self._open, []
        for r in leftovers:
            if not r.done.is_set():
                r.error = err
                r.done.set()

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the dispatch loop (gan4j-serve-dispatch thread) -----------------------

    def _loop(self) -> None:
        try:
            with self._infer.on_stream():
                self._serve()
        finally:
            if not self._stop.is_set():
                # the dispatch thread is dying OUTSIDE an orderly stop()
                # — an async watchdog raise escaped even the recovery
                # shield.  A dead engine must never keep admitting work
                # nothing will serve: close the front door, answer
                # everything outstanding, and drop the thread handle so
                # ``running`` turns False.
                err = RuntimeError(
                    "serve dispatch thread died unexpectedly — the "
                    "engine is stopped; outstanding requests failed "
                    "with this typed error")
                self.admission.close()
                with self._lock:
                    open_reqs, self._open = self._open, []
                    if self._thread is threading.current_thread():
                        self._thread = None
                for r in open_reqs:
                    if not r.done.is_set():
                        r.error = err
                        r.done.set()
                self.admission.fail_all(err)

    def _serve(self) -> None:
        pending: Optional[_Batch] = None
        cycle = 0
        while not self._stop.is_set():
            try:
                try:
                    wd = self._wd()
                    if wd is not None:
                        wd.beat()
                    if self._refresh.is_set():
                        self._refresh.clear()
                        with self._swap_lock:
                            self._infer.refresh_params(
                                ready=self._swap_ready)
                    reqs = self.admission.drain(self._max_rows)
                    inflight: Optional[_Batch] = None
                    if reqs:
                        with self._lock:
                            self._open.extend(reqs)
                        inflight = self._dispatch(reqs, wd)
                    # pipeline depth 1: batch N+1 is already on the
                    # device before batch N's outputs are fenced and
                    # fanned out
                    if pending is not None:
                        self._complete(pending, wd)
                    pending = inflight
                    if reqs or pending is not None:
                        cycle += 1
                        if wd is not None:
                            wd.beat(step=cycle)
                    else:
                        self.admission.wake.wait(self._idle_poll_s)
                except WatchdogTimeout:
                    pending = None
                    self._on_timeout()
                except Exception as e:
                    pending = None
                    self._on_error(e)
            except BaseException:
                # async-raise lands at ANY bytecode boundary, so a second
                # WatchdogTimeout can hit INSIDE the recovery handlers
                # above.  The first delivery is already being handled:
                # finish the recovery best-effort — every open/queued
                # request answered, watchdog re-armed — and keep
                # serving; the dispatch thread dying is the one
                # unacceptable outcome.
                pending = None
                try:
                    self._on_timeout()
                except BaseException:
                    _log.exception("serve: recovery after a second "
                                   "watchdog raise failed")
        # orderly exit: the batch already on the device completes;
        # stop() fails whatever is still queued
        if pending is not None:
            self._complete(pending, None)

    def _wd(self) -> Optional[HeartbeatWatchdog]:
        with self._lock:
            return self._watchdog

    def _plan(self, rows: int) -> List[int]:
        """The bucket segments a ``rows``-row batch dispatches as — the
        same policy as ``ParallelInference.output`` (one covering
        bucket, or largest-bucket chunks with the tail covered),
        computed HOST-side so the engine can pad in numpy and every
        device dispatch is exactly a captured bucket."""
        bucket = self._infer.bucket_for(rows)
        if bucket is not None:
            return [bucket]
        chunk = self._infer.buckets[-1]
        segments: List[int] = []
        for lo in range(0, rows, chunk):
            n = min(chunk, rows - lo)
            segments.append(self._infer.bucket_for(n) or chunk)
        return segments

    def _dispatch(self, reqs: List[Request],
                  wd: Optional[HeartbeatWatchdog]) -> _Batch:
        hook = _chaos_dispatch_hook
        t_drained = time.perf_counter()
        rows = sum(r.rows for r in reqs)
        segments = self._plan(rows)
        padded = sum(segments)
        region = wd.region("dispatch") if wd is not None \
            else nullcontext()
        with region, events.span("serve.dispatch", requests=len(reqs),
                                 rows=rows, padded=padded,
                                 segments=len(segments)):
            if hook is not None:
                hook()
            t0 = time.perf_counter()
            # coalesce + pad in HOST numpy: the device only ever sees
            # exact bucket shapes, so it replays the warmed graphs and
            # nothing else
            pad_s = 0.0
            xs = []
            for i in range(self._n_inputs):
                parts = [r.xs[i] for r in reqs]
                if padded > rows:
                    tp = time.perf_counter()
                    parts.append(np.zeros(
                        (padded - rows,) + parts[0].shape[1:],
                        dtype=parts[0].dtype))
                    pad_s += time.perf_counter() - tp
                xs.append(parts[0] if len(parts) == 1
                          else np.concatenate(parts))
            t_coalesced = time.perf_counter()
            outs: List[List] = []
            lo = 0
            for seg in segments:
                outs.append(self._infer.output(
                    *[x[lo:lo + seg] for x in xs]))
                lo += seg
            # the copies to host go right behind this batch's replays
            started = start_host_copy(outs)
            t_dispatched = time.perf_counter()
        stages = {"coalesce_s": (t_coalesced - t0) - pad_s,
                  "bucket_pad_s": pad_s,
                  "dispatch_s": t_dispatched - t_coalesced,
                  "t_drained": t_drained, "t_infer": t_coalesced}
        return (reqs, started, t0, rows, padded, stages)

    def _complete(self, batch: _Batch,
                  wd: Optional[HeartbeatWatchdog]) -> None:
        reqs, started, t0, rows, padded, stages = batch
        region = wd.region("readback") if wd is not None \
            else nullcontext()
        t_fence = time.perf_counter()
        with region:
            # the fence IS the materialization: one polled event behind
            # every segment's copies; responses are then sliced in numpy
            host_segs = read_host_copy(started)
        t_fenced = time.perf_counter()
        full = (host_segs[0] if len(host_segs) == 1
                else [np.concatenate([seg[i] for seg in host_segs])
                      for i in range(len(host_segs[0]))])
        now = time.perf_counter()
        lo = 0
        for r in reqs:
            r.outputs = [o[lo:lo + r.rows] for o in full]
            lo += r.rows
            r.t_done = now
            r.done.set()
        self.admission.note_dispatch(rows, now - t0)
        with self._lock:
            self._requests_total += len(reqs)
            self._batches_total += 1
            self._fills.append(rows / padded)
            for r in reqs:
                self._latencies.append((now - r.t_submit) * 1000.0)
            del self._open[:len(reqs)]
            for k in ("coalesce_s", "bucket_pad_s", "dispatch_s"):
                self._stage_s[k] += stages[k]
            self._stage_s["readback_s"] += t_fenced - t_fence
            self._stage_s["fanout_s"] += time.perf_counter() - t_fenced
        # trace stage spans for traced requests — emitted OUTSIDE every
        # lock (the recorder may write), and only when a trace context
        # rode in, so the untraced hot path records nothing extra
        for r in reqs:
            if r.trace is not None:
                self._emit_trace(r, rows, stages, t_fence,
                                 t_fenced - t_fence)

    def _emit_trace(self, r: Request, batch_rows: int, stages: Dict,
                    t_fence: float, readback_s: float) -> None:
        """Cut one traced request's stage spans from the batch's
        timings: queue wait is per-request, the rest are the batch's
        shared stages (continuous batching — the batch IS the unit of
        work, so its stage costs are every member's stage costs)."""
        ctx = r.trace
        base = {"trace": ctx.trace, "parent": ctx.span,
                "rows": r.rows, "batch_rows": batch_rows}
        events.complete("trace.queue_wait",
                        dur=stages["t_drained"] - r.t_submit,
                        t_start=r.t_submit,
                        span=tracing.new_span_id(), **base)
        events.complete("trace.coalesce", dur=stages["coalesce_s"],
                        t_start=stages["t_drained"],
                        span=tracing.new_span_id(), **base)
        events.complete("trace.bucket_pad", dur=stages["bucket_pad_s"],
                        t_start=stages["t_drained"],
                        span=tracing.new_span_id(), **base)
        events.complete("trace.dispatch", dur=stages["dispatch_s"],
                        t_start=stages["t_infer"],
                        span=tracing.new_span_id(), **base)
        events.complete("trace.readback", dur=readback_s,
                        t_start=t_fence,
                        span=tracing.new_span_id(), **base)

    # -- hang recovery ---------------------------------------------------------

    def _on_timeout(self) -> None:
        """The dispatch loop hung past the watchdog deadline: fail every
        in-flight and queued request with the typed error (the
        never-hang contract — a request always gets an answer), re-arm a
        fresh watchdog, keep serving."""
        self._disarm_watchdog()
        err = WatchdogTimeout(
            "serving dispatch hung past the watchdog deadline; "
            "in-flight and queued requests failed")
        with self._lock:
            open_reqs, self._open = self._open, []
            self._timeouts_total += 1
            thread = self._thread
        now = time.perf_counter()
        for r in open_reqs:
            if r.done.is_set():  # answered before the cycle fell over
                continue
            r.error = err
            r.t_done = now
            r.done.set()
        failed_queued = self.admission.fail_all(err)
        events.instant("serve.timeout", failed_inflight=len(open_reqs),
                       failed_queued=len(failed_queued))
        self._arm_watchdog(thread)

    def _on_error(self, exc: Exception) -> None:
        """A dispatch cycle RAISED (malformed coalesced batch that
        bypassed submit validation, a device error) — not a hang, so the
        watchdog stays armed.  Fail every in-flight request with a typed
        ``DispatchError`` and keep serving; queued requests are
        untouched (they dispatch next cycle)."""
        err = DispatchError(
            f"serving dispatch failed: {exc!r} — this batch's "
            "in-flight requests failed with the typed error; the "
            "engine keeps serving")
        err.__cause__ = exc
        with self._lock:
            open_reqs, self._open = self._open, []
            self._errors_total += 1
        now = time.perf_counter()
        for r in open_reqs:
            if r.done.is_set():  # answered before the cycle fell over
                continue
            r.error = err
            r.t_done = now
            r.done.set()
        events.instant("serve.error", error=repr(exc),
                       failed_inflight=len(open_reqs))

    def _disarm_watchdog(self) -> None:
        with self._lock:
            wd, self._watchdog = self._watchdog, None
        if wd is not None:
            wd.stop()  # no further async raises after this returns

    def _arm_watchdog(self,
                      thread: Optional[threading.Thread]) -> None:
        if not self._supervise or thread is None:
            return
        wd = HeartbeatWatchdog(deadline_s=self._wd_deadline_s)
        wd.start(thread=thread)
        with self._lock:
            self._watchdog = wd

    # -- ops surface -----------------------------------------------------------

    def report(self) -> Dict:
        """Scrape feed for ``MetricsRegistry.observe_serve`` (the
        ``gan4j_serve_*`` series and the ``/healthz`` serving block)."""
        adm = self.admission.report()
        with self._lock:
            lats = list(self._latencies)
            fills = list(self._fills)
            requests_total = self._requests_total
            batches_total = self._batches_total
            timeouts_total = self._timeouts_total
            errors_total = self._errors_total
            wd = self._watchdog
        p50, p95, p99 = percentiles(lats, (50.0, 95.0, 99.0))
        stalled = bool(wd is not None and wd.stalled)
        return {
            "requests_total": requests_total,
            "batches_total": batches_total,
            "shed_total": adm["shed_total"],
            "admitted_total": adm["admitted_total"],
            "queue_depth": adm["depth"],
            "batch_fill": (sum(fills) / len(fills)) if fills else 0.0,
            "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
            "timeouts_total": timeouts_total,
            "errors_total": errors_total,
            "rate_rows_per_s": adm["rate_rows_per_s"],
            "stalled": stalled,
            "ok": not stalled,
        }

    def stage_report(self) -> Dict:
        """The host's seconds in each stage of the dispatch cycles served
        so far (coalesce, bucket pad, dispatch — uploads, replays and the
        copies' enqueue —, readback wait, fan-out), with the batch count."""
        with self._lock:
            return {**self._stage_s, "batches": self._batches_total}
