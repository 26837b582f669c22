"""Bucketed inference (torch twin of ``gan_deeplearning4j_tpu/parallel/
inference.py``): the ``ParallelInference`` path of DL4J's parallel-wrapper
module, on one card.

``buckets`` fixes the COMPLETE set of dispatch shapes: every request pads
up to the smallest declared bucket that holds it (oversized inputs chunk
by the largest, the tail padded to ITS covering bucket), so the set of
programs the device runs is closed.  The JAX package makes that a closed
set of compiled programs; here it is one CUDA graph per dispatch shape,
captured at the shape's first dispatch (the serving engine's warm-up
captures every bucket, largest first, so the smaller graphs reuse the
largest one's memory in the pool they share).  ``captures`` counts the
graphs captured: after warm-up it stays at the number of buckets, the
port's stand-in for the JAX ``RecompileSentinel``.

A graph's inputs and outputs are static tensors, and its params are a
snapshot of the graph's params (the BN running mean and var included),
taken once; ``refresh_params`` copies the graph's current params INTO the
snapshot, in place, on the serving stream between dispatches — rebinding
it would leave every graph reading the old tensors.  Each dispatch copies
its outputs out of the static buffers on the same stream right after its
replay, so the next replay of the bucket cannot overwrite what a caller
still holds.  Every upload, replay and copy runs on ONE stream of the
graph's card (``stream``), whichever thread dispatches, a dispatch's
under a lock so that two threads (two engines sharing the inference)
cannot interleave them; a dispatch's results are handed to the caller's
current stream.  Inputs are staged
through fresh pinned buffers, which torch's caching host allocator does
not reuse before their upload has completed.

Inference uses BN running stats and no dropout, so no row affects
another: a row's output does not depend on what else is in its batch.

On the CPU the same class runs the eager forward (no graphs).  The JAX
package shards the batch over a device mesh; a world of more than one
card is not ported (ROADMAP Queue 1 item 10).  A capture that fails
raises: nothing falls back to eager on a card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.utils.device import device_fence

# The canonical serving bucket set (the JAX package's bucket-coverage
# contract); the largest bucket is the chunking unit for oversized
# requests.
DEFAULT_SERVING_BUCKETS = (8, 32, 64)

# eager forwards before each capture: cuDNN times its algorithm choice at a
# shape's first use, which must happen outside the capture
WARMUP_RUNS = 2


class _Captured:
    """One dispatch shape's CUDA graph and its static buffers."""

    __slots__ = ("inputs", "graph", "outputs")

    def __init__(self, inputs, graph, outputs):
        self.inputs, self.graph, self.outputs = inputs, graph, outputs


def _world(mesh) -> int:
    """The number of devices a ``mesh`` argument asks for: None is this
    card; an int, or a data group (``parallel/mesh.py``), its world."""
    if mesh is None:
        return 1
    return int(getattr(mesh, "world", mesh))


class ParallelInference:
    """Bucketed inference for a ``ComputationGraph`` on its device.

    Parameters are snapshotted at construction; call ``refresh_params()``
    after further training (or a checkpoint restore) to copy the graph's
    params into the snapshot."""

    def __init__(self, graph, mesh=None, axis: str = "data",
                 max_batch: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None):
        if _world(mesh) != 1:
            raise NotImplementedError(
                f"inference over {_world(mesh)} devices is not ported yet "
                "(ROADMAP Queue 1 item 10: multi-card ParallelInference)")
        axis_names = ("data",)
        n = 1
        if axis not in axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {axis_names}")
        if max_batch is not None and max_batch < n:
            raise ValueError(
                f"max_batch={max_batch} below the mesh axis size "
                f"{n} — every dispatch needs one row per shard")
        self.graph = graph
        self.axis = axis
        self.max_batch = max_batch
        self.buckets: Optional[tuple] = None
        if buckets is not None:
            bs = tuple(sorted({int(b) for b in buckets}))
            if not bs:
                raise ValueError("buckets must name at least one shape")
            bad = [b for b in bs if b <= 0 or b % n]
            if bad:
                raise ValueError(
                    f"bucket(s) {bad} must be positive multiples of the "
                    f"mesh axis size {n} — every "
                    f"bucket shape must shard evenly")
            if max_batch is not None and max_batch != bs[-1]:
                raise ValueError(
                    f"max_batch={max_batch} must equal the largest "
                    f"bucket {bs[-1]} when both are given — the largest "
                    f"bucket IS the chunking unit")
            self.buckets = bs
        self._n = n
        self.device: torch.device = graph.device
        self.stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[tuple, _Captured] = {}
        # a dispatch's uploads, replay and copies must lie back to back
        # on the stream: two threads interleaving them would swap each
        # other's rows in the static buffers
        self._lock = threading.Lock()
        # the graphs captured, each one's capture seconds by dispatch
        # rows, and the device memory the shared pool took
        self.captures = 0
        self.capture_seconds: Dict[int, float] = {}
        self.pool_bytes = 0
        self._params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.refresh_params()

    # -- the snapshot ------------------------------------------------------

    def on_stream(self):
        """Context making this card and the serving stream current (a
        no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The snapshot every dispatch reads (never rebind its tensors)."""
        return self._params

    def refresh_params(self, ready: Optional[torch.cuda.Event] = None
                       ) -> None:
        """Copy the graph's current params into the snapshot, in place and
        on the serving stream, after ``ready`` (an event recorded behind
        the work that wrote them, e.g. a restore's uploads on another
        thread's stream; default: the work already enqueued on the
        caller's stream).  The first call takes the snapshot.  The params
        must keep their names and shapes."""
        src = self.graph.params
        if self.stream is not None:
            if ready is not None:
                self.stream.wait_event(ready)
            else:
                self.stream.wait_stream(
                    torch.cuda.current_stream(self.device))
        with self._lock, self.on_stream():
            if self._params is None:
                self._params = {
                    layer: {n: t.detach().clone() for n, t in lp.items()}
                    for layer, lp in src.items()}
                return
            if set(src) != set(self._params):
                raise ValueError(
                    f"refresh_params: layers {sorted(src)} != the "
                    f"snapshot's {sorted(self._params)}")
            dst, new = [], []
            for layer, lp in self._params.items():
                if set(src[layer]) != set(lp):
                    raise ValueError(
                        f"refresh_params: layer {layer!r} has params "
                        f"{sorted(src[layer])}, the snapshot {sorted(lp)}")
                for n, t in lp.items():
                    if src[layer][n].shape != t.shape:
                        raise ValueError(
                            f"refresh_params: {layer}.{n} is "
                            f"{tuple(src[layer][n].shape)}, the snapshot "
                            f"{tuple(t.shape)}")
                    dst.append(t)
                    new.append(src[layer][n].detach())
            torch._foreach_copy_(dst, new)
            if self.stream is not None:
                # the sources may be freed on the caller's side while the
                # copies are still queued here
                for t in new:
                    t.record_stream(self.stream)

    # -- the dispatch ------------------------------------------------------

    def _forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        with torch.no_grad():
            values, _ = self.graph._forward(
                self._params, dict(zip(self.graph.input_names, xs)), False)
        return [values[n] for n in self.graph.output_names]

    def _capture(self, rows: int, like: Sequence[torch.Tensor]) -> _Captured:
        """Capture the forward at ``rows`` rows (inputs shaped and typed
        as ``like`` past the batch axis) into a graph of the shared pool,
        after WARMUP_RUNS eager forwards on the same static inputs."""
        t0 = time.perf_counter()
        before = torch.cuda.memory_allocated(self.device)
        with self.on_stream():
            inputs = [torch.zeros((rows,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=self.device)
                      for x in like]
            for _ in range(WARMUP_RUNS):
                self._forward(inputs)
            device_fence(inputs, stream=self.stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = self._forward(inputs)
        self.captures += 1
        self.capture_seconds[rows] = time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_allocated(self.device) - before
        return _Captured(inputs, graph, outputs)

    def _stage(self, x) -> torch.Tensor:
        """A request input as a tensor the upload can read: a card tensor
        as it is, host data through a fresh pinned buffer."""
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            return x
        host = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x)
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned

    def _dispatch(self, xs, pad_to: Optional[int] = None
                  ) -> List[torch.Tensor]:
        """One forward.  ``pad_to`` fixes the dispatch shape (zero rows
        appended); otherwise pad to the next mesh-axis multiple."""
        b = xs[0].shape[0]
        pad = (pad_to - b) if pad_to is not None else (-b) % self._n
        if self.stream is None:
            placed = []
            for x in xs:
                x = torch.as_tensor(x, device=self.device)
                if pad:
                    x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                placed.append(x)
            outs = self._forward(placed)
            return [o[:b] for o in outs] if pad else outs
        caller = torch.cuda.current_stream(self.device)
        staged = [self._stage(x) for x in xs]
        key = tuple((b + pad, tuple(x.shape[1:]), x.dtype) for x in staged)
        with self._lock, self.on_stream():
            self.stream.wait_stream(caller)
            cap = self._graphs.get(key)
            if cap is None:
                cap = self._graphs[key] = self._capture(b + pad, staged)
            for static, x in zip(cap.inputs, staged):
                static[:b].copy_(x, non_blocking=True)
                if pad:
                    static[b:].zero_()
            cap.graph.replay()
            outs = [o[:b].clone() for o in cap.outputs]
        if caller != self.stream:
            caller.wait_stream(self.stream)
            for o in outs:
                o.record_stream(caller)
        return outs

    def bucket_for(self, b: int) -> Optional[int]:
        """The smallest declared bucket holding a ``b``-row request;
        None when ``b`` exceeds the largest (the chunked path) or no
        buckets are declared."""
        if self.buckets is None:
            return None
        for k in self.buckets:
            if k >= b:
                return k
        return None

    def output(self, *xs) -> List[torch.Tensor]:
        """Inference forward — the counterpart of
        ``ComputationGraph.output`` (one tensor per output layer, on the
        graph's device).  ``xs``: numpy arrays or tensors, one per graph
        input.  With ``buckets`` declared, every dispatch shape is a
        bucket: requests pad up to the smallest bucket that holds them,
        oversized requests chunk by the largest with the tail padded to
        ITS covering bucket — the set of graphs stays closed."""
        if not xs:
            raise ValueError("output() needs at least one input array")
        b = xs[0].shape[0]
        if self.buckets is not None:
            bucket = self.bucket_for(b)
            if bucket is not None:
                return self._dispatch(xs, pad_to=bucket)
            chunk = self.buckets[-1]
        elif self.max_batch is None or b <= self.max_batch:
            return self._dispatch(xs)
        else:
            chunk = self.max_batch
        chunks = []
        for lo in range(0, b, chunk):
            part = [x[lo:lo + chunk] for x in xs]
            pad_to = chunk
            if self.buckets is not None:
                # the tail chunk pads to its COVERING bucket, not the
                # chunking unit: a 70-row request dispatches as 64 + 8
                pad_to = self.bucket_for(part[0].shape[0]) or chunk
            chunks.append(self._dispatch(part, pad_to=pad_to))
        return [torch.cat(parts) for parts in zip(*chunks)]

    __call__ = output


__all__ = ["DEFAULT_SERVING_BUCKETS", "ParallelInference", "WARMUP_RUNS"]
