"""One serving replica as a standalone PROCESS (torch twin of
``gan_deeplearning4j_tpu/serve/replica.py``).

``python -m gan_deeplearning4j_tpu_torch.serve.replica --port N
[--checkpoint DIR] [--events PATH] [--device cpu]`` builds the single-host
serving stack — the DCGAN-MNIST generator at full width →
``ParallelInference`` (one CUDA graph per bucket) → ``ServeEngine`` →
``Router`` → ``Gateway`` — on the card (``--device cpu`` is the only way
onto the CPU) and runs it until SIGTERM/SIGINT.  It serves the
reference's f32 parity numerics: like the JAX replica it takes no
``--bf16`` / ``--mp``.

The process contract (what spawners and probes rely on):

* **ready line** — after the gateway is listening, EXACTLY one JSON
  line goes to stdout: ``{"event": "replica_ready", "host": ...,
  "port": P, "pid": ...}`` (then a flush).  ``--port 0`` binds an
  ephemeral port, so the spawner learns the real one from this line.
* **health** — ``GET /healthz`` answers 200 only while BOTH the gateway
  and the engine report ok (the gateway's ``serve_report`` hook); a
  wedged engine answers 503 while still accepting connections.
* **admin verbs** — ``POST /admin/hotswap`` (``{"directory": ...,
  ["step"], ["max_step"]}`` → ``{"step": N}``) and
  ``POST /admin/chaos/wedge`` (``{"seconds": S}`` — report unhealthy for
  S seconds while still listening).
* **shutdown** — SIGTERM/SIGINT drains: gateway stops taking
  connections, the engine fails open requests typed, exit code 0.
* **events** — ``--events PATH`` writes this process's events timeline
  (``replica.ready``, the gateway's and engine's ``serve.*`` /
  ``gateway.*`` instants, the ``trace.*`` spans of traced requests,
  ``replica.stopped`` with the port kernels' launch counts) and flushes
  its tail on SIGTERM: the per-process file that
  ``telemetry.tracing.merge_trace_files`` joins with the others.

A ``--checkpoint`` directory (a checkpoint holding a ``gen`` graph, in the
JAX package's on-disk format) is restored via ``hotswap_from`` BEFORE the
ready line (newest verified checkpoint, corrupt ones skipped); an
empty/unverifiable directory serves the fresh initialization instead of
refusing to boot.

Not ported: ``--fleet`` (the tenant bank needs the fleet trainer, ROADMAP
Queue 1 item 9); it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np

from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.parallel.inference import (
    DEFAULT_SERVING_BUCKETS,
    ParallelInference,
)
from gan_deeplearning4j_tpu_torch.serve.engine import ServeEngine
from gan_deeplearning4j_tpu_torch.serve.gateway import Gateway
from gan_deeplearning4j_tpu_torch.serve.router import Router
from gan_deeplearning4j_tpu_torch.telemetry import events


class WedgeState:
    """A chaos latch: ``wedge(seconds)`` makes ``wedged()`` true until
    the deadline passes.  Pure bookkeeping under its lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._until = 0.0

    def wedge(self, seconds: float) -> None:
        if seconds <= 0:
            raise ValueError("wedge seconds must be > 0")
        with self._lock:
            self._until = time.monotonic() + float(seconds)

    def wedged(self) -> bool:
        with self._lock:
            return time.monotonic() < self._until


def _parse_buckets(text: str):
    try:
        buckets = tuple(int(b) for b in text.split(",") if b.strip())
    except ValueError:
        raise ValueError(f"bad --buckets {text!r} (want e.g. '8,32')") \
            from None
    if not buckets or any(b <= 0 for b in buckets):
        raise ValueError(f"bad --buckets {text!r} (want positive ints)")
    return buckets


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def build_replica(*, port: int = 0, host: str = "127.0.0.1",
                  checkpoint=None, buckets=DEFAULT_SERVING_BUCKETS,
                  max_rows: int = 4096, read_timeout_s: float = 5.0,
                  result_timeout_s: float = 60.0, device=None):
    """Build (engine, gateway, wedge) — the replica stack minus the
    process scaffolding, so tests can run one in-process too.
    ``device``: None = the card."""
    graph = M.build_generator(device=device)
    infer = ParallelInference(graph, buckets=tuple(buckets))
    engine = ServeEngine(infer=infer)
    wedge = WedgeState()

    def serve_report():
        rep = engine.report()
        rep["wedged"] = wedge.wedged()
        if rep["wedged"]:
            # stalled-but-listening: the report says unhealthy while
            # the socket keeps accepting — the probe must see a 503,
            # not a refused connection
            rep["ok"] = False
            rep["stalled"] = True
        return rep

    def admin_hotswap(params):
        directory = params.get("directory")
        if not directory:
            raise ValueError(
                'hotswap needs {"directory": "<checkpoint dir>"}')
        step = params.get("step")
        max_step = params.get("max_step")
        got = engine.hotswap_from(
            str(directory), name=str(params.get("name", "gen")),
            step=None if step is None else int(step),
            max_step=None if max_step is None else int(max_step))
        return {"step": got}

    def admin_wedge(params):
        seconds = float(params.get("seconds", 5.0))
        wedge.wedge(seconds)
        return {"wedged_s": seconds}

    gateway = Gateway(
        Router([engine]), host=host, port=port, max_rows=max_rows,
        read_timeout_s=read_timeout_s,
        result_timeout_s=result_timeout_s,
        serve_report=serve_report,
        admin={"hotswap": admin_hotswap, "chaos/wedge": admin_wedge})
    # capture every bucket before the dispatch thread starts
    engine.warmup(np.zeros((1, graph.input_specs[
        graph.input_names[0]].shape[-1]), np.float32))
    engine.start()
    if checkpoint:
        try:
            engine.hotswap_from(str(checkpoint))
        except FileNotFoundError as e:
            # incl. NoVerifiedCheckpointError: serve the fresh init — a
            # spawner may start replicas before the first deploy exists
            print(f"replica: no verified checkpoint in {checkpoint!r} "
                  f"({e}); serving fresh initialization",
                  file=sys.stderr, flush=True)
    gateway.start()
    return engine, gateway, wedge


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gan_deeplearning4j_tpu_torch.serve.replica",
        description="run one serving replica (gateway + engine) as a "
                    "standalone process, on the card")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (0 = ephemeral; read the ready "
                        "line for the real one)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory to hotswap from before "
                        "taking traffic")
    p.add_argument("--buckets", default=",".join(
        str(b) for b in DEFAULT_SERVING_BUCKETS))
    p.add_argument("--result-timeout-s", type=float, default=60.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain eager forward on the CPU)")
    p.add_argument("--events", default=None,
                   help="write this process's events timeline to PATH "
                        "(jsonl)")
    p.add_argument("--fleet", action="store_true",
                   help="serve a multi-tenant fleet (not ported: item 9)")
    args = p.parse_args(argv)
    if args.fleet:
        raise _not_ported("--fleet (FleetTenantBank over train/fleet.py)",
                          "9")
    if args.events:
        events.install(events.EventRecorder(path=args.events))

    engine, gateway, _wedge = build_replica(
        port=args.port, host=args.host, checkpoint=args.checkpoint,
        buckets=_parse_buckets(args.buckets),
        result_timeout_s=args.result_timeout_s, device=args.device)

    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        stop_evt.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    print(json.dumps({"event": "replica_ready", "host": args.host,
                      "port": gateway.port, "pid": os.getpid()}),
          flush=True)
    events.instant("replica.ready", port=gateway.port, pid=os.getpid())

    while not stop_evt.wait(0.5):
        pass

    gateway.stop()
    engine.stop()
    # the serving path launches none of the port's kernels: the counts
    # say so for this process's whole life
    events.instant("replica.stopped", pid=os.getpid(),
                   port_launches=kernels.launch_counts())
    # flush the events file's buffered tail: with fewer events than the
    # recorder's flush_every, NOTHING would reach the disk otherwise
    events.current().close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
