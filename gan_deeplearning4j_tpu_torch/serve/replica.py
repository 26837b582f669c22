"""One serving replica as a standalone PROCESS (torch twin of
``gan_deeplearning4j_tpu/serve/replica.py``).

``python -m gan_deeplearning4j_tpu_torch.serve.replica --port N
[--checkpoint DIR] [--events PATH] [--device cpu] [--fleet
[--fleet-tenants N]]`` builds the single-host
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

``--fleet [--fleet-tenants N]`` serves a multi-tenant insurance fleet
instead (``build_fleet_replica``): a ``FleetTenantBank`` over the fleet
checkpoint in ``--checkpoint`` (or a fresh N-tenant fleet while it holds
none) behind ``/v1/tenants/{id}/generate``; tenant 0's engine doubles as
the plain ``/v1/generate`` replica, so the control plane's zero-latent
canary probes run real fleet weights, and ``/admin/hotswap`` pushes each
live tenant's slice of a newer fleet checkpoint in place.
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


def _replica_gateway(router, engine, hotswap, extra_report=None, *,
                     host: str, port: int, max_rows: int,
                     read_timeout_s: float, result_timeout_s: float):
    """-> (gateway, wedge): the replica's gateway over ``router``, not
    started.  ``/healthz`` carries ``engine``'s report (with
    ``extra_report()``'s keys), unhealthy while wedged;
    ``/admin/hotswap`` calls ``hotswap(directory, params, step,
    max_step)`` -> the step now served; ``/admin/chaos/wedge``."""
    wedge = WedgeState()

    def serve_report():
        rep = engine.report()
        rep["wedged"] = wedge.wedged()
        if extra_report is not None:
            rep.update(extra_report())
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
        return {"step": hotswap(
            str(directory), params, None if step is None else int(step),
            None if max_step is None else int(max_step))}

    def admin_wedge(params):
        seconds = float(params.get("seconds", 5.0))
        wedge.wedge(seconds)
        return {"wedged_s": seconds}

    gateway = Gateway(
        router, host=host, port=port, max_rows=max_rows,
        read_timeout_s=read_timeout_s,
        result_timeout_s=result_timeout_s,
        serve_report=serve_report,
        admin={"hotswap": admin_hotswap, "chaos/wedge": admin_wedge})
    return gateway, wedge


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
    gateway, wedge = _replica_gateway(
        Router([engine]), engine,
        lambda d, params, step, max_step: engine.hotswap_from(
            d, name=str(params.get("name", "gen")), step=step,
            max_step=max_step),
        host=host, port=port, max_rows=max_rows,
        read_timeout_s=read_timeout_s, result_timeout_s=result_timeout_s)
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


def build_fleet_replica(*, port: int = 0, host: str = "127.0.0.1",
                        checkpoint=None, tenants: int = 4,
                        buckets=DEFAULT_SERVING_BUCKETS,
                        max_rows: int = 4096,
                        read_timeout_s: float = 5.0,
                        result_timeout_s: float = 60.0, device=None):
    """Build (engine, gateway, wedge, bank): the FLEET serving stack, a
    ``FleetTenantBank`` over the insurance generators with
    ``/v1/tenants/{id}/generate`` routing, behind the same process
    contract as :func:`build_replica`.  ``device``: None = the card.

    Tenant 0's engine doubles as the plain ``/v1/generate`` replica, so
    the control plane's model-agnostic canary probes (zero-latent rows,
    the insurance ``z_size`` wide) exercise real fleet weights: a poisoned
    tenant-0 slice fails the canary, not just the publisher's file probe.
    ``max_live`` is pinned above the tenant count so the probe engine is
    never LRU-evicted.

    ``checkpoint``: a fleet checkpoint directory, restored when it holds a
    verified fleet checkpoint; otherwise (empty, first boot before the
    trainer's first save, or not a fleet directory) the bank serves a
    freshly initialized ``tenants``-wide fleet, as the single-model
    replica serves its fresh init."""
    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as IM
    from gan_deeplearning4j_tpu_torch.serve.router import FleetTenantBank
    from gan_deeplearning4j_tpu_torch.train import fused_step as fused_lib
    from gan_deeplearning4j_tpu_torch.train.fleet import (
        FleetCheckpointer,
        replicate_state,
    )

    cfg = IM.InsuranceConfig()

    def build_graph():
        return IM.build_generator(cfg, device=device)

    max_live = max(int(tenants), 4) + 1
    bank = None
    if checkpoint:
        # read-side handle: the trainer owns the checkpoint directory
        ck = FleetCheckpointer(str(checkpoint), sweep_debris=False)
        if ck.latest_verified_step() is not None:
            candidate = FleetTenantBank(
                build_graph, checkpointer=ck, buckets=tuple(buckets),
                max_live=max_live)
            try:
                candidate.num_tenants()  # the restore, now
                bank = candidate
            except (FileNotFoundError, ValueError) as e:
                print(f"replica: cannot serve a fleet from {checkpoint!r} "
                      f"({e}); serving fresh initialization",
                      file=sys.stderr, flush=True)
    if bank is None:
        dis = IM.build_discriminator(cfg, device="cpu")
        graphs = (dis, IM.build_generator(cfg, device="cpu"),
                  IM.build_gan(cfg, device="cpu"),
                  IM.build_classifier(dis, cfg))
        state = replicate_state(fused_lib.state_from_graphs(*graphs),
                                int(tenants))
        bank = FleetTenantBank(build_graph, state=state,
                               buckets=tuple(buckets), max_live=max_live)
    engine = bank.engine(0)  # built, warmed, started
    gateway, wedge = _replica_gateway(
        Router([engine], tenants=bank), engine,
        lambda d, params, step, max_step: bank.hotswap_from(
            d, step=step, max_step=max_step),
        lambda: {"tenants": bank.num_tenants(),
                 "tenants_live": bank.live_count()},
        host=host, port=port, max_rows=max_rows,
        read_timeout_s=read_timeout_s, result_timeout_s=result_timeout_s)
    gateway.start()
    return engine, gateway, wedge, bank


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
                   help="serve a multi-tenant FLEET (insurance generators + "
                        "/v1/tenants/{id}/generate) instead of the single "
                        "dcgan generator")
    p.add_argument("--fleet-tenants", type=int, default=4,
                   help="fresh-init fleet width when --checkpoint holds no "
                        "verified fleet checkpoint yet")
    args = p.parse_args(argv)
    if args.events:
        events.install(events.EventRecorder(path=args.events))

    bank = None
    if args.fleet:
        engine, gateway, _wedge, bank = build_fleet_replica(
            port=args.port, host=args.host, checkpoint=args.checkpoint,
            tenants=args.fleet_tenants, buckets=_parse_buckets(args.buckets),
            result_timeout_s=args.result_timeout_s, device=args.device)
    else:
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
    if bank is not None:
        bank.stop()  # every live tenant engine, the probe one included
    else:
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
