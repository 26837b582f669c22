"""The three-graph GAN training protocol as an engine (torch twin of
``gan_deeplearning4j_tpu/train/gan_trainer.py``), on one device or one rank
of a data-parallel group.

Per iteration: a D-step on [real; G(z1)] (targets 1 + soften_real and
soften_fake, the softening drawn once per run), the dis -> gan sync, a
G-step on z2, the gan -> gen sync, and the dis -> classifier sync with a
classifier step on the labeled batch.  Then the cadences: every
``print_every`` steps the latent-grid synthesis CSV, every ``save_every``
the test-set prediction CSV; at the end the four model zips.

The training table comes from a ``RecordReaderDataSetIterator`` (the CSV
files the CV program writes, or an array source; without one, the decoded
``mnist_train.csv`` contract table of ``n_train`` rows, made in memory).
It is decoded before anything is captured, and lives on the device in one
of three tiers, as in the JAX trainer (``_resident_data_ok``):
  - resident f32 when it fits ``data_on_device_max_bytes``;
  - resident uint8 codes (``data_codec="u8x100"``, decoded bitwise after
    slicing) when only the codes fit and the table is lossless 2-decimal
    fixed point;
  - streamed otherwise: each call's K*B rows are staged by
    ``ChunkPrefetchIterator`` on a side stream while the previous call
    trains, and copied into the static chunk buffer the step reads
    (``_chunked_stream_loop``; the step slices ``it % K`` of it, so K must
    divide every cadence, as ``resolve_steps_per_call`` makes it);
  - streamed with the dedup tier (``stream_dedup``, the JAX trainer's
    adaptive decision): when one chunk of K steps covers at least a full
    pass of the iterator and the distinct-row table fits
    ``stream_chunk_bytes``, the table crosses the link once (u8 codes
    under the codec, decoded once into the static f32 table the step
    reads) and each call ships only its [K*B] row-index schedule into a
    static index buffer; the step gathers through it (``fused_step``
    ``chunk_indexed``).
Two loops, as in the JAX trainer:
  - fused (the default, ``dp_mode="gradient_sync"``): the protocol step of
    ``fused_step``, K steps per call, with the generator EMA when
    ``ema_decay`` > 0.  On one card the step runs as a replayed CUDA graph,
    captured here at construction; on the CPU and under a group it runs
    eagerly.
  - unfused (``fused=False``, or ``dp_mode="param_averaging"``): the
    reference's per-fit loop on the resident f32 table, through
    ``DataParallelGraph`` under a group.
Every call ends in one readback of its losses.  The dumps at a cadence
boundary read a snapshot of the state taken on the compute stream before
the next call (a replay overwrites the graph's static state), and their
device work and copy to pinned host memory are enqueued on the training
thread; ``AsyncArtifactWriter``'s worker waits for the copy and writes the
CSV.  Under a group only rank 0 dumps, logs metrics and saves.

Supervision (the JAX trainer's, in its checkpoint format):
  - every ``checkpoint_every`` steps a checkpoint of the four graphs, the
    label softening, the data position (``iter_state``), the generator EMA
    and the latent generator's state (``z_gen_state``, the port's own key:
    its latents come from a sequential generator, where the JAX package's
    are counter-based) through ``checkpoint/`` (``async_checkpoint``: the
    serialization on a worker).  The snapshot reads the state through
    pinned host copies behind one event at the call boundary, before the
    next replay overwrites the graph's static buffers.  Only rank 0 writes;
    every rank waits on a barrier behind the save;
  - ``resume``: the newest verified checkpoint is restored in the
    constructor, before the step is captured, so the restored params, the
    step counter, the EMA and the generator's state go into the graph; a
    checkpoint without ``z_gen_state`` (one the JAX package wrote) puts the
    generator at its step by replaying its draws;
  - ``preempt_signals``: a signal latches a flag polled at each call
    boundary (the ranks agree on it); the trainer then takes an emergency
    checkpoint, writes ``PREEMPTED.json`` and raises ``PreemptionError``;
  - the data plane: retries on transient read errors (``data_retries``)
    and a corrupt-record quarantine (``max_quarantine``);
  - ``train_with_recovery`` / ``run_with_recovery``: restart after a
    retryable failure from the newest checkpoint; a data-parallel world
    restarts as a whole (``spawn_with_recovery``: one failed rank
    re-spawns every rank).
Supervision's numerics and hang half (the JAX trainer's fields and
actions):
  - ``telemetry``: the step's in-graph numerics block (gradient and param
    norms, update ratios, a NaN/Inf count; ``telemetry/ingraph.py``) rides
    the step, the CUDA graph and its one readback, and lands in the
    metrics records as extra columns;
  - ``nan_alarm`` (warn / snapshot / abort / rollback) and ``divergence``
    (the windowed sentinel, ``train/divergence.py``) watch the records the
    metrics logger flushes and are polled at every call boundary, before
    that boundary's dumps and checkpoint; ``rollback`` restores the newest
    checkpoint before the bad step in a new incarnation, with a cut
    learning rate and a reseeded latent stream (``train/rollback.py``;
    ``run_with_recovery`` owns the one ``RollbackManager``);
  - ``watchdog``: a heartbeat at every call boundary and around every
    blocking region (the readback, chunk staging, dumps, checkpoints, all
    polled waits), so a hang becomes a retryable ``WatchdogTimeout``;
  - ``events``: the run's ``events.jsonl`` and flight recorder
    (``telemetry/events.py``), installed with the guard and the watchdog by
    ``train/shell.py`` around the loops.
Under a group only rank 0 logs metrics, so only rank 0 observes; the
alarms' outcome is agreed at every boundary so that every rank acts at
the same step.  A rollback under a group heals in place, on every rank at
once: each rank's ``run_with_recovery`` keeps a ``RollbackManager``
charged in lockstep (agreed after each charge), and rebuilds its trainer
over the same live group from the checkpoint rank 0 wrote.
Observability (the JAX trainer's):
  - goodput: a ``GoodputTimer`` (``telemetry/goodput.py``) from the start
    of the constructor, whose data set-up, restore and capture are this
    port's part of a run, attributes the wall time to ``data_wait`` /
    ``dispatch`` / ``readback`` / ``checkpoint`` / ``eval`` (``_phase``,
    which is also the watchdog's region); ``train()`` writes
    ``run_manifest.json`` (rank 0), and its result and the last metrics
    record carry ``run_id`` and ``goodput`` (under a group the ranks'
    mean);
  - ``metrics_port``: rank 0 serves ``/metrics`` + ``/healthz`` over the
    trainer's ``MetricsRegistry`` (``telemetry/exporter.py``: every
    flushed record, the goodput ledger, the watchdog, the data plane, the
    group's size and a ``ResourceMonitor``) while ``train()`` runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import random
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptError,
    NoVerifiedCheckpointError,
    TrainCheckpointer,
)
from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import mesh_spec_dict
from gan_deeplearning4j_tpu_torch.data import codec as codec_lib
from gan_deeplearning4j_tpu_torch.data import datasets
from gan_deeplearning4j_tpu_torch.data.csv import (
    CSVRecordReader,
    RecordReaderDataSetIterator,
    write_csv_matrix,
)
from gan_deeplearning4j_tpu_torch.data.prefetch import ChunkPrefetchIterator
from gan_deeplearning4j_tpu_torch.data.resilient import (
    QUARANTINE_NAME,
    DataHealth,
    DataQuarantineError,
    RecordQuarantine,
    RetryingReader,
    RetryingSource,
    ValidatingSource,
)
from gan_deeplearning4j_tpu_torch.graph import serialization
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
from gan_deeplearning4j_tpu_torch.parallel import elastic as elastic_lib
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.parallel.data_parallel import DataParallelGraph
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.telemetry.exporter import MetricsRegistry
from gan_deeplearning4j_tpu_torch.telemetry.goodput import (
    GoodputTimer,
    write_run_manifest,
)
from gan_deeplearning4j_tpu_torch.telemetry.ingraph import NanAlarm, NanAlarmError
from gan_deeplearning4j_tpu_torch.telemetry.resources import ResourceMonitor
from gan_deeplearning4j_tpu_torch.train import fused_step
from gan_deeplearning4j_tpu_torch.train.divergence import (
    DivergenceError,
    DivergenceSentinel,
)
from gan_deeplearning4j_tpu_torch.train.preemption import (
    MARKER_NAME,
    PreemptionError,
    PreemptionGuard,
    parse_signals,
    preempt_exit,
)
from gan_deeplearning4j_tpu_torch.train.rollback import (
    RollbackError,
    RollbackManager,
    RollbackRequested,
    perturb_z_gen,
)
from gan_deeplearning4j_tpu_torch.train.shell import SupervisionShell
from gan_deeplearning4j_tpu_torch.train.watchdog import HeartbeatWatchdog
from gan_deeplearning4j_tpu_torch.utils import device as device_lib
from gan_deeplearning4j_tpu_torch.utils.async_dump import (
    AsyncArtifactWriter,
    host_copy,
)
from gan_deeplearning4j_tpu_torch.utils.live_ui import serve_for_config
from gan_deeplearning4j_tpu_torch.utils.metrics import MetricsLogger
from gan_deeplearning4j_tpu_torch.utils.profiling import (
    maybe_trace,
    rank_trace_dir,
)

log_ = logging.getLogger(__name__)

# fault-injection seam (``testing/chaos.py`` ``shrink_world`` /
# ``lost_device``): called with the step count at every call boundary,
# before the boundary's own bookkeeping; a raise simulates losing part of
# the devices mid-run (the process fails retryably, and the next
# incarnation forms its world over the survivors).  The checkpointer's
# ``_chaos_hook`` discipline.
_chaos_step_hook: Optional[Callable[[int], None]] = None

DP_MODES = ("gradient_sync", "param_averaging")
NAN_ALARM_ACTIONS = (None, "warn", "snapshot", "abort", "rollback")
# the dedup tier's byte cap (the JAX trainer's): the streamed path's K
# alignment with the resume step, without a byte bound — only the index
# schedule crosses per chunk
UNCAPPED_STREAM = 1 << 62


@dataclasses.dataclass
class GANTrainerConfig:
    """The ported fields of the JAX trainer's config (same names and
    defaults).  A cadence of 0 is off (the JAX trainer requires them
    positive).  ``seed`` seeds the training streams (label softening,
    latents); the graphs take theirs from the model config."""

    dataset_name: str
    num_features: int
    label_index: int
    num_classes: int            # classifier label width (10 CV, 1 insurance)
    batch_size: int             # batchSizePerWorker
    batch_size_pred: int        # batchSizePred
    num_iterations: int
    num_gen_samples: int        # latent grid edge -> n^2 samples
    z_size: int = 2
    print_every: int = 100
    save_every: int = 100
    seed: int = prng.NUMBER_OF_THE_BEAST
    res_path: Optional[str] = "outputs"  # None: no files at all
    # elastic world formation (parallel/elastic.py): when the requested
    # world exceeds what this incarnation attaches (a world that lost a
    # device), ``resolve_n_devices`` re-forms it over the largest batch
    # divisor the survivors carry, loudly, and the checkpoint reshards
    # onto it; False = demand the requested world
    elastic: bool = True
    dp_mode: str = "gradient_sync"
    averaging_frequency: int = 1
    fused: bool = True
    # None = auto: resident when the table fits data_on_device_max_bytes
    data_on_device: Optional[bool] = None
    data_on_device_max_bytes: int = 2 << 30
    steps_per_call: Optional[int] = None  # the cap on K (None = 100)
    # streaming: the byte budget of one chunk (bounds K); 0 = K 1
    stream_chunk_bytes: int = 256 << 20
    # the epoch-in-chunk dedup tier: None = auto (a chunk covers a full
    # pass of the deterministic iterator and the distinct-row table fits
    # stream_chunk_bytes); False = never (nondeterministic iterators)
    stream_dedup: Optional[bool] = None
    use_data_codec: bool = True
    metrics: bool = True
    ema_decay: float = 0.0
    async_dumps: bool = True
    # -- supervision (the JAX trainer's fields, names and defaults) --
    checkpoint_every: int = 0         # 0 = end-of-run models only
    checkpoint_keep: int = 3
    resume: bool = False
    # serialize/fsync on a background worker; the same bytes
    async_checkpoint: bool = False
    # comma-separated signal names ("SIGTERM,SIGUSR1") that arm the
    # preemption path; None = signals keep their inherited behavior
    preempt_signals: Optional[str] = None
    # bounded retries on transient data-source I/O errors (0 = none)
    data_retries: int = 3
    data_retry_backoff_s: float = 0.1
    # corrupt-record budget (0 = strict: the first bad record raises)
    max_quarantine: int = 0
    # -- numerics and hangs (the JAX trainer's fields, names and defaults) --
    # the in-graph numerics block as metrics columns (fused step only)
    telemetry: bool = False
    # the first non-finite step's action (needs telemetry): None, "warn",
    # "snapshot" (a forensic checkpoint in res_path/nan_snapshot), "abort"
    # (NanAlarmError, fatal for the recovery wrapper) or "rollback"
    # (restore before the bad step, cut the LR, reseed the latents; needs a
    # RollbackManager shared across incarnations)
    nan_alarm: Optional[str] = None
    # the windowed divergence sentinel (needs telemetry); its action is
    # nan_alarm's (warn when None)
    divergence: bool = False
    divergence_window: int = 64       # rolling median window (records)
    divergence_factor: float = 20.0   # |value| > factor * median = outlier
    divergence_patience: int = 3      # consecutive outliers to trip
    max_rollbacks: int = 3            # progress-aware budget, then fatal
    rollback_lr_factor: float = 0.5   # LR multiplier per rollback
    # the hang watchdog: a missed heartbeat raises WatchdogTimeout on the
    # training thread (retryable); None = the deadline scales with the
    # measured interval between beats (warm-up allowance first)
    watchdog: bool = False
    watchdog_deadline_s: Optional[float] = None
    watchdog_warmup_s: float = 300.0
    watchdog_scale: float = 20.0
    watchdog_min_deadline_s: float = 5.0
    # res_path/events.jsonl and the flight recorder (False: neither)
    events: bool = True
    # serve /metrics + /healthz (telemetry/exporter.py) for the duration
    # of train(); None = off, 0 = an ephemeral port (rank 0 serves)
    metrics_port: Optional[int] = None


class Workload:
    """What a model family supplies (``cv_main.CVWorkload``,
    ``insurance_main.InsuranceWorkload``)."""

    name: str
    classifier_model_name: str  # "CV" / "insurance" in the final zip names
    # weight-sync maps: lists of (dst_layer, src_layer, param_names)
    dis_to_gan: list
    gan_to_gen: list
    dis_to_classifier: list

    def build_graphs(self, device) -> Dict[str, object]:
        raise NotImplementedError

    def ensure_data(self, res_path: str):
        """Return (train_csv, test_csv)."""
        raise NotImplementedError

    def grid_extra_arrays(self, trainer: "GANTrainer", grid_out: torch.Tensor,
                          step: int) -> List:
        """Further files of a grid dump, as ``[(path, tensor)]`` (the
        insurance program's classifier predictions over the generated
        lattices).  Called on the training thread, where any device work
        is enqueued; the tensors are copied to the host and written with
        the grid, by the same writer."""
        return []


def latent_grid(n: int, z_size: int) -> np.ndarray:
    """The cartesian product of linspace(-1, 1, n) per latent dim, first
    dim outermost — the reference's synthesis grid (n^z_size rows)."""
    axis = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    return np.stack(np.meshgrid(*([axis] * z_size), indexing="ij"),
                    axis=-1).reshape(-1, z_size)


def _largest_batch_divisor(batch_size: int, limit: int) -> int:
    """Largest world <= limit whose shares of ``batch_size`` are equal."""
    return max(d for d in range(1, limit + 1) if batch_size % d == 0)


def resolve_n_devices(n_devices: Optional[int], batch_size: int,
                      device=None, elastic: bool = True) -> int:
    """The data-parallel world for ``n_devices``: None = every attached
    card (one rank on the CPU), reduced with a warning to the largest
    divisor of the batch; an explicit count must divide the batch.  A
    count above the attached cards (``parallel/elastic.attached_devices``;
    the CPU has no limit) re-forms, with ``elastic``, over the largest
    batch divisor that fits, loudly (the global batch is held; each rank's
    share grows), and raises without it.  The divisibility check comes
    first: a count that never divides the batch raises on every host."""
    dev = backend.resolve_device(device)
    attached = elastic_lib.attached_devices(dev)
    if n_devices is None:
        avail = attached or 1
        world = _largest_batch_divisor(batch_size, avail)
        if world < avail:
            log_.warning("batch_size %d is not divisible by the %d attached "
                         "cards; using %d ranks (%d idle)", batch_size, avail,
                         world, avail - world)
        return world
    if n_devices < 1 or batch_size % n_devices:
        raise ValueError(
            f"batch_size {batch_size} is not divisible by n_devices "
            f"{n_devices}; shares are exact (largest usable: "
            f"{_largest_batch_divisor(batch_size, max(n_devices, 1))})")
    if attached is not None and n_devices > attached:
        if not elastic:
            raise ValueError(f"n_devices {n_devices} exceeds the {attached} "
                             "attached cards")
        world = _largest_batch_divisor(batch_size, attached)
        log_.warning(
            "elastic world: %d devices requested but only %d attached; "
            "re-forming on %d (global batch %d held, per-rank share %d -> %d)",
            n_devices, attached, world, batch_size, batch_size // n_devices,
            batch_size // world)
        return world
    return n_devices


def resolve_steps_per_call(iterations: int,
                           steps_per_call: Optional[int] = None, *,
                           cadences: Sequence[int] = (),
                           byte_cap: Optional[int] = None,
                           step_bytes: int = 0, start_step: int = 0) -> int:
    """Steps per call (the JAX trainer's ``_resolve_steps_per_call``): the
    largest K <= cap dividing the iteration count and every nonzero
    cadence (print, save, checkpoint), so calls never cross a dump
    boundary and the run is a whole number of calls.  The cap is
    ``fused_step.MAX_STEPS_PER_CALL``, or an explicit ``steps_per_call``,
    which is reduced with a warning when it does not divide them.

    ``byte_cap`` (the streaming path): K also keeps one chunk's bytes
    (``step_bytes`` a step) within the cap, and divides a nonzero
    ``start_step`` (a streamed chunk slices ``it % K``); 0 means K 1."""
    cap = (fused_step.MAX_STEPS_PER_CALL if steps_per_call is None
           else max(1, steps_per_call))
    byte_capped = False
    if byte_cap is not None:
        byte_steps = max(1, byte_cap // step_bytes)
        byte_capped = byte_steps < cap
        cap = min(cap, byte_steps)
    g = iterations
    for cad in cadences:
        if cad:
            g = math.gcd(g, cad)
    if byte_cap is not None and start_step:
        g = math.gcd(g, start_step)
    if g <= 0:
        return 1
    k = max(d for d in range(1, min(cap, g) + 1) if g % d == 0)
    if steps_per_call is not None and k != steps_per_call:
        log_.warning("steps_per_call=%d reduced to %d (%s)", steps_per_call,
                     k, "chunk transfer-byte budget stream_chunk_bytes"
                     if byte_capped and k == cap else
                     "must divide the iteration count and the artifact "
                     "cadences so every call runs whole")
    return k


def advance_latents(z_gen: torch.Generator, steps: int, batch_size: int,
                    z_size: int, device) -> None:
    """Put ``z_gen`` where it stands after ``steps`` protocol steps from
    its seed: each step draws z1 and z2, [batch_size, z_size] each (the
    resume route for a checkpoint without ``z_gen_state``)."""
    for _ in range(2 * steps):
        torch.rand((batch_size, z_size), generator=z_gen, device=device)


# the failures a restart would only replay (configuration and checkpoint
# structure mismatches, a corrupt explicit checkpoint, the quarantine
# budget, a NaN or divergence abort, an exhausted rollback budget):
# re-raised at once
FATAL_CLASSES = (ValueError, TypeError, CheckpointCorruptError,
                 DataQuarantineError, NanAlarmError, DivergenceError,
                 RollbackError)


def _recover(run_once: Callable[[bool], Dict], failure_step: Callable,
             is_fatal: Callable[[BaseException], bool], cleanup: Callable,
             max_restarts: int, log: Optional[Callable[[str], None]],
             backoff_base_s: float, backoff_max_s: float,
             on_restart: Optional[Callable] = None) -> Dict:
    """The restart loop both recovery wrappers share: ``run_once(resume)``
    until it returns; ``PreemptionError`` and the fatal class re-raise;
    ``RollbackRequested`` resumes at once, without charging the restart
    budget or backing off (the rollback budget is the manager's own, charged
    before the raise); anything else is retried after ``cleanup(e)``, with
    resume, backoff ``backoff_base_s * 2^n`` (capped) and jitter x[0.5,
    1.5), while the progress-aware budget lasts: a failure at a later
    ``failure_step(e)`` than the previous one resets it.  ``on_restart(e,
    step, attempt, delay)`` runs before each retry's backoff."""
    attempt = 0
    resume_next = False
    last_failure_step: Optional[int] = None
    while True:
        try:
            return run_once(resume_next)
        except (KeyboardInterrupt, PreemptionError):
            raise
        except Exception as e:
            if is_fatal(e):
                raise  # a restart replays the same failure
            cleanup(e)
            resume_next = True
            if isinstance(e, RollbackRequested):
                if log is not None:
                    log(f"rolling back at step {e.step} (rollback "
                        f"#{e.rollbacks}): {e} — restoring the last verified "
                        "pre-failure checkpoint with a cut LR and a "
                        "perturbed noise stream")
                continue
            step = int(failure_step(e) or 0)
            if last_failure_step is not None and step > last_failure_step:
                attempt = 0  # progress since the last failure
            last_failure_step = step
            attempt += 1
            if attempt > max_restarts:
                raise
            delay = 0.0
            if backoff_base_s > 0:
                delay = min(backoff_max_s,
                            backoff_base_s * (2 ** (attempt - 1)))
                delay *= 0.5 + random.random()
            if log is not None:
                log(f"training failed ({e!r}) at step {step}; restart "
                    f"{attempt}/{max_restarts} from the latest checkpoint"
                    + (f" after {delay:.1f}s backoff" if delay else ""))
            if on_restart is not None:
                on_restart(e, step, attempt, delay)
            if delay:
                time.sleep(delay)


def train_with_recovery(make_trainer: Callable[[bool], "GANTrainer"],
                        max_restarts: int = 2,
                        log: Optional[Callable[[str], None]] = print,
                        backoff_base_s: float = 1.0,
                        backoff_max_s: float = 30.0) -> Dict:
    """Run ``make_trainer(resume).train()``; after a retryable failure,
    build a new trainer that resumes from the newest checkpoint (the JAX
    package's classification):

    * fatal, re-raised at once: ``FATAL_CLASSES`` (a restart replays the
      same failure: a deterministic replay marches into the same NaN or
      divergence, and an exhausted rollback budget has already failed);
    * ``PreemptionError`` is re-raised: the emergency checkpoint is on disk
      and the scheduler restarts the job (the mains exit 75);
    * ``RollbackRequested`` (``nan_alarm="rollback"``) builds the next
      incarnation at once, resuming before the bad step, without charging
      the restart budget or backing off;
    * everything else (a ``WatchdogTimeout`` among them) is retried, with
      backoff ``backoff_base_s * 2^n`` (capped) and jitter x[0.5, 1.5).  The
      budget is progress-aware: a failure at a later step than the
      previous one resets it.

    The failed incarnation's checkpointer is quiesced (an async save in
    flight becomes durable, its worker is reaped) before the next trainer
    is built.  A retryable failure first dumps the failed incarnation's
    flight record (``flight_record_training_failure.json``), then appends
    a ``recovery.restart`` instant to the run's ``events.jsonl`` through a
    transient recorder (the next incarnation appends after it).  A
    data-parallel world recovers as a whole (``spawn_with_recovery``): its
    ranks run without this wrapper."""
    box: Dict = {}

    def run_once(resume: bool) -> Dict:
        box["trainer"] = None
        box["trainer"] = make_trainer(resume)
        return box["trainer"].train(log=log)

    def cleanup(e) -> None:
        trainer = box["trainer"]
        ck_close = getattr(getattr(trainer, "checkpointer", None),
                           "close", None)
        if ck_close is not None:
            try:
                ck_close()
            except Exception as ce:
                if log is not None:
                    log(f"checkpoint writer failed during restart quiesce "
                        f"({ce!r}); the restart falls back to the previous "
                        "verified checkpoint")
        # the flight record, while the failed incarnation's ring still
        # holds the events that led here (even the last, budget-exhausted
        # failure leaves its timeline behind)
        recorder = getattr(trainer, "_events", None)
        res_path = getattr(getattr(trainer, "c", None), "res_path", None)
        if (recorder is not None and res_path
                and not isinstance(e, RollbackRequested)):
            recorder.dump_flight_record(
                res_path, "training_failure",
                extra={"step": getattr(trainer, "steps", 0),
                       "error": repr(e)})

    def on_restart(e, step, attempt, delay) -> None:
        # the failed incarnation's recorder is closed and the next one not
        # open yet: append through a transient recorder, so the timeline
        # stays one contiguous file
        c = getattr(box["trainer"], "c", None)
        if not (getattr(c, "events", False) and getattr(c, "res_path", None)):
            return
        try:
            with events.EventRecorder(
                    path=os.path.join(c.res_path, events.EVENTS_NAME),
                    append=True, flush_every=1) as rec:
                rec.instant("recovery.restart", step=step, attempt=attempt,
                            backoff_s=round(delay, 3), error=repr(e))
        except Exception:  # diagnostics must never eat the restart
            pass

    return _recover(run_once,
                    lambda e: getattr(box["trainer"], "steps", 0),
                    lambda e: isinstance(e, FATAL_CLASSES),
                    cleanup, max_restarts, log,
                    backoff_base_s, backoff_max_s, on_restart)


def spawn_with_recovery(launch: Callable[[bool], Dict], checkpoint_dir: str,
                        max_restarts: int = 2,
                        log: Optional[Callable[[str], None]] = print,
                        backoff_base_s: float = 1.0,
                        backoff_max_s: float = 30.0) -> Dict:
    """Whole-world recovery of a data-parallel run: ``launch(resume)``
    spawns every rank (``mesh.spawn``) and returns rank 0's result.  When a
    rank fails, ``mesh.spawn`` kills the others after a short grace and
    raises ``RankFailedError`` with each failure's class names; this
    wrapper then re-spawns the whole world with ``resume`` from the newest
    checkpoint the ranks verify, under ``train_with_recovery``'s rules: a
    rank of a fatal class (by name, subclasses included) re-raises at once,
    a preempted world returns its result, anything else is retried with the
    same backoff and budget.  A world's progress is the newest verified
    checkpoint's step under ``checkpoint_dir`` (the ranks' own step does
    not cross the process boundary): a failure after a newer checkpoint
    resets the budget."""
    fatal = tuple(c.__name__ for c in FATAL_CLASSES)

    def is_fatal(e: BaseException) -> bool:
        if isinstance(e, mesh.RankFailedError):
            return e.has_class(*fatal)
        return isinstance(e, FATAL_CLASSES)

    def newest_checkpoint(e) -> int:
        if not os.path.isdir(checkpoint_dir):
            return 0
        ck = TrainCheckpointer(checkpoint_dir, sweep_debris=False)
        return ck.latest_verified_step() or 0

    return _recover(launch, newest_checkpoint, is_fatal, lambda e: None,
                    max_restarts, log, backoff_base_s, backoff_max_s)


def add_recovery_args(parser) -> None:
    """The mains' checkpoint, resume, restart and preemption flags and the
    resilient data plane's (the JAX mains' names, defaults and meaning)."""
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="checkpoint every N steps into "
                             "res-path/checkpoints (0 = none)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest verified checkpoint "
                             "(consumes PREEMPTED.json)")
    parser.add_argument(
        "--max-restarts", type=int, default=0,
        help="auto-resume from the latest checkpoint on failure, up to N "
             "times (needs --checkpoint-every); the budget is "
             "progress-aware and fatal errors (configuration or structure "
             "mismatch, a corrupt explicit checkpoint, the quarantine "
             "budget) are not retried")
    parser.add_argument(
        "--async-checkpoint", action="store_true",
        help="serialize/fsync checkpoints on a background worker — the "
             "training thread pays only the snapshot; the bytes on disk "
             "are those of a synchronous save")
    parser.add_argument(
        "--preempt-signal", action="append", default=None, metavar="SIG",
        help="signal name (e.g. SIGTERM; repeatable) that triggers an "
             "emergency checkpoint and a resumable PREEMPTED.json marker, "
             "then exit code 75 (EX_TEMPFAIL): requeue and resume with "
             "--resume")
    parser.add_argument(
        "--data-retries", type=int, default=3, metavar="N",
        help="bounded retries (exponential backoff + jitter) on transient "
             "data-source I/O errors; exhaustion is a retryable "
             "DataSourceError for --max-restarts (0 = die on the first "
             "I/O error)")
    parser.add_argument(
        "--max-quarantine", type=int, default=0, metavar="N",
        help="corrupt-record tolerance: skip up to N malformed records "
             "(bad width/parse/non-finite/label), logging each to "
             "res-path/quarantine.jsonl with file:line provenance; "
             "exceeding the budget is a fatal DataQuarantineError.  0 = "
             "strict: the first malformed record raises, naming its "
             "file:line")


def recovery_config_kwargs(args) -> Dict:
    """The add_recovery_args flags as ``GANTrainerConfig`` overrides."""
    return dict(
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        async_checkpoint=args.async_checkpoint,
        preempt_signals=(",".join(args.preempt_signal)
                         if args.preempt_signal else None),
        data_retries=args.data_retries, max_quarantine=args.max_quarantine)


def add_health_args(parser) -> None:
    """The mains' training-health flags, with the JAX mains' names, help and
    defaults (less ``--sanitize``, and less the files the port does not
    write yet): ``--telemetry`` and ``--nan-alarm`` (each JAX main's own),
    then the JAX ``add_health_args``': the divergence sentinel, rollback
    and the watchdog."""
    parser.add_argument(
        "--telemetry", action="store_true",
        help="in-graph numerics telemetry: per-step grad/param norms, "
             "update ratios and NaN/Inf counters computed inside the "
             "fused step and logged as metrics columns (they ride the "
             "step's one readback)")
    parser.add_argument(
        "--nan-alarm", default=None,
        choices=["warn", "snapshot", "abort", "rollback"],
        help="action on the first non-finite step (needs --telemetry): "
             "warn = log and continue; snapshot = save a forensic "
             "checkpoint to res-path/nan_snapshot (through the emergency-"
             "checkpoint path) and continue; abort = raise; the recovery "
             "wrapper classifies the abort as FATAL — a deterministic "
             "replay would hit the same NaN, so --max-restarts is not "
             "burned on it; rollback = heal in-process: restore the last "
             "verified pre-NaN checkpoint, cut the LR by "
             "--rollback-lr-factor and perturb the noise stream so the "
             "replay differs (needs --checkpoint-every)")
    parser.add_argument(
        "--divergence", action="store_true",
        help="arm the windowed divergence sentinel (needs --telemetry): "
             "trip on loss explosion / grad-norm blowup BEFORE NaNs "
             "appear; the action on a trip is --nan-alarm's (warn when "
             "unset) — pair with '--nan-alarm rollback' to heal")
    parser.add_argument(
        "--max-rollbacks", type=int, default=3, metavar="N",
        help="rollback budget for '--nan-alarm rollback' (progress-"
             "aware like --max-restarts: a rollback at a later step "
             "than the previous one resets the counter); exhausted = "
             "fatal escalation")
    parser.add_argument(
        "--rollback-lr-factor", type=float, default=0.5, metavar="F",
        help="learning-rate multiplier applied per rollback "
             "(compounding) — the healing half of rollback-with-"
             "perturbation")
    parser.add_argument(
        "--watchdog", action="store_true",
        help="arm the hang watchdog: heartbeat at every call boundary and "
             "around every blocking region; a silent hang (dead data "
             "source, wedged readback/collective) dumps a flight record, "
             "takes a best-effort emergency checkpoint and becomes a "
             "retryable WatchdogTimeout for --max-restarts instead of a "
             "run stuck forever")
    parser.add_argument(
        "--watchdog-deadline", type=float, default=None, metavar="SEC",
        help="fixed watchdog deadline in seconds (default: auto-scale "
             "from the measured steady-state step time)")


def add_observability_args(parser, live_ui: bool = True) -> None:
    """The JAX mains' ``--profile`` and ``--metrics-port`` and, on the
    protocol mains, ``--live-ui`` (their defaults and help)."""
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the run into DIR (with "
             "--n-devices, each rank's into DIR/rank<r>)")
    if live_ui:
        parser.add_argument(
            "--live-ui", type=int, default=0, metavar="PORT",
            help="serve a live loss dashboard over the metrics JSONL on "
                 "this port (the Spark-web-UI analog)")
    parser.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve /metrics (Prometheus text: step/loss/goodput/NaN "
             "series) + /healthz on this port for the duration of "
             "training (0 = ephemeral)")


@contextlib.contextmanager
def live_ui_for(args, config: "GANTrainerConfig", rank0: bool = True):
    """``--live-ui``: rank 0's process serves the dashboard over the run's
    metrics JSONL for the block (started before the run, stopped on every
    way out, before the mains print their JSON line)."""
    stop = (serve_for_config(config, args.live_ui)
            if rank0 and getattr(args, "live_ui", 0) else None)
    try:
        yield stop
    finally:
        if stop is not None:
            stop()


def profiled(args, group: Optional[mesh.DataGroup] = None):
    """``--profile DIR``: a ``torch.profiler`` capture of the block into
    this rank's directory (``DIR``, or ``DIR/rank<r>`` under a group),
    which must hold device activity when the rank runs on the card."""
    device = (group.device if group is not None
              else backend.resolve_device(args.device))
    return maybe_trace(rank_trace_dir(args.profile, group),
                       require_device=device.type == "cuda")


def health_config_kwargs(args) -> Dict:
    """The add_health_args flags as ``GANTrainerConfig`` overrides."""
    return dict(telemetry=args.telemetry, nan_alarm=args.nan_alarm,
                divergence=args.divergence, max_rollbacks=args.max_rollbacks,
                rollback_lr_factor=args.rollback_lr_factor,
                watchdog=args.watchdog,
                watchdog_deadline_s=args.watchdog_deadline)


def check_recovery_args(parser, args) -> None:
    """The mains' validation of the recovery and health flags."""
    if args.max_restarts > 0 and args.checkpoint_every <= 0:
        parser.error("--max-restarts needs --checkpoint-every (without "
                     "checkpoints every restart replays from step 0)")
    if getattr(args, "nan_alarm", None) == "rollback" \
            and args.checkpoint_every <= 0:
        parser.error("--nan-alarm rollback needs --checkpoint-every "
                     "(rollback restores the last verified checkpoint "
                     "from before the bad step; without checkpoints it "
                     "can only replay from step 0)")


def run_with_recovery(make_trainer: Callable[[bool, Optional[RollbackManager]],
                                             "GANTrainer"],
                      config: GANTrainerConfig, max_restarts: int = 0,
                      log: Optional[Callable[[str], None]] = print
                      ) -> Tuple["GANTrainer", Dict]:
    """The mains' wiring: ``make_trainer(resume, rollback_manager)`` builds
    a trainer (with ``resume`` forced on for a restart) and it trains,
    under ``train_with_recovery`` when ``max_restarts`` > 0 -> (the last
    trainer, its result).  With ``config.nan_alarm == "rollback"`` one
    ``RollbackManager`` is made here and shared by every incarnation (the
    LR scale, the epoch and the rollback budget must survive the rebuild),
    and the run goes through ``train_with_recovery`` even at
    ``max_restarts`` 0, so that the rollback path exists (other failures
    still re-raise at once).  A rank of a data-parallel world calls this
    too: its trainers are rebuilt over the same group, in lockstep with the
    other ranks'."""
    holder = {}
    manager = None
    if config.nan_alarm == "rollback":
        manager = RollbackManager(max_rollbacks=config.max_rollbacks,
                                  lr_factor=config.rollback_lr_factor)

    def make(resume: bool) -> "GANTrainer":
        holder["trainer"] = make_trainer(resume, manager)
        return holder["trainer"]

    if max_restarts > 0 or manager is not None:
        result = train_with_recovery(make, max_restarts=max_restarts,
                                     log=log)
    else:
        result = make(False).train(log=log)
    return holder["trainer"], result


class GANTrainer:
    """Builds the four graphs and the training table on one device (None =
    the card; a ``group`` brings its rank's device) and trains them,
    data-parallel over ``group`` when one is given.

    The bare loop (the keyword options; the DCGAN graphs on an in-memory
    MNIST table): ``steps_per_call`` caps K (None =
    ``MAX_STEPS_PER_CALL``), ``ema_decay`` in [0, 1) keeps the generator
    EMA (fused step only), ``fused=False`` or ``dp_mode="param_averaging"``
    select the unfused per-fit loop (under a group through
    ``DataParallelGraph``: ``dp_mode``, ``averaging_frequency``); no
    cadences, no files.

    The programs (``cv_main``, ``insurance_main``): ``config`` (a
    ``GANTrainerConfig``, which then supplies batch_size, steps_per_call,
    ema_decay, fused, dp_mode and averaging_frequency: leave those at their
    defaults) and ``workload`` (its graphs, sync maps, CSV files and grid
    extras).  ``rollback_manager``: the run's ``RollbackManager``, shared
    by every incarnation (``nan_alarm="rollback"`` needs one)."""

    def __init__(self, cfg: M.CVConfig = M.CVConfig(), batch_size: int = 200,
                 n_train: int = 60000, device=None,
                 group: Optional[mesh.DataGroup] = None,
                 steps_per_call: Optional[int] = None, ema_decay: float = 0.0,
                 fused: bool = True, dp_mode: str = "gradient_sync",
                 averaging_frequency: int = 1, *,
                 config: Optional[GANTrainerConfig] = None,
                 workload: Optional[Workload] = None,
                 rollback_manager: Optional[RollbackManager] = None):
        if config is None:
            config = GANTrainerConfig(
                dataset_name="mnist", num_features=cfg.num_features,
                label_index=cfg.num_features, num_classes=cfg.num_classes,
                batch_size=batch_size, batch_size_pred=500, num_iterations=0,
                num_gen_samples=10, z_size=cfg.z_size, print_every=0,
                save_every=0, seed=cfg.seed, res_path=None, dp_mode=dp_mode,
                averaging_frequency=averaging_frequency, fused=fused,
                steps_per_call=steps_per_call, metrics=False,
                ema_decay=ema_decay)
        elif (batch_size, steps_per_call, ema_decay, fused, dp_mode,
              averaging_frequency) != (200, None, 0.0, True,
                                       "gradient_sync", 1):
            raise ValueError("pass the bare loop's options or a config, "
                             "not both")
        c = self.c = config
        if not 0.0 <= c.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in [0, 1), got {c.ema_decay} "
                "(1.0 would pin the EMA at initialization forever)")
        if c.dp_mode not in DP_MODES:
            raise ValueError(f"unknown dp_mode {c.dp_mode!r}; known: "
                             f"{DP_MODES}")
        self.fused = c.fused and c.dp_mode == "gradient_sync"
        if c.ema_decay > 0 and not self.fused:
            raise ValueError(
                "ema_decay > 0 requires the fused step (fused=True, "
                "dp_mode='gradient_sync') — only it maintains the EMA")
        if c.steps_per_call is not None and c.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got "
                             f"{c.steps_per_call}")
        # the supervision options fail before any side effect (an unknown
        # signal name must not surface inside a grace window)
        self._preempt_signal_nums = (parse_signals(c.preempt_signals)
                                     if c.preempt_signals else ())
        if c.data_retries < 0:
            raise ValueError(f"data_retries must be >= 0, got "
                             f"{c.data_retries}")
        if c.max_quarantine < 0:
            raise ValueError(f"max_quarantine must be >= 0, got "
                             f"{c.max_quarantine}")
        wants_ckpt = bool(c.checkpoint_every or c.resume
                          or self._preempt_signal_nums)
        if wants_ckpt and not c.res_path:
            raise ValueError("checkpoint_every, resume and preempt_signals "
                             "need a res_path (checkpoints go to "
                             "res_path/checkpoints)")
        self._check_health_config(group, rollback_manager)
        self._rollback_mgr = rollback_manager
        # goodput covers the whole run from here: the data set-up, the
        # restore and the capture happen in this constructor (a later
        # train() of the same trainer starts a fresh timer)
        self.goodput = GoodputTimer()
        self._goodput_used = False
        self.run_manifest: Optional[Dict] = None
        # the scrape registry (telemetry/exporter.py): fed by every flushed
        # metrics record and, at scrape time, by the goodput ledger, the
        # data plane and the group's size; served by train() when
        # metrics_port is set
        self.registry = MetricsRegistry()
        self.registry.observe_goodput(lambda: self.goodput.report())
        self.metrics_port: Optional[int] = None
        # the set-up's events (the data plane's, the restore's, a
        # rollback's) go to a ring of their own until train() installs the
        # run's recorder, which adopts them after ``train.start``
        self._setup_events = events.EventRecorder()
        with events.recording(self._setup_events):
            self._build(cfg, n_train, device, group, workload,
                        rollback_manager, wants_ckpt)

    def _build(self, cfg, n_train: int, device, group, workload,
               rollback_manager, wants_ckpt: bool) -> None:
        """The constructor's set-up: the graphs, the training table, the
        resume, the step and its capture."""
        c = self.c
        if group is not None:
            device = group.device
        self.device = dev = backend.resolve_device(device)
        self.group = group
        self.rank0 = group is None or group.rank == 0
        # the alarms: rank 0 observes its flushed metrics records, and the
        # ranks agree on the outcome at every boundary (``_agree_alarms``)
        self._nan_alarm = NanAlarm() if c.nan_alarm else None
        self._nan_handled = False
        self._divergence = (DivergenceSentinel(
            window=c.divergence_window, factor=c.divergence_factor,
            patience=c.divergence_patience) if c.divergence else None)
        self._div_handled = False
        # a pending (reason, bad_step), set by the alarm polls and taken
        # by _maybe_rollback at the same boundary
        self._rollback_pending: Optional[Tuple[str, int]] = None
        # a rollback's resume is bounded: strictly before the bad step
        self._resume_max_step = (rollback_manager.resume_max_step
                                 if rollback_manager is not None else None)
        self._rolled_back = False
        self._events: Optional[events.EventRecorder] = None
        self._watchdog: Optional[HeartbeatWatchdog] = None
        self._in_flight = False
        self.batch_size = c.batch_size
        self.steps_per_call, self.ema_decay = c.steps_per_call, c.ema_decay
        self.dp_mode = c.dp_mode
        self.workload = workload
        self.steps = 0
        self.timings: Dict = {"dumps": []}
        if workload is not None:
            graphs = workload.build_graphs(dev)
            self.maps = (workload.dis_to_gan, workload.gan_to_gen,
                         workload.dis_to_classifier)
        else:
            dis = M.build_discriminator(cfg, dev)
            graphs = {"dis": dis, "gen": M.build_generator(cfg, dev),
                      "gan": M.build_gan(cfg, dev),
                      "classifier": M.build_classifier(dis, cfg)}
            self.maps = (M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER)
        self.dis, self.gen = graphs["dis"], graphs["gen"]
        self.gan, self.classifier = graphs["gan"], graphs["classifier"]
        B = c.batch_size

        # -- the data: decoded before anything reads its address ------------
        test_iter = None
        # the resilient data plane: the CSV decode retries transient I/O
        # errors and, with a budget, skips and charges corrupt records
        self.data_health = DataHealth()
        self.registry.observe_data(self.data_health.report)
        # the elastic-world surface: the world's size and the reshards this
        # incarnation's restore paid (gan4j_mesh_devices, gan4j_reshard_*)
        self._reshard_total = 0
        self._reshard_seconds = 0.0
        self.registry.observe_mesh(self._mesh_report)
        self._quarantine = None
        if c.max_quarantine:
            self._quarantine = RecordQuarantine(
                os.path.join(c.res_path, QUARANTINE_NAME)
                if c.res_path and self.rank0 else os.devnull,
                budget=c.max_quarantine, health=self.data_health)
        reader = CSVRecordReader()
        if c.data_retries:
            reader = RetryingReader(reader, retries=c.data_retries,
                                    backoff_s=c.data_retry_backoff_s,
                                    health=self.data_health, seed=c.seed)
        iter_kw = dict(reader=reader, quarantine=self._quarantine)
        with self._phase("data_wait"), events.span("data.prepare"):
            if workload is not None:
                t0 = time.perf_counter()
                train_csv, test_csv = workload.ensure_data(c.res_path)
                self.timings["csv_ready_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                train_iter = RecordReaderDataSetIterator(
                    train_csv, B, c.label_index, c.num_classes, **iter_kw)
                test_iter = RecordReaderDataSetIterator(
                    test_csv, c.batch_size_pred, c.label_index,
                    c.num_classes, **iter_kw)
                self.timings["decode_s"] = time.perf_counter() - t0
            else:
                train_iter = RecordReaderDataSetIterator(
                    datasets.mnist_table(n_train), B, c.label_index,
                    c.num_classes, **iter_kw)
        if train_iter.num_examples() < B:
            raise ValueError(f"the training table has {train_iter.num_examples()}"
                             f" rows, less than one batch of {B}")
        if c.save_every and test_iter is None:
            raise ValueError("save_every needs a test iterator")
        self.train_iter, self.test_iter = train_iter, test_iter
        self._iter_state_consumed: Optional[Dict] = None

        # the run's random state: the label softening, drawn once, and the
        # latent generator
        soften = prng.generator(c.seed, "soften")
        self.soften_real = 0.05 * torch.randn((B, 1), generator=soften).to(dev)
        self.soften_fake = 0.05 * torch.randn((B, 1), generator=soften).to(dev)
        self.z_gen = prng.generator(c.seed, "train-z", dev)

        # checkpoints (only rank 0 writes; the others read, so they leave
        # rank 0's in-flight temp dirs alone), then the resume, before the
        # step count fixes the streamed chunk size and before the capture
        self.checkpointer = None
        self._saved_step: Optional[int] = None
        if wants_ckpt:
            ck = TrainCheckpointer(
                os.path.join(c.res_path, "checkpoints"),
                keep=c.checkpoint_keep, sweep_debris=self.rank0)
            if c.async_checkpoint and self.rank0:
                ck = AsyncCheckpointer(ck)
            self.checkpointer = ck
        with self._phase("checkpoint"), events.span("train.resume"):
            self._maybe_resume()
        if rollback_manager is not None:
            # the LR cut (every incarnation) and, after a rollback restore,
            # the latent stream's new lineage: both after the restore (it
            # sets z_gen) and before the step is built and captured (the
            # captured launches carry their rates)
            rollback_manager.apply(self)
            if self._rolled_back:
                perturb_z_gen(self.z_gen, c.seed, rollback_manager.total)
        self.ones = torch.ones((B, 1), device=dev)
        self.y_real = self.ones + self.soften_real
        self.y_fake = self.soften_fake

        resident_f32 = not self.fused or self._resident_data_ok(train_iter)
        codec = None
        if (self.fused and not resident_f32 and c.use_data_codec
                and codec_lib.u8x100_lossless(train_iter.features)):
            codec = "u8x100"
        resident = resident_f32 or (
            codec is not None and self._resident_data_ok(train_iter, codec))
        self.resident = resident
        self.data_codec = codec
        self.stream_dedup = False
        self.row_idx: Optional[torch.Tensor] = None
        self._chunks: Optional[ChunkPrefetchIterator] = None
        t0 = time.perf_counter()
        with self._phase("data_wait"):
            if resident:
                feats = train_iter.features
                if codec:
                    feats = codec_lib.u8x100_encode(feats)
                self.features = torch.from_numpy(feats).to(dev)
                self.labels = torch.from_numpy(train_iter.labels).to(dev)
                self.stream_k = None
            else:
                byte_cap = c.stream_chunk_bytes
                n_full = train_iter.num_examples() // B
                if self._dedup_ok(train_iter, codec):
                    self.stream_dedup = True
                    byte_cap = UNCAPPED_STREAM
                self.stream_k = self._resolve_steps_per_call(
                    byte_cap=byte_cap, codec=codec)
                if self.stream_k <= 1:
                    self.stream_dedup = False
                if self.stream_dedup:
                    # the static table (f32: the codes decode once, on
                    # arrival) and the static schedule the step reads
                    rows = n_full * B
                    self.row_idx = torch.zeros(self.stream_k * B,
                                               dtype=torch.int32, device=dev)
                else:
                    # the static chunk buffers the step reads; each call's
                    # chunk is copied in (``_chunked_stream_loop``)
                    rows = self.stream_k * B
                self.features = torch.zeros(
                    (rows, c.num_features), device=dev,
                    dtype=(torch.uint8 if codec and not self.stream_dedup
                           else torch.float32))
                self.labels = torch.zeros((rows, c.num_classes), device=dev)
            if dev.type == "cuda":
                device_lib.stream_fence(torch.cuda.current_stream(dev))
        self.timings["upload_s"] = time.perf_counter() - t0

        self.z_grid = torch.from_numpy(
            latent_grid(c.num_gen_samples, c.z_size)).to(dev)
        self.state: Optional[fused_step.ProtocolState] = None
        self.graphed: Optional[fused_step.GraphedStep] = None
        self._step_fns: Dict[int, Callable] = {}
        self._test_x: Optional[List[torch.Tensor]] = None
        if self.fused:
            self.state = fused_step.state_from_graphs(
                self.dis, self.gen, self.gan, self.classifier,
                start_step=self.steps, ema=c.ema_decay > 0)
            # one card: the step as a CUDA graph.  The CPU and groups stay
            # eager by configuration (gloo cannot be captured; capturing
            # NCCL is later work)
            if dev.type == "cuda" and group is None:
                # the warm-up and the capture: the JAX trainer's compile,
                # which its first dispatch pays
                with self._phase("dispatch"):
                    self.graphed = fused_step.GraphedStep(
                        self.step_fn(1), self.state, *self._tables(),
                        self.y_real, self.y_fake, self.ones,
                        z_gen=self.z_gen,
                        ring=c.steps_per_call or fused_step.MAX_STEPS_PER_CALL,
                        n_losses=3 + (len(fused_step.TELEMETRY_KEYS)
                                      if c.telemetry else 0))
                self.state = self.graphed.state
                self.timings["capture_s"] = (self.graphed.setup["warmup_s"]
                                             + self.graphed.setup["capture_s"])
        elif group is None:
            self._fits = (self.dis.fit, self.gan.fit, self.classifier.fit)
        else:
            self._fits = tuple(
                DataParallelGraph(g, group, mode=c.dp_mode,
                                  averaging_frequency=c.averaging_frequency).fit
                for g in (self.dis, self.gan, self.classifier))
        metrics_path = (os.path.join(c.res_path,
                                     f"{c.dataset_name}_metrics.jsonl")
                        if c.metrics and c.res_path and self.rank0 else None)
        # a resumed run appends to its own history (one timeline; a reader
        # de-duplicates by step, the last record winning)
        self.metrics = MetricsLogger(
            metrics_path, append=c.resume,
            on_record=self._observe_record if self.rank0 else None)
        self._preempt_guard: Optional[PreemptionGuard] = None
        # inline until train() swaps in the background writer, so the dump
        # methods also work when called directly
        self._dumper = AsyncArtifactWriter(synchronous=True)

    # -- configuration ---------------------------------------------------------

    def _check_health_config(self, group, rollback_manager) -> None:
        """The numerics and hang options, before any side effect (the JAX
        trainer's checks and messages)."""
        c = self.c
        if c.nan_alarm not in NAN_ALARM_ACTIONS:
            raise ValueError(
                f"nan_alarm must be None/'warn'/'snapshot'/'abort'/"
                f"'rollback', got {c.nan_alarm!r}")
        if c.nan_alarm and not c.telemetry:
            raise ValueError(
                "nan_alarm needs telemetry=True — without the in-graph "
                "NaN/Inf counters there is nothing to trip on")
        if c.divergence and not c.telemetry:
            raise ValueError(
                "divergence=True needs telemetry=True — the sentinel "
                "watches the in-graph grad-norm/loss records")
        if c.telemetry and not self.fused:
            raise ValueError(
                "telemetry=True requires the fused step (fused=True, "
                "dp_mode='gradient_sync') — only the fused step computes "
                "the in-graph numerics block")
        if c.nan_alarm in ("snapshot", "rollback") and not c.res_path:
            raise ValueError(f"nan_alarm={c.nan_alarm!r} needs a res_path "
                             "(its checkpoints go there)")
        if c.nan_alarm == "rollback" and rollback_manager is None:
            raise ValueError(
                "nan_alarm='rollback' needs a RollbackManager shared "
                "across trainer incarnations (run_with_recovery wires "
                "one; pass rollback_manager= when driving GANTrainer "
                "directly) — a per-incarnation manager would reset the "
                "LR cut, the latent stream's epoch and the budget on "
                "every rollback")

    def _observe_record(self, rec: Dict) -> None:
        """MetricsLogger ``on_record`` hook (rank 0): every flushed record
        feeds the NaN alarm, the divergence sentinel and the scrape
        registry."""
        if self._nan_alarm is not None:
            self._nan_alarm.observe(rec)
        if self._divergence is not None:
            self._divergence.observe(rec)
        self.registry.observe_record(rec)

    def _resident_data_ok(self, iter_train, codec=None) -> bool:
        """The device-resident data path: the config's override, else the
        table (at u8 size under the codec) must fit the byte budget."""
        c = self.c
        if c.data_on_device is not None:
            return bool(c.data_on_device)
        feat_bytes = iter_train.features.nbytes
        if codec == "u8x100":
            feat_bytes //= 4
        return feat_bytes + iter_train.labels.nbytes <= c.data_on_device_max_bytes

    def _dedup_ok(self, train_iter, codec) -> bool:
        """The JAX trainer's adaptive dedup decision: not opted out, and
        one chunk of the uncapped K covers every full batch of a pass
        while the distinct-row table (u8 features under the codec) fits
        the chunk budget."""
        c = self.c
        if c.stream_dedup is False:
            return False
        k_nocap = self._resolve_steps_per_call(byte_cap=UNCAPPED_STREAM,
                                               codec=codec)
        n_full = train_iter.num_examples() // c.batch_size
        fb = 1 if codec == "u8x100" else 4
        table_bytes = n_full * c.batch_size * (fb * c.num_features
                                               + 4 * c.num_classes)
        return (0 < n_full <= k_nocap and k_nocap > 1
                and table_bytes <= c.stream_chunk_bytes)

    def _tables(self) -> Tuple[torch.Tensor, ...]:
        """The data the step reads: the table (resident, or the streamed
        chunk) and its labels, and the dedup tier's row schedule."""
        if self.stream_dedup:
            return self.features, self.labels, self.row_idx
        return self.features, self.labels

    def _resolve_steps_per_call(self, byte_cap: Optional[int] = None,
                                codec: Optional[str] = None) -> int:
        """K for this trainer's run (``resolve_steps_per_call`` with the
        config's cadences; ``byte_cap`` on the streaming path, where a
        codec chunk counts 5 bytes a feature as in the JAX trainer)."""
        c = self.c
        feat_bytes = 5 if codec == "u8x100" else 4
        return resolve_steps_per_call(
            c.num_iterations, c.steps_per_call,
            cadences=(c.print_every, c.save_every, c.checkpoint_every),
            byte_cap=byte_cap,
            step_bytes=c.batch_size * (feat_bytes * c.num_features
                                       + 4 * c.num_classes),
            start_step=self.steps)

    def step_fn(self, k: int) -> Callable:
        """The fused step with ``steps_per_call`` k (eager; built once per
        k) on this trainer's graphs, group, EMA decay and table codec."""
        if k not in self._step_fns:
            self._step_fns[k] = fused_step.make_protocol_step(
                self.dis, self.gen, self.gan, self.classifier, *self.maps,
                z_size=self.c.z_size, num_features=self.c.num_features,
                group=self.group, steps_per_call=k,
                ema_decay=self.c.ema_decay,
                data_codec=None if self.stream_dedup else self.data_codec,
                chunk_indexed=self.stream_dedup, telemetry=self.c.telemetry)
        return self._step_fns[k]

    # -- the steps -------------------------------------------------------------

    def _z(self) -> torch.Tensor:
        return torch.rand((self.batch_size, self.c.z_size),
                          generator=self.z_gen, device=self.device) * 2 - 1

    def unfused_step(self, z1: Optional[torch.Tensor] = None,
                     z2: Optional[torch.Tensor] = None):
        """One protocol step fit by fit, as the JAX trainer's unfused loop
        runs it (gan_trainer.py:2129-2150) -> (d_loss, g_loss, clf_loss).
        The batch is the fused step's (``steps % n_batches``), and z1 and z2
        come from ``z_gen`` in the fused step's order unless given, so on
        one device this gives the fused step's bits."""
        B = self.batch_size
        off = (self.steps % (self.features.shape[0] // B)) * B
        real, labels = self.features[off:off + B], self.labels[off:off + B]
        fit_dis, fit_gan, fit_clf = self._fits
        dis_to_gan, gan_to_gen, dis_to_classifier = self.maps
        # (1) D-step on [real; G(z1)], the generator in inference mode
        z1 = self._z() if z1 is None else z1
        fake = self.gen.output(z1)[0].reshape(B, self.c.num_features)
        d_loss = fit_dis(torch.cat([real, fake]),
                         torch.cat([self.y_real, self.y_fake]))
        # (2) dis -> gan frozen tail, (3) the G-step, (4) gan -> gen
        M.sync_params(self.gan, self.dis, dis_to_gan)
        z2 = self._z() if z2 is None else z2
        g_loss = fit_gan(z2, self.ones)
        M.sync_params(self.gen, self.gan, gan_to_gen)
        # (5) dis -> classifier, and the classifier on the labeled batch
        M.sync_params(self.classifier, self.dis, dis_to_classifier)
        c_loss = fit_clf(real, labels)
        self.steps += 1
        return d_loss, g_loss, c_loss

    def _call(self, k: int) -> torch.Tensor:
        """Run k steps -> their losses, [k, 3] on the host, and with
        telemetry the block's columns after them (``fused_step.
        pack_outputs``): one polled readback, inside the watchdog's
        ``readback`` region.  ``_in_flight`` marks a call whose state has
        moved past ``steps``."""
        self._in_flight = True
        rows = None
        with self._phase("dispatch"):
            if not self.fused:
                out = torch.stack(self.unfused_step()).reshape(1, 3)
            elif self.graphed is not None:
                rows = self.graphed.launch(k)
                out = self.graphed.losses
            else:
                self.state, o = self.step_fn(k)(
                    self.state, *self._tables(), self.y_real, self.y_fake,
                    self.ones, z_gen=self.z_gen)
                out = fused_step.pack_outputs(o).reshape(k, -1)
        with self._phase("readback"):
            host = torch.from_numpy(device_lib.readback(out))
        if rows is not None:
            host = host[rows]
        if self.fused:
            self.steps += k
        self._in_flight = False
        return host

    def _sync_graphs(self) -> None:
        """Point the four graphs at the current state: clones of a graph's
        static buffers, taken on the compute stream, so that the next
        replay cannot overwrite what a dump or the save reads."""
        if self.fused:
            state = (fused_step.clone_state(self.state)
                     if self.graphed is not None else self.state)
            fused_step.state_to_graphs(state, self.dis, self.gen, self.gan,
                                       self.classifier)

    # -- the loops -------------------------------------------------------------

    def train(self, iterations: Optional[int] = None,
              log: Optional[Callable[[str], None]] = print) -> Dict:
        """Run ``iterations`` protocol steps (default: the config's), K per
        call (the unfused loop: one), with the cadences' dumps, the metrics
        and, with a ``res_path``, the four model zips at the end.  Each call
        ends in one readback of its losses, so a step's time is the call's
        host clock over finished device work, over K.  The loops run behind
        the supervision shell (``train/shell.py``): the preemption guard,
        the run's event recorder (rank 0 writes ``events.jsonl``), the
        watchdog and, with ``metrics_port``, rank 0's exporter (and the
        resource sampler it reports), torn down in reverse on every way
        out."""
        c = self.c
        # rank 0 serves the exporter; its resources block samples this
        # process while the exporter runs
        port = c.metrics_port if self.rank0 else None
        monitor = None
        if port is not None:
            monitor = ResourceMonitor(interval_s=0.5)
            self.registry.observe_resources(monitor.report)
        shell = SupervisionShell(
            self.registry, c.res_path if self.rank0 else None,
            events_enabled=c.events, events_append=c.resume,
            watchdog=c.watchdog, watchdog_deadline_s=c.watchdog_deadline_s,
            watchdog_warmup_s=c.watchdog_warmup_s,
            watchdog_scale=c.watchdog_scale,
            watchdog_min_deadline_s=c.watchdog_min_deadline_s,
            watchdog_on_timeout=self._watchdog_emergency,
            metrics_port=port,
            preempt_signal_nums=self._preempt_signal_nums, log=log)

        def payload() -> Dict:
            self._watchdog, self._preempt_guard = shell.watchdog, shell.guard
            self.metrics_port = shell.metrics_port
            return self._train_impl(iterations, log)

        def expose_recorder(recorder) -> None:
            # readable as soon as it is installed, so a failure in a later
            # set-up stage still has its flight record
            self._events = recorder

        try:
            if monitor is not None:
                monitor.start()
            return shell.run(payload, on_recorder=expose_recorder)
        finally:
            if monitor is not None:
                monitor.stop()
            self._watchdog = self._preempt_guard = None
            self.metrics_port = None

    def _train_impl(self, iterations: Optional[int],
                    log: Optional[Callable[[str], None]]) -> Dict:
        c = self.c
        if iterations is not None and iterations != c.num_iterations:
            if not self.resident:
                raise ValueError("a streamed run's length is fixed at "
                                 "construction (its chunk size divides it)")
            self.c = c = dataclasses.replace(c, num_iterations=iterations)
        if self.resident:
            k = self._resolve_steps_per_call() if self.fused else 1
        else:
            k = self.stream_k
        self._k, self._log, self._times = k, log, []
        self._last = (float("nan"),) * 3
        self._steady = None
        self._dumper = AsyncArtifactWriter(synchronous=not c.async_dumps)
        if self._goodput_used:  # a second train(): a fresh ledger
            self.goodput = GoodputTimer()
        self._goodput_used = True
        workload = self.workload.name if self.workload else "mnist"
        if c.res_path and self.rank0:
            # the run's id, config, versions and topology, which the
            # metrics records and the events carry
            self.run_manifest = write_run_manifest(
                c.res_path, config=c, group=self.group, device=self.device,
                mesh={"data": self.group.world} if self.group else None,
                extra={"workload": workload})
        run_id = (self.run_manifest or {}).get("run_id")
        if self._events is not None:
            self._events.run_id = run_id
        self.registry.run_id = run_id
        events.instant("train.start", step=self.steps, workload=workload)
        # what the constructor met before this run's recorder existed (the
        # JAX trainer meets its data set-up and restore in train())
        events.current().adopt(self._setup_events)
        self._setup_events = events.EventRecorder()
        try:
            with self._dumper:
                if self.resident:
                    self._resident_loop()
                else:
                    chunks = ChunkPrefetchIterator(
                        self._wrap_stream(self.train_iter), k, c.batch_size,
                        prefetch_depth=1, device=self.device,
                        encode_features=(codec_lib.u8x100_encode
                                         if self.data_codec else None),
                        feature_dtype=(np.uint8 if self.data_codec
                                       else np.float32),
                        dedup=self.stream_dedup,
                        start_batch=self.steps % (
                            self.train_iter.num_examples() // c.batch_size),
                        # the u8 table decoded once, on its arrival (JAX
                        # decodes the call's table once a call; this one
                        # never changes in a run)
                        decode_features=(fused_step.decode_u8x100
                                         if self.data_codec else None))
                    self._chunks = chunks
                    try:
                        self._chunked_stream_loop(chunks)
                    finally:
                        chunks.close()
            # an async checkpointer's queued save is durable before the
            # run reports success
            ck_wait = getattr(self.checkpointer, "wait", None)
            if ck_wait is not None:
                with self._phase("checkpoint"):
                    ck_wait()
        except BaseException:
            self.metrics.close()  # what the run logged stays on disk
            raise
        t_end = time.perf_counter()  # every dump written
        self._sync_graphs()
        if c.res_path and self.rank0:
            t0 = time.perf_counter()
            with self._phase("checkpoint"):
                self.save_models()
            self.timings["save_s"] = time.perf_counter() - t0
        with self._phase("readback"):
            self.metrics.close()
        # the ranks' mean breakdown (rank 0 records it), then the
        # run-level record, materialized at once by the closed logger
        goodput = mesh.aggregate_goodput(self.goodput.report(), self.group)
        if self.rank0:
            self.metrics.log_record({"goodput": goodput, "run_id": run_id})
            self.metrics.flush()
        # trips that only the final flush showed still get their action,
        # a rollback of the run's last window included
        self._health_polls()
        events.instant("train.end", step=self.steps)
        times = self._times
        step_s = statistics.median(times) / k if times else float("nan")
        if len(times) > 1:
            # the steady window: every call after the first (which pays the
            # warm-up), with its bookkeeping and dumps
            steady = ((len(times) - 1) * k * c.batch_size
                      / (t_end - self._steady))
        else:
            steady = k * c.batch_size / sum(times) if times else float("nan")
        return {"steps": self.steps, "examples_per_sec": steady,
                "examples_per_sec_includes_compile": len(times) <= 1,
                "d_loss": self._last[0], "g_loss": self._last[1],
                "clf_loss": self._last[2],
                "step_ms_median": step_s * 1e3,
                "img_per_s": self.batch_size / step_s,
                "steps_per_call": k, "graphed": self.graphed is not None,
                "fused": self.fused, "dp_mode": self.dp_mode,
                "ema_decay": self.ema_decay, "resident": self.resident,
                "data_codec": self.data_codec,
                "stream_dedup": self.stream_dedup,
                "link_bytes": self._link_bytes(),
                "device": str(self.device),
                "precision": dataclasses.asdict(backend.config()),
                "world": self.group.world if self.group else 1,
                "backend": self.group.backend if self.group else None,
                "run_id": run_id, "goodput": goodput}

    def _link_bytes(self) -> Optional[Dict[str, int]]:
        """What the streamed tier put on the host link: the dedup table
        (once) and one chunk; None on the resident tier."""
        ch = self._chunks
        if ch is None:
            return None
        return {"table": ch.table_bytes, "per_chunk": ch.chunk_bytes}

    def _next_chunk(self) -> int:
        """Steps until the next artifact boundary or the end of the run,
        capped at K, which must be K: ``resolve_steps_per_call`` aligns K
        with every cadence, the run length and the start step, and a
        partial chunk would desynchronize a streamed chunk's slicing from
        the step counter."""
        c = self.c
        run = min(self._k, c.num_iterations - self.steps)
        for cad in (c.print_every, c.save_every, c.checkpoint_every):
            if cad:
                run = min(run, cad - self.steps % cad)
        if run != self._k:
            raise RuntimeError(f"chunk misalignment: next boundary in "
                               f"{run} steps but K is {self._k}")
        return run

    def _timed_call(self, k: int) -> torch.Tensor:
        t0 = time.perf_counter()
        rows = self._call(k)
        t1 = time.perf_counter()
        self._times.append(t1 - t0)
        if self._steady is None:
            self._steady = t1
        return rows

    def _resident_loop(self) -> None:
        """The device-resident data path: the step slices its own batches
        from the step counter on the device; one call advances a chunk of
        K steps (K divides every boundary, so a call never crosses one)."""
        while self.steps < self.c.num_iterations:
            self._bookkeeping(self._timed_call(self._next_chunk()))

    def _chunked_stream_loop(self, chunks: ChunkPrefetchIterator) -> None:
        """The streaming counterpart: one chunk of K batches copied into the
        static chunk buffer (behind the previous call, on the compute
        stream) and one call of K steps; chunk k+1 is staged meanwhile."""
        while self.steps < self.c.num_iterations:
            run = self._next_chunk()
            with self._phase("data_wait"):
                chunks.next_into(*self._tables())
            rows = self._timed_call(run)
            # the position after the chunk just trained, aligned with the
            # step count: what a checkpoint at this boundary records
            self._iter_state_consumed = chunks.state()
            self._bookkeeping(rows)

    def _bookkeeping(self, rows: torch.Tensor) -> None:
        """One call's heartbeat, log lines and metrics (the JAX trainer's
        per-step record with examples/sec at K 1, one chunk record
        otherwise; the telemetry block's columns in the same records), then
        the cadence triggers at the new step count."""
        if self._watchdog is not None:
            self._watchdog.beat(step=self.steps)
        n = rows.shape[0]
        start = self.steps - n
        losses, tel = fused_step.unpack_rows(rows)
        self._last = tuple(losses[-1])
        log = self._log
        if log is not None:
            ms = self._times[-1] / n * 1e3
            for i, (d, g, cl) in enumerate(losses):
                log(f"step {start + i + 1}: d_loss {d:.6f} g_loss {g:.6f} "
                    f"clf_loss {cl:.6f} ({ms:.3f} ms)")
            for s in range(start - start % 100 + 100, self.steps + 1, 100):
                log(f"Completed Batch {s}!")
        if n == 1:
            d, g, cl = losses[0]
            self.metrics.log_step(self.steps, examples=self.batch_size,
                                  d_loss=d, g_loss=g, classifier_loss=cl,
                                  **{k: v[0] for k, v in tel.items()})
        else:
            d, g, cl = zip(*losses)
            self.metrics.log_chunk(start + 1, n, 0, {
                "d_loss": d, "g_loss": g, "classifier_loss": cl, **tel})
        self._boundary_bookkeeping()

    def _boundary_bookkeeping(self) -> None:
        """The health polls, then the dumps (rank 0), then the checkpoint,
        then the preemption poll, in the JAX trainer's order: a tripped
        alarm whose action is abort or rollback unwinds BEFORE this
        boundary checkpoints the state it just found bad."""
        c = self.c
        if _chaos_step_hook is not None:
            # before this boundary's checkpoint, so the resume comes from
            # an earlier save, as a real loss mid-call leaves it
            _chaos_step_hook(self.steps)
        self._health_polls()
        grid = bool(c.print_every) and self.steps % c.print_every == 0
        preds = bool(c.save_every) and self.steps % c.save_every == 0
        if self.rank0 and (grid or preds):
            with self._phase("eval"):
                self._sync_graphs()
                if grid:
                    with events.span("eval.grid", step=self.steps):
                        self._dump_grid()
                if preds:
                    with events.span("eval.predictions", step=self.steps):
                        self._dump_predictions()
        with self._phase("checkpoint"):
            self._maybe_checkpoint()
        self._maybe_preempt()

    def _phase(self, name: str):
        """The goodput phase ``name`` (JAX ``_phase``), which is also the
        watchdog's region of that name when the watchdog is armed: the
        phases are exactly the trainer's blocking regions (data wait,
        dispatch, readback, checkpoint, eval)."""
        if self._watchdog is None:
            return self.goodput.phase(name)
        stack = contextlib.ExitStack()
        stack.enter_context(self._watchdog.region(name))
        stack.enter_context(self.goodput.phase(name))
        return stack

    def _wd_region(self, name: str):
        """The watchdog's region around a blocking wait that is no goodput
        phase (the ranks' collectives); a no-op without the watchdog."""
        if self._watchdog is not None:
            return self._watchdog.region(name)
        return contextlib.nullcontext()

    def _wrap_stream(self, source):
        """The streamed tier's source behind the resilience wrappers:
        retries of transient ``next``/``reset`` errors and, with a budget,
        the per-record contract (bad rows skipped and charged).  Both
        delegate ``state``/``restore_state``/``features``."""
        c = self.c
        if c.data_retries:
            source = RetryingSource(source, retries=c.data_retries,
                                    backoff_s=c.data_retry_backoff_s,
                                    health=self.data_health, seed=c.seed)
        if self._quarantine is not None:
            source = ValidatingSource(source, self._quarantine,
                                      num_features=c.num_features,
                                      name=f"{c.dataset_name}:train-stream")
        return source

    # -- checkpoints, resume, preemption ---------------------------------------

    def _graphs(self) -> Dict[str, object]:
        return {"dis": self.dis, "gen": self.gen, "gan": self.gan,
                "classifier": self.classifier}

    @property
    def world(self) -> int:
        return self.group.world if self.group is not None else 1

    def _mesh_spec(self) -> Dict:
        return mesh_spec_dict(self.world)

    def _mesh_report(self) -> Dict:
        """The scrape feed of the elastic-world surface: the world's size
        and the reshard accounting (the port forms its world before the
        trainer exists, so it is never "forming")."""
        return {"devices": self.world, "reshard_total": self._reshard_total,
                "reshard_seconds": self._reshard_seconds, "forming": False,
                "ok": True}

    def _iter_state(self) -> Optional[Dict]:
        """The training data's consumed position at this boundary: the
        streamed tier's stash, else (the resident table, which the step
        slices by its counter) the iterator's position for the step count."""
        if self._iter_state_consumed is not None:
            return self._iter_state_consumed
        try:
            return self.train_iter.state_for_step(self.steps)
        except ValueError:
            return None

    def _checkpoint_extra(self) -> Dict:
        """The run state the graphs' params do not carry, under the JAX
        trainer's keys (``soften_real``, ``soften_fake``, ``iter_state``,
        ``ema:{layer}:{name}``), and ``z_gen_state``: the latent
        generator's state (the JAX package derives its latents from the
        step count and needs none)."""
        extra = {"soften_real": self.soften_real,
                 "soften_fake": self.soften_fake}
        st = self._iter_state()
        if st is not None:
            # one process: the bare state; a world packs each rank's
            # boundary cursor (equal in lockstep), so a restore in another
            # world merges instead of guessing
            extra["iter_state"] = json.dumps(
                elastic_lib.pack_iter_state(st, self.world), sort_keys=True)
        ema = getattr(self.gen, "ema_params", None)
        if ema is not None:
            for layer, lp in ema.items():
                for n, v in lp.items():
                    extra[f"ema:{layer}:{n}"] = v
        extra["z_gen_state"] = self.z_gen.get_state()
        return extra

    def _save(self, ck=None) -> str:
        """Rank 0's save of the state at this boundary into ``ck`` (default:
        the run's checkpointer): the graphs are pointed at the state's
        tensors (the graph's static buffers, read by the snapshot's copies
        ahead of the next replay)."""
        if self.fused:
            fused_step.state_to_graphs(self.state, self.dis, self.gen,
                                       self.gan, self.classifier)
        t0 = time.perf_counter()
        path = (ck or self.checkpointer).save(
            self.steps, self._graphs(), extra=self._checkpoint_extra(),
            mesh_spec=self._mesh_spec())
        self.timings.setdefault("checkpoint_s", []).append(
            time.perf_counter() - t0)
        if ck is None:
            self._saved_step = self.steps
        return path

    def _maybe_checkpoint(self) -> None:
        """The cadence save at this boundary.  Rank 0 writes; every rank
        then meets it at a barrier (a synchronous save has committed by
        then; an async one commits before rank 0's run returns, and an
        emergency save is waited for before its barrier).  Under
        ``param_averaging`` the ranks also hold equal params here: the
        unfused loop's ``fit`` averages params and updater state at the end
        of every job (``averaging_frequency`` acts only inside
        ``fit_batches``), as in the JAX package, so rank 0's checkpoint is
        the run's state without a cadence constraint or an extra average."""
        c = self.c
        if not (self.checkpointer and c.checkpoint_every
                and self.steps % c.checkpoint_every == 0):
            return
        if self.rank0:
            # queued dumps first: a resume continues past this step and
            # would never write them again
            self._dumper.flush()
            with events.span("checkpoint.save", step=self.steps):
                self._save()
        if self.group is not None:
            mesh.barrier(self.group)

    def _emergency_checkpoint(self, directory: Optional[str] = None,
                              keep: int = 1) -> Optional[str]:
        """The ONE "state to disk now" path (preemption, the watchdog, the
        alarms' forensic snapshots), durable before this returns: the
        async writer is waited for.  ``directory``: a checkpoint directory
        of its own (``res_path/nan_snapshot``, keeping ``keep``) instead of
        the run's.  When this boundary's cadence save already holds the
        step, that checkpoint is the emergency one (the JAX trainer writes
        the same bytes a second time).  Rank 0 writes; every rank then
        waits until it is committed."""
        path = None
        with events.span("checkpoint.emergency", step=self.steps,
                         directory=directory or "checkpoints"):
            if self.rank0:
                if directory is not None:
                    ck = TrainCheckpointer(directory, keep=keep)
                    path = self._save(ck)
                else:
                    ck = self.checkpointer
                    if ck is None:  # no cadence: land in the usual spot
                        ck = self.checkpointer = TrainCheckpointer(
                            os.path.join(self.c.res_path, "checkpoints"),
                            keep=self.c.checkpoint_keep)
                    if self._saved_step == self.steps:
                        path = os.path.join(ck.directory,
                                            f"ckpt_{self.steps}")
                    else:
                        self._dumper.flush()
                        path = self._save()
                wait = getattr(ck, "wait", None)
                if wait is not None:
                    wait()
            if self.group is not None:
                mesh.barrier(self.group)
        return path

    def _maybe_preempt(self) -> None:
        """Poll the preemption guard at a boundary (the call has been read
        back).  Under a group every rank enters the consensus at every
        boundary, so one signalled rank stops them all at the same step."""
        guard = self._preempt_guard
        if guard is None:
            return
        if self.group is not None:
            with self._wd_region("collective.agree_preemption"):
                any_trig, agreed = mesh.agree_preemption(
                    guard.triggered, self.steps, self.group)
        else:
            any_trig, agreed = guard.triggered, self.steps
        if not any_trig:
            return
        if agreed != self.steps:
            log_.warning("preemption: agreed step %d != local step %d",
                         agreed, self.steps)
        self.metrics.flush()
        with self._phase("checkpoint"):
            path = self._emergency_checkpoint()
        if self.rank0:
            preempt_exit(self.c.res_path, guard, local_step=self.steps,
                         fleet_min_step=agreed, checkpoint=path)
        raise PreemptionError(
            f"preempted at step {self.steps} (rank {self.group.rank}); "
            f"rank 0 holds the emergency checkpoint", step=self.steps)

    def _maybe_resume(self) -> None:
        """With ``resume``: restore the newest verified checkpoint into the
        graphs (every rank reads rank 0's), then the step count, the
        softening, the EMA, the latent generator and the data position.  A
        ``PREEMPTED.json`` marker is consumed; with no checkpoint that
        verifies the run starts from step 0.  A rollback's restore is
        bounded (``_resume_max_step``, strictly before the bad step), and
        the checkpoints above the step it restores are pruned.  The
        constructor resumes, before the shell arms the watchdog, so no
        watchdog region encloses the restore."""
        c = self.c
        if not (c.resume and self.checkpointer is not None):
            return
        marker = os.path.join(c.res_path, MARKER_NAME)
        if self.rank0 and os.path.exists(marker):
            log_.info("resuming a preempted run (consuming %s)", marker)
            os.remove(marker)
        if self.group is not None:
            mesh.barrier(self.group)  # rank 0 has swept the directory
        t0 = time.perf_counter()
        events.instant("mesh.form", step=self.steps, processes=self.world,
                       devices=self.world, mesh_devices=self.world)
        max_step = self._resume_max_step
        try:
            # a checkpoint from another world reshards onto this one
            step, extra = self.checkpointer.restore(
                self._graphs(), max_step=max_step,
                target_mesh=self._mesh_spec())
        except NoVerifiedCheckpointError as e:
            log_.warning("resume requested but %s; starting from step 0", e)
            if max_step is not None:
                # still a rollback: the checkpoints above the bound are
                # poisoned and must not be resumable later
                self._prune_above(max_step)
                self._consume_rollback_restore(0, max_step)
            return
        if max_step is not None:
            # the restore point is committed: drop the poisoned suffix (a
            # later plain restart must never resume into it)
            self._prune_above(step)
            self._consume_rollback_restore(step, max_step)
        info = extra.pop("__reshard__", None)
        if info is not None:
            self._reshard_total += 1
            self._reshard_seconds += float(info["seconds"])
        dev = self.device
        self.steps = step
        self.soften_real = torch.from_numpy(
            np.asarray(extra["soften_real"], np.float32)).to(dev)
        self.soften_fake = torch.from_numpy(
            np.asarray(extra["soften_fake"], np.float32)).to(dev)
        ema: Dict[str, Dict] = {}
        for k, v in extra.items():
            if k.startswith("ema:"):
                _, layer, name = k.split(":", 2)
                ema.setdefault(layer, {})[name] = torch.from_numpy(
                    np.asarray(v)).to(dev)
        if ema:
            # every layer of the generator, the param-less ones empty
            self.gen.ema_params = {layer: ema.get(layer, {})
                                   for layer in self.gen.params}
        if "z_gen_state" in extra:
            self.z_gen.set_state(torch.from_numpy(
                np.asarray(extra["z_gen_state"], np.uint8)))
        else:  # a JAX checkpoint: replay the generator's draws
            advance_latents(self.z_gen, step, self.c.batch_size,
                            self.c.z_size, dev)
        # the data position (the streamed tier reads the iterator; the
        # resident step slices by its counter): the checkpoint's, else the
        # loops' consumption pattern after ``step`` batches, by arithmetic
        raw = extra.get("iter_state")
        rank = self.group.rank if self.group is not None else 0
        self.train_iter.restore_state(
            elastic_lib.unpack_iter_state(json.loads(raw), self.world, rank)
            if raw is not None else self.train_iter.state_for_step(step))
        self.timings["restore_s"] = time.perf_counter() - t0

    def _prune_above(self, step: int) -> None:
        """A rollback's pruning of the checkpoints above ``step``: under a
        group every rank has read its restore point first (a barrier), and
        rank 0 alone deletes, as rank 0 alone writes."""
        if self.group is not None:
            mesh.barrier(self.group)
        if self.rank0:
            self.checkpointer.prune_above(step)

    def _consume_rollback_restore(self, restored_step: int,
                                  max_step: int) -> None:
        """One rollback restore happened: the ``rollback.restore`` marker
        (in the set-up's events, which the run's timeline adopts), the mark
        that has the constructor reseed the latent stream once the restore
        has set it, and the bound cleared — it applied to THIS restore
        only."""
        mgr = self._rollback_mgr
        events.instant("rollback.restore", step=restored_step,
                       bad_step=max_step + 1,
                       rollbacks=getattr(mgr, "total", None),
                       lr_scale=getattr(mgr, "lr_scale", None))
        self._rolled_back = True
        self._resume_max_step = None
        if mgr is not None:
            mgr.restore_before = None

    # -- numerics alarms, rollback, the watchdog's emergency save --------------

    def _health_polls(self) -> None:
        """At a boundary: the ranks' agreement, then the alarms' actions
        and a pending rollback (JAX ``_boundary_bookkeeping``'s order)."""
        self._agree_alarms()
        self._poll_nan_alarm()
        self._poll_divergence()
        self._maybe_rollback()

    def _agree_alarms(self) -> None:
        """Under a group, while an alarm is armed: every rank enters one
        all-reduce at every boundary (as ``_maybe_preempt`` does), which
        hands rank 0's trips (the only observer) to the others, so that
        every rank takes the same action at the same step."""
        nan, div = self._nan_alarm, self._divergence
        if self.group is None or (nan is None and div is None):
            return
        flags = mesh.agree_max(
            [int(bool(nan and nan.tripped)), int((nan and nan.step) or 0),
             int(bool(div and div.tripped)), int((div and div.step) or 0)],
            self.group)
        if nan is not None and flags[0] and not nan.tripped:
            nan.step, nan.record, nan.tripped = flags[1], {}, True
        if div is not None and flags[2] and not div.tripped:
            div.step, div.record, div.tripped = flags[3], {}, True

    def _flight_record(self, directory: Optional[str], reason: str,
                       extra: Dict) -> None:
        """The flight record of ``reason`` into ``directory`` (rank 0, when
        there is a directory)."""
        if directory and self.rank0:
            events.dump_flight_record(directory, reason, extra=extra)

    def _poll_nan_alarm(self) -> None:
        """Apply the configured ``nan_alarm`` action once the alarm has
        seen a bad record.  Detection granularity is the metrics flush
        cadence; no flush is forced here."""
        alarm = self._nan_alarm
        if alarm is None or self._nan_handled or not alarm.tripped:
            return
        self._nan_handled = True
        c = self.c
        run_id = (self.run_manifest or {}).get("run_id", "?")
        msg = (f"NaN alarm: first non-finite telemetry at step "
               f"{alarm.step} (run {run_id})")
        events.instant("alarm.nan", step=alarm.step, action=c.nan_alarm)
        if c.nan_alarm == "abort":
            # fatal in the recovery wrapper: this dump is the timeline the
            # post-mortem gets
            self._flight_record(c.res_path, "nan_alarm", {"step": alarm.step})
            raise NanAlarmError(msg)
        log_.warning("%s", msg)
        if c.nan_alarm == "snapshot":
            # a forensic checkpoint of the state as of the last call,
            # through the one emergency path, in a directory of its own
            snap = os.path.join(c.res_path, "nan_snapshot")
            with self._phase("checkpoint"):
                self._emergency_checkpoint(directory=snap, keep=1)
            self._flight_record(snap, "nan_alarm", {"step": alarm.step})
        elif c.nan_alarm == "rollback":
            # the params went non-finite AT alarm.step: restore before it
            self._request_rollback(msg, alarm.step)

    def _request_rollback(self, reason: str, bad_step) -> None:
        """Record a rollback request for ``_maybe_rollback``.  When both
        alarms trip in one detection window the EARLIER bad step wins:
        restoring inside the later alarm's window could land on a
        checkpoint the earlier alarm already condemned."""
        if bad_step is None:
            bad_step = self.steps
        pending = self._rollback_pending
        if pending is not None and pending[1] <= bad_step:
            return  # the existing request already bounds tighter
        self._rollback_pending = (reason, bad_step)

    def _poll_divergence(self) -> None:
        """Apply the configured action once the divergence sentinel has
        tripped (``nan_alarm``'s vocabulary, warn when it is None): abort
        raises ``DivergenceError``, fatal in the recovery wrapper; rollback
        heals."""
        sentinel = self._divergence
        if sentinel is None or self._div_handled or not sentinel.tripped:
            return
        self._div_handled = True
        c = self.c
        action = c.nan_alarm or "warn"
        run_id = (self.run_manifest or {}).get("run_id", "?")
        msg = (sentinel.describe() if sentinel.key is not None
               else f"divergence: rank 0's sentinel tripped at step "
                    f"{sentinel.step}") + f" (run {run_id})"
        events.instant("alarm.divergence", step=sentinel.step,
                       key=sentinel.key, value=sentinel.value,
                       baseline=sentinel.baseline, action=action)
        if action == "abort":
            self._flight_record(c.res_path, "divergence",
                                {"step": sentinel.step, "key": sentinel.key})
            raise DivergenceError(msg)
        log_.warning("%s", msg)
        if action == "snapshot":
            snap = os.path.join(c.res_path, "divergence_snapshot")
            with self._phase("checkpoint"):
                self._emergency_checkpoint(directory=snap, keep=1)
            self._flight_record(snap, "divergence",
                                {"step": sentinel.step, "key": sentinel.key})
        elif action == "rollback":
            self._request_rollback(msg, sentinel.step)

    def _maybe_rollback(self) -> None:
        """Take a pending rollback request: charge the manager's
        (progress-aware) budget, leave the timeline behind, and unwind
        through ``RollbackRequested`` — or ``RollbackError`` once the
        budget is exhausted (fatal in the recovery wrapper).  Under a group
        every rank takes the request at the same boundary (the alarms are
        agreed) and charges its own manager; the ranks then agree that
        their budgets are equal, so that every rank heals, or fails, at
        once."""
        mgr, pending = self._rollback_mgr, self._rollback_pending
        if mgr is None or pending is None:
            return
        reason, bad_step = pending
        self._rollback_pending = None
        ok = mgr.request(self.steps, reason, bad_step=bad_step)
        if self.group is not None:
            self._agree_budget(mgr)
        events.instant("rollback.request", step=self.steps,
                       bad_step=bad_step, rollbacks=mgr.total,
                       attempts=mgr.attempts, lr_scale=mgr.lr_scale,
                       reason=reason)
        self._flight_record(self.c.res_path, "rollback", {
            "step": self.steps, "bad_step": bad_step, "rollbacks": mgr.total,
            "reason": reason})
        if not ok:
            raise RollbackError(
                f"rollback budget exhausted ({mgr.attempts - 1}/"
                f"{mgr.max_rollbacks} at step {self.steps} without "
                f"progress): {reason}")
        raise RollbackRequested(
            f"rollback #{mgr.total} at step {self.steps}: {reason}",
            step=self.steps, rollbacks=mgr.total)

    def _agree_budget(self, mgr: RollbackManager) -> None:
        """Every rank's manager holds the same (total, attempts) after a
        charge, or the world fails: ranks with different budgets would
        heal with different learning rates and latent lineages."""
        got = [mgr.total, mgr.attempts]
        agreed = mesh.agree_max(got + [-v for v in got], self.group)
        if agreed[:2] != [-v for v in agreed[2:]]:
            raise RollbackError(
                f"the ranks' rollback budgets disagree at step {self.steps}: "
                f"(total, attempts) from {[-v for v in agreed[2:]]} to "
                f"{agreed[:2]}, this rank {got}")

    def _watchdog_emergency(self) -> None:
        """The watchdog's ``on_timeout`` (its sacrificial thread, bounded
        join): a best-effort emergency checkpoint at the last boundary.
        On a data hang the device is idle and this commits a resume point
        at the stall step; on a device hang it blocks on the same hang and
        is abandoned.  Skipped mid-call (the state is past ``steps``: the
        restart falls back to the last periodic checkpoint), without a
        ``res_path``, and under a group (a barrier from this thread could
        meet no other rank)."""
        if self._in_flight or not self.c.res_path or self.group is not None:
            log_.warning("watchdog: no emergency checkpoint (%s); the "
                         "restart resumes from the last periodic one",
                         "a call is in flight" if self._in_flight else
                         "no res_path" if not self.c.res_path else
                         "a data-parallel rank")
            return
        self._emergency_checkpoint()

    # -- artifact dumps --------------------------------------------------------

    def _submit_dump(self, kind: str, files: List, t0: float) -> None:
        """Start the copies to host of ``files`` (``[(path, tensor)]``)
        behind one event and hand their CSV writes to the writer, which
        waits for the event first.  Records the host seconds: enqueue (this
        thread), readback wait and write (the writer)."""
        hosts, event = host_copy([out for _, out in files])
        rec = {"kind": kind, "step": self.steps,
               "enqueue_s": time.perf_counter() - t0}
        self.timings["dumps"].append(rec)

        def write():
            t1 = time.perf_counter()
            device_lib.wait_event(event)
            t2 = time.perf_counter()
            for (path, _), host in zip(files, hosts):
                write_csv_matrix(path, host.numpy())
            rec["readback_s"], rec["write_s"] = t2 - t1, time.perf_counter() - t2

        self._dumper.submit(write)

    def _dump_grid(self) -> None:
        """The generator over the latent grid, inference mode ->
        ``<dataset>_out_<step>.csv``, and the workload's extra files of
        that grid (``Workload.grid_extra_arrays``)."""
        t0 = time.perf_counter()
        c = self.c
        out = self.gen.output(self.z_grid)[0].reshape(
            self.z_grid.shape[0], c.num_features)
        extras = (self.workload.grid_extra_arrays(self, out, self.steps)
                  if self.workload is not None else [])
        self._submit_dump("grid", [(os.path.join(
            c.res_path, f"{c.dataset_name}_out_{self.steps}.csv"), out),
            *extras], t0)

    def _dump_predictions(self) -> None:
        """The classifier over the test set, inference mode ->
        ``<dataset>_test_predictions_<step>.csv``.  The test set moves to
        the device once, as one tensor when it fits 256 MiB (one forward
        per dump, as in the JAX trainer)."""
        t0 = time.perf_counter()
        c = self.c
        if self._test_x is None:
            it = self.test_iter
            it.reset()
            batches = []
            while it.has_next():
                batches.append(it.next().features)
            if len(batches) > 1 and sum(b.nbytes for b in batches) <= 256 << 20:
                batches = [np.concatenate(batches)]
            self._test_x = [torch.from_numpy(b).to(self.device)
                            for b in batches]
        outs = [self.classifier.output(x)[0] for x in self._test_x]
        self._submit_dump("predictions", [(os.path.join(
            c.res_path, f"{c.dataset_name}_test_predictions_{self.steps}.csv"),
            torch.cat(outs) if len(outs) > 1 else outs[0])], t0)

    # -- models ----------------------------------------------------------------

    def model_paths(self) -> Dict[str, str]:
        """The four model zips' paths (the reference's file names)."""
        c = self.c
        clf = (self.workload.classifier_model_name if self.workload
               else "CV")
        return {g: os.path.join(c.res_path, f"{c.dataset_name}_{n}_model.zip")
                for g, n in (("dis", "dis"), ("gan", "gan"), ("gen", "gen"),
                             ("classifier", clf))}

    def save_models(self) -> None:
        """The end-of-run model zips, the reference's four files."""
        for g, path in self.model_paths().items():
            serialization.write_model(getattr(self, g), path)

    def sample_grid(self, n: int = 10) -> torch.Tensor:
        """Generator output over the n x n latent grid, inference mode."""
        z = torch.from_numpy(latent_grid(n, self.c.z_size)).to(self.device)
        return self.gen.output(z)[0]
