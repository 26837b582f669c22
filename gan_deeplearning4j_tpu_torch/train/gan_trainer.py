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
    divide every cadence, as ``resolve_steps_per_call`` makes it).
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
The watchdog, the divergence sentinel, rollback and telemetry are not
ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

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
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.parallel.data_parallel import DataParallelGraph
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.train import fused_step
from gan_deeplearning4j_tpu_torch.train.preemption import (
    MARKER_NAME,
    PreemptionError,
    PreemptionGuard,
    parse_signals,
    preempt_exit,
)
from gan_deeplearning4j_tpu_torch.utils.async_dump import (
    AsyncArtifactWriter,
    host_copy,
)
from gan_deeplearning4j_tpu_torch.utils.metrics import MetricsLogger

log_ = logging.getLogger(__name__)

DP_MODES = ("gradient_sync", "param_averaging")


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
    dp_mode: str = "gradient_sync"
    averaging_frequency: int = 1
    fused: bool = True
    # None = auto: resident when the table fits data_on_device_max_bytes
    data_on_device: Optional[bool] = None
    data_on_device_max_bytes: int = 2 << 30
    steps_per_call: Optional[int] = None  # the cap on K (None = 100)
    # streaming: the byte budget of one chunk (bounds K); 0 = K 1
    stream_chunk_bytes: int = 256 << 20
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
                      device=None) -> int:
    """The data-parallel world for ``n_devices``: None = every attached
    card (one rank on the CPU), reduced with a warning to the largest
    divisor of the batch; an explicit count must divide the batch and, on
    the card, not exceed the attached cards."""
    dev = backend.resolve_device(device)
    attached = torch.cuda.device_count() if dev.type == "cuda" else None
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
        raise ValueError(f"n_devices {n_devices} exceeds the {attached} "
                         "attached cards")
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
# budget): re-raised at once
FATAL_CLASSES = (ValueError, TypeError, CheckpointCorruptError,
                 DataQuarantineError)


def _recover(run_once: Callable[[bool], Dict], failure_step: Callable,
             is_fatal: Callable[[BaseException], bool], cleanup: Callable,
             max_restarts: int, log: Optional[Callable[[str], None]],
             backoff_base_s: float, backoff_max_s: float) -> Dict:
    """The restart loop both recovery wrappers share: ``run_once(resume)``
    until it returns; ``PreemptionError`` and the fatal class re-raise;
    anything else is retried after ``cleanup(e)``, with resume, backoff
    ``backoff_base_s * 2^n`` (capped) and jitter x[0.5, 1.5), while the
    progress-aware budget lasts: a failure at a later ``failure_step(e)``
    than the previous one resets it."""
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
            step = int(failure_step(e) or 0)
            if last_failure_step is not None and step > last_failure_step:
                attempt = 0  # progress since the last failure
            last_failure_step = step
            attempt += 1
            resume_next = True
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
      same failure);
    * ``PreemptionError`` is re-raised: the emergency checkpoint is on disk
      and the scheduler restarts the job (the mains exit 75);
    * everything else is retried, with backoff ``backoff_base_s * 2^n``
      (capped) and jitter x[0.5, 1.5).  The budget is progress-aware: a
      failure at a later step than the previous one resets it.

    The failed incarnation's checkpointer is quiesced (an async save in
    flight becomes durable, its worker is reaped) before the next trainer
    is built.  The JAX wrapper's further classes (watchdog timeouts,
    rollback requests, NaN alarms, divergence) come with the next slice
    and are not caught here.  A data-parallel world recovers as a whole
    (``spawn_with_recovery``): its ranks run without this wrapper."""
    box: Dict = {}

    def run_once(resume: bool) -> Dict:
        box["trainer"] = None
        box["trainer"] = make_trainer(resume)
        return box["trainer"].train(log=log)

    def quiesce_checkpointer(e) -> None:
        ck_close = getattr(getattr(box["trainer"], "checkpointer", None),
                           "close", None)
        if ck_close is not None:
            try:
                ck_close()
            except Exception as ce:
                if log is not None:
                    log(f"checkpoint writer failed during restart quiesce "
                        f"({ce!r}); the restart falls back to the previous "
                        "verified checkpoint")

    return _recover(run_once,
                    lambda e: getattr(box["trainer"], "steps", 0),
                    lambda e: isinstance(e, FATAL_CLASSES),
                    quiesce_checkpointer, max_restarts, log,
                    backoff_base_s, backoff_max_s)


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


def check_recovery_args(parser, args) -> None:
    """The mains' validation of the recovery flags."""
    if args.max_restarts > 0 and args.checkpoint_every <= 0:
        parser.error("--max-restarts needs --checkpoint-every (without "
                     "checkpoints every restart replays from step 0)")


def run_with_recovery(make_trainer: Callable[[bool], "GANTrainer"],
                      max_restarts: int = 0,
                      log: Optional[Callable[[str], None]] = print
                      ) -> Tuple["GANTrainer", Dict]:
    """The mains' wiring: ``make_trainer(resume)`` builds a trainer (with
    ``resume`` forced on for a restart) and it trains, under
    ``train_with_recovery`` when ``max_restarts`` > 0 -> (the last trainer,
    its result)."""
    holder = {}

    def make(resume: bool) -> "GANTrainer":
        holder["trainer"] = make_trainer(resume)
        return holder["trainer"]

    if max_restarts > 0:
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
    extras)."""

    def __init__(self, cfg: M.CVConfig = M.CVConfig(), batch_size: int = 200,
                 n_train: int = 60000, device=None,
                 group: Optional[mesh.DataGroup] = None,
                 steps_per_call: Optional[int] = None, ema_decay: float = 0.0,
                 fused: bool = True, dp_mode: str = "gradient_sync",
                 averaging_frequency: int = 1, *,
                 config: Optional[GANTrainerConfig] = None,
                 workload: Optional[Workload] = None):
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
        if group is not None:
            device = group.device
        self.device = dev = backend.resolve_device(device)
        self.group = group
        self.rank0 = group is None or group.rank == 0
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
        if workload is not None:
            t0 = time.perf_counter()
            train_csv, test_csv = workload.ensure_data(c.res_path)
            self.timings["csv_ready_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            train_iter = RecordReaderDataSetIterator(
                train_csv, B, c.label_index, c.num_classes, **iter_kw)
            test_iter = RecordReaderDataSetIterator(
                test_csv, c.batch_size_pred, c.label_index, c.num_classes,
                **iter_kw)
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
        self._maybe_resume()
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
        t0 = time.perf_counter()
        if resident:
            feats = train_iter.features
            if codec:
                feats = codec_lib.u8x100_encode(feats)
            self.features = torch.from_numpy(feats).to(dev)
            self.labels = torch.from_numpy(train_iter.labels).to(dev)
            self.stream_k = None
        else:
            # the static chunk buffers the step reads; each call's chunk is
            # copied in (``_chunked_stream_loop``)
            self.stream_k = self._resolve_steps_per_call(
                byte_cap=c.stream_chunk_bytes, codec=codec)
            rows = self.stream_k * B
            self.features = torch.zeros(
                (rows, c.num_features), device=dev,
                dtype=torch.uint8 if codec else torch.float32)
            self.labels = torch.zeros((rows, c.num_classes), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
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
                self.graphed = fused_step.GraphedStep(
                    self.step_fn(1), self.state, self.features, self.labels,
                    self.y_real, self.y_fake, self.ones, z_gen=self.z_gen,
                    ring=c.steps_per_call or fused_step.MAX_STEPS_PER_CALL)
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
        self.metrics = MetricsLogger(metrics_path, append=c.resume)
        self._preempt_guard: Optional[PreemptionGuard] = None
        # inline until train() swaps in the background writer, so the dump
        # methods also work when called directly
        self._dumper = AsyncArtifactWriter(synchronous=True)

    # -- configuration ---------------------------------------------------------

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
                ema_decay=self.c.ema_decay, data_codec=self.data_codec)
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
        """Run k steps -> their losses, [k, 3] on the host (one readback)."""
        if not self.fused:
            return torch.stack(self.unfused_step()).reshape(1, 3).cpu()
        if self.graphed is not None:
            out = self.graphed(k)
        else:
            self.state, losses = self.step_fn(k)(
                self.state, self.features, self.labels, self.y_real,
                self.y_fake, self.ones, z_gen=self.z_gen)
            out = torch.stack(losses, -1).reshape(k, 3).cpu()
        self.steps += k
        return out

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
        host clock over finished device work, over K."""
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
        # the preemption guard brackets the loops (main thread only); its
        # handlers are restored on every way out
        if self._preempt_signal_nums:
            self._preempt_guard = PreemptionGuard(
                self._preempt_signal_nums).install()
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
                                       else np.float32))
                    try:
                        self._chunked_stream_loop(chunks)
                    finally:
                        chunks.close()
            # an async checkpointer's queued save is durable before the
            # run reports success
            ck_wait = getattr(self.checkpointer, "wait", None)
            if ck_wait is not None:
                ck_wait()
        except BaseException:
            self.metrics.close()  # what the run logged stays on disk
            raise
        finally:
            if self._preempt_guard is not None:
                self._preempt_guard.uninstall()
                self._preempt_guard = None
        t_end = time.perf_counter()  # every dump written
        self._sync_graphs()
        if c.res_path and self.rank0:
            t0 = time.perf_counter()
            self.save_models()
            self.timings["save_s"] = time.perf_counter() - t0
        self.metrics.close()
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
                "device": str(self.device),
                "precision": dataclasses.asdict(backend.config()),
                "world": self.group.world if self.group else 1,
                "backend": self.group.backend if self.group else None}

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
            chunks.next_into(self.features, self.labels)
            rows = self._timed_call(run)
            # the position after the chunk just trained, aligned with the
            # step count: what a checkpoint at this boundary records
            self._iter_state_consumed = chunks.state()
            self._bookkeeping(rows)

    def _bookkeeping(self, rows: torch.Tensor) -> None:
        """One call's log lines and metrics (the JAX trainer's per-step
        record with examples/sec at K 1, one chunk record otherwise), then
        the cadence triggers at the new step count."""
        n = rows.shape[0]
        start = self.steps - n
        losses = rows.tolist()
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
                                  d_loss=d, g_loss=g, classifier_loss=cl)
        else:
            d, g, cl = zip(*losses)
            self.metrics.log_chunk(start + 1, n, 0, {
                "d_loss": d, "g_loss": g, "classifier_loss": cl})
        self._boundary_bookkeeping()

    def _boundary_bookkeeping(self) -> None:
        """The dumps (rank 0), then the checkpoint, then the preemption
        poll, in the JAX trainer's order."""
        c = self.c
        grid = bool(c.print_every) and self.steps % c.print_every == 0
        preds = bool(c.save_every) and self.steps % c.save_every == 0
        if self.rank0 and (grid or preds):
            self._sync_graphs()
            if grid:
                self._dump_grid()
            if preds:
                self._dump_predictions()
        self._maybe_checkpoint()
        self._maybe_preempt()

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

    def _mesh_spec(self) -> Dict:
        return mesh_spec_dict(self.group.world if self.group else 1)

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
            extra["iter_state"] = json.dumps(st, sort_keys=True)
        ema = getattr(self.gen, "ema_params", None)
        if ema is not None:
            for layer, lp in ema.items():
                for n, v in lp.items():
                    extra[f"ema:{layer}:{n}"] = v
        extra["z_gen_state"] = self.z_gen.get_state()
        return extra

    def _save(self) -> str:
        """Rank 0's save of the state at this boundary: the graphs are
        pointed at the state's tensors (the graph's static buffers, read
        by the snapshot's copies ahead of the next replay)."""
        if self.fused:
            fused_step.state_to_graphs(self.state, self.dis, self.gen,
                                       self.gan, self.classifier)
        t0 = time.perf_counter()
        path = self.checkpointer.save(self.steps, self._graphs(),
                                      extra=self._checkpoint_extra(),
                                      mesh_spec=self._mesh_spec())
        self.timings.setdefault("checkpoint_s", []).append(
            time.perf_counter() - t0)
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
            self._save()
        if self.group is not None:
            mesh.barrier(self.group)

    def _emergency_checkpoint(self) -> Optional[str]:
        """The state to disk now (rank 0), durable before this returns:
        the async writer is waited for.  When this boundary's cadence save
        already holds the step, that checkpoint is the emergency one (the
        JAX trainer writes the same bytes a second time).  Every rank then
        waits until it is committed."""
        path = None
        if self.rank0:
            ck = self.checkpointer
            if self._saved_step == self.steps:
                path = os.path.join(ck.directory, f"ckpt_{self.steps}")
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
            any_trig, agreed = mesh.agree_preemption(guard.triggered,
                                                     self.steps, self.group)
        else:
            any_trig, agreed = guard.triggered, self.steps
        if not any_trig:
            return
        if agreed != self.steps:
            log_.warning("preemption: agreed step %d != local step %d",
                         agreed, self.steps)
        self.metrics.flush()
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
        verifies the run starts from step 0."""
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
        try:
            step, extra = self.checkpointer.restore(
                self._graphs(), mesh_spec=self._mesh_spec())
        except NoVerifiedCheckpointError as e:
            log_.warning("resume requested but %s; starting from step 0", e)
            return
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
        self.train_iter.restore_state(json.loads(raw) if raw is not None
                                      else self.train_iter.state_for_step(step))
        self.timings["restore_s"] = time.perf_counter() - t0

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
            if event is not None:
                event.synchronize()
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
