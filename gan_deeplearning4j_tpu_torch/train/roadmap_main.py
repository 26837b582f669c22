"""Roadmap model-family trainer (torch twin of ``gan_deeplearning4j_tpu/
train/roadmap_main.py``, the families ``celeba``, ``wgan-gp`` and
``cgan-cifar10``) on the two-graph ``GANPair`` engine.

Run: ``python -m gan_deeplearning4j_tpu_torch.train.roadmap_main --family
celeba --res-path outputs/celeba_torch`` (on the card; ``--device cpu``
runs the plain torch versions).

The data is the JAX package's synthetic surrogate, resident on the device:
``synthetic_celeba`` (64x64x3 in [-1, 1]), ``synthetic_mnist`` (28x28x1
in [0, 1], for wgan-gp's sigmoid head) or, for the conditional family,
``synthetic_cifar10`` in its calibrated tier (32x32x3 in [-1, 1]) with its
one-hot labels resident beside it.  K iterations run per call, K the
largest divisor of gcd(iterations, print_every, 100[, checkpoint_every][,
start iteration]) up to ``MAX_STEPS_PER_CALL`` (or ``--steps-per-call``);
on one card a call replays a CUDA graph of one iteration K times (every
family: wgan-gp's double backward and cgan-cifar10's label gather record
like the rest).  Written to ``--res-path``:
  - ``{family}_samples_{it}.png`` every ``print_every`` iterations and at
    the end (an 8x8 grid from a fixed U[-1, 1) latent batch), and
    ``{family}_samples_ema.png`` from the EMA generator, on the background
    artifact writer (cgan-cifar10's grid is conditioned on the labels
    ``arange(64) % K``: each row of the grid cycles through the classes);
  - ``{family}_metrics.jsonl``, one record per iteration (``step``,
    ``wall_s``, ``step_s``, ``d_loss``, ``g_loss``);
  - ``{family}_{gen,dis}_model.zip`` and, with ``--ema-decay``,
    ``{family}_gen_ema_model.zip`` without its updater;
  - with ``--checkpoint-every`` / ``--preempt-signal``, checkpoints in
    ``{family}_ckpt/``: the two graphs, the EMA (``extra["ema"]``) and the
    latent generator's state (``z_gen_state``: the port's draws are
    sequential, the JAX package's counter-based).
Then one JSON line: ``family``, ``steps``, ``d_loss``, ``g_loss``,
``examples_per_sec`` (batch * (n_critic + 1) per iteration over the
steady window, every call after the first), ``host_seconds``, the run's
``graphed``, ``steps_per_call`` and ``device``, and ``port_launches``: each
port kernel's launches from the capture's warm-up iteration to the last
iteration (0 on the CPU, where the plain versions run).  cgan-cifar10
adds, with ``--fidelity-steps`` > 0, ``conditional_fidelity``,
``fidelity_per_class``, ``probe_train_acc`` (``eval/conditional.py``)
and, when every class has at least 50 rows, ``per_class_fid``,
``mean_class_fid`` and ``diversity_ratio`` in the frozen CIFAR space;
with ``--ema-decay`` also ``conditional_fidelity_ema``,
``mean_class_fid_ema`` and ``diversity_ratio_ema``.  A preempted run
exits 75.

``--bf16`` and ``--mp`` set the precision policy (``runtime/backend.py``)
for the whole run, the evaluation included.  Not ported yet (each raises
``NotImplementedError`` naming its ROADMAP item): ``--n-devices`` > 1,
``--data-dir``, ``--profile`` and ``--metrics-port``; the JAX run's
``events.jsonl``, ``run_manifest.json`` and goodput record are left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.checkpoint import (
    AsyncCheckpointer,
    NoVerifiedCheckpointError,
    TrainCheckpointer,
)
from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import mesh_spec_dict
from gan_deeplearning4j_tpu_torch.eval.plots import save_rgb_grid_png
from gan_deeplearning4j_tpu_torch.graph import serialization
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.train import fused_step
from gan_deeplearning4j_tpu_torch.train.gan_pair import GANPair
from gan_deeplearning4j_tpu_torch.train.preemption import (
    EXIT_PREEMPTED,
    MARKER_NAME,
    PreemptionError,
    PreemptionGuard,
    preempt_exit,
)
from gan_deeplearning4j_tpu_torch.utils.async_dump import (
    AsyncArtifactWriter,
    host_copy,
)
from gan_deeplearning4j_tpu_torch.utils.metrics import MetricsLogger

FAMILIES = ("cgan-cifar10", "wgan-gp", "celeba")
DEFAULT_BATCH_SIZE = 128
# the conditional family's class-metrics gate: every class needs this many
# real rows (a covariance over fewer samples is degenerate, not a metric)
MIN_CLASS_ROWS = 50

SAMPLE_SHAPES = {
    "cgan-cifar10": (3, 32, 32),
    "wgan-gp": (1, 28, 28),
    "celeba": (3, 64, 64),
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; choose from {FAMILIES}")


def _build(family: str, device=None, lr_decay_steps: Optional[int] = None,
           ms_weight: float = 0.0):
    """-> (pair, config, sample shape (C, H, W)) on ``device``."""
    import dataclasses

    _check_family(family)
    if lr_decay_steps is not None and lr_decay_steps <= 0:
        raise ValueError(f"--lr-decay-steps must be positive, "
                         f"got {lr_decay_steps}")
    if lr_decay_steps and family == "wgan-gp":
        raise ValueError("--lr-decay-steps is wired for cgan-cifar10 and "
                         "celeba only")
    if ms_weight and family == "wgan-gp":
        raise ValueError("--ms-weight is wired for cgan-cifar10 and celeba "
                         "only")
    if family == "wgan-gp":
        from gan_deeplearning4j_tpu_torch.models import wgan_gp as M

        cfg = M.WGANGPConfig()
        pair = GANPair(M.build_generator(cfg, device),
                       M.build_critic(cfg, device), mode="wgan-gp",
                       gp_weight=cfg.gp_weight)
        return pair, cfg, (cfg.channels, cfg.height, cfg.width)
    if family == "cgan-cifar10":
        from gan_deeplearning4j_tpu_torch.models import cgan_cifar10 as M

        cfg = M.CGANConfig()
    else:
        from gan_deeplearning4j_tpu_torch.models import dcgan_celeba as M

        cfg = M.CelebAConfig()
    if lr_decay_steps:
        cfg = dataclasses.replace(cfg, decay_steps=lr_decay_steps)
    if ms_weight:
        cfg = dataclasses.replace(cfg, ms_weight=ms_weight)
    pair = GANPair(M.build_generator(cfg, device),
                   M.build_discriminator(cfg, device), ms_weight=cfg.ms_weight)
    return pair, cfg, (cfg.channels, cfg.height, cfg.width)


def _data(family: str, n: int, seed: int):
    """(features [n, C*H*W] f32, one-hot labels [n, 10] f32 or None): tanh
    range, except wgan-gp's [0, 1]; labels for cgan-cifar10 only (its
    calibrated tier, whose ambiguous tail keeps the probe's Bayes ceiling
    below 1)."""
    from gan_deeplearning4j_tpu_torch.data import datasets

    if family == "cgan-cifar10":
        x, y = datasets.synthetic_cifar10(n, seed=seed,
                                          difficulty="calibrated")
        return x, np.eye(10, dtype=np.float32)[y]
    if family == "wgan-gp":
        x, _ = datasets.synthetic_mnist(n, seed=seed)
        return x.astype(np.float32), None
    return datasets.synthetic_celeba(n, seed=seed), None


def steps_per_call(iterations: int, print_every: int, checkpoint_every: int,
                   start_it: int, cap: Optional[int]) -> int:
    """The JAX chunk rule: the largest divisor of gcd(iterations,
    print_every, 100[, checkpoint_every][, start_it]) at most ``cap``
    (default ``MAX_STEPS_PER_CALL``)."""
    g = math.gcd(math.gcd(iterations, print_every), 100)
    if checkpoint_every:
        g = math.gcd(g, checkpoint_every)  # chunks end on checkpoint points
    if start_it:
        g = math.gcd(g, start_it)  # and tile [start_it, iterations]
    cap = min(fused_step.MAX_STEPS_PER_CALL,
              cap or fused_step.MAX_STEPS_PER_CALL)
    return max(d for d in range(1, min(cap, g) + 1) if g % d == 0)


def advance_draws(pair: GANPair, z_gen: torch.Generator, iterations: int,
                  n_rows: int, batch_size: int, n_critic: int,
                  z_size: int) -> None:
    """Put ``z_gen`` where ``iterations`` iterations leave it (a checkpoint
    without ``z_gen_state``, one the JAX package wrote)."""
    for _ in range(iterations):
        pair.draw(z_gen, n_rows, batch_size, n_critic, z_size,
                  pair.device)


def train(family: str, iterations: int, batch_size: int, res_path: str,
          n_train: int, print_every: int, device=None,
          ema_decay: float = 0.0, checkpoint_every: int = 0,
          checkpoint_keep: int = 3, resume: bool = False,
          steps_per_call_cap: Optional[int] = None,
          lr_decay_steps: Optional[int] = None, ms_weight: float = 0.0,
          fidelity_steps: int = 400, async_checkpoint: bool = False,
          preempt_signals: Optional[str] = None,
          log: Optional[Callable[[str], None]] = print) -> Dict:
    """Train one roadmap family end to end -> the result dict (the JSON
    line).  Raises ``PreemptionError`` after an emergency checkpoint."""
    _check_family(family)
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
    log = log or (lambda s: None)
    guard = PreemptionGuard(preempt_signals) if preempt_signals else None
    os.makedirs(res_path, exist_ok=True)
    if guard is not None:
        guard.install()
    try:
        return _train_impl(family, iterations, batch_size, res_path, n_train,
                           print_every, device, ema_decay, checkpoint_every,
                           checkpoint_keep, resume, steps_per_call_cap,
                           lr_decay_steps, ms_weight, fidelity_steps,
                           async_checkpoint, guard, log)
    finally:
        if guard is not None:
            guard.uninstall()


def _train_impl(family, iterations, batch_size, res_path, n_train,
                print_every, device, ema_decay, checkpoint_every,
                checkpoint_keep, resume, cap, lr_decay_steps, ms_weight,
                fidelity_steps, async_checkpoint, guard, log) -> Dict:
    dev = backend.resolve_device(device)
    host: Dict = {}
    t0 = time.perf_counter()
    x, y = _data(family, n_train, prng.NUMBER_OF_THE_BEAST)
    host["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pair, cfg, sample_shape = _build(family, dev, lr_decay_steps, ms_weight)
    host["build_s"] = time.perf_counter() - t0
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
    z_gen = prng.generator(cfg.seed, "roadmap-z", dev)
    # the fixed 8x8 evaluation grid, from the training latent law U[-1, 1)
    z_eval = (torch.rand((64, cfg.z_size),
                         generator=prng.generator(cfg.seed, "eval-z")) * 2
              - 1).to(dev)
    # a conditional grid cycles through the classes along each row
    eval_in = [z_eval] if y is None else [z_eval, torch.from_numpy(
        np.eye(y.shape[1], dtype=np.float32)[np.arange(64) % y.shape[1]]
    ).to(dev)]
    vrange = (0.0, 1.0) if family == "wgan-gp" else (-1.0, 1.0)

    ckpt = None
    start_it = 0
    spec = mesh_spec_dict(1)
    if checkpoint_every or resume or guard is not None:
        ckpt = TrainCheckpointer(os.path.join(res_path, f"{family}_ckpt"),
                                 keep=checkpoint_keep)
        if async_checkpoint:
            ckpt = AsyncCheckpointer(ckpt)
    if resume and ckpt is not None:
        marker = os.path.join(res_path, MARKER_NAME)
        if os.path.exists(marker):
            log(f"[{family}] resuming a preempted run (consuming {marker})")
            os.remove(marker)
        t0 = time.perf_counter()
        try:
            start_it, extra = ckpt.restore({"gen": pair.gen, "dis": pair.dis},
                                           mesh_spec=spec)
        except NoVerifiedCheckpointError:
            start_it, extra = 0, {}
            log(f"[{family}] resume requested but no verified checkpoint; "
                "starting from iteration 0")
        if "ema" in extra:
            if not ema_decay:
                raise ValueError(
                    "checkpoint carries a generator EMA but --ema-decay is "
                    "0: pass the original decay")
            pair.gen.ema_params = {
                layer: {n: torch.from_numpy(np.asarray(v)).to(dev)
                        for n, v in extra["ema"].get(layer, {}).items()}
                for layer in pair.gen.params}
        if "z_gen_state" in extra:
            z_gen.set_state(torch.from_numpy(
                np.asarray(extra["z_gen_state"], np.uint8)))
        elif start_it:
            advance_draws(pair, z_gen, start_it, x.shape[0], batch_size,
                          n_critic, cfg.z_size)
        host["restore_s"] = time.perf_counter() - t0
        if start_it:
            log(f"[{family}] resumed from checkpoint at iteration {start_it}")

    K = steps_per_call(iterations, print_every, checkpoint_every, start_it,
                       cap)
    t0 = time.perf_counter()
    table = torch.from_numpy(x).to(dev)
    table_cond = None if y is None else torch.from_numpy(y).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    host["upload_s"] = time.perf_counter() - t0
    graphed = dev.type == "cuda"
    # the port kernels' launches on this run's path: the capture's warm-up
    # iteration and every iteration after it
    launches0 = kernels.launch_counts()
    t0 = time.perf_counter()
    step_fn, state = pair.make_multistep(
        table, table_cond, batch_size=batch_size, steps_per_call=K,
        n_critic=n_critic, real_label=real_label, z_size=cfg.z_size, z_gen=z_gen,
        ema_decay=ema_decay, start_step=start_it, graphed=graphed)
    host["capture_s"] = time.perf_counter() - t0
    metrics = MetricsLogger(os.path.join(res_path, f"{family}_metrics.jsonl"),
                            append=start_it > 0)

    def snapshot() -> None:
        """Point the graphs at the current state: clones of a graph's
        static buffers (the next replay overwrites those)."""
        pair.adopt_state(fused_step.clone_state(state) if graphed else state)

    saved = {"step": None, "path": None}

    def save_ckpt(it: int) -> str:
        extra = {"z_gen_state": z_gen.get_state()}
        ema = getattr(pair.gen, "ema_params", None)
        if ema is not None:
            extra["ema"] = ema
        saved["path"] = ckpt.save(it, {"gen": pair.gen, "dis": pair.dis},
                                  extra=extra, mesh_spec=spec)
        saved["step"] = it
        return saved["path"]

    with AsyncArtifactWriter() as dumper:

        def dump_samples(tag) -> None:
            samples = pair.gen.output(*eval_in)[0]
            (hosted,), event = host_copy([samples])
            path = os.path.join(res_path, f"{family}_samples_{tag}.png")

            def write():
                if event is not None:
                    event.synchronize()
                save_rgb_grid_png(path, hosted.numpy().reshape(64, -1),
                                  sample_shape, value_range=vrange)

            dumper.submit(write)

        steady_t0, steady_start = None, start_it
        d_loss = g_loss = float("nan")
        it = start_it
        while it < iterations:
            state, (dl, gl) = step_fn(state)
            dl, gl = dl.tolist(), gl.tolist()  # the call's one readback
            if steady_t0 is None:
                steady_t0, steady_start = time.perf_counter(), it + K
            metrics.log_chunk(it + 1, K, 0, {"d_loss": dl, "g_loss": gl})
            it += K
            d_loss, g_loss = dl[-1], gl[-1]
            if it % 100 == 0:
                log(f"[{family}] iteration {it}: d={d_loss:.4f} "
                    f"g={g_loss:.4f}")
            if it % print_every == 0 or it >= iterations:
                snapshot()
                dump_samples(it)
            if ckpt is not None and checkpoint_every \
                    and it % checkpoint_every == 0:
                snapshot()
                dumper.flush()  # pending artifacts land first
                save_ckpt(it)
            if guard is not None and guard.triggered:
                if saved["step"] != it:
                    snapshot()
                    dumper.flush()
                    save_ckpt(it)
                wait = getattr(ckpt, "wait", None)
                if wait is not None:
                    wait()  # emergency saves must be durable
                metrics.close()
                preempt_exit(res_path, guard, local_step=it,
                             fleet_min_step=it, checkpoint=saved["path"])
        t_end = time.perf_counter()
        launches = {k: n - launches0[k]
                    for k, n in kernels.launch_counts().items()}
        if getattr(pair.gen, "ema_params", None) is not None:
            # the final grid from the trajectory-averaged weights too
            live = pair.gen.params
            pair.gen.params = pair.gen.ema_params
            try:
                dump_samples("ema")
            finally:
                pair.gen.params = live
    metrics.close()
    if ckpt is not None:
        wait = getattr(ckpt, "wait", None)
        if wait is not None:
            wait()  # queued async saves are durable before success
    t0 = time.perf_counter()
    for name, graph in (("gen", pair.gen), ("dis", pair.dis)):
        serialization.write_model(
            graph, os.path.join(res_path, f"{family}_{name}_model.zip"))
    if getattr(pair.gen, "ema_params", None) is not None:
        live = pair.gen.params
        pair.gen.params = pair.gen.ema_params
        try:
            # inference-only: the live Adam moments do not belong to it
            serialization.write_model(pair.gen, os.path.join(
                res_path, f"{family}_gen_ema_model.zip"), save_updater=False)
        finally:
            pair.gen.params = live
    host["save_models_s"] = time.perf_counter() - t0
    steps_timed = iterations - steady_start if steady_t0 is not None else 0
    wall = t_end - steady_t0 if steady_t0 is not None else 0.0
    result = {
        "family": family, "steps": it, "d_loss": d_loss, "g_loss": g_loss,
        "examples_per_sec": (steps_timed * batch_size * (n_critic + 1) / wall
                             if steps_timed > 0 else 0.0),
        "host_seconds": host, "graphed": graphed, "steps_per_call": K,
        "device": str(dev), "precision": dataclasses.asdict(backend.config()),
        "port_launches": launches,
    }
    if y is not None and fidelity_steps > 0:
        t0 = time.perf_counter()
        result.update(_conditional_metrics(pair, cfg, x, y, sample_shape,
                                           fidelity_steps, log, family))
        host["conditional_eval_s"] = time.perf_counter() - t0
    return result


def _conditional_metrics(pair: GANPair, cfg, x: np.ndarray, y: np.ndarray,
                         sample_shape, fidelity_steps: int, log,
                         family: str) -> Dict:
    """The conditional family's end-of-run scores (the JAX main's keys):
    the probe's label agreement, and with every class at
    ``MIN_CLASS_ROWS`` rows or more the per-class frozen FID and diversity
    ratio; each for the EMA weights too when the run kept them."""
    from gan_deeplearning4j_tpu_torch.eval.conditional import (
        conditional_class_metrics,
        conditional_fidelity,
    )

    gen = pair.gen
    ema = getattr(gen, "ema_params", None) is not None
    out: Dict = {}
    fid = conditional_fidelity(gen, x, y, sample_shape=sample_shape,
                               z_size=cfg.z_size, probe_steps=fidelity_steps)
    out["conditional_fidelity"] = fid["fidelity"]
    out["fidelity_per_class"] = fid["per_class"]
    out["probe_train_acc"] = fid["probe_train_acc"]
    log(f"[{family}] conditional fidelity {fid['fidelity']:.3f} (probe "
        f"train acc {fid['probe_train_acc']:.3f}); per-class "
        + " ".join(f"{v:.2f}" for v in fid["per_class"]))
    if ema:
        # the probe depends only on (x, y, seed): trained once
        out["conditional_fidelity_ema"] = conditional_fidelity(
            gen, x, y, sample_shape=sample_shape, z_size=cfg.z_size,
            use_ema=True, probe=fid["probe"])["fidelity"]
    counts = np.bincount(np.argmax(y, axis=1), minlength=y.shape[1])
    if int(counts.min()) >= MIN_CLASS_ROWS:
        cm = conditional_class_metrics(gen, x, y, sample_shape=sample_shape,
                                       z_size=cfg.z_size)
        out["per_class_fid"] = cm["per_class_fid"]
        out["mean_class_fid"] = cm["mean_class_fid"]
        out["diversity_ratio"] = cm["mean_diversity_ratio"]
        log(f"[{family}] per-class frozen FID mean "
            f"{cm['mean_class_fid']:.2f} "
            + " ".join(f"{v:.1f}" for v in cm["per_class_fid"])
            + f"; diversity ratio {cm['mean_diversity_ratio']:.3f}")
        if ema:
            cme = conditional_class_metrics(
                gen, x, y, sample_shape=sample_shape, z_size=cfg.z_size,
                use_ema=True, real_features=cm["_real_features"])
            out["mean_class_fid_ema"] = cme["mean_class_fid"]
            out["diversity_ratio_ema"] = cme["mean_diversity_ratio"]
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", choices=FAMILIES, required=True)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=DEFAULT_BATCH_SIZE)
    p.add_argument("--res-path", default=None)
    p.add_argument("--n-train", type=int, default=10000)
    p.add_argument("--print-every", type=int, default=500)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="cap on iterations per call (None = auto, up to 100)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N iterations (aligned to calls)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest verified checkpoint")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="serialize checkpoints on a background worker")
    p.add_argument("--preempt-signal", action="append", default=None,
                   metavar="SIG",
                   help="signal (repeatable) that triggers an emergency "
                        "checkpoint, PREEMPTED.json and exit code 75")
    p.add_argument("--lr-decay-steps", type=int, default=None,
                   help="hold-then-sigmoid-decay LR horizon (cgan-cifar10, "
                        "celeba)")
    p.add_argument("--ms-weight", type=float, default=0.0,
                   help="mode-seeking regularizer weight (cgan-cifar10, "
                        "celeba)")
    p.add_argument("--fidelity-steps", type=int, default=400,
                   help="probe-classifier training steps of the conditional "
                        "fidelity evaluation (cgan-cifar10; 0 = skip it)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="generator weight EMA decay (e.g. 0.999)")
    p.add_argument("--profile", default=None, metavar="DIR")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT")
    backend.add_bf16_flag(p)
    backend.add_mp_flag(p)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "torch versions of the kernels)")
    args = p.parse_args(argv)
    if args.n_devices and args.n_devices > 1:
        raise _not_ported("--n-devices > 1 (GANPair data parallelism)", "8")
    if args.data_dir:
        raise _not_ported("--data-dir (data/images.py)", "8")
    if args.profile:
        raise _not_ported("--profile (train/profile_step.py profiles the "
                          "iteration)", "6.5")
    if args.metrics_port is not None:
        raise _not_ported("--metrics-port (telemetry exporter)", "6.5")
    return args


def main(argv=None) -> Dict:
    args = parse_args(argv)
    res = args.res_path or os.path.join("outputs", args.family)
    try:
        with backend.configured(**backend.flag_policy(args)):
            result = train(
                args.family, args.iterations, args.batch_size, res,
                args.n_train, args.print_every, device=args.device,
                ema_decay=args.ema_decay,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                steps_per_call_cap=args.steps_per_call,
                lr_decay_steps=args.lr_decay_steps, ms_weight=args.ms_weight,
                fidelity_steps=args.fidelity_steps,
                async_checkpoint=args.async_checkpoint,
                preempt_signals=(",".join(args.preempt_signal)
                                 if args.preempt_signal else None))
    except PreemptionError as e:
        result = {"family": args.family, "preempted": True, "step": e.step,
                  "checkpoint": e.checkpoint, "res_path": res}
    # one JSON line (numpy scalars coerced)
    print(json.dumps(result, default=float), flush=True)
    return result


def cli(argv=None) -> None:
    """The ``python -m`` entry: ``main``, exiting 75 (EX_TEMPFAIL: requeue
    me) when the run was preempted."""
    if main(argv).get("preempted"):
        sys.exit(EXIT_PREEMPTED)


if __name__ == "__main__":
    cli()
