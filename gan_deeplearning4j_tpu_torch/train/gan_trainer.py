"""A DCGAN trainer on device-resident data (torch twin of the resident
loops of ``gan_deeplearning4j_tpu/train/gan_trainer.py``), on one device
or one rank of a data-parallel group.

The whole training table lives on the device; under a group every rank
holds the whole table and the global soften vectors.  Label softening is
drawn once per run: 0.05*N(0,1) over (B, 1) for the real and the fake
half, y_dis = [1 + soften_real; soften_fake].  Two loops, as in the JAX
trainer:
  - fused (the default, ``dp_mode="gradient_sync"``): the protocol step of
    ``fused_step``, K steps per call (``steps_per_call``; K is resolved to
    divide the run), with the generator EMA when ``ema_decay`` > 0.  On one
    card the step runs as a replayed CUDA graph; on the CPU and under a
    group it runs eagerly.
  - unfused (``fused=False``, or ``dp_mode="param_averaging"``): the
    reference's per-fit loop, ``dis.fit`` / sync / ``gan.fit`` / sync /
    ``classifier.fit``, through ``DataParallelGraph`` under a group.
Every call ends in one readback of its losses.  ``train_data_parallel``
runs the trainer in one process per rank.  Artifacts, checkpoints, metrics,
the print/save cadences, supervision and evaluation are not ported yet.
"""

from __future__ import annotations

import logging
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.parallel.data_parallel import DataParallelGraph
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.train import fused_step

log_ = logging.getLogger(__name__)

DP_MODES = ("gradient_sync", "param_averaging")


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
                           steps_per_call: Optional[int] = None) -> int:
    """Steps per call: the largest K <= cap that divides the run, so every
    call runs whole (the JAX trainer's ``_resolve_steps_per_call``).  The
    cap is ``fused_step.MAX_STEPS_PER_CALL``, or an explicit
    ``steps_per_call``, which is reduced with a warning when it does not
    divide the run."""
    cap = (fused_step.MAX_STEPS_PER_CALL if steps_per_call is None
           else max(1, steps_per_call))
    # the iteration count is the only divisor: the JAX trainer also takes
    # the gcd with its print, save and checkpoint cadences, which join it
    # here when they are ported
    g = iterations
    if g <= 0:
        return 1
    k = max(d for d in range(1, min(cap, g) + 1) if g % d == 0)
    if steps_per_call is not None and k != steps_per_call:
        log_.warning("steps_per_call=%d reduced to %d (must divide the "
                     "iteration count so every call runs whole)",
                     steps_per_call, k)
    return k


class GANTrainer:
    """Builds the four DCGAN graphs and the training table on one device
    (None = the card; a ``group`` brings its rank's device) and trains
    them, data-parallel over ``group`` when one is given.

    ``steps_per_call``: the cap on K (None = ``MAX_STEPS_PER_CALL``).
    ``ema_decay`` in [0, 1): the generator EMA (fused step only).
    ``fused=False`` or ``dp_mode="param_averaging"`` select the unfused
    per-fit loop; under a group its graphs fit through ``DataParallelGraph``
    (``dp_mode``, ``averaging_frequency``).  On one card the fused step is
    captured as a CUDA graph here, at construction."""

    def __init__(self, cfg: M.CVConfig = M.CVConfig(), batch_size: int = 200,
                 n_train: int = 60000, device=None,
                 group: Optional[mesh.DataGroup] = None,
                 steps_per_call: Optional[int] = None, ema_decay: float = 0.0,
                 fused: bool = True, dp_mode: str = "gradient_sync",
                 averaging_frequency: int = 1):
        if n_train < batch_size:
            raise ValueError(f"n_train {n_train} is less than one batch "
                             f"of {batch_size}")
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in [0, 1), got {ema_decay} "
                "(1.0 would pin the EMA at initialization forever)")
        if dp_mode not in DP_MODES:
            raise ValueError(f"unknown dp_mode {dp_mode!r}; known: {DP_MODES}")
        self.fused = fused and dp_mode == "gradient_sync"
        if ema_decay > 0 and not self.fused:
            raise ValueError(
                "ema_decay > 0 requires the fused step (fused=True, "
                "dp_mode='gradient_sync') — only it maintains the EMA")
        if steps_per_call is not None and steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got "
                             f"{steps_per_call}")
        if group is not None:
            device = group.device
        self.device = dev = backend.resolve_device(device)
        self.group = group
        self.cfg, self.batch_size = cfg, batch_size
        self.steps_per_call, self.ema_decay = steps_per_call, ema_decay
        self.dp_mode = dp_mode
        self.dis = M.build_discriminator(cfg, dev)
        self.gen = M.build_generator(cfg, dev)
        self.gan = M.build_gan(cfg, dev)
        self.classifier = M.build_classifier(self.dis, cfg)
        feats, labels = synthetic_mnist(n_train)
        self.features = torch.from_numpy(feats).to(dev)
        self.labels = torch.nn.functional.one_hot(
            torch.from_numpy(labels), cfg.num_classes).float().to(dev)
        soften = prng.generator(cfg.seed, "soften")
        B = batch_size
        self.ones = torch.ones((B, 1), device=dev)
        self.y_real = self.ones + 0.05 * torch.randn((B, 1), generator=soften).to(dev)
        self.y_fake = 0.05 * torch.randn((B, 1), generator=soften).to(dev)
        self.z_gen = prng.generator(cfg.seed, "train-z", dev)
        self.steps = 0
        self.state: Optional[fused_step.ProtocolState] = None
        self.graphed: Optional[fused_step.GraphedStep] = None
        self._step_fns: Dict[int, Callable] = {}
        if self.fused:
            self.state = fused_step.state_from_graphs(
                self.dis, self.gen, self.gan, self.classifier,
                ema=ema_decay > 0)
            # one card: the step as a CUDA graph.  The CPU and groups stay
            # eager by configuration (gloo cannot be captured; capturing
            # NCCL is later work)
            if dev.type == "cuda" and group is None:
                self.graphed = fused_step.GraphedStep(
                    self.step_fn(1), self.state, self.features, self.labels,
                    self.y_real, self.y_fake, self.ones, self.z_gen,
                    ring=steps_per_call or fused_step.MAX_STEPS_PER_CALL)
                self.state = self.graphed.state
        elif group is None:
            self._fits = (self.dis.fit, self.gan.fit, self.classifier.fit)
        else:
            self._fits = tuple(
                DataParallelGraph(g, group, mode=dp_mode,
                                  averaging_frequency=averaging_frequency).fit
                for g in (self.dis, self.gan, self.classifier))

    def step_fn(self, k: int) -> Callable:
        """The fused step with ``steps_per_call`` k (eager; built once per
        k) on this trainer's graphs, group and EMA decay."""
        if k not in self._step_fns:
            self._step_fns[k] = fused_step.make_protocol_step(
                self.dis, self.gen, self.gan, self.classifier, M.DIS_TO_GAN,
                M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER, z_size=self.cfg.z_size,
                num_features=self.cfg.num_features, group=self.group,
                steps_per_call=k, ema_decay=self.ema_decay)
        return self._step_fns[k]

    def _z(self) -> torch.Tensor:
        return torch.rand((self.batch_size, self.cfg.z_size),
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
        # (1) D-step on [real; G(z1)], the generator in inference mode
        z1 = self._z() if z1 is None else z1
        fake = self.gen.output(z1)[0].reshape(B, self.cfg.num_features)
        d_loss = fit_dis(torch.cat([real, fake]),
                         torch.cat([self.y_real, self.y_fake]))
        # (2) dis -> gan frozen tail, (3) the G-step, (4) gan -> gen
        M.sync_params(self.gan, self.dis, M.DIS_TO_GAN)
        z2 = self._z() if z2 is None else z2
        g_loss = fit_gan(z2, self.ones)
        M.sync_params(self.gen, self.gan, M.GAN_TO_GEN)
        # (5) dis -> classifier, and the classifier on the labeled batch
        M.sync_params(self.classifier, self.dis, M.DIS_TO_CLASSIFIER)
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

    def train(self, iterations: int,
              log: Optional[Callable[[str], None]] = print) -> Dict:
        """Run ``iterations`` protocol steps, K per call (the unfused loop:
        one).  Each call ends in one readback of its losses, so a step's
        time is the call's host clock over finished device work, over K."""
        k = (resolve_steps_per_call(iterations, self.steps_per_call)
             if self.fused else 1)
        times, losses = [], (float("nan"),) * 3
        for _ in range(iterations // k):
            t0 = time.perf_counter()
            rows = self._call(k)
            times.append(time.perf_counter() - t0)
            for i, row in enumerate(rows.tolist()):
                losses = tuple(row)
                if log is not None:
                    log(f"step {self.steps - k + i + 1}: d_loss "
                        f"{losses[0]:.6f} g_loss {losses[1]:.6f} clf_loss "
                        f"{losses[2]:.6f} ({times[-1] / k * 1e3:.3f} ms)")
        if self.fused:
            # clones of a graph's static buffers: a later replay must not
            # overwrite the graphs' params under sample_grid
            state = (fused_step.clone_state(self.state)
                     if self.graphed is not None else self.state)
            fused_step.state_to_graphs(state, self.dis, self.gen, self.gan,
                                       self.classifier)
        step_s = statistics.median(times) / k if times else float("nan")
        return {"steps": self.steps, "d_loss": losses[0],
                "g_loss": losses[1], "clf_loss": losses[2],
                "step_ms_median": step_s * 1e3,
                "img_per_s": self.batch_size / step_s,
                "steps_per_call": k, "graphed": self.graphed is not None,
                "fused": self.fused, "dp_mode": self.dp_mode,
                "ema_decay": self.ema_decay,
                "device": str(self.device),
                "world": self.group.world if self.group else 1,
                "backend": self.group.backend if self.group else None}

    def sample_grid(self, n: int = 10) -> torch.Tensor:
        """Generator output over the n x n latent grid, inference mode."""
        z = torch.from_numpy(latent_grid(n, self.cfg.z_size)).to(self.device)
        return self.gen.output(z)[0]


def _train_rank(group: mesh.DataGroup, cfg: M.CVConfig, batch_size: int,
                n_train: int, iterations: int, options: Dict) -> Dict:
    trainer = GANTrainer(cfg, batch_size, n_train, group=group, **options)
    return trainer.train(iterations, log=print if group.rank == 0 else None)


def train_data_parallel(cfg: M.CVConfig, batch_size: int, n_train: int,
                        iterations: int, device=None,
                        n_devices: Optional[int] = None,
                        timeout: float = 3600.0, **options) -> Dict:
    """Train with ``resolve_n_devices(n_devices)`` ranks: in this process
    when that is one, else one spawned process per rank (rank r on
    ``cuda:r``, NCCL; gloo ranks with ``device="cpu"``), rank 0 logging its
    steps.  ``options`` go to every rank's ``GANTrainer``
    (``steps_per_call``, ``ema_decay``, ``fused``, ``dp_mode``,
    ``averaging_frequency``).  Returns rank 0's result."""
    world = resolve_n_devices(n_devices, batch_size, device)
    if world == 1:
        return GANTrainer(cfg, batch_size, n_train, device,
                          **options).train(iterations)
    dev = backend.resolve_device(device)
    results = mesh.spawn(_train_rank, world,
                         (cfg, batch_size, n_train, iterations, options),
                         device=dev.type, timeout=timeout)
    return results[0]
