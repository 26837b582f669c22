"""A few-steps DCGAN trainer on device-resident data (torch twin of the
resident loop of ``gan_deeplearning4j_tpu/train/gan_trainer.py``), on one
device or one rank of a data-parallel group.

The whole training table lives on the device and the protocol step slices
its own batches; under a group every rank holds the whole table and the
global soften vectors and the step takes its rows (the JAX package's
``data_on_device`` mesh path).  Label softening is drawn once per run:
0.05*N(0,1) over (B, 1) for the real and the fake half, y_dis =
[1 + soften_real; soften_fake].  ``train_data_parallel`` runs the trainer
in one process per rank.  Artifacts, checkpoints, metrics, supervision and
evaluation are not ported yet.
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
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.train import fused_step

log_ = logging.getLogger(__name__)


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


class GANTrainer:
    """Builds the four DCGAN graphs and the training table on one device
    (None = the card; a ``group`` brings its rank's device) and runs the
    protocol step, data-parallel over ``group`` when one is given."""

    def __init__(self, cfg: M.CVConfig = M.CVConfig(), batch_size: int = 200,
                 n_train: int = 60000, device=None,
                 group: Optional[mesh.DataGroup] = None):
        if n_train < batch_size:
            raise ValueError(f"n_train {n_train} is less than one batch "
                             f"of {batch_size}")
        if group is not None:
            device = group.device
        self.device = dev = backend.resolve_device(device)
        self.group = group
        self.cfg, self.batch_size = cfg, batch_size
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
        self.step_fn = fused_step.make_protocol_step(
            self.dis, self.gen, self.gan, self.classifier, M.DIS_TO_GAN,
            M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER, z_size=cfg.z_size,
            num_features=cfg.num_features, group=group)
        self.state = fused_step.state_from_graphs(
            self.dis, self.gen, self.gan, self.classifier)

    def train(self, iterations: int,
              log: Optional[Callable[[str], None]] = print) -> Dict[str, float]:
        """Run ``iterations`` protocol steps.  Each step ends in a readback
        of its three losses, so the step time is host clock over finished
        device work."""
        times, losses = [], (float("nan"),) * 3
        for _ in range(iterations):
            t0 = time.perf_counter()
            self.state, out = self.step_fn(
                self.state, self.features, self.labels, self.y_real,
                self.y_fake, self.ones, z_gen=self.z_gen)
            losses = tuple(float(v) for v in out)
            times.append(time.perf_counter() - t0)
            if log is not None:
                log(f"step {self.state.it}: d_loss {losses[0]:.6f} "
                    f"g_loss {losses[1]:.6f} clf_loss {losses[2]:.6f} "
                    f"({times[-1] * 1e3:.3f} ms)")
        fused_step.state_to_graphs(self.state, self.dis, self.gen, self.gan,
                                   self.classifier)
        step_s = statistics.median(times) if times else float("nan")
        return {"steps": self.state.it, "d_loss": losses[0],
                "g_loss": losses[1], "clf_loss": losses[2],
                "step_ms_median": step_s * 1e3,
                "img_per_s": self.batch_size / step_s,
                "device": str(self.device),
                "world": self.group.world if self.group else 1,
                "backend": self.group.backend if self.group else None}

    def sample_grid(self, n: int = 10) -> torch.Tensor:
        """Generator output over the n x n latent grid, inference mode."""
        z = torch.from_numpy(latent_grid(n, self.cfg.z_size)).to(self.device)
        return self.gen.output(z)[0]


def _train_rank(group: mesh.DataGroup, cfg: M.CVConfig, batch_size: int,
                n_train: int, iterations: int) -> Dict:
    trainer = GANTrainer(cfg, batch_size, n_train, group=group)
    return trainer.train(iterations, log=print if group.rank == 0 else None)


def train_data_parallel(cfg: M.CVConfig, batch_size: int, n_train: int,
                        iterations: int, device=None,
                        n_devices: Optional[int] = None,
                        timeout: float = 3600.0) -> Dict:
    """Train with ``resolve_n_devices(n_devices)`` ranks: in this process
    when that is one, else one spawned process per rank (rank r on
    ``cuda:r``, NCCL; gloo ranks with ``device="cpu"``), rank 0 logging its
    steps.  Returns rank 0's result."""
    world = resolve_n_devices(n_devices, batch_size, device)
    if world == 1:
        return GANTrainer(cfg, batch_size, n_train, device).train(iterations)
    dev = backend.resolve_device(device)
    results = mesh.spawn(_train_rank, world,
                         (cfg, batch_size, n_train, iterations),
                         device=dev.type, timeout=timeout)
    return results[0]
