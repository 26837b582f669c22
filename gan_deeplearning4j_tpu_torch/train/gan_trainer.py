"""A few-steps DCGAN trainer on device-resident data (torch twin of the
resident loop of ``gan_deeplearning4j_tpu/train/gan_trainer.py``).

The whole training table lives on the device and the protocol step slices
its own batches.  Label softening is drawn once per run: 0.05*N(0,1) over
(B, 1) for the real and the fake half, y_dis = [1 + soften_real;
soften_fake].  Artifacts, checkpoints, metrics, supervision and evaluation
are not ported yet.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.train import fused_step


def latent_grid(n: int, z_size: int) -> np.ndarray:
    """The cartesian product of linspace(-1, 1, n) per latent dim, first
    dim outermost — the reference's synthesis grid (n^z_size rows)."""
    axis = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    return np.stack(np.meshgrid(*([axis] * z_size), indexing="ij"),
                    axis=-1).reshape(-1, z_size)


class GANTrainer:
    """Builds the four DCGAN graphs and the training table on one device
    (None = the card) and runs the protocol step."""

    def __init__(self, cfg: M.CVConfig = M.CVConfig(), batch_size: int = 200,
                 n_train: int = 60000, device=None):
        if n_train < batch_size:
            raise ValueError(f"n_train {n_train} is less than one batch "
                             f"of {batch_size}")
        self.device = dev = backend.resolve_device(device)
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
            num_features=cfg.num_features)
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
                "device": str(self.device)}

    def sample_grid(self, n: int = 10) -> torch.Tensor:
        """Generator output over the n x n latent grid, inference mode."""
        z = torch.from_numpy(latent_grid(n, self.cfg.z_size)).to(self.device)
        return self.gen.output(z)[0]
