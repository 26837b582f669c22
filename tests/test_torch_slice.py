"""The port's DCGAN protocol step held against the JAX package's, on the CPU.

Both packages start from the same state (the JAX graphs' params and RmsProp
caches carried over through ``interop``), see the same batch and targets,
and the port is handed the JAX step's own latent draws (z1 under
fold_in(z_key, 2*it), z2 under fold_in(z_key, 2*it+1)).  Step one is the
binding check; later steps need a wider band because RmsProp at decay 1e-8
is nearly sign-SGD and rounding differences grow multiplicatively.

Also here: the CLI on the CPU, and the port's import hygiene (no jax, no
module of the JAX package) and device defaults.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.train import fused_step as FJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.runtime import backend
from gan_deeplearning4j_tpu_torch.train import cv_main
from gan_deeplearning4j_tpu_torch.train import fused_step as FT

REPO = Path(__file__).resolve().parents[1]
B = 8
STEPS = 3
FIELDS = FT.TREES  # every tree of the state


def _carry(state_j) -> FT.ProtocolState:
    def tree(t):
        return interop.params_from_numpy(jax.tree.map(np.asarray, t), "cpu")

    return FT.ProtocolState(*(tree(getattr(state_j, f)) for f in FIELDS),
                            torch.tensor(int(state_j.it)))


@pytest.fixture(scope="module")
def runs():
    """STEPS protocol steps in each package from the same start; returns
    the per-step (jax state, jax losses, torch state, torch losses)."""
    dis, gen, gan = MJ.build_discriminator(), MJ.build_generator(), MJ.build_gan()
    clf = MJ.build_classifier(dis)
    step_j = FJ.make_protocol_step(
        dis, gen, gan, clf, MJ.DIS_TO_GAN, MJ.GAN_TO_GEN,
        MJ.DIS_TO_CLASSIFIER, z_size=2, num_features=784, donate=False)
    state_j = FJ.state_from_graphs(dis, gen, gan, clf)

    tdis = MT.build_discriminator(device="cpu")
    graphs_t = (tdis, MT.build_generator(device="cpu"),
                MT.build_gan(device="cpu"), MT.build_classifier(tdis))
    step_t = FT.make_protocol_step(
        *graphs_t, MT.DIS_TO_GAN, MT.GAN_TO_GEN, MT.DIS_TO_CLASSIFIER,
        z_size=2, num_features=784)
    state_t = _carry(state_j)

    # a resident table of two batches: the step slices batch it % 2
    feats, labels = synthetic_mnist(2 * B, seed=5)
    onehot = np.eye(10, dtype=np.float32)[labels]
    rng = np.random.RandomState(1)
    ones = np.ones((B, 1), np.float32)
    y_real = ones + (0.05 * rng.randn(B, 1)).astype(np.float32)
    y_fake = (0.05 * rng.randn(B, 1)).astype(np.float32)
    z_key, rng_key = jax.random.key(3), jax.random.key(4)
    T = torch.from_numpy
    out = []
    for it in range(STEPS):
        z1, z2 = (np.asarray(jax.random.uniform(
            jax.random.fold_in(z_key, 2 * it + k), (B, 2),
            minval=-1.0, maxval=1.0)) for k in (0, 1))
        sl = slice((it % 2) * B, (it % 2 + 1) * B)
        state_j, losses_j = step_j(
            state_j, jnp.asarray(feats[sl]), jnp.asarray(onehot[sl]), z_key,
            rng_key, jnp.asarray(y_real), jnp.asarray(y_fake),
            jnp.asarray(ones))
        state_t, losses_t = step_t(
            state_t, T(feats), T(onehot), T(y_real), T(y_fake), T(ones),
            z1=T(z1), z2=T(z2))
        out.append((_carry(state_j), [float(v) for v in losses_j],
                    state_t, [float(v) for v in losses_t]))
    return out


def _worst(ref: FT.ProtocolState, got: FT.ProtocolState, kind: str) -> float:
    """Max over leaves of |got - ref| for ``kind`` "param" (absolute) or
    "cache" (divided by the leaf's largest |ref| plus RmsProp's eps 1e-8:
    a cache enters the update only as cache + eps)."""
    worst = 0.0
    for f in FIELDS:
        if f.endswith("_opt") != (kind == "cache"):
            continue
        for layer, lp in getattr(ref, f).items():
            for n, a in lp.items():
                d = float((getattr(got, f)[layer][n] - a).abs().max())
                if kind == "cache":
                    d /= float(a.abs().max()) + 1e-8
                worst = max(worst, d)
    return worst


def test_one_step_matches_jax(runs):
    """The binding check, on every loss and every leaf of the state.

    Tolerances (f32 on both sides, different summation orders in conv and
    matmul): losses 1e-5 relative; params and BN statistics 2e-5 absolute —
    an RmsProp update moves a param by up to lr = 2e-3..4e-3, so a wrong
    update sign is 100x outside it; caches (~g^2) 2e-3 of each leaf's
    largest value plus eps: elements near g = 0 carry a large relative
    rounding error but a negligible absolute one, and the gradients of the
    widest reductions (a frozen input BN's running mean sums B*784 terms
    that cancel) differ by ~2e-4 relative between summation orders."""
    state_j, losses_j, state_t, losses_t = runs[0]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert state_t.it == state_j.it == 1
    assert _worst(state_j, state_t, "param") <= 2e-5
    assert _worst(state_j, state_t, "cache") <= 2e-3


def test_three_steps_track_jax(runs):
    """Steps two and three within a wider band: losses 1e-3 relative,
    params 4e-3 absolute (one generator learning rate: an element whose
    gradient sat near 0 may take a different sign, no more), caches 5e-2
    of each leaf's largest value plus eps."""
    for state_j, losses_j, state_t, losses_t in runs[1:]:
        np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
        assert _worst(state_j, state_t, "param") <= 4e-3
        assert _worst(state_j, state_t, "cache") <= 5e-2
        assert all(np.isfinite(losses_t))


def test_cv_main_runs_on_cpu(capsys, tmp_path):
    result = cv_main.main(["--iterations", "2", "--batch-size", "8",
                           "--n-train", "32", "--device", "cpu",
                           "--res-path", str(tmp_path), "--n-test", "16",
                           "--fid-samples", "64"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == result
    assert result["steps"] == 2 and result["device"] == "cpu"
    assert all(np.isfinite([result["d_loss"], result["g_loss"],
                            result["clf_loss"]]))
    assert sum(line.startswith("step ") for line in out) == 2


# -- hygiene -----------------------------------------------------------------

_HYGIENE = r"""
import sys
from gan_deeplearning4j_tpu_torch.checkpoint import (AsyncCheckpointer,
                                                    TrainCheckpointer)
from gan_deeplearning4j_tpu_torch.data import (codec, csv, datasets, prefetch,
                                               resilient)
from gan_deeplearning4j_tpu_torch.eval import (conditional, evaluation, fid,
                                               fid_extractor, metrics)
from gan_deeplearning4j_tpu_torch.graph import serialization
from gan_deeplearning4j_tpu_torch.parallel import data_parallel, mesh
from gan_deeplearning4j_tpu_torch.models import cgan_cifar10, mlpgan_insurance
from gan_deeplearning4j_tpu_torch.train import (checkpoint_ab, cv_main,
                                                gan_pair, insurance_main,
                                                preemption, roadmap_main)
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer
from gan_deeplearning4j_tpu_torch.utils import async_dump, metrics as logger
assert fid_extractor.load_extractor("cpu").params["feat"]["W"].shape == (512, 256)
t = GANTrainer(batch_size=4, n_train=8, device="cpu")
r = t.train(1, log=None)
assert r["steps"] == 1, r
assert tuple(t.sample_grid(3).shape) == (9, 1, 28, 28)
dis = mlpgan_insurance.build_discriminator(device="cpu")
assert dis.input_specs["dis_input_layer_0"].shape == (12,)
assert insurance_main.default_config().num_classes == 1
assert fid_extractor.load_extractor_cifar("cpu").params["feat"]["W"].shape == (
    1024, 256)
assert "cgan-cifar10" in roadmap_main.FAMILIES
g = cgan_cifar10.build_generator(cgan_cifar10.CGANConfig(base_filters=2),
                                 device="cpu")
assert g.input_names == ["z", "label"]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "gan_deeplearning4j_tpu"
             or m.startswith("gan_deeplearning4j_tpu."))
print("BAD", bad)
"""


def test_port_runs_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "BAD []"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*(REPO / "gan_deeplearning4j_tpu_torch").rglob("*.py"),
     REPO / "chip_smoke.py"]), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "gan_deeplearning4j_tpu"), (
            f"{path} imports {mod}")


def test_default_device_is_the_card():
    """No explicit device means CUDA: a host without a card raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        assert backend.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MT.build_generator()
    assert backend.resolve_device("cpu").type == "cpu"
