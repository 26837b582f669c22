"""Where a roadmap iteration's f32 numbers on the card part from float64.

Run: ``python -m gan_deeplearning4j_tpu_torch.train.moment_triage
[--family celeba] [--family cgan-cifar10] [--batch-size 128]`` (needs a
CUDA device).

One iteration (n_critic D-steps and a G-step) at full width from one set
of params and draws, made on the CPU: once on the CPU in float64 (the
reference), once on the CPU in f32, and on the card in f32 under each of
these policies, in one process:
  - ``timed``: the port's parity mode (TF32 off, cuDNN deterministic and
    timed at each shape's first use: ``runtime/backend.py``);
  - ``heuristic``: cuDNN deterministic, its heuristic choice, not timed;
  - ``no_cudnn``: cuDNN off (PyTorch's own CUDA convolutions);
  - ``f64_moments``: ``timed``, with the 4-D and conditional BNs (their
    batch moments E[x], E[x^2], var = E[x^2] - E[x]^2 and the normalize)
    computed in float64 on the card.
For each run it prints one JSON line: the discriminator's forward on the
first D-step's real rows in train mode, node by node, as the relative
error (in norm) against float64; the gradient of every leaf, read from
Adam's first moment after the iteration, the same way; the losses; the
cuDNN switches; and the card's name and power limit.  The worst leaf and
the BN leaves are listed first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
from typing import Dict

import torch

from gan_deeplearning4j_tpu_torch.graph import layers
from gan_deeplearning4j_tpu_torch.ops import batchnorm as bn_ops
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain
from gan_deeplearning4j_tpu_torch.train import fused_step, roadmap_main
from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws, PairState

POLICIES = ("timed", "heuristic", "no_cudnn", "f64_moments")
N_ROWS = 512


def _to(tree, dev, dtype):
    return {k: _to(v, dev, dtype) if isinstance(v, dict)
            else v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
            for k, v in tree.items()}


def _f64_moments(fn):
    """``fn`` (a BN op: x, gamma, beta, running mean, running var, ...)
    computed in float64, its outputs cast back."""

    def wrapped(x, *args, **kw):
        out, mean, var = fn(x.double(), *[a.double() for a in args[:4]],
                            *args[4:], **kw)
        return out.to(x.dtype), mean.to(x.dtype), var.to(x.dtype)

    return wrapped


@contextlib.contextmanager
def _policy(name: str):
    """The card's switches for one run (restored after it)."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.deterministic, cudnn.benchmark)
    patched = {}
    if name == "heuristic":
        cudnn.benchmark = False
    elif name == "no_cudnn":
        cudnn.enabled = False
    elif name == "f64_moments":
        for op in ("batch_norm_train", "batch_norm_train_cond"):
            patched[op] = getattr(layers, op)
            setattr(layers, op, _f64_moments(getattr(bn_ops, op)))
    try:
        yield
    finally:
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = saved
        for op, fn in patched.items():
            setattr(layers, op, fn)


@contextlib.contextmanager
def _plain_2d_bn():
    """The 2-D BN layer on ``bn_act``'s plain version (the float64 run:
    the kernel's wrapper takes f32 only)."""
    fused = layers.fused_bn_act_train
    layers.fused_bn_act_train = (
        lambda x, g, b, eps, act, group=None: bn_act_plain(x, g, b, eps, act))
    try:
        yield
    finally:
        layers.fused_bn_act_train = fused


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double().cpu()
    n = float(ref.norm())
    return float((a.double().cpu() - ref).norm()) / n if n else 0.0


def _run(family: str, base, cfg, table, cond, draws, dev, dtype,
         policy: str = "timed"):
    """(the iteration's state and losses, D's train-mode forward values on
    the first D-step's real rows, the cuDNN switches) on ``dev`` in
    ``dtype``, the card under ``policy`` (set after the build, which puts
    the parity switches in place)."""
    pair, _, _ = roadmap_main._build(family, dev)
    for g, src in ((pair.gen, base.gen), (pair.dis, base.dis)):
        g.params = _to(src.params, dev, dtype)
        g.opt_state = _to(g.opt_state, dev, dtype)
    d = Draws(*[None if v is None else
                [t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
                 for t in v] if isinstance(v, list)
                else v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                for v in draws])
    state = PairState(pair.gen.params, pair.gen.opt_state, pair.dis.params,
                      pair.dis.opt_state, torch.tensor(0, device=dev))
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
    labels = [t.to(dtype) for t in pair.label_vectors(d.g_z.shape[0],
                                                      real_label)]
    t = table.to(dev, dtype)
    c = None if cond is None else cond.to(dev, dtype)
    rows = d.d_idx[0]
    inputs = {pair.dis.input_names[0]: t.index_select(0, rows)}
    if c is not None:
        inputs[pair.label_name] = c.index_select(0, rows)
    one = pair.iteration(d.g_z.shape[0], n_critic, cfg.z_size)
    cudnn = torch.backends.cudnn
    with _policy(policy) if dev == "cuda" else contextlib.nullcontext():
        switches = dict(enabled=cudnn.enabled,
                        deterministic=cudnn.deterministic,
                        benchmark=cudnn.benchmark)
        with torch.no_grad():
            values, _ = pair.dis._forward(pair.dis.params, inputs, True)
        out = one(state, t, *labels, c, draws=d)
        if dev == "cuda":
            torch.cuda.synchronize()
    return out, values, switches


def triage(family: str, batch_size: int):
    base, cfg, _ = roadmap_main._build(family, "cpu")
    x, y = roadmap_main._data(family, N_ROWS, 7)
    table = torch.from_numpy(x)
    cond = None if y is None else torch.from_numpy(y)
    draws = base.draw(torch.Generator().manual_seed(8), N_ROWS, batch_size,
                      getattr(cfg, "n_critic", 1), cfg.z_size, "cpu")
    with _plain_2d_bn():
        ref, ref_values, _ = _run(family, base, cfg, table, cond, draws,
                                  "cpu", torch.float64)
    ref_leaves = fused_step._leaves(ref[0])
    runs = [("cpu_f32", "cpu")] + [(p, "cuda") for p in POLICIES]
    for name, dev in runs:
        (state, losses), values, switches = _run(
            family, base, cfg, table, cond, draws, dev, torch.float32, name)
        leaves = fused_step._leaves(state)
        grads: Dict[str, float] = {}
        for path, r in ref_leaves.items():
            if path[0].endswith("_opt") and path[-1] == "m":
                grads[".".join(map(str, path[:-1]))] = _rel(leaves[path], r)
        worst = max(grads, key=grads.get)
        bn = {k: v for k, v in grads.items() if "_bn" in k}
        print(json.dumps({
            "family": family, "run": name, "device": dev,
            "cudnn": switches if dev == "cuda" else None,
            "forward_rel_err": {k: _rel(v, ref_values[k])
                                for k, v in values.items()
                                if v.is_floating_point()},
            "worst_grad": [worst, grads[worst]],
            "bn_grad_rel_err": bn,
            "loss_rel_err": [abs(float(a) - float(b)) / max(abs(float(b)),
                                                             1e-12)
                             for a, b in zip(losses, ref[1])],
            "grad_rel_err": grads,
        }), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", action="append", default=None,
                   choices=roadmap_main.FAMILIES)
    p.add_argument("--batch-size", type=int,
                   default=roadmap_main.DEFAULT_BATCH_SIZE)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moment_triage needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for family in args.family or ["celeba", "cgan-cifar10"]:
        triage(family, args.batch_size)


if __name__ == "__main__":
    main()
