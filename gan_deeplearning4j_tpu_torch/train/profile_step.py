"""Where a training step's time goes on the card.

Run: ``python -m gan_deeplearning4j_tpu_torch.train.profile_step``
(``--steps``, ``--warmup``, ``--batch-size``, ``--eager``, ``--workload``,
and the precision flags ``--bf16`` / ``--mp``, which set the policy before
anything is built).
Builds the trainer on the GPU (which captures the step as a CUDA graph):
``--workload cv`` (the default) the DCGAN's on an in-memory MNIST table of
``--n-train`` rows at batch 200, ``--workload insurance`` the insurance
program's on its CSV pair (written to a temporary directory) at batch 50,
``--workload celeba`` / ``wgan-gp`` / ``cgan-cifar10`` a roadmap family's
``GANPair`` iteration (n_critic D-steps and a G-step, ``roadmap_main``'s
build and surrogate table of ``--n-train`` rows, with its labels for the
conditional family) at batch 128, and profiles calls of
``--steps`` steps, each ending in one readback of its losses: by default
the graphed step (``--steps`` replays a call), with ``--eager`` the eager
step, called directly on a copy of the trainer's state (the trainer itself
has no eager mode on one card).  After
``--warmup`` calls it times REPEATS untraced calls, then traces one
with ``torch.profiler`` (CPU and CUDA activities) between two CUDA events,
and prints one JSON line: the host-clock step time (untraced median, and
traced), the device's busy time per step and its idle share, of the traced
wall time and of the untraced step, the events' device time per step, the
port's kernel launches per step, the device work that takes most
time, each port kernel's own device time per step, and ``split``: the
device time per step by kind of work (``KINDS``: cuDNN's convolutions by
dgrad / wgrad / fprop, layout transposes, GEMMs, the port's kernels, the
rest) with the convolutions' share of it.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import subprocess
import tempfile
import time
from typing import Dict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.train import (
    fused_step,
    insurance_main,
    roadmap_main,
)
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

# each port kernel's device function (csrc/*.cu), as the trace names it
PORT_KERNELS = {"fused_update": "rmsprop_multi_kernel",
                "bn_act": "bn_act_kernel", "upsample_bwd": "upsample_bwd_kernel",
                "bn_moments": "bn_moments_kernel",
                "bn_apply": "bn_apply_kernel", "bn_act_4d": "bn_act_4d_kernel"}
REPEATS = 5
# kinds of device work by kernel name, first match wins; "other" is the
# rest (torch's elementwise ops and reductions, copies)
KINDS = (("conv_dgrad", ("dgrad",)), ("conv_wgrad", ("wgrad",)),
         ("conv_fprop", ("fprop", "implicit_convolve")),
         ("layout", ("nchwtonhwc", "nhwctonchw", "transpose")),
         ("conv_other", ("convolve", "conv2d", "cudnn")),
         ("port", tuple(PORT_KERNELS.values())), ("gemm", ("gemm",)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--workload", default="cv",
                   choices=["cv", "insurance", *roadmap_main.FAMILIES])
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: 200 (cv), 50 (insurance), 128 (the "
                        "roadmap families)")
    p.add_argument("--n-train", type=int, default=10000)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--eager", action="store_true",
                   help="profile the eager step instead of the graphed one")
    backend.add_bf16_flag(p)
    backend.add_mp_flag(p)
    args = p.parse_args(argv)
    with backend.configured(**backend.flag_policy(args)):
        return _main(args)


def _main(args) -> Dict:
    n = args.steps
    if args.batch_size is None:
        args.batch_size = {"cv": 200, "insurance": 50}.get(
            args.workload, roadmap_main.DEFAULT_BATCH_SIZE)
    if args.workload in roadmap_main.FAMILIES:
        return _profile(args, *_pair_calls(args))
    if args.workload == "cv":
        trainer = GANTrainer(M.CVConfig(), batch_size=args.batch_size,
                             n_train=args.n_train, device="cuda",
                             steps_per_call=n)
    else:
        # the program's trainer; its CSV pair is decoded at construction
        res = tempfile.mkdtemp(prefix="gan4j_profile_")
        try:
            trainer = GANTrainer(
                device="cuda", workload=insurance_main.InsuranceWorkload(),
                config=insurance_main.default_config(
                    res_path=res, batch_size=args.batch_size,
                    num_iterations=0, print_every=0, save_every=0,
                    metrics=False, steps_per_call=n))
        finally:
            shutil.rmtree(res, ignore_errors=True)
    if args.eager:
        box = {"state": fused_step.clone_state(trainer.state)}
        step = trainer.step_fn(n)
        inputs = (trainer.features, trainer.labels, trainer.y_real,
                  trainer.y_fake, trainer.ones)

        def call():
            box["state"], losses = step(box["state"], *inputs,
                                        z_gen=trainer.z_gen)
            return torch.stack(losses, -1).cpu()
    else:
        def call():
            return trainer.graphed(n)

    return _profile(args, call, None if args.eager else trainer.graphed.setup)


def _pair_calls(args):
    """(call, capture set-up or None) for a roadmap family's iteration:
    K = ``--steps`` iterations a call, graphed or (``--eager``) eager."""
    pair, cfg, _ = roadmap_main._build(args.workload, "cuda")
    x, y = roadmap_main._data(args.workload, args.n_train,
                              prng.NUMBER_OF_THE_BEAST)
    step, box = pair.make_multistep(
        torch.from_numpy(x).cuda(),
        None if y is None else torch.from_numpy(y).cuda(),
        batch_size=args.batch_size, steps_per_call=args.steps,
        n_critic=getattr(cfg, "n_critic", 1),
        real_label=getattr(cfg, "real_label", 1.0), z_size=cfg.z_size,
        graphed=not args.eager)
    state = {"s": box}

    def call():
        state["s"], (dl, gl) = step(state["s"])
        return torch.stack([dl, gl], -1).cpu()

    return call, None if args.eager else step.graphed.setup


def _profile(args, call, setup) -> Dict:
    n = args.steps
    for _ in range(args.warmup):
        call()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    untraced_ms = statistics.median(times) / n * 1e3
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    # device activity: the events the CUDA activity recorded (kernels,
    # memcpy, memset), grouped by name; busy time is the union of their
    # intervals, so overlapping streams are not counted twice
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t - s) / 1e3, calls + 1)
    busy_us, last = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > last:
            busy_us += t - max(s, last)
            last = t
    busy_ms = busy_us / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    out = {
        "mode": "eager" if args.eager else "graphed",
        "workload": args.workload,
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch_size, "steps": n,
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "step_ms_median": untraced_ms,
        "traced_wall_ms_per_step": wall_ms / n,
        "event_ms_per_step": start.elapsed_time(end) / n,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1.0 - busy_ms * n / wall_ms) if spans else None,
        "device_idle_share_untraced": (1.0 - busy_ms / untraced_ms)
        if spans else None,
        "device_events_per_step": len(spans) / n,
        "precision": dataclasses.asdict(backend.config()),
        "port_launches_per_step": {k: v / n for k, v in launches.items()},
        "top": [{"name": k[:120], "ms_per_step": ms / n, "calls_per_step": c / n}
                for k, (ms, c) in top],
        "port_kernels": {
            kernel: {"ms_per_step": sum(ms for k, (ms, _) in by_name.items()
                                        if fn in k) / n,
                     "calls_per_step": sum(c for k, (_, c) in by_name.items()
                                           if fn in k) / n}
            for kernel, fn in PORT_KERNELS.items()},
    }
    split = {kind: 0.0 for kind, _ in KINDS}
    split["other"] = 0.0
    for name, (ms, _) in by_name.items():
        split[kind_of(name)] += ms / n
    total = sum(split.values())
    out["split"] = {"ms_per_step": split, "conv_share": sum(
        v for k, v in split.items() if k.startswith("conv_")) / total
        if total else None}
    if setup is not None:
        out["capture"] = setup
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
