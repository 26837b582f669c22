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

``--telemetry`` (``cv`` / ``insurance``, graphed or eager) profiles the
step with the in-graph telemetry block on and the same step without it,
each from its own trainer, and adds ``telemetry_split``: the step ms of
each (untraced medians, in turns), the block's cost, and the device work
the block adds per step, split by kind (``TELEMETRY_KINDS``: the
flattening copies, the reductions, the elementwise rest) with its extra
kernel launches; the part of the cost that no added kernel's time
explains is ``unattributed_ms`` (the graph's launch gaps, or the host's
launches when eager).  The block itself is not changed.
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
from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
    GANTrainer,
    GANTrainerConfig,
)
from gan_deeplearning4j_tpu_torch.utils.profiling import PORT_KERNELS

REPEATS = 5
# kinds of device work by kernel name, first match wins; "other" is the
# rest (torch's elementwise ops and reductions, copies)
KINDS = (("conv_dgrad", ("dgrad",)), ("conv_wgrad", ("wgrad",)),
         ("conv_fprop", ("fprop", "implicit_convolve")),
         ("layout", ("nchwtonhwc", "nhwctonchw", "transpose")),
         ("conv_other", ("convolve", "conv2d", "cudnn")),
         ("port", tuple(PORT_KERNELS.values())), ("gemm", ("gemm",)))


# the telemetry block's device work by kernel name, first match wins:
# torch.cat's batched copies flatten the trees, cuBLAS's dot and torch's
# reductions reduce them, the rest is elementwise (sub, sqrt, isfinite...)
TELEMETRY_KINDS = (("copy", ("cat", "copy")),
                   ("reduction", ("reduce", "dot", "gemv")))


def kind_of(name: str, kinds=KINDS) -> str:
    low = name.lower()
    for kind, keys in kinds:
        if any(k.lower() in low for k in keys):
            return kind
    return "other" if kinds is KINDS else "elementwise"


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
    p.add_argument("--telemetry", action="store_true",
                   help="profile the step with the in-graph telemetry "
                        "block and without it, and split the block's "
                        "cost (cv, insurance)")
    backend.add_bf16_flag(p)
    backend.add_mp_flag(p)
    args = p.parse_args(argv)
    if args.telemetry and args.workload not in ("cv", "insurance"):
        p.error("--telemetry profiles the protocol step (cv, insurance)")
    with backend.configured(**backend.flag_policy(args)):
        return _main(args)


def _main(args) -> Dict:
    if args.batch_size is None:
        args.batch_size = {"cv": 200, "insurance": 50}.get(
            args.workload, roadmap_main.DEFAULT_BATCH_SIZE)
    if args.workload in roadmap_main.FAMILIES:
        return _profile(args, *_pair_calls(args))
    if args.telemetry:
        return _telemetry_split(args)
    return _profile(args, *_protocol_call(args, _trainer(args)))


def _trainer(args, telemetry: bool = False) -> GANTrainer:
    """The protocol trainer of ``--workload`` on the card (``telemetry``:
    with the in-graph block), K = ``--steps`` steps a call."""
    n = args.steps
    if args.workload == "cv":
        if not telemetry:
            return GANTrainer(M.CVConfig(), batch_size=args.batch_size,
                              n_train=args.n_train, device="cuda",
                              steps_per_call=n)
        # the bare loop's configuration, with the block
        config = GANTrainerConfig(
            dataset_name="mnist", num_features=784, label_index=784,
            num_classes=10, batch_size=args.batch_size, batch_size_pred=500,
            num_iterations=0, num_gen_samples=10, print_every=0,
            save_every=0, res_path=None, steps_per_call=n, metrics=False,
            telemetry=True)
        return GANTrainer(n_train=args.n_train, device="cuda", config=config)
    # the program's trainer; its CSV pair is decoded at construction
    res = tempfile.mkdtemp(prefix="gan4j_profile_")
    try:
        return GANTrainer(
            device="cuda", workload=insurance_main.InsuranceWorkload(),
            config=insurance_main.default_config(
                res_path=res, batch_size=args.batch_size,
                num_iterations=0, print_every=0, save_every=0,
                metrics=False, steps_per_call=n, telemetry=telemetry))
    finally:
        shutil.rmtree(res, ignore_errors=True)


def _protocol_call(args, trainer: GANTrainer):
    """(call, capture set-up or None): K steps of ``trainer``, graphed or
    (``--eager``) eager on a copy of its state."""
    n = args.steps
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

    return call, None if args.eager else trainer.graphed.setup


def _telemetry_split(args) -> Dict:
    """``--telemetry``: the step with the block and without it (module
    docstring) -> the block-on profile, with ``telemetry_split``."""
    n = args.steps
    calls = {on: _protocol_call(args, _trainer(args, telemetry=on))
             for on in (True, False)}
    for on in (True, False):
        for _ in range(args.warmup):
            calls[on][0]()
    # the untraced step in turns (on, off, off, on, ...), medians
    times: Dict[bool, list] = {True: [], False: []}
    for r in range(REPEATS):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            calls[on][0]()
            times[on].append(time.perf_counter() - t0)
    step = {on: statistics.median(t) / n * 1e3 for on, t in times.items()}
    off = _profile(args, *calls[False], emit=False)
    out = _profile(args, *calls[True], emit=False)
    extra: Dict[str, list] = {}
    for name, (ms, c) in out["_by_name"].items():
        ms0, c0 = off["_by_name"].get(name, (0.0, 0))
        if c > c0:  # a kernel the block adds (or launches more often)
            extra[name] = [(ms - ms0) / n, (c - c0) / n]
    by_kind: Dict[str, float] = {kind: 0.0 for kind, _ in TELEMETRY_KINDS}
    by_kind["elementwise"] = 0.0
    for name, (ms, _) in extra.items():
        by_kind[kind_of(name, TELEMETRY_KINDS)] += ms
    cost = step[True] - step[False]
    added = sum(by_kind.values())
    out["telemetry_split"] = {
        "step_ms_on": step[True], "step_ms_off": step[False],
        "cost_ms": cost,
        "device_busy_ms_on": out["device_busy_ms_per_step"],
        "device_busy_ms_off": off["device_busy_ms_per_step"],
        "added_kernels_per_step": sum(c for _, c in extra.values()),
        "added_device_ms_by_kind": by_kind,
        "added_device_ms": added,
        "unattributed_ms": cost - added,
        "added_top": [{"name": k[:120], "ms_per_step": v[0],
                       "calls_per_step": v[1]}
                      for k, v in sorted(extra.items(),
                                         key=lambda kv: -kv[1][0])[:args.top]],
    }
    for d in (out, off):
        d.pop("_by_name")
    print(json.dumps(out))
    return out


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


def _profile(args, call, setup, emit: bool = True) -> Dict:
    """Warm-up, REPEATS untraced calls, then one traced call -> the report
    (printed as one JSON line when ``emit``; otherwise it keeps the device
    work by name under ``_by_name``)."""
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
    if emit:
        print(json.dumps(out))
    else:
        out["_by_name"] = by_name
    return out


if __name__ == "__main__":
    main()
