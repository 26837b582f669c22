"""Where the protocol step's time goes on the card.

Run: ``python -m gan_deeplearning4j_tpu_torch.train.profile_step``
(``--steps``, ``--warmup``, ``--batch-size``).  Builds the trainer on the
GPU, runs the warm-up steps, then traces ``--steps`` steps with
``torch.profiler`` (CPU and CUDA activities) and prints one JSON line: the
host-clock step time (median of as many untraced steps, and of the traced
ones), the device's busy time per step, its idle share of the traced wall
time, the port's kernel launches, and the device work that takes most
time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=200)
    p.add_argument("--n-train", type=int, default=10000)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    trainer = GANTrainer(M.CVConfig(), batch_size=args.batch_size,
                         n_train=args.n_train, device="cuda")
    trainer.train(args.warmup, log=None)
    untraced = trainer.train(args.steps, log=None)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = trainer.train(args.steps, log=None)
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
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, calls + 1)
    busy_us, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    n = args.steps
    out = {
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch_size, "steps": n,
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "step_ms_median": untraced["step_ms_median"],
        "step_ms_median_traced": result["step_ms_median"],
        "traced_wall_ms_per_step": wall_ms / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms) if spans else None,
        "device_events_per_step": len(spans) / n,
        "port_launches_per_step": {k: v / n for k, v in launches.items()},
        "top": [{"name": k[:120], "ms_per_step": ms / n, "calls_per_step": c / n}
                for k, (ms, c) in top],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
