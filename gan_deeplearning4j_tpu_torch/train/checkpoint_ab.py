"""What checkpointing costs a program end to end, on one card.

    python -m gan_deeplearning4j_tpu_torch.train.checkpoint_ab \\
        [--program cv_main|insurance_main] [--every N] [--res-root DIR]
        [-- PROGRAM ARGS...]

Runs the program (``cv_main`` by default, at its defaults: 10,000 steps,
60,000 training rows) three times, each a fresh process on the same CSV
pair: without checkpoints, with ``--checkpoint-every N`` (default 1000;
synchronous saves) and with ``--checkpoint-every N --async-checkpoint``.
Prints one JSON line per run (the program's ``steps``,
``examples_per_sec``, the seconds of each save on the training thread, the
capture and end-of-run save seconds, the checkpoint bytes, the wall
seconds) and a
summary line: each checkpointed run's ``examples_per_sec`` as a share of
the run without checkpoints, and the card's name and power limit as
``nvidia-smi`` gives them.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

CSV_PAIRS = {"cv_main": ("mnist_train.csv", "mnist_test.csv"),
             "insurance_main": ("insurance_train.csv", "insurance_test.csv")}


def _run(module: str, res: str, args) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, "--res-path", res,
                           *args], capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{module} {args} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    ck_dir = os.path.join(res, "checkpoints")
    ckpt_bytes = None
    if os.path.isdir(ck_dir):
        last = max(int(n.split("_")[1]) for n in os.listdir(ck_dir)
                   if n.startswith("ckpt_"))
        with open(os.path.join(ck_dir, f"ckpt_{last}",
                               "MANIFEST.json")) as f:
            ckpt_bytes = sum(m["bytes"] for m in json.load(f)["files"].values())
    hs = result.get("host_seconds", {})
    return {"args": list(args), "steps": result["steps"],
            "examples_per_sec": result["examples_per_sec"],
            "step_ms_median": result.get("step_ms_median"),
            "checkpoint_s": hs.get("checkpoint_s"),
            "capture_s": hs.get("capture_s"), "save_s": hs.get("save_s"),
            "checkpoint_bytes": ckpt_bytes, "wall_s": wall}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--program", default="cv_main", choices=sorted(CSV_PAIRS))
    p.add_argument("--every", type=int, default=1000)
    p.add_argument("--res-root", default="outputs/checkpoint_ab")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="further program flags, after --")
    a = p.parse_args(argv)
    extra = [x for x in a.rest if x != "--"]
    module = f"gan_deeplearning4j_tpu_torch.train.{a.program}"
    shutil.rmtree(a.res_root, ignore_errors=True)
    os.makedirs(a.res_root)
    variants = {"none": [],
                "sync": ["--checkpoint-every", str(a.every)],
                "async": ["--checkpoint-every", str(a.every),
                          "--async-checkpoint"]}
    runs, first = {}, None
    for name, args in variants.items():
        res = os.path.join(a.res_root, name)
        os.makedirs(res)
        if first is not None:  # the same CSV pair, written once
            for f in CSV_PAIRS[a.program]:
                shutil.copy(os.path.join(first, f), os.path.join(res, f))
        runs[name] = _run(module, res, [*extra, *args])
        first = first or res
        print(json.dumps({"run": name, **runs[name]}), flush=True)
    base = runs["none"]["examples_per_sec"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    summary = {"program": a.program, "every": a.every, "nvidia_smi": smi,
               "examples_per_sec": {k: r["examples_per_sec"]
                                    for k, r in runs.items()},
               "share_of_no_checkpoint": {
                   k: r["examples_per_sec"] / base
                   for k, r in runs.items() if k != "none"}}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
