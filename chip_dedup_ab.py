#!/usr/bin/env python3
"""The CV program's streamed dedup tier against the plain chunk tier and
the resident table, on one card, in turns.

    python3 chip_dedup_ab.py [--rounds 5] [--iterations 600]
                             [--out chiprun_out/dedup_ab.json]

Each round runs ``cv_main`` (MNIST, 10,000 training rows, batch 200, dumps
every 100 steps, K = 100 steps a call, no FID) three times in this
process, once on each tier, in an order that rotates from round to round:

  - ``resident``: the table on the card (the program's default);
  - ``plain``: streamed in chunks of K steps of u8 codes
    (``data_on_device=False``, ``stream_dedup=False``);
  - ``dedup``: streamed with the dedup tier on auto (a pass of 50 batches
    fits one chunk): the u8 table crosses the link once and is decoded
    once, and each chunk ships its row schedule.

For each run: ``examples_per_sec`` (the program's steady window: every
call after the first, with its data waits, bookkeeping and dumps),
``step_ms_median`` (the median call's host clock over its K steps: the
replays and the loss readback only), the goodput phases' seconds, the
bytes a chunk put on the link and the final losses, which must be the
same bits on every tier.  The summary gives each tier's median, min and
max over the rounds, and the dedup run's ratio to the plain run of its
round.

Then each tier's per-step data read alone, device ms a step by CUDA events
(the stream parked on a sleep kernel first, so the events time the
device's work and not the launch rate): the plain tier's (200 rows of the
u8 chunk, decoded), the dedup tier's (200 entries of the schedule, then
those rows of the f32 table), and the dedup tier's one decode of its u8
table.

Every line names the card and its power limit (``nvidia-smi``).  Needs one
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ARGS = ["--n-train", "10000", "--n-test", "2000", "--print-every", "100",
        "--save-every", "100", "--fid-samples", "0"]
N_TRAIN, BATCH, K = 10000, 200, 100
# chip_smoke.py's chunk budget: K steps of u8 codes, 5 bytes a feature and
# 4 a label column, as the JAX trainer counts them
BUDGET = K * BATCH * (5 * 784 + 4 * 10)
TIERS = ("resident", "plain", "dedup")
REPS, TURNS = 200, 5  # data reads a timed turn, turns
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz clock


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def overrides(tier: str) -> dict:
    if tier == "resident":
        return {}
    out = {"data_on_device": False, "stream_chunk_bytes": BUDGET}
    if tier == "plain":
        out["stream_dedup"] = False
    return out


def one_run(tier: str, iterations: int, csv_dir: str, root: str) -> dict:
    """``cv_main`` on ``tier`` in a fresh res-path holding the CSV pair."""
    from gan_deeplearning4j_tpu_torch.train import cv_main

    d = tempfile.mkdtemp(prefix=f"{tier}_", dir=root)
    for f in ("mnist_train.csv", "mnist_test.csv"):
        shutil.copy(os.path.join(csv_dir, f), d)
    _, res = cv_main.run(cv_main.parse_args(
        ARGS + ["--iterations", str(iterations), "--res-path", d]),
        **overrides(tier))
    shutil.rmtree(d, ignore_errors=True)
    if (res["resident"] != (tier == "resident")
            or bool(res["stream_dedup"]) != (tier == "dedup")
            or res["steps_per_call"] != K):
        raise RuntimeError(f"{tier}: the run took another tier: {res}")
    gp = res["goodput"]
    return {"tier": tier, "examples_per_sec": res["examples_per_sec"],
            "step_ms_median": res["step_ms_median"],
            "goodput_s": {k: v for k, v in gp.items()
                          if isinstance(v, (int, float))},
            "link_bytes": res["link_bytes"],
            "losses": [res["d_loss"], res["g_loss"], res["clf_loss"]]}


def device_ms(fn, torch) -> float:
    """Device ms of one ``fn()``: REPS calls between two events behind a
    sleep kernel, the median of TURNS turns."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    turns = []
    for _ in range(TURNS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        turns.append(a.elapsed_time(b) / REPS)
    return statistics.median(turns)


def data_reads(torch) -> dict:
    """Each tier's per-step data read, as the captured step runs it, and the
    dedup tier's one table decode: device ms."""
    from gan_deeplearning4j_tpu_torch.train import fused_step as FT

    g = torch.Generator(device="cuda")
    g.manual_seed(20261021)
    u8 = lambda n: torch.randint(0, 256, (n, 784), generator=g,  # noqa: E731
                                 device="cuda").to(torch.uint8)
    chunk, table_u8 = u8(K * BATCH), u8(N_TRAIN)
    table = FT.decode_u8x100(table_u8)
    sched = torch.randint(0, N_TRAIN, (K * BATCH,), generator=g,
                          device="cuda").to(torch.int32)
    it = torch.tensor(37, device="cuda")
    return {
        "plain_step_read_ms": device_ms(lambda: FT.decode_u8x100(
            chunk.index_select(0, FT.batch_rows(it, K * BATCH, BATCH))),
            torch),
        "dedup_step_read_ms": device_ms(lambda: table.index_select(
            0, FT.indexed_rows(it, sched, BATCH)), torch),
        "dedup_table_decode_ms": device_ms(
            lambda: FT.decode_u8x100(table_u8), torch)}


def spread(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "all": xs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--iterations", type=int, default=600)
    p.add_argument("--out", default="chiprun_out/dedup_ab.json")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_dedup_ab: no CUDA device", file=sys.stderr)
        return 1
    from gan_deeplearning4j_tpu_torch.data import datasets

    smi = nvidia_smi()
    root = tempfile.mkdtemp(prefix="gan4j_dedup_ab_")
    runs = []
    try:
        csv_dir = os.path.join(root, "csv")
        datasets.ensure_mnist_csv(csv_dir, N_TRAIN, 2000)
        for r in range(args.rounds):
            order = TIERS[r % 3:] + TIERS[:r % 3]
            for tier in order:
                run = dict(one_run(tier, args.iterations, csv_dir, root),
                           round=r, nvidia_smi=smi)
                print(json.dumps(run), flush=True)
                runs.append(run)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = {json.dumps(r["losses"]) for r in runs}
    if len(losses) != 1:
        raise RuntimeError(f"the tiers' final losses differ: {losses}")
    by = {t: [r for r in runs if r["tier"] == t] for t in TIERS}
    summary = {
        "nvidia_smi": smi, "rounds": args.rounds,
        "iterations": args.iterations, "steps_per_call": K, "batch": BATCH,
        "examples_per_sec": {t: spread([r["examples_per_sec"] for r in rs])
                             for t, rs in by.items()},
        "step_ms_median": {t: spread([r["step_ms_median"] for r in rs])
                           for t, rs in by.items()},
        "dedup_over_plain": spread([
            d["examples_per_sec"] / p_["examples_per_sec"]
            for d, p_ in zip(by["dedup"], by["plain"])]),
        "link_bytes": {t: rs[0]["link_bytes"] for t, rs in by.items()},
        "data_reads": data_reads(torch), "losses_bitwise_across_tiers": True}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
