#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (gan_deeplearning4j_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  1. env      — torch/CUDA versions, the card's name and power limit, the
                TF32 switches (off: f32 parity mode).
  2. build    — nvcc builds every kernel under gan_deeplearning4j_tpu_torch/
                csrc/ for sm_90a (all sources at once).
  3. kernel   — each kernel against its plain torch version on the card,
                at the shapes one DCGAN protocol step at batch 200 gives it
                (the sync-BN pair at a 2-rank step's per-rank shapes, the
                4-D BN at the JAX package's benchmark shapes and at one
                shape whose channels take its streamed branch), then the
                times of that step's launches: kernel, plain version, one
                PyTorch library call where there is one, and the card's
                bound for the same work.  The RmsProp update runs as the
                step runs it, one multi-leaf launch per trained graph
                (dis, gan, classifier); each launch must also give the bits
                of one launch per leaf, of the same leaves' gradients as
                split views of one buffer at an odd offset (the
                data-parallel layout: the scalar path) and of a second
                launch, and beside its device time stands the host's time
                to enqueue the three launches.  A ``plans`` line gives the
                launch plan (cluster size, grid, shared memory, branch) of
                each launch of the two cluster BN kernels and the grids of
                the pair's moments and apply kernels; each kernel must give
                the same bits on two launches, and each is
                timed in turns with its library call (kernel, library,
                library, kernel).  The pair's apply kernel runs as the
                data-parallel step runs it, from the all-reduced sums: its
                mean and var must be the bits of the torch epilogue it
                replaces, for worlds 1-4; both pair kernels must give the
                same bits from an offset view of x (their scalar path) as
                from x.  Beside each kernel's time stands ``floor_ms``: as
                many back-to-back empty launches, timed the same way.  A
                ``kernel_insurance`` line does the same at the insurance
                step's shapes: ``bn_act`` at each of its four BNs (shape,
                activation, gradient, bitwise repeat, time against
                ``F.batch_norm`` in turns, floor and bound), the pair at a
                2-rank insurance step's per-rank shapes ([25, 2] on the
                scalar path) and ``fused_update`` over its three leaf
                tables.
  4. main     — the trainer (the cv_main entry) on cuda for 20 protocol
                steps at batch 200, full width, on synthetic MNIST, as
                cv_main runs it on one card: the step captured as a CUDA
                graph, two calls of 10 replays.  The launch counters are
                zeroed just before and read just after (a replay counts
                the launches its capture recorded), and each kernel must
                have run its expected count per step (``fused_update`` once
                per graph update: 3).  Then a 10x10 latent grid from the
                trained generator.
  5. parity   — one protocol step on cuda (kernels) and on the CPU (plain
                versions) from the same state, latents and targets.
  6. graph    — from one start, 20 eager steps against two graphed calls
                of 10 replays, bitwise (losses and the final state), with
                and without the generator EMA; the eager and the graphed
                step timed in turns, the capture's seconds and memory, and
                the copy-back's device time.
  7. dp       — data parallel over torch.distributed, two ranks (one per
                card over NCCL when two cards are attached, else both on
                cuda:0 over gloo), one process each: the sync-BN pair's
                gradient against its plain composition, one 2-rank step
                against one single-process step, then 20 trainer steps at
                global batch 200 with exact per-rank launch counts and the
                ranks' final states bitwise equal, and the time of one
                step's gradient all-reduces alone, then 4 steps of the
                unfused per-fit loop with param_averaging (exact launch
                counts, the ranks' states bitwise equal after the last
                average), then INS_DP_STEPS insurance steps at global
                batch 50 (the pair at [50, 12], [25, 2], [25, 12],
                [25, 100] per rank), each held against the single-process
                step, with exact launch counts; then, in this process,
                one step of a 1-rank NCCL group against the single-process
                step, and under torch.profiler one sync-BN forward per BN
                shape on that group: exactly one moments and one apply
                kernel and nothing but NCCL's work beside them (the old
                composition, profiled beside it, shows what it replaced).
  8. cv_main  — the CV program as a user runs it (``cv_main``: the CSV
                pair written and decoded, 200 steps at batch 200 graphed in
                calls of K = 100, the grid and prediction dumps at 100 and
                200, the four model zips, the evaluation with FID on 2,000
                samples), three times: with the launch counters zeroed just
                before and read just after (a warm-up step and 200 replays'
                worth), the dumps' shapes, the metrics JSONL, the zips read
                back bit for bit as the trained graphs, finite scores; then
                with ``--sync-dumps`` (the dumps byte-identical); then with
                the table streamed in chunks of 100 steps (per-step losses
                bitwise the resident run's).  Host seconds of the export,
                decode, upload, capture, each dump, the save and the
                evaluation, and examples/sec, beside the card's name and
                power limit.
  9. insurance — the insurance program as a user runs it
                (``insurance_main`` at its defaults: 5,000 steps at batch
                50 graphed in calls of K = 100, the grid, grid-extras and
                prediction dumps every 100 steps, the four model zips, the
                AUROC), twice: with the launch counters zeroed just before
                and read just after (4 ``bn_act`` and 3 ``fused_update`` a
                step, warm-up included, nothing else), every dump's shape,
                the metrics JSONL, the zips read back bit for bit, a test
                AUROC above 0.5; then with ``--sync-dumps`` (every dump
                byte-identical).  Then the program's step graphed against
                eager (bitwise over 20 steps) and the two timed in turns.
 10. resume   — checkpoints, preemption and resume, each check required:
                the insurance program at its defaults in child processes,
                one sent SIGTERM after step 2,000 (exit 75, PREEMPTED.json,
                a verified checkpoint at its step) and one resuming it to
                5,000, bitwise the insurance phase's uninterrupted run (the
                four zips' params and updater state, every metrics record,
                test_auroc); the CV program at full width, 400 steps at
                batch 200 with checkpoints every 100, preempted at 200 and
                resumed in this process (bitwise the uninterrupted run,
                with the resumed path's launch counts), and in a child
                process from a copy of that checkpoint (the largest param
                difference and the bound it meets); the latent generator's state after graph replays
                against eager draws; the insurance step at world 2 over
                gloo on one card, checkpointed at 4 and resumed to 8
                (equal to the uninterrupted world-2 run); one run whose
                first CSV read meets an injected transient OSError (one
                retry); and the cost of a checkpoint (snapshot ms, sync
                and async save seconds, bytes, restore seconds, the
                capture after a resume) for both models.
 11. roadmap  — the roadmap families (``roadmap_main``: CelebA-64 DCGAN,
                WGAN-GP and the conditional cgan-cifar10 on the ``GANPair``
                engine, Adam) at full width and batch 128: ``bn_act`` at
                the celeba and wgan-gp generators' gen_bn0 shapes ([128,
                8192] and [128, 6272], relu) against its plain version and
                its gradient, bitwise repeat, timed against
                ``F.batch_norm`` in turns; one iteration of each of the
                three families on the card against the CPU path from the
                same params and draws; RM_K graphed iterations against
                RM_K eager ones, bitwise, with and without the EMA, the
                capture's seconds and pool memory, and the two timed in
                turns; each program as a child process (artifacts, result
                line, and the port kernels' launches around its graphed
                iterations: one ``bn_act`` an iteration for celeba and
                wgan-gp, none of the six for cgan-cifar10, whose child also
                prints its ``examples_per_sec``, ``conditional_fidelity``
                and ``mean_class_fid``); celeba's and wgan-gp's ``train``
                in this process with the launch counters zeroed just before
                and read just after; and celeba checkpointed at 100 and
                resumed in this process, its zips byte-equal to the
                200-iteration straight run's.
 12. precision — the reference's precision modes (``--bf16``: bf16
                operands into every convolution and GEMM, result rounded
                once; ``--mp``: bf16 params and activations with f32
                master params, BNs and losses), per workload (cv,
                insurance, celeba, wgan-gp, cgan-cifar10) in ``--bf16``
                and ``--mp``, cv and celeba also in both: PR_CALLS graphed
                calls of PR_K replays against as many eager calls from one
                start, bit for bit, with each port kernel's launches (eager
                run and per replay) equal to PR_PER_STEP (``upsample_bwd``
                0 under ``--mp``: its bf16 cotangent takes the plain block
                sum, as in the JAX package) and finite losses; the same in
                parity, whose losses give each mode's drift (max |d| and
                the final step's); one step at learning rates 0 on the card
                against the CPU in the mode, within the mode's own distance
                from parity; each f32-only wrapper refusing bf16; the plain
                bf16 block sum timed at the CV shapes beside the f32
                kernel; and ``roadmap_main --family cgan-cifar10 --mp`` and
                ``cv_main --bf16 --mp`` as child processes, evaluation
                included.
 13. the ``kernels`` line (each kernel's insurance numbers beside the
     CV step's, where the insurance path runs it, ``bn_act``'s roadmap
     numbers, each kernel's launches on the cgan-cifar10 path: 0, and
     its launches per workload and mode in the precision phase), the
     seconds line (the script's total beside its total before the
     precision phase was added), the nvidia-smi
     line, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is available.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 200
MAIN_STEPS = 20
MAIN_K = 10  # steps per call of the main path: two calls
GRAPH_STEPS = 20  # the graph phase's eager run and graphed run
TURN_CALLS = 5  # calls of MAIN_K steps in one timed turn
N_TRAIN = 10000
DP_WORLD = 2
DP_TIMEOUT_S = 300
PA_STEPS = 4  # the dp phase's param_averaging run
# the cv_main phase: the program at its reference cadences, cut to 200 steps
CV_ARGS = ["--n-train", "10000", "--n-test", "2000", "--iterations", "200",
           "--print-every", "100", "--save-every", "100",
           "--fid-samples", "2000"]
CV_STEPS = 200
CV_K = 100
PA_FREQ = 2
# the insurance program (insurance_main) at its reference defaults: 5,000
# steps at batch 50, dumps every 100 steps, K = 100 steps a call
INS_STEPS = 5000
INS_K = 100
INS_BATCH = 50
INS_TURN_K = 10  # steps per call of the insurance phase's timed turns
INS_DP_STEPS = 4  # the dp phase's insurance steps per rank
# the insurance step's 2-D BNs on one card (dis, gan's two, classifier)
# and, at 2 ranks, the sync-BN pair's per-rank shapes
INS_BN = [((100, 12), "elu"), ((50, 2), "tanh"), ((50, 12), "elu"),
          ((50, 100), "elu")]
INS_PAIR = [((50, 12), "elu"), ((25, 2), "tanh"), ((25, 12), "elu"),
            ((25, 100), "elu")]
# the insurance step against another from the same state: STEP_TOL, with
# params held to one generator learning rate of this model (4e-4)
INS_STEP_TOL = {"loss": 1e-4, "param": 4e-4, "cache": 5e-2}
REPS = 30
# the script's whole run before the precision phase was added (from a
# git archive of that tree, NVIDIA H100 80GB HBM3, 700.00 W)
TOTAL_BEFORE_PRECISION_S = 419.0
T_START = 0.0
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz clock
# each kernel's CUDA source and the Pallas kernel it replaces
SOURCES = {"fused_update": "fused_update.cu", "bn_act": "bn_act.cu",
           "upsample_bwd": "upsample_bwd.cu",
           "bn_moments": "bn_moments_apply.cu",
           "bn_apply": "bn_moments_apply.cu", "bn_act_4d": "bn_act_4d.cu"}
REPLACES = {"fused_update": "ops/pallas/fused_update.py:40",
            "bn_act": "ops/pallas/bn_act.py:56",
            "upsample_bwd": "ops/pallas/dma_pipeline.py:86",
            "bn_moments": "ops/pallas/bn_act.py:71",
            "bn_apply": "ops/pallas/bn_act.py:79",
            "bn_act_4d": "ops/pallas/bn_act.py:180"}
# f32 peak outside the tensor cores and device-memory bandwidth, by card
# (NVIDIA data sheets, dense rates, full power limit)
PEAK_F32_FLOPS = 67e12
BANDWIDTH = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
             ("H100", 3.35e12))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bandwidth_for(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"chip_smoke: no memory bandwidth on record for {name!r}")


def time_ms(fn, torch) -> float:
    """Device time of one call of ``fn`` (a whole step's launches of one
    kernel), median over REPS after three warm-ups.  Each repetition first
    parks the stream on a sleep kernel (~20 ms) so the host has enqueued
    the start event, every launch and the end event before the device
    reaches them: the events then time the device's work back to back, not
    the Python wrappers' launch rate.  A repetition whose enqueue took
    longer than half the sleep (a host hiccup) is dropped and run again;
    more than REPS drops fail the run."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, dropped = [], []
    for _ in range(2 * REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        enqueue = time.perf_counter() - t0
        end.synchronize()
        if enqueue < 0.01:
            times.append(start.elapsed_time(end))
        else:
            dropped.append(enqueue)
        if len(times) == REPS:
            return statistics.median(times)
    raise RuntimeError(
        f"chip_smoke: the host took {max(dropped) * 1e3:.1f} ms to enqueue a "
        f"timed group ({len(dropped)} of {2 * REPS} repetitions over 10 ms); "
        "the sleep no longer covers it")


def in_turns(kernel_fn, library_fn, torch):
    """(kernel ms, library ms, the four times): timed kernel, library,
    library, kernel, so a drift of the card's clock over the run touches
    both; each number is the mean of its two turns."""
    k1 = time_ms(kernel_fn, torch)
    l1 = time_ms(library_fn, torch)
    l2 = time_ms(library_fn, torch)
    k2 = time_ms(kernel_fn, torch)
    return (k1 + k2) / 2, (l1 + l2) / 2, [k1, l1, l2, k2]


def floor_ms(n: int, torch) -> float:
    """What no group of ``n`` launches can beat: ``n`` back-to-back empty
    launches (``torch.cuda._sleep(0)``) timed as ``time_ms`` times a
    kernel's group."""
    return time_ms(lambda: [torch.cuda._sleep(0) for _ in range(n)], torch)


def offset_view(x, torch):
    """A copy of ``x`` that starts 4 bytes past a 16-byte boundary (a
    contiguous view of a larger buffer): the pair kernels' scalar path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view_as(x)


def old_epilogue(sums, world, torch):
    """The sync-BN forward's epilogue before the apply kernel took it over
    (``mesh.all_reduce_mean`` after the collective, then ``_BnSync``):
    -> (mean, var)."""
    flat = torch.cat([sums.reshape(-1)])
    flat /= world
    stats = flat.view_as(sums)
    return stats[0].clone(), stats[1] - torch.square(stats[0])


def bitwise_repeat(fn, inputs, torch) -> bool:
    """Two launches on the same inputs give the same bits."""
    return all(torch.equal(a, b) for args in inputs
               for a, b in zip(fn(*args), fn(*args)))


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def within(a, b, atol: float, rtol: float) -> bool:
    return bool(((a.double() - b.double()).abs()
                 <= atol + rtol * b.double().abs()).all())


# one protocol step against another from the same state.  Losses: 1e-4
# relative.  Params and BN statistics: 4e-3 absolute, one generator
# learning rate — RmsProp's update is ~lr*sign(g), and an element whose
# gradient lies near 0 sits on its linear part (slope lr/sqrt(eps) = 40),
# so rounding may move it by up to one lr; a wiring error moves whole
# leaves by lr and shifts the losses.  RmsProp caches (~g^2): 5e-2 of the
# leaf's largest value plus eps (a cache enters the update only as
# cache + eps); a frozen input BN's running-stat gradient sums 200*784
# terms that cancel.
STEP_TOL = {"loss": 1e-4, "param": 4e-3, "cache": 5e-2}


def step_diff(ref, got):
    """(loss relative error, {kind: (worst, where)}) between two
    (state, losses) results of the protocol step."""
    from gan_deeplearning4j_tpu_torch.train.fused_step import state_trees

    (s_ref, l_ref), (s_got, l_got) = ref, got
    loss_err = max(abs(float(a) - float(b)) / max(abs(float(a)), 1e-6)
                   for a, b in zip(l_ref, l_got))
    worst = {"param": (0.0, ""), "cache": (0.0, "")}
    for field, tree in state_trees(s_ref):
        kind = "cache" if field.endswith("_opt") else "param"
        for layer, lp in tree.items():
            for pname, a in lp.items():
                b = getattr(s_got, field)[layer][pname].to(a.device)
                d = max_err(a, b)
                if kind == "cache":
                    d /= float(a.abs().max()) + 1e-8
                if d >= worst[kind][0]:
                    worst[kind] = (d, f"{field}.{layer}.{pname}")
    return loss_err, worst


def require_step_match(what, loss_err, worst, tol=STEP_TOL) -> None:
    require(loss_err <= tol["loss"],
            f"{what}: loss relative error {loss_err} > {tol['loss']}")
    for kind, (d, where) in worst.items():
        require(d <= tol[kind], f"{what}: {where} differs by {d} > {tol[kind]}")


def protocol_step(device, group=None):
    """A fresh DCGAN (seed 666: the same init in every process) and its
    protocol step -> (step, state)."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.train import fused_step

    cfg = M.CVConfig()
    d = M.build_discriminator(cfg, device)
    graphs = (d, M.build_generator(cfg, device), M.build_gan(cfg, device),
              M.build_classifier(d, cfg))
    step = fused_step.make_protocol_step(
        *graphs, M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER,
        z_size=cfg.z_size, num_features=cfg.num_features, group=group)
    return step, fused_step.state_from_graphs(*graphs)


def run_step(step, state, host, device):
    a = {k: v.to(device) for k, v in host.items()}
    return step(state, a["real"], a["labels"], a["y_real"], a["y_fake"],
                a["ones"], z1=a["z1"], z2=a["z2"])


def group_vs_single(group, host):
    """One step with ``group`` against one single-process step on the
    rank's card from the same state, latents and targets."""
    dev = group.device
    got = run_step(*protocol_step(dev, group), host, dev)
    ref = run_step(*protocol_step(dev), host, dev)
    return step_diff(ref, got)


def state_digest(state) -> str:
    """sha256 over every tensor of a ProtocolState (the EMA tree included
    when there is one) and its step counter, in a fixed order."""
    from gan_deeplearning4j_tpu_torch.train.fused_step import state_trees

    h = hashlib.sha256()
    for field, tree in state_trees(state):
        for layer in sorted(tree):
            for pname, t in sorted(tree[layer].items()):
                h.update(f"{field}.{layer}.{pname}".encode())
                h.update(t.detach().cpu().numpy().tobytes())
    h.update(str(int(state.it)).encode())
    return h.hexdigest()


def insurance_protocol(device, group=None):
    """A fresh insurance MLP-GAN (seed 666) and its protocol step ->
    (step, state)."""
    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
    from gan_deeplearning4j_tpu_torch.train import fused_step

    cfg = MI.InsuranceConfig()
    d = MI.build_discriminator(cfg, device)
    graphs = (d, MI.build_generator(cfg, device), MI.build_gan(cfg, device),
              MI.build_classifier(d, cfg))
    step = fused_step.make_protocol_step(
        *graphs, MI.DIS_TO_GAN, MI.GAN_TO_GEN, MI.DIS_TO_CLASSIFIER,
        z_size=cfg.z_size, num_features=cfg.num_features, group=group)
    return step, fused_step.state_from_graphs(*graphs)


def insurance_host(torch, steps: int) -> dict:
    """CPU tensors of ``steps`` insurance steps at batch 50: the first two
    batches of the program's training table (``insurance_train.csv``), the
    softened targets and global latents, from fixed seeds."""
    from gan_deeplearning4j_tpu_torch.data import datasets
    from gan_deeplearning4j_tpu_torch.data.csv import RecordReaderDataSetIterator

    d = tempfile.mkdtemp(prefix="gan4j_ins_host_")
    try:
        train_csv, _ = datasets.ensure_insurance_csv(d)
        it = RecordReaderDataSetIterator(train_csv, INS_BATCH, 12, 1)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rng = torch.Generator().manual_seed(8)
    B = INS_BATCH
    return dict(
        real=torch.from_numpy(it.features[:2 * B].copy()),
        labels=torch.from_numpy(it.labels[:2 * B].copy()),
        y_real=1.0 + 0.05 * torch.randn((B, 1), generator=rng),
        y_fake=0.05 * torch.randn((B, 1), generator=rng),
        ones=torch.ones((B, 1)),
        z1=torch.rand((steps, B, 2), generator=rng) * 2 - 1,
        z2=torch.rand((steps, B, 2), generator=rng) * 2 - 1)


def insurance_dp(group, ins) -> dict:
    """INS_DP_STEPS insurance steps on ``group`` (the counters zeroed just
    before and read just after), each held against the single-process step
    on the rank's card from the same state, table, targets and latents."""
    import torch

    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels

    dev = group.device
    a = {k: v.to(dev) for k, v in ins.items()}
    inputs = (a["real"], a["labels"], a["y_real"], a["y_fake"], a["ones"])
    step_g, state_g = insurance_protocol(dev, group)
    step_s, state_s = insurance_protocol(dev)
    outs_g, outs_s = [], []
    kernels.reset_launch_counts()
    for i in range(INS_DP_STEPS):
        state_g, losses = step_g(state_g, *inputs, z1=a["z1"][i], z2=a["z2"][i])
        outs_g.append((state_g, losses))
    torch.cuda.synchronize(dev)
    launches = kernels.launch_counts()
    for i in range(INS_DP_STEPS):
        state_s, losses = step_s(state_s, *inputs, z1=a["z1"][i], z2=a["z2"][i])
        outs_s.append((state_s, losses))
    return {"launches": launches,
            "losses": [[float(v) for v in ls] for _, ls in outs_g],
            "vs_single": [step_diff(s, g) for s, g in zip(outs_s, outs_g)],
            "digest": state_digest(state_g)}


def insurance_kernels(torch, randn, dev, bw: float, sms: int) -> dict:
    """The kernels of the insurance step at its shapes, each against its
    plain version: ``bn_act`` at each single-device BN (shape and
    activation) with its gradient, a bitwise repeat, and its time against
    ``F.batch_norm`` in turns, one launch's floor and its bound; the
    sync-BN pair at a 2-rank step's per-rank shapes (the step's four
    launches of each kernel as one timed group; [25, 2] takes the scalar
    path); ``fused_update`` over the insurance step's three leaf tables.
    Returns the phase's line and the two groups' rows for the kernels
    line."""
    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
        bn_act_plain,
        bn_apply_sums_plain,
        bn_moments_plain,
    )
    from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
        rmsprop_chain_plain,
    )

    torch_f = torch.nn.functional

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAK_F32_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    # bn_act, shape by shape
    rows, err = [], 0.0
    bn_in = [((randn(b, f, scale=0.5, shift=0.2), randn(f, scale=0.1, shift=1.0),
               randn(f, scale=0.1)), act) for (b, f), act in INS_BN]
    for (x, gm, bt), act in bn_in:
        b, f = x.shape
        yk, mk, vk = kernels.fused_bn_act_train(x, gm, bt, 1e-5, act)
        yp, mp, vp = bn_act_plain(x, gm, bt, 1e-5, act)
        require(within(yk, yp, 1e-5, 1e-4) and within(mk, mp, 1e-6, 1e-4)
                and within(vk, vp, 1e-6, 1e-4),
                f"bn_act disagrees with its plain version at [{b},{f}] {act}")
        e = max(max_err(yk, yp), max_err(mk, mp), max_err(vk, vp))
        err = max(err, e)
        require(bitwise_repeat(lambda *t: kernels.fused_bn_act_train(
            *t, 1e-5, act), [(x, gm, bt)], torch),
            f"bn_act: two launches differ at [{b},{f}]")
        leaves = [t.clone().requires_grad_(True) for t in (x, gm, bt)]
        gy = randn(b, f)
        gk = torch.autograd.grad(kernels.fused_bn_act_train(
            *leaves, 1e-5, act)[0], leaves, gy)
        gp = torch.autograd.grad(bn_act_plain(*leaves, 1e-5, act)[0], leaves, gy)
        require(all(within(u, v, 1e-4, 1e-3) for u, v in zip(gk, gp)),
                f"bn_act gradient disagrees at [{b},{f}] {act}")
        ms, library_ms, turns = in_turns(
            lambda: kernels.fused_bn_act_train(x, gm, bt, 1e-5, act),
            lambda: torch_f.batch_norm(x, None, None, gm, bt, training=True,
                                       eps=1e-5), torch)
        bound_ms, bound_by = bound(8 * b * f + 16 * f, 10 * b * f)
        rows.append(dict(shape=[b, f], act=act,
                         plan=bn2d.launch_plan(b, f, sms)._asdict(),
                         max_abs_err=e, ms=ms, library_ms=library_ms,
                         turns_ms=turns, floor_ms=floor_ms(1, torch),
                         bound_ms=bound_ms, bound_by=bound_by,
                         kernel_slower_than_library=ms > library_ms))
    xs = [t for t, _ in bn_in]
    group = dict(
        calls=[f"[{b},{f}] {act}" for (b, f), act in INS_BN], max_abs_err=err,
        ms=time_ms(lambda: [kernels.fused_bn_act_train(*t, 1e-5, act)
                            for t, act in bn_in], torch),
        plain_ms=time_ms(lambda: [bn_act_plain(*t, 1e-5, act)
                                  for t, act in bn_in], torch),
        library_ms=time_ms(lambda: [torch_f.batch_norm(
            x, None, None, gm, bt, training=True, eps=1e-5)
            for x, gm, bt in xs], torch),
        floor_ms=floor_ms(len(bn_in), torch))
    group["bound_ms"], group["bound_by"] = bound(
        sum(8 * b * f + 16 * f for (b, f), _ in INS_BN),
        sum(10 * b * f for (b, f), _ in INS_BN))
    out = {"bn_act": rows}
    groups = {"bn_act": group}

    # the sync-BN pair from the sums of 2 ranks (sums made from this
    # input's moments times two, plus noise)
    pair_in = [((randn(b, f, scale=0.5, shift=0.2),
                 randn(f, scale=0.1, shift=1.0), randn(f, scale=0.1)), act)
               for (b, f), act in INS_PAIR]
    pairs = []
    err_m = err_a = 0.0
    for (x, gm, bt), act in pair_in:
        b, f = x.shape
        for u, v in zip(kernels.bn_moments(x), bn_moments_plain(x)):
            require(within(u, v, 1e-6, 1e-4),
                    f"bn_moments disagrees with its plain version at [{b},{f}]")
            err_m = max(err_m, max_err(u, v))
        mean, m2 = bn_moments_plain(x)
        noise = randn(2, f, scale=1e-3)
        sums = torch.stack([mean, m2]) * DP_WORLD + noise * noise
        yk, mk, vk = kernels.bn_apply_sums(x, sums, DP_WORLD, gm, bt, 1e-5, act)
        yp, mp, vp = bn_apply_sums_plain(x, sums, DP_WORLD, gm, bt, 1e-5, act)
        require(within(yk, yp, 1e-5, 1e-4) and torch.equal(mk, mp)
                and torch.equal(vk, vp),
                f"bn_apply (from sums) disagrees at [{b},{f}] {act}")
        err_a = max(err_a, max_err(yk, yp))
        xo = offset_view(x, torch)
        require(all(torch.equal(u, v) for u, v in zip(
            kernels.bn_moments(x), kernels.bn_moments(xo))) and all(
            torch.equal(u, v) for u, v in zip(
                kernels.bn_apply_sums(x, sums, DP_WORLD, gm, bt, 1e-5, act),
                kernels.bn_apply_sums(xo, sums, DP_WORLD, gm, bt, 1e-5, act))),
            f"the pair's scalar path (offset view) gives other bits at [{b},{f}]")
        pairs.append((x, sums, gm, bt, act))
    require(bitwise_repeat(kernels.bn_moments, [(p[0],) for p in pairs], torch)
            and bitwise_repeat(lambda x, s_, g, b_, a: kernels.bn_apply_sums(
                x, s_, DP_WORLD, g, b_, 1e-5, a), pairs, torch),
            "the pair: two launches differ at an insurance shape")
    epilogues = [old_epilogue(p[1], DP_WORLD, torch) for p in pairs]
    m_ms, m_lib, m_turns = in_turns(
        lambda: [kernels.bn_moments(p[0]) for p in pairs],
        lambda: [torch.var_mean(p[0], dim=0, unbiased=False) for p in pairs],
        torch)
    a_ms, a_lib, a_turns = in_turns(
        lambda: [kernels.bn_apply_sums(x, s_, DP_WORLD, g, b_, 1e-5, a)
                 for x, s_, g, b_, a in pairs],
        lambda: [torch_f.batch_norm(p[0], m, v, p[2], p[3], training=False,
                                    eps=1e-5)
                 for p, (m, v) in zip(pairs, epilogues)], torch)
    shapes = [(b, f) for (b, f), _ in INS_PAIR]
    groups["bn_moments"] = dict(
        calls=[f"[{b},{f}]" for b, f in shapes], max_abs_err=err_m, ms=m_ms,
        library_ms=m_lib, turns_ms=m_turns,
        plain_ms=time_ms(lambda: [bn_moments_plain(p[0]) for p in pairs], torch),
        floor_ms=floor_ms(len(pairs), torch),
        plans=[bn2d.moments_plan(b, f)._asdict() for b, f in shapes])
    groups["bn_moments"]["bound_ms"], groups["bn_moments"]["bound_by"] = bound(
        sum(4 * b * f + 8 * f for b, f in shapes), sum(3 * b * f for b, f in shapes))
    groups["bn_apply"] = dict(
        calls=[f"[{b},{f}] {a}, from the sums of {DP_WORLD} ranks"
               for (b, f), a in INS_PAIR], max_abs_err=err_a, ms=a_ms,
        library_ms=a_lib, turns_ms=a_turns,
        plain_ms=time_ms(lambda: [bn_apply_sums_plain(x, s_, DP_WORLD, g, b_,
                                                      1e-5, a)
                                  for x, s_, g, b_, a in pairs], torch),
        floor_ms=floor_ms(len(pairs), torch),
        plans=[bn2d.apply_plan(b, f, sms)._asdict() for b, f in shapes])
    groups["bn_apply"]["bound_ms"], groups["bn_apply"]["bound_by"] = bound(
        sum(8 * b * f + 24 * f for b, f in shapes),
        sum(10 * b * f + 5 * f for b, f in shapes))

    # fused_update over the three leaf tables, each leaf with its rates
    cfg = MI.InsuranceConfig()
    dis = MI.build_discriminator(cfg, dev)
    updates, n_elems, err = [], 0, 0.0
    for g in (dis, MI.build_gan(cfg, dev), MI.build_classifier(dis, cfg)):
        keys = [(layer, n) for layer, lp in g.params.items() for n in lp]
        shp = [g.params[layer][n].shape for layer, n in keys]
        updates.append(dict(
            ps=[randn(*t, scale=0.05) for t in shp],
            gs=[randn(*t, scale=0.02) for t in shp],
            cs=[randn(*t, scale=1e-3).abs() for t in shp],
            rates=[g.updater.rates(layer, n) for layer, n in keys],
            clip=g.updater.clip_threshold))
        n_elems += sum(math.prod(t) for t in shp)

    def chains(u):
        return kernels.fused_rmsprop_chains(u["ps"], u["gs"], u["cs"],
                                            u["rates"], clip=u["clip"])

    def chains_plain(u):
        return [rmsprop_chain_plain(p, g, c, **r._asdict(), clip=u["clip"])
                for p, g, c, r in zip(u["ps"], u["gs"], u["cs"], u["rates"])]

    for u in updates:
        pk, ck = chains(u)
        for (pp, cp), a_, b_ in zip(chains_plain(u), pk, ck):
            require(within(a_, pp, 1e-6, 1e-5) and within(b_, cp, 1e-12, 1e-5),
                    "fused_update disagrees with its plain version on an "
                    f"insurance leaf {tuple(pp.shape)}")
            err = max(err, max_err(a_, pp), max_err(b_, cp))
        pk2, ck2 = chains(u)
        require(all(torch.equal(a_, b_) for a_, b_ in zip(pk + ck, pk2 + ck2)),
                "fused_update: two launches differ on an insurance table")
    groups["fused_update"] = dict(
        calls=[f"{len(u['ps'])} leaves" for u in updates], max_abs_err=err,
        ms=time_ms(lambda: [chains(u) for u in updates], torch),
        plain_ms=time_ms(lambda: [chains_plain(u) for u in updates], torch),
        library_ms=None, floor_ms=floor_ms(len(updates), torch))
    groups["fused_update"]["bound_ms"], groups["fused_update"]["bound_by"] = \
        bound(20 * n_elems, 12 * n_elems)
    out["groups"] = groups
    return out


def dump_summary(host_seconds: dict) -> dict:
    """``host_seconds`` with its per-dump records summed by kind (a long
    run's hundreds of records do not fit on one line)."""
    out = {k: v for k, v in host_seconds.items() if k != "dumps"}
    by_kind = {}
    for rec in host_seconds.get("dumps", []):
        agg = by_kind.setdefault(rec["kind"], {"n": 0})
        agg["n"] += 1
        for k in ("enqueue_s", "readback_s", "write_s"):
            agg[k] = agg.get(k, 0.0) + rec.get(k, 0.0)
    out["dumps_summed"] = by_kind
    return out


def insurance_phase(torch, smi: str, keep: str) -> dict:
    """The insurance program as a user runs it (``insurance_main`` at its
    reference defaults: 5,000 steps at batch 50, the grid, grid-extras and
    prediction dumps every 100 steps, K = 100 steps a call), twice in
    temporary res-paths: as given (the launch counters zeroed just before
    and read just after; the dumps' shapes, the metrics JSONL, the zips
    read back bit for bit, the scores) and with ``--sync-dumps`` (every
    dump byte-identical); then, on one trainer of the program, 2 x
    INS_TURN_K eager steps against two graphed calls (bitwise) and the
    eager and the graphed step timed in turns.  The first run's CSV pair,
    four model zips and metrics JSONL are copied to ``keep`` (the resume
    phase's uninterrupted run).  Returns the phase's line."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.graph import serialization
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import fused_step, insurance_main
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    def read_csv(path):
        return np.loadtxt(path, delimiter=",", ndmin=2)

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_ins_")
    try:
        dirs = {k: f"{root}/{k}" for k in ("async", "sync", "turns")}
        out = io.StringIO()  # the program's 5,000 step lines, counted
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            trainer, res = insurance_main.run(insurance_main.parse_args(
                ["--res-path", dirs["async"]]))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        step_lines = sum(ln.startswith("step ")
                         for ln in out.getvalue().splitlines())
        seconds_async = time.perf_counter() - t0
        # one warm-up step before the capture, then a replay per step; the
        # dumps and the evaluation run inference forwards only
        calls = INS_STEPS + 1
        expected = {"fused_update": 3 * calls, "bn_act": 4 * calls,
                    "upsample_bwd": 0, "bn_moments": 0, "bn_apply": 0,
                    "bn_act_4d": 0}
        require(launches == expected,
                f"insurance: launch counts {launches} != expected {expected}")
        require(res["steps"] == INS_STEPS and res["graphed"]
                and res["steps_per_call"] == INS_K and res["resident"]
                and step_lines == INS_STEPS,
                f"insurance: {step_lines} step lines, {res}")
        d = dirs["async"]
        ks = range(100, INS_STEPS + 1, 100)
        dumps = {f"insurance_out_{k}.csv": (2500, 12) for k in ks}
        dumps.update({f"insurance_out_pred_{k}.csv": (2500, 1) for k in ks})
        dumps.update({f"insurance_test_predictions_{k}.csv": (300, 1)
                      for k in ks})
        for f, shape in dumps.items():
            a = read_csv(f"{d}/{f}")
            require(a.shape == shape and bool(np.isfinite(a).all()),
                    f"insurance: {f} is {a.shape}, not {shape}, or not finite")
        recs = [json.loads(ln) for ln in open(f"{d}/insurance_metrics.jsonl")]
        require([r["step"] for r in recs] == list(range(1, INS_STEPS + 1)),
                "insurance: the metrics JSONL does not hold one record a step")
        require(os.path.getsize(f"{d}/evaluation_stats.txt") > 0,
                "insurance: no evaluation_stats.txt")
        for g, path in trainer.model_paths().items():
            back = serialization.read_model(path, trainer.device)
            live = getattr(trainer, g)
            require(back.params.keys() == live.params.keys()
                    and all(torch.equal(back.params[ly][n], t)
                            for ly, lp in live.params.items()
                            for n, t in lp.items()),
                    f"insurance: {path} does not read back as the trained "
                    f"{g} graph")
        require(isinstance(res.get("test_auroc"), float)
                and math.isfinite(res["test_auroc"]) and res["test_auroc"] > 0.5
                and math.isfinite(res.get("test_f1", float("nan"))),
                f"insurance: test_auroc {res.get('test_auroc')}, test_f1 "
                f"{res.get('test_f1')}")
        del trainer
        os.makedirs(keep, exist_ok=True)
        for f in ["insurance_train.csv", "insurance_test.csv",
                  "insurance_metrics.jsonl",
                  *(f"insurance_{g}_model.zip"
                    for g in ("dis", "gan", "gen", "insurance"))]:
            shutil.copy(f"{d}/{f}", f"{keep}/{f}")

        for k in ("sync", "turns"):
            os.makedirs(dirs[k])
            for f in ("insurance_train.csv", "insurance_test.csv"):
                shutil.copy(f"{d}/{f}", f"{dirs[k]}/{f}")
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            _, res_sync = insurance_main.run(insurance_main.parse_args(
                ["--res-path", dirs["sync"], "--sync-dumps"]))
        seconds_sync = time.perf_counter() - t1
        for f in dumps:
            require(open(f"{d}/{f}", "rb").read()
                    == open(f"{dirs['sync']}/{f}", "rb").read(),
                    f"insurance: {f} differs between async and --sync-dumps")

        # the program's step, graphed against eager, on one trainer
        trainer = GANTrainer(
            device=res["device"], workload=insurance_main.InsuranceWorkload(),
            config=insurance_main.default_config(
                res_path=dirs["turns"], num_iterations=0, print_every=0,
                save_every=0, metrics=False, steps_per_call=INS_TURN_K))
        graphed = trainer.graphed
        z_gen = torch.Generator(device=trainer.device)
        z_gen.set_state(trainer.z_gen.get_state())
        box = {"state": fused_step.clone_state(graphed.state)}
        step = trainer.step_fn(INS_TURN_K)
        inputs = (trainer.features, trainer.labels, trainer.y_real,
                  trainer.y_fake, trainer.ones)

        def eager():
            box["state"], losses = step(box["state"], *inputs, z_gen=z_gen)
            return torch.stack(losses, -1).cpu()

        def replays():
            return graphed(INS_TURN_K)

        le = torch.cat([eager() for _ in range(2)])
        lg = torch.cat([replays() for _ in range(2)])
        require(torch.equal(le, lg)
                and state_digest(box["state"]) == state_digest(graphed.state),
                "insurance: the graphed step's bits differ from the eager "
                f"step's (losses max |d| {max_err(le, lg)})")
        # what a checkpoint saves of the latent generator: its state after
        # the replays of a graph it is registered with must be the eager
        # generator's after as many steps
        z_eager, z_graphed = z_gen.get_state(), trainer.z_gen.get_state()
        require(torch.equal(z_eager, z_graphed),
                "insurance: the graph-registered generator's state "
                f"{z_graphed.tolist()} after {2 * INS_TURN_K} replays is not "
                f"the eager generator's {z_eager.tolist()}")

        def turn(fn):
            times = []
            for _ in range(TURN_CALLS):
                t2 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t2)
            return statistics.median(times) / INS_TURN_K * 1e3

        turns = [turn(eager), turn(replays), turn(replays), turn(eager)]
        launches_per_replay = graphed.launches
        del trainer, graphed, box
    finally:
        shutil.rmtree(root, ignore_errors=True)
    eager_ms, graphed_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return dict(
        seconds=time.perf_counter() - t0, seconds_as_given=seconds_async,
        seconds_sync_dumps=seconds_sync, steps=res["steps"], batch=INS_BATCH,
        steps_per_call=res["steps_per_call"], launches=launches,
        expected_launches=expected, launches_per_replay=launches_per_replay,
        examples_per_sec=res["examples_per_sec"],
        examples_per_sec_sync_dumps=res_sync["examples_per_sec"],
        step_ms_median=res["step_ms_median"],
        turns_ms=turns, eager_ms=eager_ms, graphed_ms=graphed_ms,
        eager_examples_per_s=INS_BATCH / eager_ms * 1e3,
        graphed_examples_per_s=INS_BATCH / graphed_ms * 1e3,
        graphed_bitwise_eager=True, z_gen_state_after_replays_is_eager=True,
        z_gen_state=z_graphed.tolist(), losses=[
            res[k] for k in ("d_loss", "g_loss", "clf_loss")],
        test_auroc=res["test_auroc"], test_f1=res["test_f1"],
        test_auroc_sync_dumps=res_sync["test_auroc"],
        host_seconds=dump_summary(res["host_seconds"]),
        host_seconds_sync=dump_summary(res_sync["host_seconds"]),
        dumps_checked=len(dumps), sync_dumps_byte_identical=True,
        nvidia_smi=smi)


def graph_phase(cfg, torch):
    """The graphed step against the eager step on one card, at batch 200
    and full width, without and with the EMA: from one start, GRAPH_STEPS
    eager steps (calls of MAIN_K) against GRAPH_STEPS // MAIN_K graphed
    calls of MAIN_K replays must give the same losses and the same final
    state, bit for bit.  Without the EMA, also: the eager and the graphed
    step timed in turns (E G G E, each turn TURN_CALLS calls, a call ending
    in its readback) and the copy-back's device time.  (What each cuDNN
    algorithm policy costs and whether it keeps the bits: ``python -m
    gan_deeplearning4j_tpu_torch.train.cudnn_ab``.)"""
    from gan_deeplearning4j_tpu_torch.train import fused_step
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    out = {}
    for ema in (0.0, 0.999):
        trainer = GANTrainer(cfg, batch_size=BATCH, n_train=N_TRAIN,
                             device="cuda", steps_per_call=MAIN_K,
                             ema_decay=ema)
        graphed = trainer.graphed
        # the eager run from the graph's start: a copy of the static state,
        # and a generator at the state the graph's generator starts from
        z_gen = torch.Generator(device=trainer.device)
        z_gen.set_state(trainer.z_gen.get_state())
        box = {"state": fused_step.clone_state(graphed.state)}
        step = trainer.step_fn(MAIN_K)
        inputs = (trainer.features, trainer.labels, trainer.y_real,
                  trainer.y_fake, trainer.ones)

        def eager():
            box["state"], losses = step(box["state"], *inputs, z_gen=z_gen)
            return torch.stack(losses, -1).cpu()

        def replays():
            return graphed(MAIN_K)

        calls = GRAPH_STEPS // MAIN_K
        le = torch.cat([eager() for _ in range(calls)])
        lg = torch.cat([replays() for _ in range(calls)])
        res = dict(steps=GRAPH_STEPS, steps_per_call=MAIN_K,
                   losses_bitwise=torch.equal(le, lg),
                   loss_max_abs_diff=max_err(le, lg),
                   digest_eager=state_digest(box["state"]),
                   digest_graphed=state_digest(graphed.state),
                   setup=graphed.setup, launches_per_replay=graphed.launches)
        if not ema:
            def turn(fn):
                times = []
                for _ in range(TURN_CALLS):
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
                return statistics.median(times) / MAIN_K * 1e3

            turns = [turn(eager), turn(replays), turn(replays), turn(eager)]
            res["turns_ms"] = turns
            res["eager_ms"] = (turns[0] + turns[3]) / 2
            res["graphed_ms"] = (turns[1] + turns[2]) / 2
            res["eager_img_per_s"] = BATCH / res["eager_ms"] * 1e3
            res["graphed_img_per_s"] = BATCH / res["graphed_ms"] * 1e3
            # the copy of a new state into the static one, as the graph ends
            a = fused_step.clone_state(graphed.state)
            b = fused_step.clone_state(graphed.state)
            res["copy_back_ms"] = time_ms(lambda: fused_step.copy_state_(a, b),
                                          torch)
            res["copy_back_bytes"] = 2 * sum(
                t.numel() * t.element_size() for _, tree in
                fused_step.state_trees(a) for lp in tree.values()
                for t in lp.values())
            del a, b
        out["ema" if ema else "plain"] = res
        del trainer, graphed, box
        torch.cuda.empty_cache()
    return out


def dp_rank(group, host, ins):
    """One rank of the dp phase (a spawned process)."""
    import torch

    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain
    from gan_deeplearning4j_tpu_torch.parallel import mesh
    from gan_deeplearning4j_tpu_torch.train import fused_step
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    dev = group.device
    out = {"rank": group.rank, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev),
           "backend": group.backend}
    # the sync-BN pair's autograd.Function against autograd through the
    # plain composition (with the differentiable all-reduce), on this
    # rank's rows of one global batch per BN shape of the step
    gen = torch.Generator(device=dev).manual_seed(20261017)
    Bl = BATCH // group.world
    rows = slice(group.rank * Bl, (group.rank + 1) * Bl)
    pair_err = 0.0
    for F in (2, 7 * 7 * 128, 1024):
        x = torch.randn((BATCH, F), generator=gen, device=dev)[rows] * 0.5
        gm = torch.randn(F, generator=gen, device=dev) * 0.1 + 1.0
        bt = torch.randn(F, generator=gen, device=dev) * 0.1
        gy = torch.randn((BATCH, F), generator=gen, device=dev)[rows]
        res = []
        for fn in (kernels.fused_bn_act_train, bn_act_plain):
            leaves = [t.clone().requires_grad_(True) for t in (x, gm, bt)]
            y, mean, var = fn(*leaves, 1e-5, "tanh", group)
            res.append((y, mean, var,
                        *torch.autograd.grad(y, leaves, gy)))
        for a, b, (atol, rtol) in zip(
                *res, [(1e-5, 1e-4), (1e-6, 1e-4), (1e-6, 1e-4)]
                + [(1e-4, 1e-3)] * 3):
            require(within(a.detach(), b.detach(), atol, rtol),
                    f"dp rank {group.rank}: the sync-BN pair disagrees with "
                    f"its plain composition at [{Bl},{F}]")
            pair_err = max(pair_err, max_err(a.detach(), b.detach()))
    out["pair_max_abs_err"] = pair_err
    # one 2-rank step against one single-process step
    out["step_vs_single"] = group_vs_single(group, host)
    # the main path, data parallel: counts zeroed just before, read after
    trainer = GANTrainer(M.CVConfig(), batch_size=BATCH, n_train=N_TRAIN,
                         group=group)
    kernels.reset_launch_counts()
    result = trainer.train(MAIN_STEPS, log=None)
    torch.cuda.synchronize(dev)
    out["launches"] = kernels.launch_counts()
    out["result"] = result
    trained = (trainer.dis, trainer.gan, trainer.classifier)
    out["rmsprop_leaves"] = sum(len(lp) for g in trained
                                for lp in g.opt_state.values())
    out["digest"] = state_digest(trainer.state)
    # a step's gradient collectives alone (one all-reduce per trained
    # graph, of a tree the size of its params), host clock to completion
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        for g in trained:
            mesh.all_reduce_mean(g.params, group)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    out["grad_allreduce_ms"] = statistics.median(times[1:]) * 1e3
    # the unfused per-fit loop, param_averaging: local steps (BN on the
    # rank's rows), params and updater state averaged after every fit
    pa = GANTrainer(M.CVConfig(), batch_size=BATCH, n_train=N_TRAIN,
                    group=group, fused=False, dp_mode="param_averaging",
                    averaging_frequency=PA_FREQ)
    kernels.reset_launch_counts()
    out["pa_result"] = pa.train(PA_STEPS, log=None)
    torch.cuda.synchronize(dev)
    out["pa_launches"] = kernels.launch_counts()
    out["pa_digest"] = state_digest(fused_step.state_from_graphs(
        pa.dis, pa.gen, pa.gan, pa.classifier, start_step=pa.steps))
    del pa, trainer
    out["insurance"] = insurance_dp(group, ins)
    return out


def sync_bn_profile(group, torch):
    """One ``_BnSync`` forward per BN shape of a 2-rank step on ``group``
    under torch.profiler, and the same for the composition it replaced
    (moments kernel, ``all_reduce_mean``, clone, square, subtract, apply
    kernel) -> {"new": ..., "old": ...}: device activities per forward,
    their device time (ms, all three forwards) and their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.parallel import mesh

    dev = group.device
    gen = torch.Generator(device=dev).manual_seed(20261018)
    inputs = [(torch.randn((BATCH // DP_WORLD, f), generator=gen, device=dev),
               torch.randn(f, generator=gen, device=dev) * 0.1 + 1.0,
               torch.randn(f, generator=gen, device=dev) * 0.1)
              for f in (2, 7 * 7 * 128, 1024)]

    def new(x, gm, bt):
        return bn2d._BnSync.apply(x, gm, bt, 1e-5, "tanh", group)

    def old(x, gm, bt):
        stats = mesh.all_reduce_mean(bn2d._moments_launch(x), group)
        mean = stats[0].clone()
        var = stats[1] - torch.square(stats[0])
        return bn2d._apply_launch(x, mean, var, gm, bt, 1e-5, "tanh"), mean, var

    outs = {}
    for label, fn in (("new", new), ("old", old)):
        for a in inputs:  # warm-up: the collective's first call sets it up
            fn(*a)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = [fn(*a) for a in inputs]
            torch.cuda.synchronize(dev)
        acts = [(e.name, e.time_range.end - e.time_range.start)
                for e in prof.events() if e.device_type == DeviceType.CUDA]
        kinds = {"bn_moments": 0, "bn_apply": 0, "nccl": 0, "other": 0}
        for n, _ in acts:
            kinds["bn_moments" if "bn_moments_kernel" in n else
                  "bn_apply" if "bn_apply_kernel" in n else
                  "nccl" if "nccl" in n.lower() else "other"] += 1
        outs[label] = dict(
            per_forward=len(acts) / len(inputs), kinds=kinds,
            device_ms=sum(us for _, us in acts) / 1e3,
            names=sorted({n[:100] for n, _ in acts}), results=res)
    for (y, m, v), (yo, mo, vo) in zip(outs["new"].pop("results"),
                                       outs["old"].pop("results")):
        require(torch.equal(m, mo) and torch.equal(v, vo)
                and within(y, yo, 1e-6, 1e-5),
                "sync-BN forward: the new pair differs from the old "
                "composition on a 1-rank group")
    return outs


def cv_main_phase(torch, smi: str) -> dict:
    """The CV program as a user runs it (``cv_main``), on the card, three
    times in temporary res-paths: as given (the launch counters zeroed just
    before and read just after; artifacts, model zips read back, scores),
    with ``--sync-dumps`` (the dumps byte-identical), and with the table
    streamed in chunks of K = 100 steps (``data_on_device=False``; per-step
    losses bitwise the resident run's).  Returns the phase's line."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.graph import serialization
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import cv_main

    def read_csv(path):
        return np.loadtxt(path, delimiter=",", ndmin=2)

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_cv_")
    try:
        dirs = {k: f"{root}/{k}" for k in ("async", "sync", "stream")}
        kernels.reset_launch_counts()
        trainer, res = cv_main.run(cv_main.parse_args(
            CV_ARGS + ["--res-path", dirs["async"]]))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        # one warm-up step before the capture, then a replay per step; the
        # dumps and the evaluation run inference forwards only
        calls = CV_STEPS + 1
        expected = {"fused_update": 3 * calls, "bn_act": 3 * calls,
                    "upsample_bwd": 2 * calls, "bn_moments": 0,
                    "bn_apply": 0, "bn_act_4d": 0}
        require(launches == expected,
                f"cv_main: launch counts {launches} != expected {expected}")
        require(res["steps"] == CV_STEPS and res["graphed"]
                and res["steps_per_call"] == CV_K and res["resident"],
                f"cv_main: {res}")
        d = dirs["async"]
        dumps = [f"mnist_out_{k}.csv" for k in (100, 200)] + [
            f"mnist_test_predictions_{k}.csv" for k in (100, 200)]
        for f in dumps[:2]:
            a = read_csv(f"{d}/{f}")
            require(a.shape == (100, 784) and bool(np.isfinite(a).all()),
                    f"cv_main: {f} is {a.shape}")
        for f in dumps[2:]:
            a = read_csv(f"{d}/{f}")
            require(a.shape == (2000, 10)
                    and float(np.abs(a.sum(axis=1) - 1).max()) <= 1e-4,
                    f"cv_main: {f} is {a.shape} or its rows do not sum to 1")
        recs = [json.loads(ln) for ln in open(f"{d}/mnist_metrics.jsonl")]
        require([r["step"] for r in recs] == list(range(1, CV_STEPS + 1)),
                "cv_main: the metrics JSONL does not hold one record a step")
        require(os.path.getsize(f"{d}/evaluation_stats.txt") > 0,
                "cv_main: no evaluation_stats.txt")
        # the four zips read back give the trainer's params, bit for bit
        for g, path in trainer.model_paths().items():
            back = serialization.read_model(path, "cuda")
            live = getattr(trainer, g)
            require(all(torch.equal(back.params[ly][n], t)
                        for ly, lp in live.params.items()
                        for n, t in lp.items())
                    and back.params.keys() == live.params.keys(),
                    f"cv_main: {path} does not read back as the trained "
                    f"{g} graph")
        scores = {k: res.get(k) for k in (
            "test_accuracy", "test_f1", "fid", "fid_frozen", "fid_primary",
            "fid_primary_source")}
        require(all(isinstance(res.get(k), float) and math.isfinite(res[k])
                    for k in ("test_accuracy", "fid", "fid_frozen")),
                f"cv_main: scores {scores}")
        del trainer

        # the same run with synchronous dumps, from the same CSV pair
        for k in ("sync", "stream"):
            os.makedirs(dirs[k])
            for f in ("mnist_train.csv", "mnist_test.csv"):
                shutil.copy(f"{d}/{f}", f"{dirs[k]}/{f}")
        _, res_sync = cv_main.run(cv_main.parse_args(
            CV_ARGS[:-1] + ["0", "--res-path", dirs["sync"], "--sync-dumps"]))
        for f in dumps:
            require(open(f"{d}/{f}", "rb").read()
                    == open(f"{dirs['sync']}/{f}", "rb").read(),
                    f"cv_main: {f} differs between async and --sync-dumps")
        # streamed: K = 100 steps of u8 codes a chunk (5 bytes a feature
        # in the byte budget, as in the JAX trainer)
        _, res_stream = cv_main.run(
            cv_main.parse_args(CV_ARGS[:-1] + ["0", "--res-path",
                                               dirs["stream"]]),
            data_on_device=False,
            stream_chunk_bytes=CV_K * 200 * (5 * 784 + 4 * 10))
        recs_s = [json.loads(ln)
                  for ln in open(f"{dirs['stream']}/mnist_metrics.jsonl")]
        keys = ("d_loss", "g_loss", "classifier_loss")
        require(not res_stream["resident"]
                and res_stream["steps_per_call"] == CV_K
                and res_stream["data_codec"] == "u8x100",
                f"cv_main streamed: {res_stream}")
        require([[r[k] for k in keys] for r in recs]
                == [[r[k] for k in keys] for r in recs_s],
                "cv_main: the streamed run's per-step losses differ from "
                "the resident run's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(
        seconds=time.perf_counter() - t0, argv=CV_ARGS, steps=res["steps"],
        steps_per_call=res["steps_per_call"],
        launches=launches, expected_launches=expected,
        examples_per_sec=res["examples_per_sec"],
        examples_per_sec_sync_dumps=res_sync["examples_per_sec"],
        examples_per_sec_streamed=res_stream["examples_per_sec"],
        step_ms_median=res["step_ms_median"], losses=[
            res[k] for k in ("d_loss", "g_loss", "clf_loss")],
        scores=scores, host_seconds=res["host_seconds"],
        host_seconds_sync=res_sync["host_seconds"],
        host_seconds_streamed=res_stream["host_seconds"],
        sync_dumps_byte_identical=True, streamed_losses_bitwise=True,
        nvidia_smi=smi)


# -- the resume phase ---------------------------------------------------------

RES_INS_EVERY = 500  # the insurance children's --checkpoint-every
RES_INS_SIGNAL_AFTER = 2000  # SIGTERM after this step's "Completed Batch"
# the CV runs: full width, batch 200, 400 steps in calls of K = 100, the
# CSV pair cut as in the cv_main phase, no FID
RES_CV_BASE = ["--n-train", "10000", "--n-test", "2000", "--iterations",
               "400", "--print-every", "100", "--save-every", "100",
               "--fid-samples", "0"]
RES_CV_CKPT = ["--checkpoint-every", "100"]
RES_CV_STEPS = 400
RES_CV_STOP = 200
RES_DP_STEPS = (4, 8)  # the world-2 run: a checkpoint at 4, resumed to 8
RES_CHILD_TIMEOUT_S = 300
# the cross-process CV resume against the in-process run: the largest
# param difference is reported with the first of these bounds it meets;
# beyond the last, the phase fails
RES_CV_BOUNDS = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 5e-2)
LOSS_KEYS = ("classifier_loss", "d_loss", "g_loss")


class _SignalAt(io.TextIOBase):
    """A stdout that sends SIGTERM to this process when ``line`` is
    written (the in-process preemption), discarding everything."""

    def __init__(self, line: str):
        self.line, self.fired = line, False

    def write(self, text: str) -> int:
        if not self.fired and self.line in text:
            import signal

            self.fired = True
            os.kill(os.getpid(), signal.SIGTERM)
        return len(text)


def run_child(module: str, args, stop_after=None):
    """``python -m module args`` in a child process from this checkout ->
    (exit code, its last JSON line or None, seconds, stderr tail); with
    ``stop_after``, SIGTERM once it printed ``Completed Batch
    {stop_after}!``.  The child is killed at RES_CHILD_TIMEOUT_S."""
    import signal
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([sys.executable, "-m", module, *args],
                                cwd=root, env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        killer = threading.Timer(RES_CHILD_TIMEOUT_S, proc.kill)
        killer.start()
        last, sent = None, False
        try:
            for line in proc.stdout:
                if (stop_after is not None and not sent and line.startswith(
                        f"Completed Batch {stop_after}!")):
                    proc.send_signal(signal.SIGTERM)
                    sent = True
                if line.startswith("{"):
                    last = line
            rc = proc.wait()
        finally:
            killer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        tail = err.read()[-3000:]
    return (rc, json.loads(last) if last else None,
            time.perf_counter() - t0, tail)


def zip_arrays(path: str) -> dict:
    """A model zip's params and updater state, {member/key: array}."""
    import zipfile

    import numpy as np

    out = {}
    with zipfile.ZipFile(path) as zf:
        for member in ("params.npz", "updater.npz"):
            with np.load(io.BytesIO(zf.read(member))) as z:
                out.update({f"{member[:-4]}/{k}": z[k] for k in z.files})
    return out


def zips_diff(ref_dir: str, got_dir: str, prefix: str, names) -> tuple:
    """(largest |difference|, (first differing leaf, its difference) or
    None) over the params and updater state of two runs' model zips."""
    import numpy as np

    worst, first = 0.0, None
    for g in names:
        a = zip_arrays(f"{ref_dir}/{prefix}_{g}_model.zip")
        b = zip_arrays(f"{got_dir}/{prefix}_{g}_model.zip")
        require(a.keys() == b.keys(), f"{prefix}_{g}: the zips' leaves differ")
        for k in sorted(a):
            d = (float(np.abs(a[k].astype(np.float64) - b[k]).max())
                 if a[k].size else 0.0)
            if not math.isfinite(d):
                d = float("inf")
            if d > 0 and first is None:
                first = (f"{g}:{k}", d)
            worst = max(worst, d)
    return worst, first


def metrics_by_step(path: str) -> dict:
    """A metrics JSONL by step, the last record of a step winning (a
    resumed run appends to the file)."""
    out = {}
    for ln in open(path):
        rec = json.loads(ln)
        if "step" in rec:
            out[rec["step"]] = rec
    return out


def manifest_bytes(ckpt_dir: str) -> int:
    with open(f"{ckpt_dir}/MANIFEST.json") as f:
        return sum(m["bytes"] for m in json.load(f)["files"].values())


def checkpoint_costs(trainer, root: str, torch) -> dict:
    """The cost of checkpointing ``trainer``'s state at its step: the
    snapshot (copies to pinned host memory behind one event: the host's
    enqueue ms and the ms until the copies are done), a synchronous save,
    an asynchronous one (the
    seconds that block the caller, and until durable; its manifest must be
    the synchronous one's), the bytes, and a restore of the saved
    checkpoint (which must give back the state, bit for bit)."""
    from gan_deeplearning4j_tpu_torch.checkpoint import (
        AsyncCheckpointer,
        TrainCheckpointer,
    )
    from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
        snapshot_state,
    )
    from gan_deeplearning4j_tpu_torch.train import fused_step

    fused_step.state_to_graphs(trainer.state, trainer.dis, trainer.gen,
                               trainer.gan, trainer.classifier)
    graphs, step = trainer._graphs(), trainer.steps
    extra, spec = trainer._checkpoint_extra(), trainer._mesh_spec()
    want = {f"{g}/{f}/{ly}/{n}": t.detach().clone()
            for g, gr in graphs.items() for f in ("params", "opt_state")
            for ly, lp in getattr(gr, f).items() for n, t in lp.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = snapshot_state(graphs, step, extra, mesh_spec=spec)
    t1 = time.perf_counter()
    snap["event"].synchronize()
    snapshot = {"enqueue_ms": (t1 - t0) * 1e3,
                "copied_ms": (time.perf_counter() - t0) * 1e3}
    del snap
    sync_dir, async_dir = f"{root}/sync", f"{root}/async"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TrainCheckpointer(sync_dir).save(step, graphs, extra, mesh_spec=spec)
    sync_s = time.perf_counter() - t0
    ack = AsyncCheckpointer(TrainCheckpointer(async_dir))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ack.save(step, graphs, extra, mesh_spec=spec)
    async_blocking_s = time.perf_counter() - t0
    ack.wait()
    async_total_s = time.perf_counter() - t0
    ack.close()
    m_sync = json.load(open(f"{sync_dir}/ckpt_{step}/MANIFEST.json"))
    m_async = json.load(open(f"{async_dir}/ckpt_{step}/MANIFEST.json"))
    require(m_sync == m_async,
            "the async checkpoint's manifest differs from the sync one's")
    t0 = time.perf_counter()
    TrainCheckpointer(sync_dir).restore(graphs, mesh_spec=spec)
    restore_s = time.perf_counter() - t0
    got = {f"{g}/{f}/{ly}/{n}": t
           for g, gr in graphs.items() for f in ("params", "opt_state")
           for ly, lp in getattr(gr, f).items() for n, t in lp.items()}
    require(want.keys() == got.keys()
            and all(torch.equal(want[k], got[k]) for k in want),
            "the restored checkpoint is not the saved state")
    return {"snapshot": snapshot, "sync_save_s": sync_s,
            "async_save_blocking_s": async_blocking_s,
            "async_save_s": async_total_s,
            "bytes": manifest_bytes(f"{sync_dir}/ckpt_{step}"),
            "files": sorted(m_sync["files"]), "restore_s": restore_s,
            "leaves": len(want)}


def resume_insurance(ref: str, ref_auroc: float, root: str) -> dict:
    """The insurance program at its defaults in child processes: child A
    with ``--checkpoint-every RES_INS_EVERY --preempt-signal SIGTERM``,
    sent SIGTERM after step RES_INS_SIGNAL_AFTER, must exit 75 and leave
    PREEMPTED.json and a verified checkpoint at its step; child B resumes
    it to INS_STEPS.  The four zips (params and updater state), every
    metrics record's losses and test_auroc must be bitwise those of the
    insurance phase's uninterrupted run (``ref``)."""
    from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer

    module = "gan_deeplearning4j_tpu_torch.train.insurance_main"
    d = f"{root}/ins"
    os.makedirs(d)
    for f in ("insurance_train.csv", "insurance_test.csv"):
        shutil.copy(f"{ref}/{f}", f"{d}/{f}")
    args = ["--res-path", d, "--checkpoint-every", str(RES_INS_EVERY),
            "--preempt-signal", "SIGTERM"]
    rc_a, res_a, sec_a, err = run_child(module, args,
                                        stop_after=RES_INS_SIGNAL_AFTER)
    require(rc_a == 75 and res_a is not None and res_a.get("preempted"),
            f"insurance child A: exit {rc_a}, {res_a}; stderr: {err}")
    marker = json.load(open(f"{d}/PREEMPTED.json"))
    stop = marker["step"]
    ck = TrainCheckpointer(f"{d}/checkpoints", sweep_debris=False)
    require(RES_INS_SIGNAL_AFTER <= stop < INS_STEPS
            and marker["signal"] == "SIGTERM"
            and ck.latest_verified_step() == stop == res_a["step"],
            f"insurance child A: marker {marker}, checkpoints {ck.steps()}")
    ckpt_bytes = manifest_bytes(f"{d}/checkpoints/ckpt_{stop}")
    rc_b, res_b, sec_b, err = run_child(module, args + ["--resume"])
    require(rc_b == 0 and res_b is not None
            and res_b.get("steps") == INS_STEPS
            and not os.path.exists(f"{d}/PREEMPTED.json"),
            f"insurance child B: exit {rc_b}, {res_b}; stderr: {err}")
    worst, first = zips_diff(ref, d, "insurance",
                             ("dis", "gan", "gen", "insurance"))
    m_ref = metrics_by_step(f"{ref}/insurance_metrics.jsonl")
    m_got = metrics_by_step(f"{d}/insurance_metrics.jsonl")
    require(sorted(m_got) == list(range(1, INS_STEPS + 1)),
            "insurance resume: the metrics JSONL misses steps")
    bad = [s for s in sorted(m_ref)
           if any(m_ref[s][k] != m_got[s][k] for k in LOSS_KEYS)]
    require(worst == 0.0 and not bad and res_b["test_auroc"] == ref_auroc,
            f"insurance resume is not bitwise the uninterrupted run: first "
            f"differing leaf {first}, largest difference {worst}; metrics "
            f"differ at {len(bad)} steps (first {bad[:1]}); test_auroc "
            f"{res_b['test_auroc']} vs {ref_auroc}")
    hs = res_b["host_seconds"]
    return {"stopped_at": stop, "exit_a": rc_a, "marker": marker,
            "checkpoint_bytes": ckpt_bytes, "seconds_a": sec_a,
            "seconds_b": sec_b, "bitwise": True, "largest_param_diff": worst,
            "metrics_steps_equal": INS_STEPS, "test_auroc": ref_auroc,
            "b_restore_s": hs.get("restore_s"),
            "b_capture_s": hs.get("capture_s"),
            "b_checkpoint_s": hs.get("checkpoint_s")}


def resume_cv(torch, root: str) -> dict:
    """The CV program at full width, RES_CV_STEPS steps at batch 200 in
    calls of K = 100, checkpoints every 100: (1) in this process, U runs
    uninterrupted, P is preempted (SIGTERM to itself after step
    RES_CV_STOP's line: the emergency checkpoint), R resumes it with the
    launch counters zeroed just before and read just after; R's final
    state and latent generator must be U's, bitwise.  (2) The generator's
    state after U's replays must be that of a fresh generator after
    2 x RES_CV_STEPS eager draws (the resume route of a checkpoint without
    ``z_gen_state``).  (3) The cost of a checkpoint of R's state.  (4)
    Across processes: a child resumes a copy of P's directory (its
    checkpoint and PREEMPTED.json) to RES_CV_STEPS; its zips against U's,
    with the bound they meet.  (The insurance part sends SIGTERM to a
    child; here the signal reaches this process, which keeps the CV part
    to one child.)"""
    from gan_deeplearning4j_tpu_torch.data import datasets
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import cv_main, fused_step
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import advance_latents

    data = f"{root}/cv_data"
    datasets.ensure_mnist_csv(data, 10000, 2000)

    def res_dir(name: str) -> str:
        d = f"{root}/{name}"
        os.makedirs(d)
        for f in ("mnist_train.csv", "mnist_test.csv"):
            shutil.copy(f"{data}/{f}", f"{d}/{f}")
        return d

    def run(args, out=None):
        with contextlib.redirect_stdout(out or io.StringIO()):
            return cv_main.run(cv_main.parse_args(RES_CV_BASE + args))

    t0 = time.perf_counter()
    u = res_dir("cv_u")
    tu, ru = run(["--res-path", u])
    p = res_dir("cv_p")
    sig = _SignalAt(f"Completed Batch {RES_CV_STOP}!")
    tp, rp = run(RES_CV_CKPT + ["--res-path", p, "--preempt-signal",
                                "SIGTERM", "--async-checkpoint"], sig)
    require(sig.fired and tp is None and rp.get("preempted")
            and rp["step"] == RES_CV_STOP
            and os.path.exists(f"{p}/PREEMPTED.json"),
            f"cv: the in-process preemption gave {rp}")
    # the preempted run as this process left it, for a resume in another
    x = f"{root}/cv_x"
    shutil.copytree(p, x)
    kernels.reset_launch_counts()
    tr, rr = run(RES_CV_CKPT + ["--res-path", p, "--resume",
                                "--async-checkpoint"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    calls = 1 + RES_CV_STEPS - RES_CV_STOP  # the warm-up step and replays
    expected = {"fused_update": 3 * calls, "bn_act": 3 * calls,
                "upsample_bwd": 2 * calls, "bn_moments": 0, "bn_apply": 0,
                "bn_act_4d": 0}
    require(launches == expected,
            f"cv resume: launch counts {launches} != expected {expected}")
    require(rr["steps"] == RES_CV_STEPS and rr["graphed"],
            f"cv resume: {rr}")
    lu, lr = fused_step._leaves(tu.state), fused_step._leaves(tr.state)
    differ = [(".".join(k), max_err(lu[k], lr[k])) for k in lu
              if not torch.equal(lu[k], lr[k])]
    z_u, z_r = tu.z_gen.get_state(), tr.z_gen.get_state()
    require(not differ and torch.equal(z_u, z_r)
            and int(tu.state.it) == int(tr.state.it) == RES_CV_STEPS,
            f"cv: the in-process resume is not bitwise the uninterrupted run "
            f"({len(differ)} leaves differ, first {differ[:1]}; generator "
            f"states equal: {torch.equal(z_u, z_r)})")
    # the generator: replays of a registered generator against eager draws
    z_fresh = prng.generator(prng.NUMBER_OF_THE_BEAST, "train-z", tu.device)
    advance_latents(z_fresh, RES_CV_STEPS, BATCH, 2, tu.device)
    require(torch.equal(z_fresh.get_state(), z_u),
            f"cv: the generator's state after {RES_CV_STEPS} graphed steps "
            f"{z_u.tolist()} is not that of {2 * RES_CV_STEPS} eager draws "
            f"{z_fresh.get_state().tolist()}")
    seconds_in_process = time.perf_counter() - t0
    costs = checkpoint_costs(tr, f"{root}/cv_costs", torch)
    restore_s, capture_s = tr.timings["restore_s"], tr.timings["capture_s"]
    resumed_checkpoint_s = tr.timings.get("checkpoint_s")
    del tu, tr

    # across processes: a child resumes the copy of P's directory
    rc_b, res_b, sec_b, err = run_child(
        "gan_deeplearning4j_tpu_torch.train.cv_main",
        RES_CV_BASE + RES_CV_CKPT + ["--res-path", x, "--resume"])
    require(rc_b == 0 and res_b is not None
            and res_b.get("steps") == RES_CV_STEPS
            and not os.path.exists(f"{x}/PREEMPTED.json"),
            f"cv child: exit {rc_b}, {res_b}; stderr: {err}")
    worst, first = zips_diff(u, x, "mnist", ("dis", "gan", "gen", "CV"))
    bound = next((b for b in RES_CV_BOUNDS if worst <= b), None)
    require(bound is not None,
            f"cv: the cross-process resume differs from the uninterrupted "
            f"run by {worst} (first differing leaf {first}), beyond "
            f"{RES_CV_BOUNDS[-1]}")
    return {"steps": RES_CV_STEPS, "stopped_at": RES_CV_STOP,
            "in_process_bitwise": True, "launches": launches,
            "expected_launches": expected,
            "z_gen_state_is_eager_draws": True, "z_gen_state": z_u.tolist(),
            "seconds_in_process": seconds_in_process,
            "resumed_run_restore_s": restore_s,
            "resumed_run_capture_s": capture_s,
            "resumed_run_checkpoint_s": resumed_checkpoint_s,
            "examples_per_sec_uninterrupted": ru["examples_per_sec"],
            "examples_per_sec_resumed": rr["examples_per_sec"],
            "costs": costs,
            "cross_process": {"largest_param_diff": worst,
                              "first_differing_leaf": first,
                              "bound_met": bound, "bitwise": worst == 0.0,
                              "seconds": sec_b,
                              "checkpoint_s": res_b["host_seconds"].get(
                                  "checkpoint_s"),
                              "restore_s": res_b["host_seconds"].get(
                                  "restore_s"),
                              "capture_s": res_b["host_seconds"].get(
                                  "capture_s")}}


def resume_dp_rank(group, dirs) -> dict:
    """One rank of the world-2 resume (a spawned process): the insurance
    program's trainer run uninterrupted for RES_DP_STEPS[1] steps, then in
    a second res-path for RES_DP_STEPS[0] steps with a checkpoint there
    and resumed to RES_DP_STEPS[1] -> the two final states' digests."""
    from gan_deeplearning4j_tpu_torch.train import insurance_main
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    every, steps = RES_DP_STEPS

    def run(res, n, **kw):
        t = GANTrainer(group=group, workload=insurance_main.InsuranceWorkload(),
                       config=insurance_main.default_config(
                           res_path=res, num_iterations=n, print_every=every,
                           save_every=every, metrics=False, **kw))
        t.train(log=None)
        return t

    u = run(dirs["u"], steps)
    run(dirs["r"], every, checkpoint_every=every)
    b = run(dirs["r"], steps, checkpoint_every=every, resume=True)
    return {"rank": group.rank, "backend": group.backend,
            "uninterrupted": state_digest(u.state),
            "resumed": state_digest(b.state), "steps": b.steps,
            "restore_s": b.timings.get("restore_s")}


def resume_dp(root: str) -> dict:
    from gan_deeplearning4j_tpu_torch.data import datasets
    from gan_deeplearning4j_tpu_torch.parallel import mesh

    dirs = {k: f"{root}/dp_{k}" for k in ("u", "r")}
    for d in dirs.values():
        datasets.ensure_insurance_csv(d)  # before the ranks read it
    t0 = time.perf_counter()
    ranks = mesh.spawn(resume_dp_rank, DP_WORLD, (dirs,), device="cuda",
                       timeout=DP_TIMEOUT_S)
    digests = {r["uninterrupted"] for r in ranks} | {r["resumed"]
                                                    for r in ranks}
    require(len(digests) == 1
            and all(r["steps"] == RES_DP_STEPS[1] for r in ranks),
            f"dp resume: the resumed world-2 run is not the uninterrupted "
            f"one: {ranks}")
    return {"world": DP_WORLD, "backend": ranks[0]["backend"],
            "checkpoint_at": RES_DP_STEPS[0], "steps": RES_DP_STEPS[1],
            "equal": True, "ranks": ranks,
            "seconds": time.perf_counter() - t0}


def resume_data_retry(root: str, torch) -> dict:
    """One insurance run with ``--data-retries 3`` whose first CSV read
    meets an injected transient OSError -> its retry count (must be 1),
    and the checkpoint costs at the insurance model's size."""
    from gan_deeplearning4j_tpu_torch.data.csv import CSVRecordReader
    from gan_deeplearning4j_tpu_torch.train import insurance_main
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    orig = CSVRecordReader.read
    calls = {"n": 0}

    def flaky(self, path, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(f"injected transient read error on {path}")
        return orig(self, path, *a, **kw)

    CSVRecordReader.read = flaky
    try:
        t = GANTrainer(workload=insurance_main.InsuranceWorkload(),
                       config=insurance_main.default_config(
                           res_path=f"{root}/retry", num_iterations=100,
                           data_retries=3, metrics=False))
    finally:
        CSVRecordReader.read = orig
    res = t.train(log=None)
    retries = t.data_health.retries_total
    require(retries == 1 and res["steps"] == 100,
            f"data retries: {retries} retries, {res['steps']} steps")
    costs = checkpoint_costs(t, f"{root}/ins_costs", torch)
    return {"retries": retries, "reads": calls["n"], "steps": res["steps"],
            "insurance_costs": costs,
            "insurance_capture_s": t.timings.get("capture_s")}


def resume_phase(torch, smi: str, ins_ref: str, ins_auroc: float) -> dict:
    """Checkpoints, preemption and resume on the card (see the module
    docstring, phase 10)."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_resume_")
    try:
        out = {"insurance": resume_insurance(ins_ref, ins_auroc, root)}
        t1 = time.perf_counter()
        out["cv"] = resume_cv(torch, root)
        t2 = time.perf_counter()
        out["dp"] = resume_dp(root)
        out["data_retry"] = resume_data_retry(root, torch)
        out["seconds_by_part"] = {"insurance": t1 - t0, "cv": t2 - t1,
                                  "dp_and_retry": time.perf_counter() - t2}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["nvidia_smi"] = smi
    return out


# -- the roadmap phase --------------------------------------------------------

RM_BATCH = 128  # roadmap_main.DEFAULT_BATCH_SIZE
# bn_act's two shapes on the roadmap path: the generators' gen_bn0 (one
# launch per G-step)
RM_BN = {"celeba": ((RM_BATCH, 4 * 4 * 8 * 64), "relu"),
         "wgan-gp": ((RM_BATCH, 7 * 7 * 4 * 32), "relu")}
RM_N_TRAIN = 2000  # cgan-cifar10: ~200 rows a class, over the 50 its
#                   class metrics need
RM_FAMILIES = ("celeba", "wgan-gp", "cgan-cifar10")
RM_K = 10  # iterations per call of the graphed-vs-eager runs
RM_TURN_CALLS = 3  # calls of RM_K iterations in one timed turn
RM_EMA = 0.999
# the programs as child processes: (iterations, print_every)
RM_CHILD = {"celeba": (200, 100), "wgan-gp": (100, 50),
            "cgan-cifar10": (200, 100)}
RM_FIDELITY_STEPS = 100  # the cgan child's --fidelity-steps
RM_RESUME = (200, 100)  # celeba in this process: straight, then 100 + resume
# one iteration on the card against one on the CPU, from the same state and
# draws, each held against the CPU in float64.  A GAN's first generator
# gradients are mostly cancellation (D's outputs sit near 0.5, and a
# train-mode BN's backward subtracts means): the CPU's own f32 gradients
# of the celeba generator lie ~3.5% (in norm) from the f64 ones, the
# card's ~4%.  So the card is held to the CPU's f32 accuracy, not to the
# CPU: leaf by leaf, the gradients read from Adam's m and v
# (||m' - m64|| / ||m64||) within 4x the CPU's distance plus 2e-3 (the
# celeba D-step's dis_bn3.gamma sits 1.1e-3 from f64 on the card, 2e-6 on
# the CPU; below); the share of a leaf's params more than 2.5e-5 (a quarter of the
# smallest learning rate) from f64's within 2x the CPU's share plus 2%
# (Adam's first step moves an element by about lr * sign(g), so a
# gradient near 0 may flip: 1.2% of gen_bn1.gamma on the card, none on the
# CPU); every param within 2 lr per update of the CPU's; the losses within
# 1e-4 of f64's, relative.
RM_CARD_TOL = {"loss": 1e-4, "moment_ratio": 4.0, "moment_slack": 2e-3,
               "param": 2.5e-5, "share_ratio": 2.0, "share_slack": 0.02,
               "flip_lr": 2.0}
# celeba's dis_bn3.gamma error is cuDNN's (``train/moment_triage.py`` on
# the H100): with cuDNN off (PyTorch's own CUDA convolutions) it falls from
# 1.1e-3 to 4.6e-7, while cuDNN's heuristic (untimed) choice and the BNs
# computed in float64 leave it as it is.  cgan-cifar10's card lies closer to
# f64 than the CPU does (its largest gradient error on the card 4.3e-6,
# gen_deconv2.b; the CPU's 1.7e-3, gen_bn0.gamma; no leaf above 4x the
# CPU's): its moment slack is sized from that reading, 1e-5.
RM_CARD_TOL_BY_FAMILY = {"cgan-cifar10": {**RM_CARD_TOL, "moment_slack": 1e-5}}


def roadmap_kernels(torch, randn, bw: float, sms: int) -> dict:
    """``bn_act`` at the roadmap path's two shapes: against its plain
    version (and its gradient), a bitwise repeat, its time against
    ``F.batch_norm`` in turns, one launch's floor and its bound."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain

    torch_f = torch.nn.functional
    rows = {}
    for family, ((b, f), act) in RM_BN.items():
        x, gm, bt = (randn(b, f, scale=0.5, shift=0.2),
                     randn(f, scale=0.1, shift=1.0), randn(f, scale=0.1))
        yk, mk, vk = kernels.fused_bn_act_train(x, gm, bt, 1e-5, act)
        yp, mp, vp = bn_act_plain(x, gm, bt, 1e-5, act)
        require(within(yk, yp, 1e-5, 1e-4) and within(mk, mp, 1e-6, 1e-4)
                and within(vk, vp, 1e-6, 1e-4),
                f"bn_act disagrees with its plain version at [{b},{f}] {act}")
        require(bitwise_repeat(lambda *t: kernels.fused_bn_act_train(
            *t, 1e-5, act), [(x, gm, bt)], torch),
            f"bn_act: two launches differ at [{b},{f}]")
        leaves = [t.clone().requires_grad_(True) for t in (x, gm, bt)]
        gy = randn(b, f)
        gk = torch.autograd.grad(kernels.fused_bn_act_train(
            *leaves, 1e-5, act)[0], leaves, gy)
        gp = torch.autograd.grad(bn_act_plain(*leaves, 1e-5, act)[0], leaves, gy)
        require(all(within(u, v, 1e-4, 1e-3) for u, v in zip(gk, gp)),
                f"bn_act gradient disagrees at [{b},{f}] {act}")
        ms, library_ms, turns = in_turns(
            lambda: kernels.fused_bn_act_train(x, gm, bt, 1e-5, act),
            lambda: torch_f.batch_norm(x, None, None, gm, bt, training=True,
                                       eps=1e-5), torch)
        t_bytes = (8 * b * f + 16 * f) / bw * 1e3
        t_ops = 10 * b * f / PEAK_F32_FLOPS * 1e3
        rows[family] = dict(
            shape=[b, f], act=act, plan=bn2d.launch_plan(b, f, sms)._asdict(),
            max_abs_err=max(max_err(yk, yp), max_err(mk, mp), max_err(vk, vp)),
            ms=ms, library_ms=library_ms, turns_ms=turns,
            plain_ms=time_ms(lambda: bn_act_plain(x, gm, bt, 1e-5, act), torch),
            floor_ms=floor_ms(1, torch), bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_call="F.batch_norm(training=True), without the activation",
            kernel_slower_than_library=ms > library_ms)
    return rows


@contextlib.contextmanager
def _plain_bn_act():
    """The 2-D BN layer on ``bn_act``'s plain version (the float64
    reference; the kernel's wrapper takes f32 only)."""
    from gan_deeplearning4j_tpu_torch.graph import layers
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain

    fused = layers.fused_bn_act_train
    layers.fused_bn_act_train = (
        lambda x, g, b, eps, act, group=None: bn_act_plain(x, g, b, eps, act))
    try:
        yield
    finally:
        layers.fused_bn_act_train = fused


def _pair_to(tree, dev, dtype):
    return {k: _pair_to(v, dev, dtype) if isinstance(v, dict)
            else v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
            for k, v in tree.items()}


def roadmap_card_vs_cpu(family: str, torch) -> dict:
    """One iteration (n_critic D-steps, one G-step) at full width and batch
    RM_BATCH on the card, on the CPU and on the CPU in float64, from the
    same params and draws (made on the CPU): within RM_CARD_TOL."""
    from gan_deeplearning4j_tpu_torch.train import fused_step, roadmap_main
    from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws, PairState

    base, cfg, _ = roadmap_main._build(family, "cpu")
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if base.mode == "gan" else 1.0
    x, y = roadmap_main._data(family, 512, 7)
    table = torch.from_numpy(x)
    cond = None if y is None else torch.from_numpy(y)
    draws = base.draw(torch.Generator().manual_seed(8), 512, RM_BATCH,
                      n_critic, cfg.z_size, "cpu")
    runs = {}
    for key, dev, dtype in (("f64", "cpu", torch.float64),
                            ("cpu", "cpu", torch.float32),
                            ("card", "cuda", torch.float32)):
        pair, _, _ = roadmap_main._build(family, dev)
        for g in (pair.gen, pair.dis):
            src = base.gen if g is pair.gen else base.dis
            g.params = _pair_to(src.params, dev, dtype)
            g.opt_state = _pair_to(g.opt_state, dev, dtype)
        d = Draws(*[None if v is None else
                    [_pair_to({0: t}, dev, dtype)[0] for t in v]
                    if isinstance(v, list) else _pair_to({0: v}, dev, dtype)[0]
                    for v in draws])
        state = PairState(pair.gen.params, pair.gen.opt_state, pair.dis.params,
                          pair.dis.opt_state, torch.tensor(0, device=dev))
        labels = [t.to(dtype) for t in pair.label_vectors(RM_BATCH, real_label)]
        one = pair.iteration(RM_BATCH, n_critic, cfg.z_size)
        with _plain_bn_act() if dtype == torch.float64 else contextlib.nullcontext():
            runs[key] = one(state, table.to(dev, dtype), *labels,
                            None if cond is None else cond.to(dev, dtype),
                            draws=d)
    tol = RM_CARD_TOL_BY_FAMILY.get(family, RM_CARD_TOL)
    out = {k: [float(v) for v in r[1]] for k, r in runs.items()}
    out["loss_rel_err"] = {k: max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)
                                  for a, b in zip(runs[k][1], runs["f64"][1]))
                           for k in ("cpu", "card")}
    require(out["loss_rel_err"]["card"] <= tol["loss"],
            f"roadmap {family} card vs f64: loss relative error "
            f"{out['loss_rel_err']['card']} > {tol['loss']}")
    leaves = {k: fused_step._leaves(r[0]) for k, r in runs.items()}
    steps = {"gen": 1, "dis": n_critic}
    worst = {"moment": (-1.0, ""), "share": (-1.0, ""), "flip_lr": (0.0, "")}
    detail = {}
    for path, ref in leaves["f64"].items():
        field = path[0]
        if field == "it" or ref.dim() == 0:
            continue
        g = field.split("_")[0]
        cpu, card = leaves["cpu"][path].double(), leaves["card"][path].cpu().double()
        where = ".".join(map(str, path))
        if field.endswith("_opt"):
            nref = float(ref.norm())
            if nref == 0:
                continue
            e_cpu = float((cpu - ref).norm()) / nref
            e_card = float((card - ref).norm()) / nref
            margin = e_card - (tol["moment_ratio"] * e_cpu + tol["moment_slack"])
            detail[where] = (e_cpu, e_card)
            if margin >= worst["moment"][0] or worst["moment"][1] == "":
                worst["moment"] = (margin, where)
        else:
            lr = getattr(base, g).updater.updater_for(path[1]).learning_rate
            s_cpu = float(((cpu - ref).abs() > tol["param"]).double().mean())
            s_card = float(((card - ref).abs() > tol["param"]).double().mean())
            margin = s_card - (tol["share_ratio"] * s_cpu + tol["share_slack"])
            detail[where] = (s_cpu, s_card)
            if margin >= worst["share"][0] or worst["share"][1] == "":
                worst["share"] = (margin, where)
            flip = float((card - cpu).abs().max()) / (lr * steps[g])
            if flip >= worst["flip_lr"][0]:
                worst["flip_lr"] = (flip, where)
    out["worst"] = {k: (v, w, detail.get(w)) for k, (v, w) in worst.items()}
    out["tolerance"] = tol
    require(worst["moment"][0] <= 0 and worst["share"][0] <= 0
            and worst["flip_lr"][0] <= tol["flip_lr"],
            f"roadmap {family} card vs cpu: {out['worst']} beyond {tol}")
    return out


def roadmap_graphed_vs_eager(family: str, torch) -> dict:
    """From one start at full width and batch RM_BATCH: RM_K graphed
    iterations (one call of RM_K replays) against RM_K eager ones, bit for
    bit (losses and every leaf of the state), without and with the EMA;
    the capture's seconds and pool memory; without the EMA also the eager
    and the graphed iteration timed in turns (E G G E, RM_TURN_CALLS calls
    of RM_K iterations each, a call ending in its readback) and
    examples/s = batch * (n_critic + 1) per iteration."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import fused_step, roadmap_main

    out = {}
    for ema in (0.0, RM_EMA):
        pair, cfg, _ = roadmap_main._build(family, "cuda")
        n_critic = getattr(cfg, "n_critic", 1)
        real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
        x, y = roadmap_main._data(family, RM_N_TRAIN,
                                  prng.NUMBER_OF_THE_BEAST)
        table = torch.from_numpy(x).cuda()
        cond = None if y is None else torch.from_numpy(y).cuda()
        kw = dict(batch_size=RM_BATCH, steps_per_call=RM_K, n_critic=n_critic,
                  real_label=real_label, z_size=cfg.z_size, ema_decay=ema)
        z_g = prng.generator(cfg.seed, "roadmap-z", "cuda")
        fg, sg = pair.make_multistep(table, cond, z_gen=z_g, graphed=True,
                                     **kw)
        z_e = torch.Generator(device="cuda")
        z_e.set_state(z_g.get_state())
        box = {"e": fused_step.clone_state(sg), "g": sg}
        fe, _ = pair.make_multistep(table, cond, z_gen=z_e, graphed=False,
                                    **kw)

        def eager():
            box["e"], (d, g) = fe(box["e"])
            return torch.stack([d, g], -1).cpu()

        def graphed():
            box["g"], (d, g) = fg(box["g"])  # the static state, replayed
            return torch.stack([d, g], -1).cpu()

        le, lg = eager(), graphed()
        le_leaves = fused_step._leaves(box["e"])
        lg_leaves = fused_step._leaves(box["g"])
        res = dict(iterations=RM_K, losses_bitwise=torch.equal(le, lg),
                   loss_max_abs_diff=max_err(le, lg),
                   state_bitwise=le_leaves.keys() == lg_leaves.keys() and all(
                       torch.equal(le_leaves[k], lg_leaves[k]) for k in le_leaves),
                   generator_state_equal=torch.equal(z_e.get_state(),
                                                     z_g.get_state()),
                   setup=fg.graphed.setup,
                   launches_per_replay=fg.graphed.launches,
                   losses_last=lg[-1].tolist())
        require(res["losses_bitwise"] and res["state_bitwise"]
                and res["generator_state_equal"],
                f"roadmap {family} (ema {ema}): the graphed iterations' bits "
                f"differ from the eager ones' ({res})")
        require(bool(torch.isfinite(lg).all()),
                f"roadmap {family}: non-finite losses {lg.tolist()}")
        if not ema:
            def turn(fn):
                times = []
                for _ in range(RM_TURN_CALLS):
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
                return statistics.median(times) / RM_K * 1e3

            turns = [turn(eager), turn(graphed), turn(graphed), turn(eager)]
            res["turns_ms"] = turns
            res["eager_ms"] = (turns[0] + turns[3]) / 2
            res["graphed_ms"] = (turns[1] + turns[2]) / 2
            per_it = RM_BATCH * (n_critic + 1)
            res["eager_examples_per_s"] = per_it / res["eager_ms"] * 1e3
            res["graphed_examples_per_s"] = per_it / res["graphed_ms"] * 1e3
        out["ema" if ema else "plain"] = res
        del pair, fg, fe, sg, box, table, cond
        kernels.reset_launch_counts()
        torch.cuda.empty_cache()
    return out


def roadmap_children(root: str) -> dict:
    """``roadmap_main`` as a user runs it, one child process per family at
    its defaults but the length (RM_CHILD) and ``--n-train`` RM_N_TRAIN:
    the exit code, the artifact set and the result line.  Each result's
    ``port_launches`` counts the port kernels' launches around the child's
    graphed iterations (the capture's warm-up included): one ``bn_act`` an
    iteration for celeba and wgan-gp (gen_bn0), and none at all for
    cgan-cifar10 (its generator's BNs are conditional, with no kernel route
    in the JAX package either; its one plain BN, dis_bn2, is 4-D, which the
    JAX layer does not send to Pallas; Adam is torch ops).  The cgan child
    also runs its end-of-run conditional evaluation (``--fidelity-steps``
    RM_FIDELITY_STEPS; every class has over 50 rows, so the per-class
    frozen FID runs too)."""
    out = {}
    for family, (iters, every) in RM_CHILD.items():
        res = f"{root}/{family}_child"
        extra = (["--fidelity-steps", str(RM_FIDELITY_STEPS)]
                 if family == "cgan-cifar10" else [])
        rc, result, secs, tail = run_child(
            "gan_deeplearning4j_tpu_torch.train.roadmap_main",
            ["--family", family, "--iterations", str(iters), "--n-train",
             str(RM_N_TRAIN), "--print-every", str(every), "--res-path", res,
             *extra])
        require(rc == 0 and result is not None,
                f"roadmap_main {family}: exit {rc}, stderr {tail}")
        want = sorted([f"{family}_samples_{s}.png"
                       for s in range(every, iters + 1, every)]
                      + [f"{family}_metrics.jsonl", f"{family}_gen_model.zip",
                         f"{family}_dis_model.zip"])
        files = sorted(os.listdir(res))
        with open(f"{res}/{family}_metrics.jsonl") as f:
            steps = [json.loads(line)["step"] for line in f]
        require(files == want and steps == list(range(1, iters + 1)),
                f"roadmap_main {family}: files {files}, metrics steps "
                f"{steps[:3]}..{steps[-3:]}")
        require(result["family"] == family and result["steps"] == iters
                and result["graphed"] and result["device"].startswith("cuda")
                and math.isfinite(result["d_loss"])
                and math.isfinite(result["g_loss"])
                and result["examples_per_sec"] > 0,
                f"roadmap_main {family}: result {result}")
        expected = {k: 0 for k in result["port_launches"]}
        if family != "cgan-cifar10":
            expected["bn_act"] = iters + 1  # the warm-up and the replays
        require(result["port_launches"] == expected,
                f"roadmap_main {family}: launch counts "
                f"{result['port_launches']} != {expected}")
        if family == "cgan-cifar10":
            keys = ("conditional_fidelity", "probe_train_acc",
                    "mean_class_fid", "diversity_ratio")
            require(all(math.isfinite(result.get(k, math.nan)) for k in keys)
                    and len(result["per_class_fid"]) == 10
                    and 0.0 <= result["conditional_fidelity"] <= 1.0,
                    f"roadmap_main {family}: conditional scores {result}")
            print(json.dumps({"cgan_child": {
                k: result[k] for k in ("examples_per_sec", *keys)}}),
                flush=True)
        out[family] = dict(seconds=secs, files=len(files), result=result,
                           expected_launches=expected)
    return out


def roadmap_counted_and_resume(torch, root: str) -> dict:
    """The main path in this process: ``roadmap_main.train`` for celeba
    (RM_RESUME[0] iterations) and wgan-gp (RM_CHILD's length), each with
    the launch counters zeroed just before and read just after (one
    ``bn_act`` a G-step: the warm-up iteration and every replay).  Then
    celeba checkpointed at RM_RESUME[1] and resumed in this process to
    RM_RESUME[0]: its zips must be the straight run's, byte for byte."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.train import roadmap_main

    out = {}
    straight = {}
    for family, iters in (("celeba", RM_RESUME[0]),
                          ("wgan-gp", RM_CHILD["wgan-gp"][0])):
        res = f"{root}/{family}_counted"
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        r = roadmap_main.train(family, iters, RM_BATCH, res, RM_N_TRAIN, 100,
                               device="cuda", log=None)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        expected = {k: 0 for k in launches}
        expected["bn_act"] = iters + 1  # the warm-up iteration and the replays
        require(launches == expected,
                f"roadmap {family}: launch counts {launches} != {expected}")
        straight[family] = res
        out[family] = dict(iterations=iters, launches=launches,
                           expected_launches=expected,
                           steps_per_call=r["steps_per_call"],
                           examples_per_sec=r["examples_per_sec"],
                           host_seconds=r["host_seconds"],
                           losses=[r["d_loss"], r["g_loss"]])
    res = f"{root}/celeba_resumed"
    total, stop = RM_RESUME
    roadmap_main.train("celeba", stop, RM_BATCH, res, RM_N_TRAIN, 100,
                       device="cuda", checkpoint_every=stop, log=None)
    r = roadmap_main.train("celeba", total, RM_BATCH, res, RM_N_TRAIN, 100,
                           device="cuda", checkpoint_every=stop, resume=True,
                           log=None)
    same = {}
    for name in ("gen", "dis"):
        with open(f"{straight['celeba']}/celeba_{name}_model.zip", "rb") as f:
            a = f.read()
        with open(f"{res}/celeba_{name}_model.zip", "rb") as f:
            same[name] = a == f.read()
    require(all(same.values()) and r["steps"] == total,
            f"roadmap celeba resume: zips equal {same}, steps {r['steps']}")
    out["resume"] = dict(stop=stop, total=total, zips_bitwise=same,
                         restore_s=r["host_seconds"].get("restore_s"))
    return out


def roadmap_phase(torch, smi: str, randn, bw: float, sms: int) -> dict:
    """The roadmap families on the card (module docstring, phase 11)."""
    t0 = time.perf_counter()
    out = {"kernels": roadmap_kernels(torch, randn, bw, sms)}
    t1 = time.perf_counter()
    out["card_vs_cpu"] = {f: roadmap_card_vs_cpu(f, torch)
                          for f in RM_FAMILIES}
    t2 = time.perf_counter()
    out["graph"] = {f: roadmap_graphed_vs_eager(f, torch)
                    for f in RM_FAMILIES}
    t3 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gan4j_roadmap_")
    try:
        out["program"] = roadmap_children(root)
        t4 = time.perf_counter()
        out["main"] = roadmap_counted_and_resume(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds_by_part"] = {
        "kernels": t1 - t0, "card_vs_cpu": t2 - t1, "graph": t3 - t2,
        "program": t4 - t3, "main_and_resume": time.perf_counter() - t4}
    out["seconds"] = time.perf_counter() - t0
    out["batch"] = RM_BATCH
    out["nvidia_smi"] = smi
    return out


# -- the precision phase ------------------------------------------------------

# the JAX package's two precision flags, as runtime policies
PR_MODES = {"bf16": {"matmul_bf16": True}, "mp": {"compute_bf16": True},
            "bf16_mp": {"matmul_bf16": True, "compute_bf16": True}}
# the modes each workload runs in (CV and celeba also both flags at once)
PR_WORKLOADS = {"cv": ("bf16", "mp", "bf16_mp"), "insurance": ("bf16", "mp"),
                "celeba": ("bf16", "mp", "bf16_mp"), "wgan-gp": ("bf16", "mp"),
                "cgan-cifar10": ("bf16", "mp")}
PR_K = 10  # steps (iterations) per graphed call
PR_CALLS = 2  # calls from one start: the graphed-vs-eager and drift runs
# launches per step (iteration) of each port kernel on each path, the JAX
# routing's: the BN carve-out keeps bn_act f32 in every mode; under --mp
# the upsample cotangent is bf16 and takes the plain block sum
PR_PER_STEP = {"cv": {"fused_update": 3, "bn_act": 3, "upsample_bwd": 2},
               "insurance": {"fused_update": 3, "bn_act": 4},
               "celeba": {"bn_act": 1}, "wgan-gp": {"bn_act": 1},
               "cgan-cifar10": {}}
# the CV step's two upsample cotangents (the G-step's backward)
PR_UPSAMPLE = [(BATCH, 128, 14, 14), (BATCH, 64, 28, 28)]
# the card-vs-CPU step's batch (the CPU runs it in the mode and in parity)
PR_CPU_BATCH = 16
PR_PAIR_MODELS = {"celeba": ("dcgan_celeba", "CelebAConfig"),
                  "wgan-gp": ("wgan_gp", "WGANGPConfig"),
                  "cgan-cifar10": ("cgan_cifar10", "CGANConfig")}
PR_CHILD_CGAN = ["--family", "cgan-cifar10", "--iterations", "100",
                 "--n-train", "2000", "--print-every", "50",
                 "--fidelity-steps", "100", "--mp"]


def pr_expected(workload: str, mode: str, steps: int) -> dict:
    """Each port kernel's launches over ``steps`` steps of ``workload``
    under ``mode`` (PR_PER_STEP)."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels

    per = dict(PR_PER_STEP[workload])
    if workload == "cv" and PR_MODES.get(mode, {}).get("compute_bf16"):
        per["upsample_bwd"] = 0
    return {k: per.get(k, 0) * steps for k in kernels.launch_counts()}


def pr_runs(workload: str, torch):
    """(graphed call, eager call, the graph, its generator, the eager
    generator) for ``workload`` at full width on the card under the current
    policy: the trainer's captured step (cv at batch 200, insurance at 50)
    or the pair's captured iteration (batch RM_BATCH), and the same step
    eager from a copy of the graph's start; each call runs PR_K steps and
    returns their losses [PR_K, n] on the host."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import (
        fused_step,
        insurance_main,
        roadmap_main,
    )
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    if workload in ("cv", "insurance"):
        if workload == "cv":
            trainer = GANTrainer(M.CVConfig(), batch_size=BATCH,
                                 n_train=N_TRAIN, device="cuda",
                                 steps_per_call=PR_K)
        else:
            res = tempfile.mkdtemp(prefix="gan4j_pr_ins_")
            try:
                trainer = GANTrainer(
                    device="cuda",
                    workload=insurance_main.InsuranceWorkload(),
                    config=insurance_main.default_config(
                        res_path=res, batch_size=INS_BATCH, num_iterations=0,
                        print_every=0, save_every=0, metrics=False,
                        steps_per_call=PR_K))
            finally:
                shutil.rmtree(res, ignore_errors=True)
        g = trainer.graphed
        z_e = torch.Generator(device="cuda")
        z_e.set_state(trainer.z_gen.get_state())
        box = {"s": fused_step.clone_state(g.state)}
        step = trainer.step_fn(PR_K)
        inputs = (trainer.features, trainer.labels, trainer.y_real,
                  trainer.y_fake, trainer.ones)

        def eager():
            box["s"], losses = step(box["s"], *inputs, z_gen=z_e)
            return torch.stack(losses, -1).cpu()

        return (lambda: g(PR_K)), eager, g, trainer.z_gen, z_e, box
    pair, cfg, _ = roadmap_main._build(workload, "cuda")
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
    x, y = roadmap_main._data(workload, RM_N_TRAIN, prng.NUMBER_OF_THE_BEAST)
    table = torch.from_numpy(x).cuda()
    cond = None if y is None else torch.from_numpy(y).cuda()
    kw = dict(batch_size=RM_BATCH, steps_per_call=PR_K, n_critic=n_critic,
              real_label=real_label, z_size=cfg.z_size)
    z_g = prng.generator(cfg.seed, "roadmap-z", "cuda")
    fg, sg = pair.make_multistep(table, cond, z_gen=z_g, graphed=True, **kw)
    z_e = torch.Generator(device="cuda")
    z_e.set_state(z_g.get_state())
    box = {"s": fused_step.clone_state(sg), "g": sg}
    fe, _ = pair.make_multistep(table, cond, z_gen=z_e, graphed=False, **kw)

    def eager():
        box["s"], (d, gl) = fe(box["s"])
        return torch.stack([d, gl], -1).cpu()

    def graphed():
        box["g"], (d, gl) = fg(box["g"])
        return torch.stack([d, gl], -1).cpu()

    return graphed, eager, fg.graphed, z_g, z_e, box


def pr_graphed_vs_eager(workload: str, mode: str, torch) -> dict:
    """Under ``mode``: PR_CALLS graphed calls of PR_K replays against as
    many eager calls from one start, bit for bit (losses, every leaf of the
    final state, the generators); the eager run's launches (counters zeroed
    just before, read just after) and the graph's per replay, each against
    ``pr_expected``; the graphed losses [PR_CALLS * PR_K, n]; the graphed
    and eager call ms (host clock around a call ending in its readback,
    median over the calls after the first); and, off parity, a replay
    under the parity policy refused."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.runtime import backend
    from gan_deeplearning4j_tpu_torch.train import fused_step

    with backend.configured(**PR_MODES.get(mode, {})):
        graphed, eager, g, z_g, z_e, box = pr_runs(workload, torch)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        le, te = [], []
        for _ in range(PR_CALLS):
            t0 = time.perf_counter()
            le.append(eager())
            te.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        eager_launches = kernels.launch_counts()
        lg, tg = [], []
        for _ in range(PR_CALLS):
            t0 = time.perf_counter()
            lg.append(graphed())
            tg.append(time.perf_counter() - t0)
        state_g = g.state
    # the graph keeps the policy of its capture: a replay under another
    # (here the policy put back) is refused
    refused = None
    if mode != "parity":
        try:
            g(1)
            refused = False
        except ValueError:
            refused = True
    le, lg = torch.cat(le), torch.cat(lg)
    a, b = fused_step._leaves(box["s"]), fused_step._leaves(state_g)
    steps = PR_CALLS * PR_K
    out = dict(
        steps=steps, losses_bitwise=torch.equal(le, lg),
        state_bitwise=a.keys() == b.keys() and all(
            torch.equal(a[k], b[k]) for k in a),
        generator_state_equal=torch.equal(z_e.get_state(), z_g.get_state()),
        losses=lg, eager_launches=eager_launches,
        launches_per_replay=g.launches,
        expected_per_step=pr_expected(workload, mode, 1),
        replay_under_parity_refused=refused,
        graphed_call_ms=statistics.median(tg[1:]) * 1e3 / PR_K,
        eager_call_ms=statistics.median(te[1:]) * 1e3 / PR_K,
        capture=g.setup)
    require(out["losses_bitwise"] and out["state_bitwise"]
            and out["generator_state_equal"],
            f"precision {workload} {mode}: the graphed steps' bits differ "
            f"from the eager ones' (losses max |d| {max_err(le, lg)})")
    require(eager_launches == pr_expected(workload, mode, steps)
            and g.launches == out["expected_per_step"],
            f"precision {workload} {mode}: launches eager {eager_launches}, "
            f"per replay {g.launches}, expected per step "
            f"{out['expected_per_step']}")
    require(bool(torch.isfinite(lg).all()),
            f"precision {workload} {mode}: non-finite losses {lg.tolist()}")
    require(refused is not False, f"precision {workload} {mode}: the graph "
            "replayed under parity")
    del graphed, eager, g, box
    kernels.reset_launch_counts()
    torch.cuda.empty_cache()
    return out


def _lr0(cfg):
    """``cfg`` with every learning rate 0: each update of a step leaves the
    params where they were, so every gradient is taken at the start."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: 0.0 for k in (
        "learning_rate", "d_learning_rate", "dis_learning_rate",
        "gen_learning_rate") if k in names})


def pr_step_lr0(workload: str, device, torch):
    """One step (iteration) of ``workload`` at full width on ``device``
    under the current policy, learning rates 0, at batch PR_CPU_BATCH (the
    insurance step's own 50), from the seed-666 init and fixed draws made
    on the CPU -> (losses, {leaf: gradient}); the gradient
    read back from the updater state (RmsProp: sqrt(cache), the cache being
    (1 - 1e-8) g^2; Adam: m / (1 - b1))."""
    from gan_deeplearning4j_tpu_torch.train import fused_step, roadmap_main
    from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws, PairState

    gen = torch.Generator().manual_seed(31)
    if workload in ("cv", "insurance"):
        if workload == "cv":
            from gan_deeplearning4j_tpu_torch.data.datasets import (
                synthetic_mnist,
            )
            from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M

            cfg, B = _lr0(M.CVConfig()), PR_CPU_BATCH
            feats, lab = synthetic_mnist(B, seed=11)
            real = torch.from_numpy(feats)
            labels = torch.nn.functional.one_hot(torch.from_numpy(lab),
                                                 10).float()
        else:
            from gan_deeplearning4j_tpu_torch.models import (
                mlpgan_insurance as M,
            )

            cfg, B = _lr0(M.InsuranceConfig()), INS_BATCH
            real = torch.rand((B, 12), generator=gen)
            labels = (torch.rand((B, 1), generator=gen) > 0.5).float()
        d = M.build_discriminator(cfg, device)
        graphs = (d, M.build_generator(cfg, device), M.build_gan(cfg, device),
                  M.build_classifier(d, cfg))
        step = fused_step.make_protocol_step(
            *graphs, M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER,
            z_size=cfg.z_size, num_features=cfg.num_features)
        host = [real, labels, 1.0 + 0.05 * torch.randn((B, 1), generator=gen),
                0.05 * torch.randn((B, 1), generator=gen), torch.ones((B, 1)),
                torch.rand((B, cfg.z_size), generator=gen) * 2 - 1,
                torch.rand((B, cfg.z_size), generator=gen) * 2 - 1]
        a = [t.to(device) for t in host]
        state, losses = step(fused_step.state_from_graphs(*graphs), *a[:5],
                             z1=a[5], z2=a[6])
        grads = {k: v.double().sqrt().cpu()
                 for k, v in fused_step._leaves(state).items()
                 if k[0].endswith("_opt")}
        return torch.stack(losses).cpu().double(), grads
    import importlib

    from gan_deeplearning4j_tpu_torch.train.gan_pair import GANPair

    mod, cls = PR_PAIR_MODELS[workload]
    M = importlib.import_module(f"gan_deeplearning4j_tpu_torch.models.{mod}")
    cfg = _lr0(getattr(M, cls)())
    if workload == "wgan-gp":
        pair = GANPair(M.build_generator(cfg, device),
                       M.build_critic(cfg, device), mode="wgan-gp",
                       gp_weight=cfg.gp_weight)
    else:
        pair = GANPair(M.build_generator(cfg, device),
                       M.build_discriminator(cfg, device),
                       ms_weight=cfg.ms_weight)
    n_critic = getattr(cfg, "n_critic", 1)
    real_label = getattr(cfg, "real_label", 1.0) if pair.mode == "gan" else 1.0
    x, y = roadmap_main._data(workload, 512, 7)
    draws = pair.draw(torch.Generator().manual_seed(8), 512, PR_CPU_BATCH,
                      n_critic, cfg.z_size, "cpu")
    draws = Draws(*[None if v is None else
                    [t.to(device) for t in v] if isinstance(v, list)
                    else v.to(device) for v in draws])
    state = PairState(pair.gen.params, pair.gen.opt_state, pair.dis.params,
                      pair.dis.opt_state, torch.tensor(0, device=device))
    one = pair.iteration(PR_CPU_BATCH, n_critic, cfg.z_size)
    state, losses = one(state, torch.from_numpy(x).to(device),
                        *pair.label_vectors(PR_CPU_BATCH, real_label),
                        None if y is None else torch.from_numpy(y).to(device),
                        draws=draws)
    b1 = 0.5  # every roadmap family's Adam beta1
    grads = {k[:-1]: v.double().cpu() / (1 - b1)
             for k, v in fused_step._leaves(state).items()
             if k[0].endswith("_opt") and k[-1] == "m"}
    return torch.stack(losses).cpu().double(), grads


def _grad_rel(ref: dict, got: dict) -> float:
    num = sum(float((got[k] - v).square().sum()) for k, v in ref.items())
    den = sum(float(v.square().sum()) for v in ref.values())
    return math.sqrt(num / den)


def pr_card_vs_cpu(workload: str, mode: str, parity_cpu, torch) -> dict:
    """One step (learning rates 0, ``pr_step_lr0``) under ``mode`` on the
    card and on the CPU, and the CPU's parity step (``parity_cpu``), from
    the same params and draws.  The gradients (norm relative over every
    leaf) of the card lie within PR_CARD_RATIO of the mode's own distance
    from parity on the CPU (cuDNN's and the CPU's f32 sums round to bf16
    differently, far less than the mode's roundings move the step); each
    loss within PR_LOSS_REL of the CPU's, relative (one bf16 rounding of a
    loss taken from bf16 activations).  The mode's own loss deviation is
    printed beside it."""
    from gan_deeplearning4j_tpu_torch.runtime import backend

    with backend.configured(**PR_MODES[mode]):
        cpu = pr_step_lr0(workload, "cpu", torch)
        card = pr_step_lr0(workload, "cuda", torch)
    out = {"loss_err": float((card[0] - cpu[0]).abs().max()),
           "loss_dev": float((parity_cpu[0] - cpu[0]).abs().max()),
           "grad_err": _grad_rel(cpu[1], card[1]),
           "grad_dev": _grad_rel(cpu[1], parity_cpu[1]),
           "losses_card": card[0].tolist(), "losses_cpu": cpu[0].tolist()}
    out["loss_rel"] = float(((card[0] - cpu[0]).abs()
                             / cpu[0].abs().clamp_min(1e-6)).max())
    out["grad_ratio"] = out["grad_err"] / max(out["grad_dev"], 1e-30)
    require(bool(torch.isfinite(card[0]).all())
            and out["loss_rel"] <= PR_LOSS_REL
            and out["grad_ratio"] <= PR_CARD_RATIO,
            f"precision {workload} {mode}: the card against the CPU {out}")
    return out


PR_CARD_RATIO = 0.5
PR_LOSS_REL = 2.0 ** -8


def pr_block_sum(torch, bw: float) -> list:
    """The plain bf16 block sum that a ``--mp`` cotangent takes, at the CV
    step's two shapes: its device time beside the f32 kernel's on the f32
    cotangent of the same shape (in turns: kernel, plain, plain, kernel)
    and the bf16 sum's bound (bf16 read once, written once)."""
    from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import upsample_bwd

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, C, H, W in PR_UPSAMPLE:
        g32 = torch.randn((B, C, 2 * H, 2 * W), generator=gen, device="cuda")
        g16 = g32.bfloat16()

        def plain():
            return g16.reshape(B, C, H, 2, W, 2).sum((3, 5))

        kernel_ms, plain_ms, turns = in_turns(
            lambda: upsample_bwd(g32, 2, 2), plain, torch)
        ref = g16.float().reshape(B, C, H, 2, W, 2).sum((3, 5)).bfloat16()
        nbytes = 2 * (g16.numel() + B * C * H * W)
        rows.append(dict(g_shape=[B, C, 2 * H, 2 * W], bf16_plain_ms=plain_ms,
                         f32_kernel_ms=kernel_ms, turns_ms=turns,
                         bf16_bound_ms=nbytes / bw * 1e3,
                         f32_sum_rounded_once=torch.equal(plain(), ref)))
        require(rows[-1]["f32_sum_rounded_once"],
                f"precision: the bf16 block sum of g {rows[-1]['g_shape']} is "
                "not the f32 sum rounded once")
    return rows


def pr_wrappers_refuse_bf16(torch) -> dict:
    """Each f32-only kernel wrapper refuses a bf16 card tensor (TypeError,
    before any launch), so a mode's step that ran through a wrapper gave
    it f32."""
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels

    x = torch.randn((8, 64), device="cuda").bfloat16()
    f = torch.ones(64, device="cuda")
    calls = {
        "bn_act": lambda: kernels.fused_bn_act_train(x, f, f * 0, 1e-5,
                                                     "relu"),
        "upsample_bwd": lambda: kernels.upsample_bwd(
            x.reshape(2, 4, 8, 8), 2, 2),
        "fused_update": lambda: kernels.fused_rmsprop_chains(
            [x.float()], [x], [x.float()], [None])}
    before = kernels.launch_counts()
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = "accepted"
        except TypeError as e:
            out[name] = f"TypeError: {e}"[:120]
    require(all(v.startswith("TypeError") for v in out.values())
            and kernels.launch_counts() == before,
            f"precision: an f32-only wrapper took bf16: {out}")
    return out


def precision_phase(torch, smi: str, bw: float) -> dict:
    """The reference's precision modes on the card (module docstring,
    phase 12)."""
    t0 = time.perf_counter()
    out = {"wrappers_refuse_bf16": pr_wrappers_refuse_bf16(torch),
           "upsample_bf16_block_sum": pr_block_sum(torch, bw)}
    runs, card = {}, {}
    for workload, modes in PR_WORKLOADS.items():
        runs[workload] = {m: pr_graphed_vs_eager(workload, m, torch)
                          for m in ("parity",) + modes}
        parity_cpu = pr_step_lr0(workload, "cpu", torch)
        card[workload] = {m: pr_card_vs_cpu(workload, m, parity_cpu, torch)
                          for m in modes}
    t1 = time.perf_counter()
    drift = {}
    for workload, res in runs.items():
        ref = res["parity"]["losses"]
        drift[workload] = {m: {
            "max_abs": float((r["losses"] - ref).abs().max()),
            "final": (r["losses"][-1] - ref[-1]).tolist()}
            for m, r in res.items() if m != "parity"}
    out["graphed_vs_eager"] = {w: {m: {k: v for k, v in r.items()
                                       if k != "losses"}
                                   for m, r in res.items()}
                               for w, res in runs.items()}
    out["loss_drift"] = drift
    out["card_vs_cpu"] = card
    root = tempfile.mkdtemp(prefix="gan4j_precision_")
    try:
        children = {}
        for name, module, args in (
                ("roadmap_cgan_mp", "gan_deeplearning4j_tpu_torch.train."
                 "roadmap_main", PR_CHILD_CGAN + ["--res-path",
                                                  f"{root}/cgan"]),
                ("cv_main_bf16_mp", "gan_deeplearning4j_tpu_torch.train."
                 "cv_main", CV_ARGS + ["--bf16", "--mp", "--res-path",
                                       f"{root}/cv"])):
            rc, result, secs, tail = run_child(module, args)
            require(rc == 0 and result is not None,
                    f"precision child {name}: exit {rc}, stderr {tail}")
            children[name] = dict(seconds=secs, result=result)
        cg = children["roadmap_cgan_mp"]["result"]
        require(cg["precision"] == {"matmul_bf16": False, "compute_bf16": True}
                and cg["steps"] == 100 and cg["graphed"]
                and math.isfinite(cg["d_loss"]) and math.isfinite(cg["g_loss"])
                and 0.0 <= cg["conditional_fidelity"] <= 1.0
                and math.isfinite(cg["mean_class_fid"]),
                f"precision child roadmap_cgan_mp: {cg}")
        cv = children["cv_main_bf16_mp"]["result"]
        require(cv["precision"] == {"matmul_bf16": True, "compute_bf16": True}
                and cv["steps"] == CV_STEPS and cv["graphed"]
                and all(math.isfinite(cv[k]) for k in (
                    "d_loss", "g_loss", "test_accuracy", "fid_frozen")),
                f"precision child cv_main_bf16_mp: {cv}")
        out["children"] = children
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds_by_part"] = {"steps": t1 - t0,
                              "children": time.perf_counter() - t1}
    out["seconds"] = time.perf_counter() - t0
    out["nvidia_smi"] = smi
    return out


def main() -> int:
    global T_START
    T_START = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import build
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act_4d as bn4d
    from gan_deeplearning4j_tpu_torch.ops.cuda import fused_update as fu
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
        bn_act_plain,
        bn_apply_plain,
        bn_apply_sums_plain,
        bn_moments_plain,
    )
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act_4d import bn_act_4d_plain
    from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
        rmsprop_chain_plain,
    )
    from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import (
        upsample_bwd_plain,
    )
    from gan_deeplearning4j_tpu_torch.parallel import mesh
    from gan_deeplearning4j_tpu_torch.runtime import backend
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    # -- 1. environment ------------------------------------------------------
    dev = backend.resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw = bandwidth_for(name)
    print(smi, flush=True)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, nvidia_smi=smi, device_count=torch.cuda.device_count(),
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_deterministic=torch.backends.cudnn.deterministic,
         cudnn_benchmark=torch.backends.cudnn.benchmark,
         bandwidth_bytes_per_s=bw)
    require(not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32
            and torch.backends.cudnn.deterministic,
            "TF32 is on or cuDNN may pick nondeterministic algorithms; the "
            "port runs in f32 parity mode")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    per_kernel = build.build()
    ptxas = {n: [ln.strip() for ln in (build.build_dir() / f"lib{n}.log")
                 .read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in build.KERNELS
             if (build.build_dir() / f"lib{n}.log").exists()}
    emit("build", seconds=time.perf_counter() - t0, per_kernel=per_kernel,
         dir=str(build.build_dir()), ptxas=ptxas)

    # -- 3. kernels against their plain versions, and their times ------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    report = []

    # fused_update: one multi-leaf launch per graph update, over every
    # RmsProp leaf of the three trained graphs, with each leaf's own rates
    # as the protocol step runs it
    cfg = M.CVConfig()
    dis = M.build_discriminator(cfg, dev)
    graphs = {"dis": dis, "gan": M.build_gan(cfg, dev),
              "classifier": M.build_classifier(dis, cfg)}
    updates = []
    for g in graphs.values():
        keys = [(layer, n) for layer, lp in g.params.items() for n in lp]
        shapes = [g.params[layer][n].shape for layer, n in keys]
        updates.append(dict(
            ps=[randn(*s, scale=0.05) for s in shapes],
            gs=[randn(*s, scale=0.02) for s in shapes],
            cs=[randn(*s, scale=1e-3).abs() for s in shapes],
            rates=[g.updater.rates(layer, n) for layer, n in keys],
            clip=g.updater.clip_threshold))

    def chains(u, gs=None):
        return kernels.fused_rmsprop_chains(
            u["ps"], u["gs"] if gs is None else gs, u["cs"], u["rates"],
            clip=u["clip"])

    def chains_plain(u):
        return [rmsprop_chain_plain(p, g, c, **r._asdict(), clip=u["clip"])
                for p, g, c, r in zip(u["ps"], u["gs"], u["cs"], u["rates"])]

    err, scalar_leaves, calls, n_elems = 0.0, 0, [], 0
    for name_g, u in zip(graphs, updates):
        sizes = [p.numel() for p in u["ps"]]
        calls.append(f"{name_g}: {len(sizes)} leaves, {sum(sizes)} elements")
        n_elems += sum(sizes)
        pk, ck = chains(u)
        for (pp, cp), a, b in zip(chains_plain(u), pk, ck):
            require(within(a, pp, 1e-6, 1e-5) and within(b, cp, 1e-12, 1e-5),
                    f"fused_update disagrees with its plain version on a "
                    f"{name_g} leaf {tuple(pp.shape)}")
            err = max(err, max_err(a, pp), max_err(b, cp))
        # the same kernel launched once per leaf
        single = [kernels.fused_rmsprop_chain(p, g, c, **r._asdict(),
                                              clip=u["clip"])
                  for p, g, c, r in zip(u["ps"], u["gs"], u["cs"], u["rates"])]
        require(all(torch.equal(a, s[0]) and torch.equal(b, s[1])
                    for a, b, s in zip(pk, ck, single)),
                f"fused_update: the {name_g} launch differs from one launch "
                "per leaf")
        # the dp path's layout: the gradients as split views of one buffer,
        # from an odd element offset, so most leaves take the scalar path
        flat = torch.empty(1 + sum(sizes), device=dev)
        flat[1:] = torch.cat([g.reshape(-1) for g in u["gs"]])
        split = [v.view_as(g) for v, g in zip(flat[1:].split(sizes), u["gs"])]
        plan = fu.launch_plan(sizes, [p.data_ptr() | g.data_ptr() | c.data_ptr()
                                      for p, g, c in zip(u["ps"], split, u["cs"])],
                              u["rates"], u["clip"])
        require(len(plan.launches) == 1 and not all(plan.vec),
                f"fused_update: the {name_g} split layout plans "
                f"{len(plan.launches)} launches, vec {plan.vec}")
        scalar_leaves += plan.vec.count(False)
        ps2, cs2 = chains(u, split)
        require(all(torch.equal(a, b) for a, b in zip(pk + ck, ps2 + cs2)),
                f"fused_update: the {name_g} split views give other bits")
        ps3, cs3 = chains(u)
        require(all(torch.equal(a, b) for a, b in zip(pk + ck, ps3 + cs3)),
                f"fused_update: two {name_g} launches differ")

    def enqueue_ms():
        """The host's time to enqueue the three launches (the wrappers' own
        work, the device idle), median over REPS."""
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for u in updates:
                chains(u)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    report.append(dict(
        name="fused_update", tolerance="|d| <= 1e-6 + 1e-5|plain| on p', "
        "1e-12 + 1e-5|plain| on the cache", max_abs_err=err, calls=calls,
        bitwise_single_leaf=True, bitwise_split_views=True,
        split_scalar_leaves=scalar_leaves, bitwise_repeat=True,
        ms=time_ms(lambda: [chains(u) for u in updates], torch),
        enqueue_ms=enqueue_ms(),
        plain_ms=time_ms(lambda: [chains_plain(u) for u in updates], torch),
        floor_ms=floor_ms(len(updates), torch),
        library_ms=None, bytes=20 * n_elems, flops=12 * n_elems))

    # the cluster BN kernels' plans at every shape this phase gives them:
    # the step's three 2-D BNs (all tanh), the JAX package's 4-D benchmark
    # shapes with C > 1 (benchmarks/pallas_bn_bench.py; no model path runs
    # the 4-D kernel) and one 4-D shape (21 MB) whose 2 MB channels do not
    # fit in a cluster's shared memory
    bn_shapes = [(BATCH, 2), (BATCH, 7 * 7 * 128), (BATCH, 1024)]
    shapes_4d = [(200, 64, 12, 12), (128, 64, 32, 32), (128, 128, 16, 16),
                 (128, 256, 8, 8), (128, 512, 4, 4)]
    streamed_4d = (32, 10, 128, 128)
    bn_in = [(randn(b, f, scale=0.5), randn(f, scale=0.1, shift=1.0),
              randn(f, scale=0.1)) for b, f in bn_shapes]
    in_4d = [(randn(*s, scale=0.5, shift=0.2), randn(s[1], scale=0.1, shift=1.0),
              randn(s[1], scale=0.1)) for s in shapes_4d + [streamed_4d]]
    sms = bn2d.sm_count(dev)
    # the sync-BN pair: the three 2-D BNs of a 2-rank step, per rank
    pair_shapes = [(BATCH // DP_WORLD, f) for _, f in bn_shapes]

    def plan_line(shape, plan):
        return {"shape": list(shape), **plan._asdict(),
                "branch": "resident" if plan.resident else "streamed"}

    plans_4d = [bn4d.launch_plan(b, c, h * w, x.data_ptr(), sms)
                for (b, c, h, w), (x, _, _) in zip(shapes_4d + [streamed_4d],
                                                   in_4d)]
    emit("plans", sms=sms,
         bn_act=[plan_line(s, bn2d.launch_plan(*s, sms)) for s in bn_shapes],
         bn_act_4d=[plan_line(s, p) for s, p in
                    zip(shapes_4d + [streamed_4d], plans_4d)],
         bn_moments=[{"shape": list(s), **bn2d.moments_plan(*s)._asdict()}
                     for s in pair_shapes],
         bn_apply=[{"shape": list(s), **bn2d.apply_plan(*s, sms)._asdict()}
                   for s in pair_shapes])
    require(not plans_4d[-1].resident and all(p.resident for p in plans_4d[:-1]),
            "bn_act_4d: the streamed shape must stream and the others not")
    err = 0.0
    for x, gm, bt in bn_in:
        yk, mk, vk = kernels.fused_bn_act_train(x, gm, bt, 1e-5, "tanh")
        yp, mp, vp = bn_act_plain(x, gm, bt, 1e-5, "tanh")
        require(within(yk, yp, 1e-5, 1e-4) and within(mk, mp, 1e-6, 1e-4)
                and within(vk, vp, 1e-6, 1e-4),
                f"bn_act disagrees with its plain version at {tuple(x.shape)}")
        err = max(err, max_err(yk, yp), max_err(mk, mp),
                  max_err(vk, vp))
    # the gradient: the kernel's autograd.Function against autograd
    # through the plain version
    x, gm, bt = (t.clone().requires_grad_(True) for t in bn_in[1])
    gy = randn(*x.shape)
    yk, _, _ = kernels.fused_bn_act_train(x, gm, bt, 1e-5, "tanh")
    gk = torch.autograd.grad(yk, (x, gm, bt), gy)
    yp, _, _ = bn_act_plain(x, gm, bt, 1e-5, "tanh")
    gp = torch.autograd.grad(yp, (x, gm, bt), gy)
    for a, b in zip(gk, gp):
        require(within(a, b, 1e-4, 1e-3), "bn_act gradient disagrees")
    require(bitwise_repeat(lambda *a: kernels.fused_bn_act_train(
        *a, 1e-5, "tanh"), bn_in, torch), "bn_act: two launches differ")
    torch_f = torch.nn.functional
    ms, library_ms, turns = in_turns(
        lambda: [kernels.fused_bn_act_train(x, gm, bt, 1e-5, "tanh")
                 for x, gm, bt in bn_in],
        lambda: [torch_f.batch_norm(x, None, None, gm, bt, training=True,
                                    eps=1e-5) for x, gm, bt in bn_in], torch)
    report.append(dict(
        name="bn_act", tolerance="|d| <= 1e-5 + 1e-4|plain| on y, "
        "1e-6 + 1e-4|plain| on mean/var", max_abs_err=err,
        calls=[f"[{b},{f}] tanh" for b, f in bn_shapes], bitwise_repeat=True,
        ms=ms, plain_ms=time_ms(lambda: [bn_act_plain(x, gm, bt, 1e-5, "tanh")
                                         for x, gm, bt in bn_in], torch),
        floor_ms=floor_ms(len(bn_in), torch),
        library_ms=library_ms, turns_ms=turns,
        library_call="F.batch_norm(training=True), without the activation",
        bytes=sum(8 * b * f + 16 * f for b, f in bn_shapes),
        flops=sum(10 * b * f for b, f in bn_shapes)))

    # upsample_bwd: the G-step backward of the generator's two upsamples
    up_shapes = [(BATCH, 128, 14, 14), (BATCH, 64, 28, 28)]
    up_in = [randn(*s) for s in up_shapes]
    err = 0.0
    for g in up_in:
        dk = kernels.upsample_bwd(g, 2, 2)
        dp = upsample_bwd_plain(g, 2, 2)
        require(within(dk, dp, 1e-5, 1e-5),
                f"upsample_bwd disagrees with its plain version at {tuple(g.shape)}")
        err = max(err, max_err(dk, dp))

    def library_block_sum(g):
        B, C, Hs, Ws = g.shape
        return g.view(B, C, Hs // 2, 2, Ws // 2, 2).sum((3, 5))

    report.append(dict(
        name="upsample_bwd", tolerance="|d| <= 1e-5 + 1e-5|plain|",
        max_abs_err=err,
        calls=[f"[{b},{c},{h},{w}] -> [{b},{c},{h // 2},{w // 2}]"
               for b, c, h, w in up_shapes],
        ms=time_ms(lambda: [kernels.upsample_bwd(g, 2, 2) for g in up_in], torch),
        plain_ms=time_ms(lambda: [upsample_bwd_plain(g, 2, 2) for g in up_in],
                         torch),
        floor_ms=floor_ms(len(up_in), torch),
        library_ms=time_ms(lambda: [library_block_sum(g) for g in up_in], torch),
        library_call="g.view(B,C,H,2,W,2).sum((3,5))",
        bytes=sum(4 * math.prod(s) * 5 // 4 for s in up_shapes),
        flops=sum(math.prod(s) for s in up_shapes)))

    # bn_moments / bn_apply: the three 2-D BNs of a 2-rank step, per rank
    # (the pair's gradient needs a group: it is checked in the dp phase)
    pair_in = [(randn(b, f, scale=0.5, shift=0.2), randn(f, scale=0.1, shift=1.0),
                randn(f, scale=0.1)) for b, f in pair_shapes]
    err = 0.0
    for x, _, _ in pair_in:
        for a, b in zip(kernels.bn_moments(x), bn_moments_plain(x)):
            require(within(a, b, 1e-6, 1e-4), "bn_moments disagrees with its "
                    f"plain version at {tuple(x.shape)}")
            err = max(err, max_err(a, b))
    require(bitwise_repeat(kernels.bn_moments, [(x,) for x, _, _ in pair_in],
                           torch), "bn_moments: two launches differ")
    # the float4 and the scalar path: the [100, 1024] input, and the same
    # values from an offset view
    x = pair_in[2][0]
    require(all(torch.equal(a, b) for a, b in zip(
        kernels.bn_moments(x), kernels.bn_moments(offset_view(x, torch)))),
        "bn_moments: the scalar path (offset view) gives other bits")
    ms, library_ms, turns = in_turns(
        lambda: [kernels.bn_moments(x) for x, _, _ in pair_in],
        lambda: [torch.var_mean(x, dim=0, unbiased=False)
                 for x, _, _ in pair_in], torch)
    report.append(dict(
        name="bn_moments", tolerance="|d| <= 1e-6 + 1e-4|plain|",
        max_abs_err=err, calls=[f"[{b},{f}]" for b, f in pair_shapes],
        bitwise_repeat=True, bitwise_scalar_path=True,
        gradient="checked in the dp phase (2 ranks)", ms=ms,
        plain_ms=time_ms(lambda: [bn_moments_plain(x) for x, _, _ in pair_in],
                         torch),
        floor_ms=floor_ms(len(pair_in), torch),
        library_ms=library_ms, turns_ms=turns,
        library_call="torch.var_mean(x, dim=0, unbiased=False)",
        bytes=sum(4 * b * f + 8 * f for b, f in pair_shapes),
        flops=sum(3 * b * f for b, f in pair_shapes)))

    # bn_apply as the step runs it: from the [2, F] sums the all-reduce
    # leaves, for worlds 1-4 (sums made from this rank's moments times the
    # world, plus noise); mean and var must be the old epilogue's bits
    def sums_for(x, world):
        mean, m2 = bn_moments_plain(x)
        noise = randn(2, x.shape[1], scale=1e-3)
        return torch.stack([mean, m2]) * world + noise * noise

    err, worlds = 0.0, (1, 2, 3, 4)
    for x, gm, bt in pair_in:
        for world in worlds:
            sums = sums_for(x, world)
            yk, mk, vk = kernels.bn_apply_sums(x, sums, world, gm, bt, 1e-5,
                                               "tanh")
            yp, mp, vp = bn_apply_sums_plain(x, sums, world, gm, bt, 1e-5,
                                             "tanh")
            mo, vo = old_epilogue(sums, world, torch)
            require(within(yk, yp, 1e-5, 1e-4), "bn_apply (from sums) "
                    f"disagrees with its plain version at {tuple(x.shape)}, "
                    f"world {world}")
            require(all(torch.equal(a, b) for a, b in
                        ((mk, mp), (vk, vp), (mk, mo), (vk, vo))),
                    f"bn_apply (from sums): mean/var at {tuple(x.shape)}, "
                    f"world {world} are not the old epilogue's bits")
            err = max(err, max_err(yk, yp))
        # the entry given mean and var (the wrapper bn_apply)
        yk = kernels.bn_apply(x, mp, vp, gm, bt, 1e-5, "tanh")
        require(within(yk, bn_apply_plain(x, mp, vp, gm, bt, 1e-5, "tanh"),
                       1e-5, 1e-4),
                f"bn_apply disagrees with its plain version at {tuple(x.shape)}")
    pairs = [(x, sums_for(x, DP_WORLD), gm, bt) for x, gm, bt in pair_in]
    require(bitwise_repeat(lambda x, s, gm, bt: kernels.bn_apply_sums(
        x, s, DP_WORLD, gm, bt, 1e-5, "tanh"), pairs, torch),
        "bn_apply: two launches differ")
    x, sums, gm, bt = pairs[2]
    require(all(torch.equal(a, b) for a, b in zip(
        kernels.bn_apply_sums(x, sums, DP_WORLD, gm, bt, 1e-5, "tanh"),
        kernels.bn_apply_sums(offset_view(x, torch), sums, DP_WORLD, gm, bt,
                              1e-5, "tanh"))),
        "bn_apply: the scalar path (offset view) gives other bits")
    moments = [old_epilogue(s, DP_WORLD, torch) for _, s, _, _ in pairs]
    ms, library_ms, turns = in_turns(
        lambda: [kernels.bn_apply_sums(x, s, DP_WORLD, gm, bt, 1e-5, "tanh")
                 for x, s, gm, bt in pairs],
        lambda: [torch_f.batch_norm(x, m, v, gm, bt, training=False, eps=1e-5)
                 for (x, _, gm, bt), (m, v) in zip(pairs, moments)], torch)
    report.append(dict(
        name="bn_apply", tolerance="|d| <= 1e-5 + 1e-4|plain| on y; mean and "
        "var bitwise equal to the torch epilogue", max_abs_err=err,
        calls=[f"[{b},{f}] tanh, from the sums of {DP_WORLD} ranks"
               for b, f in pair_shapes], worlds_checked=list(worlds),
        bitwise_repeat=True, bitwise_scalar_path=True,
        gradient="checked in the dp phase (2 ranks)", ms=ms,
        mean_var_entry_ms=time_ms(lambda: [
            kernels.bn_apply(x, m, v, gm, bt, 1e-5, "tanh")
            for (x, _, gm, bt), (m, v) in zip(pairs, moments)], torch),
        plain_ms=time_ms(lambda: [bn_apply_sums_plain(x, s, DP_WORLD, gm, bt,
                                                      1e-5, "tanh")
                                  for x, s, gm, bt in pairs], torch),
        floor_ms=floor_ms(len(pairs), torch),
        library_ms=library_ms, turns_ms=turns,
        library_call="F.batch_norm(training=False) on the epilogue's mean/var, "
        "without the epilogue or the activation",
        bytes=sum(8 * b * f + 24 * f for b, f in pair_shapes),
        flops=sum(10 * b * f + 5 * f for b, f in pair_shapes)))

    # bn_act_4d: the benchmark shapes and the streamed shape
    kernels.fused_bn_act_train_4d.launches = 0
    err = 0.0
    for x, gm, bt in in_4d:
        outk = kernels.fused_bn_act_train_4d(x, gm, bt, 1e-5, "tanh")
        outp = bn_act_4d_plain(x, gm, bt, 1e-5, "tanh")
        for a, b, (atol, rtol) in zip(outk, outp, [(1e-5, 1e-4), (1e-6, 1e-4),
                                                   (1e-6, 1e-4)]):
            require(within(a, b, atol, rtol), "bn_act_4d disagrees with its "
                    f"plain version at {tuple(x.shape)}")
            err = max(err, max_err(a, b))
    x, gm, bt = (t.clone().requires_grad_(True) for t in in_4d[0])
    gy = randn(*x.shape)
    yk, _, _ = kernels.fused_bn_act_train_4d(x, gm, bt, 1e-5, "tanh")
    gk = torch.autograd.grad(yk, (x, gm, bt), gy)
    yp, _, _ = bn_act_4d_plain(x, gm, bt, 1e-5, "tanh")
    gp = torch.autograd.grad(yp, (x, gm, bt), gy)
    for a, b in zip(gk, gp):
        require(within(a, b, 1e-4, 1e-3), "bn_act_4d gradient disagrees")
    require(bitwise_repeat(lambda *a: kernels.fused_bn_act_train_4d(
        *a, 1e-5, "tanh"), in_4d, torch), "bn_act_4d: two launches differ")
    bn4d_launches = kernels.fused_bn_act_train_4d.launches
    streamed_in = in_4d.pop()
    n_4d = [math.prod(s) for s in shapes_4d]
    ms, library_ms, turns = in_turns(
        lambda: [kernels.fused_bn_act_train_4d(x, gm, bt, 1e-5, "tanh")
                 for x, gm, bt in in_4d],
        lambda: [torch_f.batch_norm(x, None, None, gm, bt, training=True,
                                    eps=1e-5) for x, gm, bt in in_4d], torch)
    streamed_ms, streamed_library_ms, _ = in_turns(
        lambda: kernels.fused_bn_act_train_4d(*streamed_in, 1e-5, "tanh"),
        lambda: torch_f.batch_norm(streamed_in[0], None, None, *streamed_in[1:],
                                   training=True, eps=1e-5), torch)
    report.append(dict(
        name="bn_act_4d", tolerance="|d| <= 1e-5 + 1e-4|plain| on y, "
        "1e-6 + 1e-4|plain| on mean/var", max_abs_err=err,
        calls=[f"[{b},{c},{h},{w}] tanh" for b, c, h, w in shapes_4d],
        checked_also="[{},{},{},{}] tanh (streamed branch)".format(*streamed_4d),
        bitwise_repeat=True, ms=ms,
        plain_ms=time_ms(lambda: [bn_act_4d_plain(x, gm, bt, 1e-5, "tanh")
                                  for x, gm, bt in in_4d], torch),
        library_ms=library_ms, turns_ms=turns,
        streamed_ms=streamed_ms, streamed_library_ms=streamed_library_ms,
        streamed_bound_ms=8 * math.prod(streamed_4d) / bw * 1e3,
        floor_ms=floor_ms(len(in_4d), torch),
        library_call="F.batch_norm(training=True), without the activation",
        bytes=sum(8 * n + 16 * s[1] for n, s in zip(n_4d, shapes_4d)),
        flops=sum(10 * n for n in n_4d)))

    # the insurance step's kernels at its shapes
    ins_kernels = insurance_kernels(torch, randn, dev, bw, sms)
    emit("kernel_insurance", nvidia_smi=smi, **ins_kernels)

    for r in report:
        t_bytes, t_ops = r["bytes"] / bw * 1e3, r["flops"] / PEAK_F32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        emit("kernel", **r)
    del graphs, dis, updates, bn_in, up_in, pair_in, pairs, moments, in_4d
    del streamed_in

    # -- 4. the main path ----------------------------------------------------
    # as cv_main runs it on one card: the step captured as a CUDA graph (at
    # construction), MAIN_STEPS steps in calls of MAIN_K replays; the
    # counters count each replay as the launches its capture recorded
    trainer = GANTrainer(cfg, batch_size=BATCH, n_train=N_TRAIN, device="cuda",
                         steps_per_call=MAIN_K)
    n_leaves = sum(len(lp) for g in (trainer.dis, trainer.gan, trainer.classifier)
                   for lp in g.opt_state.values())
    kernels.reset_launch_counts()
    result = trainer.train(MAIN_STEPS, log=None)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {"fused_update": 3 * MAIN_STEPS,
                "bn_act": 3 * MAIN_STEPS, "upsample_bwd": 2 * MAIN_STEPS,
                "bn_moments": 0, "bn_apply": 0, "bn_act_4d": 0}
    losses = [result[k] for k in ("d_loss", "g_loss", "clf_loss")]
    grid = trainer.sample_grid(10)
    emit("main", steps=result["steps"], batch=BATCH, n_train=N_TRAIN,
         losses=losses, step_ms_median=result["step_ms_median"],
         img_per_s=result["img_per_s"], graphed=result["graphed"],
         steps_per_call=result["steps_per_call"],
         launches_per_replay=trainer.graphed.launches, launches=launches,
         expected_launches=expected, rmsprop_leaves=n_leaves,
         grid_shape=list(grid.shape))
    require(result["graphed"] and result["steps_per_call"] == MAIN_K,
            f"main: graphed {result['graphed']}, K {result['steps_per_call']}")
    require(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    require(launches == expected,
            f"launch counts {launches} != expected {expected}")
    require(tuple(grid.shape) == (100, 1, 28, 28)
            and bool(torch.isfinite(grid).all()), "bad latent grid")
    del trainer, grid

    # -- 5. one step on the card against one on the CPU ----------------------
    rng = torch.Generator().manual_seed(7)
    feats, labels = synthetic_mnist(BATCH, seed=11)
    host = dict(
        real=torch.from_numpy(feats),
        labels=torch_f.one_hot(torch.from_numpy(labels), 10).float(),
        y_real=1.0 + 0.05 * torch.randn((BATCH, 1), generator=rng),
        y_fake=0.05 * torch.randn((BATCH, 1), generator=rng),
        ones=torch.ones((BATCH, 1)),
        z1=torch.rand((BATCH, cfg.z_size), generator=rng) * 2 - 1,
        z2=torch.rand((BATCH, cfg.z_size), generator=rng) * 2 - 1)
    # cuDNN and the CPU sum the convolutions in other orders (f32, TF32
    # off; a conv weight gradient sums up to 200*14*14 terms): STEP_TOL
    out_cpu = run_step(*protocol_step("cpu"), host, "cpu")
    out_gpu = run_step(*protocol_step(dev), host, dev)
    loss_err, worst = step_diff(out_cpu, out_gpu)
    emit("parity", losses_cpu=[float(v) for v in out_cpu[1]],
         losses_cuda=[float(v) for v in out_gpu[1]], loss_rel_err=loss_err,
         worst=worst, tolerance=STEP_TOL)
    require_step_match("parity", loss_err, worst)
    del out_cpu, out_gpu

    # -- 6. the graphed step against the eager step --------------------------
    graph = graph_phase(cfg, torch)
    emit("graph", batch=BATCH, **graph)
    for label, res in graph.items():
        require(res["losses_bitwise"]
                and res["digest_eager"] == res["digest_graphed"],
                f"graph ({label}): the graphed step's bits differ from the "
                f"eager step's (losses max |d| {res['loss_max_abs_diff']})")

    # -- 7. data parallel ----------------------------------------------------
    n_cards = torch.cuda.device_count()
    ins_host = insurance_host(torch, INS_DP_STEPS)
    ranks = mesh.spawn(dp_rank, DP_WORLD, (host, ins_host), device="cuda",
                       timeout=DP_TIMEOUT_S)
    r0 = ranks[0]
    dp_expected = {"fused_update": 3 * MAIN_STEPS,
                   "bn_act": 0, "upsample_bwd": 2 * MAIN_STEPS,
                   "bn_moments": 3 * MAIN_STEPS, "bn_apply": 3 * MAIN_STEPS,
                   "bn_act_4d": 0}
    dp_losses = [r0["result"][k] for k in ("d_loss", "g_loss", "clf_loss")]
    emit("dp", world=DP_WORLD, backend=r0["backend"],
         shared_card=n_cards < DP_WORLD,
         devices=[r["device"] for r in ranks], steps=r0["result"]["steps"],
         global_batch=BATCH, losses=dp_losses,
         step_ms_median=[r["result"]["step_ms_median"] for r in ranks],
         img_per_s=r0["result"]["img_per_s"],
         launches=[r["launches"] for r in ranks],
         expected_launches=dp_expected, rmsprop_leaves=r0["rmsprop_leaves"],
         digests=[r["digest"] for r in ranks],
         pair_max_abs_err=[r["pair_max_abs_err"] for r in ranks],
         grad_allreduce_ms=[r["grad_allreduce_ms"] for r in ranks],
         step_vs_single=[r["step_vs_single"] for r in ranks],
         tolerance=STEP_TOL)
    require(r0["backend"] == ("nccl" if n_cards >= DP_WORLD else "gloo"),
            f"dp: backend {r0['backend']} with {n_cards} cards")
    require(all(math.isfinite(v) for v in dp_losses),
            f"dp: non-finite losses {dp_losses}")
    for r in ranks:
        require(r["launches"] == dp_expected,
                f"dp rank {r['rank']}: launch counts {r['launches']} != "
                f"expected {dp_expected}")
        require_step_match(f"dp rank {r['rank']} 2-rank step vs single",
                           *r["step_vs_single"])
    require(len({r["digest"] for r in ranks}) == 1,
            "dp: the ranks' states differ after the run")
    pa_expected = {"fused_update": 3 * PA_STEPS, "bn_act": 3 * PA_STEPS,
                   "upsample_bwd": 2 * PA_STEPS, "bn_moments": 0,
                   "bn_apply": 0, "bn_act_4d": 0}
    pa_losses = [r0["pa_result"][k] for k in ("d_loss", "g_loss", "clf_loss")]
    emit("dp_param_averaging", world=DP_WORLD, backend=r0["backend"],
         steps=r0["pa_result"]["steps"], averaging_frequency=PA_FREQ,
         losses=pa_losses,
         step_ms_median=[r["pa_result"]["step_ms_median"] for r in ranks],
         launches=[r["pa_launches"] for r in ranks],
         expected_launches=pa_expected,
         digests=[r["pa_digest"] for r in ranks])
    require(r0["pa_result"]["steps"] == PA_STEPS
            and not r0["pa_result"]["fused"],
            f"dp param_averaging: {r0['pa_result']}")
    require(all(math.isfinite(v) for v in pa_losses),
            f"dp param_averaging: non-finite losses {pa_losses}")
    for r in ranks:
        require(r["pa_launches"] == pa_expected,
                f"dp param_averaging rank {r['rank']}: launch counts "
                f"{r['pa_launches']} != expected {pa_expected}")
    require(len({r["pa_digest"] for r in ranks}) == 1,
            "dp param_averaging: the ranks' states differ after the last "
            "average")
    ins_expected = {"fused_update": 3 * INS_DP_STEPS, "bn_act": 0,
                    "upsample_bwd": 0, "bn_moments": 4 * INS_DP_STEPS,
                    "bn_apply": 4 * INS_DP_STEPS, "bn_act_4d": 0}
    ins_dp = [r["insurance"] for r in ranks]
    emit("dp_insurance", world=DP_WORLD, backend=r0["backend"],
         steps=INS_DP_STEPS, global_batch=INS_BATCH,
         losses=ins_dp[0]["losses"], launches=[r["launches"] for r in ins_dp],
         expected_launches=ins_expected,
         vs_single=[r["vs_single"] for r in ins_dp],
         digests=[r["digest"] for r in ins_dp], tolerance=INS_STEP_TOL)
    for rank, r in enumerate(ins_dp):
        require(r["launches"] == ins_expected,
                f"dp insurance rank {rank}: launch counts {r['launches']} != "
                f"expected {ins_expected}")
        for i, (loss_err, worst) in enumerate(r["vs_single"]):
            require_step_match(f"dp insurance rank {rank} step {i + 1} vs "
                               "single", loss_err, worst, INS_STEP_TOL)
    require(len({r["digest"] for r in ins_dp}) == 1,
            "dp insurance: the ranks' states differ after the run")
    # a 1-rank NCCL group in this process, so the NCCL path runs on a
    # one-card machine too
    rdv = tempfile.mkdtemp(prefix="gan4j_nccl1_")
    try:
        group = mesh.data_group(0, 1, f"file://{rdv}/store", "cuda")
        try:
            require(group.backend == "nccl",
                    f"1-rank group on {group.backend}, not nccl")
            loss_err, worst = group_vs_single(group, host)
            sync_bn = sync_bn_profile(group, torch)
        finally:
            group.close()
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    emit("dp_nccl1", backend="nccl", loss_rel_err=loss_err, worst=worst,
         tolerance=STEP_TOL, sync_bn_forward=sync_bn)
    require_step_match("1-rank NCCL step vs single", loss_err, worst)
    kinds = sync_bn["new"]["kinds"]
    require(kinds["bn_moments"] == kinds["bn_apply"] == 3
            and kinds["other"] == 0 and sync_bn["new"]["per_forward"] <= 3,
            f"a sync-BN forward is not moments, collective, apply: {sync_bn}")

    # -- 8. the CV program end to end -----------------------------------------
    emit("cv_main", **cv_main_phase(torch, smi))

    # -- 9. the insurance program end to end ----------------------------------
    ins_ref = tempfile.mkdtemp(prefix="gan4j_ins_ref_")
    try:
        ins = insurance_phase(torch, smi, ins_ref)
        emit("insurance", **ins)

        # -- 10. checkpoints, preemption and resume ---------------------------
        emit("resume", **resume_phase(torch, smi, ins_ref, ins["test_auroc"]))
    finally:
        shutil.rmtree(ins_ref, ignore_errors=True)

    # -- 11. the roadmap families ---------------------------------------------
    rm = roadmap_phase(torch, smi, randn, bw, sms)
    emit("roadmap", **rm)

    # -- 12. the precision modes ---------------------------------------------
    prec = precision_phase(torch, smi, bw)
    emit("precision", **prec)

    # -- 13. the kernels line and the result ---------------------------------
    # launches: the main phase's, the dp phase's (rank 0) for the sync-BN
    # pair, and the kernel phase's check for the 4-D BN, which no model
    # path runs (as in the JAX package)
    counted = {**launches, "bn_moments": r0["launches"]["bn_moments"],
               "bn_apply": r0["launches"]["bn_apply"],
               "bn_act_4d": bn4d_launches}
    # the insurance path's own: the program's run for bn_act and
    # fused_update, the dp phase's insurance steps (rank 0) for the pair
    ins_counted = {"bn_act": ins["launches"]["bn_act"],
                   "fused_update": ins["launches"]["fused_update"],
                   "bn_moments": ins_dp[0]["launches"]["bn_moments"],
                   "bn_apply": ins_dp[0]["launches"]["bn_apply"]}
    ins_groups = ins_kernels["groups"]
    cgan_launches = rm["program"]["cgan-cifar10"]["result"]["port_launches"]
    print(json.dumps({"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": f"gan_deeplearning4j_tpu_torch/csrc/{SOURCES[r['name']]}",
         "replaces": f"gan_deeplearning4j_tpu/{REPLACES[r['name']]}",
         "launches": counted[r["name"]], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "floor_ms": r["floor_ms"],
         **{k: r[k] for k in ("enqueue_ms",) if k in r},
         **({"insurance": {
             "launches": ins_counted[r["name"]],
             **{k: ins_groups[r["name"]][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "floor_ms")}}}
            if r["name"] in ins_groups else {}),
         **({"roadmap": {
             family: {"launches": rm["main"][family]["launches"]["bn_act"],
                      "launches_per_iteration": rm["graph"][family]["plain"][
                          "launches_per_replay"]["bn_act"],
                      **{k: rm["kernels"][family][k] for k in (
                          "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "floor_ms")}}
             for family in RM_BN}} if r["name"] == "bn_act" else {}),
         # the conditional family's path runs none of the six (the
         # roadmap_children docstring says why): its child's counts
         "cgan-cifar10": {"launches": cgan_launches[r["name"]]},
         # each workload's eager run in each mode (PR_CALLS * PR_K steps)
         "precision": {w: {m: res["eager_launches"][r["name"]]
                           for m, res in modes.items()}
                       for w, modes in prec["graphed_vs_eager"].items()}}
        for r in report]}), flush=True)
    print(json.dumps({"seconds": {
        "total": time.perf_counter() - T_START,
        "precision": prec["seconds"],
        "total_before_the_precision_phase": TOTAL_BEFORE_PRECISION_S}}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
