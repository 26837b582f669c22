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
                at the shapes one DCGAN protocol step at batch 200 gives it,
                then the times of that step's launches: kernel, plain
                version, one PyTorch library call where there is one, and
                the card's bound for the same work.
  4. main     — the trainer (the cv_main entry) on cuda for 20 protocol
                steps at batch 200, full width, on synthetic MNIST; the
                launch counters are zeroed just before and read just after,
                and each kernel must have run its expected count per step.
                Then a 10x10 latent grid from the trained generator.
  5. parity   — one protocol step on cuda (kernels) and on the CPU (plain
                versions) from the same state, latents and targets.
  6. the ``kernels`` line, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is available.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

BATCH = 200
MAIN_STEPS = 20
N_TRAIN = 10000
REPS = 30
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz clock
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
    the Python wrappers' launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, enqueue = [], []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        enqueue.append(time.perf_counter() - t0)
        end.synchronize()
        times.append(start.elapsed_time(end))
    require(max(enqueue) < 0.01, f"the host took {max(enqueue) * 1e3:.1f} ms "
            "to enqueue a timed group; the sleep no longer covers it")
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def within(a, b, atol: float, rtol: float) -> bool:
    return bool(((a.double() - b.double()).abs()
                 <= atol + rtol * b.double().abs()).all())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import build
    from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import bn_act_plain
    from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import (
        rmsprop_chain_plain,
    )
    from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import (
        upsample_bwd_plain,
    )
    from gan_deeplearning4j_tpu_torch.runtime import backend
    from gan_deeplearning4j_tpu_torch.train import fused_step
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
         bandwidth_bytes_per_s=bw)
    require(not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on; the port runs in f32 parity mode")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    per_kernel = build.build()
    ptxas = {n: [ln.strip() for ln in (build.build_dir() / f"lib{n}.log")
                 .read_text().splitlines() if "registers" in ln]
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

    # fused_update: every RmsProp leaf of the three trained graphs, with
    # each leaf's own lr / l2 as the protocol step runs it
    cfg = M.CVConfig()
    dis = M.build_discriminator(cfg, dev)
    graphs = [dis, M.build_gan(cfg, dev), M.build_classifier(dis, cfg)]
    leaves = []
    for g in graphs:
        for layer, lp in g.params.items():
            up = g.updater.updater_for(layer)
            for pname, p in lp.items():
                leaves.append(dict(
                    p=randn(*p.shape, scale=0.05),
                    g=randn(*p.shape, scale=0.02),
                    c=randn(*p.shape, scale=1e-3).abs(),
                    kw=dict(lr=up.learning_rate, rho=up.rms_decay,
                            eps=up.epsilon,
                            l2=g.updater.l2 if pname == "W" else 0.0,
                            clip=g.updater.clip_threshold)))
    n_elems = sum(lf["p"].numel() for lf in leaves)
    err = 0.0
    for lf in leaves:
        pk, ck = kernels.fused_rmsprop_chain(lf["p"], lf["g"], lf["c"], **lf["kw"])
        pp, cp = rmsprop_chain_plain(lf["p"], lf["g"], lf["c"], **lf["kw"])
        require(within(pk, pp, 1e-6, 1e-5) and within(ck, cp, 1e-12, 1e-5),
                f"fused_update disagrees with its plain version on a leaf "
                f"{tuple(lf['p'].shape)}")
        err = max(err, max_err(pk, pp), max_err(ck, cp))
    report.append(dict(
        name="fused_update", tolerance="|d| <= 1e-6 + 1e-5|plain| on p', "
        "1e-12 + 1e-5|plain| on the cache", max_abs_err=err,
        calls=[f"{len(leaves)} leaves, {n_elems} elements"],
        ms=time_ms(lambda: [kernels.fused_rmsprop_chain(
            lf["p"], lf["g"], lf["c"], **lf["kw"]) for lf in leaves], torch),
        plain_ms=time_ms(lambda: [rmsprop_chain_plain(
            lf["p"], lf["g"], lf["c"], **lf["kw"]) for lf in leaves], torch),
        library_ms=None, bytes=20 * n_elems, flops=12 * n_elems))

    # bn_act: the three 2-D train-mode BNs of a step (all tanh)
    bn_shapes = [(BATCH, 2), (BATCH, 7 * 7 * 128), (BATCH, 1024)]
    bn_in = [(randn(b, f, scale=0.5), randn(f, scale=0.1, shift=1.0),
              randn(f, scale=0.1)) for b, f in bn_shapes]
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
    torch_f = torch.nn.functional
    report.append(dict(
        name="bn_act", tolerance="|d| <= 1e-5 + 1e-4|plain| on y, "
        "1e-6 + 1e-4|plain| on mean/var", max_abs_err=err,
        calls=[f"[{b},{f}] tanh" for b, f in bn_shapes],
        ms=time_ms(lambda: [kernels.fused_bn_act_train(x, gm, bt, 1e-5, "tanh")
                            for x, gm, bt in bn_in], torch),
        plain_ms=time_ms(lambda: [bn_act_plain(x, gm, bt, 1e-5, "tanh")
                                  for x, gm, bt in bn_in], torch),
        library_ms=time_ms(lambda: [torch_f.batch_norm(
            x, None, None, gm, bt, training=True, eps=1e-5)
            for x, gm, bt in bn_in], torch),
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
        library_ms=time_ms(lambda: [library_block_sum(g) for g in up_in], torch),
        library_call="g.view(B,C,H,2,W,2).sum((3,5))",
        bytes=sum(4 * math.prod(s) * 5 // 4 for s in up_shapes),
        flops=sum(math.prod(s) for s in up_shapes)))

    for r in report:
        t_bytes, t_ops = r["bytes"] / bw * 1e3, r["flops"] / PEAK_F32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        emit("kernel", **r)
    del graphs, dis, leaves, bn_in, up_in

    # -- 4. the main path ----------------------------------------------------
    trainer = GANTrainer(cfg, batch_size=BATCH, n_train=N_TRAIN, device="cuda")
    n_leaves = sum(len(lp) for g in (trainer.dis, trainer.gan, trainer.classifier)
                   for lp in g.opt_state.values())
    kernels.reset_launch_counts()
    result = trainer.train(MAIN_STEPS, log=None)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {"fused_update": n_leaves * MAIN_STEPS,
                "bn_act": 3 * MAIN_STEPS, "upsample_bwd": 2 * MAIN_STEPS}
    losses = [result[k] for k in ("d_loss", "g_loss", "clf_loss")]
    grid = trainer.sample_grid(10)
    emit("main", steps=result["steps"], batch=BATCH, n_train=N_TRAIN,
         losses=losses, step_ms_median=result["step_ms_median"],
         img_per_s=result["img_per_s"], launches=launches,
         expected_launches=expected, rmsprop_leaves=n_leaves,
         grid_shape=list(grid.shape))
    require(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    require(launches == expected,
            f"launch counts {launches} != expected {expected}")
    require(tuple(grid.shape) == (100, 1, 28, 28)
            and bool(torch.isfinite(grid).all()), "bad latent grid")

    # -- 5. one step on the card against one on the CPU ----------------------
    def build_state(device):
        d = M.build_discriminator(cfg, device)
        graphs = (d, M.build_generator(cfg, device), M.build_gan(cfg, device),
                  M.build_classifier(d, cfg))
        step = fused_step.make_protocol_step(
            *graphs, M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER,
            z_size=cfg.z_size, num_features=cfg.num_features)
        return step, fused_step.state_from_graphs(*graphs)

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
    outs = {}
    for device in ("cpu", "cuda"):
        step, state = build_state(device)
        a = {k: v.to(device) for k, v in host.items()}
        outs[device] = step(state, a["real"], a["labels"], a["y_real"],
                            a["y_fake"], a["ones"], z1=a["z1"], z2=a["z2"])
    (s_cpu, l_cpu), (s_gpu, l_gpu) = outs["cpu"], outs["cuda"]
    loss_err = max(abs(float(a) - float(b)) / max(abs(float(a)), 1e-6)
                   for a, b in zip(l_cpu, l_gpu))
    # tolerances: cuDNN and the CPU sum the convolutions in other orders
    # (f32, TF32 off; a conv weight gradient sums up to 200*14*14 terms).
    # Losses: 1e-4 relative.  Params and BN statistics: 4e-3 absolute, one
    # generator learning rate — RmsProp's update is ~lr*sign(g), and an
    # element whose gradient lies near 0 sits on its linear part (slope
    # lr/sqrt(eps) = 40), so rounding may move it by up to one lr; a wiring
    # error moves whole leaves by lr and shifts the losses.  RmsProp caches
    # (~g^2): 5e-2 of the leaf's largest value plus eps (a cache enters the
    # update only as cache + eps); a frozen input BN's running-stat
    # gradient sums 200*784 terms that cancel.
    tol = {"param": 4e-3, "cache": 5e-2}
    worst = {k: (0.0, "") for k in tol}
    for field in s_cpu._fields[:-1]:
        kind = "cache" if field.endswith("_opt") else "param"
        for layer, lp in getattr(s_cpu, field).items():
            for pname, a in lp.items():
                d = max_err(a, getattr(s_gpu, field)[layer][pname].cpu())
                if kind == "cache":
                    d /= float(a.abs().max()) + 1e-8
                if d >= worst[kind][0]:
                    worst[kind] = (d, f"{field}.{layer}.{pname}")
    emit("parity", losses_cpu=[float(v) for v in l_cpu],
         losses_cuda=[float(v) for v in l_gpu], loss_rel_err=loss_err,
         worst=worst, tolerance=tol, loss_tolerance=1e-4)
    require(loss_err <= 1e-4, f"parity: loss relative error {loss_err} > 1e-4")
    for kind, (d, where) in worst.items():
        require(d <= tol[kind], f"parity: {where} differs by {d} > {tol[kind]}")

    # -- 6. the kernels line and the result ----------------------------------
    sources = {"fused_update": "ops/pallas/fused_update.py:40",
               "bn_act": "ops/pallas/bn_act.py:56",
               "upsample_bwd": "ops/pallas/dma_pipeline.py:86"}
    print(json.dumps({"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": f"gan_deeplearning4j_tpu_torch/csrc/{r['name']}.cu",
         "replaces": f"gan_deeplearning4j_tpu/{sources[r['name']]}",
         "launches": launches[r["name"]], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for r in report]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
