#!/usr/bin/env python3
"""The fleet's tenant-batched BN and the fleet step, one checkout against
another on the same card, in turns.

    python3 chip_fleet_ab.py BASE_DIR [--out chiprun_out/fleet_ab.json]

BASE_DIR holds another checkout of this repository (for example the parent
commit, unpacked with ``git archive``).  Each turn is a child process that
imports ``gan_deeplearning4j_tpu_torch`` from one checkout only, builds its
kernels from that checkout's sources and measures, on one NVIDIA card:

  - ``forward``: the fleet step's four train-mode BNs (FLEET_BN) through
    ``fused_bn_act_train_tenants`` at each N of FLEET_SWEEP, device ms of
    the four calls (the stream parked on a sleep kernel first, so the
    events time the device's work and not the wrappers' launch rate);
  - ``backward``: ``torch.autograd.grad`` of those four calls' (y, mean,
    var) with cotangents on all three, as the fleet step's backward runs
    them, device ms; and, where the checkout has it, the four bare launches
    of ``bn_act_tenants_bwd``;
  - ``floor``: four empty launches, timed the same way;
  - ``per_shape``: each BN alone at N = 256, 1,024 and 4,096, forward and
    (where present) backward, and under each row split the plan allows;
  - ``sweep``: the graphed fleet step (``train/fleet.py``, insurance at full
    width, batch 16, a 64-row table a tenant) at each N of FLEET_SWEEP,
    device ms a step (median of 3 calls of 10 replays) and the port's
    launches a step;
  - ``split``: ``torch.profiler`` over one graphed call of 10 replays at
    N = 1,024 and 4,096, device ms a step grouped as the tenant BN's
    forward kernel, its backward kernel, the cuBLAS products (``bmm``),
    ``fused_update`` and the rest; and over one eager step, the device ms
    of the kernels launched under the tenant BN's autograd backward node
    (the kernel, or the recompute's ops).

Turns run base, this checkout, this checkout, base; each number in the
summary is the mean of a checkout's two turns.  Every line names the card
and its power limit (``nvidia-smi``).  Needs one card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

FLEET_B = 16
FLEET_ROWS = 64
FLEET_SWEEP = (1, 64, 256, 1024, 4096)
SPLIT_AT = (1024, 4096)
SHAPE_AT = (256, 1024, 4096)
FLEET_BN = [((32, 12), "elu"), ((16, 2), "tanh"), ((16, 12), "elu"),
            ((16, 100), "elu")]
CALLS, K = 3, 10
REPS = 30
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz clock
SEED = 20261019
HERE = os.path.dirname(os.path.abspath(__file__))


def time_ms(fn, torch) -> float:
    """Device ms of one call of ``fn``, median over REPS after three
    warm-ups; each repetition parks the stream on a sleep kernel first, so
    the events time the device's work back to back (chip_smoke.py
    time_ms)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, tries = [], 0
    while len(times) < REPS:
        tries += 1
        if tries > 3 * REPS:
            raise RuntimeError("chip_fleet_ab: the host takes over 10 ms to "
                               "enqueue the timed group; the sleep no longer "
                               "covers it")
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
    return statistics.median(times)


def _group(name: str) -> str:
    low = name.lower()
    if "FwdPair" in name or "bn_act_tenants_kernel" in name:
        return "bn_forward"
    if "BwdPair" in name:
        return "bn_backward_kernel"
    if "rmsprop_multi_kernel" in name:
        return "fused_update"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "bmm")):
        return "bmm"
    return "rest"


def _device_ms(evt) -> float:
    us = getattr(evt, "device_time_total", None)
    if us is None:
        us = evt.cuda_time_total
    return us / 1e3


def per_shape(torch, kernels, bn2d, randn, has_bwd) -> dict:
    """Each of the four BNs alone at each N of SHAPE_AT: the forward's
    device ms; where the checkout has the backward kernel, its ms too, and
    both under each row split the kernels take (``tenant_split`` replaced:
    1, 2, 4; 1 only from 32 columns), the plan's own choice marked."""
    splits = hasattr(bn2d, "tenant_split")
    choose = bn2d.tenant_split if splits else None
    rows = {}
    for n in SHAPE_AT:
        for (b, f), act in FLEET_BN:
            x = randn(n, b, f, scale=0.5, shift=0.2)
            gm, bt = randn(n, f, scale=0.1, shift=1.0), randn(n, f, scale=0.1)
            _, mean, var = kernels.fused_bn_act_train_tenants(x, gm, bt, 1e-5,
                                                              act)
            cots = (randn(n, b, f), randn(n, f), randn(n, f))
            row = {"forward_ms": time_ms(
                lambda: kernels.fused_bn_act_train_tenants(x, gm, bt, 1e-5,
                                                           act), torch)}
            if has_bwd:
                row["backward_ms"] = time_ms(lambda: bn2d.bn_act_tenants_bwd(
                    x, gm, bt, mean, var, *cots, 1e-5, act), torch)
            if splits:
                row["plan_split"] = choose(n, b, f)
                for r in (1, 2, 4):
                    if r > 1 and (f >= 32 or b // r < 4):
                        continue
                    bn2d.tenant_split = lambda *_, r=r: r
                    try:
                        row[f"split{r}"] = {
                            "forward_ms": time_ms(
                                lambda: kernels.fused_bn_act_train_tenants(
                                    x, gm, bt, 1e-5, act), torch),
                            "backward_ms": time_ms(
                                lambda: bn2d.bn_act_tenants_bwd(
                                    x, gm, bt, mean, var, *cots, 1e-5, act),
                                torch)}
                    finally:
                        bn2d.tenant_split = choose
            rows[f"{n}:{b}x{f}"] = row
    return rows


def child(root: str, label: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
    from gan_deeplearning4j_tpu_torch.ops.cuda import build
    from gan_deeplearning4j_tpu_torch.runtime import prng
    from gan_deeplearning4j_tpu_torch.train import fleet as FL
    from gan_deeplearning4j_tpu_torch.train import fused_step as FT

    assert os.path.dirname(os.path.dirname(kernels.__file__)).startswith(
        os.path.abspath(root)), kernels.__file__
    t0 = time.perf_counter()
    build.build()
    out = {"label": label, "root": root, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    has_bwd = hasattr(bn2d, "bn_act_tenants_bwd")
    fwd, bwd, bare, floor = {}, {}, {}, {}
    for n in FLEET_SWEEP:
        ins = [((randn(n, b, f, scale=0.5, shift=0.2),
                 randn(n, f, scale=0.1, shift=1.0), randn(n, f, scale=0.1)),
                act) for (b, f), act in FLEET_BN]
        fwd[n] = time_ms(lambda: [kernels.fused_bn_act_train_tenants(
            *t, 1e-5, act) for t, act in ins], torch)
        leaves = [[u.clone().requires_grad_(True) for u in t] for t, _ in ins]
        outs = [kernels.fused_bn_act_train_tenants(*lv, 1e-5, act)
                for lv, (_, act) in zip(leaves, ins)]
        cots = [(randn(*o[0].shape), randn(*o[1].shape), randn(*o[2].shape))
                for o in outs]
        bwd[n] = time_ms(lambda: [torch.autograd.grad(
            o, lv, c, retain_graph=True)
            for o, lv, c in zip(outs, leaves, cots)], torch)
        if has_bwd:
            bare[n] = time_ms(lambda: [bn2d.bn_act_tenants_bwd(
                t[0], t[1], t[2], o[1].detach(), o[2].detach(), *c, 1e-5,
                act) for (t, act), o, c in zip(ins, outs, cots)], torch)
        floor[n] = time_ms(lambda: [torch.cuda._sleep(0) for _ in FLEET_BN],
                           torch)
        del ins, leaves, outs, cots
    out.update(forward_ms=fwd, backward_autograd_ms=bwd,
               backward_kernel_ms=bare or None, floor_ms=floor)
    out["per_shape"] = per_shape(torch, kernels, bn2d, randn, has_bwd)

    # the graphed fleet step
    cfg = MI.InsuranceConfig()
    dis = MI.build_discriminator(cfg, "cuda")
    graphs = (dis, MI.build_generator(cfg, "cuda"), MI.build_gan(cfg, "cuda"),
              MI.build_classifier(dis, cfg))
    maps = (MI.DIS_TO_GAN, MI.GAN_TO_GEN, MI.DIS_TO_CLASSIFIER)
    rng = np.random.RandomState(SEED)
    ones = np.ones((FLEET_B, 1), np.float32)
    targets = [torch.from_numpy(a).cuda() for a in (
        ones + (0.05 * rng.randn(FLEET_B, 1)).astype(np.float32),
        (0.05 * rng.randn(FLEET_B, 1)).astype(np.float32), ones)]
    data_gen = torch.Generator(device="cuda")
    data_gen.manual_seed(SEED)
    sweep, split = {}, {}
    from torch.profiler import ProfilerActivity, profile

    for n in FLEET_SWEEP:
        feats = torch.rand((n, FLEET_ROWS, 12), generator=data_gen,
                           device="cuda")
        labs = (torch.rand((n, FLEET_ROWS, 1), generator=data_gen,
                           device="cuda") < 0.5).float()
        step = FL.make_fleet_step(*graphs, *maps, z_size=2, num_features=12,
                                  per_tenant_data=True)
        state = FL.replicate_state(FT.state_from_graphs(*graphs), n)
        g = FL.graphed_fleet_step(
            step, FT.clone_state(state), feats, labs, *targets,
            z_gen=prng.generator(SEED, f"fleet-z-{n}", "cuda"))
        g(1)
        times = []
        kernels.reset_launch_counts()
        for _ in range(CALLS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.launch(K)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / K)
        counts = {k: v / (CALLS * K) for k, v in
                  kernels.launch_counts().items() if v}
        sweep[n] = {"step_ms": statistics.median(times), "calls_ms": times,
                    "launches_per_step": counts}
        if n in SPLIT_AT:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                g.launch(K)
                torch.cuda.synchronize()
            groups = {}
            for e in prof.key_averages():
                ms = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)) / 1e3
                if ms > 0:
                    k = _group(e.key)
                    groups[k] = groups.get(k, 0.0) + ms / K
            # one eager step: the kernels under the tenant BN's backward
            eager_state = FT.clone_state(state)
            z1 = torch.rand((n, FLEET_B, 2), device="cuda") * 2 - 1
            z2 = torch.rand((n, FLEET_B, 2), device="cuda") * 2 - 1
            step(FT.clone_state(state), feats, labs, *targets, z1=z1, z2=z2)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof2:
                step(eager_state, feats, labs, *targets, z1=z1, z2=z2)
                torch.cuda.synchronize()
            nodes = [e for e in prof2.events()
                     if "_BnActTenantsBackward" in e.name
                     and "evaluate_function" in e.name]
            total = sum(getattr(k, "duration", 0.0) for e in prof2.events()
                        for k in getattr(e, "kernels", []))
            split[n] = {"graphed_ms_per_step": groups,
                        "graphed_total_ms": sum(groups.values()),
                        "eager_bn_backward_ms": sum(_device_ms(e)
                                                    for e in nodes),
                        "eager_bn_backward_nodes": len(nodes),
                        "eager_kernels_ms": total / 1e3}
        del g, step, state, feats, labs
        torch.cuda.empty_cache()
    out.update(sweep=sweep, split=split)
    return out


def _mean(a, b):
    if isinstance(a, dict):
        return {k: _mean(a[k], b[k]) for k in a if k in b}
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return (a + b) / 2
    return None


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("base", nargs="?")
    p.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                 "fleet_ab.json"))
    p.add_argument("--child", default=None)
    p.add_argument("--label", default="")
    args = p.parse_args()
    if args.child:
        print("AB " + json.dumps(child(args.child, args.label)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.base:
        print("chip_fleet_ab: needs a card and a base checkout",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for label, root in (("base", args.base), ("change", HERE),
                        ("change", HERE), ("base", args.base)):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(root), "--label", label],
            cwd=os.path.abspath(root), env=env, capture_output=True,
            text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            return 1
        turns.append(json.loads(line[-1][3:]))
        print(json.dumps({"turn": len(turns), "label": label,
                          "forward_ms": turns[-1]["forward_ms"],
                          "backward_autograd_ms":
                              turns[-1]["backward_autograd_ms"],
                          "step_ms": {n: r["step_ms"] for n, r in
                                      turns[-1]["sweep"].items()}}),
              flush=True)
    summary = {"nvidia_smi": smi,
               "base": _mean(turns[0], turns[3]),
               "change": _mean(turns[1], turns[2])}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "turns": turns}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
