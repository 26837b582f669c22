"""The scenario's preemptible trainer unit: one fleet incarnation (torch
twin of ``gan_deeplearning4j_tpu/scenario/trainer_child.py``).

``python -m gan_deeplearning4j_tpu_torch.scenario.trainer_child`` runs ONE
incarnation of the fleet trainer (train/fleet.py), on the card unless
``--device cpu``, and maps each outcome to the exit-code protocol a
supervisor acts on:

* **0** — ran to ``--iterations``; ``final.json`` in ``--res-path``
  carries the terminal trajectory (step, tenants, quarantined rows, mean
  d/g loss over the tenants at the last step), also the last line of its
  stdout, after a line with the incarnation's port-kernel launches
  (``launches``: the wrappers' counters, a graph replay counted as the
  launches its capture recorded; the other outcomes' lines carry them
  too).
* **75** (``EXIT_PREEMPTED``) — the SIGTERM guard (train/preemption.py)
  latched and the loop drained at the next step boundary: emergency fleet
  checkpoint, ``PREEMPTED.json`` marker, clean exit.  Respawn with
  ``--resume``.
* **82** (``EXIT_DEVICE_LOST``) — the ``--device-lost-signal`` (default
  SIGUSR1) handler latched and the next step boundary raised
  ``testing.chaos.DeviceLostError``, deliberately WITHOUT an emergency
  save: lost hardware does not flush, so the respawn restores the older
  cadence checkpoint.

``READY.json`` (``{"pid": ...}``) is written once the signal handlers are
armed: a supervisor must not send SIGUSR1 before it exists (the default
action would kill the process outright).

Data is read tolerantly: rows rewritten as ``#CORRUPT#,...`` parse to NaN
rows of the right width and flow into the TenantRouter, whose per-tenant
quarantine decides what a bad row costs.  ``--step-delay-s`` paces the
loop so checkpoint cadence and signal timing interact as at production
step times.
"""

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional

import numpy as np

# a distinct code from train/preemption's 75: "hardware gone" (resume from
# an older cadence save), not "requeue me"
EXIT_DEVICE_LOST = 82

FINAL_NAME = "final.json"


def read_csv_tolerant(path: str, width: int) -> np.ndarray:
    """Parse ``path`` into ``(rows, width)`` float32, mapping every
    unparsable or wrong-width line to a NaN row instead of failing the
    load (the JAX child's parser, row for row)."""
    rows: List[List[float]] = []
    nan_row = [float("nan")] * width
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                vals = [float(p) for p in line.split(",")]
            except ValueError:
                vals = nan_row
            rows.append(vals if len(vals) == width else nan_row)
    if not rows:
        raise ValueError(f"{path}: no data rows")
    return np.asarray(rows, np.float32)


def _atomic_json(path: str, doc) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--res-path", required=True)
    p.add_argument("--data", required=True,
                   help="CSV of num_features feature columns + 1 label")
    p.add_argument("--tenants", type=int, default=4)
    p.add_argument("--iterations", type=int, required=True)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--checkpoint-every", type=int, default=8)
    p.add_argument("--keep-checkpoints", type=int, default=64)
    p.add_argument("--n-devices", type=int, default=None,
                   help="tenant-mesh size: the tenant axis split over this "
                        "many shards, sharing the card(s) when there are "
                        "fewer; a resume at another size reshards the "
                        "checkpoint (parallel/fleet.py)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--print-every", type=int, default=0)
    p.add_argument("--step-delay-s", type=float, default=0.0)
    p.add_argument("--preempt-signals", default="SIGTERM",
                   help='guard signals ("" disables; exit 75 protocol)')
    p.add_argument("--device-lost-signal", default="SIGUSR1",
                   help='simulated hardware loss ("" disables; exit '
                        f"{EXIT_DEVICE_LOST})")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain eager fleet step on the CPU)")
    args = p.parse_args(argv)

    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as M
    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.testing.chaos import DeviceLostError
    from gan_deeplearning4j_tpu_torch.train import fleet as fleet_lib
    from gan_deeplearning4j_tpu_torch.train.preemption import (
        EXIT_PREEMPTED,
        PreemptionError,
    )

    width = M.InsuranceConfig().num_features + 1
    data = read_csv_tolerant(args.data, width)
    feats, labels = data[:, :-1], data[:, -1]

    cfg = fleet_lib.FleetConfig(
        num_tenants=args.tenants,
        num_iterations=args.iterations,
        batch_size=args.batch_size,
        seed=args.seed,
        res_path=args.res_path,
        per_tenant_data=True,
        print_every=args.print_every,
        checkpoint_every=args.checkpoint_every,
        keep_checkpoints=args.keep_checkpoints,
        n_devices=args.n_devices,
        events=True,
        resume=args.resume,
        preempt_signals=args.preempt_signals or None,
        device=args.device,
    )
    trainer = fleet_lib.FleetTrainer(cfg)

    # the device-lost signal only LATCHES here; the raise happens at the
    # next step boundary through fleet._chaos_step_hook, where a real loss
    # would be observed
    lost = {"armed": False}
    if args.device_lost_signal:
        signum = getattr(signal, args.device_lost_signal)
        signal.signal(signum, lambda s, f: lost.update(armed=True))
    delay = max(0.0, float(args.step_delay_s))
    _atomic_json(os.path.join(args.res_path, "READY.json"),
                 {"pid": os.getpid()})

    def _hook(step: int) -> None:
        if lost["armed"]:
            raise DeviceLostError(
                f"injected device loss at step {step} "
                f"({args.device_lost_signal})")
        if delay:
            time.sleep(delay)

    fleet_lib._chaos_step_hook = _hook
    try:
        out = trainer.train(feats, labels)
    except PreemptionError as e:
        # PREEMPTED.json and the emergency checkpoint are on disk
        print(json.dumps({"preempted": True, "step": e.step,
                          "checkpoint": e.checkpoint,
                          "launches": kernels.launch_counts()}), flush=True)
        return EXIT_PREEMPTED
    except DeviceLostError as e:
        # no emergency save, on purpose: lost hardware does not flush
        print(json.dumps({"device_lost": True,
                          "step": trainer.batch_counter,
                          "reason": str(e),
                          "launches": kernels.launch_counts()}), flush=True)
        return EXIT_DEVICE_LOST
    finally:
        fleet_lib._chaos_step_hook = None

    losses = trainer.last_losses
    final = {
        "step": int(out["steps"]),
        "tenants": int(out["tenants"]),
        "quarantined": int(out["quarantined"]),
        "d_loss": (None if losses is None
                   else float(np.mean(np.asarray(losses[0])))),
        "g_loss": (None if losses is None
                   else float(np.mean(np.asarray(losses[1])))),
    }
    _atomic_json(os.path.join(args.res_path, FINAL_NAME), final)
    print(json.dumps({"launches": kernels.launch_counts()}), flush=True)
    print(json.dumps(final), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
