"""DCGAN-on-MNIST trainer CLI (torch twin of ``gan_deeplearning4j_tpu/
train/cv_main.py``, the training loop only).

Run: ``python -m gan_deeplearning4j_tpu_torch.train.cv_main --iterations 20``
(on the GPU; ``--device cpu`` runs the plain torch versions on the CPU).
``--n-devices N`` trains data-parallel in N processes, rank r on card r
over NCCL (gloo ranks with ``--device cpu``); the default is every
attached card, reduced to the largest divisor of the batch.  On one card
the fused step runs as a replayed CUDA graph, ``--steps-per-call`` steps
per call; ``--dp-mode param_averaging`` runs the unfused per-fit loop.
Prints rank 0's per-step losses, then one JSON line with the final
losses, the median step time (a call's time over its steps), img/s
(global batch rows per second, the MNIST protocol's count), the steps per
call, whether the step ran graphed, and the world size.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
from gan_deeplearning4j_tpu_torch.runtime import prng
from gan_deeplearning4j_tpu_torch.train.gan_trainer import train_data_parallel


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=200)
    p.add_argument("--seed", type=int, default=prng.NUMBER_OF_THE_BEAST,
                   help="model-init + training-stream seed (the dataset "
                        "keeps its own fixed seed)")
    p.add_argument("--n-train", type=int, default=60000)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "torch versions of the kernels)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks, one process each (default: "
                        "every attached card, reduced to the largest "
                        "divisor of the batch; 1 on the CPU)")
    p.add_argument("--dp-mode", default="gradient_sync",
                   choices=["gradient_sync", "param_averaging"],
                   help="gradient_sync: the fused step with sync-BN; "
                        "param_averaging: the unfused per-fit loop, params "
                        "and updater state averaged over the ranks")
    p.add_argument("--averaging-frequency", type=int, default=10)
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="cap on protocol steps per call of the fused step "
                        "(None = auto: the largest divisor of the run up "
                        "to 100)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="generator weight EMA decay (e.g. 0.999); fused "
                        "step only")
    args = p.parse_args(argv)
    result = train_data_parallel(
        M.CVConfig(seed=args.seed), batch_size=args.batch_size,
        n_train=args.n_train, iterations=args.iterations, device=args.device,
        n_devices=args.n_devices, steps_per_call=args.steps_per_call,
        ema_decay=args.ema_decay, dp_mode=args.dp_mode,
        averaging_frequency=args.averaging_frequency)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
