"""DCGAN-on-MNIST trainer CLI (torch twin of ``gan_deeplearning4j_tpu/
train/cv_main.py``, the training loop only).

Run: ``python -m gan_deeplearning4j_tpu_torch.train.cv_main --iterations 20``
(on the GPU; ``--device cpu`` runs the plain torch versions on the CPU).
``--n-devices N`` trains data-parallel in N processes, rank r on card r
over NCCL (gloo ranks with ``--device cpu``); the default is every
attached card, reduced to the largest divisor of the batch.  Prints rank
0's per-step losses, then one JSON line with the final losses, the median
step time, img/s (global batch rows per second, the MNIST protocol's
count) and the world size.
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
    args = p.parse_args(argv)
    result = train_data_parallel(
        M.CVConfig(seed=args.seed), batch_size=args.batch_size,
        n_train=args.n_train, iterations=args.iterations, device=args.device,
        n_devices=args.n_devices)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
