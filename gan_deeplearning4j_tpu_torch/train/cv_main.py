"""DCGAN-on-MNIST trainer CLI (torch twin of ``gan_deeplearning4j_tpu/
train/cv_main.py``, the training loop only).

Run: ``python -m gan_deeplearning4j_tpu_torch.train.cv_main --iterations 20``
(on the GPU; ``--device cpu`` runs the plain torch versions on the CPU).
Prints each step's losses, then one JSON line with the final losses, the
median step time and img/s (batch rows per second, the MNIST protocol's
count).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
from gan_deeplearning4j_tpu_torch.runtime import prng
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer


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
    args = p.parse_args(argv)
    trainer = GANTrainer(M.CVConfig(seed=args.seed),
                         batch_size=args.batch_size, n_train=args.n_train,
                         device=args.device)
    result = trainer.train(args.iterations)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
