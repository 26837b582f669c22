"""The insurance program, an MLP-GAN on 4x3 transaction lattices (torch twin
of ``gan_deeplearning4j_tpu/train/insurance_main.py``; the reference's
``dl4jGANInsurance``).

Run: ``python -m gan_deeplearning4j_tpu_torch.train.insurance_main
--res-path outputs/insurance_torch`` (on the GPU; ``--device cpu`` runs the
plain torch versions of the kernels on the CPU).  The program:
  1. writes ``insurance_{train,test}.csv`` into ``--res-path`` unless both
     are there (700 + 300 policies of synthetic transaction lattices, 12
     features scaled by the train split, the risk label as column 12);
  2. decodes them through the DataVec-style iterator (the label as one
     column: the classifier's sigmoid target);
  3. trains ``--iterations`` steps of the three-graph protocol at
     ``--batch-size`` (on one card the step is a replayed CUDA graph, K
     steps a call: the largest divisor of the run and of both cadences up
     to ``--steps-per-call`` or 100);
  4. every ``--print-every`` steps writes ``insurance_out_<k>.csv`` (the
     generator over the 50x50 latent grid, 2500 lattices) and
     ``insurance_out_pred_<k>.csv`` (the classifier over those lattices),
     every ``--save-every`` ``insurance_test_predictions_<k>.csv`` (the
     classifier over the 300 test policies), on a background writer unless
     ``--sync-dumps``;
  5. writes ``insurance_metrics.jsonl`` and the four model zips
     ``insurance_{dis,gan,gen,insurance}_model.zip``;
  6. scores the last prediction dump: the weighted AUROC (``test_auroc``)
     and the risk class's F1 (``evaluation_stats.txt``);
and prints rank 0's per-step losses, then one JSON line (``steps``,
``examples_per_sec``, ``d_loss``, ``g_loss``, ``test_auroc``,
``test_f1``, ``host_seconds``, ...).  ``--n-devices N`` trains
data-parallel in N processes (rank r on card r over NCCL; gloo ranks with
``--device cpu``); ``--dp-mode param_averaging`` runs the unfused per-fit
loop.  Supervision, as in the JAX program: ``--checkpoint-every N``
(checkpoints in the JAX format under ``res-path/checkpoints``),
``--resume``, ``--max-restarts`` (with ``--n-devices``, one failed rank
restarts the whole world from the newest checkpoint),
``--async-checkpoint``,
``--preempt-signal SIG`` (an emergency checkpoint, ``PREEMPTED.json`` and
exit code 75), ``--data-retries`` and ``--max-quarantine``.  The JAX
program's lattice PNGs and telemetry are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Tuple

from gan_deeplearning4j_tpu_torch.data import datasets
from gan_deeplearning4j_tpu_torch.data.csv import read_csv_matrix
from gan_deeplearning4j_tpu_torch.eval import metrics as metrics_lib
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as M
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
    GANTrainer,
    GANTrainerConfig,
    Workload,
    add_recovery_args,
    check_recovery_args,
    recovery_config_kwargs,
    resolve_n_devices,
    run_with_recovery,
    spawn_with_recovery,
)
from gan_deeplearning4j_tpu_torch.train.preemption import (
    EXIT_PREEMPTED,
    PreemptionError,
    parse_signals,
)


class InsuranceWorkload(Workload):
    name = "insurance"
    classifier_model_name = "insurance"

    def __init__(self, cfg: M.InsuranceConfig = M.InsuranceConfig()):
        self.cfg = cfg
        self.dis_to_gan = M.DIS_TO_GAN
        self.gan_to_gen = M.gan_to_gen_map(cfg)
        self.dis_to_classifier = M.DIS_TO_CLASSIFIER

    def build_graphs(self, device) -> Dict[str, object]:
        dis = M.build_discriminator(self.cfg, device)
        return {"dis": dis, "gen": M.build_generator(self.cfg, device),
                "gan": M.build_gan(self.cfg, device),
                "classifier": M.build_classifier(dis, self.cfg)}

    def ensure_data(self, res_path: str):
        return datasets.ensure_insurance_csv(res_path)

    def grid_extra_arrays(self, trainer: GANTrainer, grid_out, step: int):
        """The classifier's risk scores over the generated lattices
        (dl4jGANInsurance.java:422-437)."""
        preds = trainer.classifier.output(grid_out)[0]
        return [(os.path.join(trainer.c.res_path,
                              f"insurance_out_pred_{step}.csv"), preds)]


def default_config(**overrides) -> GANTrainerConfig:
    base = dict(dataset_name="insurance", num_features=12, label_index=12,
                num_classes=1,  # the sigmoid target (dl4jGANInsurance.java:61)
                batch_size=50, batch_size_pred=700, num_iterations=5000,
                num_gen_samples=50, averaging_frequency=5)
    base.update(overrides)
    return GANTrainerConfig(**base)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iterations", type=int, default=5000)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--res-path", default="outputs/insurance")
    p.add_argument("--print-every", type=int, default=100)
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks, one process each (default: "
                        "every attached card, reduced to the largest "
                        "divisor of the batch; 1 on the CPU)")
    p.add_argument("--dp-mode", default="gradient_sync",
                   choices=["gradient_sync", "param_averaging"],
                   help="gradient_sync: the fused step with sync-BN; "
                        "param_averaging: the unfused per-fit loop, params "
                        "and updater state averaged over the ranks")
    p.add_argument("--averaging-frequency", type=int, default=5)
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="cap on protocol steps per call of the fused step "
                        "(None = auto: the largest divisor of the run and "
                        "the cadences up to 100)")
    p.add_argument("--sync-dumps", action="store_true",
                   help="write artifacts synchronously on the training "
                        "thread (the reference's behavior) instead of the "
                        "background artifact writer")
    p.add_argument("--seed", type=int, default=prng.NUMBER_OF_THE_BEAST,
                   help="model-init + training-stream seed (the dataset "
                        "keeps its own fixed seed)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="generator weight EMA decay (e.g. 0.999); fused "
                        "step only")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "torch versions of the kernels)")
    backend.add_bf16_flag(p)
    backend.add_mp_flag(p)
    add_recovery_args(p)
    args = p.parse_args(argv)
    check_recovery_args(p, args)
    return args


def evaluate(trainer: GANTrainer) -> Dict[str, float]:
    """End-of-run evaluation: the notebook's cell-10 weighted AUROC and the
    risk class's F1 over the last prediction dump (``evaluation_stats.txt``).
    Its host seconds go to ``trainer.timings``."""
    c = trainer.c
    out: Dict[str, float] = {}
    t0 = time.perf_counter()
    pred_csv = os.path.join(
        c.res_path, f"insurance_test_predictions_{trainer.steps}.csv")
    test_csv = os.path.join(c.res_path, "insurance_test.csv")
    if os.path.exists(pred_csv) and os.path.exists(test_csv):
        preds = read_csv_matrix(pred_csv)
        labels = read_csv_matrix(test_csv)[:, c.label_index]
        out["test_auroc"] = metrics_lib.auroc_from_predictions(preds, labels)
        out.update(metrics_lib.write_evaluation_report(
            c.res_path, preds, labels, num_classes=2, f1_cls=1))
    trainer.timings["report_s"] = time.perf_counter() - t0
    return out


def _config(args: argparse.Namespace, overrides: Dict) -> GANTrainerConfig:
    return default_config(
        num_iterations=args.iterations, batch_size=args.batch_size,
        res_path=args.res_path, print_every=args.print_every,
        save_every=args.save_every, dp_mode=args.dp_mode,
        averaging_frequency=args.averaging_frequency,
        steps_per_call=args.steps_per_call, async_dumps=not args.sync_dumps,
        ema_decay=args.ema_decay, seed=args.seed,
        **recovery_config_kwargs(args), **overrides)


def _train_and_evaluate(args: argparse.Namespace, config: GANTrainerConfig,
                        group: Optional[mesh.DataGroup] = None
                        ) -> Tuple[GANTrainer, Dict]:
    rank0 = group is None or group.rank == 0

    def make_trainer(resume: bool) -> GANTrainer:
        c = dataclasses.replace(config, resume=True) if resume else config
        return GANTrainer(
            device=args.device, group=group, config=c,
            workload=InsuranceWorkload(M.InsuranceConfig(seed=args.seed)))

    # a data-parallel world recovers as a whole, in the parent (``run``)
    trainer, result = run_with_recovery(
        make_trainer, max_restarts=args.max_restarts if group is None else 0,
        log=print if rank0 else None)
    if rank0:
        result.update(evaluate(trainer))
        result["host_seconds"] = trainer.timings
    return trainer, result


def _preempted(e: PreemptionError, args: argparse.Namespace) -> Dict:
    """The result of a preempted run: the resumable state, not a traceback
    (``cli`` exits 75 on it)."""
    return {"preempted": True, "step": e.step, "checkpoint": e.checkpoint,
            "res_path": args.res_path}


def _rank(group: mesh.DataGroup, args: argparse.Namespace,
          config: GANTrainerConfig) -> Dict:
    try:
        # a spawned rank starts from the default policy: the flags set it
        with backend.configured(**backend.flag_policy(args)):
            return _train_and_evaluate(args, config, group)[1]
    except PreemptionError as e:
        return _preempted(e, args)


def run(args: argparse.Namespace, timeout: float = 3600.0, **overrides
        ) -> Tuple[Optional[GANTrainer], Dict]:
    """The program for parsed ``args`` -> (the trainer, or None when the
    run was spread over ranks in other processes or was preempted; rank
    0's result, ``{"preempted": True, ...}`` after a preemption).
    ``overrides`` set further ``GANTrainerConfig`` fields."""
    config = _config(args, overrides)
    world = resolve_n_devices(args.n_devices, args.batch_size, args.device)
    if world == 1:
        try:
            # --bf16 / --mp over the configured policy, before any graph
            with backend.configured(**backend.flag_policy(args)):
                return _train_and_evaluate(args, config)
        except PreemptionError as e:
            return None, _preempted(e, args)
    t0 = time.perf_counter()
    datasets.ensure_insurance_csv(args.res_path)
    csv_s = time.perf_counter() - t0
    dev = backend.resolve_device(args.device)

    def launch(resume: bool) -> Dict:
        c = dataclasses.replace(config, resume=True) if resume else config
        return mesh.spawn(
            _rank, world, (args, c), device=dev.type, timeout=timeout,
            forward_signals=parse_signals(config.preempt_signals)
            if config.preempt_signals else ())[0]

    if args.max_restarts > 0:
        # one failed rank restarts the whole world from the checkpoint
        result = spawn_with_recovery(
            launch, os.path.join(args.res_path, "checkpoints"),
            max_restarts=args.max_restarts)
    else:
        result = launch(False)
    if not result.get("preempted"):
        result["host_seconds"]["csv_ready_s"] = csv_s
    return None, result


def main(argv=None) -> Dict:
    _, result = run(parse_args(argv))
    # one JSON line (numpy scalars coerced)
    print(json.dumps(result, default=float))
    return result


def cli(argv=None) -> None:
    """The ``python -m`` entry: ``main``, exiting 75 (EX_TEMPFAIL: requeue
    me) when the run was preempted."""
    if main(argv).get("preempted"):
        sys.exit(EXIT_PREEMPTED)


if __name__ == "__main__":
    cli()
