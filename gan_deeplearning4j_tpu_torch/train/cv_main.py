"""The CV program, DCGAN on MNIST (torch twin of ``gan_deeplearning4j_tpu/
train/cv_main.py``; the reference's ``dl4jGANComputerVision``).

Run: ``python -m gan_deeplearning4j_tpu_torch.train.cv_main --res-path
outputs/cv_torch`` (on the GPU; ``--device cpu`` runs the plain torch
versions of the kernels on the CPU).  The program:
  1. writes ``mnist_{train,test}.csv`` into ``--res-path`` unless both are
     there (``--n-train`` / ``--n-test`` rows of the synthetic surrogate);
  2. decodes them through the DataVec-style iterator;
  3. trains ``--iterations`` steps at ``--batch-size`` (on one card the
     step is a replayed CUDA graph, K steps a call: the largest divisor of
     the run and of both cadences up to ``--steps-per-call`` or 100);
  4. every ``--print-every`` steps writes ``mnist_out_<k>.csv`` (the
     generator over the 10x10 latent grid), every ``--save-every``
     ``mnist_test_predictions_<k>.csv`` (the classifier's softmax over the
     test set), on a background writer unless ``--sync-dumps``;
  5. writes ``mnist_metrics.jsonl`` (one record a step) and the four model
     zips ``mnist_{dis,gan,gen,CV}_model.zip``;
  6. scores the run: test accuracy and macro F1 from the last prediction
     dump (``evaluation_stats.txt``), FID of ``--fid-samples`` generated
     against as many test digits in the run's classifier space (``fid``)
     and in the frozen extractor's (``fid_frozen``; ``_ema`` twins with
     ``--ema-decay``), and ``fid_primary``;
and prints rank 0's per-step losses, then one JSON line (``steps``,
``examples_per_sec``, ``d_loss``, ``g_loss``, the scores, and
``host_seconds``: the set-up, dump, save and evaluation times).
``--n-devices N`` trains data-parallel in N processes (rank r on card r
over NCCL; gloo ranks with ``--device cpu``): this process writes the CSV
pair first, every rank decodes it, and rank 0 alone dumps, saves, logs
metrics and evaluates.  ``--dp-mode param_averaging`` runs the unfused
per-fit loop.  Supervision, as in the JAX program: ``--checkpoint-every N``
(checkpoints in the JAX format under ``res-path/checkpoints``),
``--resume``, ``--max-restarts`` (with ``--n-devices``, one failed rank
restarts the whole world from the newest checkpoint),
``--async-checkpoint``,
``--preempt-signal SIG`` (an emergency checkpoint, ``PREEMPTED.json`` and
exit code 75; with ``--n-devices`` this process forwards the signal to the
ranks), ``--data-retries`` and ``--max-quarantine``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.data import datasets
from gan_deeplearning4j_tpu_torch.data.csv import read_csv_matrix
from gan_deeplearning4j_tpu_torch.eval import fid as fid_lib
from gan_deeplearning4j_tpu_torch.eval import fid_extractor as fx
from gan_deeplearning4j_tpu_torch.eval import metrics as metrics_lib
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
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


class CVWorkload(Workload):
    name = "mnist"
    classifier_model_name = "CV"

    def __init__(self, cfg: M.CVConfig = M.CVConfig(),
                 n_train: int = 60000, n_test: int = 10000):
        self.cfg = cfg
        self.n_train = n_train
        self.n_test = n_test
        self.dis_to_gan = M.DIS_TO_GAN
        self.gan_to_gen = M.GAN_TO_GEN
        self.dis_to_classifier = M.DIS_TO_CLASSIFIER

    def build_graphs(self, device) -> Dict[str, object]:
        dis = M.build_discriminator(self.cfg, device)
        return {"dis": dis, "gen": M.build_generator(self.cfg, device),
                "gan": M.build_gan(self.cfg, device),
                "classifier": M.build_classifier(dis, self.cfg)}

    def ensure_data(self, res_path: str):
        return datasets.ensure_mnist_csv(res_path, self.n_train, self.n_test)


def default_config(**overrides) -> GANTrainerConfig:
    base = dict(dataset_name="mnist", num_features=784, label_index=784,
                num_classes=10, batch_size=200, batch_size_pred=500,
                num_iterations=10000, num_gen_samples=10)
    base.update(overrides)
    return GANTrainerConfig(**base)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=200)
    p.add_argument("--res-path", default="outputs/computer_vision")
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
    p.add_argument("--averaging-frequency", type=int, default=10)
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="cap on protocol steps per call of the fused step "
                        "(None = auto: the largest divisor of the run and "
                        "the cadences up to 100)")
    p.add_argument("--sync-dumps", action="store_true",
                   help="write artifacts synchronously on the training "
                        "thread (the reference's behavior) instead of the "
                        "background artifact writer")
    p.add_argument("--n-train", type=int, default=60000)
    p.add_argument("--n-test", type=int, default=10000)
    p.add_argument("--seed", type=int, default=prng.NUMBER_OF_THE_BEAST,
                   help="model-init + training-stream seed (the dataset "
                        "keeps its own fixed seed)")
    p.add_argument("--fid-samples", type=int, default=10000,
                   help="generator samples for the end-of-run FID "
                        "(0 disables)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="generator weight EMA decay (e.g. 0.999); adds the "
                        "fid_ema metrics; fused step only")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "torch versions of the kernels)")
    backend.add_bf16_flag(p)
    backend.add_mp_flag(p)
    add_recovery_args(p)
    args = p.parse_args(argv)
    check_recovery_args(p, args)
    return args


def evaluate(trainer: GANTrainer, fid_samples: int = 10000) -> Dict[str, float]:
    """End-of-run evaluation: the notebook's cell-7 accuracy and the F1
    report over the final prediction dump, and the generator FID in the
    run's classifier space and in the frozen extractor's, for the live
    weights and, when the run kept one, the EMA; ``fid_primary`` is the
    frozen space's, EMA weights when available.  Host seconds of the
    report and of the FID go to ``trainer.timings``."""
    c = trainer.c
    out: Dict[str, float] = {}
    t0 = time.perf_counter()
    step = trainer.steps
    pred_csv = os.path.join(c.res_path,
                            f"{c.dataset_name}_test_predictions_{step}.csv")
    test_csv = os.path.join(c.res_path, "mnist_test.csv")
    if os.path.exists(pred_csv) and os.path.exists(test_csv):
        preds = read_csv_matrix(pred_csv)
        labels = read_csv_matrix(test_csv)[:, c.label_index]
        out["test_accuracy"] = metrics_lib.accuracy_from_predictions(
            preds, labels)
        out.update(metrics_lib.write_evaluation_report(
            c.res_path, preds, labels, c.num_classes))
    t1 = time.perf_counter()
    trainer.timings["report_s"] = t1 - t0
    if fid_samples and os.path.exists(test_csv):
        real, _ = datasets.load_split(test_csv, c.label_index)
        real = real[:fid_samples].astype("float32")
        try:
            frozen = fx.load_extractor(trainer.device)
        except FileNotFoundError:
            frozen = None  # asset absent; the run's own space still scores
        spaces = [("", trainer.classifier, fid_lib.DEFAULT_FEATURE_LAYER)]
        if frozen is not None:
            spaces.append(("_frozen", frozen, fx.FEATURE_LAYER))
        real_moments = {}
        for tag, graph, layer in spaces:
            f = fid_lib.extract_features(graph, real, layer)
            real_moments[tag] = (f.mean(axis=0), np.cov(f, rowvar=False))

        def score(suffix: str) -> None:
            generated = fid_lib.synthesize_pixels(
                trainer.gen, fid_samples, real.shape[1], z_size=c.z_size)
            for tag, graph, layer in spaces:
                f = fid_lib.extract_features(graph, generated, layer)
                mu_r, cov_r = real_moments[tag]
                out[f"fid{tag}{suffix}"] = fid_lib.frechet_distance(
                    mu_r, cov_r, f.mean(axis=0), np.cov(f, rowvar=False))

        score("")
        ema = getattr(trainer.gen, "ema_params", None)
        if ema is not None:
            orig = trainer.gen.params
            trainer.gen.params = ema
            try:
                score("_ema")
            finally:
                trainer.gen.params = orig
        for k in ("fid_frozen_ema", "fid_frozen", "fid_ema", "fid"):
            if k in out:
                out["fid_primary"] = out[k]
                out["fid_primary_source"] = k
                break
    trainer.timings["fid_s"] = time.perf_counter() - t1
    return out


def _config(args: argparse.Namespace, overrides: Dict) -> GANTrainerConfig:
    return default_config(
        num_iterations=args.iterations, batch_size=args.batch_size,
        res_path=args.res_path, print_every=args.print_every,
        save_every=args.save_every, dp_mode=args.dp_mode, averaging_frequency=args.averaging_frequency,
        steps_per_call=args.steps_per_call, async_dumps=not args.sync_dumps,
        ema_decay=args.ema_decay, seed=args.seed,
        **recovery_config_kwargs(args), **overrides)


def _train_and_evaluate(args: argparse.Namespace, config: GANTrainerConfig,
                        group: Optional[mesh.DataGroup] = None
                        ) -> Tuple[GANTrainer, Dict]:
    cfg = M.CVConfig(seed=args.seed)
    rank0 = group is None or group.rank == 0

    def make_trainer(resume: bool) -> GANTrainer:
        c = dataclasses.replace(config, resume=True) if resume else config
        return GANTrainer(
            cfg, device=args.device, group=group, config=c,
            workload=CVWorkload(cfg, n_train=args.n_train,
                                n_test=args.n_test))

    # a data-parallel world recovers as a whole, in the parent (``run``)
    trainer, result = run_with_recovery(
        make_trainer, max_restarts=args.max_restarts if group is None else 0,
        log=print if rank0 else None)
    if rank0:
        result.update(evaluate(trainer, fid_samples=args.fid_samples))
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
    ``overrides`` set further ``GANTrainerConfig`` fields (e.g.
    ``data_on_device``, ``stream_chunk_bytes``)."""
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
    datasets.ensure_mnist_csv(args.res_path, args.n_train, args.n_test)
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
