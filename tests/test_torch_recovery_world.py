"""Whole-world recovery of a data-parallel run on the CPU (two gloo ranks):
one rank that fails alone fails ``mesh.spawn`` fast, with its class, and
``--max-restarts`` re-spawns the whole world from the newest checkpoint.

This module imports torch and the port only — never jax — because its rank
jobs are spawned: a spawned rank imports the module its function lives in.
"""

import os
import time

import pytest
import torch
import torch.distributed as dist

from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.train import gan_trainer
from gan_deeplearning4j_tpu_torch.train import insurance_main as IT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

TIMEOUT_S = 120.0
ZIPS = ("dis", "gan", "gen", "insurance")
# the insurance program at world 2: 6 steps, one a call, checkpoints at
# 2, 4 and 6
BASE = ["--device", "cpu", "--n-devices", "2", "--iterations", "6",
        "--batch-size", "10", "--checkpoint-every", "2", "--print-every", "2",
        "--save-every", "2", "--steps-per-call", "1"]
FAULTS = {"RuntimeError": RuntimeError, "ValueError": ValueError}


# -- rank jobs ---------------------------------------------------------------

def _fail_while_rank_0_waits(group):
    """Rank 1 raises; rank 0 sits in a collective rank 1 never joins."""
    if group.rank == 1:
        raise OSError("rank 1 lost its disk")
    dist.all_reduce(torch.zeros(1))
    return group.rank


def faulty_insurance_rank(group, args, config):
    """insurance_main's rank job, counting its starts per rank; in rank 1,
    the first time only (a marker file in the run's directory), an
    ``args.fault = (class name, step)`` raised at that step's boundary,
    after the step ran and before its checkpoint."""
    kind, step = args.fault
    with open(os.path.join(args.res_path, f"starts_{group.rank}"), "a") as f:
        f.write("start\n")
    marker = os.path.join(args.res_path, "FAULT_FIRED")
    if group.rank == 1 and not os.path.exists(marker):
        orig = GANTrainer._bookkeeping

        def bookkeeping(self, rows):
            if self.steps == step and not os.path.exists(marker):
                open(marker, "w").close()
                raise FAULTS[kind](f"injected in rank 1 at step {step}")
            orig(self, rows)

        GANTrainer._bookkeeping = bookkeeping
    return IT._rank(group, args, config)


# -- tests -------------------------------------------------------------------

def test_spawn_fails_fast_when_one_rank_fails_alone():
    """Rank 0 would wait in its collective until the timeout; the call
    fails within the grace instead, naming rank 1's failure and class."""
    t0 = time.monotonic()
    with pytest.raises(mesh.RankFailedError) as e:
        mesh.spawn(_fail_while_rank_0_waits, 2, device="cpu",
                   timeout=TIMEOUT_S)
    assert time.monotonic() - t0 < 60
    assert e.value.has_class("OSError") and e.value.has_class("Exception")
    assert not e.value.has_class("ValueError")
    assert "rank 1 lost its disk" in str(e.value)
    assert e.value.failures[0][0] == 1


def _run(tmp_path, name, fault=None, extra=()):
    res = str(tmp_path / name)
    os.makedirs(res)
    args = IT.parse_args(BASE + list(extra) + ["--res-path", res])
    if fault is not None:
        args.fault = fault
    return res, IT.run(args, timeout=TIMEOUT_S)[1]


def _starts(res, rank):
    with open(os.path.join(res, f"starts_{rank}")) as f:
        return len(f.readlines())


def _zips_equal(a, b):
    for g in ZIPS:
        with open(os.path.join(a, f"insurance_{g}_model.zip"), "rb") as f:
            x = f.read()
        with open(os.path.join(b, f"insurance_{g}_model.zip"), "rb") as f:
            assert x == f.read(), g


def test_one_failed_rank_restarts_the_whole_world(tmp_path, monkeypatch):
    """A retryable fault in rank 1 alone at step 4 (after the checkpoint at
    2): both ranks are re-spawned and resume, and the run ends with the
    zips of the run that never failed, byte for byte — well inside the
    spawn timeout."""
    ref, want = _run(tmp_path, "ref")
    monkeypatch.setattr(IT, "_rank", faulty_insurance_rank)
    t0 = time.monotonic()
    res, got = _run(tmp_path, "flaky", ("RuntimeError", 4),
                    ["--max-restarts", "2"])
    assert time.monotonic() - t0 < 60
    assert os.path.exists(os.path.join(res, "FAULT_FIRED"))
    assert _starts(res, 0) == _starts(res, 1) == 2
    assert got["steps"] == want["steps"] == 6 and got["world"] == 2
    _zips_equal(ref, res)


def test_a_fatal_class_in_one_rank_is_not_retried(tmp_path, monkeypatch):
    """A ValueError in rank 1 alone re-raises at once: one start per
    rank, no restart."""
    monkeypatch.setattr(IT, "_rank", faulty_insurance_rank)
    t0 = time.monotonic()
    with pytest.raises(mesh.RankFailedError) as e:
        _run(tmp_path, "fatal", ("ValueError", 4), ["--max-restarts", "2"])
    assert time.monotonic() - t0 < 60
    assert e.value.has_class("ValueError")
    res = str(tmp_path / "fatal")
    assert _starts(res, 0) == _starts(res, 1) == 1


def test_world_recovery_budget_is_progress_aware(tmp_path):
    """The world's progress is its newest verified checkpoint: repeated
    failures with no newer checkpoint exhaust the budget; fatal classes
    are judged by the ranks' class names (a subclass counts)."""
    calls = []

    def failure(names):
        return mesh.RankFailedError([(1, names, "tb")])

    def launch(resume):
        calls.append(resume)
        raise failure(("RuntimeError", "Exception", "BaseException",
                       "object"))

    with pytest.raises(mesh.RankFailedError):
        gan_trainer.spawn_with_recovery(launch, str(tmp_path / "none"),
                                        max_restarts=2, log=None,
                                        backoff_base_s=0)
    assert calls == [False, True, True]
    calls.clear()

    def fatal(resume):
        calls.append(resume)
        raise failure(("CheckpointCorruptError", "RuntimeError", "Exception",
                       "BaseException", "object"))

    with pytest.raises(mesh.RankFailedError):
        gan_trainer.spawn_with_recovery(fatal, str(tmp_path / "none"),
                                        max_restarts=2, log=None,
                                        backoff_base_s=0)
    assert calls == [False]
