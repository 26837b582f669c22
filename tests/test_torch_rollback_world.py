"""Rollback across a data-parallel world on the CPU (two gloo ranks): a NaN
batch under ``--nan-alarm rollback`` heals by exactly one rollback on every
rank, in place (no re-spawn), and the healed world ends where the port's
one-rank rollback from the same draws ends; a budget that runs out is fatal
on every rank.

This module imports torch and the port only — never jax — because its rank
jobs are spawned: a spawned rank imports the module its function lives in.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.runtime import backend
from gan_deeplearning4j_tpu_torch.testing.chaos import NanSource
from gan_deeplearning4j_tpu_torch.train import gan_trainer
from gan_deeplearning4j_tpu_torch.train import insurance_main as IT
from gan_deeplearning4j_tpu_torch.train.fused_step import state_to_graphs

TIMEOUT_S = 120.0
# the insurance program: 6 steps of batch 10, one a call, checkpoints at
# 2, 4 and 6; the batches are streamed so that the wrapped source feeds them
BASE = ["--device", "cpu", "--iterations", "6", "--batch-size", "10",
        "--checkpoint-every", "2", "--print-every", "2", "--save-every", "2",
        "--steps-per-call", "1", "--telemetry", "--nan-alarm", "rollback"]
OVERRIDES = dict(data_on_device=False)
# world 2 against world 1 after the heal: sync-BN's and the all-reduce's
# f32 sums run in another order, and an element whose gradient is near
# zero sits on RmsProp's linear part (slope lr / sqrt(eps) = 4 at lr 4e-4),
# so its order noise moves it by up to a quarter of the learning rate over
# six steps
PARAM_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _poison(nan_at, every):
    """Wrap the training iterator of the first incarnation (``every``:
    of every incarnation) with a ``NanSource`` at emitted batch
    ``nan_at``, and flush the metrics every record, so that the alarm
    trips at the bad step's own boundary."""
    import functools

    from gan_deeplearning4j_tpu_torch.utils.metrics import MetricsLogger

    gan_trainer.MetricsLogger = functools.partial(MetricsLogger,
                                                  flush_every=1)
    orig = gan_trainer.RecordReaderDataSetIterator
    built = []

    def make(*a, **kw):
        it = orig(*a, **kw)
        # a trainer builds its training iterator first, then its test one
        built.append(it)
        if len(built) % 2 == 1 and (every or len(built) == 1):
            return NanSource(it, nan_at=nan_at)
        return it

    gan_trainer.RecordReaderDataSetIterator = make


def _digest(trainer) -> str:
    """The four graphs' params and updater state, hashed."""
    state_to_graphs(trainer.state, trainer.dis, trainer.gen, trainer.gan,
                    trainer.classifier)
    h = hashlib.sha256()
    for name, g in sorted(trainer._graphs().items()):
        for tree in (g.params, g.opt_state):
            for layer in sorted(tree):
                for k in sorted(tree[layer]):
                    h.update(f"{name}/{layer}/{k}".encode())
                    h.update(tree[layer][k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _params(trainer):
    state_to_graphs(trainer.state, trainer.dis, trainer.gen, trainer.gan,
                    trainer.classifier)
    return {(name, layer, k): v.detach().cpu().numpy().copy()
            for name, g in trainer._graphs().items()
            for layer, lp in g.params.items() for k, v in lp.items()}


def _report(trainer, result, group):
    mgr = trainer._rollback_mgr
    return {"rank": group.rank if group is not None else 0,
            "steps": result["steps"], "total": mgr.total,
            "attempts": mgr.attempts, "lr_scale": mgr.lr_scale,
            "losses": [result["d_loss"], result["g_loss"],
                       result["clf_loss"]],
            "digest": _digest(trainer),
            "z_gen": trainer.z_gen.get_state().numpy().tobytes().hex()}


# -- rank jobs ---------------------------------------------------------------

def healing_insurance_rank(group, args, config):
    """insurance_main's rank job with a NaN batch in the first
    incarnation; each rank writes its manager, losses and state digest
    (``rank_<r>.json``) and its params (``params_<r>.npz``)."""
    _poison(args.nan_at, every=False)
    with backend.configured(**backend.flag_policy(args)):
        trainer, result = IT._train_and_evaluate(args, config, group)
    with open(os.path.join(args.res_path, f"rank_{group.rank}.json"),
              "w") as f:
        json.dump(_report(trainer, result, group), f)
    np.savez(os.path.join(args.res_path, f"params_{group.rank}.npz"),
             **{"/".join(k): v for k, v in _params(trainer).items()})
    return result


def exhausted_insurance_rank(group, args, config):
    """A NaN batch in every incarnation at the same step: the second
    rollback at that step exceeds ``--max-rollbacks 1``; each rank writes
    the class it fails with (``failed_<r>``)."""
    _poison(args.nan_at, every=True)
    try:
        return IT._rank(group, args, config)
    except BaseException as e:
        with open(os.path.join(args.res_path, f"failed_{group.rank}"),
                  "w") as f:
            f.write(type(e).__name__)
        raise


# -- tests -------------------------------------------------------------------

def test_a_world_heals_in_place_as_one_rank_does(tmp_path, monkeypatch):
    """A NaN in batch 3 at world 2: both ranks raise the agreed alarm at
    step 3, take one rollback each to the checkpoint at 2, with the same
    LR scale and latent lineage, and finish the 6 steps with finite losses
    and equal state; the healed world ends where the port's one-rank
    rollback from the same draws ends, within ``PARAM_ATOL``."""
    res1 = str(tmp_path / "w1")
    args1 = IT.parse_args(BASE + ["--res-path", res1])
    args1.nan_at = 2
    monkeypatch.setattr(gan_trainer, "RecordReaderDataSetIterator",
                        gan_trainer.RecordReaderDataSetIterator)
    monkeypatch.setattr(gan_trainer, "MetricsLogger",
                        gan_trainer.MetricsLogger)
    _poison(2, every=False)
    trainer1, one = IT.run(args1, **OVERRIDES)
    want = _report(trainer1, one, None)
    want_params = _params(trainer1)
    assert want["total"] == 1 and want["steps"] == 6

    res2 = str(tmp_path / "w2")
    os.makedirs(res2)
    args2 = IT.parse_args(BASE + ["--n-devices", "2", "--res-path", res2])
    args2.nan_at = 2
    monkeypatch.setattr(IT, "_rank", healing_insurance_rank)
    _, got = IT.run(args2, timeout=TIMEOUT_S, **OVERRIDES)
    assert got["world"] == 2 and got["steps"] == 6
    ranks = []
    for r in (0, 1):
        with open(os.path.join(res2, f"rank_{r}.json")) as f:
            ranks.append(json.load(f))
    for rep in ranks:
        assert (rep["steps"], rep["total"], rep["attempts"]) == (6, 1, 1)
        assert rep["lr_scale"] == want["lr_scale"] == 0.5
        assert rep["z_gen"] == want["z_gen"]
        assert np.all(np.isfinite(rep["losses"]))
    assert ranks[0]["digest"] == ranks[1]["digest"]
    with np.load(os.path.join(res2, "params_0.npz")) as f:
        for key, value in want_params.items():
            np.testing.assert_allclose(f["/".join(key)], value, rtol=0,
                                       atol=PARAM_ATOL, err_msg=str(key))
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=1e-3, atol=1e-5)
    # rank 0's timeline: the agreed alarm, one request, one restore at 2
    evs = [json.loads(line) for line in
           open(os.path.join(res2, "events.jsonl"))]
    req = [e for e in evs if e["name"] == "rollback.request"]
    rest = [e for e in evs if e["name"] == "rollback.restore"]
    assert [(e["step"], e["bad_step"]) for e in req] == [(3, 3)]
    assert [(e["step"], e["bad_step"]) for e in rest] == [(2, 3)]


def test_an_exhausted_budget_is_fatal_on_every_rank(tmp_path, monkeypatch):
    """The same NaN in every incarnation: the second rollback at step 1
    exceeds ``--max-rollbacks 1`` on both ranks at once, and the world
    fails with ``RollbackError``, which its recovery does not retry."""
    res = str(tmp_path / "exhausted")
    os.makedirs(res)
    args = IT.parse_args(BASE + ["--n-devices", "2", "--max-rollbacks", "1",
                                 "--max-restarts", "2", "--res-path", res])
    args.nan_at = 0
    monkeypatch.setattr(IT, "_rank", exhausted_insurance_rank)
    with pytest.raises(mesh.RankFailedError) as e:
        IT.run(args, timeout=TIMEOUT_S, **OVERRIDES)
    assert e.value.has_class("RollbackError")
    assert not e.value.has_class("RollbackRequested")
    for r in (0, 1):
        with open(os.path.join(res, f"failed_{r}")) as f:
            assert f.read() == "RollbackError", r
