"""The port's ``GANPair`` data parallelism through its entry point, on the
CPU in spawned gloo ranks: ``roadmap_main --n-devices 2 --device cpu``.

This module imports torch, numpy and the port only — never jax — because
it also holds the rank job that ``tests/test_torch_pair_dp.py`` hands to
``mesh.spawn`` (a spawned rank imports the module its function lives in,
and a rank must not import jax or the JAX package).

Covered: the CLI at world 2 for celeba and cgan-cifar10 (rank 0's files
and result line, ``world`` 2, eager, finite losses); wgan-gp at world 2
for 4 iterations against a run checkpointed at 2 and resumed to 4 (the
zips bit for bit); a world-1 checkpoint refused at world 2
(``CheckpointMeshMismatchError`` through ``RankFailedError``); a batch
that does not split over the ranks refused before any rank starts, and a
share that would split a ``MinibatchStdDev`` group refused; ``--profile``
and ``--metrics-port`` at world 2 (a capture per rank, the ranks' mean
goodput).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import mesh_spec_dict
from gan_deeplearning4j_tpu_torch.models import cgan_cifar10 as GT
from gan_deeplearning4j_tpu_torch.models import dcgan_celeba as CT
from gan_deeplearning4j_tpu_torch.models import wgan_gp as WT
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.train import roadmap_main as RM
from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws, GANPair

# the small widths of test_torch_roadmap.py / test_torch_cgan.py
B = 8
CONFIGS = {
    "celeba": dataclasses.replace(CT.CelebAConfig(), base_filters=4, z_size=8),
    "wgan-gp": dataclasses.replace(WT.WGANGPConfig(), base_filters=4,
                                   z_size=8),
    "cgan-cifar10": dataclasses.replace(GT.CGANConfig(), base_filters=8,
                                        z_size=8),
}
SPAWN_TIMEOUT_S = 240.0
T = torch.from_numpy


# -- the rank job (spawned by tests/test_torch_pair_dp.py) -------------------

def build_pair(family: str, ms_weight: float = 0.0, group=None) -> GANPair:
    """A small pair of ``family`` on the CPU (over ``group``)."""
    cfg = CONFIGS[family]
    if family == "wgan-gp":
        return GANPair(WT.build_generator(cfg, "cpu"),
                       WT.build_critic(cfg, "cpu"), mode="wgan-gp",
                       gp_weight=cfg.gp_weight, group=group)
    M = GT if family == "cgan-cifar10" else CT
    return GANPair(M.build_generator(cfg, "cpu"),
                   M.build_discriminator(cfg, "cpu"), ms_weight=ms_weight,
                   group=group)


def draws_from_numpy(d) -> Draws:
    return Draws(*(None if v is None else
                   [T(np.array(a)) for a in v] if isinstance(v, list)
                   else T(np.array(v)) for v in d))


def state_to_numpy(state) -> dict:
    out = {"gen": interop.params_to_numpy(state.gen_params),
           "gen_opt": interop.opt_state_to_numpy(state.gen_opt),
           "dis": interop.params_to_numpy(state.dis_params),
           "dis_opt": interop.opt_state_to_numpy(state.dis_opt),
           "it": int(state.it)}
    if state.ema is not None:
        out["ema"] = interop.params_to_numpy(state.ema)
    return out


def run_case(group, case) -> dict:
    """``case["draws"]`` (K global iterations' draws) through
    ``make_multistep`` from the case's params -> (losses, final state).
    With ``case["ms_probe"]``, also one G-step's loss from the initial
    state on the first iteration's G-step draws, with the mode-seeking
    distances averaged over the ranks (as the pair does) and, for the
    probe, each rank's own ratio instead."""
    pair = build_pair(case["family"], case.get("ms", 0.0), group)
    pair.gen.params = interop.params_from_numpy(case["gen"], "cpu",
                                                like=pair.gen.params)
    pair.dis.params = interop.params_from_numpy(case["dis"], "cpu",
                                                like=pair.dis.params)
    y = None if case["y"] is None else T(case["y"])
    draws = [draws_from_numpy(d) for d in case["draws"]]
    step, state0 = pair.make_multistep(
        T(case["x"]), y, batch_size=case["batch"], steps_per_call=len(draws),
        n_critic=case["n_critic"], real_label=case["real_label"], z_size=8,
        ema_decay=case.get("ema", 0.0))
    out = {}
    if case.get("ms_probe"):
        out["ms_probe"] = ms_probe(pair, state0, draws[0], case["batch"])
    state, (dl, gl) = step(state0, draws=draws)
    out.update(d_loss=dl.numpy(), g_loss=gl.numpy(),
               state=state_to_numpy(state))
    return out


def ms_probe(pair: GANPair, state, draws: Draws, batch: int) -> dict:
    """One G-step from ``state`` on this rank's rows of ``draws``: its
    loss as the pair takes it, and as it would be with each rank's own
    distance ratio (the distances' all-reduce made the identity)."""
    b = pair.local_batch(batch)
    d = pair.share(draws, b)
    y_gen = torch.ones((b, 1))
    args = (state.gen_params, state.gen_opt, state.dis_params, d.g_z, y_gen,
            d.g_z2)
    loss = pair._g_step(*args)[2]

    class _PerRank:
        """``mesh`` as gan_pair sees it, with the distances' mean over
        the ranks taken out (the sync-BNs keep theirs: ops/batchnorm.py
        and the kernels' wrappers hold their own reference)."""

        @staticmethod
        def all_reduce_mean_diff(t, group):
            return t

    from gan_deeplearning4j_tpu_torch.train import gan_pair

    real = gan_pair.mesh
    gan_pair.mesh = _PerRank
    try:
        per_rank = pair._g_step(*args)[2]
    finally:
        gan_pair.mesh = real
    return {"loss": float(loss), "per_rank_ratio_loss": float(per_rank)}


def pair_rank_job(group, cases) -> dict:
    """Every case of ``cases`` on this rank -> {case name: result}."""
    return {name: run_case(group, case) for name, case in cases.items()}


# -- the entry point at world 2 -----------------------------------------------

def _main(tmp, family, *extra):
    """The program (``main`` less its print) with a spawn timeout."""
    return RM.run(RM.parse_args(
        ["--family", family, "--device", "cpu", "--batch-size", str(B),
         "--n-train", "24", "--print-every", "2", "--fidelity-steps", "0",
         "--res-path", str(tmp), *extra]), timeout=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("family", ["celeba", "cgan-cifar10"])
def test_roadmap_main_two_ranks_on_cpu(tmp_path, family):
    """``--n-devices 2`` (refused before it was ported): two gloo ranks at
    full width; rank 0's files and result line, with ``world`` 2, eager
    calls and no kernel launches on the CPU."""
    result = _main(tmp_path, family, "--iterations", "2", "--n-devices", "2")
    assert result["steps"] == 2
    assert result["world"] == 2 and result["family"] == family
    assert not result["graphed"] and result["device"] == "cpu"
    assert np.isfinite([result["d_loss"], result["g_loss"]]).all()
    assert result["examples_per_sec"] == 0.0  # one call: no steady window
    assert set(result["port_launches"].values()) == {0}
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"{family}_samples_2.png", f"{family}_metrics.jsonl",
         f"{family}_gen_model.zip", f"{family}_dis_model.zip",
         "events.jsonl", "run_manifest.json"])
    steps = [json.loads(l).get("step")
             for l in open(tmp_path / f"{family}_metrics.jsonl")]
    assert steps == [1, 2, None]  # + the ranks' goodput record


def _zips(d):
    return {n: (d / f"wgan-gp_{n}_model.zip").read_bytes()
            for n in ("gen", "dis", "gen_ema")}


def test_roadmap_main_two_ranks_resume_equals_a_straight_run(tmp_path):
    """wgan-gp with the EMA at world 2: 4 iterations straight, against 2
    with a checkpoint and a ``--resume`` to 4 (rank 0 writes, every rank
    restores): the zips bit for bit, the metrics steps 1-4, and the
    checkpoint's mesh spec says 2 ranks.  A world-1 checkpoint is then
    refused at world 2."""
    kw = ("--n-devices", "2", "--ema-decay", "0.9")
    straight, ckpt = tmp_path / "straight", tmp_path / "ckpt"
    _main(straight, "wgan-gp", "--iterations", "4", *kw)
    _main(ckpt, "wgan-gp", "--iterations", "2", "--checkpoint-every", "2",
          *kw)
    saved = TrainCheckpointer(str(ckpt / "wgan-gp_ckpt"), sweep_debris=False)
    assert saved.mesh_spec(2) == mesh_spec_dict(2)
    out = _main(ckpt, "wgan-gp", "--iterations", "4", "--checkpoint-every",
                "2", "--resume", *kw)
    assert out["steps"] == 4 and out["world"] == 2
    assert _zips(straight) == _zips(ckpt)
    steps = {json.loads(l).get("step")
             for l in open(ckpt / "wgan-gp_metrics.jsonl")}
    assert steps == {1, 2, 3, 4, None}  # + the goodput records
    one = tmp_path / "one"
    _main(one, "wgan-gp", "--iterations", "2", "--checkpoint-every", "2",
          "--ema-decay", "0.9")
    with pytest.raises(mesh.RankFailedError) as e:
        _main(one, "wgan-gp", "--iterations", "4", "--checkpoint-every", "2",
              "--resume", *kw)
    assert e.value.has_class("CheckpointMeshMismatchError")


def test_roadmap_main_refuses_a_batch_the_ranks_cannot_split(tmp_path):
    with pytest.raises(ValueError, match="must divide over 3 devices"):
        _main(tmp_path, "celeba", "--iterations", "2", "--n-devices", "3")


def test_a_share_that_splits_a_minibatch_stddev_group_is_refused():
    """celeba's discriminator groups rows by 4: at world 4 a batch of 8
    leaves each rank 2 real and 2 fake rows, which would group together
    (the one-rank batch groups real and fake rows apart)."""
    pair = build_pair("celeba", group=mesh.DataGroup(0, 4, torch.device("cpu"),
                                                     "gloo"))
    assert pair.local_batch(16) == 4
    with pytest.raises(ValueError, match="group_size 4"):
        pair.local_batch(B)


def test_roadmap_main_two_ranks_profile_and_goodput(tmp_path):
    """``--profile DIR --metrics-port 0`` at world 2: each rank's capture
    in ``DIR/rank<r>`` (with its sidecar), rank 0's manifest (process 0 of
    2, the data axis 2) and the ranks' mean goodput in the result and the
    last metrics record, aggregated over both processes."""
    prof = tmp_path / "prof"
    result = _main(tmp_path / "r", "wgan-gp", "--iterations", "2",
                   "--n-devices", "2", "--profile", str(prof),
                   "--metrics-port", "0")
    assert sorted(os.listdir(prof)) == ["rank0", "rank1"]
    for r in ("rank0", "rank1"):
        files = os.listdir(prof / r)
        assert "host_anchor.json" in files
        assert [f for f in files if f.endswith(".pt.trace.json")]
    gp = result["goodput"]
    assert gp["aggregated_processes"] == 2
    assert sum(gp[p] for p in ("data_wait", "dispatch", "readback",
                               "checkpoint", "eval", "other")) \
        == pytest.approx(gp["wall_s"], rel=1e-3)
    manifest = json.load(open(tmp_path / "r" / "run_manifest.json"))
    assert (manifest["process_index"], manifest["process_count"],
            manifest["mesh"]) == (0, 2, {"data": 2})
    assert manifest["run_id"] == result["run_id"]
    last = json.loads((tmp_path / "r" / "wgan-gp_metrics.jsonl")
                      .read_text().splitlines()[-1])
    assert last == {"goodput": gp, "run_id": result["run_id"]}
