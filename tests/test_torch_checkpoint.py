"""The port's checkpointer (``gan_deeplearning4j_tpu_torch/checkpoint/``)
on the CPU: its crash-safety contract, mirrored from tests/test_chaos.py
and tests/test_train.py (every kill point of a save, a SIGKILL'd writer,
corrupt / truncated / missing files, torn-only directories, async saves,
pruning), and its on-disk format held to the JAX package's: a checkpoint
of either package restores in the other bit for bit, and the same state
gives byte-equal files and manifest hashes."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.checkpoint import TrainCheckpointer as JCheckpointer
from gan_deeplearning4j_tpu.data.csv import RecordReaderDataSetIterator as IterJ
from gan_deeplearning4j_tpu.parallel.elastic import MeshSpec
from gan_deeplearning4j_tpu.train import gan_trainer as GJ
from gan_deeplearning4j_tpu.train import insurance_main as IJ
from gan_deeplearning4j_tpu_torch.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptError,
    CheckpointMeshMismatchError,
    NoVerifiedCheckpointError,
    TrainCheckpointer,
)
from gan_deeplearning4j_tpu_torch.checkpoint import checkpointer as ck_mod
from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
    MANIFEST_NAME,
    mesh_spec_dict,
)
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MT
from gan_deeplearning4j_tpu_torch.train import fused_step
from gan_deeplearning4j_tpu_torch.train import insurance_main as IT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

REPO = Path(__file__).resolve().parents[1]
SEED = 666
EMA = 0.9


class InjectedCrash(RuntimeError):
    simulates_kill = True  # leaves the debris a real kill leaves


def _graph():
    return MT.build_discriminator(device="cpu")


def _extra():
    return {"note": "x", "arr": np.arange(8, dtype=np.float32)}


def _save_events(save) -> list:
    """The chaos points one save passes, in order."""
    events = []
    ck_mod._chaos_hook = events.append
    try:
        save()
    finally:
        ck_mod._chaos_hook = None
    return events


def _kill_at(k: int, save) -> None:
    """Run ``save`` with a hard kill at its ``k``-th chaos point."""
    seen = []

    def hook(event):
        seen.append(event)
        if len(seen) == k + 1:
            raise InjectedCrash(f"killed at {event}")

    ck_mod._chaos_hook = hook
    try:
        with pytest.raises(InjectedCrash):
            save()
    finally:
        ck_mod._chaos_hook = None


def _assert_restorable(directory, expect_steps):
    """A fresh checkpointer (its init reclaims debris) restores a verified
    checkpoint at one of ``expect_steps`` and leaves no debris."""
    step, extra = TrainCheckpointer(directory).restore({"dis": _graph()})
    assert step in expect_steps
    assert extra["note"] == "x"
    np.testing.assert_array_equal(extra["arr"], np.arange(8, dtype=np.float32))
    assert not [n for n in os.listdir(directory)
                if n.startswith((".ckpt_tmp_", ".ckpt_del_"))]
    return step


def _flip_byte(path: str, seed: int) -> None:
    rng = np.random.RandomState(seed)
    data = bytearray(open(path, "rb").read())
    data[rng.randint(len(data))] ^= 0xFF
    open(path, "wb").write(bytes(data))


# -- kills during a save -------------------------------------------------------

def test_every_first_save_kill_point_restorable(tmp_path):
    """A checkpoint at 2 committed, then a kill at every chaos point of the
    step-4 save: the directory restores (4 once the rename committed or
    the complete orphan is adopted, else 2)."""
    base = tmp_path / "base"
    g = _graph()
    ck0 = TrainCheckpointer(str(base), keep=10)
    ck0.save(2, {"dis": g}, extra=_extra())
    events = _save_events(lambda: ck0.save(4, {"dis": g}, extra=_extra()))
    shutil.rmtree(str(base / "ckpt_4"))
    assert events[-2:] == ["pre_swap", "post_swap"] and len(events) >= 5
    for k in range(len(events)):
        d = str(tmp_path / f"kill_{k}")
        shutil.copytree(str(base), d)
        ck = TrainCheckpointer(d, keep=10)
        _kill_at(k, lambda: ck.save(4, {"dis": g}, extra=_extra()))
        step = _assert_restorable(d, {2, 4})
        if events[k] in ("manifest", "pre_swap", "post_swap"):
            assert step == 4  # complete bytes: committed or adopted


def test_every_resave_kill_point_restorable(tmp_path):
    """Re-saving a step swaps by rename, rename, rmtree: a kill at any
    point leaves the step restorable (old copy, new copy or an adopted
    orphan)."""
    base = tmp_path / "base"
    g = _graph()
    ck0 = TrainCheckpointer(str(base), keep=10)
    ck0.save(2, {"dis": g}, extra=_extra())
    events = _save_events(lambda: ck0.save(2, {"dis": g}, extra=_extra()))
    assert "mid_swap" in events
    for k in range(len(events)):
        d = str(tmp_path / f"kill_{k}")
        shutil.copytree(str(base), d)
        _kill_at(k, lambda: TrainCheckpointer(d, keep=10).save(
            2, {"dis": g}, extra=_extra()))
        _assert_restorable(d, {2})


def test_resave_swap_kill_adopts_the_newer_copy(tmp_path):
    d = str(tmp_path)
    g = _graph()
    ck = TrainCheckpointer(d, keep=10)
    ck.save(2, {"dis": g}, extra={"note": "old", "arr": np.zeros(2)})
    k = _save_events(lambda: ck.save(
        2, {"dis": g}, extra={"note": "old", "arr": np.zeros(2)})).index(
            "mid_swap")
    _kill_at(k, lambda: ck.save(2, {"dis": g},
                                extra={"note": "new", "arr": np.ones(2)}))
    assert not os.path.exists(os.path.join(d, "ckpt_2"))  # both orphaned
    step, extra = TrainCheckpointer(d).restore({"dis": _graph()})
    assert step == 2 and extra["note"] == "new"


def test_sigkill_subprocess_mid_save_restorable(tmp_path):
    """SIGKILL at a seeded moment while a child loops saves: after one
    committed save the directory always restores."""
    script = textwrap.dedent("""
        import sys

        import numpy as np

        from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
        from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as M

        ck = TrainCheckpointer(sys.argv[1], keep=3)
        g = M.build_generator(device="cpu")
        extra = {"note": "x", "arr": np.arange(8, dtype=np.float32)}
        ck.save(1, {"gen": g}, extra=extra)
        print("READY", flush=True)
        step = 2
        while True:
            ck.save(step, {"gen": g}, extra=extra)
            step += 1
    """)
    rng = np.random.RandomState(SEED)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for trial in range(2):
        d = str(tmp_path / f"trial_{trial}")
        proc = subprocess.Popen([sys.executable, "-c", script, d],
                                stdout=subprocess.PIPE, text=True, env=env)
        try:
            assert proc.stdout.readline().strip() == "READY"
            time.sleep(rng.uniform(0.0, 0.25))
            proc.kill()
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
        step, extra = TrainCheckpointer(d).restore(
            {"gen": MT.build_generator(device="cpu")})
        assert step >= 1 and extra["note"] == "x"


# -- corruption ------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["flip", "truncate", "missing"])
def test_a_damaged_newest_checkpoint_falls_back(tmp_path, fault):
    """A flipped byte (the manifest intact: only hashing sees it), a torn
    state.npz or a lost one: verification fails and restore falls back to
    the previous checkpoint; an explicit request for the damaged step
    raises CheckpointCorruptError."""
    d = str(tmp_path)
    ck = TrainCheckpointer(d, keep=10)
    g = _graph()
    ck.save(2, {"dis": g}, extra=_extra())
    ck.save(4, {"dis": g}, extra=_extra())
    npz = os.path.join(d, "ckpt_4", "state.npz")
    if fault == "flip":
        for name in sorted(os.listdir(os.path.join(d, "ckpt_4"))):
            if name != MANIFEST_NAME:
                _flip_byte(os.path.join(d, "ckpt_4", name), SEED)
                break
    elif fault == "truncate":
        with open(npz, "rb+") as f:
            f.truncate(os.path.getsize(npz) // 2)
    else:
        os.remove(npz)
    assert not ck.verify(4) and ck.verify(2)
    assert ck.latest_verified_step() == 2
    step, extra = ck.restore({"dis": _graph()})
    assert step == 2
    np.testing.assert_array_equal(extra["arr"], np.arange(8, dtype=np.float32))
    with pytest.raises(CheckpointCorruptError):
        ck.restore({"dis": _graph()}, step=4)


def test_all_checkpoints_corrupt_raises_no_verified(tmp_path):
    d = str(tmp_path)
    ck = TrainCheckpointer(d, keep=10)
    ck.save(2, {"dis": _graph()}, extra=_extra())
    _flip_byte(os.path.join(d, "ckpt_2", "dis_model.zip"), SEED)
    with pytest.raises(NoVerifiedCheckpointError):
        ck.restore({"dis": _graph()})
    with pytest.raises(FileNotFoundError):
        ck.restore({"dis": _graph()}, step=5)  # absent, not "corrupt"


def test_legacy_pre_manifest_checkpoint_still_restores(tmp_path):
    d = str(tmp_path)
    ck = TrainCheckpointer(d, keep=10)
    g = _graph()
    ck.save(4, {"dis": g}, extra=_extra())
    os.remove(os.path.join(d, "ckpt_4", MANIFEST_NAME))
    assert not ck.verify(4)
    assert ck.restore({"dis": _graph()})[0] == 4
    assert ck.restore({"dis": _graph()}, step=4)[0] == 4
    ck.save(2, {"dis": g}, extra=_extra())
    assert ck.restore({"dis": _graph()})[0] == 2  # verified outranks legacy


def test_torn_only_checkpoint_resumes_from_step_zero(tmp_path):
    """``resume`` with the only checkpoint torn starts from step 0."""
    d = str(tmp_path)

    def trainer(**kw):
        return GANTrainer(device="cpu", workload=IT.InsuranceWorkload(),
                          config=IT.default_config(
                              num_iterations=2, res_path=d,
                              checkpoint_every=2, metrics=False, **kw))

    t = trainer()
    t.train(log=None)
    _flip_byte(os.path.join(d, "checkpoints", "ckpt_2", "gen_model.zip"),
               SEED)
    t2 = trainer(resume=True)
    assert t2.steps == 0 and int(t2.state.it) == 0


def test_structure_and_topology_mismatches_are_value_errors(tmp_path):
    d = str(tmp_path)
    ck = TrainCheckpointer(d)
    ck.save(2, {"dis": _graph()}, extra=_extra(),
            mesh_spec=mesh_spec_dict(2))
    with pytest.raises(ValueError, match="graphs"):
        ck.restore({"gen": MT.build_generator(device="cpu")})
    with pytest.raises(ValueError, match="structure"):
        ck.restore({"dis": MT.build_generator(device="cpu")})
    # a checkpoint from another world reshards onto the target (the
    # elastic restore); the mismatch error is left for a program that
    # cannot take another world up (roadmap_main's pair)
    step, extra = ck.restore({"dis": _graph()},
                             target_mesh=mesh_spec_dict(1))
    assert step == 2 and extra["__reshard__"]["from"] == mesh_spec_dict(2)
    assert extra["__reshard__"]["to"] == mesh_spec_dict(1)
    assert issubclass(CheckpointMeshMismatchError, ValueError)
    step, extra = ck.restore({"dis": _graph()},
                             target_mesh=mesh_spec_dict(2))
    assert step == 2 and "__reshard__" not in extra


# -- async, prune --------------------------------------------------------------

def test_async_saves_are_byte_identical_to_sync(tmp_path):
    g = _graph()
    TrainCheckpointer(str(tmp_path / "sync")).save(3, {"dis": g},
                                                   extra=_extra())
    with AsyncCheckpointer(TrainCheckpointer(str(tmp_path / "async"))) as ack:
        ack.save(3, {"dis": g}, extra=_extra())
        assert ack.latest_step() == 3 and ack.verify(3)  # reads barrier
        assert ack.restore({"dis": _graph()})[0] == 3
    for name in os.listdir(tmp_path / "sync" / "ckpt_3"):
        assert ((tmp_path / "sync" / "ckpt_3" / name).read_bytes()
                == (tmp_path / "async" / "ckpt_3" / name).read_bytes())


def test_async_checkpointer_surfaces_a_worker_fault(tmp_path):
    g = _graph()
    ack = AsyncCheckpointer(TrainCheckpointer(str(tmp_path)))

    def hook(event):
        if event.startswith("wrote:"):
            raise InjectedCrash(event)

    ck_mod._chaos_hook = hook
    try:
        ack.save(2, {"dis": g}, extra=_extra())
        with pytest.raises(InjectedCrash):
            ack.wait()
    finally:
        ck_mod._chaos_hook = None
    ack.save(4, {"dis": g}, extra=_extra())  # still usable
    ack.close()
    assert TrainCheckpointer(str(tmp_path)).latest_verified_step() == 4


def test_prune_keep_and_prune_above(tmp_path):
    ck = TrainCheckpointer(str(tmp_path), keep=2)
    g = MT.build_discriminator(device="cpu")
    for s in (1, 2, 3):
        ck.save(s, {"dis": g}, extra={"note": "x", "arr": np.arange(3)})
    assert ck.steps() == [2, 3]
    g2 = MT.build_discriminator(MT.InsuranceConfig(seed=5), device="cpu")
    step, extra = ck.restore({"dis": g2})
    assert step == 3 and extra["note"] == "x"
    for layer, lp in g.params.items():
        for n, v in lp.items():
            assert torch.equal(v, g2.params[layer][n])
    assert ck.prune_above(2) == [3] and ck.steps() == [2]


# -- the JAX package's format ------------------------------------------------------

def _port_run(res, iterations=2, **kw):
    """The port's insurance trainer with the EMA, checkpointing every 2."""
    t = GANTrainer(device="cpu", workload=IT.InsuranceWorkload(),
                   config=IT.default_config(
                       res_path=res, num_iterations=iterations,
                       print_every=2, save_every=2, checkpoint_every=2,
                       ema_decay=EMA, metrics=False, **kw))
    t.train(log=None)
    return t


def _jax_graphs():
    return IJ.InsuranceWorkload().build_graphs()


def _graph_trees(state: fused_step.ProtocolState):
    return {"dis": (state.dis_params, state.dis_opt),
            "gan": (state.gan_params, state.gan_opt),
            "classifier": (state.clf_params, state.clf_opt),
            "gen": (state.gen_params, None)}


def _assert_tree_equal(jtree, ttree):
    assert set(jtree) == set(ttree)
    for layer, lp in ttree.items():
        assert set(jtree[layer]) == set(lp), layer
        for n, t in lp.items():
            np.testing.assert_array_equal(np.asarray(jtree[layer][n]),
                                          t.detach().numpy(), err_msg=n)


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    """A port checkpoint (insurance, with the EMA) restores in the JAX
    ``TrainCheckpointer`` with params, updater state, softening, EMA and
    data position bit-equal; the JAX trainer's own resume takes it."""
    d = str(tmp_path)
    t = _port_run(d)
    graphs = _jax_graphs()
    step, extra = JCheckpointer(os.path.join(d, "checkpoints")).restore(graphs)
    assert step == 2
    for name, (params, opt) in _graph_trees(t.state).items():
        _assert_tree_equal(graphs[name].params, params)
        if opt is not None:
            _assert_tree_equal(graphs[name].opt_state, opt)
    for k in ("soften_real", "soften_fake"):
        np.testing.assert_array_equal(np.asarray(extra[k]),
                                      getattr(t, k).numpy())
    ema = {}
    for k, v in extra.items():
        if k.startswith("ema:"):
            _, layer, n = k.split(":", 2)
            ema.setdefault(layer, {})[n] = v
    _assert_tree_equal(ema, {ly: lp for ly, lp in t.state.ema_gen.items()
                             if lp})
    assert json.loads(extra["iter_state"]) == t.train_iter.state_for_step(2)
    # the JAX trainer resumes from it and ignores z_gen_state
    tj = GJ.GANTrainer(IJ.InsuranceWorkload(), IJ.default_config(
        num_iterations=2, res_path=d, resume=True, metrics=False,
        ema_decay=EMA, events=False, n_devices=1))
    it = IterJ(os.path.join(d, "insurance_train.csv"), 50, 12, 1)
    tj._maybe_resume(it)
    assert tj.batch_counter == 2 and it.state() == t.train_iter.state_for_step(2)
    np.testing.assert_array_equal(np.asarray(tj.soften_real),
                                  t.soften_real.numpy())


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's insurance trainer, 2 steps with the EMA and a
    checkpoint at 2."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    tj = GJ.GANTrainer(IJ.InsuranceWorkload(), IJ.default_config(
        num_iterations=2, res_path=d, print_every=2, save_every=2,
        checkpoint_every=2, ema_decay=EMA, metrics=False, events=False,
        n_devices=1))
    tj.train(log=lambda s: None)
    return d, tj


def test_jax_checkpoint_restores_in_the_port(jax_run):
    """A JAX checkpoint resumes in the port's trainer with params, updater
    state, softening, EMA and data position bit-equal, the step counter
    at 2 and the latent generator replayed to step 2."""
    d, tj = jax_run
    t = GANTrainer(device="cpu", workload=IT.InsuranceWorkload(),
                   config=IT.default_config(
                       res_path=d, num_iterations=4, checkpoint_every=2,
                       resume=True, ema_decay=EMA, metrics=False))
    assert t.steps == 2 and int(t.state.it) == 2
    for name, (params, opt) in _graph_trees(t.state).items():
        g = getattr(tj, name)
        _assert_tree_equal(jax.tree.map(np.asarray, g.params), params)
        if opt is not None:
            _assert_tree_equal(jax.tree.map(np.asarray, g.opt_state), opt)
    _assert_tree_equal({ly: lp for ly, lp in tj.gen.ema_params.items() if lp},
                       {ly: lp for ly, lp in t.state.ema_gen.items() if lp})
    np.testing.assert_array_equal(np.asarray(tj.soften_real),
                                  t.soften_real.numpy())
    np.testing.assert_array_equal(np.asarray(tj.soften_fake),
                                  t.soften_fake.numpy())
    with open(os.path.join(d, "checkpoints", "ckpt_2", "state.json")) as f:
        assert json.loads(json.load(f)["iter_state"]) == t.train_iter.state()
    fresh = GANTrainer(device="cpu", workload=IT.InsuranceWorkload(),
                       config=IT.default_config(res_path=d, metrics=False))
    for _ in range(2 * 2):
        torch.rand((50, 2), generator=fresh.z_gen)
    assert torch.equal(fresh.z_gen.get_state(), t.z_gen.get_state())


def test_the_same_state_writes_the_same_files(tmp_path):
    """For the same params and extras both packages write byte-equal zips,
    state.json, state.npz and MANIFEST.json; the port's own checkpoint
    differs only by its ``z_gen_state`` array."""
    d = str(tmp_path / "run")
    t = _port_run(d)
    fused_step.state_to_graphs(t.state, t.dis, t.gen, t.gan, t.classifier)
    extra = t._checkpoint_extra()
    z_state = extra.pop("z_gen_state")
    graphs_j = _jax_graphs()
    for name, g in t._graphs().items():
        graphs_j[name].params = {ly: {n: jax.numpy.asarray(v.numpy())
                                      for n, v in lp.items()}
                                 for ly, lp in g.params.items()}
        graphs_j[name].opt_state = {ly: {n: jax.numpy.asarray(v.numpy())
                                         for n, v in lp.items()}
                                    for ly, lp in g.opt_state.items()}
    extra_j = {k: (v if isinstance(v, str) else jax.numpy.asarray(v.numpy()))
               for k, v in extra.items()}
    spec = MeshSpec.from_mesh(None).to_dict()
    assert spec == mesh_spec_dict(1)
    JCheckpointer(str(tmp_path / "j")).save(2, graphs_j, extra=extra_j,
                                            mesh_spec=spec)
    TrainCheckpointer(str(tmp_path / "t")).save(2, t._graphs(), extra=extra,
                                                mesh_spec=mesh_spec_dict(1))
    files = sorted(os.listdir(tmp_path / "j" / "ckpt_2"))
    assert files == sorted(os.listdir(tmp_path / "t" / "ckpt_2")) == [
        MANIFEST_NAME, "classifier_model.zip", "dis_model.zip",
        "gan_model.zip", "gen_model.zip", "state.json", "state.npz"]
    for name in files:
        assert ((tmp_path / "j" / "ckpt_2" / name).read_bytes()
                == (tmp_path / "t" / "ckpt_2" / name).read_bytes()), name
    # the trainer's own checkpoint: the same files and manifest hashes
    # apart from state.npz, which adds z_gen_state last
    own = Path(d) / "checkpoints" / "ckpt_2"
    m_own = json.loads((own / MANIFEST_NAME).read_text())["files"]
    m_j = json.loads((tmp_path / "j" / "ckpt_2" / MANIFEST_NAME)
                     .read_text())["files"]
    assert {k: v for k, v in m_own.items() if k != "state.npz"} == {
        k: v for k, v in m_j.items() if k != "state.npz"}
    with np.load(own / "state.npz") as a, \
            np.load(tmp_path / "j" / "ckpt_2" / "state.npz") as b:
        assert a.files == b.files + ["z_gen_state"]
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["z_gen_state"], z_state.numpy())
