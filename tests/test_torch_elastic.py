"""The port's elastic tier (``parallel/elastic.py``, the checkpointer's
reshard-on-restore, the trainer's elastic clamp and world-shrink resume) on
the CPU, held against the JAX package's ``parallel/elastic.py`` and
``tests/test_elastic.py``:

* ``MeshSpec`` dicts and ``describe``, and the four iterator-state
  functions, equal to JAX's on the same inputs;
* the reshard matrix at worlds 1, 2 and 4: params, updater state and the
  iterator state bit-equal after the restore, ``__reshard__`` present
  exactly when the topology differs;
* a restore without a target loads any world's checkpoint (the port forms
  every world on any host), a serving engine on one card hot-swaps a
  world-2 checkpoint, and a checkpoint from before the elastic format
  loads as before;
* the clamp: ``n_devices`` above the attached cards re-forms over the
  largest batch divisor that fits (``elastic``), and a count that never
  divides the batch raises on every host;
* an insurance run at world 2 over gloo loses a rank to ``shrink_world``;
  ``spawn_with_recovery`` re-forms it at world 1, the restore reshards the
  world-2 checkpoint, and the run finishes with its losses at every step
  within 5% of a world-2 control.

The module imports torch and the port at its top, and jax only inside the
tests that compare with it: its rank job is spawned, and a spawned rank
imports the module its function lives in.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
    TrainCheckpointer,
    mesh_spec_dict,
)
from gan_deeplearning4j_tpu_torch.parallel import elastic
from gan_deeplearning4j_tpu_torch.parallel import fleet as pfleet
from gan_deeplearning4j_tpu_torch.testing import ChaosInjector
from gan_deeplearning4j_tpu_torch.train import gan_trainer
from gan_deeplearning4j_tpu_torch.train import insurance_main as IT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
    GANTrainer,
    resolve_n_devices,
)

SEED = 666
WORLDS = (1, 2, 4)
SPAWN_TIMEOUT_S = 240.0
# the losses' band against the world-2 control (JAX's
# test_device_loss_8_to_4_resumes_finishes_banded)
BAND = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's CPU ops on one thread while this module runs (the tier-1
    lane runs six test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- MeshSpec and the iterator state against JAX's -----------------------------

def test_mesh_spec_dicts_and_describe_equal_jax(cpu_devices):
    from gan_deeplearning4j_tpu.parallel import data_mesh
    from gan_deeplearning4j_tpu.parallel import elastic as JE
    from gan_deeplearning4j_tpu.parallel import fleet as JF

    for world in WORLDS:
        jax_spec = JE.MeshSpec.from_mesh(data_mesh(world) if world > 1
                                         else None, process_count=1)
        spec = elastic.MeshSpec.from_world(world)
        assert spec.to_dict() == jax_spec.to_dict() == mesh_spec_dict(world)
        assert spec.describe() == jax_spec.describe()
        jf = JF.fleet_mesh_spec(JF.tenant_mesh(world))
        tf = pfleet.fleet_mesh_spec(pfleet.tenant_mesh(world, "cpu"))
        assert tf.to_dict() == jf.to_dict()
        assert list(tf.to_dict()["axes"]) == list(jf.to_dict()["axes"])
        assert tf.describe() == jf.describe()
        back = elastic.MeshSpec.from_dict(spec.to_dict())
        assert back == spec and back.same_topology(spec)
    assert (pfleet.fleet_mesh_spec(None).to_dict()
            == JF.fleet_mesh_spec(None).to_dict())
    assert not elastic.MeshSpec.from_world(2).same_topology(
        elastic.MeshSpec.from_world(4))
    # the data-parallel and the tenant spec of one world are not one
    # topology (other axes)
    assert not elastic.MeshSpec.from_world(2).same_topology(
        pfleet.fleet_mesh_spec(pfleet.tenant_mesh(2, "cpu")))


ITER_STATES = [
    {"epoch": 1, "cursor": 64, "shuffle": False, "shuffle_seed": 0},
    {"epoch": 2, "cursor": 128, "shuffle": True, "shuffle_seed": 7},
]
MERGES = [
    [{"epoch": 2, "cursor": 10}, {"epoch": 1, "cursor": 900},
     {"epoch": 2, "cursor": 0}],
    [{"epoch": 0, "cursor": 5, "shuffle": True, "shuffle_seed": 3}] * 3,
    [{"epoch": 0, "cursor": 0, "shuffle": True, "shuffle_seed": 1},
     {"epoch": 0, "cursor": 0, "shuffle": True, "shuffle_seed": 2}],
]


def _same(fn_t, fn_j, *args):
    """fn_t(*args) == fn_j(*args), raising alike."""
    try:
        want = fn_j(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            fn_t(*args)
        return None
    got = fn_t(*args)
    assert got == want
    return got


@pytest.mark.parametrize("state", ITER_STATES)
def test_iter_state_functions_equal_jax(state):
    from gan_deeplearning4j_tpu.parallel import elastic as JE

    for hosts in (0, 1, 2, 4, 8):
        if hosts:
            packed = _same(elastic.pack_iter_state, JE.pack_iter_state,
                           state, hosts)
            assert (elastic.is_packed_iter_state(packed)
                    == JE.is_packed_iter_state(packed) == (hosts > 1))
            for new in (1, 2, 3, 8):
                for pid in range(new):
                    _same(elastic.unpack_iter_state, JE.unpack_iter_state,
                          packed, new, pid)
        _same(elastic.split_iter_state, JE.split_iter_state, state, hosts)
    for states in MERGES:
        _same(elastic.merge_iter_states, JE.merge_iter_states, states)
        _same(elastic.merge_iter_states, JE.merge_iter_states, states[::-1])
    _same(elastic.merge_iter_states, JE.merge_iter_states, [])


# -- the reshard matrix ---------------------------------------------------------

def _cfg(res_path, **kw):
    base = dict(res_path=str(res_path), batch_size=16, num_iterations=2,
                checkpoint_every=2, print_every=100, save_every=100,
                metrics=False, steps_per_call=1)
    base.update(kw)
    return IT.default_config(**base)


def _graphs():
    return IT.InsuranceWorkload().build_graphs(torch.device("cpu"))


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(tree)
    return out


def _bitequal(a, b, label):
    la, lb = _leaves(a, []), _leaves(b, [])
    assert len(la) == len(lb), label
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), label


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One insurance run's checkpoint at step 2 (graphs and extras), the
    source the matrix re-saves under each world's spec."""
    d = tmp_path_factory.mktemp("trained")
    t = GANTrainer(device="cpu", config=_cfg(d),
                   workload=IT.InsuranceWorkload())
    t.train(log=None)
    graphs = _graphs()
    ck = TrainCheckpointer(os.path.join(str(d), "checkpoints"))
    step, extra = ck.restore(graphs)
    assert step == 2 and "iter_state" in extra
    return graphs, extra


@pytest.mark.parametrize("save_n", WORLDS)
def test_reshard_roundtrip_matrix(tmp_path, trained, save_n):
    """Saved under a world of ``save_n``, restored under each of 1, 2 and
    4: params and updater state bit-equal to a same-world restore, the
    iterator state and the softening untouched, ``__reshard__`` (from,
    to, seconds) present exactly when the topology changed."""
    src, extra = trained
    world_state = elastic.pack_iter_state(json.loads(extra["iter_state"]),
                                          save_n)
    extra = {**extra, "iter_state": json.dumps(world_state, sort_keys=True)}
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(2, src, extra=extra, mesh_spec=mesh_spec_dict(save_n))
    assert ck.mesh_spec(2)["device_count"] == save_n
    ref = _graphs()
    step, ref_extra = ck.restore(ref, target_mesh=mesh_spec_dict(save_n))
    assert step == 2 and "__reshard__" not in ref_extra
    for restore_n in WORLDS:
        graphs = _graphs()
        step, got = ck.restore(graphs, target_mesh=mesh_spec_dict(restore_n))
        assert step == 2
        if restore_n == save_n:
            assert "__reshard__" not in got
        else:
            info = got["__reshard__"]
            assert info["from"] == mesh_spec_dict(save_n)
            assert info["to"] == mesh_spec_dict(restore_n)
            assert info["seconds"] >= 0.0
        for name in ("dis", "gen", "gan", "classifier"):
            _bitequal(ref[name].params, graphs[name].params,
                      f"{save_n}->{restore_n} {name} params")
            _bitequal(ref[name].opt_state, graphs[name].opt_state,
                      f"{save_n}->{restore_n} {name} opt_state")
        assert got["iter_state"] == ref_extra["iter_state"]
        # the restoring world's cursor: the merged (lagging) position
        assert elastic.unpack_iter_state(
            json.loads(got["iter_state"]), restore_n, 0) == json.loads(
                trained[1]["iter_state"])
        assert np.array_equal(got["soften_real"], ref_extra["soften_real"])


def test_no_target_restore_loads_any_world(tmp_path, monkeypatch):
    """A checkpoint from a world bigger than this host's cards (stubbed to
    1) restored without a target is the plain load, bit-equal, no
    ``__reshard__``: the port forms any world on any host (ranks and
    tenant shards share a card), so nothing is refused.  With a target
    the same checkpoint reports the reshard, which moves no bytes (the
    replicated state's load places it): 0.0 seconds."""
    monkeypatch.setattr(elastic, "attached_devices", lambda device=None: 1)
    ck = TrainCheckpointer(str(tmp_path))
    src = _graphs()
    fake = elastic.MeshSpec(axes={"data": 16}, device_count=16)
    ck.save(1, src, extra={}, mesh_spec=fake.to_dict())
    plain = _graphs()
    step, extra = ck.restore(plain)
    assert step == 1 and "__reshard__" not in extra
    for name in src:
        _bitequal(src[name].params, plain[name].params, name)
        _bitequal(src[name].opt_state, plain[name].opt_state, name)
    moved = _graphs()
    step, extra = ck.restore(moved, target_mesh=mesh_spec_dict(4))
    assert step == 1 and extra["__reshard__"]["to"]["device_count"] == 4
    assert extra["__reshard__"]["from"]["device_count"] == 16
    assert extra["__reshard__"]["seconds"] == 0.0
    for name in src:
        _bitequal(src[name].params, moved[name].params, name)


def test_hotswap_serves_a_world_2_checkpoint_on_one_card(tmp_path,
                                                        monkeypatch):
    """A serving engine on a host of one card (stubbed) hot-swaps the
    generator of a checkpoint that a world of 2 wrote, by the newest-first
    walk and by an explicit step: the served params bit-equal the saved
    ones, and the engine serves them."""
    from gan_deeplearning4j_tpu_torch.parallel.inference import (
        ParallelInference,
    )
    from gan_deeplearning4j_tpu_torch.serve import ServeEngine

    monkeypatch.setattr(elastic, "attached_devices", lambda device=None: 1)
    torch.manual_seed(SEED)
    src = _graphs()
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(3, {"gen": src["gen"]}, extra={}, mesh_spec=mesh_spec_dict(2))
    for step in (None, 3):
        torch.manual_seed(SEED + 1)
        eng = ServeEngine(infer=ParallelInference(_graphs()["gen"],
                                                  buckets=(8,)),
                          supervise=False)
        assert eng.hotswap_from(str(tmp_path), step=step) == 3
        _bitequal(src["gen"].params, eng._infer.graph.params, "gen")
        z = np.random.RandomState(SEED).rand(4, 2).astype(np.float32)
        with eng:
            out = eng.generate(z, timeout=120.0)
        assert out[0].shape[0] == 4 and np.isfinite(out[0]).all()


def test_pre_elastic_checkpoint_keeps_legacy_restore(tmp_path):
    """A checkpoint with no recorded spec restores as before, with or
    without a target: no guard, no reshard."""
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(1, _graphs(), extra={})
    assert ck.mesh_spec(1) is None
    step, extra = ck.restore(_graphs())
    assert step == 1 and "__reshard__" not in extra
    step, extra = ck.restore(_graphs(), target_mesh=mesh_spec_dict(2))
    assert step == 1 and "__reshard__" not in extra


# -- the elastic clamp ------------------------------------------------------------

def test_elastic_clamp_reforms_on_shrunken_world(monkeypatch):
    """n_devices above what the host attaches (stubbed: 8) re-forms over
    the largest batch divisor that fits (elastic, the default); without
    ``elastic`` it raises."""
    monkeypatch.setattr(elastic, "attached_devices", lambda device=None: 8)
    assert resolve_n_devices(16, 16, "cpu") == 8
    assert resolve_n_devices(12, 24, "cpu") == 8  # 24's largest within 8
    assert resolve_n_devices(4, 16, "cpu") == 4  # fits: as asked
    assert gan_trainer.GANTrainerConfig.elastic
    with pytest.raises(ValueError, match="exceeds"):
        resolve_n_devices(16, 16, "cpu", elastic=False)


def test_elastic_clamp_never_legalizes_a_bad_batch_split(monkeypatch):
    """A count that never divides the batch raises on every host size,
    before the clamp."""
    for attached in (None, 4, 8, 16):
        monkeypatch.setattr(elastic, "attached_devices",
                            lambda device=None, n=attached: n)
        with pytest.raises(ValueError, match="not divisible"):
            resolve_n_devices(12, 16, "cpu")


# -- the world-shrink resume --------------------------------------------------------

# the insurance program at world 2: 6 steps, one a call, checkpoints at 2,
# 4 and 6; the device is lost at step 3
BASE = ["--device", "cpu", "--n-devices", "2", "--iterations", "6",
        "--batch-size", "10", "--checkpoint-every", "2", "--print-every", "1",
        "--save-every", "6", "--steps-per-call", "1"]
KILL_STEP = 3


def elastic_insurance_rank(group, args, config):
    """insurance_main's rank job, metrics flushed every step, under the
    ``shrink_world`` injector (``args.shrink``, its firing carried by a
    marker file); rank 0 writes its registry's scrape and /healthz after
    training (``scrape_<world>.txt``, ``health_<world>.json``)."""
    from gan_deeplearning4j_tpu_torch.utils.metrics import MetricsLogger

    gan_trainer.MetricsLogger = functools.partial(MetricsLogger,
                                                  flush_every=1)
    if group.rank == 0:
        train = GANTrainer.train

        def recorded(self, *a, **kw):
            out = train(self, *a, **kw)
            w = group.world
            with open(os.path.join(args.res_path, f"scrape_{w}.txt"),
                      "w") as f:
                f.write(self.registry.render())
            with open(os.path.join(args.res_path, f"health_{w}.json"),
                      "w") as f:
                json.dump(self.registry.health(), f, default=str)
            return out

        GANTrainer.train = recorded
    shrink = getattr(args, "shrink", None)
    if shrink is None:
        return IT._rank(group, args, config)
    with shrink:
        return IT._rank(group, args, config)


def _step_losses(res):
    out = {}
    with open(os.path.join(res, "insurance_metrics.jsonl")) as f:
        for ln in f:
            rec = json.loads(ln)
            if isinstance(rec.get("step"), int) and "d_loss" in rec:
                out[rec["step"]] = (float(rec["d_loss"]),
                                    float(rec["g_loss"]))
    return out


def test_device_loss_2_to_1_resumes_finishes_banded(tmp_path, monkeypatch):
    """A world of 2 loses a device at step 3: both ranks are failed, the
    recovery re-forms the world at the injector's ``world_size()`` (the
    elastic clamp over the attached count), the world-1 rank restores the
    world-2 checkpoint at step 2 through the reshard, and the run finishes:
    ``gan4j_reshard_total >= 1``, ``gan4j_mesh_devices`` 1, the
    ``reshard.restore`` (2 -> 1) and ``mesh.form`` events on the timeline,
    and d/g losses at every step within 5% of a world-2 control."""
    monkeypatch.setattr(IT, "_rank", elastic_insurance_rank)
    ctrl = str(tmp_path / "control")
    os.makedirs(ctrl)
    IT.run(IT.parse_args(BASE + ["--res-path", ctrl]),
           timeout=SPAWN_TIMEOUT_S)
    ela = str(tmp_path / "elastic")
    os.makedirs(ela)
    world = ChaosInjector(SEED).shrink_world(
        kill_step=KILL_STEP, before=2, after=1,
        marker=os.path.join(ela, "DEVICE_LOST"))
    # this host "attaches" what the injector says is alive
    monkeypatch.setattr(elastic, "attached_devices",
                        lambda device=None: world.world_size())
    args = IT.parse_args(BASE + ["--res-path", ela, "--max-restarts", "2"])
    args.shrink = world
    _, res = IT.run(args, timeout=SPAWN_TIMEOUT_S)
    assert world.fired and world.world_size() == 1
    assert res["steps"] == 6 and res["world"] == 1

    scrape = open(os.path.join(ela, "scrape_1.txt")).read().splitlines()
    value = {ln.split()[0]: float(ln.split()[1]) for ln in scrape
             if ln.startswith(("gan4j_reshard_total ",
                               "gan4j_mesh_devices "))}
    assert value["gan4j_reshard_total"] >= 1.0
    assert value["gan4j_mesh_devices"] == 1.0
    health = json.load(open(os.path.join(ela, "health_1.json")))
    assert health["mesh"]["devices"] == 1
    assert health["mesh"]["reshard_total"] >= 1 and health["mesh"]["ok"]

    evs = [json.loads(ln) for ln in open(os.path.join(ela, "events.jsonl"))]
    names = [e.get("name") for e in evs]
    assert "mesh.form" in names
    moved = [e for e in evs if e.get("name") == "reshard.restore"]
    assert moved and moved[0]["from_devices"] == 2
    assert moved[0]["to_devices"] == 1 and moved[0]["step"] == 2

    want, got = _step_losses(ctrl), _step_losses(ela)
    assert set(want) == set(got) == set(range(1, 7))
    for s in range(1, 7):
        for c_val, e_val in zip(want[s], got[s]):
            assert np.isfinite(e_val)
            assert abs(c_val - e_val) <= BAND * max(1.0, abs(c_val)), (
                f"step {s}: control {want[s]} vs elastic {got[s]}")
