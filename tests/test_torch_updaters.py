"""DL4J's Sgd, Nesterovs and AdaGrad updaters in the port (``optim/sgd.py``,
``optim/adagrad.py``) against the JAX package's, on the CPU.

Covered: each updater, bare and under ``Scheduled`` (an exponential
schedule), through ``GraphUpdater`` (L2 on W, elementwise clip) over 3
updates of a small leaf tree: params and updater state within 1e-6 of
each leaf's largest value (XLA's and torch's rsqrt differ by an ulp, which
AdaGrad's small params show as more than 1e-6 of themselves), the state's
dtypes and shapes the JAX ones; and a model zip whose layers
name each updater (refused before the port had them), read by the port
and written back byte-equal to the JAX package's zip of the same graph.
"""

import dataclasses
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_deeplearning4j_tpu.graph import serialization as SJ
from gan_deeplearning4j_tpu.models import mlpgan_insurance as MJ
from gan_deeplearning4j_tpu.optim import schedules as SchedJ
from gan_deeplearning4j_tpu.optim.adagrad import AdaGrad as AdaGradJ
from gan_deeplearning4j_tpu.optim.sgd import Nesterovs as NesterovsJ
from gan_deeplearning4j_tpu.optim.sgd import Sgd as SgdJ
from gan_deeplearning4j_tpu.optim.updater import GraphUpdater as UpdJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.graph import serialization as ST
from gan_deeplearning4j_tpu_torch.optim import AdaGrad, Nesterovs, Sgd
from gan_deeplearning4j_tpu_torch.optim import schedules as SchedT
from gan_deeplearning4j_tpu_torch.optim.updater import GraphUpdater as UpdT

RTOL = 1e-6
# (port, JAX) pairs with non-default rates; the defaults are DL4J's
UPDATERS = {
    "Sgd": (Sgd(0.05), SgdJ(0.05)),
    "Nesterovs": (Nesterovs(0.05, 0.8), NesterovsJ(0.05, 0.8)),
    "AdaGrad": (AdaGrad(0.05, 1e-6), AdaGradJ(0.05, 1e-6)),
}


def _scheduled(pair):
    t, j = pair
    return (SchedT.Scheduled(t, SchedT.ExponentialSchedule(0.05, 0.9)),
            SchedJ.Scheduled(j, SchedJ.ExponentialSchedule(0.05, 0.9)))


def test_dl4j_defaults():
    assert Sgd() == Sgd(0.1) and dataclasses.asdict(Sgd()) == \
        dataclasses.asdict(SgdJ())
    assert dataclasses.asdict(Nesterovs()) == dataclasses.asdict(NesterovsJ())
    assert dataclasses.asdict(AdaGrad()) == dataclasses.asdict(AdaGradJ())


def _leaf_close(ref, got, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _leaf_close(ref[k], got[k], f"{path}/{k}")
        return
    a, b = np.asarray(ref), got.detach().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
    np.testing.assert_allclose(b, a, rtol=0, err_msg=path,
                               atol=RTOL * float(np.abs(a).max(initial=0.0)))


@pytest.mark.parametrize("scheduled", [False, True], ids=["bare", "scheduled"])
@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_matches_jax_over_three_updates(name, scheduled):
    ut, uj = _scheduled(UPDATERS[name]) if scheduled else UPDATERS[name]
    rng = np.random.RandomState(5)
    params = {"dense": {"W": rng.randn(6, 5).astype(np.float32),
                        "b": rng.randn(5).astype(np.float32)},
              "bn": {"gamma": (rng.rand(5) + 0.5).astype(np.float32)}}
    up_t = UpdT({"dense": ut, "bn": ut}, l2=1e-3, clip_threshold=1.5)
    up_j = UpdJ({"dense": uj, "bn": uj}, l2=1e-3, clip_threshold=1.5)
    pj = jax.tree.map(jnp.asarray, params)
    pt = interop.params_from_numpy(params, "cpu")
    sj, st = up_j.init(pj), up_t.init(pt)
    _leaf_close(jax.tree.map(np.asarray, sj), st)
    for step in range(3):
        g = jax.tree.map(lambda p: (rng.randn(*p.shape) * 2).astype(
            np.float32), params)
        pj, sj = up_j.apply(pj, jax.tree.map(jnp.asarray, g), sj)
        pt, st = up_t.apply(pt, interop.params_from_numpy(g, "cpu"), st)
        _leaf_close(jax.tree.map(np.asarray, pj), pt, f"params@{step}")
        _leaf_close(jax.tree.map(np.asarray, sj), st, f"state@{step}")


def _with_updaters(graph, kind):
    """``graph`` with every trained layer's updater set to ``kind`` (bare
    or under ``Scheduled``) in either package."""
    for node in graph.nodes.values():
        if node.layer.updater is not None:
            node.layer = dataclasses.replace(node.layer, updater=kind)
    graph.updater.layer_updaters = {
        k: kind for k in graph.updater.layer_updaters}
    graph.opt_state = graph.updater.init(graph.params)
    return graph


@pytest.mark.parametrize("scheduled", [False, True], ids=["bare", "scheduled"])
@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_a_zip_naming_the_updater_reads_and_writes_back(tmp_path, name,
                                                        scheduled):
    """The JAX package's zip of the insurance generator with ``name`` on every
    trained layer, after one update: the port reads it (the updater and
    its state) and writes it back byte-equal."""
    ut, uj = _scheduled(UPDATERS[name]) if scheduled else UPDATERS[name]
    gj = _with_updaters(MJ.build_generator(), uj)
    rng = np.random.RandomState(8)
    g = jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32)), gj.params)
    params, opt = gj.updater.apply(gj.params, g, gj.opt_state)
    # one key order on both sides (a jitted step sorts its trees)
    gj.params = jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, params))
    gj.opt_state = jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, opt))
    zj, zt = tmp_path / "j.zip", tmp_path / "t.zip"
    SJ.write_model(gj, str(zj))
    gt = ST.read_model(str(zj), "cpu")
    kinds = {type(u).__name__ for u in gt.updater.layer_updaters.values()}
    assert kinds == {type(ut).__name__}
    assert set(gt.updater.layer_updaters.values()) == {ut}
    ST.write_model(gt, str(zt))
    assert zt.read_bytes() == zj.read_bytes()
    with zipfile.ZipFile(zt) as zf:
        assert f'"__type__": "{name}"' in zf.read("config.json").decode()
    # and the port's state takes the next update as the JAX state does
    g2 = jax.tree.map(lambda p: (rng.randn(*p.shape)).astype(np.float32),
                      jax.tree.map(np.asarray, gj.params))
    pj, sj = gj.updater.apply(gj.params, jax.tree.map(jnp.asarray, g2),
                              gj.opt_state)
    pt, st = gt.updater.apply(gt.params, interop.params_from_numpy(g2, "cpu"),
                              gt.opt_state)
    _leaf_close(jax.tree.map(np.asarray, pj), pt, "params")
    _leaf_close(jax.tree.map(np.asarray, sj), st, "state")
