"""K protocol steps per call, the generator EMA, the graphed step's
bookkeeping and the unfused per-fit loop of the port, on the CPU, held
against the JAX package and against the port's own single steps.

Inputs are made with numpy (synthetic MNIST, B = 8) and the JAX side's own
latent draws are injected into the port, as tests/test_torch_slice.py
does, with its bands: step one binds (losses 1e-5 relative, params 2e-5
absolute, caches 2e-3 of each leaf's largest value plus eps); later steps,
and the state after a multi-step call, 1e-3 / 4e-3 / 5e-2 (RmsProp at
decay 1e-8 is nearly sign-SGD, so rounding differences grow).  The port
against its own other path is held bit for bit.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import test_torch_mesh as ranks
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.optim import ema as ema_jax
from gan_deeplearning4j_tpu.parallel import DataParallelGraph, data_mesh
from gan_deeplearning4j_tpu.train import fused_step as FJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.optim import ema as ema_torch
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.train import cv_main
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
    GANTrainer,
    resolve_steps_per_call,
)

REPO = Path(__file__).resolve().parents[1]
B = 8
K = 3
T = torch.from_numpy
# (loss relative, param absolute, cache relative to the leaf's max + eps)
FIRST = (1e-5, 2e-5, 2e-3)
LATER = (1e-3, 4e-3, 5e-2)
SPAWN_TIMEOUT_S = 300
MAPS = (MT.DIS_TO_GAN, MT.GAN_TO_GEN, MT.DIS_TO_CLASSIFIER)


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_state(state_j):
    """{field: numpy tree} of a JAX ProtocolState, the EMA when on."""
    out = {f: _numpy_tree(getattr(state_j, f)) for f in FT.TREES}
    if state_j.ema_gen is not None:
        out["ema_gen"] = _numpy_tree(state_j.ema_gen)
    return out


def _torch_state(state):
    return {f: interop.params_to_numpy(t) for f, t in FT.state_trees(state)}


def _carry(trees, it: int = 0, ema: bool = False) -> FT.ProtocolState:
    """A port state from {field: numpy tree}."""
    def tree(f):
        return interop.params_from_numpy(trees[f], "cpu")

    return FT.ProtocolState(*(tree(f) for f in FT.TREES), torch.tensor(it),
                            tree("ema_gen") if ema else None)


def _worst(ref, got, relative: bool) -> float:
    """Max over a {layer: {name: array}} tree of |got - ref|, absolute or
    divided by the leaf's largest |ref| plus RmsProp's eps 1e-8."""
    worst = 0.0
    for layer, lp in ref.items():
        for n, a in lp.items():
            d = float(np.abs(np.asarray(got[layer][n]) - a).max())
            if relative:
                d /= float(np.abs(a).max()) + 1e-8
            worst = max(worst, d)
    return worst


def _assert_state_within(ref, got, band, fields=FT.TREES):
    _, param_tol, cache_tol = band
    for f in fields:
        cache = f.endswith("_opt")
        d = _worst(ref[f], got[f], cache)
        assert d <= (cache_tol if cache else param_tol), f"{f}: {d}"


def _assert_trees_equal(a, b):
    for f in a:
        for layer, lp in a[f].items():
            for n, x in lp.items():
                assert np.array_equal(x, b[f][layer][n]), f"{f}.{layer}.{n}"


def _data(n_batches: int):
    feats, labels = synthetic_mnist(n_batches * B, seed=5)
    rng = np.random.RandomState(1)
    ones = np.ones((B, 1), np.float32)
    return dict(real=feats, labels=np.eye(10, dtype=np.float32)[labels],
                ones=ones,
                y_real=ones + (0.05 * rng.randn(B, 1)).astype(np.float32),
                y_fake=(0.05 * rng.randn(B, 1)).astype(np.float32))


def _jax_latents(z_key, steps: int):
    """The JAX step's own draws: z1 under fold_in(z_key, 2*it), z2 under
    fold_in(z_key, 2*it + 1)."""
    return [tuple(np.array(jax.random.uniform(
        jax.random.fold_in(z_key, 2 * it + k), (B, 2), minval=-1.0,
        maxval=1.0)) for k in (0, 1)) for it in range(steps)]


def _jax_graphs():
    dis = MJ.build_discriminator()
    return dis, MJ.build_generator(), MJ.build_gan(), MJ.build_classifier(dis)


def _torch_graphs():
    dis = MT.build_discriminator(device="cpu")
    return (dis, MT.build_generator(device="cpu"), MT.build_gan(device="cpu"),
            MT.build_classifier(dis))


def _torch_step(**kw):
    return FT.make_protocol_step(*_torch_graphs(), *MAPS, z_size=2,
                                 num_features=784, **kw)


def _inputs(d):
    return [T(d[k]) for k in ("real", "labels", "y_real", "y_fake", "ones")]


# -- K steps per call and the EMA against JAX ---------------------------------

@pytest.fixture(scope="module")
def multi():
    """One K-step call of the JAX step (lax.scan, EMA at decay 0.5) and of
    the port's step from the same start on a two-batch table, with the JAX
    step's latents; the port also without the EMA."""
    graphs = _jax_graphs()
    state0 = FJ.state_from_graphs(*graphs, ema=True)
    start = _jax_state(state0)
    d = _data(2)
    z_key, rng_key = jax.random.key(3), jax.random.key(4)
    step_j = FJ.make_protocol_step(
        *graphs, MJ.DIS_TO_GAN, MJ.GAN_TO_GEN, MJ.DIS_TO_CLASSIFIER,
        z_size=2, num_features=784, donate=False, data_on_device=True,
        steps_per_call=K, ema_decay=0.5)
    state_j, losses_j = step_j(
        state0, *(jnp.asarray(d[k]) for k in ("real", "labels")), z_key,
        rng_key, *(jnp.asarray(d[k]) for k in ("y_real", "y_fake", "ones")))
    z = _jax_latents(z_key, K)
    z1, z2 = (T(np.stack([zs[k] for zs in z])) for k in (0, 1))
    out = {"jax": (_jax_state(state_j), np.stack(
        [np.asarray(v) for v in losses_j], -1), int(state_j.it))}
    for decay in (0.5, 0.0):
        state, losses = _torch_step(steps_per_call=K, ema_decay=decay)(
            _carry(start, ema=bool(decay)), *_inputs(d), z1=z1, z2=z2)
        out[decay] = (state, losses)
    return out


def test_k_step_call_tracks_jax_scan(multi):
    """One port call of K = 3 against JAX ``make_protocol_step(
    steps_per_call=3, data_on_device=True)``: each loss comes back stacked
    [3]; step one's losses within 1e-5 relative, steps two and three's
    within 1e-3, the state after the call within the later-step bands
    (params 4e-3, caches 5e-2).  Within bands, not bitwise: the JAX
    package's own multi-step program is not bitwise its single steps on
    this tree."""
    state_j, losses_j, it_j = multi["jax"]
    state_t, losses_t = multi[0.5]
    assert [tuple(v.shape) for v in losses_t] == [(K,)] * 3
    got = torch.stack(losses_t, -1).numpy()
    np.testing.assert_allclose(got[0], losses_j[0], rtol=FIRST[0])
    np.testing.assert_allclose(got[1:], losses_j[1:], rtol=LATER[0])
    assert int(state_t.it) == it_j == K
    _assert_state_within(state_j, _torch_state(state_t), LATER)


def test_ema_tracks_jax(multi):
    """The generator EMA at decay 0.5 after three steps against JAX's:
    within 4e-3 absolute, the later-step param band (the EMA mixes the
    generator params of the start and of each step, which lie within that
    band); a wrong seed (the gan graph's generator instead of gen's own
    init) or a step without the update is off by the distance between two
    inits, ~1e-1."""
    state_j = multi["jax"][0]
    got = _torch_state(multi[0.5][0])
    assert _worst(state_j["ema_gen"], got["ema_gen"], False) <= LATER[1]


def test_ema_off_leaves_the_step_alone(multi):
    """ema_decay 0: no EMA tree, and every other tree and loss is the EMA
    run's, bit for bit."""
    off, on = multi[0.0], multi[0.5]
    assert off[0].ema_gen is None and on[0].ema_gen is not None
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
    a, b = _torch_state(off[0]), _torch_state(on[0])
    assert set(a) == set(FT.TREES)
    _assert_trees_equal(a, b)


def test_ema_update_matches_jax():
    """The rule decay*e + (1-decay)*p on random trees at decay 0.9 against
    the JAX package's ema_update: within 1e-6 relative (2 ulp; the JAX
    program may contract the multiply-add)."""
    rng = np.random.RandomState(0)
    e = {"a": {"W": rng.randn(5, 3).astype(np.float32)},
         "b": {"gamma": rng.randn(7).astype(np.float32)}, "c": {}}
    p = jax.tree.map(lambda a: (a + rng.randn(*a.shape)).astype(np.float32), e)
    ref = _numpy_tree(ema_jax.ema_update(jax.tree.map(jnp.asarray, e),
                                         jax.tree.map(jnp.asarray, p), 0.9))
    got = ema_torch.ema_update(interop.params_from_numpy(e, "cpu"),
                               interop.params_from_numpy(p, "cpu"), 0.9)
    assert set(got) == set(ref) and got["c"] == {}
    for layer, lp in ref.items():
        for n, a in lp.items():
            np.testing.assert_allclose(got[layer][n].numpy(), a, rtol=1e-6)


def test_ema_init_returns_fresh_buffers():
    """ema_init copies: no EMA leaf shares storage with a live param; a
    generator that carries ``ema_params`` seeds from those."""
    gen = MT.build_generator(device="cpu")
    ema = ema_torch.ema_init(gen)
    live = {t.data_ptr() for lp in gen.params.values() for t in lp.values()}
    for layer, lp in ema.items():
        for n, t in lp.items():
            assert t.data_ptr() not in live
            assert torch.equal(t, gen.params[layer][n])
    gen.ema_params = {layer: {n: t + 1 for n, t in lp.items()}
                      for layer, lp in ema.items()}
    again = ema_torch.ema_init(gen)
    assert torch.equal(again["gen_conv2d_8"]["W"],
                       gen.ema_params["gen_conv2d_8"]["W"])
    assert (again["gen_conv2d_8"]["W"].data_ptr()
            != gen.ema_params["gen_conv2d_8"]["W"].data_ptr())


# -- K steps per call against the port's single steps -------------------------

def test_k_step_call_equals_single_calls_bitwise():
    """One call of K = 4 against four calls of one, from one start, with
    latents from two generators of one seed, on a three-batch table (the
    fourth step wraps to batch 0): the same losses and state, bit for bit,
    the EMA (decay 0.9) and the step counter included."""
    d = _data(3)
    graphs = _torch_graphs()
    start = FT.state_from_graphs(*graphs, ema=True)
    multi_step = FT.make_protocol_step(*graphs, *MAPS, z_size=2,
                                       num_features=784, steps_per_call=4,
                                       ema_decay=0.9)
    single = FT.make_protocol_step(*graphs, *MAPS, z_size=2, num_features=784,
                                   ema_decay=0.9)
    gens = [torch.Generator().manual_seed(9) for _ in range(2)]
    s4, l4 = multi_step(FT.clone_state(start), *_inputs(d), z_gen=gens[0])
    s1, l1 = FT.clone_state(start), []
    for _ in range(4):
        s1, losses = single(s1, *_inputs(d), z_gen=gens[1])
        l1.append(torch.stack(losses))
    assert torch.equal(torch.stack(l4, -1), torch.stack(l1))
    assert int(s4.it) == int(s1.it) == 4
    _assert_trees_equal(_torch_state(s1), _torch_state(s4))


@pytest.mark.parametrize("world", [1, 2])
def test_batch_rows_match_jax_slices(world):
    """The device-counter gather against the JAX step's
    ``dynamic_slice_in_dim(table, (it % n_batches) * B + rank * B/world,
    B/world)``, for every rank and steps 0-6 of a three-batch table (plus
    a partial batch the floor division drops): the same rows, exactly."""
    table = np.arange(27 * 3, dtype=np.float32).reshape(27, 3)
    bl = B // world
    for it in range(7):
        for rank in range(world):
            rows = FT.batch_rows(torch.tensor(it), 27, B, rank, world)
            ref = lax.dynamic_slice_in_dim(
                jnp.asarray(table), (it % 3) * B + rank * bl, bl)
            np.testing.assert_array_equal(T(table).index_select(0, rows),
                                          np.asarray(ref))


# -- the trainer's configuration -----------------------------------------------

@pytest.mark.parametrize("iterations,cap,expected,warns", [
    (20, None, 20, False), (250, None, 50, False), (20, 8, 5, True),
    (7, 4, 1, True), (20, 10, 10, False)])
def test_resolve_steps_per_call(caplog, iterations, cap, expected, warns):
    """The largest K <= cap (100, or the explicit value) dividing the run;
    an explicit value that is reduced logs a warning."""
    with caplog.at_level(logging.WARNING):
        assert resolve_steps_per_call(iterations, cap) == expected
    assert any("reduced to" in r.message for r in caplog.records) == warns


@pytest.mark.parametrize("kwargs,match", [
    ({"ema_decay": 1.0}, r"ema_decay must be in \[0, 1\)"),
    ({"ema_decay": -0.1}, r"ema_decay must be in \[0, 1\)"),
    ({"ema_decay": 0.5, "fused": False}, "requires the fused step"),
    ({"ema_decay": 0.5, "dp_mode": "param_averaging"},
     "requires the fused step"),
    ({"dp_mode": "hogwild"}, "unknown dp_mode"),
    ({"steps_per_call": 0}, "steps_per_call")])
def test_trainer_refuses_bad_options(kwargs, match):
    with pytest.raises(ValueError, match=match):
        GANTrainer(batch_size=4, n_train=8, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [{"chunk_indexed": True},
                                    {"telemetry": True}])
def test_step_refuses_what_is_not_ported(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        FT.make_protocol_step(None, None, None, None, [], [], [], 2, 784,
                              **kwargs)


# -- the graphed step's bookkeeping on the CPU ---------------------------------

def test_graphed_launch_counts_on_a_stub():
    """The counters' graphed mode: the launches a capture records are
    taken back off the counters and counted once per replay."""
    class StubGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    before = kernels.launch_counts()
    try:
        with kernels.captured_launches() as per_replay:
            kernels.WRAPPERS["fused_update"].launches += 3
            kernels.WRAPPERS["bn_act"].launches += 3
            kernels.WRAPPERS["upsample_bwd"].launches += 2
        assert kernels.launch_counts() == before
        assert per_replay == {**{k: 0 for k in before}, "fused_update": 3,
                              "bn_act": 3, "upsample_bwd": 2}
        graph = StubGraph()
        FT.replay(graph, 10, per_replay)
        assert graph.replays == 10
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: 10 * n for k, n in per_replay.items()}
    finally:
        for name, fn in kernels.WRAPPERS.items():
            fn.launches = before[name]


def test_graph_body_matches_eager_steps():
    """What the CUDA graph records, run on the CPU: five steps of
    ``graph_body`` on one static state with a ring of 3 loss rows give the
    eager steps' bits — each step's losses in row it % 3, the new state
    copied into the static buffers (which keep their storage), the EMA and
    the counter included."""
    d = _data(2)
    graphs = _torch_graphs()
    start = FT.state_from_graphs(*graphs, ema=True)
    step = FT.make_protocol_step(*graphs, *MAPS, z_size=2, num_features=784,
                                 ema_decay=0.9)
    static = FT.clone_state(start)
    ptrs = {k: t.data_ptr() for k, t in FT._leaves(static).items()}
    ring = torch.zeros((3, 3))
    gens = [torch.Generator().manual_seed(2) for _ in range(2)]
    eager, rows = FT.clone_state(start), []
    for it in range(5):
        FT.graph_body(step, _inputs(d), gens[0], 3, static, ring)
        eager, losses = step(eager, *_inputs(d), z_gen=gens[1])
        rows.append(torch.stack(losses))
        assert torch.equal(ring[it % 3], rows[-1])
    assert int(static.it) == 5
    assert {k: t.data_ptr() for k, t in FT._leaves(static).items()} == ptrs
    _assert_trees_equal(_torch_state(eager), _torch_state(static))


def test_copy_state_refuses_crossed_leaves():
    """A source leaf that is another place's destination would make the
    copies depend on their order: refused."""
    state = FT.state_from_graphs(*_torch_graphs())
    dst = FT.clone_state(state)
    src = FT.clone_state(state)
    src.dis_params["dis_conv2d_layer_2"]["b"] = dst.dis_params[
        "dis_conv2d_layer_4"]["b"]
    with pytest.raises(ValueError, match="destination"):
        FT.copy_state_(dst, src)


# -- the unfused per-fit loop ---------------------------------------------------

def test_unfused_loop_equals_fused_step_bitwise():
    """On one device the per-fit loop (dis.fit, sync, gan.fit, sync, sync,
    classifier.fit) gives the fused step's bits over three steps: the same
    batches, the same latents from the same generator, the same order."""
    fused = GANTrainer(batch_size=B, n_train=2 * B, device="cpu")
    unfused = GANTrainer(batch_size=B, n_train=2 * B, device="cpu", fused=False)
    rf, ru = fused.train(3, log=None), unfused.train(3, log=None)
    assert (rf["fused"], ru["fused"], rf["steps_per_call"]) == (True, False, 3)
    assert [rf[k] for k in ("d_loss", "g_loss", "clf_loss")] == [
        ru[k] for k in ("d_loss", "g_loss", "clf_loss")]
    got = FT.state_from_graphs(unfused.dis, unfused.gen, unfused.gan,
                               unfused.classifier)
    _assert_trees_equal(_torch_state(fused.state), _torch_state(got))


def _unfused_jax(fits, graphs, d, z):
    """The JAX trainer's unfused loop (gan_trainer.py:2129-2150) with
    injected latents -> per step ({field: numpy tree}, losses)."""
    dis, gen, gan, clf = graphs
    fit_dis, fit_gan, fit_clf = fits
    y_dis = jnp.concatenate([jnp.asarray(d["y_real"]), jnp.asarray(d["y_fake"])])
    out = []
    for it, (z1, z2) in enumerate(z):
        sl = slice((it % 2) * B, (it % 2 + 1) * B)
        real, labels = jnp.asarray(d["real"][sl]), jnp.asarray(d["labels"][sl])
        fake = gen.output(jnp.asarray(z1))[0].reshape(B, 784)
        dl = fit_dis(jnp.concatenate([real, fake]), y_dis)
        MJ.sync_params(gan, dis, MJ.DIS_TO_GAN)
        gl = fit_gan(jnp.asarray(z2), jnp.asarray(d["ones"]))
        MJ.sync_params(gen, gan, MJ.GAN_TO_GEN)
        MJ.sync_params(clf, dis, MJ.DIS_TO_CLASSIFIER)
        cl = fit_clf(real, labels)
        out.append((_jax_state(FJ.state_from_graphs(dis, gen, gan, clf)),
                    [float(dl), float(gl), float(cl)]))
    return out


def _assert_tracks(ref_steps, got_steps, bands=(FIRST, LATER, LATER)):
    """Step i's losses and state within ``bands[i]``."""
    assert len(ref_steps) == len(got_steps) <= len(bands)
    for (s_ref, l_ref), (s_got, l_got), band in zip(ref_steps, got_steps,
                                                    bands):
        np.testing.assert_allclose(l_got, l_ref, rtol=band[0])
        _assert_state_within(s_ref, s_got, band)


def test_unfused_loop_tracks_jax_fits():
    """The port trainer's per-fit loop on one device against the JAX
    graphs driven by dis.fit / sync_params / gan.fit / classifier.fit, with
    the JAX package's latents, over three steps: step one within the
    binding bands (losses 1e-5 relative, params 2e-5 absolute, caches 2e-3
    of each leaf's largest value plus eps), steps two and three within the
    later ones (1e-3 / 4e-3 / 5e-2)."""
    graphs = _jax_graphs()
    d = _data(2)
    z = _jax_latents(jax.random.key(3), 3)
    payload = dict(d, state=_jax_state(FJ.state_from_graphs(*graphs)), z=z)
    ref = _unfused_jax([g.fit for g in (graphs[0], graphs[2], graphs[3])],
                       graphs, d, z)
    _assert_tracks(ref, ranks.unfused_trainer_job(None, payload)["steps"])


# param_averaging over two ranks against JAX, per step.  Step one: losses
# 1e-5 relative, the binding band; params 1e-4 absolute and caches 5e-2,
# test_torch_dp.py's bands for DataParallelGraph's param_averaging against
# JAX: each rank steps on 4-8 rows, where more gradient elements sit near
# 0, on RmsProp's linear part (slope lr/sqrt(eps) = 40), and the average of
# two such steps carries their rounding (measured here: 4.6e-5 and 1.1e-2);
# a missed or wrong average moves elements by a learning rate, 2e-3.  Step
# two: losses 1e-3, the later band; params 8e-3, two generator learning
# rates (an element near 0 may flip its sign on either step), and caches
# 1e-1 (measured: 4.2e-3 and 5.4e-2).
PA_BANDS = ((1e-5, 1e-4, 5e-2), (1e-3, 8e-3, 1e-1))


def _spread_generators(graphs, scale: float = 30.0) -> None:
    """Scale the last conv W of the JAX gen and gan graphs' generators by
    ``scale``.  At init the generator's output is 0.50 +- 0.02 (variance
    2.8e-5); a batch of fakes alone, as param_averaging's rank 1 gets in
    the D-step, then has a BN variance that E[x^2] - E[x]^2 cancels to
    ~1e-3 relative in f32, in either package (the JAX value was 3% off the
    f64 one): a property of the reference's formula on that input, which
    moves the losses by ~4e-4.  Scaled, the fakes spread over the sigmoid
    and the comparison holds the code, not that cancellation."""
    for g, layer in ((graphs[1], "gen_conv2d_8"), (graphs[2], "gan_conv2d_8")):
        g.params = {**g.params, layer: {**g.params[layer],
                                        "W": g.params[layer]["W"] * scale}}


def test_param_averaging_trainer_matches_jax(cpu_devices):
    """Two gloo ranks of the trainer with ``fused=False,
    dp_mode="param_averaging"`` against the JAX graphs fit through
    ``DataParallelGraph(mode="param_averaging")`` on data_mesh(2), with the
    JAX package's latents, over two steps: the D-step's [real; fake] splits
    into rank 0's real rows and rank 1's fake rows, each rank steps
    locally (BN on its own rows) and params and caches are averaged after
    every fit.  Each step within PA_BANDS (step one: losses 1e-5 relative,
    params 1e-4 absolute, caches 5e-2; step two: 1e-3 / 8e-3 / 1e-1; the
    reasons stand beside PA_BANDS); after each average the ranks' states
    are equal, bit for bit, and no rank imported jax.  The
    generators' output is spread first (``_spread_generators``)."""
    graphs = _jax_graphs()
    _spread_generators(graphs)
    d = _data(2)
    z = _jax_latents(jax.random.key(3), 2)
    payload = dict(d, state=_jax_state(FJ.state_from_graphs(*graphs)), z=z)
    got = mesh.spawn(ranks.unfused_trainer_job, 2, (payload,), device="cpu",
                     timeout=SPAWN_TIMEOUT_S)
    fits = [DataParallelGraph(g, mesh=data_mesh(2), mode="param_averaging",
                              averaging_frequency=2).fit
            for g in (graphs[0], graphs[2], graphs[3])]
    ref = _unfused_jax(fits, graphs, d, z)
    assert [r["jax_modules"] for r in got] == [[], []]
    for r in got:
        _assert_tracks(ref, r["steps"], PA_BANDS)
    for (s0, l0), (s1, l1) in zip(got[0]["steps"], got[1]["steps"]):
        assert l0 == l1
        _assert_trees_equal(s0, s1)


# -- the CLI --------------------------------------------------------------------

def test_cv_main_steps_per_call_and_ema_on_cpu(capsys, tmp_path):
    """--steps-per-call 2 --ema-decay 0.9: four steps in two calls, each
    step logged, the JSON line says so."""
    result = cv_main.main(["--iterations", "4", "--batch-size", "8",
                           "--n-train", "32", "--device", "cpu",
                           "--steps-per-call", "2", "--ema-decay", "0.9",
                           "--res-path", str(tmp_path), "--n-test", "16",
                           "--fid-samples", "64"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == result
    assert (result["steps"], result["steps_per_call"], result["ema_decay"],
            result["graphed"], result["fused"]) == (4, 2, 0.9, False, True)
    assert sum(line.startswith("step ") for line in out) == 4
    assert all(np.isfinite([result["d_loss"], result["g_loss"],
                            result["clf_loss"]]))


def test_cv_main_param_averaging_two_ranks_on_cpu(tmp_path):
    """--n-devices 2 --dp-mode param_averaging: two gloo ranks run the
    unfused per-fit loop; rank 0 prints its steps and the JSON line."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.train.cv_main",
         "--n-devices", "2", "--device", "cpu", "--iterations", "2",
         "--batch-size", "8", "--n-train", "64", "--dp-mode",
         "param_averaging", "--averaging-frequency", "2",
         "--res-path", str(tmp_path), "--n-test", "16",
         "--fid-samples", "64"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    assert (result["world"], result["steps"], result["fused"],
            result["dp_mode"], result["backend"]) == (
        2, 2, False, "param_averaging", "gloo")
    assert all(np.isfinite([result["d_loss"], result["g_loss"],
                            result["clf_loss"]]))
    assert sum(line.startswith("step ") for line in lines) == 2
