"""The port's conditional family (cgan-cifar10) held against the JAX
package's, on the CPU, at small width (base_filters 8, z 8, batch 8, so
each D-step half is a multiple of MinibatchStdDev's group of 4).

Every random draw is the JAX side's, carried into the port: the graphs'
Xavier init through ``interop``, each iteration's batch rows (the G-step's
own rows included), latents and mode-seeking z2 derived from the JAX keys
as the JAX multistep derives them, the probe's init and the evaluation
latents.  The probe's batches come from a numpy stream both packages
share.

Covered: the multi-input layers (``Merge``, ``ElementWise``,
``ConditionalBatchNorm`` on 2-D and 4-D input in train and inference mode
with its running statistics, ``ProjectionOutput``), forward and gradient
within 1e-6 of the leaf's scale; the builders with every flag in both
states; the zips byte-equal both ways; ``synthetic_cifar10`` byte-equal;
one conditional ``GANPair`` iteration within 1e-5 (losses relative, params
absolute, Adam's m and v of the leaf's scale), three within 1e-4, with and
without the mode-seeking term; the probe's first ``fit`` step within 1e-5
and the per-class agreement equal given the JAX probe and latents; the
per-class frozen FID; the unconditional families' draw streams pinned as
they were before conditional pairs; and ``roadmap_main --family
cgan-cifar10`` on the CPU (files, result keys, checkpoint and resume equal
to a straight run).
"""

import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data import datasets as DJ
from gan_deeplearning4j_tpu.eval import conditional as CondJ
from gan_deeplearning4j_tpu.graph import layers as LJ
from gan_deeplearning4j_tpu.graph import serialization as SJ
from gan_deeplearning4j_tpu.models import cgan_cifar10 as GJ
from gan_deeplearning4j_tpu.runtime import prng as prng_j
from gan_deeplearning4j_tpu.train.gan_pair import GANPair as PairJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data import datasets as DT
from gan_deeplearning4j_tpu_torch.eval import conditional as CondT
from gan_deeplearning4j_tpu_torch.graph import layers as LT
from gan_deeplearning4j_tpu_torch.graph import serialization as ST
from gan_deeplearning4j_tpu_torch.models import cgan_cifar10 as GT
from gan_deeplearning4j_tpu_torch.models import dcgan_celeba as CT
from gan_deeplearning4j_tpu_torch.models import wgan_gp as WT
from gan_deeplearning4j_tpu_torch.train import roadmap_main as RM
from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws, GANPair
from test_torch_gan_pair import _key_draws
from test_torch_roadmap import (
    B,
    CELEBA_T,
    LOSS_TOL,
    WGAN_T,
    _assert_params_track,
    _assert_tree_close,
    _np,
    _t,
)

CGAN = dataclasses.replace(GJ.CGANConfig(), base_filters=8, z_size=8)
CGAN_T = dataclasses.replace(GT.CGANConfig(), base_filters=8, z_size=8)
K_CLASSES = 10
LAYER_TOL = 1e-6
# one conditional iteration: params within 1e-5 absolute (the noise
# elements of test_torch_roadmap's band within 2 lr), Adam's m and v within
# 1e-5 of the leaf's largest value; three iterations 1e-4
ITER_TOL = 1e-5
ITER3_TOL = 1e-4


def _onehot(labels):
    return np.eye(K_CLASSES, dtype=np.float32)[labels]


def _close(got, ref, tol=LAYER_TOL, what=""):
    """Within ``tol`` of the reference's scale (its largest magnitude)."""
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _opt_close(ref, got, tol, path=""):
    """Adam's state: m and v within ``tol`` of the leaf's largest value,
    the step count exactly."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _opt_close(ref[k], got[k], tol, f"{path}/{k}")
        return
    a, b = np.asarray(ref), got.detach().cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if a.ndim == 0:
        assert a == b, path
    else:
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=tol * (np.abs(a).max() + 1e-12),
                                   err_msg=path)


# -- the layers ------------------------------------------------------------------

def _layer_pair(name, **kw):
    return getattr(LJ, name)(**kw), getattr(LT, name)(**kw)


def _grads_both(lj, lt, params, xs, train, gy):
    """(out, param grads, input grads) of sum(out * gy) in both packages."""
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    xj = [jnp.asarray(x) for x in xs]

    def fj(p, xs_):
        y, upd = lj.apply(p, xs_, train, None)
        return jnp.sum(y * gy), (y, upd)

    (_, (yj, updj)), (gpj, gxj) = jax.value_and_grad(
        fj, argnums=(0, 1), has_aux=True)(pj, xj)
    pt = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    xt = [_t(x).requires_grad_(True) for x in xs]
    yt, updt = lt.apply(pt, xt, train, None)
    leaves = list(pt.values()) + xt
    g = torch.autograd.grad((yt * _t(gy)).sum(), leaves, allow_unused=True)
    g = [torch.zeros_like(l) if v is None else v for v, l in zip(g, leaves)]
    gpt = dict(zip(pt, g[:len(pt)]))
    return (yj, updj, gpj, gxj), (yt, updt, gpt, g[len(pt):])


def _check_layer(lj, lt, params, xs, train):
    out_j = lj.apply({k: jnp.asarray(v) for k, v in params.items()},
                     [jnp.asarray(x) for x in xs], train, None)[0]
    gy = np.random.RandomState(1).randn(*out_j.shape).astype(np.float32)
    (yj, updj, gpj, gxj), (yt, updt, gpt, gxt) = _grads_both(
        lj, lt, params, xs, train, gy)
    _close(yt, yj, what="forward")
    assert (updj is None) == (updt is None)
    if updj is not None:
        assert set(updj) == set(updt)
        for k in updj:
            _close(updt[k], updj[k], what=f"update {k}")
    for k in params:
        _close(gpt[k], gpj[k], what=f"grad {k}")
    for i, (a, b) in enumerate(zip(gxt, gxj)):
        _close(a, b, what=f"input grad {i}")


@pytest.mark.parametrize("shapes", [((5, 3), (5, 4)), ((2, 3, 4, 4),
                                                        (2, 5, 4, 4)),
                                    ((6,), (2,))])
def test_merge_matches_jax(shapes):
    lj, lt = _layer_pair("Merge")
    rng = np.random.RandomState(2)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    _check_layer(lj, lt, {}, xs, True)
    in_shapes = [s[1:] if len(s) > 1 else s for s in shapes]
    assert tuple(lt.out_shape(in_shapes)) == tuple(lj.out_shape(in_shapes))
    assert lt.multi_input and not lt.has_params


@pytest.mark.parametrize("op", ["add", "product", "subtract", "average",
                                "max"])
def test_elementwise_matches_jax(op):
    lj, lt = _layer_pair("ElementWise", op=op)
    rng = np.random.RandomState(3)
    n = 2 if op == "subtract" else 3
    xs = [rng.randn(4, 2, 3, 3).astype(np.float32) for _ in range(n)]
    _check_layer(lj, lt, {}, xs, True)
    assert lt.activation == lj.activation == "identity"
    with pytest.raises(ValueError, match="share a shape"):
        lt.out_shape([(3,), (4,)])
    if op == "subtract":
        with pytest.raises(ValueError, match="two inputs"):
            lt.out_shape([(3,)] * 3)


@pytest.mark.parametrize("x_shape", [(8, 6), (8, 3, 4, 4)], ids=["2d", "4d"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
def test_conditional_batch_norm_matches_jax(x_shape, train):
    """Per-class gamma/beta on class-agnostic statistics, with the running
    mean/var updates in train mode and the graph's relu applied."""
    lj, lt = _layer_pair("ConditionalBatchNorm", num_classes=4,
                         activation="relu")
    rng = np.random.RandomState(4)
    x = (rng.randn(*x_shape) * 1.5 + 0.3).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, x_shape[0])]
    n = x_shape[1]
    params = {"gamma": (1 + 0.2 * rng.randn(4, n)).astype(np.float32),
              "beta": (0.1 * rng.randn(4, n)).astype(np.float32),
              "mean": (0.1 * rng.randn(n)).astype(np.float32),
              "var": (1 + 0.1 * rng.rand(n)).astype(np.float32)}
    _check_layer(lj, lt, params, [x, y], train)
    init_t = lt.init(None, [x_shape[1:], (4,)])
    init_j = lj.init(None, [x_shape[1:], (4,)])
    _assert_tree_close(_np(init_j), init_t, 0.0)


def test_conditional_batch_norm_inherits_the_graph_activation():
    """Resolved against the generator's default (relu), as in JAX."""
    lj = LJ.ConditionalBatchNorm(num_classes=3).resolved("relu", None)
    lt = LT.ConditionalBatchNorm(num_classes=3).resolved("relu", None)
    assert lt.activation == lj.activation == "relu"
    assert LT.ElementWise().resolved("relu", None).activation == "identity"


@pytest.mark.parametrize("phi_shape", [(6, 10), (6, 2, 3, 3)])
def test_projection_output_matches_jax(phi_shape):
    lj, lt = _layer_pair("ProjectionOutput", num_classes=5, loss="xent",
                         activation="sigmoid")
    rng = np.random.RandomState(5)
    phi = rng.randn(*phi_shape).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, phi_shape[0])]
    n_in = int(np.prod(phi_shape[1:]))
    params = {"W": (0.3 * rng.randn(n_in, 1)).astype(np.float32),
              "b": rng.randn(1).astype(np.float32),
              "V": (0.3 * rng.randn(5, n_in)).astype(np.float32)}
    _check_layer(lj, lt, params, [phi, y], True)
    init = lt.init(torch.Generator().manual_seed(0), [phi_shape[1:], (5,)])
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "W": (n_in, 1), "b": (1,), "V": (5, n_in)}
    assert lt.loss == "xent" and lt.out_shape([phi_shape[1:], (5,)]) == (1,)


# -- the builders and files ------------------------------------------------------

FLAG_CASES = [dict(), dict(conditional_bn=False, projection_d=False,
                           minibatch_stddev=False),
              dict(conditional_bn=False), dict(projection_d=False),
              dict(decay_steps=1000)]


def _graphs(flags):
    cj = dataclasses.replace(CGAN, **flags)
    ct = dataclasses.replace(CGAN_T, **flags)
    return [(GJ.build_generator(cj), GT.build_generator(ct, "cpu")),
            (GJ.build_discriminator(cj), GT.build_discriminator(ct, "cpu"))]


@pytest.mark.parametrize("flags", FLAG_CASES,
                         ids=["all_on", "all_off", "plain_bn", "merge_head",
                              "decay"])
def test_builders_match_jax(flags):
    """Layer names and order, types, inputs, resolved activations and
    updaters, shapes, and the param and updater trees key for key."""
    for gj, gt in _graphs(flags):
        assert list(gj.nodes) == list(gt.nodes)
        assert gj.input_names == gt.input_names
        for name, nj in gj.nodes.items():
            nt = gt.nodes[name]
            assert type(nj.layer).__name__ == type(nt.layer).__name__
            assert tuple(nj.inputs) == tuple(nt.inputs), name
            assert nj.layer.activation == nt.layer.activation, name
            assert tuple(nj.out_shape) == tuple(nt.out_shape), name
            assert (ST._updater_to_dict(nt.layer.updater)
                    if nt.layer.updater is not None else None) == (
                SJ._updater_to_dict(nj.layer.updater)
                if nj.layer.updater is not None else None), name
        p = interop.params_from_numpy(_np(gj.params), "cpu", like=gt.params)
        _assert_tree_close(_np(gj.params), p, 0.0)
        o = interop.opt_state_from_numpy(_np(gj.opt_state), "cpu",
                                         like=gt.opt_state)
        _opt_close(_np(gj.opt_state), o, 0.0)
        _opt_close(_np(gj.opt_state), gt.opt_state, 0.0)  # fresh zeros


@pytest.mark.parametrize("flags", [dict(), dict(projection_d=False,
                                                conditional_bn=False),
                                   dict(decay_steps=1000)],
                         ids=["all_on", "merge_head", "decay"])
def test_model_zips_byte_equal_both_ways(tmp_path, flags):
    """Both graphs after one JAX updater step: the port writes the JAX
    bytes (the multi-input edges in the configuration as JAX writes them),
    and each package reads the other's."""
    rng = np.random.RandomState(8)
    for a, b in _graphs(flags):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.randn(*p.shape).astype(np.float32)), a.params)
        params, opt = a.updater.apply(a.params, g, a.opt_state)
        a.params = jax.tree.map(jnp.asarray, _np(params))
        a.opt_state = jax.tree.map(jnp.asarray, _np(opt))
        b.params = interop.params_from_numpy(_np(params), "cpu", like=b.params)
        b.opt_state = interop.opt_state_from_numpy(_np(opt), "cpu",
                                                   like=b.opt_state)
        for upd in (True, False):
            pj_, pt_ = tmp_path / "j.zip", tmp_path / "t.zip"
            SJ.write_model(a, str(pj_), save_updater=upd)
            ST.write_model(b, str(pt_), save_updater=upd)
            assert pj_.read_bytes() == pt_.read_bytes()
        back_t = ST.read_model(str(pj_), device="cpu")
        back_j = SJ.read_model(str(pt_))
        assert ST.graph_config_to_dict(back_t) == SJ.graph_config_to_dict(back_j)
        _assert_tree_close(_np(back_j.params), back_t.params, 0.0)
        SJ.write_model(a, str(pj_))
        _opt_close(_np(a.opt_state), ST.read_model(str(pj_), "cpu").opt_state,
                   0.0)


@pytest.mark.parametrize("seed", [3, 666])
@pytest.mark.parametrize("n", [7, 4100])
@pytest.mark.parametrize("difficulty", ["v1", "calibrated"])
def test_synthetic_cifar10_byte_equal(seed, n, difficulty):
    xa, ya = DJ.synthetic_cifar10(n, seed=seed, difficulty=difficulty)
    xb, yb = DT.synthetic_cifar10(n, seed=seed, difficulty=difficulty)
    assert xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes()
    assert ya.dtype == yb.dtype and ya.tobytes() == yb.tobytes()


# -- the conditional GANPair ---------------------------------------------------

def _pairs(ms=0.0):
    pj = PairJ(GJ.build_generator(CGAN), GJ.build_discriminator(CGAN),
               ms_weight=ms)
    pt = GANPair(GT.build_generator(CGAN_T, "cpu"),
                 GT.build_discriminator(CGAN_T, "cpu"), ms_weight=ms)
    for gj, gt in ((pj.gen, pt.gen), (pj.dis, pt.dis)):
        gt.params = interop.params_from_numpy(_np(gj.params), "cpu",
                                              like=gt.params)
    return pj, pt


def _cond_draws(key, n_rows, ms):
    """One JAX multistep iteration's draws (n_critic 1) as the port's
    ``Draws``, the G-step's own rows included."""
    i, z = _key_draws(key, 0, n_rows, 8)
    gi, gz = _key_draws(key, 1, n_rows, 8)
    z2 = None
    if ms:
        z2 = _t(jax.random.uniform(prng_j.stream(prng_j.stream(key, "g"), "ms"),
                                   (B, 8), minval=-1.0, maxval=1.0))

    def idx(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))

    return Draws([idx(i)], [_t(z)], None, _t(gz), z2, idx(gi))


@pytest.fixture(scope="module", params=[(1, 0.0), (3, 0.0), (1, 0.5),
                                        (3, 0.5)],
                ids=["k1", "k3", "k1_ms", "k3_ms"])
def iterations(request):
    """K conditional iterations in each package from the same params, the
    JAX scan's draws injected into the port's ``make_multistep``."""
    K, ms = request.param
    pj, pt = _pairs(ms)
    n_rows = 40
    x, labels = DJ.synthetic_cifar10(n_rows, seed=5, difficulty="calibrated")
    y = _onehot(labels)
    key0 = jax.random.key(31)
    fj, sj = pj.make_multistep(jnp.asarray(x), jnp.asarray(y), batch_size=B,
                               steps_per_call=K, real_label=0.9, z_size=8,
                               seed_key=key0)
    sj, (dlj, glj) = fj(sj)
    draws = [_cond_draws(jax.random.fold_in(key0, it), n_rows, ms)
             for it in range(K)]
    ft, st0 = pt.make_multistep(_t(x), _t(y), batch_size=B, steps_per_call=K,
                                real_label=0.9, z_size=8)
    st, (dlt, glt) = ft(st0, draws=draws)
    return dict(K=K, jax=(sj, dlj, glj), port=(st, dlt, glt))


def test_conditional_iterations_match_jax(iterations):
    sj, dlj, glj = iterations["jax"]
    st, dlt, glt = iterations["port"]
    K = iterations["K"]
    tol = ITER_TOL if K == 1 else ITER3_TOL
    np.testing.assert_allclose(dlt.numpy(), np.asarray(dlj), rtol=tol)
    np.testing.assert_allclose(glt.numpy(), np.asarray(glj), rtol=tol)
    assert int(st.it) == int(sj[4]) == K
    # noise elements (gradient at rounding level) within 2 lr a step
    _assert_params_track(_np(sj[0]), _np(sj[1]), st.gen_params, tol,
                         2e-4 * K)
    _assert_params_track(_np(sj[2]), _np(sj[3]), st.dis_params, tol,
                         1e-4 * K)
    _opt_close(_np(sj[1]), st.gen_opt, tol)
    _opt_close(_np(sj[3]), st.dis_opt, tol)


def test_conditional_pair_refuses_a_missing_or_stray_condition():
    _, pt = _pairs()
    x = torch.zeros(16, 3 * 32 * 32)
    with pytest.raises(ValueError, match="needs table_cond"):
        pt.make_multistep(x, batch_size=B, steps_per_call=1, z_size=8)
    plain = GANPair(CT.build_generator(CELEBA_T, "cpu"),
                    CT.build_discriminator(CELEBA_T, "cpu"))
    with pytest.raises(ValueError, match="takes no table_cond"):
        plain.make_multistep(torch.zeros(16, 3 * 64 * 64),
                             torch.zeros(16, 10), batch_size=B,
                             steps_per_call=1, z_size=8)


def test_public_steps_take_the_jax_condition_dicts():
    """``d_step`` / ``g_step`` with the JAX API's dicts move the graphs as
    the pure steps do from the same state and inputs."""
    _, pt = _pairs()
    rng = np.random.RandomState(12)
    real = _t(rng.rand(B, 3 * 32 * 32).astype(np.float32) * 2 - 1)
    z = _t(rng.uniform(-1, 1, (B, 8)).astype(np.float32))
    c = _t(_onehot(rng.randint(0, 10, B)))
    y_real, y_fake, y_gen = pt.label_vectors(B)
    pd, _, dl = pt._d_step(pt.dis.params, pt.dis.opt_state, pt.gen.params,
                           real, z, y_real, y_fake, None, c, c)
    assert torch.equal(pt.d_step(real, {"z": z, "label": c}, {"label": c},
                                 {"label": c}), dl)
    assert all(torch.equal(pd[l][n], pt.dis.params[l][n])
               for l in pd for n in pd[l])
    pg, _, gl = pt._g_step(pt.gen.params, pt.gen.opt_state, pt.dis.params,
                           z, y_gen, None, c)
    assert torch.equal(pt.g_step({"z": z, "label": c}, {"label": c}), gl)
    assert all(torch.equal(pg[l][n], pt.gen.params[l][n])
               for l in pg for n in pg[l])


# -- the unconditional streams stay as they were --------------------------------

def _digest(draws):
    h = hashlib.sha256()
    for f in draws[:5]:
        if f is None:
            h.update(b"none")
            continue
        for t in (f if isinstance(f, list) else [f]):
            h.update(str(t.dtype).encode())
            h.update(t.numpy().tobytes())
    return h.hexdigest()


# sha256 of the first iteration's draws (seed 123, 50 rows, batch 8, z 8)
# and the first 16 hex digits of the generator's state after them, as the
# port drew them before conditional pairs existed (a checkpoint's
# z_gen_state resumes these streams)
PINNED_DRAWS = {
    "celeba": ("f6c54397d8494c75afe082460f43818de74f7409b5684216bd2ab9edeb46c108",
               "6a1300a74d175728"),
    "celeba_ms": ("229ca6b91a3fa19fe479916e832ec5b6c37e2f25add2e1a46775691d16fe05b7",
                  "0fada9de46f80e75"),
    "wgan-gp": ("8efea96c44e7f1d4ea758b988ff8543fdd7c4683a2d561666e5af42b7689954f",
                "1220d3c7f7f2d9db"),
}


@pytest.mark.parametrize("family", sorted(PINNED_DRAWS))
def test_unconditional_draw_streams_are_unchanged(family):
    if family == "wgan-gp":
        pair = GANPair(WT.build_generator(WGAN_T, "cpu"),
                       WT.build_critic(WGAN_T, "cpu"), mode="wgan-gp")
        n_critic = WGAN_T.n_critic
    else:
        pair = GANPair(CT.build_generator(CELEBA_T, "cpu"),
                       CT.build_discriminator(CELEBA_T, "cpu"),
                       ms_weight=0.5 if family == "celeba_ms" else 0.0)
        n_critic = 1
    g = torch.Generator().manual_seed(123)
    d = pair.draw(g, 50, B, n_critic, 8, "cpu")
    assert d.g_idx is None
    state = hashlib.sha256(g.get_state().numpy().tobytes()).hexdigest()[:16]
    assert (_digest(d), state) == PINNED_DRAWS[family]


# -- the conditional evaluation ---------------------------------------------------

SHAPE = (3, 32, 32)


@pytest.fixture(scope="module")
def probe_data():
    x, labels = DJ.synthetic_cifar10(200, seed=9, difficulty="calibrated")
    return x, _onehot(labels)


def test_probe_first_fit_step_matches_jax(probe_data):
    """From the JAX probe's init, one Adam step on the shared numpy batch:
    the loss within 1e-5 relative, every param within 1e-5 (rounding-noise
    gradients within 2 lr)."""
    x, y = probe_data
    pj = CondJ.build_probe(*SHAPE, K_CLASSES)
    pt = CondT.build_probe(*SHAPE, K_CLASSES, device="cpu")
    pt.params = interop.params_from_numpy(_np(pj.params), "cpu",
                                          like=pt.params)
    idx = np.random.RandomState(666).randint(0, x.shape[0], 128)
    x4 = x.reshape(-1, *SHAPE)
    lj = pj.fit(jnp.asarray(x4[idx]), jnp.asarray(y[idx]))
    lt = pt.fit(_t(x4[idx]), _t(y[idx]))
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_TOL)
    _assert_params_track(_np(pj.params), _np(pj.opt_state), pt.params,
                         ITER_TOL, 1e-3)
    _opt_close(_np(pj.opt_state), pt.opt_state, ITER_TOL)


@pytest.fixture(scope="module")
def fidelity_runs(probe_data):
    """The JAX conditional_fidelity (probe trained 3 steps) and the port's
    on the JAX probe's trained params and the JAX latents."""
    x, y = probe_data
    gj = GJ.build_generator(CGAN)
    gt = GT.build_generator(CGAN_T, "cpu")
    gt.params = interop.params_from_numpy(_np(gj.params), "cpu",
                                          like=gt.params)
    n_per = 12
    rj = CondJ.conditional_fidelity(gj, x, y, sample_shape=SHAPE, z_size=8,
                                    n_per_class=n_per, probe_steps=3,
                                    probe_batch=32)
    probe = CondT.build_probe(*SHAPE, K_CLASSES, device="cpu")
    probe.params = interop.params_from_numpy(_np(rj["probe"].params), "cpu",
                                             like=probe.params)
    z = jax.random.uniform(
        prng_j.stream(prng_j.root_key(prng_j.NUMBER_OF_THE_BEAST),
                      "fidelity-z"), (K_CLASSES * n_per, 8),
        minval=-1.0, maxval=1.0)
    rt = CondT.conditional_fidelity(gt, x, y, sample_shape=SHAPE, z_size=8,
                                    n_per_class=n_per, probe=probe,
                                    z=np.asarray(z))
    return rj, rt, gj, gt


def test_conditional_fidelity_agreement_equals_jax(fidelity_runs):
    rj, rt, _, _ = fidelity_runs
    assert rt["per_class"] == rj["per_class"]
    assert rt["fidelity"] == rj["fidelity"]
    assert rt["probe_train_acc"] == rj["probe_train_acc"]
    assert rt["n_per_class"] == rj["n_per_class"] == 12


def test_conditional_class_metrics_match_jax(fidelity_runs, probe_data):
    """The per-class frozen FID and diversity ratio (the committed CIFAR
    extractor in both packages) on the JAX latents: within 1e-3 relative
    (float64 Frechet distances of f32 features that agree to ~1e-6)."""
    x, y = probe_data
    _, _, gj, gt = fidelity_runs
    n_per = 12
    kw = dict(sample_shape=SHAPE, z_size=8, n_per_class=n_per, real_cap=30,
              batch_size=40)
    cj = CondJ.conditional_class_metrics(gj, x, y, **kw)
    z = jax.random.uniform(
        prng_j.stream(prng_j.root_key(prng_j.NUMBER_OF_THE_BEAST),
                      "class-metrics-z"), (K_CLASSES * n_per, 8),
        minval=-1.0, maxval=1.0)
    ct = CondT.conditional_class_metrics(gt, x, y, z=np.asarray(z), **kw)
    np.testing.assert_allclose(ct["per_class_fid"], cj["per_class_fid"],
                               rtol=1e-3)
    np.testing.assert_allclose(ct["diversity_ratio"], cj["diversity_ratio"],
                               rtol=1e-3, atol=1e-6)
    for a, b in zip(ct["_real_features"], cj["_real_features"]):
        _close(a, b, 1e-5)


# -- the program ---------------------------------------------------------------------

def test_roadmap_main_cgan_cpu_end_to_end(tmp_path, capsys):
    """The program at full width on the CPU with the EMA: the JAX run's
    file set (less events.jsonl / run_manifest.json), one metrics record
    per iteration, the conditional keys (every class has 50 rows or more,
    so the class metrics run), and zips that read back."""
    res = tmp_path / "cgan"
    RM.main(["--family", "cgan-cifar10", "--device", "cpu", "--iterations",
             "4", "--batch-size", str(B), "--n-train", "700",
             "--print-every", "2", "--ema-decay", "0.9", "--fidelity-steps",
             "3", "--res-path", str(res)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["family"] == "cgan-cifar10" and result["steps"] == 4
    for k in ("conditional_fidelity", "probe_train_acc", "mean_class_fid",
              "diversity_ratio", "conditional_fidelity_ema",
              "mean_class_fid_ema", "diversity_ratio_ema"):
        assert np.isfinite(result[k]), k
    assert len(result["fidelity_per_class"]) == len(
        result["per_class_fid"]) == K_CLASSES
    f = "cgan-cifar10"
    assert sorted(os.listdir(res)) == sorted(
        [f"{f}_samples_2.png", f"{f}_samples_4.png", f"{f}_samples_ema.png",
         f"{f}_metrics.jsonl", f"{f}_gen_model.zip", f"{f}_dis_model.zip",
         f"{f}_gen_ema_model.zip", "events.jsonl", "run_manifest.json"])
    recs = [json.loads(l) for l in open(res / f"{f}_metrics.jsonl")]
    assert [r.get("step") for r in recs] == [1, 2, 3, 4, None]  # + goodput
    gen = SJ.read_model(str(res / f"{f}_gen_model.zip"))
    assert gen.input_names == ["z", "label"]


def test_roadmap_main_cgan_resume_equals_a_straight_run(tmp_path):
    """4 iterations straight against 2 checkpointed and resumed to 4 (the
    G-step rows ride the saved draw generator): the zips are equal."""
    kw = dict(family="cgan-cifar10", batch_size=B, n_train=48,
              print_every=2, device="cpu", fidelity_steps=0, log=None)
    straight, ckpt = tmp_path / "s", tmp_path / "c"
    RM.train(iterations=4, res_path=str(straight), **kw)
    RM.train(iterations=2, res_path=str(ckpt), checkpoint_every=2, **kw)
    out = RM.train(iterations=4, res_path=str(ckpt), checkpoint_every=2,
                   resume=True, **kw)
    assert out["steps"] == 4 and "conditional_fidelity" not in out
    for name in ("gen", "dis"):
        assert ((straight / f"cgan-cifar10_{name}_model.zip").read_bytes()
                == (ckpt / f"cgan-cifar10_{name}_model.zip").read_bytes())
