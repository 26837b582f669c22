"""The port's ``GANPair`` engine (train/gan_pair.py) and the WGAN-GP losses
held against the JAX package's, on the CPU, at small width (base_filters 4,
z 8, batch 8).

Every random draw is the JAX side's: the graphs' params through
``interop``, and each step's batch rows, latents, GP alphas and
mode-seeking z2, derived from the JAX keys as the JAX step derives them
(``Draws``).  Module fixtures run the JAX side once.

Covered: ``wasserstein``; ``gradient_penalty`` with its gradient over the
critic's params (the second-order backward); what ``GANPair`` refuses; one
D-step and one G-step in ``gan`` (celeba), ``wgan-gp`` and ``ms_weight``
modes; ``make_multistep`` at K = 3 against the JAX scan, and against three
K = 1 calls bit for bit, with and without the EMA.  Tolerances: see
``test_torch_roadmap``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data import datasets as DJ
from gan_deeplearning4j_tpu.models import dcgan_celeba as CJ
from gan_deeplearning4j_tpu.models import wgan_gp as WJ
from gan_deeplearning4j_tpu.ops import losses as LossJ
from gan_deeplearning4j_tpu.runtime import prng as prng_j
from gan_deeplearning4j_tpu.train.gan_pair import GANPair as PairJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.models import dcgan_celeba as CT
from gan_deeplearning4j_tpu_torch.models import wgan_gp as WT
from gan_deeplearning4j_tpu_torch.ops import losses as LossT
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train.gan_pair import Draws, GANPair
from test_torch_roadmap import (
    B,
    CELEBA,
    CELEBA_T,
    LOSS_TOL,
    STEP_PARAM_TOL,
    WGAN,
    WGAN_T,
    _assert_opt_close,
    _assert_params_track,
    _np,
    _t,
)


# -- losses -----------------------------------------------------------------------

def test_wasserstein_matches_jax():
    rng = np.random.RandomState(6)
    out = rng.randn(8, 1).astype(np.float32)
    lab = np.where(rng.rand(8, 1) < 0.5, 1.0, -1.0).astype(np.float32)
    np.testing.assert_allclose(
        float(LossT.wasserstein(_t(out), _t(lab))),
        float(LossJ.wasserstein(jnp.asarray(out), jnp.asarray(lab))), rtol=1e-6)
    assert LossT.get("wasserstein") is LossT.wasserstein


@pytest.fixture(scope="module")
def critic():
    """A small WGAN critic in both packages on the same params."""
    cj = WJ.build_critic(WGAN)
    ct = WT.build_critic(WGAN_T, device="cpu")
    ct.params = interop.params_from_numpy(_np(cj.params), "cpu", like=ct.params)
    return cj, ct


def test_gradient_penalty_and_its_param_gradient_match_jax(critic):
    """The penalty (one gradient of the summed critic output vs JAX's
    per-example vmap(grad)) and its gradient over the critic's params (the
    second-order backward)."""
    cj, ct = critic
    rng = np.random.RandomState(7)
    real = rng.rand(B, 784).astype(np.float32)
    fake = rng.rand(B, 784).astype(np.float32)
    alpha = rng.rand(B, 1).astype(np.float32)

    def gp_j(p):
        def fn(x):
            return cj._forward(p, {"image": x}, False, None)[0]["crit_out"]
        return LossJ.gradient_penalty(fn, jnp.asarray(real), jnp.asarray(fake),
                                      None, alpha=jnp.asarray(alpha))

    vj, gj = jax.value_and_grad(gp_j)(cj.params)
    leaves = {l: {n: v.detach().requires_grad_(True) for n, v in lp.items()}
              for l, lp in ct.params.items()}
    vt = LossT.gradient_penalty(
        lambda x: ct._forward(leaves, {"image": x}, False)[0]["crit_out"],
        _t(real), _t(fake), _t(alpha))
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    keys = [(l, n) for l in leaves for n in leaves[l]]
    gt = torch.autograd.grad(vt, [leaves[l][n] for l, n in keys],
                             allow_unused=True)
    for (l, n), g in zip(keys, gt):
        a = np.asarray(gj[l][n])
        # the head's bias does not reach an input gradient: JAX's zeros
        g = torch.zeros(a.shape) if g is None else g
        np.testing.assert_allclose(g.numpy(), a, rtol=0,
                                   atol=1e-4 * (np.abs(a).max() + 1e-6),
                                   err_msg=f"{l}.{n}")


def test_gan_pair_refuses_what_it_does_not_run():
    with pytest.raises(ValueError, match="couple examples"):
        GANPair(CT.build_generator(CELEBA_T, "cpu"),
                CT.build_discriminator(CELEBA_T, "cpu"), mode="wgan-gp")
    # a group (refused before data parallelism was ported) is taken: rank
    # 1 of 2 steps on the second half of each batch, which must split
    pair = GANPair(WT.build_generator(WGAN_T, "cpu"),
                   WT.build_critic(WGAN_T, "cpu"),
                   group=mesh.DataGroup(1, 2, torch.device("cpu"), "gloo"))
    assert (pair.world, pair.rank, pair.local_batch(B)) == (2, 1, B // 2)
    with pytest.raises(ValueError, match="must divide over 2 devices"):
        pair.local_batch(B + 1)
    with pytest.raises(ValueError, match="ms_weight"):
        GANPair(WT.build_generator(WGAN_T, "cpu"),
                WT.build_critic(WGAN_T, "cpu"), ms_weight=-1.0)


# -- the GANPair steps ---------------------------------------------------------------

def _pairs(mode):
    """(JAX pair, port pair on the JAX params)."""
    if mode == "wgan-gp":
        pj = PairJ(WJ.build_generator(WGAN), WJ.build_critic(WGAN),
                   mode="wgan-gp", gp_weight=10.0)
        pt = GANPair(WT.build_generator(WGAN_T, "cpu"),
                     WT.build_critic(WGAN_T, "cpu"), mode="wgan-gp")
    else:
        ms = 0.5 if mode == "ms" else 0.0
        pj = PairJ(CJ.build_generator(CELEBA), CJ.build_discriminator(CELEBA),
                   ms_weight=ms)
        pt = GANPair(CT.build_generator(CELEBA_T, "cpu"),
                     CT.build_discriminator(CELEBA_T, "cpu"), ms_weight=ms)
    for gj, gt in ((pj.gen, pt.gen), (pj.dis, pt.dis)):
        gt.params = interop.params_from_numpy(_np(gj.params), "cpu",
                                              like=gt.params)
    return pj, pt


def _key_draws(key, j, n_rows, z_size):
    """The JAX multistep's ``draw(key, j)``."""
    k = jax.random.fold_in(key, j)
    idx = jax.random.randint(jax.random.fold_in(k, 0), (B,), 0, n_rows)
    z = jax.random.uniform(jax.random.fold_in(k, 1), (B, z_size),
                           minval=-1.0, maxval=1.0)
    return idx, z


def _iteration_draws(key, n_critic, n_rows, z_size, mode, ms):
    """One JAX multistep iteration's draws (``fold_in(key0, it)`` = key) as
    the port's ``Draws``."""
    idx, zs, alphas = [], [], []
    for j in range(n_critic):
        i, z = _key_draws(key, j, n_rows, z_size)
        idx.append(torch.from_numpy(np.asarray(i).astype(np.int64)))
        zs.append(_t(z))
        if mode == "wgan-gp":
            gp_key = prng_j.stream(prng_j.stream(key, f"d{j}"), "gp")
            alphas.append(_t(jax.random.uniform(gp_key, (B, 1))))
    _, z = _key_draws(key, n_critic, n_rows, z_size)
    z2 = None
    if ms:
        z2 = _t(jax.random.uniform(prng_j.stream(prng_j.stream(key, "g"), "ms"),
                                   (B, z_size), minval=-1.0, maxval=1.0))
    return Draws(idx, zs, alphas if mode == "wgan-gp" else None, _t(z), z2)


@pytest.fixture(scope="module", params=["celeba", "wgan-gp", "ms"])
def single_steps(request):
    """One D-step and one G-step in each package from the same state, with
    the JAX step's own draws injected into the port."""
    mode = request.param
    pj, pt = _pairs(mode)
    jmode = "wgan-gp" if mode == "wgan-gp" else "gan"
    z_size = 8
    if mode == "wgan-gp":
        real = DJ.synthetic_mnist(B, seed=3)[0].astype(np.float32)
    else:
        real = DJ.synthetic_celeba(B, seed=3)
    y_real, y_fake, y_gen = (np.asarray(t) for t in pt.label_vectors(
        B, 0.9 if jmode == "gan" else 1.0))
    rng = jax.random.key(11)
    z = np.asarray(jax.random.uniform(jax.random.key(12), (B, z_size),
                                      minval=-1.0, maxval=1.0))
    pd, od, dl = pj._jit_d(pj.dis.params, pj.dis.opt_state, pj.gen.params, rng,
                           jnp.asarray(real), {"z": jnp.asarray(z)}, {}, {},
                           jnp.asarray(y_real), jnp.asarray(y_fake))
    alpha = (_t(jax.random.uniform(prng_j.stream(rng, "gp"), (B, 1)))
             if jmode == "wgan-gp" else None)
    pdt, odt, dlt = pt._d_step(pt.dis.params, pt.dis.opt_state, pt.gen.params,
                               _t(real), _t(z), _t(y_real), _t(y_fake), alpha)
    # the G-step against the UPDATED discriminator, each package its own
    rng_g = jax.random.key(13)
    z2 = None
    if mode == "ms":
        z2 = _t(jax.random.uniform(prng_j.stream(rng_g, "ms"), (B, z_size),
                                   minval=-1.0, maxval=1.0))
    pg, og, gl = pj._jit_g(pj.gen.params, pj.gen.opt_state, pd, rng_g,
                           {"z": jnp.asarray(z)}, {}, jnp.asarray(y_gen))
    pd_carried = interop.params_from_numpy(_np(pd), "cpu")
    pgt, ogt, glt = pt._g_step(pt.gen.params, pt.gen.opt_state, pd_carried,
                               _t(z), _t(y_gen), z2)
    return dict(d=((pd, od, dl), (pdt, odt, dlt)),
                g=((pg, og, gl), (pgt, ogt, glt)), mode=mode)


def test_d_step_matches_jax(single_steps):
    (pd, od, dl), (pdt, odt, dlt) = single_steps["d"]
    np.testing.assert_allclose(float(dlt), float(dl), rtol=LOSS_TOL)
    _assert_params_track(_np(pd), _np(od), pdt, STEP_PARAM_TOL, 1e-4)
    _assert_opt_close(_np(od), odt)


def test_g_step_matches_jax(single_steps):
    (pg, og, gl), (pgt, ogt, glt) = single_steps["g"]
    np.testing.assert_allclose(float(glt), float(gl), rtol=LOSS_TOL)
    _assert_params_track(_np(pg), _np(og), pgt, STEP_PARAM_TOL, 2e-4)
    _assert_opt_close(_np(og), ogt)


@pytest.fixture(scope="module", params=[0.0, 0.9], ids=["plain", "ema"])
def multistep(request):
    """K = 3 iterations of wgan-gp (n_critic 2): the JAX scan, the port's
    K = 3 call on the JAX draws, and three port K = 1 calls from one z_gen
    against one K = 3 call from another in the same state."""
    ema = request.param
    pj, pt = _pairs("wgan-gp")
    n_rows, K, n_critic = 24, 3, 2
    x = DJ.synthetic_mnist(n_rows, seed=4)[0].astype(np.float32)
    key0 = jax.random.key(21)
    fj, sj = pj.make_multistep(jnp.asarray(x), batch_size=B, steps_per_call=K,
                               n_critic=n_critic, z_size=8, seed_key=key0,
                               ema_decay=ema)
    sj, (dlj, glj) = fj(sj)
    draws = [_iteration_draws(jax.random.fold_in(key0, it), n_critic, n_rows,
                              8, "wgan-gp", False) for it in range(K)]
    ft, st0 = pt.make_multistep(_t(x), batch_size=B, steps_per_call=K,
                                n_critic=n_critic, z_size=8, ema_decay=ema)
    st, (dlt, glt) = ft(st0, draws=draws)
    # the port against itself: K = 3 vs three K = 1 calls, same generator
    g3 = torch.Generator().manual_seed(5)
    g1 = torch.Generator().manual_seed(5)
    f3, s3 = pt.make_multistep(_t(x), batch_size=B, steps_per_call=3,
                               n_critic=n_critic, z_size=8, z_gen=g3,
                               ema_decay=ema)
    f1, s1 = pt.make_multistep(_t(x), batch_size=B, steps_per_call=1,
                               n_critic=n_critic, z_size=8, z_gen=g1,
                               ema_decay=ema)
    s3, l3 = f3(s3)
    l1 = []
    for _ in range(3):
        s1, out = f1(s1)
        l1.append(out)
    return dict(jax=(sj, dlj, glj), port=(st, dlt, glt), k3=(s3, l3),
                k1=(s1, l1), ema=ema)


def test_multistep_matches_jax(multistep):
    sj, dlj, glj = multistep["jax"]
    st, dlt, glt = multistep["port"]
    np.testing.assert_allclose(dlt.numpy(), np.asarray(dlj), rtol=1e-4)
    np.testing.assert_allclose(glt.numpy(), np.asarray(glj), rtol=1e-4,
                               atol=1e-6)
    assert int(st.it) == int(sj[4]) == 3
    # three iterations (6 critic updates, 3 generator updates): 3x the
    # one-step band, and 3 lr for the noise elements
    _assert_params_track(_np(sj[0]), _np(sj[1]), st.gen_params,
                         3 * STEP_PARAM_TOL, 3e-4)
    _assert_params_track(_np(sj[2]), _np(sj[3]), st.dis_params,
                         3 * STEP_PARAM_TOL, 3e-4)
    if multistep["ema"]:
        # the EMA averages the generator's params: the same band
        _assert_params_track(_np(sj[5]), _np(sj[1]), st.ema,
                             3 * STEP_PARAM_TOL, 3e-4)
    else:
        assert st.ema is None and sj[5] is None


def test_multistep_k3_equals_three_single_iterations(multistep):
    s3, (d3, g3) = multistep["k3"]
    s1, l1 = multistep["k1"]
    assert torch.equal(d3, torch.cat([d for d, _ in l1]))
    assert torch.equal(g3, torch.cat([g for _, g in l1]))
    a, b = FT._leaves(s3), FT._leaves(s1)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_public_steps_move_the_graphs_as_the_pure_steps_do():
    """``d_step`` / ``g_step`` (the JAX package's public API) on the
    graphs' own state: the same losses and params as ``_d_step`` /
    ``_g_step`` from that state, the D-step's targets defaulting to 1 and
    -1 in wgan-gp mode."""
    _, pt = _pairs("wgan-gp")
    rng = np.random.RandomState(12)
    real = _t(rng.rand(B, 784).astype(np.float32))
    z = _t(rng.uniform(-1, 1, (B, 8)).astype(np.float32))
    alpha = _t(rng.rand(B, 1).astype(np.float32))
    y_real, y_fake, y_gen = pt.label_vectors(B)
    pd, od, dl = pt._d_step(pt.dis.params, pt.dis.opt_state, pt.gen.params,
                            real, z, y_real, y_fake, alpha)
    assert torch.equal(pt.d_step(real, {"z": z}, alpha=alpha), dl)
    assert all(torch.equal(pd[l][n], pt.dis.params[l][n])
               for l in pd for n in pd[l])
    pg, og, gl = pt._g_step(pt.gen.params, pt.gen.opt_state, pt.dis.params,
                            z, y_gen)
    assert torch.equal(pt.g_step(z), gl)
    assert all(torch.equal(pg[l][n], pt.gen.params[l][n])
               for l in pg for n in pg[l])
    assert float(pt.dis.opt_state["crit_out"]["W"]["t"]) == 1.0
