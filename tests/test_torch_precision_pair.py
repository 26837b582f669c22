"""The precision modes on the roadmap families' ``GANPair`` iteration
(celeba, wgan-gp with its double backward, cgan-cifar10), the port held
against the JAX package at small width (base filters 4, 8 for
cgan-cifar10; z 8; batch 8), with the JAX multistep's draws injected.

One iteration at the configs' own learning rates (n_critic D-steps, then
the G-step) from the same params, in each package under each mode: the
losses and the gradients (Adam's first moment over 1 - b1) within half of
JAX's own deviation between the mode and parity (``test_torch_precision``
module docstring, whose ``policy``, ``jax_compiled`` and ``metrics`` this
module uses), and every param within 2 lr of JAX's (Adam's first step
moves an element by about lr * sign(g); the discriminator takes
n_critic of them).

The pair's loss is taken on the f32 head in the port (``GANPair.
_dis_loss``) and on the bf16 head in the JAX package, whose XENT clip
bound 1 - 1e-7 then rounds to 1.0; the JAX side here takes it on the f32
head too, patched for the run (``_f32_loss``), and
``test_pair_loss_is_taken_in_f32`` shows the difference on its own.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data import datasets as DJ
from gan_deeplearning4j_tpu.models import cgan_cifar10 as GJ
from gan_deeplearning4j_tpu.models import dcgan_celeba as CJ
from gan_deeplearning4j_tpu.models import wgan_gp as WJ
from gan_deeplearning4j_tpu.ops import losses as LossJ
from gan_deeplearning4j_tpu.train import gan_pair as pair_j
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.models import cgan_cifar10 as GT
from gan_deeplearning4j_tpu_torch.models import dcgan_celeba as CT
from gan_deeplearning4j_tpu_torch.models import wgan_gp as WT
from gan_deeplearning4j_tpu_torch.ops import losses as LossT
from gan_deeplearning4j_tpu_torch.runtime import backend as BT
from gan_deeplearning4j_tpu_torch.train.gan_pair import GANPair
from test_torch_cgan import _cond_draws
from test_torch_gan_pair import _iteration_draws
from test_torch_precision import (
    HALF,
    MODES,
    assert_tracks,
    jax_compiled,
    leaves,
    metrics,
    np_tree,
    policy,
    torch_tree,
)

B, Z, N_ROWS = 8, 8, 24
B1 = 0.5  # every family's Adam beta1
_PARITY_CACHE = {}


def _family(name):
    """(JAX config, port config, (JAX builders), (port builders), pair
    keywords, n_critic, real label, table, one-hot labels or None)."""
    if name == "wgan-gp":
        cj, ct = (dataclasses.replace(M.WGANGPConfig(), base_filters=4,
                                      z_size=Z, n_critic=2) for M in (WJ, WT))
        return (cj, ct, (WJ.build_generator, WJ.build_critic),
                (WT.build_generator, WT.build_critic),
                {"mode": "wgan-gp", "gp_weight": cj.gp_weight}, 2, 1.0,
                DJ.synthetic_mnist(N_ROWS, seed=4)[0].astype(np.float32),
                None)
    M, cfg, width = ((CJ, CT), "CelebAConfig", 4) if name == "celeba" else (
        (GJ, GT), "CGANConfig", 8)
    cj, ct = (dataclasses.replace(getattr(m, cfg)(), base_filters=width,
                                  z_size=Z) for m in M)
    if name == "celeba":
        x, y = DJ.synthetic_celeba(N_ROWS, seed=3), None
    else:
        x, labels = DJ.synthetic_cifar10(N_ROWS, seed=5,
                                         difficulty="calibrated")
        y = np.eye(10, dtype=np.float32)[labels]
    return (cj, ct, (M[0].build_generator, M[0].build_discriminator),
            (M[1].build_generator, M[1].build_discriminator), {}, 1, 0.9, x,
            y)


@contextlib.contextmanager
def _f32_loss():
    """The JAX pair's loss taken on the f32 head, as the port's is."""
    loss = pair_j.GANPair._dis_loss
    pair_j.GANPair._dis_loss = (
        lambda self, out, labels: loss(self, out.astype(jnp.float32), labels))
    try:
        yield
    finally:
        pair_j.GANPair._dis_loss = loss


def _result(trees, losses):
    gen_p, gen_o, dis_p, dis_o = trees
    grads = {k[:-1]: v / (1.0 - B1) for k, v in leaves(
        {"gen": gen_o, "dis": dis_o}).items() if k[-1] == "m"}
    return {"losses": np.array([float(v[0]) for v in losses]),
            "grads": grads, "params": leaves({"gen": gen_p, "dis": dis_p})}


def pair_runs(name: str, mode):
    """One iteration of family ``name`` -> {"jax_parity", "jax", "port"}."""
    cj, ct, bj, bt, kind, n_critic, real_label, x, y = _family(name)
    key0 = jax.random.key(21)
    key = jax.random.fold_in(key0, 0)
    if y is None:
        draws = [_iteration_draws(key, n_critic, N_ROWS, Z,
                                  kind.get("mode", "gan"), False)]
    else:
        draws = [_cond_draws(key, N_ROWS, 0.0)]
    start = [np_tree(b(cj).params) for b in bj]

    def jax_run(kw):
        with policy(**kw), _f32_loss():
            pj = pair_j.GANPair(bj[0](cj), bj[1](cj), **kind)
            f, s = pj.make_multistep(
                jnp.asarray(x), None if y is None else jnp.asarray(y),
                batch_size=B, steps_per_call=1, n_critic=n_critic,
                real_label=real_label, z_size=Z, seed_key=key0)
            s, losses = jax_compiled(f.jitted, s, *f.invariants)
        return _result([np_tree(t) for t in s[:4]], losses)

    with BT.configured(**mode):
        pt = GANPair(bt[0](ct, "cpu"), bt[1](ct, "cpu"), **kind)
        for g, p in zip((pt.gen, pt.dis), start):
            g.params = interop.params_from_numpy(p, "cpu", like=g.params)
        f, s = pt.make_multistep(
            torch.from_numpy(x), None if y is None else torch.from_numpy(y),
            batch_size=B, steps_per_call=1, n_critic=n_critic,
            real_label=real_label, z_size=Z)
    # the iteration keeps the policy it was built under
    s, losses = f(s, draws=draws)
    port = _result([torch_tree(t) for t in s[:4]], losses)
    if name not in _PARITY_CACHE:
        _PARITY_CACHE[name] = jax_run({})
    return {"jax_parity": _PARITY_CACHE[name], "jax": jax_run(mode),
            "port": port}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["celeba", "wgan-gp", "cgan-cifar10"])
def test_pair_iteration_tracks_jax(name, mode):
    runs = pair_runs(name, MODES[mode])
    assert_tracks(metrics(runs, MODES[mode]))
    fam = _family(name)
    lr = max(getattr(fam[1], k, 0.0) for k in ("learning_rate",
                                                "d_learning_rate"))
    j, t = runs["jax"]["params"], runs["port"]["params"]
    # the discriminator takes n_critic updates
    assert (max(float(np.abs(t[k] - v).max()) for k, v in j.items())
            <= 2 * lr * fam[5])


def test_pair_loss_is_taken_in_f32():
    """Why the port's pair takes its loss on the f32 head: the JAX pair's
    XENT on a bf16 head clips at 1 - 1e-7, which bf16 rounds to 1.0, so a
    real row that D scores 0.9995 under label smoothing (0.9) gives an
    infinite loss; on the f32 head (the port's, and the graph loss's in
    both packages) it is finite and the same in both packages."""
    probs = np.array([[0.9995], [0.5], [0.01]], np.float32)
    labels = np.array([[0.9], [0.0], [0.0]], np.float32)
    bf16 = jnp.asarray(probs).astype(jnp.bfloat16)
    assert not np.isfinite(float(LossJ.binary_xent(bf16, jnp.asarray(labels))))
    ref = float(LossJ.binary_xent(bf16.astype(jnp.float32),
                                  jnp.asarray(labels)))
    pair = GANPair(CT.build_generator(dataclasses.replace(
        CT.CelebAConfig(), base_filters=4, z_size=Z), "cpu"),
        CT.build_discriminator(dataclasses.replace(
            CT.CelebAConfig(), base_filters=4, z_size=Z), "cpu"))
    got = pair._dis_loss(torch.from_numpy(probs).bfloat16(),
                         torch.from_numpy(labels))
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)


def test_gradient_penalty_takes_the_f32_interpolate():
    """Under ``--mp`` the penalty's interpolate is f32 (the fakes are bf16;
    alpha * real + (1 - alpha) * fake promotes, as in JAX), the critic
    casts it to bf16 inside its forward, and the input gradient comes back
    f32: the penalty is f32, its value within half of JAX's own
    mode-vs-parity deviation, and its double backward reaches the critic's
    f32 master weights."""
    cj, ct, bj, bt, kind, *_ = _family("wgan-gp")
    rng = np.random.RandomState(6)
    real = rng.rand(B, 784).astype(np.float32)
    fake = rng.rand(B, 784).astype(np.float32)
    alpha = rng.rand(B, 1).astype(np.float32)
    crit_j = bj[1](cj)

    def gp_jax(kw):
        with policy(**kw):
            c = bj[1](cj)
            fk = jnp.asarray(fake).astype(
                jnp.bfloat16 if kw else jnp.float32)

            def critic(xi):
                return c._forward(crit_j.params, {c.input_names[0]: xi},
                                  False, None)[0][c.output_names[0]]
            return float(jax_compiled(jax.jit(
                lambda r, f, a: LossJ.gradient_penalty(critic, r, f, None,
                                                       alpha=a)),
                jnp.asarray(real), fk, jnp.asarray(alpha)))

    mode = MODES["mp"]
    with BT.configured(**mode):
        c = bt[1](ct, "cpu")
        params = interop.params_from_numpy(np_tree(crit_j.params), "cpu",
                                           like=c.params)
        leaves_t = {k: {n: v.requires_grad_(True) for n, v in lp.items()}
                    for k, lp in params.items()}
        gp = LossT.gradient_penalty(
            lambda xi: c._forward(leaves_t, {c.input_names[0]: xi}, False)[
                0][c.output_names[0]],
            torch.from_numpy(real), torch.from_numpy(fake).bfloat16(),
            torch.from_numpy(alpha))
        # an input gradient does not depend on the biases (through
        # piecewise-linear activations): the weights' gradients
        grads = torch.autograd.grad(gp, [lp["W"] for lp in leaves_t.values()
                                         if "W" in lp])
    assert gp.dtype == torch.float32 and len(grads) == 4
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               and g.abs().max() > 0 for g in grads)
    ref, par = gp_jax(mode), gp_jax({})
    assert abs(float(gp) - ref) <= HALF * abs(par - ref)


def test_conditional_evaluation_under_mp():
    """cgan-cifar10's conditional evaluation under ``--mp`` (small width):
    the probe trains and scores, and the per-class frozen FID reads the
    generated rows back to the host as f32 (numpy has no bf16); every
    score finite."""
    from gan_deeplearning4j_tpu_torch.eval import conditional as CondT

    _, ct, _, bt, *_ = _family("cgan-cifar10")
    x, labels = DJ.synthetic_cifar10(60, seed=7, difficulty="calibrated")
    y = np.eye(10, dtype=np.float32)[labels]
    with BT.configured(compute_bf16=True):
        gen = bt[0](ct, "cpu")
        fid = CondT.conditional_fidelity(gen, x, y, sample_shape=(3, 32, 32),
                                         z_size=Z, n_per_class=4,
                                         probe_steps=2, probe_batch=16)
        cm = CondT.conditional_class_metrics(
            gen, x, y, sample_shape=(3, 32, 32), z_size=Z, n_per_class=8,
            real_cap=16, batch_size=16)
    assert 0.0 <= fid["fidelity"] <= 1.0
    assert np.isfinite(cm["mean_class_fid"])
    assert np.isfinite(cm["mean_diversity_ratio"])

