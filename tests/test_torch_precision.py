"""The precision modes ``--bf16`` (``matmul_bf16``) and ``--mp``
(``compute_bf16``) of the port held against the JAX package's, on the CPU.

Every test that sets a mode sets it in both packages and puts both back
(``policy``).  The JAX programs are compiled with XLA's
``xla_allow_excess_precision`` off (``jax_compiled``): with it on, as by
default, XLA's CPU compiler drops the f32 -> bf16 -> f32 round trips
inside a fusion, so the program does not round where the JAX code says it
does (a bf16 convolution's result cast back to f32, for one); with it off
each JAX op rounds as its dtype says, as op-by-op execution
(``jax.disable_jit``) does and as the port does.

The test that pins the cast placement (``test_protocol_step_tracks_jax``
here, ``test_pair_iteration_tracks_jax`` in
``test_torch_precision_pair.py``): one step in each package from the same
params, data and draws, and the port's error against JAX under the mode
must be at most half of JAX's own deviation between the mode and parity,
for the step's losses (max abs) and for its gradients (``rel_err``, norm
relative over every leaf, read back from the updater state).  A cast in
the wrong place (a bias added before the rounding, a BN fed bf16, a loss
taken in bf16) shows as an error of the order of the mode's deviation.
Under ``--mp`` the gradients leave out the bf16 layers' biases: a bias
add's backward reduces the bf16 cotangent, which XLA's CPU backend
accumulates in bf16 and torch in f32
(``test_jax_cpu_reduces_bf16_in_bf16``).

Also: the help texts byte-equal; the per-layer ops; a layer's own
``bf16_matmul`` over the policy; the activations' bf16 forms and
derivative rules; the ``upsample_bwd`` route by dtype against JAX's
``supports_upsample_bwd``; no bf16 tensor anywhere in a parity step; the
f32-only kernel wrappers never given bf16, with their calls per step in
each mode; a step keeping the policy it was built under; and a world-2
gloo step under ``--mp`` against world 1.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import test_torch_mesh as ranks
from gan_deeplearning4j_tpu.graph import layers as LJ
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.models import mlpgan_insurance as IJ
from gan_deeplearning4j_tpu.ops import activations as ActJ
from gan_deeplearning4j_tpu.ops.pallas import dma_pipeline as DmaJ
from gan_deeplearning4j_tpu.ops.upsample import upsample2d as up_j
from gan_deeplearning4j_tpu.runtime import backend as BJ
from gan_deeplearning4j_tpu.train import fused_step as FJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
from gan_deeplearning4j_tpu_torch.graph import layers as LT
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as IT
from gan_deeplearning4j_tpu_torch.ops import activations as ActT
from gan_deeplearning4j_tpu_torch.ops import upsample as up_t
from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import (
    supports_upsample_bwd,
    upsample_bwd,
)
from gan_deeplearning4j_tpu_torch.optim import updater as upd_t
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.runtime import backend as BT
from gan_deeplearning4j_tpu_torch.train import (
    cv_main,
    insurance_main,
    roadmap_main,
)
from gan_deeplearning4j_tpu_torch.train import fused_step as FT

MODES = {"bf16": {"matmul_bf16": True}, "mp": {"compute_bf16": True},
         "bf16_mp": {"matmul_bf16": True, "compute_bf16": True}}
# the cast-placement bound: the port's error at most this share of JAX's
# own deviation between the mode and parity
HALF = 0.5
SPAWN_TIMEOUT_S = 300
T = torch.from_numpy


@contextlib.contextmanager
def policy(**kw):
    """Both packages under one precision policy; both put back after."""
    prev = BJ.config()
    BJ.configure(**kw)
    try:
        with BT.configured(**kw):
            yield
    finally:
        BJ.configure(matmul_bf16=prev.matmul_bf16,
                     compute_bf16=prev.compute_bf16)


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def torch_tree(tree):
    """{..: tensor} -> {..: f32 numpy} at any depth."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def leaves(tree, prefix=()):
    """{path: float64 array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float64)
    return out


def rel_err(ref: dict, got: dict, keys=None) -> float:
    """||got - ref|| / ||ref|| over the leaves ``keys`` (default: all)."""
    keys = list(ref) if keys is None else keys
    num = sum(float(np.sum((np.asarray(got[k], np.float64) - ref[k]) ** 2))
              for k in keys)
    den = sum(float(np.sum(np.asarray(ref[k], np.float64) ** 2))
              for k in keys)
    return float(np.sqrt(num / den))


def metrics(runs, mode) -> dict:
    """The port's error against JAX under ``mode`` and JAX's own deviation
    between the mode and parity, for the losses and the gradients (module
    docstring: under ``compute_bf16`` without the bf16 layers' biases)."""
    j, jp, t = runs["jax"], runs["jax_parity"], runs["port"]
    keys = [k for k in j["grads"]
            if not (mode.get("compute_bf16") and k[-1] == "b")]
    return {
        "loss_err": float(np.max(np.abs(t["losses"] - j["losses"]))),
        "loss_dev": float(np.max(np.abs(jp["losses"] - j["losses"]))),
        "grad_err": rel_err(j["grads"], t["grads"], keys),
        "grad_dev": rel_err(j["grads"], jp["grads"], keys),
    }


def jax_compiled(fn, *args):
    """``fn`` (a jitted JAX function) compiled for ``args`` with XLA's
    excess precision off, and run (module docstring)."""
    return fn.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def assert_tracks(m):
    assert m["loss_err"] <= HALF * m["loss_dev"], m
    assert m["grad_err"] <= HALF * m["grad_dev"], m


# -- the policy and its flags ---------------------------------------------------

@pytest.mark.parametrize("name", ["BF16_HELP", "MP_HELP"])
def test_help_texts_are_the_jax_packages(name):
    assert getattr(BT, name) == getattr(BJ, name)


def test_runtime_config_mirrors_jax():
    """The port's two fields are the JAX config's, off by default;
    ``configure`` sets them, ``configured`` puts the previous config back,
    also after an error."""
    fields = [f.name for f in dataclasses.fields(BT.RuntimeConfig)]
    assert fields == ["matmul_bf16", "compute_bf16"]
    for f in fields:
        assert getattr(BJ.RuntimeConfig(), f) is False
        assert getattr(BT.RuntimeConfig(), f) is False
    prev = BT.config()
    with pytest.raises(RuntimeError):
        with BT.configured(compute_bf16=True) as cfg:
            assert BT.config() is cfg and cfg.compute_bf16
            raise RuntimeError
    assert BT.config() == prev
    try:
        assert BT.configure(matmul_bf16=True).matmul_bf16
    finally:
        BT.configure(matmul_bf16=prev.matmul_bf16)
    assert BT.config() == prev


@pytest.mark.parametrize("parse", [
    cv_main.parse_args, insurance_main.parse_args,
    lambda argv: roadmap_main.parse_args(["--family", "celeba"] + argv)],
    ids=["cv_main", "insurance_main", "roadmap_main"])
def test_mains_parse_the_jax_flags(parse):
    """Each main takes ``--bf16`` and ``--mp`` with the JAX flags' names,
    and ``flag_policy`` turns on what is given, as the JAX mains do."""
    args = parse([])
    assert (args.bf16, args.mp) == (False, False)
    assert BT.flag_policy(args) == {}
    args = parse(["--bf16", "--mp"])
    assert BT.flag_policy(args) == {"matmul_bf16": True,
                                    "compute_bf16": True}
    assert BT.flag_policy(parse(["--mp"])) == {"compute_bf16": True}


# -- ops and layers -------------------------------------------------------------

LAYER_CASES = {
    "Dense": (dict(n_out=24, n_in=40), (16, 40), {"W": (40, 24), "b": (24,)}),
    "Output": (dict(n_out=10, n_in=40, loss="mcxent"), (16, 40),
               {"W": (40, 10), "b": (10,)}),
    "Conv2D": (dict(kernel=(5, 5), stride=(2, 2), padding=(0, 0), n_in=4,
                    n_out=8), (4, 4, 12, 12), {"W": (8, 4, 5, 5), "b": (8,)}),
    "ConvTranspose2D": (dict(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                             n_in=4, n_out=6), (4, 4, 6, 6),
                        {"W": (6, 4, 4, 4), "b": (6,)}),
}


def _layer_inputs(kind):
    kw, x_shape, p_shapes = LAYER_CASES[kind]
    rng = np.random.RandomState(0)
    params = {k: (rng.randn(*s) * (0.3 if k == "W" else 0.5)).astype(
        np.float32) for k, s in p_shapes.items()}
    return kw, params, rng.randn(*x_shape).astype(np.float32)


def _jax_layer(kind, params, x, gy_seed=1, **kw):
    """(y, {"x": dx, "W": dW, "b": db}) of a JAX layer, op by op."""
    layer = getattr(LJ, kind)(activation="identity", **kw)
    with jax.disable_jit():
        y, vjp = jax.vjp(lambda p, x: layer.apply(p, x, False, None)[0],
                         jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        gy = np.random.RandomState(gy_seed).randn(*y.shape).astype(np.float32)
        gp, gx = vjp(jnp.asarray(gy))
    return np.asarray(y), {"x": np.asarray(gx), **{
        k: np.asarray(v) for k, v in gp.items()}}, gy


def _port_layer(kind, params, x, gy, **kw):
    layer = getattr(LT, kind)(activation="identity", **kw)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    y = layer.apply(p, xt, False, None)[0]
    gx, gw, gb = torch.autograd.grad(y, [xt, p["W"], p["b"]], T(gy))
    return y.detach().numpy(), {"x": gx.numpy(), "W": gw.numpy(),
                                "b": gb.numpy()}


@pytest.mark.parametrize("kind", list(LAYER_CASES))
def test_layer_matches_jax_under_bf16(kind):
    """Forward and backward of each contraction layer under
    ``matmul_bf16``: y, dx and dW within half of JAX's own bf16-vs-f32
    deviation (they come out bitwise here), and db — the bias is added in
    f32 after the cast back, so its gradient is an f32 sum — within 1e-5
    relative (a bias added inside the bf16 op would put it at the bf16
    level, ~4e-3)."""
    kw, params, x = _layer_inputs(kind)
    yj0, gj0, gy = _jax_layer(kind, params, x, **kw)
    with policy(matmul_bf16=True):
        yj, gj, _ = _jax_layer(kind, params, x, **kw)
        yt, gt = _port_layer(kind, params, x, gy, **kw)
    for name, (ref, got, par) in {"y": (yj, yt, yj0), **{
            k: (gj[k], gt[k], gj0[k]) for k in ("x", "W")}}.items():
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        dev = np.linalg.norm(par - ref) / np.linalg.norm(ref)
        assert dev > 1e-3 and err <= HALF * dev, (name, err, dev)
    np.testing.assert_allclose(gt["b"], gj["b"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["Dense", "Conv2D", "ConvTranspose2D"])
def test_a_layers_own_flag_wins_over_the_policy(kind):
    """``bf16_matmul=False`` under ``matmul_bf16`` gives the parity bits;
    ``bf16_matmul=True`` under parity gives the policy's bits."""
    kw, params, x = _layer_inputs(kind)
    _, _, gy = _jax_layer(kind, params, x, **kw)
    y_par, g_par = _port_layer(kind, params, x, gy, **kw)
    with BT.configured(matmul_bf16=True):
        y_pol, g_pol = _port_layer(kind, params, x, gy, **kw)
        y_off, g_off = _port_layer(kind, params, x, gy, bf16_matmul=False,
                                   **kw)
    y_on, g_on = _port_layer(kind, params, x, gy, bf16_matmul=True, **kw)
    assert not np.array_equal(y_par, y_pol)
    for (ya, ga), (yb, gb) in (((y_off, g_off), (y_par, g_par)),
                               ((y_on, g_on), (y_pol, g_pol))):
        assert np.array_equal(ya, yb)
        assert all(np.array_equal(ga[k], gb[k]) for k in ga)


def _jax_act(name, x, g):
    """(y, dx) of a JAX activation, op by op, as f32 numpy."""
    with jax.disable_jit():
        y, vjp = jax.vjp(ActJ.get(name), x)
        (d,) = vjp(g)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(d.astype(jnp.float32)))


@pytest.mark.parametrize("name", ["tanh", "sigmoid", "elu", "leakyrelu",
                                  "softmax", "relu"])
def test_bf16_activation_follows_jax(name):
    """Each activation on bf16 against ``jax.nn``'s, op by op (JAX's forms
    and derivative rules, each op rounded to bf16, where torch's fused
    kernels round once): the values and the input gradient bit for bit.
    Softmax's gradient reduces a bf16 cotangent over the classes, which
    XLA's CPU backend sums in bf16 and torch in f32
    (``test_jax_cpu_reduces_bf16_in_bf16``): it is held to lie no farther
    from the f32 gradient than JAX's bf16 gradient does."""
    rng = np.random.RandomState(3)
    x = (rng.randn(64, 10) * 3).astype(np.float32)
    g = rng.randn(64, 10).astype(np.float32)
    xj, gj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    yj, dj = _jax_act(name, xj, gj)
    xt = T(np.asarray(xj.astype(jnp.float32))).bfloat16().requires_grad_(True)
    yt = ActT.get(name)(xt)
    (dt,) = torch.autograd.grad(yt, xt, T(np.asarray(
        gj.astype(jnp.float32))).bfloat16())
    assert yt.dtype == dt.dtype == torch.bfloat16
    np.testing.assert_array_equal(yt.detach().float().numpy(), yj)
    if name != "softmax":
        np.testing.assert_array_equal(dt.float().numpy(), dj)
        return
    _, d32 = _jax_act(name, xj.astype(jnp.float32), gj.astype(jnp.float32))
    assert (np.linalg.norm(dt.float().numpy() - d32)
            <= np.linalg.norm(dj - d32))


def test_f32_activations_are_torchs_own():
    """In f32 the registry is torch's own ops, so parity keeps its bits."""
    x = torch.randn(32, 10, generator=torch.Generator().manual_seed(0))
    for name, ref in (("tanh", torch.tanh(x)), ("sigmoid", torch.sigmoid(x)),
                      ("elu", torch.nn.functional.elu(x)),
                      ("softmax", torch.softmax(x, dim=-1)),
                      ("leakyrelu", torch.where(x >= 0, x, 0.01 * x))):
        assert torch.equal(ActT.get(name)(x), ref), name


def test_jax_cpu_reduces_bf16_in_bf16():
    """Why the ``--mp`` gradient comparisons leave out the bf16 layers'
    biases: the JAX gradient of a bf16 bias add is ``lax.reduce_sum`` of
    the bf16 cotangent, which XLA's CPU backend accumulates in bf16 (here
    over 1,024 terms it lands many ulps from the f32 sum rounded once),
    while the port's (torch's) sums in f32 and rounds once, as
    ``jnp.sum`` does."""
    rng = np.random.RandomState(0)
    g = jnp.asarray(rng.randn(16, 8, 8, 8).astype(np.float32)).astype(
        jnp.bfloat16)
    b = jnp.zeros((8,), jnp.bfloat16)
    x = jnp.zeros((16, 8, 8, 8), jnp.bfloat16)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda b: x + b.reshape(1, -1, 1, 1), b)
        (db_j,) = vjp(g)
    f32_once = np.asarray(jnp.sum(g, axis=(0, 2, 3)).astype(jnp.float32))
    gt = T(np.asarray(g.astype(jnp.float32))).bfloat16()
    bt = torch.zeros(8, dtype=torch.bfloat16, requires_grad=True)
    (db_t,) = torch.autograd.grad(
        torch.zeros_like(gt) + bt.reshape(1, -1, 1, 1), bt, gt)
    np.testing.assert_array_equal(db_t.float().numpy(), f32_once)
    assert np.abs(np.asarray(db_j.astype(jnp.float32)) - f32_once).max() > 0.1


# -- the upsample backward's route by dtype ---------------------------------------

def test_upsample_route_agrees_with_jax():
    """``supports_upsample_bwd`` against the JAX package's on a grid of
    shapes, factors and dtypes.  The JAX predicate's third test (its TPU
    pipeline's VMEM tiling: B*C*H*sh rows in whole sublane groups) is not
    the CUDA kernel's; on the grid's tileable shapes the two agree, and
    where the JAX pipeline cannot tile an f32 cotangent the port's kernel
    still takes it."""
    dtypes = ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
              (jnp.float16, torch.float16))
    # cotangent shapes: the CV step's two, small ones, spatial dims that a
    # factor does not divide, and one of rank 3
    shapes = [(200, 128, 14, 14), (200, 64, 28, 28), (8, 4, 12, 12),
              (4, 2, 16, 8), (8, 4, 12, 9), (8, 4, 7, 12), (4, 16, 12)]
    for gs in shapes:
        for sh, sw in ((2, 2), (3, 3), (2, 1)):
            for dj, dt in dtypes:
                got = supports_upsample_bwd(gs, sh, sw, dt)
                want = DmaJ.supports_upsample_bwd(gs, sh, sw, dj)
                tileable = (len(gs) != 4 or gs[2] % sh or gs[3] % sw
                            or DmaJ._chunk_rows(gs[0] * gs[1] * gs[2], gs[3],
                                                sh) > 0)
                if tileable:
                    assert got == want, (gs, sh, sw, dt)
                else:
                    assert got and dt == torch.float32, (gs, sh, sw)
    assert not supports_upsample_bwd((2, 3, 5, 4), 2, 2, torch.float32)


def test_bf16_cotangent_takes_the_plain_block_sum():
    """A bf16 cotangent takes the block sum in torch ops, never the f32
    kernel's wrapper (which raises on bf16), and gives JAX's bits: the
    (sh, sw) blocks summed in f32 and rounded once, as ``jnp.sum`` does."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 3, 5, 6).astype(np.float32)
    g = rng.randn(4, 3, 10, 12).astype(np.float32)
    xj, gj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a: up_j(a, 2), xj)
        (dj,) = vjp(gj)
    xt = T(x).bfloat16().requires_grad_(True)
    calls = upsample_bwd.launches
    gt = T(np.asarray(gj.astype(jnp.float32))).bfloat16()
    (dt,) = torch.autograd.grad(up_t.upsample2d(xt, 2), xt, gt)
    assert dt.dtype == torch.bfloat16
    np.testing.assert_array_equal(dt.float().numpy(),
                                  np.asarray(dj.astype(jnp.float32)))
    with pytest.raises(TypeError, match="float32 only"):
        upsample_bwd(T(g).bfloat16(), 2, 2)
    assert upsample_bwd.launches == calls


# -- parity untouched; the f32-only wrappers ----------------------------------

def _cv_step_inputs(B=8):
    feats, labels = synthetic_mnist(B, seed=5)
    rng = np.random.RandomState(1)
    ones = np.ones((B, 1), np.float32)
    z = rng.uniform(-1, 1, (2, B, 2)).astype(np.float32)
    return [T(feats), T(np.eye(10, dtype=np.float32)[labels]),
            T(ones + 0.05 * rng.randn(B, 1).astype(np.float32)),
            T(0.05 * rng.randn(B, 1).astype(np.float32)), T(ones)], z


def _protocol_step(M=MT, num_features=784):
    """A fresh protocol step of the model module ``M`` -> (step, state)."""
    d = M.build_discriminator(device="cpu")
    graphs = (d, M.build_generator(device="cpu"), M.build_gan(device="cpu"),
              M.build_classifier(d))
    step = FT.make_protocol_step(*graphs, M.DIS_TO_GAN, M.GAN_TO_GEN,
                                 M.DIS_TO_CLASSIFIER, z_size=2,
                                 num_features=num_features)
    return step, FT.state_from_graphs(*graphs)


class _Dtypes(TorchDispatchMode):
    """Records the dtype of every tensor an aten op returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.dtype)
        return out


def test_parity_step_creates_no_bf16_tensor():
    """One CV protocol step in parity mode (forward, backward, updates):
    no aten op returns a bf16 tensor."""
    step, state = _protocol_step()
    inputs, z = _cv_step_inputs()
    with _Dtypes() as rec:
        step(state, *inputs, z1=T(z[0]), z2=T(z[1]))
    assert torch.bfloat16 not in rec.seen and torch.float32 in rec.seen


@pytest.mark.parametrize("mode", ["parity", *MODES])
def test_f32_only_wrappers_never_see_bf16(monkeypatch, mode):
    """One CV protocol step per mode, each kernel wrapper the step reaches
    wrapped to record its calls and their dtypes: every call is f32, and
    the calls per step are the card's launches per step (``PERF.md`` §6):
    3 ``fused_bn_act_train`` (the BN carve-out keeps it f32 under
    ``--mp``), 3 ``fused_rmsprop_chains`` (f32 master params), and 2
    ``upsample_bwd`` except under ``--mp``, whose bf16 cotangents take
    the plain block sum (0), as in the JAX package."""
    calls = {"bn_act": [], "fused_update": [], "upsample_bwd": []}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name].append({t.dtype for t in tree_leaves((args, kw))
                                if isinstance(t, torch.Tensor)})
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(LT, "fused_bn_act_train",
                        spy("bn_act", LT.fused_bn_act_train))
    monkeypatch.setattr(upd_t, "fused_rmsprop_chains",
                        spy("fused_update", upd_t.fused_rmsprop_chains))
    monkeypatch.setattr(up_t, "upsample_bwd",
                        spy("upsample_bwd", up_t.upsample_bwd))
    with BT.configured(**MODES.get(mode, {})):
        step, state = _protocol_step()
    inputs, z = _cv_step_inputs()
    _, losses = step(state, *inputs, z1=T(z[0]), z2=T(z[1]))
    assert all(torch.isfinite(v) for v in losses)
    mp = MODES.get(mode, {}).get("compute_bf16", False)
    assert {k: len(v) for k, v in calls.items()} == {
        "bn_act": 3, "fused_update": 3, "upsample_bwd": 0 if mp else 2}
    assert all(d == {torch.float32} for v in calls.values() for d in v)


def test_step_keeps_the_policy_it_was_built_under():
    """A step built under ``--mp`` and called outside it gives the bits of
    a step built and called under it, not the parity step's (the JAX step
    fixes the policy when it is traced).  The insurance step."""
    feats, labels = _protocol_batch("insurance")
    rng = np.random.RandomState(4)
    B = feats.shape[0]
    inputs = [T(feats), T(labels), T(np.ones((B, 1), np.float32)),
              T(np.zeros((B, 1), np.float32)), T(np.ones((B, 1), np.float32))]
    z1, z2 = (T(rng.uniform(-1, 1, (B, 2)).astype(np.float32)) for _ in "ab")
    with BT.configured(compute_bf16=True):
        step_mp, state = _protocol_step(IT, 12)
        _, inside = step_mp(state, *inputs, z1=z1, z2=z2)
    _, outside = step_mp(state, *inputs, z1=z1, z2=z2)
    step_par, state = _protocol_step(IT, 12)
    _, parity = step_par(state, *inputs, z1=z1, z2=z2)
    assert all(torch.equal(a, b) for a, b in zip(inside, outside))
    assert not all(torch.equal(a, b) for a, b in zip(inside, parity))


# -- one protocol step against JAX's ---------------------------------------------

PROTOCOL = {"cv": (MJ, MT, 784), "insurance": (IJ, IT, 12)}
_PARITY_CACHE = {}


def _protocol_batch(model):
    if model == "cv":
        feats, labels = synthetic_mnist(8, seed=5)
        return feats, np.eye(10, dtype=np.float32)[labels]
    rng = np.random.RandomState(2)
    return (rng.rand(16, 12).astype(np.float32),
            (rng.rand(16, 1) > 0.5).astype(np.float32))


def _cfg(M, **kw):
    cfg = M.CVConfig() if hasattr(M, "CVConfig") else M.InsuranceConfig()
    return dataclasses.replace(cfg, **kw)


def _protocol_result(trees, losses):
    """Losses, |g| from RmsProp's caches (cache = (1 - 1e-8) g^2), and the
    params."""
    return {"losses": np.array([float(v) for v in losses]),
            "grads": {k: np.sqrt(v) for k, v in leaves(
                {f: trees[f] for f in trees if f.endswith("_opt")}).items()},
            "params": leaves({f: trees[f] for f in trees
                              if not f.endswith("_opt")})}


def protocol_runs(model: str, mode, lr0: bool):
    """One protocol step of ``model`` (full width; batch 8 for cv, 16 for
    insurance) from the JAX graphs' init, the JAX step's latent draws
    injected into the port: {"jax_parity", "jax", "port"}.  ``lr0``: both
    learning rates 0, so each of the step's three updates leaves the
    params where they were and every graph's gradient is taken at the
    start state (a real step's later graphs see the first update, whose
    RmsProp steps of ~lr * sign(g) flip with rounding noise)."""
    MJm, MTm, nf = PROTOCOL[model]
    rates = ({"dis_learning_rate": 0.0, "gen_learning_rate": 0.0} if lr0
             else {})
    cj, ct = _cfg(MJm, **rates), _cfg(MTm, **rates)
    feats, labels = _protocol_batch(model)
    B = feats.shape[0]
    rng = np.random.RandomState(1)
    ones = np.ones((B, 1), np.float32)
    y_real = ones + (0.05 * rng.randn(B, 1)).astype(np.float32)
    y_fake = (0.05 * rng.randn(B, 1)).astype(np.float32)
    z_key, rng_key = jax.random.key(3), jax.random.key(4)
    z1, z2 = (np.array(jax.random.uniform(jax.random.fold_in(z_key, k),
                                          (B, 2), minval=-1.0, maxval=1.0))
              for k in (0, 1))

    def jax_graphs():
        dis = MJm.build_discriminator(cj)
        return (dis, MJm.build_generator(cj), MJm.build_gan(cj),
                MJm.build_classifier(dis, cj))

    def jax_run(kw):
        with policy(**kw):
            g = jax_graphs()
            step = FJ.make_protocol_step(
                *g, MJm.DIS_TO_GAN, MJm.GAN_TO_GEN, MJm.DIS_TO_CLASSIFIER,
                z_size=2, num_features=nf, donate=False)
            state, losses = jax_compiled(
                step, FJ.state_from_graphs(*g), jnp.asarray(feats),
                jnp.asarray(labels), z_key, rng_key, jnp.asarray(y_real),
                jnp.asarray(y_fake), jnp.asarray(ones))
            return _protocol_result(
                {f: np_tree(getattr(state, f)) for f in FT.TREES}, losses)

    start = {f: np_tree(getattr(FJ.state_from_graphs(*jax_graphs()), f))
             for f in FT.TREES}
    with BT.configured(**mode):
        d = MTm.build_discriminator(ct, device="cpu")
        step = FT.make_protocol_step(
            d, MTm.build_generator(ct, device="cpu"),
            MTm.build_gan(ct, device="cpu"), MTm.build_classifier(d, ct),
            MTm.DIS_TO_GAN, MTm.GAN_TO_GEN, MTm.DIS_TO_CLASSIFIER, z_size=2,
            num_features=nf)
    # the step keeps the policy it was built under
    state = FT.ProtocolState(
        *(interop.params_from_numpy(start[f], "cpu") for f in FT.TREES),
        torch.tensor(0))
    state, losses = step(state, T(feats), T(labels), T(y_real), T(y_fake),
                         T(ones), z1=T(z1), z2=T(z2))
    port = _protocol_result({f: torch_tree(getattr(state, f))
                             for f in FT.TREES}, losses)
    key = (model, lr0)
    if key not in _PARITY_CACHE:
        _PARITY_CACHE[key] = jax_run({})
    return {"jax_parity": _PARITY_CACHE[key], "jax": jax_run(mode),
            "port": port}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", list(PROTOCOL))
def test_protocol_step_tracks_jax(model, mode):
    """The four graphs' protocol step (learning rates 0; see
    ``protocol_runs``): the losses and every graph's gradient within half
    of JAX's own mode-vs-parity deviation (module docstring)."""
    runs = protocol_runs(model, MODES[mode], lr0=True)
    assert_tracks(metrics(runs, MODES[mode]))


def test_protocol_step_updates_track_jax_under_mp():
    """One real insurance step under ``--mp`` (its own learning rates):
    the D-step's loss within half of the mode's deviation (it is taken
    before any update); the G-step's and the classifier's, which see the
    updated discriminator, within 1e-2 relative (bf16 rounding around
    RmsProp's ~lr * sign(g) steps); every param within 2 lr (the largest
    rate, the generator's) of JAX's, and at most 1% of them more than 1e-5
    away."""
    model, mode = "insurance", MODES["mp"]
    runs = protocol_runs(model, mode, lr0=False)
    j, jp, t = runs["jax"], runs["jax_parity"], runs["port"]
    assert abs(t["losses"][0] - j["losses"][0]) <= HALF * abs(
        jp["losses"][0] - j["losses"][0])
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-2)
    lr = _cfg(PROTOCOL[model][1]).gen_learning_rate
    diffs = [np.abs(t["params"][k] - v) for k, v in j["params"].items()]
    assert max(float(d.max()) for d in diffs) <= 2 * lr
    off = sum(int((d > 1e-5).sum()) for d in diffs)
    assert off <= 0.01 * sum(d.size for d in diffs)


# -- data parallel under --mp -----------------------------------------------------

def test_world2_step_under_mp_matches_world1():
    """Two gloo ranks on four rows each under ``--mp`` against one process
    on all eight, learning rates 0 (``protocol_runs``): sync-BN's
    statistics stay f32 through the carve-out and the gradients are
    all-reduced in f32, so the three losses meet the f32 DP step's band
    (1e-5 relative, ``test_torch_dp.test_dp_step_matches_single_process_
    step``).  Each rank's bf16 weight gradients are rounded before the
    f32 all-reduce (as each shard's are in the JAX package's mesh step),
    so the gradients (read from the caches) are held to half of the
    mode's own deviation from parity instead of the f32 band's 2e-3."""
    dj = MJ.build_discriminator()
    state0 = FJ.state_from_graphs(dj, MJ.build_generator(), MJ.build_gan(),
                                  MJ.build_classifier(dj))
    inputs, z = _cv_step_inputs()
    p = dict(state={f: np_tree(getattr(state0, f)) for f in ranks.FIELDS},
             real=inputs[0].numpy(), labels=inputs[1].numpy(),
             y_real=inputs[2].numpy(), y_fake=inputs[3].numpy(),
             ones=inputs[4].numpy(), z=[(z[0], z[1])],
             config={"dis_learning_rate": 0.0, "gen_learning_rate": 0.0})
    mp = dict(p, precision={"compute_bf16": True})
    got = mesh.spawn(ranks.run_protocol, 2, (mp,), device="cpu",
                     timeout=SPAWN_TIMEOUT_S)

    def result(run):
        (state, losses), = run
        return _protocol_result(state, losses)

    single, parity = (result(ranks.run_protocol(None, q)) for q in (mp, p))
    for rank in got:
        runs = {"jax": single, "jax_parity": parity, "port": result(rank)}
        np.testing.assert_allclose(runs["port"]["losses"], single["losses"],
                                   rtol=1e-5)
        m = metrics(runs, {"compute_bf16": True})
        assert m["grad_err"] <= HALF * m["grad_dev"], m
