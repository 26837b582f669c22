"""The port's ops and updater against the JAX package's, on the CPU: the same
numpy inputs through both, forward values and gradients (``jax.vjp``
against ``torch.autograd``).  Unless a test says otherwise the tolerance is
1e-5 (f32 on both sides; reductions summed in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.ops import activations as act_j
from gan_deeplearning4j_tpu.ops import batchnorm as bn_j
from gan_deeplearning4j_tpu.ops import clipping as clip_j
from gan_deeplearning4j_tpu.ops import conv as conv_j
from gan_deeplearning4j_tpu.ops.dense import dense as dense_jax
from gan_deeplearning4j_tpu.ops import initializers as init_j
from gan_deeplearning4j_tpu.ops import losses as loss_j
from gan_deeplearning4j_tpu.ops import pool as pool_j
from gan_deeplearning4j_tpu.ops import upsample as up_j
from gan_deeplearning4j_tpu.optim.rmsprop import RmsProp as RmsProp_j
from gan_deeplearning4j_tpu.optim.updater import GraphUpdater as Updater_j
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.ops import activations as act_t
from gan_deeplearning4j_tpu_torch.ops import batchnorm as bn_t
from gan_deeplearning4j_tpu_torch.ops import clipping as clip_t
from gan_deeplearning4j_tpu_torch.ops import conv as conv_t
from gan_deeplearning4j_tpu_torch.ops.dense import dense as dense_torch
from gan_deeplearning4j_tpu_torch.ops.dense import dropout as dropout_torch
from gan_deeplearning4j_tpu_torch.ops import initializers as init_t
from gan_deeplearning4j_tpu_torch.ops import losses as loss_t
from gan_deeplearning4j_tpu_torch.ops import pool as pool_t
from gan_deeplearning4j_tpu_torch.ops import upsample as up_t
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp as RmsProp_t
from gan_deeplearning4j_tpu_torch.optim.updater import GraphUpdater as Updater_t


def _vjp_both(f_jax, f_torch, inputs, g_out, rtol=1e-5, atol=1e-5):
    """Compare f and its input gradients under cotangent ``g_out``."""
    y_j, vjp = jax.vjp(f_jax, *(jnp.asarray(a) for a in inputs))
    grads_j = vjp(jnp.asarray(g_out))
    leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
    y_t = f_torch(*leaves)
    grads_t = torch.autograd.grad(y_t, leaves, torch.from_numpy(g_out))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=rtol, atol=atol)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", ["identity", "tanh", "sigmoid", "elu",
                                  "relu", "leakyrelu", "softmax"])
def test_activation(name):
    rng = np.random.RandomState(0)
    x = _rand(rng, 6, 9, scale=2.0)
    _vjp_both(act_j.get(name), act_t.get(name), [x], _rand(rng, 6, 9))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        act_t.get("nope")


def test_xavier_is_a_gaussian_with_dl4j_std():
    """Same distribution as the JAX initializer (not the same bits): zero
    mean, std sqrt(2/(fan_in+fan_out)), and the same conv fan arithmetic."""
    fan_in, fan_out = init_t.fan_in_out_conv(64, 128, (5, 5))
    assert (fan_in, fan_out) == init_j.fan_in_out_conv(64, 128, (5, 5))
    gen = torch.Generator().manual_seed(0)
    w = init_t.xavier(gen, (128, 64, 5, 5), fan_in, fan_out)
    std = np.sqrt(2.0 / (fan_in + fan_out))
    assert w.shape == (128, 64, 5, 5) and w.dtype == torch.float32
    assert abs(float(w.std()) / std - 1) < 0.02
    assert abs(float(w.mean())) < 0.02 * std
    u = init_t.xavier_uniform(gen, (4000,), 10, 20)
    assert float(u.abs().max()) <= np.sqrt(6.0 / 30)


def test_dense():
    rng = np.random.RandomState(1)
    x, w, b = _rand(rng, 5, 7), _rand(rng, 7, 3), _rand(rng, 3)
    _vjp_both(dense_jax, dense_torch, [x, w, b], _rand(rng, 5, 3))


def test_dropout_rate_zero_is_identity():
    x = torch.randn(4, 4)
    assert dropout_torch(x, 0.0, None, True) is x
    gen = torch.Generator().manual_seed(0)
    y = dropout_torch(torch.ones(1000), 0.5, gen, True)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert dropout_torch(x, 0.5, gen, False) is x


def test_clipping():
    rng = np.random.RandomState(2)
    tree = {"a": {"W": _rand(rng, 4, 3, scale=3)}, "b": {"b": _rand(rng, 5, scale=3)}}
    tree_t = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in tree.items()}
    for f_j, f_t, arg in ((clip_j.clip_elementwise, clip_t.clip_elementwise, 1.0),
                          (clip_j.clip_by_global_norm, clip_t.clip_by_global_norm, 2.0)):
        out_j = f_j(jax.tree.map(jnp.asarray, tree), arg)
        out_t = f_t(tree_t, arg)
        for k in tree:
            for n in tree[k]:
                np.testing.assert_allclose(out_t[k][n].numpy(),
                                           np.asarray(out_j[k][n]), rtol=1e-6)


@pytest.mark.parametrize("shape,w_shape,stride,pad", [
    ((3, 1, 28, 28), (4, 1, 5, 5), (2, 2), (0, 0)),    # the D input conv
    ((2, 4, 11, 11), (6, 4, 5, 5), (2, 2), (0, 0)),    # Truncate: 11 -> 4
    ((2, 4, 14, 14), (2, 4, 5, 5), (1, 1), (2, 2)),    # the G 'same' convs
])
def test_conv2d(shape, w_shape, stride, pad):
    rng = np.random.RandomState(3)
    x, w, b = _rand(rng, *shape), _rand(rng, *w_shape, scale=0.2), _rand(rng, w_shape[0])
    out = conv_t.conv2d_out_size(shape[2], w_shape[2], stride[0], pad[0])
    assert out == conv_j.conv2d_out_size(shape[2], w_shape[2], stride[0], pad[0])
    g = _rand(rng, shape[0], w_shape[0], out, out)
    _vjp_both(lambda a, k, c: conv_j.conv2d(a, k, c, stride, pad),
              lambda a, k, c: conv_t.conv2d(a, k, c, stride, pad),
              [x, w, b], g, rtol=1e-4, atol=1e-4)


def test_discriminator_shape_chain():
    """DL4J Truncate arithmetic: 28 -> 12 -> (pool) 11 -> 4 -> (pool) 3,
    flattened to 128*3*3 = 1152 into the dense layer."""
    dis = MT.build_discriminator(device="cpu")
    shapes = {n: node.out_shape for n, node in dis.nodes.items()}
    assert shapes["dis_conv2d_layer_2"] == (64, 12, 12)
    assert shapes["dis_maxpool_layer_3"] == (64, 11, 11)
    assert shapes["dis_conv2d_layer_4"] == (128, 4, 4)
    assert shapes["dis_maxpool_layer_5"] == (128, 3, 3)
    assert tuple(dis.params["dis_dense_layer_6"]["W"].shape) == (1152, 1024)
    out = dis.output(torch.rand(3, 784))[0]
    assert tuple(out.shape) == (3, 1)


@pytest.mark.parametrize("kind", ["ties", "random"])
def test_max_pool_first_max_rule(kind):
    """2x2 stride-1 pool; with tied windows the gradient goes to the FIRST
    maximum in row-major window order, as in the JAX package.  Tolerance
    1e-6: an input element shared by several windows sums their
    gradients in another order (a routing error would be O(1))."""
    rng = np.random.RandomState(4)
    if kind == "ties":
        x = rng.randint(0, 3, size=(2, 3, 6, 7)).astype(np.float32)
    else:
        x = _rand(rng, 2, 3, 6, 7)
    g = _rand(rng, 2, 3, 5, 6)
    _vjp_both(lambda a: pool_j.max_pool2d(a, (2, 2), (1, 1)),
              lambda a: pool_t.max_pool2d(a, (2, 2), (1, 1)), [x], g,
              rtol=0, atol=1e-6)


def test_upsample():
    rng = np.random.RandomState(5)
    x = _rand(rng, 2, 3, 4, 5)
    _vjp_both(lambda a: up_j.upsample2d(a, 2), lambda a: up_t.upsample2d(a, 2),
              [x], _rand(rng, 2, 3, 8, 10))


@pytest.mark.parametrize("shape", [(9, 6), (5, 3, 4, 4)])
def test_batch_norm_train(shape):
    """Out, running stats and input gradients against the JAX op; the
    batch variance is the biased one and the running update is
    decay*running + (1-decay)*batch."""
    rng = np.random.RandomState(6)
    C = shape[1]
    x = _rand(rng, *shape, scale=2.0) + 1.0
    gamma, beta = rng.rand(C).astype(np.float32) + 0.5, _rand(rng, C)
    rm, rv = _rand(rng, C), rng.rand(C).astype(np.float32) + 0.5
    out_j, m_j, v_j = bn_j.batch_norm_train(*map(jnp.asarray, (x, gamma, beta, rm, rv)), 0.9, 1e-5)
    out_t, m_t, v_t = bn_t.batch_norm_train(*map(torch.from_numpy, (x, gamma, beta, rm, rv)), 0.9, 1e-5)
    for a, b in ((out_t, out_j), (m_t, m_j), (v_t, v_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    axes = (0,) if len(shape) == 2 else (0, 2, 3)
    np.testing.assert_allclose(v_t.numpy(), 0.9 * rv + 0.1 * x.var(axis=axes),
                               rtol=1e-5)
    _vjp_both(lambda a, g, b: bn_j.batch_norm_train(a, g, b, jnp.asarray(rm), jnp.asarray(rv))[0],
              lambda a, g, b: bn_t.batch_norm_train(a, g, b, torch.from_numpy(rm), torch.from_numpy(rv))[0],
              [x, gamma, beta], _rand(rng, *shape), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(9, 6), (5, 3, 4, 4)])
def test_batch_norm_inference(shape):
    rng = np.random.RandomState(7)
    C = shape[1]
    args = [_rand(rng, *shape), rng.rand(C).astype(np.float32) + 0.5, _rand(rng, C),
            _rand(rng, C), rng.rand(C).astype(np.float32) + 0.5]
    _vjp_both(bn_j.batch_norm_inference, bn_t.batch_norm_inference, args,
              _rand(rng, *shape))


def test_xent_at_the_clip_edges():
    """Probabilities at and beyond 1e-7 / 1 - 1e-7 (a saturated sigmoid):
    both packages clip, so the loss is finite and the gradient is zero
    beyond the edges (nn.BCELoss would differ)."""
    probs = np.array([[0.0], [1e-9], [0.3], [1.0 - 1e-9], [1.0], [0.9]], np.float32)
    labels = np.array([[1.0], [0.0], [1.05], [0.02], [0.0], [1.0]], np.float32)
    _vjp_both(lambda p: loss_j.binary_xent(p, jnp.asarray(labels)),
              lambda p: loss_t.binary_xent(p, torch.from_numpy(labels)),
              [probs], np.array(1.0, np.float32))
    assert np.isfinite(float(loss_t.binary_xent(torch.from_numpy(probs),
                                                torch.from_numpy(labels))))


def test_mcxent_at_the_clip_edge():
    """1 - 1e-9 rounds to 1.0 in f32: a probability exactly ON the upper
    bound, where jnp.clip's gradient is halved."""
    probs = np.array([[0.0, 0.2, 0.8], [1e-9, 1.0 - 1e-9, 0.0],
                      [0.3, 0.3, 0.4]], np.float32)
    labels = np.eye(3, dtype=np.float32)
    _vjp_both(lambda p: loss_j.mcxent(p, jnp.asarray(labels)),
              lambda p: loss_t.mcxent(p, torch.from_numpy(labels)),
              [probs], np.array(1.0, np.float32))


def test_graph_updater_matches_jax():
    """L2 on W only, clip 1.0, per-layer RmsProp, and a layer without an
    updater frozen at lr 0 (its params unchanged bit for bit, its cache
    moving) — two applications, against the JAX GraphUpdater.  Tolerance
    1e-6: one elementwise chain per leaf."""
    rng = np.random.RandomState(8)
    params = {"dense": {"W": _rand(rng, 6, 4), "b": _rand(rng, 4)},
              "bn": {"gamma": rng.rand(4).astype(np.float32) + 0.5,
                     "beta": _rand(rng, 4), "mean": _rand(rng, 4),
                     "var": rng.rand(4).astype(np.float32)},
              "frozen": {"W": _rand(rng, 4, 2), "b": _rand(rng, 2)},
              "pool": {}}
    rates = {"dense": 0.002, "bn": 0.004}
    up_j = Updater_j({k: RmsProp_j(v, 1e-8, 1e-8) for k, v in rates.items()},
                     l2=1e-4, clip_threshold=1.0)
    up_t = Updater_t({k: RmsProp_t(v, 1e-8, 1e-8) for k, v in rates.items()},
                     l2=1e-4, clip_threshold=1.0)
    p_j = jax.tree.map(jnp.asarray, params)
    p_t = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in params.items()}
    c_j, c_t = up_j.init(p_j), up_t.init(p_t)
    for _ in range(2):
        grads = {k: {n: _rand(rng, *v.shape, scale=0.8) for n, v in d.items()}
                 for k, d in params.items()}
        p_j, c_j = up_j.apply(p_j, jax.tree.map(jnp.asarray, grads), c_j)
        p_t, c_t = up_t.apply(p_t, {k: {n: torch.from_numpy(v) for n, v in d.items()}
                                    for k, d in grads.items()}, c_t)
    for tree_t, tree_j in ((p_t, p_j), (c_t, c_j)):
        for k, d in tree_t.items():
            for n, v in d.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(tree_j[k][n]),
                                           rtol=1e-6, atol=1e-7)
    assert torch.equal(p_t["frozen"]["W"], torch.from_numpy(params["frozen"]["W"]))
    assert bool((c_t["frozen"]["W"] > 0).all())
