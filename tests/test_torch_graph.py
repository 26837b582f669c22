"""The port's graph layer against the JAX package's, on the CPU: one training
step of small graphs from carried params, the DCGAN graphs' structure and
sync maps, the dataset copy, and the interop carry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu import graph as GJ
from gan_deeplearning4j_tpu.data.datasets import synthetic_mnist as mnist_jax
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.optim.rmsprop import RmsProp as RmsProp_j
from gan_deeplearning4j_tpu_torch import graph as GT
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist as mnist_torch
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp as RmsProp_t


def _tiny(G, RmsProp, loss, act, n_out, device=None):
    """Dense 16, Conv 4 channels, 4-D and 2-D BN, an upsample and an Output,
    in either package (``device`` only for the port)."""
    lr = RmsProp(0.002, 1e-8, 1e-8)
    b = G.GraphBuilder(seed=3, l2=1e-4, activation="tanh", clip_threshold=1.0)
    b.add_inputs("in")
    b.set_input_types(G.InputSpec.convolutional_flat(6, 6, 1))
    b.add_layer("bn4d", G.BatchNorm(updater=lr), "in")
    b.add_layer("up", G.Upsampling2D(size=2), "bn4d")
    b.add_layer("conv", G.Conv2D(kernel=(3, 3), stride=(2, 2), n_in=1, n_out=4,
                                 updater=lr), "up")
    b.add_layer("pool", G.MaxPool2D(kernel=(2, 2), stride=(1, 1)), "conv")
    b.add_layer("dense", G.Dense(n_out=16, updater=lr), "pool")
    b.add_layer("bn2d", G.BatchNorm(updater=lr), "dense")
    b.add_layer("out", G.Output(n_out=n_out, loss=loss, activation=act,
                                updater=lr), "bn2d")
    b.set_outputs("out")
    graph = b.build() if device is None else b.build(device)
    return graph.init()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("loss,act,n_out", [("mcxent", "softmax", 3),
                                            ("xent", "sigmoid", 1)])
def test_tiny_graph_train_step_matches_jax(loss, act, n_out):
    """One ``_train_step`` from the same params and RmsProp caches: loss,
    params, caches and BN statistics agree.  Tolerances: 1e-5 relative on
    the loss, 2e-5 absolute on params and statistics (an update moves a
    param by up to lr = 2e-3), 2e-3 of each cache leaf's largest value
    plus eps (caches are ~g^2; elements near g = 0 carry large relative
    rounding differences)."""
    gj = _tiny(GJ, RmsProp_j, loss, act, n_out)
    gt = _tiny(GT, RmsProp_t, loss, act, n_out, device="cpu")
    rng = np.random.RandomState(0)
    # non-zero caches, so the carried updater state matters
    opt = jax.tree.map(lambda a: np.abs(rng.randn(*a.shape)).astype(np.float32)
                       * 1e-3, _np_tree(gj.opt_state))
    gt.params = interop.params_from_numpy(_np_tree(gj.params), "cpu", like=gt.params)
    gt.opt_state = interop.opt_state_from_numpy(opt, "cpu", like=gt.opt_state)
    x = rng.rand(10, 36).astype(np.float32)
    y = (np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, 10)] if n_out > 1
         else rng.rand(10, 1).astype(np.float32))
    pj, cj, lj = gj._train_step(gj.params, jax.tree.map(jnp.asarray, opt),
                                jax.random.key(0), {"in": jnp.asarray(x)},
                                {"out": jnp.asarray(y)})
    pt, ct, lt = gt._train_step(gt.params, gt.opt_state, {"in": torch.from_numpy(x)},
                                {"out": torch.from_numpy(y)})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for tree_t, tree_j, is_cache in ((pt, pj, False), (ct, cj, True)):
        ref = _np_tree(tree_j)
        got = interop.params_to_numpy(tree_t)
        assert set(got) == set(ref)
        for layer in ref:
            assert set(got[layer]) == set(ref[layer])
            for n, a in ref[layer].items():
                atol = 2e-3 * (np.abs(a).max() + 1e-8) if is_cache else 2e-5
                np.testing.assert_allclose(got[layer][n], a, rtol=0, atol=atol,
                                           err_msg=f"{layer}.{n}")
    # the BN running statistics moved (train mode) in both
    assert not np.allclose(interop.params_to_numpy(pt)["bn2d"]["var"], 1.0)


@pytest.fixture(scope="module")
def dcgan_pair():
    dis_j = MJ.build_discriminator()
    graphs_j = {"dis": dis_j, "gen": MJ.build_generator(), "gan": MJ.build_gan(),
                "clf": MJ.build_classifier(dis_j)}
    dis_t = MT.build_discriminator(device="cpu")
    graphs_t = {"dis": dis_t, "gen": MT.build_generator(device="cpu"),
                "gan": MT.build_gan(device="cpu"), "clf": MT.build_classifier(dis_t)}
    return graphs_j, graphs_t


@pytest.mark.parametrize("name", ["dis", "gen", "gan", "clf"])
def test_dcgan_graphs_have_the_reference_structure(dcgan_pair, name):
    """Layer names and order, param names and shapes, frozen set, per-layer
    learning rate and activation: identical in both packages."""
    gj, gt = dcgan_pair[0][name], dcgan_pair[1][name]
    assert list(gt.nodes) == list(gj.nodes)
    assert gt.input_names == gj.input_names and gt.output_names == gj.output_names
    assert gt.frozen == gj.frozen
    for layer, node in gj.nodes.items():
        assert gt.nodes[layer].out_shape == node.out_shape, layer
        assert gt.nodes[layer].layer.activation == node.layer.activation, layer
        assert (gt.updater.updater_for(layer).learning_rate
                == gj.updater.lr_for(layer)), layer
        assert {n: tuple(t.shape) for n, t in gt.params[layer].items()} == {
            n: tuple(a.shape) for n, a in gj.params[layer].items()}, layer
    assert gt.num_params() == gj.num_params()
    assert {l: set(d) for l, d in gt.opt_state.items()} == {
        l: set(d) for l, d in gj.opt_state.items()}


def test_dcgan_param_counts():
    """The reference's ground truth: discriminator 1,388,293 params,
    generator 6,663,433."""
    assert MT.build_discriminator(device="cpu").num_params() == 1_388_293
    assert MT.build_generator(device="cpu").num_params() == 6_663_433


def test_sync_maps_match_the_reference():
    assert MT.DIS_TO_GAN == MJ.DIS_TO_GAN
    assert MT.GAN_TO_GEN == MJ.GAN_TO_GEN
    assert MT.DIS_TO_CLASSIFIER == MJ.DIS_TO_CLASSIFIER
    assert MT.CVConfig() == MT.CVConfig(**{
        f: getattr(MJ.CVConfig(), f) for f in MJ.CVConfig.__dataclass_fields__})


def test_sync_params_aliases_tensors(dcgan_pair):
    dis, gan = dcgan_pair[1]["dis"], dcgan_pair[1]["gan"]
    MT.sync_params(gan, dis, MT.DIS_TO_GAN)
    for dst, src, names in MT.DIS_TO_GAN:
        for n in names:
            assert gan.get_param(dst, n) is dis.get_param(src, n)


@pytest.mark.parametrize("seed,difficulty", [(666, "calibrated"), (3, "v1")])
def test_synthetic_mnist_is_byte_equal(seed, difficulty):
    fj, lj = mnist_jax(300, seed=seed, difficulty=difficulty, chunk=128)
    ft, lt = mnist_torch(300, seed=seed, difficulty=difficulty, chunk=128)
    assert ft.dtype == fj.dtype and lt.dtype == lj.dtype
    assert ft.tobytes() == fj.tobytes() and lt.tobytes() == lj.tobytes()


def test_interop_round_trip_and_checks():
    rng = np.random.RandomState(1)
    tree = {"a": {"W": rng.randn(3, 2).astype(np.float32)}, "b": {}}
    t = interop.params_from_numpy(tree, "cpu")
    assert t["a"]["W"].dtype == torch.float32 and t["b"] == {}
    back = interop.opt_state_to_numpy(interop.opt_state_from_numpy(tree, "cpu"))
    assert back["a"]["W"].tobytes() == tree["a"]["W"].tobytes()
    with pytest.raises(ValueError, match="shape"):
        interop.params_from_numpy({"a": {"W": np.zeros((2, 3))}, "b": {}}, "cpu", like=t)
    with pytest.raises(ValueError, match="param names"):
        interop.params_from_numpy({"a": {"V": np.zeros((3, 2))}, "b": {}}, "cpu", like=t)
    with pytest.raises(ValueError, match="layer names"):
        interop.params_from_numpy({"a": tree["a"]}, "cpu", like=t)
