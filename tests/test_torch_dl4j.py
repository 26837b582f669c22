"""The port's DL4J ModelSerializer interop (``graph/dl4j_import.py``)
against the JAX package's, on the CPU: the ND4J codec byte for byte, the
JAX test's hand-written beta3 fixtures, and zips crossing the packages in
both directions with bitwise-equal parameters and updater state.

Within the port a round trip is bitwise in params and outputs; across the
packages the params are bitwise and the outputs agree within f32 order
noise (``OUT_RTOL`` / ``OUT_ATOL``: the two frameworks' convolutions and
matmuls sum in different orders).
"""

import io
import json
import struct
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_dl4j_import as JT
from gan_deeplearning4j_tpu.graph import dl4j_import as DJ
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.models import mlpgan_insurance as IJ
from gan_deeplearning4j_tpu.optim.rmsprop import RmsProp as RmsPropJ
from gan_deeplearning4j_tpu_torch.graph import dl4j_import as DT
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as IT
from gan_deeplearning4j_tpu_torch.optim.adam import Adam as AdamT
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp as RmsPropT

OUT_RTOL, OUT_ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return {l: {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in lp.items()}
            for l, lp in tree.items()}


def _assert_trees_equal(a, b):
    a, b = _np_tree(a), _np_tree(b)
    assert sorted(a) == sorted(b)
    for layer in a:
        assert sorted(a[layer]) == sorted(b[layer]), layer
        for k in a[layer]:
            assert a[layer][k].dtype == b[layer][k].dtype == np.float32
            np.testing.assert_array_equal(a[layer][k], b[layer][k],
                                          err_msg=f"{layer}.{k}")


# -- the ND4J codec ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 3), (2, 3, 4), (1, 1), (1, 1000)])
def test_nd4j_records_are_the_jax_bytes(shape):
    """``write_nd4j`` writes the JAX writer's bytes, and either reader
    reads either writer's record back exactly."""
    arr = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    bt, bj = io.BytesIO(), io.BytesIO()
    DT.write_nd4j(bt, arr)
    DJ.write_nd4j(bj, arr)
    assert bt.getvalue() == bj.getvalue()
    for reader in (DT.read_nd4j, DJ.read_nd4j):
        got = reader(io.BytesIO(bt.getvalue()))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, arr)


def test_nd4j_reader_is_header_tolerant():
    """Any allocation-mode token and DOUBLE data, as the JAX reader."""
    buf = io.BytesIO()

    def utf(s):
        b = s.encode()
        buf.write(struct.pack(">H", len(b)) + b)

    info = [2, 1, 3, 3, 1, 0, 1, ord("c")]
    utf("DIRECT")
    buf.write(struct.pack(">q", len(info)))
    utf("LONG")
    buf.write(struct.pack(f">{len(info)}q", *info))
    utf("HEAP")
    buf.write(struct.pack(">q", 3))
    utf("DOUBLE")
    buf.write(struct.pack(">3d", 0.5, 1.5, -2.0))
    np.testing.assert_array_equal(DT.read_nd4j(io.BytesIO(buf.getvalue())),
                                  np.float32([[0.5, 1.5, -2.0]]))


# -- the JAX test's hand-written fixtures --------------------------------------

def test_handwritten_beta3_fixture_imports(tmp_path):
    """The JAX test's fixture (dense -> BN -> softmax output, f-order
    dense weights, unknown fields, junk updater state) imports into the
    port's graph with its values, and its forward is the hand numpy
    computation; the JAX import of the same zip holds the same params."""
    path = str(tmp_path / "fixture.zip")
    d1_w, d1_b, gamma, beta, mean, var, out_w, out_b = JT._fixture_zip(path)
    g = DT.import_dl4j(path, device="cpu")
    assert g.device.type == "cpu"
    for layer, k, want in (("d1", "W", d1_w), ("d1", "b", d1_b),
                           ("bn", "gamma", gamma), ("bn", "beta", beta),
                           ("bn", "mean", mean), ("bn", "var", var),
                           ("out", "W", out_w), ("out", "b", out_b)):
        np.testing.assert_array_equal(g.get_param(layer, k).numpy(), want)
    _assert_trees_equal(g.params, DJ.import_dl4j(path).params)
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    h = np.tanh(x @ d1_w + d1_b)
    h = gamma * (h - mean) / np.sqrt(var + np.float32(1e-5)) + beta
    logits = h @ out_w + out_b
    want = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    got = g.output(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_conv_fixture_pins_bias_first_segmentation(tmp_path):
    """A convolution's params view is bias-first, OIHW row-major."""
    ns = "org.deeplearning4j.nn.conf"
    conf = {
        "networkInputs": ["in"], "networkOutputs": ["c"],
        "vertexInputs": {"c": ["in"]},
        "vertices": {"c": {"@class": f"{ns}.graph.LayerVertex",
                           "layerConf": {"layer": {
                               "@class": f"{ns}.layers.ConvolutionLayer",
                               "kernelSize": [2, 2], "stride": [1, 1],
                               "padding": [0, 0], "nin": 2, "nout": 3,
                               "convolutionMode": "Truncate",
                               "activationFn": {
                                   "@class": "org.nd4j.linalg.activations."
                                   "impl.ActivationIdentity"}}}}},
        "inputTypes": [{"@class": f"{ns}.inputs.InputType$"
                        "InputTypeConvolutional", "channels": 2,
                        "height": 4, "width": 4}],
    }
    bias = np.float32([10.0, 20.0, 30.0])
    kern = np.arange(24, dtype=np.float32).reshape(3, 2, 2, 2)
    coeffs = io.BytesIO()
    DJ.write_nd4j(coeffs, np.concatenate([bias, kern.ravel()]).reshape(1, -1))
    p = str(tmp_path / "conv.zip")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", coeffs.getvalue())
    g = DT.import_dl4j(p, device="cpu")
    np.testing.assert_array_equal(g.get_param("c", "b").numpy(), bias)
    np.testing.assert_array_equal(g.get_param("c", "W").numpy(), kern)


# -- zips crossing the packages --------------------------------------------------

def _models():
    """name -> (port graph on the CPU, JAX graph holding its params, a
    batch): the CV discriminator and generator at full width (conv, BN,
    max-pool, dense; FeedForwardToCnn, upsampling) and the insurance
    discriminator, with non-trivial BN statistics."""
    rng = np.random.RandomState(3)
    out = {}
    for name, tb, jb, x in (
            ("cv_dis", lambda: MT.build_discriminator(device="cpu"),
             MJ.build_discriminator, rng.rand(4, 784)),
            ("cv_gen", lambda: MT.build_generator(device="cpu"),
             MJ.build_generator, rng.rand(3, 2) * 2 - 1),
            ("ins_dis", lambda: IT.build_discriminator(device="cpu"),
             IJ.build_discriminator, rng.rand(7, 12))):
        gt, gj = tb(), jb()
        for layer, lp in gt.params.items():
            if "mean" in lp:
                n = lp["mean"].shape
                gt.set_layer_params(layer, {
                    "mean": torch.from_numpy(
                        0.2 * rng.randn(*n).astype(np.float32)),
                    "var": torch.from_numpy(
                        (1 + 0.3 * rng.rand(*n)).astype(np.float32))})
        gj.params = jax.tree.map(jnp.asarray, _np_tree(gt.params))
        out[name] = (gt, gj, x.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("name", ["cv_dis", "cv_gen", "ins_dis"])
def test_zips_cross_the_packages_bitwise(tmp_path, models, name):
    """The port's zip: the port reads it back with bitwise params and
    outputs, the JAX package with bitwise params; the JAX package's zip of
    the same graph: the port reads it with bitwise params, and its
    configuration is the port's; the outputs agree across the packages
    within ``OUT_RTOL`` / ``OUT_ATOL``."""
    gt, gj, x = models[name]
    pt, pj = str(tmp_path / "t.zip"), str(tmp_path / "j.zip")
    DT.export_dl4j(gt, pt)
    DJ.export_dl4j(gj, pj)
    back = DT.import_dl4j(pt, device="cpu")
    _assert_trees_equal(back.params, gt.params)
    xt = torch.from_numpy(x)
    assert torch.equal(back.output(xt)[0], gt.output(xt)[0])
    _assert_trees_equal(DJ.import_dl4j(pt).params, gt.params)
    from_j = DT.import_dl4j(pj, device="cpu")
    _assert_trees_equal(from_j.params, gt.params)
    with zipfile.ZipFile(pt) as zt, zipfile.ZipFile(pj) as zj:
        assert json.loads(zt.read("configuration.json")) == json.loads(
            zj.read("configuration.json"))
        assert zt.read("coefficients.bin") == zj.read("coefficients.bin")
    np.testing.assert_allclose(from_j.output(xt)[0].numpy(),
                               np.asarray(gj.output(x)[0]),
                               rtol=OUT_RTOL, atol=OUT_ATOL)


def test_updater_state_crosses_both_ways(tmp_path):
    """RmsProp state after a few fits: the port's ``updaterState.bin`` is
    the JAX writer's bytes for the same state, each package restores the
    other's into its RmsProp state bitwise (BN mean/var keep no state),
    and ``load_updater=False`` leaves a fresh optimizer."""
    upd_t, upd_j = RmsPropT(0.05, 0.95, 1e-8), RmsPropJ(0.05, 0.95, 1e-8)
    from gan_deeplearning4j_tpu_torch.graph import (
        BatchNorm, Dense, GraphBuilder, InputSpec, Output)

    b = GraphBuilder(seed=666, activation="tanh", clip_threshold=1.0)
    b.add_inputs("in")
    b.set_input_types(InputSpec.feed_forward(6))
    b.add_layer("d1", Dense(n_out=16, updater=upd_t), "in")
    b.add_layer("bn", BatchNorm(updater=upd_t), "d1")
    b.add_layer("out", Output(n_out=1, n_in=16, loss="xent",
                              activation="sigmoid", updater=upd_t), "bn")
    b.set_outputs("out")
    gt = b.build("cpu").init()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(40, 6).astype(np.float32))
    y = (x.sum(dim=1, keepdim=True) > 3).float()
    for _ in range(4):
        gt.fit(x, y)
    gj = JT._training_net(upd_j)
    gj.params = jax.tree.map(jnp.asarray, _np_tree(gt.params))
    gj.opt_state = jax.tree.map(jnp.asarray, _np_tree(gt.opt_state))
    pt, pj = str(tmp_path / "t.zip"), str(tmp_path / "j.zip")
    DT.export_dl4j(gt, pt, save_updater=True)
    DJ.export_dl4j(gj, pj, save_updater=True)
    with zipfile.ZipFile(pt) as zt, zipfile.ZipFile(pj) as zj:
        assert zt.read("updaterState.bin") == zj.read("updaterState.bin")
    in_j = DJ.import_dl4j(pt, updater=upd_j)
    in_t = DT.import_dl4j(pj, updater=upd_t, device="cpu")
    _assert_trees_equal(in_t.params, gt.params)
    for layer, k in (("d1", "W"), ("d1", "b"), ("bn", "gamma"),
                     ("bn", "beta"), ("out", "W"), ("out", "b")):
        want = gt.opt_state[layer][k].numpy()
        assert want.any()
        np.testing.assert_array_equal(in_t.opt_state[layer][k].numpy(), want)
        np.testing.assert_array_equal(np.asarray(in_j.opt_state[layer][k]),
                                      want)
    assert not in_t.opt_state["bn"]["mean"].any()
    fresh = DT.import_dl4j(pj, updater=upd_t, load_updater=False,
                           device="cpu")
    assert not fresh.opt_state["d1"]["W"].any()
    # a continuation from the imported state is the uninterrupted run's
    ref = DT.import_dl4j(pt, updater=upd_t, device="cpu")
    for _ in range(3):
        gt.fit(x, y)
        ref.fit(x, y)
    _assert_trees_equal(ref.params, gt.params)


def test_non_rmsprop_state_degrades_to_weights_only(tmp_path, models):
    """Adam state has no DL4J RmsProp view: the zip carries weights only,
    and they still round-trip."""
    from gan_deeplearning4j_tpu_torch.graph import (
        Dense, GraphBuilder, InputSpec, Output)

    b = GraphBuilder(seed=666, activation="tanh")
    b.add_inputs("in")
    b.set_input_types(InputSpec.feed_forward(6))
    b.add_layer("d1", Dense(n_out=8, updater=AdamT(1e-3)), "in")
    b.add_layer("out", Output(n_out=1, loss="xent", activation="sigmoid",
                              updater=AdamT(1e-3)), "d1")
    b.set_outputs("out")
    g = b.build("cpu").init()
    g.fit(torch.zeros((4, 6)), torch.zeros((4, 1)))
    p = str(tmp_path / "adam.zip")
    DT.export_dl4j(g, p, save_updater=True)
    with zipfile.ZipFile(p) as zf:
        assert "updaterState.bin" not in zf.namelist()
    _assert_trees_equal(DT.import_dl4j(p, device="cpu").params, g.params)


def test_unsupported_configs_raise(tmp_path):
    """The JAX importer's refusals, with its messages."""
    ns = "org.deeplearning4j.nn.conf"

    def zip_with_layer(layer_json):
        conf = {
            "networkInputs": ["in"], "networkOutputs": ["l"],
            "vertexInputs": {"l": ["in"]},
            "vertices": {"l": {"@class": f"{ns}.graph.LayerVertex",
                               "layerConf": {"layer": layer_json}}},
            "inputTypes": [{"@class": f"{ns}.inputs.InputType$"
                            "InputTypeConvolutional", "channels": 2,
                            "height": 8, "width": 8}],
        }
        p = str(tmp_path / "bad.zip")
        with zipfile.ZipFile(p, "w") as zf:
            zf.writestr("configuration.json", json.dumps(conf))
        return p

    for layer, match in (
            ({"@class": f"{ns}.layers.SubsamplingLayer",
              "poolingType": "AVG", "kernelSize": [2, 2]}, "poolingType"),
            ({"@class": f"{ns}.layers.ConvolutionLayer",
              "convolutionMode": "Same", "kernelSize": [3, 3], "nin": 2,
              "nout": 4}, "convolutionMode"),
            ({"@class": f"{ns}.layers.LSTM", "nin": 2, "nout": 4},
             "unsupported DL4J layer")):
        with pytest.raises(NotImplementedError, match=match):
            DT.import_dl4j(zip_with_layer(layer), device="cpu")
    p = str(tmp_path / "empty.zip")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("other.txt", "x")
    with pytest.raises(ValueError, match="not a DL4J model zip"):
        DT.import_dl4j(p, device="cpu")


# -- Keras -----------------------------------------------------------------------------

def test_a_live_keras_model_through_both_importers():
    """One live Keras model (conv, BN with moving statistics, max-pool,
    Flatten -> Dense, dropout, softmax) through the JAX importer and the
    port's: the same params bitwise, and outputs equal to Keras's own
    within the JAX test's band; the port reads the live model without
    importing keras itself."""
    keras = pytest.importorskip("keras")
    from gan_deeplearning4j_tpu.graph.keras_import import import_keras as KJ
    from gan_deeplearning4j_tpu_torch.graph.keras_import import (
        import_keras as KT,
    )

    m = keras.Sequential([
        keras.layers.Input(shape=(12, 12, 3)),
        keras.layers.Conv2D(8, 3, strides=2, activation="relu"),
        keras.layers.BatchNormalization(),
        keras.layers.Conv2D(4, 3, padding="same", activation="linear"),
        keras.layers.Activation("elu"),
        keras.layers.MaxPooling2D(pool_size=2, strides=1),
        keras.layers.Flatten(),
        keras.layers.Dense(16, activation="tanh"),
        keras.layers.Dropout(0.25),
        keras.layers.Dense(10, activation="softmax"),
    ])
    bn = m.layers[1]
    rng = np.random.RandomState(5)
    bn.set_weights([
        (1 + 0.1 * rng.randn(8)).astype(np.float32),
        (0.1 * rng.randn(8)).astype(np.float32),
        (0.2 * rng.randn(8)).astype(np.float32),
        (1 + 0.3 * rng.rand(8)).astype(np.float32)])
    gt, gj = KT(m, device="cpu"), KJ(m)
    _assert_trees_equal(gt.params, gj.params)
    x = rng.rand(4, 12, 12, 3).astype(np.float32)
    want = np.asarray(m(x, training=False))
    nchw = np.transpose(x, (0, 3, 1, 2))
    got_t = gt.output(torch.from_numpy(np.ascontiguousarray(nchw)))[0]
    np.testing.assert_allclose(got_t.numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(gj.output(nchw)[0]),
                               rtol=2e-4, atol=2e-5)
