"""The port's model zips held against the JAX package's, on the CPU: the
four DCGAN graphs written by both packages from the same numpy params and
updater state are byte-equal, each package reads the other's zips to equal
arrays, and the committed frozen FID extractor read and written again by
the port is byte-equal to the JAX package's read-and-write of it.
"""

import dataclasses
import io
import json
import zipfile

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.eval import fid_extractor as fx_j
from gan_deeplearning4j_tpu.graph import serialization as ser_j
from gan_deeplearning4j_tpu.graph.layers import LAYER_TYPES as LAYERS_J
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.eval import fid_extractor as fx_t
from gan_deeplearning4j_tpu_torch.graph import serialization as ser_t
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT

GRAPHS = ("dis", "gen", "gan", "classifier")


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def pairs():
    """{name: (jax graph, port graph)} holding the same params and a
    nonzero updater state (random caches from a seed)."""
    dj = MJ.build_discriminator()
    dt = MT.build_discriminator(device="cpu")
    graphs = {"dis": (dj, dt),
              "gen": (MJ.build_generator(), MT.build_generator(device="cpu")),
              "gan": (MJ.build_gan(), MT.build_gan(device="cpu")),
              "classifier": (MJ.build_classifier(dj), MT.build_classifier(dt))}
    rng = np.random.RandomState(0)
    for gj, gt in graphs.values():
        params = _numpy(gj.params)
        opt = {layer: {n: np.abs(rng.randn(*a.shape)).astype(np.float32)
                       for n, a in lp.items()}
               for layer, lp in _numpy(gj.opt_state).items()}
        gj.params = jax.tree.map(jax.numpy.asarray, params)
        gj.opt_state = jax.tree.map(jax.numpy.asarray, opt)
        gt.params = interop.params_from_numpy(params, "cpu", like=gt.params)
        gt.opt_state = interop.opt_state_from_numpy(opt, "cpu",
                                                    like=gt.opt_state)
    return graphs


def _zip(mod, graph, tmp_path, tag) -> bytes:
    path = str(tmp_path / f"{tag}.zip")
    mod.write_model(graph, path)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", GRAPHS)
def test_model_zips_are_byte_equal(pairs, tmp_path, name):
    gj, gt = pairs[name]
    zj = _zip(ser_j, gj, tmp_path, "j")
    zt = _zip(ser_t, gt, tmp_path, "t")
    assert zt == zj
    with zipfile.ZipFile(io.BytesIO(zt)) as zf:
        assert [(i.filename, i.compress_type, i.date_time)
                for i in zf.infolist()] == [
            ("config.json", zipfile.ZIP_DEFLATED, ser_t._ZIP_EPOCH),
            ("params.npz", zipfile.ZIP_STORED, ser_t._ZIP_EPOCH),
            ("updater.npz", zipfile.ZIP_STORED, ser_t._ZIP_EPOCH)]


def _assert_trees_equal(t, j):
    """Equal layers, param names (in order) and arrays; a read-back tree
    lists its param-less layers last, as the JAX reader's does."""
    assert sorted(t) == sorted(j)
    for layer, lp in j.items():
        assert list(t[layer]) == list(lp), layer
        for n, a in lp.items():
            np.testing.assert_array_equal(t[layer][n].numpy(), np.asarray(a))


@pytest.mark.parametrize("name", GRAPHS)
def test_each_package_reads_the_others_zips(pairs, tmp_path, name):
    """JAX-written -> port: equal params and updater state, and the port's
    rewrite is the same bytes; that port-written zip -> JAX: equal arrays,
    and JAX's rewrite is the same bytes again."""
    gj, gt = pairs[name]
    zj = _zip(ser_j, gj, tmp_path, "j")
    back_t = ser_t.read_model(str(tmp_path / "j.zip"), "cpu")
    assert list(back_t.params) == list(
        ser_j.read_model(str(tmp_path / "j.zip")).params)
    _assert_trees_equal(back_t.params, gj.params)
    _assert_trees_equal(back_t.opt_state, gj.opt_state)
    assert back_t.frozen == gt.frozen
    assert back_t.updater.layer_updaters == gt.updater.layer_updaters
    assert _zip(ser_t, back_t, tmp_path, "t") == zj
    back_j = ser_j.read_model(str(tmp_path / "t.zip"))
    _assert_trees_equal(gt.params, back_j.params)
    _assert_trees_equal(gt.opt_state, back_j.opt_state)
    assert _zip(ser_j, back_j, tmp_path, "jj") == zj


def test_read_graph_runs_like_the_original(pairs, tmp_path):
    """A graph read back from its zip gives the original's inference
    output bit for bit (the topology, preprocessors and BN statistics all
    survive the file)."""
    _, gt = pairs["gen"]
    _zip(ser_t, gt, tmp_path, "t")
    back = ser_t.read_model(str(tmp_path / "t.zip"), "cpu")
    z = torch.from_numpy(np.random.RandomState(3).rand(5, 2).astype(np.float32))
    assert torch.equal(back.output(z)[0], gt.output(z)[0])


def test_frozen_extractor_round_trip_is_byte_equal(tmp_path):
    """The committed ``fid_extractor_v1.zip`` (no updater.npz: fresh caches
    on read), read and written again by each package: the same bytes."""
    gj = ser_j.read_model(fx_j.ASSET_PATH)
    gt = ser_t.read_model(fx_t.ASSET_PATH, "cpu")
    assert fx_t.ASSET_PATH == fx_j.ASSET_PATH
    assert _zip(ser_t, gt, tmp_path, "t") == _zip(ser_j, gj, tmp_path, "j")
    _assert_trees_equal(gt.params, gj.params)


@pytest.mark.parametrize("kind", ["Dense", "Output", "Conv2D", "MaxPool2D",
                                  "Upsampling2D", "BatchNorm", "Dropout",
                                  "ConvTranspose2D", "MinibatchStdDev",
                                  "Merge", "ElementWise",
                                  "ConditionalBatchNorm", "ProjectionOutput"])
def test_file_fields_are_the_jax_dataclass_fields(kind):
    assert ser_t._FILE_FIELDS[kind] == tuple(
        f.name for f in dataclasses.fields(LAYERS_J[kind]))


def _with_layer(path, out, **changes):
    """A copy of model zip ``path`` whose first node's layer has
    ``changes``."""
    with zipfile.ZipFile(path) as zf:
        cfg = json.loads(zf.read("config.json"))
        params = zf.read("params.npz")
    cfg["nodes"][0]["layer"].update(changes)
    with zipfile.ZipFile(out, "w") as zf:
        zf.writestr("config.json", json.dumps(cfg))
        zf.writestr("params.npz", params)
    return out


@pytest.mark.parametrize("changes,match", [
    ({"updater": {"__type__": "Sgd", "learning_rate": 1e-3}},
     "ROADMAP Queue 1 item 8"),
    ({"bf16_matmul": True}, "bf16_matmul")])
def test_what_the_port_cannot_run_raises(tmp_path, changes, match):
    path = _with_layer(fx_t.ASSET_PATH, str(tmp_path / "x.zip"), **changes)
    with pytest.raises(NotImplementedError, match=match):
        ser_t.read_model(path, "cpu")
