"""The port's model zips held against the JAX package's, on the CPU: the
four DCGAN graphs written by both packages from the same numpy params and
updater state are byte-equal, each package reads the other's zips to equal
arrays, and the committed frozen FID extractor read and written again by
the port is byte-equal to the JAX package's read-and-write of it.  A
layer's ``bf16_matmul`` rides the zip as set (CelebA with ``bf16=True``
byte-equal both ways), and each main runs under ``--bf16`` / ``--mp`` on
the CPU through its evaluation and its zips.
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
    # a layer kind neither package defines (Sgd, refused here before the
    # port had it, is read and written back in test_torch_updaters.py)
    ({"__type__": "Attention"}, "layer type 'Attention' is not ported")])
def test_what_the_port_cannot_run_raises(tmp_path, changes, match):
    path = _with_layer(fx_t.ASSET_PATH, str(tmp_path / "x.zip"), **changes)
    with pytest.raises(NotImplementedError, match=match):
        ser_t.read_model(path, "cpu")


@pytest.mark.parametrize("flag", [True, False])
def test_a_zip_with_bf16_matmul_loads_and_keeps_it(tmp_path, flag):
    """A layer's ``bf16_matmul`` set in a zip (refused before the port had
    the field) is read into the layer and written back as it was."""
    path = _with_layer(fx_t.ASSET_PATH, str(tmp_path / "x.zip"),
                       bf16_matmul=flag)
    g = ser_t.read_model(path, "cpu")
    first = next(iter(g.nodes.values())).layer
    assert first.bf16_matmul is flag
    assert ser_t.graph_config_to_dict(g)["nodes"][0]["layer"][
        "bf16_matmul"] is flag


def test_celeba_zips_with_bf16_are_byte_equal_both_ways(tmp_path):
    """CelebA graphs built with ``CelebAConfig(bf16=True)`` (small width):
    every contraction layer carries ``bf16_matmul: true``; both packages
    write the same bytes, and each reads the other's zip to a graph whose
    config (the field included) and params are the writer's."""
    from gan_deeplearning4j_tpu.models import dcgan_celeba as CJ
    from gan_deeplearning4j_tpu_torch.models import dcgan_celeba as CT

    cj = dataclasses.replace(CJ.CelebAConfig(), base_filters=4, z_size=8,
                             bf16=True)
    ct = dataclasses.replace(CT.CelebAConfig(), base_filters=4, z_size=8,
                             bf16=True)
    for bj, bt in ((CJ.build_generator, CT.build_generator),
                   (CJ.build_discriminator, CT.build_discriminator)):
        gj, gt = bj(cj), bt(ct, "cpu")
        # both graphs from one numpy tree (jax.tree.map's key order)
        params = _numpy(gj.params)
        gj.params = jax.tree.map(jax.numpy.asarray, params)
        gt.params = interop.params_from_numpy(params, "cpu", like=gt.params)
        flags = {n: getattr(node.layer, "bf16_matmul", "absent")
                 for n, node in gt.nodes.items()}
        assert {n: f for n, f in flags.items() if f != "absent"} == {
            n: True for n, node in gt.nodes.items()
            if type(node.layer).__name__ in ("Dense", "Output", "Conv2D",
                                             "ConvTranspose2D")}
        zj = _zip(ser_j, gj, tmp_path, "j")
        assert _zip(ser_t, gt, tmp_path, "t") == zj
        back_t = ser_t.read_model(str(tmp_path / "j.zip"), "cpu")
        back_j = ser_j.read_model(str(tmp_path / "t.zip"))
        assert (ser_t.graph_config_to_dict(back_t)
                == ser_j.graph_config_to_dict(back_j))
        assert {n: node.layer.bf16_matmul for n, node in back_t.nodes.items()
                if n in flags and flags[n] is True} == {
            n: True for n, f in flags.items() if f is True}
        _assert_trees_equal(back_t.params, gj.params)
        _assert_trees_equal(gt.params, back_j.params)


@pytest.mark.parametrize("main,argv", [
    ("cv_main", ["--mp", "--iterations", "2", "--batch-size", "8",
                 "--n-train", "16", "--n-test", "16", "--print-every", "2",
                 "--save-every", "2", "--fid-samples", "16"]),
    ("insurance_main", ["--bf16", "--mp", "--iterations", "2",
                        "--batch-size", "10", "--print-every", "2",
                        "--save-every", "2"])])
def test_protocol_mains_run_under_the_precision_flags(tmp_path, main, argv):
    """Each protocol main under its flags runs two steps on the CPU and
    finishes its evaluation: the dumps and the scores go through the
    host's f32 copies of the bf16 heads (numpy has no bf16), and the zips
    hold f32 params."""
    import importlib

    mod = importlib.import_module(f"gan_deeplearning4j_tpu_torch.train.{main}")
    result = mod.main(argv + ["--device", "cpu", "--res-path", str(tmp_path)])
    assert result["steps"] == 2 and result["precision"]["compute_bf16"]
    assert all(np.isfinite(result[k]) for k in ("d_loss", "g_loss"))
    if main == "cv_main":
        assert 0.0 <= result["test_accuracy"] <= 1.0
        assert np.isfinite(result["fid_frozen"]) and np.isfinite(result["fid"])
    else:
        assert 0.0 <= result["test_auroc"] <= 1.0
    prefix = "mnist" if main == "cv_main" else "insurance"
    g = ser_t.read_model(str(tmp_path / f"{prefix}_gen_model.zip"), "cpu")
    assert all(t.dtype == torch.float32 for lp in g.params.values()
               for t in lp.values())


@pytest.mark.parametrize("family,flags", [
    ("wgan-gp", ["--mp"]), ("cgan-cifar10", ["--bf16", "--mp"])])
def test_roadmap_families_run_under_the_precision_flags(tmp_path, family,
                                                        flags):
    """``roadmap_main``'s other two families under the flags: two
    iterations on the CPU at full width with finite losses and the sample
    grid written (through the host's f32 copy).  cgan-cifar10's
    conditional evaluation under ``--mp`` is
    ``test_torch_precision_pair.test_conditional_evaluation_under_mp``."""
    from gan_deeplearning4j_tpu_torch.train import roadmap_main

    extra = (["--n-train", "40", "--fidelity-steps", "0"]
             if family == "cgan-cifar10" else ["--n-train", "24"])
    result = roadmap_main.main(
        ["--family", family, "--iterations", "2", "--batch-size", "8",
         "--print-every", "2", "--device", "cpu", "--res-path",
         str(tmp_path), *flags, *extra])
    assert result["steps"] == 2 and result["precision"]["compute_bf16"]
    assert np.isfinite(result["d_loss"]) and np.isfinite(result["g_loss"])
    assert (tmp_path / f"{family}_samples_2.png").exists()
