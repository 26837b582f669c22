"""The frozen extractors' recipes (``eval/fid_extractor.py``
``build_extractor*``, ``train_extractor*``, ``save_asset``, ``main``) held
against the JAX package's on the CPU: each architecture's parameter names
and shapes equal to the committed zip's; the recipe's constants and its
batch-index stream byte-equal to JAX's; a few ``fit`` steps of each
recipe's graph from JAX's init carried across (``interop``) against JAX's
(losses 1e-4 relative, params 1e-4 absolute: RmsProp at lr 1e-3 with eps
1e-8 moves a near-zero gradient's element on its linear part, slope
lr/sqrt(eps) = 10); and ``save_asset`` / ``main`` writing only where the
caller says, by default outside the JAX package."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.eval import fid_extractor as FXJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.eval import fid_extractor as FXT

FAMILIES = ("mnist", "celeba", "cifar")
BUILD_J = {"mnist": FXJ.build_extractor, "celeba": FXJ.build_extractor_celeba,
           "cifar": FXJ.build_extractor_cifar}
# (features, target width, one-hot targets) of a recipe's rows
SHAPES = {"mnist": (784, 10, True), "celeba": (3 * 64 * 64, 8, False),
          "cifar": (3 * 32 * 32, 10, True)}
FITS = 3
FIT_BATCH = 8
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(params) -> dict:
    return {(layer, n): tuple(t.shape) for layer, lp in params.items()
            for n, t in lp.items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_the_architecture_is_the_committed_zips(family):
    built = FXT.BUILDERS[family]("cpu")
    committed = FXT._load(FXT.ASSET_PATHS[family], "cpu")
    assert _shapes(built.params) == _shapes(committed.params)
    assert list(built.nodes) == list(committed.nodes)


@pytest.mark.parametrize("family", FAMILIES)
def test_the_recipe_and_its_index_stream_are_jaxs(family):
    """Seeds, rows, batches, steps and learning rate are the JAX module's
    constants; the batch indices of the first 50 steps byte-equal to the
    JAX recipe's ``RandomState(seed).randint(0, rows, batch)`` stream."""
    pre = {"mnist": "_", "celeba": "_CELEBA_", "cifar": "_CIFAR_"}[family]
    seed, rows, batch, steps = FXT.RECIPES[family][:4]
    assert (seed, rows, batch, steps) == tuple(
        getattr(FXJ, pre + k) for k in ("SEED", "N_TRAIN", "BATCH", "STEPS"))
    assert getattr(FXT, pre + "LR") == getattr(FXJ, pre + "LR")
    order = np.random.RandomState(getattr(FXJ, pre + "SEED"))
    want = b"".join(order.randint(0, getattr(FXJ, pre + "N_TRAIN"),
                                  getattr(FXJ, pre + "BATCH")).tobytes()
                    for _ in range(50))
    assert b"".join(i.tobytes() for i in FXT.batch_order(family, 50)) == want


@pytest.mark.parametrize("family", FAMILIES)
def test_fits_from_jax_init_match_jax(family):
    """``FITS`` fit steps on the same batches (small, drawn by numpy) from
    the JAX graph's init carried into the port's graph."""
    F, width, onehot = SHAPES[family]
    rng = np.random.RandomState(7)
    lo = 0.0 if family == "mnist" else -1.0
    x = rng.uniform(lo, 1.0, (FITS, FIT_BATCH, F)).astype(np.float32)
    if onehot:
        y = np.eye(width, dtype=np.float32)[rng.randint(0, width,
                                                        (FITS, FIT_BATCH))]
    else:
        y = (rng.rand(FITS, FIT_BATCH, width) < 0.5).astype(np.float32)
    gj = BUILD_J[family]()
    gt = FXT.BUILDERS[family]("cpu")
    gt.params = interop.params_from_numpy(
        jax.tree.map(np.array, gj.params), "cpu", like=gt.params)
    gt.opt_state = interop.opt_state_from_numpy(
        jax.tree.map(np.array, gj.opt_state), "cpu", like=gt.opt_state)
    for s in range(FITS):
        lj = float(gj.fit(x[s], y[s]))
        lt = float(gt.fit(torch.from_numpy(x[s]), torch.from_numpy(y[s])))
        assert lt == pytest.approx(lj, rel=LOSS_RTOL), (family, s)
    want = jax.tree.map(np.array, gj.params)
    got = interop.params_to_numpy(gt.params)
    worst = max(float(np.abs(got[layer][n] - a).max())
                for layer, lp in want.items() for n, a in lp.items())
    assert worst <= PARAM_ATOL, (family, worst)


def test_save_asset_writes_only_where_told(tmp_path, monkeypatch):
    """The default path is under ``outputs/`` of the working directory,
    outside the JAX package; an explicit path is used as given; the zip
    reads back as the graph (params only)."""
    jax_pkg = os.path.dirname(os.path.dirname(FXT.ASSET_PATH))
    for family in FAMILIES:
        default = os.path.abspath(FXT.default_asset_path(family))
        assert not default.startswith(jax_pkg + os.sep)
        assert FXT.default_asset_path(family).startswith("outputs")
    monkeypatch.chdir(tmp_path)
    g = FXT.build_extractor("cpu")
    before = {f: os.path.getmtime(p) for f, p in FXT.ASSET_PATHS.items()}
    path = FXT.save_asset(g, family="mnist")
    assert os.path.abspath(path) == str(
        tmp_path / "outputs" / "fid_extractors" / "fid_extractor_v1.zip")
    back = FXT._load(path, "cpu")
    assert all(torch.equal(back.params[layer][n], t)
               for layer, lp in g.params.items() for n, t in lp.items())
    mine = str(tmp_path / "elsewhere" / "x.zip")
    assert FXT.save_asset(g, mine) == mine and os.path.exists(mine)
    assert {f: os.path.getmtime(p) for f, p in FXT.ASSET_PATHS.items()} \
        == before


def test_main_scores_and_writes_the_retrained_extractor(tmp_path, capsys,
                                                        monkeypatch):
    """``main --family cifar --out P --device cpu`` with the recipe cut to
    2 steps: one JSON line with the held-out scores of the retrained and
    the committed extractor, the asset at P."""
    short = FXT.TRAINERS["cifar"]
    monkeypatch.setitem(FXT.TRAINERS, "cifar", lambda device: short(
        device, log=None, steps=2))
    monkeypatch.setattr(FXT, "held_out_set", lambda family: (
        np.random.RandomState(0).uniform(-1, 1, (40, 3 * 32 * 32)).astype(
            np.float32), np.arange(40) % 10))
    out = str(tmp_path / "cifar.zip")
    res = FXT.main(["--family", "cifar", "--out", out, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["path"] == out and os.path.exists(out)
    assert 0.0 <= res["held_out_score"] <= 1.0
    assert 0.0 <= res["committed_score"] <= 1.0
