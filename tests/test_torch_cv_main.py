"""The port's CV program held against the JAX package's, on the CPU: the
artifact set a short ``cv_main`` run writes, the training table, the two
dumps from the same params, K's resolution, and the streamed loop against
the resident one.

Tolerances: the dumps from the same params within atol 1e-5 (f32 forwards
whose convolutions the two packages sum in different orders; outputs are
O(1)).  The port's streamed run against its resident run, and its table
against the JAX iterator's, bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data.csv import RecordReaderDataSetIterator as IterJ
from gan_deeplearning4j_tpu.train import cv_main as cv_j
from gan_deeplearning4j_tpu.train.gan_trainer import GANTrainer as TrainerJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data.csv import read_csv_matrix
from gan_deeplearning4j_tpu_torch.graph import serialization
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.train import cv_main as cv_t
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
    GANTrainer,
    resolve_steps_per_call,
)

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--iterations", "2", "--batch-size", "16", "--n-train", "64",
        "--n-test", "32", "--print-every", "2", "--save-every", "2",
        "--fid-samples", "64"]
# what both runs write under ARGS ...
ARTIFACTS = {"mnist_train.csv", "mnist_test.csv", "mnist_out_2.csv",
             "mnist_test_predictions_2.csv", "mnist_metrics.jsonl",
             "evaluation_stats.txt", "mnist_dis_model.zip",
             "mnist_gan_model.zip", "mnist_gen_model.zip",
             "mnist_CV_model.zip", "events.jsonl", "run_manifest.json",
             "mnist_metrics_losses.png", "DCGAN_Generated_Images.png"}
# ... and what only the JAX run writes: nothing since the port writes the
# sample grid's PNG
JAX_ONLY = set()
SCORES = ("steps", "examples_per_sec", "d_loss", "g_loss", "test_accuracy",
          "test_f1", "fid", "fid_frozen", "fid_primary", "fid_primary_source")
DUMP_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's CPU ops on one thread while this module runs (then the
    process's setting again): the tier-1 lane runs six test processes at
    once, and torch's OpenMP pool in each, as wide as the host, spins
    against the others' (these three modules' test-seconds fell from 1,024
    to 262 s at three processes on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``cv_main.main(ARGS)`` -> {package: (dir, result)}."""
    out = {}
    for name, main, extra in (("jax", cv_j.main, []),
                              ("torch", cv_t.main, ["--device", "cpu"])):
        d = str(tmp_path_factory.mktemp(name))
        out[name] = (d, main(ARGS + extra + ["--res-path", d]))
    return out


def test_cv_main_writes_the_jax_artifact_set(runs):
    (dj, rj), (dt, rt) = runs["jax"], runs["torch"]
    assert set(os.listdir(dt)) == ARTIFACTS
    assert set(os.listdir(dj)) == ARTIFACTS | JAX_ONLY
    for f in ("mnist_train.csv", "mnist_test.csv"):
        assert Path(dt, f).read_bytes() == Path(dj, f).read_bytes()
    for f in ("mnist_out_2.csv", "mnist_test_predictions_2.csv"):
        a, b = read_csv_matrix(f"{dt}/{f}"), read_csv_matrix(f"{dj}/{f}")
        assert a.shape == b.shape and np.isfinite(a).all()
    preds = read_csv_matrix(f"{dt}/mnist_test_predictions_2.csv")
    assert preds.shape == (32, 10)
    np.testing.assert_allclose(preds.sum(axis=1), 1.0, rtol=1e-4)
    recs = [[json.loads(ln) for ln in open(f"{d}/mnist_metrics.jsonl")]
            for d in (dt, dj)]
    steps = [[r for r in rs if "step" in r] for rs in recs]
    assert [list(r) for r in steps[0]] == [list(r) for r in steps[1]]
    assert [r["step"] for r in steps[0]] == [1, 2]
    for f in ("mnist_dis_model.zip", "mnist_gan_model.zip",
              "mnist_gen_model.zip", "mnist_CV_model.zip"):
        with serialization.zipfile.ZipFile(f"{dt}/{f}") as a, \
                serialization.zipfile.ZipFile(f"{dj}/{f}") as b:
            assert a.namelist() == b.namelist()
            assert a.read("config.json") == b.read("config.json")
    stats = [Path(d, "evaluation_stats.txt").read_text().splitlines()
             for d in (dt, dj)]
    assert len(stats[0]) == len(stats[1]) == 17  # 6 lines, header, 10 rows
    assert [ln.split(":")[0] for ln in stats[0][:7]] == [
        ln.split(":")[0] for ln in stats[1][:7]]
    assert set(SCORES) <= set(rt) and set(SCORES) <= set(rj)
    assert rt["steps"] == 2 and rt["fid_primary_source"] == "fid_frozen"
    assert all(np.isfinite(rt[k]) for k in SCORES[1:-1])


def test_cv_main_records_the_jax_run_level_goodput(runs):
    """Both programs under ARGS: the result lines' goodput (the same keys
    and phases entered) and run id, the last metrics record
    ``{"goodput", "run_id"}``, the manifests' key sets equal (their
    ``versions`` name each package's stack) and the port's run id in its
    ``events.jsonl`` header."""
    (dj, rj), (dt, rt) = runs["jax"], runs["torch"]
    assert set(rt["goodput"]) == set(rj["goodput"])
    assert set(rt["goodput"]["phase_n"]) == set(rj["goodput"]["phase_n"])
    for d, r in ((dj, rj), (dt, rt)):
        last = json.loads(Path(d, "mnist_metrics.jsonl").read_text()
                          .splitlines()[-1])
        assert list(last) == ["goodput", "run_id"]
        assert last["run_id"] == r["run_id"] and len(r["run_id"]) == 12
    mj, mt = (json.load(open(f"{d}/run_manifest.json")) for d in (dj, dt))
    # the JAX program spreads its batch over the conftest's virtual CPU
    # devices (a "mesh"); the port's CPU run is one process
    assert set(mt) | {"mesh"} == set(mj) | {"mesh"}
    assert mt["run_id"] == rt["run_id"]
    head = json.loads(Path(dt, "events.jsonl").read_text().splitlines()[0])
    assert head["run_id"] == rt["run_id"]


def _trainer(d, **overrides):
    """The port's CV trainer on the CSV pair in ``d``, without training."""
    kw = dict(res_path=d, batch_size=16, num_iterations=2, print_every=2,
              save_every=2)
    cfg = cv_t.default_config(**{**kw, **overrides})
    return GANTrainer(device="cpu", config=cfg,
                      workload=cv_t.CVWorkload(n_train=64, n_test=32))


def test_training_table_is_the_jax_iterators_table(runs):
    d = runs["torch"][0]
    t = _trainer(d)
    it = IterJ(f"{d}/mnist_train.csv", 16, 784, 10)
    np.testing.assert_array_equal(t.features.numpy().view(np.uint32),
                                  it.features.view(np.uint32))
    np.testing.assert_array_equal(t.labels.numpy(), it.labels)


def test_dumps_agree_with_jax_from_the_same_params(runs, tmp_path):
    """``_dump_grid`` and ``_dump_predictions`` of the JAX trainer and of
    the port's, the port's generator and classifier carrying the JAX
    graphs' params."""
    src = runs["torch"][0]
    dirs = {}
    for k in ("j", "t"):
        dirs[k] = str(tmp_path / k)
        os.makedirs(dirs[k])
        for f in ("mnist_train.csv", "mnist_test.csv"):
            Path(dirs[k], f).write_bytes(Path(src, f).read_bytes())
    tj = TrainerJ(cv_j.CVWorkload(n_train=64, n_test=32), cv_j.default_config(
        res_path=dirs["j"], batch_size=16, num_iterations=2, metrics=False))
    tt = _trainer(dirs["t"], metrics=False)
    for g in ("gen", "classifier"):
        live = getattr(tt, g)
        live.params = interop.params_from_numpy(
            jax.tree.map(np.asarray, getattr(tj, g).params), "cpu",
            like=live.params)
    tj.batch_counter = tt.steps = 2
    tj._dump_grid()
    tj._dump_predictions(IterJ(f"{dirs['j']}/mnist_test.csv", 500, 784, 10))
    tt._dump_grid()
    tt._dump_predictions()
    for f in ("mnist_out_2.csv", "mnist_test_predictions_2.csv"):
        a = read_csv_matrix(f"{dirs['t']}/{f}")
        b = read_csv_matrix(f"{dirs['j']}/{f}")
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=DUMP_ATOL)


# (iterations, print, save, checkpoint, cap, byte cap, codec, start step)
_K_CASES = [
    (10000, 100, 100, 0, None, None, None, 0),
    (250, 100, 100, 0, None, None, None, 0),
    (200, 100, 50, 0, None, None, None, 0),
    (300, 100, 75, 0, None, None, None, 0),
    (1000, 100, 100, 300, None, None, None, 0),
    (20, 10, 10, 0, 8, None, None, 0),
    (7, 7, 7, 0, 4, None, None, 0),
    (200, 100, 100, 0, None, 100 * 200 * (5 * 784 + 40), "u8x100", 0),
    (200, 100, 100, 0, None, 100 * 200 * (5 * 784 + 40), None, 0),
    (200, 100, 100, 0, None, 50 * 200 * (4 * 784 + 40), None, 0),
    (200, 100, 100, 0, None, 30 * 200 * (4 * 784 + 40), None, 0),
    (200, 100, 100, 0, 40, 256 << 20, None, 0),
    (200, 100, 100, 0, None, 0, None, 0),
    (400, 100, 100, 0, None, 256 << 20, None, 40),
    (400, 100, 100, 0, None, None, None, 40),
]


@pytest.mark.parametrize("case", _K_CASES)
def test_resolve_steps_per_call_matches_jax(case):
    """The port's rule (the module function with the checkpoint cadence
    too; the trainer's method, whose cadences are print and save) against
    the JAX trainer's ``_resolve_steps_per_call``."""
    iters, pe, se, ce, cap, byte_cap, codec, start = case
    kw = dict(num_iterations=iters, print_every=pe, save_every=se,
              steps_per_call=cap)
    ref = TrainerJ._resolve_steps_per_call(
        SimpleNamespace(c=cv_j.default_config(checkpoint_every=ce, **kw),
                        batch_counter=start),
        byte_cap=byte_cap, codec=codec)
    feat_bytes = 5 if codec == "u8x100" else 4
    got = resolve_steps_per_call(iters, cap, cadences=(pe, se, ce),
                                 byte_cap=byte_cap,
                                 step_bytes=200 * (feat_bytes * 784 + 40),
                                 start_step=start)
    assert got == ref
    if not ce:  # the trainer's own cadences: print and save
        assert GANTrainer._resolve_steps_per_call(
            SimpleNamespace(c=cv_t.default_config(**kw), steps=start),
            byte_cap=byte_cap, codec=codec) == ref


def _twelve_steps(d, resident: bool, use_data_codec: bool):
    """12 steps over 4 full batches a pass, resident or streamed (K = 3:
    chunks cross passes) -> (every step's losses, the final state)."""
    fb = 5 if use_data_codec else 4
    kw = dict(num_iterations=12, print_every=0, save_every=0, metrics=False,
              use_data_codec=use_data_codec)
    if not resident:
        # the plain chunk tier: with the dedup tier on auto, one chunk of
        # the 12-step run would cover the 4-batch pass
        kw.update(data_on_device=False, stream_dedup=False,
                  stream_chunk_bytes=3 * 16 * (fb * 784 + 40))
    t = _trainer(d, **kw)
    t.c.res_path = None  # no model zips
    r = t.train(log=None)
    assert (r["resident"], r["steps_per_call"]) == (resident, 3 if not
                                                    resident else 12)
    assert r["data_codec"] == ("u8x100" if use_data_codec and not resident
                               else None)
    return ([[x[k] for k in ("d_loss", "g_loss", "classifier_loss")]
             for x in t.metrics.records() if "step" in x], t.state)


@pytest.fixture(scope="module")
def resident_run(runs):
    """The resident f32 run both streamed cases are held to (the table
    fits, so the codec option changes nothing on it)."""
    return _twelve_steps(runs["torch"][0], True, True)


@pytest.mark.parametrize("use_data_codec", [True, False])
def test_streamed_losses_are_bitwise_the_resident_run(runs, resident_run,
                                                      use_data_codec):
    """12 steps over 4 full batches a pass (K = 3: chunks cross passes),
    streamed (u8 codes, or f32) against resident: every step's losses and
    the final state bit for bit."""
    la, sa = resident_run
    lb, sb = _twelve_steps(runs["torch"][0], False, use_data_codec)
    assert la == lb and len(la) == 12
    for (f, ta), (_, tb) in zip(FT.state_trees(sa), FT.state_trees(sb)):
        for layer, lp in ta.items():
            for n, v in lp.items():
                assert v.equal(tb[layer][n]), (f, layer, n)


def test_trainer_refuses_mixed_options():
    with pytest.raises(ValueError, match="not both"):
        GANTrainer(batch_size=8, device="cpu",
                   config=cv_t.default_config(res_path=None))


def test_cv_main_two_gloo_ranks(tmp_path):
    """``--n-devices 2``: this process writes the CSV pair, both ranks
    decode it and train, rank 0 alone dumps, saves and evaluates."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.train.cv_main",
         *ARGS, "--device", "cpu", "--n-devices", "2", "--res-path",
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=400)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (result["world"], result["steps"], result["backend"]) == (
        2, 2, "gloo")
    assert set(SCORES) <= set(result)
    assert set(os.listdir(tmp_path)) == ARTIFACTS
    back = serialization.read_model(str(tmp_path / "mnist_gen_model.zip"),
                                    "cpu")
    assert set(back.params) == set(MT.build_generator(device="cpu").params)

