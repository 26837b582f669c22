"""The port's insurance program (MLP-GAN on 4x3 transaction lattices) held
against the JAX package's, on the CPU, at the reference's own widths
(hidden 100, 12 features, z 2) and small batches.

Every random draw is the JAX side's, carried into the port: the graphs'
Xavier init and RmsProp caches through ``interop``, the latents z1/z2 of
the JAX step's counter-based stream, and the label-softening vectors.
One module fixture runs the JAX side once.

Covered: the CSV pair (byte-equal) and the decoded table (bitwise); the
four graphs' structure, input inference, resolved activations, and
forward and backward on carried params; the BN kernel's plain versions at
the insurance shapes and activations against the Pallas kernels in
interpret mode; one protocol step and three steps against the JAX step;
the AUROC against sklearn's; and the program (``insurance_main``): its
files, zips, JSON line, grid extras, ``--sync-dumps`` and two gloo ranks.
"""

import contextlib
import functools
import io
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

import test_torch_mesh as ranks
from gan_deeplearning4j_tpu.data import datasets as DJ
from gan_deeplearning4j_tpu.data.csv import RecordReaderDataSetIterator as IterJ
from gan_deeplearning4j_tpu.eval import metrics as metrics_j
from gan_deeplearning4j_tpu.models import mlpgan_insurance as MJ
from gan_deeplearning4j_tpu.ops.pallas.bn_act import (
    LANE,
    SUBLANE,
    _apply,
    _local_moments,
    _pad_to,
)
from gan_deeplearning4j_tpu.ops.pallas.bn_act import fused_bn_act_train as bn_act_jax
from gan_deeplearning4j_tpu.train import fused_step as FJ
from gan_deeplearning4j_tpu.train import insurance_main as ins_j
from gan_deeplearning4j_tpu_torch import graph as GT
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data import datasets as DT
from gan_deeplearning4j_tpu_torch.data.csv import (
    RecordReaderDataSetIterator as IterT,
)
from gan_deeplearning4j_tpu_torch.data.csv import read_csv_matrix
from gan_deeplearning4j_tpu_torch.eval import metrics as metrics_t
from gan_deeplearning4j_tpu_torch.graph import serialization
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MT
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
    bn_act_plain,
    bn_apply_plain,
    bn_moments_plain,
)
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train import insurance_main as ins_t

GRAPHS = ("dis", "gen", "gan", "classifier")
B = 16          # the protocol step's batch (the D-step sees 32 rows)
STEPS = 3
# one step's params and BN statistics, absolute: 5% of the generator's
# learning rate (4e-4).  An element whose gradient sits near 0 moves on
# RmsProp's linear part, slope lr / sqrt(eps) = 4; through the train-mode
# BNs' cancellation both packages' f32 gradients lie up to ~2e-6 from the
# f64 gradient, so rounding alone moves such an element by up to ~1.6e-5.
# A wrong update sign moves an element by up to 2 lr = 8e-4, 40x outside.
PARAM_TOL = 2e-5
ARGS = ["--iterations", "4", "--batch-size", "10", "--print-every", "2",
        "--save-every", "2"]
# what both programs write under ARGS ...
ARTIFACTS = {"insurance_train.csv", "insurance_test.csv",
             "insurance_out_2.csv", "insurance_out_4.csv",
             "insurance_out_pred_2.csv", "insurance_out_pred_4.csv",
             "insurance_test_predictions_2.csv",
             "insurance_test_predictions_4.csv", "insurance_metrics.jsonl",
             "evaluation_stats.txt", "insurance_dis_model.zip",
             "insurance_gan_model.zip", "insurance_gen_model.zip",
             "insurance_insurance_model.zip"}
# ... and what only the JAX program writes: the PNGs (matplotlib) and the
# telemetry files, not ported
JAX_ONLY = {"DCGAN_Generated_Lattices.png", "DCGAN_Generated_Lattice_Example.png",
            "DCGAN_Generated_Lattice_Example_Plotted.png",
            "insurance_metrics_losses.png", "events.jsonl", "run_manifest.json"}
# keys of the JAX program's JSON line that come from its telemetry
JAX_TELEMETRY_KEYS = {"run_id", "goodput"}
DUMPS = ["insurance_out_2.csv", "insurance_out_4.csv",
         "insurance_out_pred_2.csv", "insurance_out_pred_4.csv",
         "insurance_test_predictions_2.csv", "insurance_test_predictions_4.csv"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_graphs():
    dis = MJ.build_discriminator()
    return {"dis": dis, "gen": MJ.build_generator(), "gan": MJ.build_gan(),
            "classifier": MJ.build_classifier(dis)}


def _torch_graphs():
    dis = MT.build_discriminator(device="cpu")
    return {"dis": dis, "gen": MT.build_generator(device="cpu"),
            "gan": MT.build_gan(device="cpu"),
            "classifier": MT.build_classifier(dis)}


def _run_main(main, argv):
    """``main(argv)`` with its standard output captured -> (result, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX side, once: the graphs, the CSV pair, three protocol steps
    from the graphs' start, and the program under ARGS."""
    d = str(tmp_path_factory.mktemp("jax_csv"))
    DJ.ensure_insurance_csv(d)
    graphs = _jax_graphs()
    step = FJ.make_protocol_step(
        graphs["dis"], graphs["gen"], graphs["gan"], graphs["classifier"],
        MJ.DIS_TO_GAN, MJ.GAN_TO_GEN,
        MJ.DIS_TO_CLASSIFIER, z_size=2, num_features=12, donate=False)
    state = FJ.state_from_graphs(graphs["dis"], graphs["gen"], graphs["gan"],
                                 graphs["classifier"])
    it = IterJ(f"{d}/insurance_train.csv", B, 12, 1)
    feats, labels = it.features[:2 * B], it.labels[:2 * B]
    rng = np.random.RandomState(1)
    ones = np.ones((B, 1), np.float32)
    y_real = ones + (0.05 * rng.randn(B, 1)).astype(np.float32)
    y_fake = (0.05 * rng.randn(B, 1)).astype(np.float32)
    z_key, rng_key = jax.random.key(3), jax.random.key(4)
    start = state
    steps, zs = [], []
    for i in range(STEPS):
        zs.append(tuple(np.array(jax.random.uniform(
            jax.random.fold_in(z_key, 2 * i + k), (B, 2), minval=-1.0,
            maxval=1.0)) for k in (0, 1)))
        sl = slice((i % 2) * B, (i % 2 + 1) * B)
        state, losses = step(state, jnp.asarray(feats[sl]),
                             jnp.asarray(labels[sl]), z_key, rng_key,
                             jnp.asarray(y_real), jnp.asarray(y_fake),
                             jnp.asarray(ones))
        steps.append(({f: _np_tree(getattr(state, f)) for f in FT.TREES},
                      [float(v) for v in losses]))
    prog = str(tmp_path_factory.mktemp("jax_prog"))
    result, _ = _run_main(ins_j.main, ARGS + ["--res-path", prog])
    return dict(
        csv_dir=d, graphs=graphs,
        start={f: _np_tree(getattr(start, f)) for f in FT.TREES},
        steps=steps, protocol=dict(
            real=feats, labels=labels, ones=ones, y_real=y_real,
            y_fake=y_fake, z=zs, model="insurance"),
        prog_dir=prog, prog_result=result)


@pytest.fixture(scope="module")
def torch_prog(tmp_path_factory):
    """The port's program under ARGS on the CPU, as given (through ``run``,
    which hands back the trainer) and with ``--sync-dumps`` (through
    ``main``, whose printed lines are kept)."""
    a = str(tmp_path_factory.mktemp("torch_prog"))
    trainer, result = ins_t.run(ins_t.parse_args(
        ARGS + ["--device", "cpu", "--res-path", a]))
    s = str(tmp_path_factory.mktemp("torch_sync"))
    result_s, lines = _run_main(ins_t.main, ARGS + [
        "--device", "cpu", "--res-path", s, "--sync-dumps"])
    return dict(dir=a, trainer=trainer, result=result, sync_dir=s,
                sync_result=result_s, sync_lines=lines)


# -- data ----------------------------------------------------------------------

def test_insurance_csv_pair_is_byte_equal_to_jax(jax_side, tmp_path):
    DT.ensure_insurance_csv(str(tmp_path))
    for f in ("insurance_train.csv", "insurance_test.csv"):
        assert (tmp_path / f).read_bytes() == Path(jax_side["csv_dir"],
                                                   f).read_bytes()


def test_v1_tier_is_byte_equal_to_jax(tmp_path, monkeypatch):
    """The "v1" tier: the lattices bit for bit, and the CSV pairs both
    pipelines write from them (``prepare_insurance`` has no tier argument:
    each package's draw is pointed at the v1 tier)."""
    tj, rj = DJ.synthetic_transactions(difficulty="v1")
    tt, rt = DT.synthetic_transactions(difficulty="v1")
    assert np.array_equal(tj, tt) and np.array_equal(rj, rt)
    for mod in (DJ, DT):
        monkeypatch.setattr(mod, "synthetic_transactions", functools.partial(
            mod.synthetic_transactions, difficulty="v1"))
    DJ.prepare_insurance(str(tmp_path / "j"))
    DT.prepare_insurance(str(tmp_path / "t"))
    for f in ("insurance_train.csv", "insurance_test.csv"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    with pytest.raises(KeyError):
        DT.synthetic_transactions(difficulty="v2")


def test_half_present_pair_is_refused(tmp_path):
    (tmp_path / "insurance_train.csv").write_text("0\n")
    with pytest.raises(FileExistsError, match="without the other"):
        DT.ensure_insurance_csv(str(tmp_path))


def test_training_table_is_the_jax_iterators_table(jax_side):
    """The port's decode of the training CSV (label as one column, the
    sigmoid target) is the JAX iterator's, bit for bit."""
    path = f"{jax_side['csv_dir']}/insurance_train.csv"
    it_j, it_t = IterJ(path, 50, 12, 1), IterT(path, 50, 12, 1)
    assert it_t.features.shape == (700, 12) and it_t.labels.shape == (700, 1)
    np.testing.assert_array_equal(it_t.features.view(np.uint32),
                                  it_j.features.view(np.uint32))
    np.testing.assert_array_equal(it_t.labels, it_j.labels)


# -- graphs ----------------------------------------------------------------------

@pytest.mark.parametrize("name", GRAPHS)
def test_graph_structure_matches_jax(jax_side, name):
    """Layer names and order, param names and shapes, param counts, the
    frozen set and each layer's resolved activation (the discriminator's
    global ELU, the generator's global TANH, the gan graph's frozen tail
    set to ELU) equal the JAX graph's."""
    gj, gt = jax_side["graphs"][name], _torch_graphs()[name]
    assert list(gt.nodes) == list(gj.nodes)
    assert {ly: {n: tuple(t.shape) for n, t in lp.items()}
            for ly, lp in gt.params.items()} == {
        ly: {n: tuple(np.shape(a)) for n, a in lp.items()}
        for ly, lp in gj.params.items()}
    assert gt.num_params() == gj.num_params()
    assert gt.frozen == gj.frozen
    assert gt.input_names == gj.input_names
    assert gt.output_names == gj.output_names
    for ly, node in gt.nodes.items():
        assert node.layer.activation == gj.nodes[ly].layer.activation, ly
        assert node.out_shape == tuple(gj.nodes[ly].out_shape), ly


def test_resolved_activations_and_counts():
    g = _torch_graphs()
    assert {n: g["gan"].nodes[n].layer.activation for n in (
        "gan_batch_1", "gan_dense_layer_4", "gan_dense_layer_5",
        "gan_dis_batch_layer_6", "gan_dis_dense_layer_7",
        "gan_dis_output_layer_9")} == {
        "gan_batch_1": "tanh", "gan_dense_layer_4": "tanh",
        "gan_dense_layer_5": "sigmoid", "gan_dis_batch_layer_6": "elu",
        "gan_dis_dense_layer_7": "elu", "gan_dis_output_layer_9": "sigmoid"}
    assert g["dis"].nodes["dis_dense_layer_2"].layer.activation == "elu"
    assert [g[n].num_params() for n in GRAPHS] == [1449, 21720, 23169, 1849]


def test_input_inference():
    """The discriminator sets no input type: its input is feed-forward of
    the first consumer's declared size; without one the build raises with
    the JAX message."""
    dis = MT.build_discriminator(device="cpu")
    assert dis.input_specs["dis_input_layer_0"] == GT.InputSpec.feed_forward(12)
    b = GT.GraphBuilder()
    b.add_inputs("in")
    b.add_layer("d", GT.Dense(n_out=3), "in")
    b.set_outputs("d")
    with pytest.raises(ValueError, match="no InputType set and no consumer "
                                         "declares nIn"):
        b.build("cpu")
    b = GT.GraphBuilder()
    b.add_inputs("in")
    b.add_layer("bn", GT.BatchNorm(n=5), "in")
    b.set_outputs("bn")
    assert b.build("cpu").nodes["bn"].in_shape == (5,)


def _graph_inputs(name, rng, n=8):
    if name in ("gen", "gan"):
        x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    else:
        x = rng.rand(n, 12).astype(np.float32)
    y = (rng.rand(n, 1) < 0.5).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", GRAPHS)
def test_forward_and_backward_match_jax(jax_side, name):
    """On the JAX graph's params carried across, at B = 8: the inference
    forward, and the train-mode loss and its gradient for every leaf.
    Tolerances (f32, other summation orders): outputs 1e-5 absolute (values
    of O(1)); the loss 1e-5 relative; gradients 1e-5 + 1e-4 relative."""
    gj = jax_side["graphs"][name]
    gt = _torch_graphs()[name]
    gt.params = interop.params_from_numpy(_np_tree(gj.params), "cpu",
                                          like=gt.params)
    x, y = _graph_inputs(name, np.random.RandomState(len(name)))
    np.testing.assert_allclose(gt.output(torch.from_numpy(x))[0].numpy(),
                               np.asarray(gj.output(jnp.asarray(x))[0]),
                               rtol=0, atol=1e-5)
    inp, out = gj.input_names[0], gj.output_names[0]

    def loss_j(p):
        values, _ = gj._forward(p, {inp: jnp.asarray(x)}, True, None)
        return gj._loss({out: values[out]}, {out: jnp.asarray(y)})

    lj, grads_j = jax.value_and_grad(loss_j)(gj.params)
    leaves = {ly: {n: t.clone().requires_grad_(True) for n, t in lp.items()}
              for ly, lp in gt.params.items()}
    values, _ = gt._forward(leaves, {inp: torch.from_numpy(x)}, True)
    lt = gt._loss({out: values[out]}, {out: torch.from_numpy(y)})
    keys = [(ly, n) for ly, lp in leaves.items() for n in lp]
    grads_t = torch.autograd.grad(lt, [leaves[ly][n] for ly, n in keys],
                                  allow_unused=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for (ly, n), g in zip(keys, grads_t):
        ref = np.asarray(grads_j[ly][n])
        got = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name}.{ly}.{n}")


def test_params_round_trip_through_interop(jax_side):
    """All four graphs' params and RmsProp caches carry JAX -> port -> numpy
    unchanged, bit for bit, and the port refuses a tree of another
    graph."""
    gt = _torch_graphs()
    for name in GRAPHS:
        gj = jax_side["graphs"][name]
        p = interop.params_from_numpy(_np_tree(gj.params), "cpu",
                                      like=gt[name].params)
        o = interop.opt_state_from_numpy(_np_tree(gj.opt_state), "cpu",
                                         like=gt[name].opt_state)
        for src, back in ((gj.params, interop.params_to_numpy(p)),
                          (gj.opt_state, interop.opt_state_to_numpy(o))):
            src = _np_tree(src)
            assert src.keys() == back.keys()
            for ly, lp in src.items():
                for n, a in lp.items():
                    assert np.array_equal(a, back[ly][n]), f"{name}.{ly}.{n}"
    with pytest.raises(ValueError, match="layer names differ"):
        interop.params_from_numpy(_np_tree(jax_side["graphs"]["dis"].params),
                                  "cpu", like=gt["gan"].params)


# -- the BN kernel's plain versions at the insurance shapes ------------------------

@pytest.mark.parametrize("shape,act", [((100, 12), "elu"), ((50, 2), "tanh"),
                                       ((50, 12), "elu"), ((50, 100), "elu")])
def test_bn_act_plain_matches_pallas_at_insurance_shapes(shape, act):
    """(y, mean, var) of the single-device path against the Pallas kernel in
    interpret mode, at each shape and activation the insurance step gives
    it.  Tolerance 1e-5 (f32, other reduction orders, values of O(1))."""
    Bn, F = shape
    rng = np.random.RandomState(Bn + F)
    x = rng.rand(Bn, F).astype(np.float32) * 2 - 0.5
    gamma = (rng.rand(F) + 0.5).astype(np.float32)
    beta = rng.randn(F).astype(np.float32)
    outs_j = bn_act_jax(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                        1e-5, act, True)
    outs_t = bn_act_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                          torch.from_numpy(beta), 1e-5, act)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape,act", [((25, 2), "tanh"), ((25, 100), "elu")])
def test_bn_pair_plain_matches_pallas_at_insurance_shapes(shape, act):
    """One rank's moments and apply step at a 2-rank insurance step's
    per-rank shapes, each against its Pallas kernel in interpret mode (rows
    and lanes padded as the TPU path pads them).  Tolerances: 1e-6 on the
    moments, 1e-5 on y."""
    Bn, F = shape
    rng = np.random.RandomState(Bn * 3 + F)
    x = (rng.randn(Bn, F) * 1.5 - 0.5).astype(np.float32)
    gamma = (rng.rand(F) + 0.5).astype(np.float32)
    beta = rng.randn(F).astype(np.float32)
    B_pad, F_pad = -(-Bn // SUBLANE) * SUBLANE, -(-F // LANE) * LANE
    xp = _pad_to(jnp.asarray(x), B_pad, F_pad)
    mean_j, m2_j = _local_moments(xp, Bn, B_pad, F_pad, True)
    var_j = m2_j - mean_j * mean_j
    y_j = _apply(xp, mean_j, var_j, _pad_to(jnp.asarray(gamma)[None], 1, F_pad),
                 _pad_to(jnp.asarray(beta)[None], 1, F_pad), B_pad, F_pad,
                 1e-5, act, True)[:Bn, :F]
    mean_t, m2_t = bn_moments_plain(torch.from_numpy(x))
    for a, b in ((mean_t, mean_j), (m2_t, m2_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[0, :F],
                                   rtol=1e-6, atol=1e-6)
    y_t = bn_apply_plain(torch.from_numpy(x), mean_t, m2_t - mean_t * mean_t,
                         torch.from_numpy(gamma), torch.from_numpy(beta),
                         1e-5, act)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)


# -- the protocol step -------------------------------------------------------------

@pytest.fixture(scope="module")
def torch_steps(jax_side):
    """STEPS port steps from the JAX start state on the same table, targets
    and latents (``test_torch_mesh.run_protocol``, the rank job's code, in
    this process)."""
    return ranks.run_protocol(None, dict(jax_side["protocol"],
                                         state=jax_side["start"]))


def _worst(ref, got, kind: str) -> float:
    """Max over leaves of |got - ref|: "param" absolute, "cache" over the
    leaf's largest |ref| plus RmsProp's eps 1e-8."""
    worst = 0.0
    for f in FT.TREES:
        if f.endswith("_opt") != (kind == "cache"):
            continue
        for ly, lp in ref[f].items():
            for n, a in lp.items():
                d = float(np.abs(got[f][ly][n] - a).max()) if a.size else 0.0
                if kind == "cache":
                    d /= float(np.abs(a).max()) + 1e-8
                worst = max(worst, d)
    return worst


def test_one_step_matches_jax(jax_side, torch_steps):
    """The binding check, on every loss and every leaf.  Tolerances: losses
    1e-5 relative; caches 2e-3 of each leaf's largest value plus eps
    (elements near g = 0 carry a large relative rounding error); params
    and BN statistics PARAM_TOL absolute."""
    state_j, losses_j = jax_side["steps"][0]
    state_t, losses_t = torch_steps[0]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert _worst(state_j, state_t, "param") <= PARAM_TOL
    assert _worst(state_j, state_t, "cache") <= 2e-3


def test_three_steps_track_jax(jax_side, torch_steps):
    """Steps two and three within the band of
    tests/test_torch_slice.py::test_three_steps_track_jax at this model's
    rates: losses 1e-3 relative, params 4e-4 absolute (one generator
    learning rate: an element whose gradient sat near 0 may take a
    different sign, no more), caches 5e-2 of each leaf's largest value plus
    eps."""
    for (state_j, losses_j), (state_t, losses_t) in zip(jax_side["steps"][1:],
                                                        torch_steps[1:]):
        np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
        assert _worst(state_j, state_t, "param") <= 4e-4
        assert _worst(state_j, state_t, "cache") <= 5e-2
        assert all(np.isfinite(losses_t))


# -- AUROC -----------------------------------------------------------------------

def _auroc_cases():
    rng = np.random.RandomState(8)
    y = (rng.rand(300) < 0.3).astype(np.int64)
    yield "random", rng.rand(300), y
    yield "ties", np.round(rng.rand(300) * 4) / 4, y
    y_rare = np.zeros(1000, np.int64)
    y_rare[rng.choice(1000, 10, replace=False)] = 1
    yield "rare", rng.rand(1000) + 0.3 * y_rare, y_rare
    yield "column", rng.rand(300, 1), y.astype(np.float64)


@pytest.mark.parametrize("case", ["random", "ties", "rare", "column"])
def test_auroc_matches_sklearn(case):
    """The port's numpy AUROC against the JAX package's (sklearn's
    ``roc_auc_score``, average="weighted") to 1e-12: random scores, scores
    with many ties, 99% of one class, and a [N, 1] prediction column with
    float labels (what the program reads from its CSVs)."""
    _, scores, labels = next(c for c in _auroc_cases() if c[0] == case)
    want = metrics_j.auroc_from_predictions(scores, labels)
    assert abs(metrics_t.auroc_from_predictions(scores, labels) - want) <= 1e-12
    assert abs(want - roc_auc_score(np.asarray(labels).astype(int),
                                    np.asarray(scores).ravel())) <= 1e-15


def test_auroc_refuses_a_single_class():
    """The AUROC is undefined for labels of one class: the port raises, as
    sklearn did; the sklearn of this environment returns NaN under an
    UndefinedMetricWarning instead, so the JAX package's value is NaN."""
    scores, labels = np.linspace(0, 1, 10), np.ones(10)
    with pytest.warns(UserWarning, match="Only one class"):
        assert np.isnan(metrics_j.auroc_from_predictions(scores, labels))
    for y in (labels, np.zeros(10)):
        with pytest.raises(ValueError, match="Only one class"):
            metrics_t.auroc_from_predictions(scores, y)
    with pytest.raises(ValueError, match="binary"):
        metrics_t.auroc_from_predictions(scores, np.arange(10) % 3)


def test_insurance_auroc_and_lattices(torch_prog, jax_side):
    """``insurance_auroc`` over the program's files, and
    ``grid_to_lattices``, against the JAX package's."""
    d = torch_prog["dir"]
    args = (f"{d}/insurance_test_predictions_4.csv", f"{d}/insurance_test.csv")
    assert abs(metrics_t.insurance_auroc(*args)
               - metrics_j.insurance_auroc(*args)) <= 1e-12
    lat = metrics_t.grid_to_lattices(f"{d}/insurance_out_4.csv", 4, 3)
    assert lat.shape == (2500, 4, 3)
    assert np.array_equal(lat, metrics_j.grid_to_lattices(
        f"{d}/insurance_out_4.csv", 4, 3))


# -- the program -------------------------------------------------------------------

def test_insurance_main_writes_the_jax_artifact_set(jax_side, torch_prog):
    """The file set, the CSV pair byte-equal, the dumps' shapes, the
    metrics records' keys, the zips' layout and configs, the evaluation
    report's lines and the JSON line's keys, against the JAX program's run
    under the same arguments."""
    dj, dt = jax_side["prog_dir"], torch_prog["dir"]
    assert set(os.listdir(dt)) == ARTIFACTS
    assert set(os.listdir(dj)) == ARTIFACTS | JAX_ONLY
    for f in ("insurance_train.csv", "insurance_test.csv"):
        assert Path(dt, f).read_bytes() == Path(dj, f).read_bytes()
    shapes = {"insurance_out_": (2500, 12), "insurance_out_pred_": (2500, 1),
              "insurance_test_predictions_": (300, 1)}
    for f in DUMPS:
        a = read_csv_matrix(f"{dt}/{f}")
        want = shapes[f.rsplit("_", 1)[0] + "_"]
        assert a.shape == want == read_csv_matrix(f"{dj}/{f}").shape, f
        assert np.isfinite(a).all()
        if "pred" in f:
            assert ((a > 0) & (a < 1)).all()
    recs = [[json.loads(ln) for ln in open(f"{d}/insurance_metrics.jsonl")]
            for d in (dt, dj)]
    steps = [[r for r in rs if "step" in r] for rs in recs]
    assert [list(r) for r in steps[0]] == [list(r) for r in steps[1]]
    assert [r["step"] for r in steps[0]] == [1, 2, 3, 4]
    for g in ("dis", "gan", "gen", "insurance"):
        f = f"insurance_{g}_model.zip"
        with serialization.zipfile.ZipFile(f"{dt}/{f}") as a, \
                serialization.zipfile.ZipFile(f"{dj}/{f}") as b:
            assert a.namelist() == b.namelist()
            assert a.read("config.json") == b.read("config.json")
    stats = [Path(d, "evaluation_stats.txt").read_text().splitlines()
             for d in (dt, dj)]
    assert len(stats[0]) == len(stats[1]) == 9  # 5 lines, header, 2 rows
    assert [ln.split(":")[0] for ln in stats[0][:7]] == [
        ln.split(":")[0] for ln in stats[1][:7]]
    keys = set(jax_side["prog_result"]) - JAX_TELEMETRY_KEYS
    rt = torch_prog["result"]
    assert keys <= set(rt) and "host_seconds" in rt
    assert rt["steps"] == 4 and rt["steps_per_call"] == 2
    assert all(np.isfinite(rt[k]) for k in ("d_loss", "g_loss", "clf_loss",
                                            "test_auroc", "test_f1"))
    assert 0.0 <= rt["test_auroc"] <= 1.0


def test_zips_read_back_as_the_trained_graphs(torch_prog):
    trainer = torch_prog["trainer"]
    for g, path in trainer.model_paths().items():
        back = serialization.read_model(path, "cpu")
        live = getattr(trainer, g)
        assert back.params.keys() == live.params.keys(), g
        for ly, lp in live.params.items():
            for n, t in lp.items():
                assert torch.equal(back.params[ly][n], t), f"{g}.{ly}.{n}"


def test_grid_extras_are_the_classifier_over_the_grid(torch_prog):
    """``insurance_out_pred_4.csv`` is the classifier (the state at step 4:
    the run's last) over the lattices of ``insurance_out_4.csv``.
    Tolerance 1e-6: both files hold 8 significant digits."""
    d, trainer = torch_prog["dir"], torch_prog["trainer"]
    grid = torch.from_numpy(read_csv_matrix(f"{d}/insurance_out_4.csv")
                            .astype(np.float32))
    preds = trainer.classifier.output(grid)[0].numpy()
    np.testing.assert_allclose(read_csv_matrix(f"{d}/insurance_out_pred_4.csv"),
                               preds, rtol=0, atol=1e-6)


def test_sync_dumps_are_byte_identical(torch_prog):
    """``--sync-dumps`` writes the same bytes, and ``main`` prints the step
    lines, then the JSON line of its result."""
    for f in DUMPS:
        assert (Path(torch_prog["dir"], f).read_bytes()
                == Path(torch_prog["sync_dir"], f).read_bytes()), f
    lines = torch_prog["sync_lines"]
    assert json.loads(lines[-1]) == json.loads(json.dumps(
        torch_prog["sync_result"], default=float))
    assert sum(ln.startswith("step ") for ln in lines) == 4


def test_two_gloo_ranks_match_one_process(torch_prog, tmp_path):
    """``--n-devices 2`` (two gloo ranks, 5 rows each; sync-BN at [10, 12],
    [5, 2], [5, 12], [5, 100]) against the one-process run from the same
    CSV pair, within tests/test_torch_dp.py's bands: step 1's losses 1e-5
    relative and later steps' 1e-3; the final params of the four zips 4e-4
    absolute (one generator learning rate)."""
    for f in ("insurance_train.csv", "insurance_test.csv"):
        (tmp_path / f).write_bytes(Path(torch_prog["dir"], f).read_bytes())
    _, res = ins_t.run(ins_t.parse_args(
        ARGS + ["--device", "cpu", "--n-devices", "2", "--res-path",
                str(tmp_path)]), timeout=300)
    assert res["world"] == 2 and res["backend"] == "gloo"
    assert np.isfinite(res["test_auroc"])
    keys = ("d_loss", "g_loss", "classifier_loss")
    got, ref = ([[r[k] for k in keys] for r in map(
        json.loads, open(f"{d}/insurance_metrics.jsonl")) if "step" in r]
        for d in (tmp_path, torch_prog["dir"]))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-3)
    for g in ("dis", "gan", "gen", "insurance"):
        a = serialization.read_model(f"{tmp_path}/insurance_{g}_model.zip",
                                     "cpu")
        b = serialization.read_model(
            f"{torch_prog['dir']}/insurance_{g}_model.zip", "cpu")
        for ly, lp in b.params.items():
            for n, t in lp.items():
                assert float((a.params[ly][n] - t).abs().max()) <= 4e-4, \
                    f"{g}.{ly}.{n}"


def test_two_rank_step_matches_one_process_step(jax_side, torch_steps):
    """The insurance protocol step on two gloo ranks (8 rows each) from
    the JAX start state equals the single-process step on all 16 rows
    (step-one bands), and the two ranks end bitwise equal."""
    got = ranks.mesh.spawn(ranks.run_protocol, 2, (dict(
        jax_side["protocol"], state=jax_side["start"]),), device="cpu",
        timeout=300)
    state_s, losses_s = torch_steps[0]
    for r in got:
        state_t, losses_t = r[0]
        np.testing.assert_allclose(losses_t, losses_s, rtol=1e-5)
        assert _worst(state_s, state_t, "param") <= PARAM_TOL
        assert _worst(state_s, state_t, "cache") <= 2e-3
    (s0, l0), (s1, l1) = (r[-1] for r in got)
    assert l0 == l1
    for f in FT.TREES:
        for ly, lp in s0[f].items():
            for n, a in lp.items():
                assert np.array_equal(a, s1[f][ly][n]), f"{f}.{ly}.{n}"


def test_insurance_main_defaults_to_the_card(tmp_path):
    """Without ``--device`` the program runs on the card: on a host without
    one it raises before it trains, and so does each builder."""
    if torch.cuda.is_available():
        assert MT.build_discriminator().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ins_t.main(ARGS + ["--res-path", str(tmp_path)])
    for build in (MT.build_discriminator, MT.build_generator, MT.build_gan):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert not any(tmp_path.glob("insurance_*_model.zip"))
