"""The port's data-parallel path (two gloo ranks, one process each) held
against the JAX package's on ``data_mesh(2)`` of the 8 virtual CPU devices.

One module fixture spawns the two ranks once (``test_torch_mesh.
dp_rank_job``, a jax-free module) and runs the JAX side in this process;
they share every input, made with numpy: the sync-BN pair's tensors, the
protocol step's starting state (the JAX graphs' params and RmsProp caches),
table, targets and global latent draws, and the classifier's batches.

Also here: the 2-rank step against the port's own single-process step on
the whole batch, the ranks' states bitwise equal, and the CLI with two
ranks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import test_torch_mesh as ranks
from gan_deeplearning4j_tpu.compat.jaxver import shard_map
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.ops.pallas.bn_act import fused_bn_act_train as bn_act_jax
from gan_deeplearning4j_tpu.parallel import DataParallelGraph, data_mesh
from gan_deeplearning4j_tpu.train import fused_step as FJ
from gan_deeplearning4j_tpu_torch.data.datasets import synthetic_mnist
from gan_deeplearning4j_tpu_torch.parallel import mesh

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
B = 8            # global batch: 4 rows per rank
STEPS = 3
PAIR_SHAPES = [(16, 192), (10, 130)]  # F not a lane multiple; 5 rows a rank
SPAWN_TIMEOUT_S = 300


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair_jax(x, gamma, beta):
    """The SPMD path (moments kernel, pmean, apply kernel) in interpret
    mode under shard_map, as tests/test_pallas.py runs it: forward, and the
    gradients of the global sum of y^2."""
    m = data_mesh(WORLD)
    specs = dict(mesh=m, in_specs=(P("data"), P(), P()), check_vma=False)

    def fwd(xb, g, b):
        return bn_act_jax(xb, g, b, 1e-5, "tanh", True, "data")

    def loss(xa, g, b):
        def shard(xb, g, b):
            return jax.lax.psum(jnp.sum(fwd(xb, g, b)[0] ** 2), "data")
        return shard_map(shard, out_specs=P(), **specs)(xa, g, b)

    args = [jnp.asarray(a) for a in (x, gamma, beta)]
    outs = shard_map(fwd, out_specs=(P("data"), P(), P()), **specs)(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(a) for a in (*outs, *grads)]


def _protocol_jax(graphs, state, p, feats, onehot):
    """STEPS JAX mesh steps from ``state`` -> [(state, losses)]."""
    step = FJ.make_protocol_step(
        *graphs, MJ.DIS_TO_GAN, MJ.GAN_TO_GEN, MJ.DIS_TO_CLASSIFIER,
        z_size=2, num_features=784, mesh=data_mesh(WORLD), donate=False)
    out = []
    for it in range(STEPS):
        sl = slice((it % 2) * B, (it % 2 + 1) * B)
        state, losses = step(
            state, jnp.asarray(feats[sl]), jnp.asarray(onehot[sl]),
            p["z_key"], p["rng_key"], jnp.asarray(p["y_real"]),
            jnp.asarray(p["y_fake"]), jnp.asarray(p["ones"]))
        out.append(({f: _numpy_tree(getattr(state, f)) for f in ranks.FIELDS},
                    [float(v) for v in losses]))
    return out


def _dpg_jax(xs, ys):
    """Each ranks.DPG_CASES case on a fresh JAX classifier (the seed gives
    every one the same start) over data_mesh(2)."""
    out = {}
    for case, mode, freq in ranks.DPG_CASES:
        clf = MJ.build_classifier(MJ.build_discriminator())
        dp = DataParallelGraph(clf, mesh=data_mesh(WORLD), mode=mode,
                               averaging_frequency=freq)
        if case.endswith("_batches"):
            losses = [dp.fit_batches({"dis_input_layer_0": xs},
                                     {"dis_output_layer_7": ys})]
        else:
            losses = [dp.fit(x, y) for x, y in zip(xs[:2], ys[:2])]
        out[case] = ([float(v) for v in losses], _numpy_tree(clf.params),
                     _numpy_tree(clf.opt_state))
    return out


@pytest.fixture(scope="module")
def dp(cpu_devices):
    rng = np.random.RandomState(11)
    pair = [((rng.randn(b, f) * 1.5 - 0.5).astype(np.float32),
             (rng.rand(f) + 0.5).astype(np.float32),
             rng.randn(f).astype(np.float32)) for b, f in PAIR_SHAPES]

    # the protocol step: a resident table of two batches, the global
    # targets, and the JAX step's own global latent draws
    dis = MJ.build_discriminator()
    graphs = (dis, MJ.build_generator(), MJ.build_gan(), MJ.build_classifier(dis))
    state0 = FJ.state_from_graphs(*graphs)
    feats, labels = synthetic_mnist(2 * B, seed=5)
    onehot = np.eye(10, dtype=np.float32)[labels]
    ones = np.ones((B, 1), np.float32)
    z_key = jax.random.key(3)
    protocol = dict(
        state={f: _numpy_tree(getattr(state0, f)) for f in ranks.FIELDS},
        real=feats, labels=onehot, ones=ones,
        y_real=ones + (0.05 * rng.randn(B, 1)).astype(np.float32),
        y_fake=(0.05 * rng.randn(B, 1)).astype(np.float32),
        z=[tuple(np.array(jax.random.uniform(
            jax.random.fold_in(z_key, 2 * it + k), (B, 2), minval=-1.0,
            maxval=1.0)) for k in (0, 1)) for it in range(STEPS)])

    # the classifier's batches (4 of 8 rows) and starting state
    xs, lab = synthetic_mnist(4 * B, seed=9)
    xs = xs.reshape(4, B, 784)
    ys = np.eye(10, dtype=np.float32)[lab].reshape(4, B, 10)
    clf = MJ.build_classifier(MJ.build_discriminator())
    dpg = dict(params=_numpy_tree(clf.params), opt=_numpy_tree(clf.opt_state),
               xs=xs, ys=ys)

    got = mesh.spawn(ranks.dp_rank_job, WORLD,
                     ({"pair": pair, "protocol": protocol, "dpg": dpg},),
                     device="cpu", timeout=SPAWN_TIMEOUT_S)
    return dict(
        pair=pair, ranks=got,
        pair_jax=[_pair_jax(*shape) for shape in pair],
        protocol_jax=_protocol_jax(
            graphs, state0,
            dict(protocol, z_key=z_key, rng_key=jax.random.key(4)),
            feats, onehot),
        protocol_single=ranks.run_protocol(None, protocol),
        dpg_jax=_dpg_jax(xs, ys))


def _tree_worst(ref, got, relative: bool) -> float:
    """Max over the leaves of a {layer: {name: array}} tree of |got - ref|,
    absolute (params) or divided by the leaf's largest |ref| plus
    RmsProp's eps 1e-8 (caches, as tests/test_torch_slice.py)."""
    worst = 0.0
    for layer, lp in ref.items():
        for n, a in lp.items():
            d = float(np.abs(got[layer][n] - a).max())
            if relative:
                d /= float(np.abs(a).max()) + 1e-8
            worst = max(worst, d)
    return worst


def _worst(ref, got, kind: str) -> float:
    """_tree_worst over a protocol state's "param" or "cache" trees."""
    return max(_tree_worst(ref[f], got[f], kind == "cache")
               for f in ranks.FIELDS if f.endswith("_opt") == (kind == "cache"))


def test_ranks_import_no_jax(dp):
    assert [r["jax_modules"] for r in dp["ranks"]] == [[]] * WORLD


@pytest.mark.parametrize("i", range(len(PAIR_SHAPES)),
                         ids=[f"{b}x{f}" for b, f in PAIR_SHAPES])
def test_sync_bn_pair_matches_jax_spmd(dp, i):
    """The port's plain moments/apply pair over two ranks against the
    Pallas SPMD path: y and the x gradient are the ranks' rows stacked,
    mean/var the global batch's on every rank, and the gamma/beta
    gradients the sum of the ranks' shares.  Tolerances as
    tests/test_pallas.py: mean rtol 1e-5 atol 1e-6; var, y and the
    gradients rtol 1e-4 atol 1e-5."""
    y_j, mean_j, var_j, gx_j, gg_j, gb_j = dp["pair_jax"][i]
    per_rank = [r["pair"][i] for r in dp["ranks"]]
    stack = [np.concatenate([r[k] for r in per_rank]) for k in (0, 3)]
    total = [sum(r[k] for r in per_rank) for k in (4, 5)]
    for r in per_rank:
        np.testing.assert_allclose(r[1], mean_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r[2], var_j, rtol=1e-4, atol=1e-5)
    for got, ref in zip([*stack, *total], [y_j, gx_j, gg_j, gb_j]):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("i", range(len(PAIR_SHAPES)),
                         ids=[f"{b}x{f}" for b, f in PAIR_SHAPES])
def test_sync_bn_sums_route_matches_jax_spmd(dp, i):
    """The sync-BN forward as the card runs it (moments, one in-place
    all-reduce sum, the apply step finishing the moments from the sums;
    plain versions on two gloo ranks) against the Pallas SPMD forward, with
    test_sync_bn_pair_matches_jax_spmd's tolerances: mean rtol 1e-5 atol
    1e-6; var and y rtol 1e-4 atol 1e-5.  It also gives the bits of the
    differentiable composition the CPU path runs (the same sums, the same
    divide and epilogue)."""
    y_j, mean_j, var_j = dp["pair_jax"][i][:3]
    per_rank = [r["pair_sums"][i] for r in dp["ranks"]]
    for r, ref in zip(per_rank, (r["pair"][i] for r in dp["ranks"])):
        np.testing.assert_allclose(r[1], mean_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r[2], var_j, rtol=1e-4, atol=1e-5)
        for a, b in zip(r, ref[:3]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.concatenate([r[0] for r in per_rank]), y_j,
                               rtol=1e-4, atol=1e-5)


def test_dp_step_matches_jax_mesh_step(dp):
    """Step one, the binding check, with the bands of
    tests/test_torch_slice.py: losses 1e-5 relative, params 2e-5
    absolute, caches 2e-3 of each leaf's largest value."""
    state_j, losses_j = dp["protocol_jax"][0]
    for r in dp["ranks"]:
        state_t, losses_t = r["protocol"][0]
        np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
        assert _worst(state_j, state_t, "param") <= 2e-5
        assert _worst(state_j, state_t, "cache") <= 2e-3


def test_dp_steps_track_jax_mesh_steps(dp):
    """Steps two and three: losses 1e-3 relative, params 4e-3 absolute,
    caches 5e-2 (RmsProp at decay 1e-8 is nearly sign-SGD, so rounding
    differences grow; tests/test_torch_slice.py)."""
    for (state_j, losses_j), (state_t, losses_t) in zip(
            dp["protocol_jax"][1:], dp["ranks"][0]["protocol"][1:]):
        np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
        assert _worst(state_j, state_t, "param") <= 4e-3
        assert _worst(state_j, state_t, "cache") <= 5e-2
        assert all(np.isfinite(losses_t))


def test_dp_step_matches_single_process_step(dp):
    """Two ranks on four rows each equal one process on all eight: sync-BN
    with its cross-rank gradient terms, and the mean of the gradients.
    Step-one bands."""
    state_s, losses_s = dp["protocol_single"][0]
    state_t, losses_t = dp["ranks"][0]["protocol"][0]
    np.testing.assert_allclose(losses_t, losses_s, rtol=1e-5)
    assert _worst(state_s, state_t, "param") <= 2e-5
    assert _worst(state_s, state_t, "cache") <= 2e-3


def test_ranks_stay_bitwise_equal(dp):
    """Every rank applies the same update to the same state, so after
    three steps the states are equal bit for bit (a difference would be a
    wiring fault, not rounding)."""
    (s0, l0), (s1, l1) = (r["protocol"][-1] for r in dp["ranks"])
    assert l0 == l1
    for f in ranks.FIELDS:
        for layer, lp in s0[f].items():
            for n, a in lp.items():
                assert np.array_equal(a, s1[f][layer][n]), f"{f}.{layer}.{n}"


@pytest.mark.parametrize("case", [c for c, _, _ in ranks.DPG_CASES])
def test_data_parallel_graph_matches_jax(dp, case):
    """gradient_sync (sync-BN, two fits), param_averaging (local steps,
    params and caches averaged after each of two fits), and
    param_averaging's fit_batches (four batches, averaged after the second
    and the fourth) against the JAX DataParallelGraph on data_mesh(2).
    Losses 1e-5 relative, as tests/test_parallel.py.  Params 1e-4
    absolute: a missed or wrong average moves elements by up to one
    learning rate (2e-3), twenty times the band, while rounding over two
    to four near-sign-SGD steps stays under 1e-5 here.  Caches 5e-2 of
    each leaf's largest value, the band of the protocol's later steps:
    averaged caches of small gradients carry a large relative rounding
    error."""
    losses_j, params_j, opt_j = dp["dpg_jax"][case]
    for r in dp["ranks"]:
        losses_t, params_t, opt_t = r["dpg"][case]
        np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
        assert _tree_worst(params_j, params_t, False) <= 1e-4
        assert _tree_worst(opt_j, opt_t, True) <= 5e-2


def test_cv_main_two_ranks_on_cpu():
    """The CLI spawns two gloo ranks; rank 0 prints its steps and the
    JSON line, with the world size."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.train.cv_main",
         "--n-devices", "2", "--device", "cpu", "--iterations", "2",
         "--batch-size", "8", "--n-train", "64"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["world"] == 2 and result["steps"] == 2
    assert result["backend"] == "gloo" and result["device"] == "cpu"
    assert all(np.isfinite([result["d_loss"], result["g_loss"],
                            result["clf_loss"]]))
    assert sum(line.startswith("step ") for line in lines) == 2
