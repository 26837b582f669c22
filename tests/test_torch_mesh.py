"""The port's process groups and data-parallel layer on the CPU, in one
process or in spawned gloo ranks.

This module imports torch, numpy and the port only — never jax — because
it also holds the rank jobs that ``tests/test_torch_dp.py``,
``tests/test_torch_steps.py``, ``tests/test_torch_insurance.py`` and
``tests/test_torch_precision.py`` hand to
``mesh.spawn``: a spawned rank
imports the module its function lives in,
and a rank must not import jax or the JAX package.
"""

import dataclasses
import sys
import time

import pytest
import torch

from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
    bn_apply_sums_plain,
    bn_moments_plain,
)
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.parallel.data_parallel import DataParallelGraph
from gan_deeplearning4j_tpu_torch.runtime import backend
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
    GANTrainer,
    resolve_n_devices,
)

FIELDS = FT.TREES
DPG_CASES = (("gradient_sync", "gradient_sync", 1),
             ("param_averaging", "param_averaging", 1),
             ("param_averaging_batches", "param_averaging", 2))
T = torch.from_numpy


# -- rank jobs (spawned by tests/test_torch_dp.py, test_torch_steps.py,
# test_torch_insurance.py and test_torch_precision.py) ---------------------

def state_from_numpy(trees, it: int) -> FT.ProtocolState:
    return FT.ProtocolState(
        *(interop.params_from_numpy(trees[f], "cpu") for f in FIELDS),
        torch.tensor(it))


def state_to_numpy(state: FT.ProtocolState):
    return {f: interop.params_to_numpy(getattr(state, f)) for f in FIELDS}


def run_protocol(group, p):
    """len(p["z"]) protocol steps from p["state"] on the resident table,
    with the injected global latents -> [(state as numpy, losses)].  The
    DCGAN's step, or with p["model"] == "insurance" the insurance MLP-GAN's
    (tests/test_torch_insurance.py); with the model config fields
    p["config"] and under the precision policy p["precision"] when given
    (tests/test_torch_precision.py)."""
    with backend.configured(**p.get("precision", {})):
        return _run_protocol(group, p)


def _run_protocol(group, p):
    M, features, cfg = ((MI, 12, MI.InsuranceConfig())
                        if p.get("model") == "insurance"
                        else (MT, 784, MT.CVConfig()))
    cfg = dataclasses.replace(cfg, **p.get("config", {}))
    d = M.build_discriminator(cfg, device="cpu")
    graphs = (d, M.build_generator(cfg, device="cpu"),
              M.build_gan(cfg, device="cpu"), M.build_classifier(d, cfg))
    step = FT.make_protocol_step(
        *graphs, M.DIS_TO_GAN, M.GAN_TO_GEN, M.DIS_TO_CLASSIFIER,
        z_size=2, num_features=features, group=group)
    state = state_from_numpy(p["state"], 0)
    out = []
    for z1, z2 in p["z"]:
        state, losses = step(state, T(p["real"]), T(p["labels"]),
                             T(p["y_real"]), T(p["y_fake"]), T(p["ones"]),
                             z1=T(z1), z2=T(z2))
        out.append((state_to_numpy(state), [float(v) for v in losses]))
    return out


def _pair(group, shapes):
    """The sync-BN pair (plain versions, CPU) on this rank's rows: forward
    and the gradients of sum(y^2) over this rank's rows."""
    out = []
    for x, gamma, beta in shapes:
        bl = x.shape[0] // group.world
        rows = x[group.rank * bl:(group.rank + 1) * bl]
        leaves = [T(a.copy()).requires_grad_(True) for a in (rows, gamma, beta)]
        y, mean, var = kernels.fused_bn_act_train(*leaves, 1e-5, "tanh", group)
        grads = torch.autograd.grad(torch.sum(y ** 2), leaves)
        out.append([t.detach().numpy() for t in (y, mean, var, *grads)])
    return out


def _pair_sums(group, shapes):
    """The sync-BN forward as the card runs it, in plain versions, on this
    rank's rows: the moments, one in-place all-reduce sum of the stacked
    [2, F], the apply step from the sums -> (y, mean, var)."""
    out = []
    for x, gamma, beta in shapes:
        bl = x.shape[0] // group.world
        rows = T(x[group.rank * bl:(group.rank + 1) * bl].copy())
        sums = mesh.all_reduce_sum_(torch.stack(bn_moments_plain(rows)), group)
        out.append([t.numpy() for t in bn_apply_sums_plain(
            rows, sums, group.world, T(gamma), T(beta), 1e-5, "tanh")])
    return out


def _classifier(p):
    clf = MT.build_classifier(MT.build_discriminator(device="cpu"))
    clf.params = interop.params_from_numpy(p["params"], "cpu", like=clf.params)
    clf.opt_state = interop.opt_state_from_numpy(p["opt"], "cpu",
                                                 like=clf.opt_state)
    return clf


def _data_parallel_graph(group, p):
    """Each DPG_CASES case from the same classifier state: two ``fit``s,
    or one ``fit_batches`` of the stacked batches."""
    out = {}
    for case, mode, freq in DPG_CASES:
        clf = _classifier(p)
        dp = DataParallelGraph(clf, group, mode, averaging_frequency=freq)
        if case.endswith("_batches"):
            losses = [dp.fit_batches(T(p["xs"]), T(p["ys"]))]
        else:
            losses = [dp.fit(T(x), T(y)) for x, y in zip(p["xs"][:2],
                                                        p["ys"][:2])]
        out[case] = ([float(v) for v in losses],
                     interop.params_to_numpy(clf.params),
                     interop.opt_state_to_numpy(clf.opt_state))
    return out


def dp_rank_job(group, payload):
    """Everything tests/test_torch_dp.py needs from one rank, in one
    spawn: the pair, the protocol steps, the DataParallelGraph cases, and
    the modules of jax or the JAX package this process imported."""
    return {
        "pair": _pair(group, payload["pair"]),
        "pair_sums": _pair_sums(group, payload["pair"]),
        "protocol": run_protocol(group, payload["protocol"]),
        "dpg": _data_parallel_graph(group, payload["dpg"]),
        "jax_modules": sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "gan_deeplearning4j_tpu")),
    }


def unfused_trainer_job(group, p):
    """The trainer's unfused per-fit loop (``fused=False``, param_averaging
    under a group: tests/test_torch_steps.py), on the CPU or on this rank:
    every graph starts from p["state"], the table, targets and global
    latents are p's -> per step (the four graphs' state as numpy, losses),
    and the modules of jax or the JAX package this process imported."""
    t = GANTrainer(batch_size=p["ones"].shape[0], n_train=p["real"].shape[0],
                   device="cpu", group=group, fused=False,
                   dp_mode="param_averaging", averaging_frequency=2)
    for name, g in (("dis", t.dis), ("gan", t.gan), ("clf", t.classifier),
                    ("gen", t.gen)):
        g.params = interop.params_from_numpy(p["state"][f"{name}_params"],
                                             "cpu", like=g.params)
        if name != "gen":
            g.opt_state = interop.opt_state_from_numpy(
                p["state"][f"{name}_opt"], "cpu", like=g.opt_state)
    t.features, t.labels = T(p["real"]), T(p["labels"])
    t.y_real, t.y_fake, t.ones = T(p["y_real"]), T(p["y_fake"]), T(p["ones"])
    out = []
    for z1, z2 in p["z"]:
        losses = t.unfused_step(T(z1), T(z2))
        state = FT.state_from_graphs(t.dis, t.gen, t.gan, t.classifier)
        out.append((state_to_numpy(state), [float(v) for v in losses]))
    return {"steps": out, "jax_modules": sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "gan_deeplearning4j_tpu"))}


def _fail_on_rank_1(group):
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return group.rank


def _hang_on_rank_1(group):
    if group.rank == 1:
        time.sleep(120)
    return group.rank


# -- tests in this process ----------------------------------------------------

@pytest.fixture
def one_rank_group(tmp_path):
    group = mesh.data_group(0, 1, f"file://{tmp_path}/store", "cpu")
    try:
        yield group
    finally:
        group.close()


def test_one_rank_group_on_the_cpu_is_gloo(one_rank_group):
    g = one_rank_group
    assert (g.rank, g.world, g.device.type, g.backend) == (0, 1, "cpu", "gloo")
    assert mesh.choose_backend(torch.device("cpu"), 4) == "gloo"


def test_all_reduce_mean_keeps_the_structure(one_rank_group):
    """One flat collective for a nested tree; the structure comes back,
    and on one rank the mean is the input itself."""
    tree = (torch.tensor(2.5), {"a": {"W": torch.randn(3, 2)},
                                "b": {"v": torch.randn(4)}})
    out = mesh.all_reduce_mean(tree, one_rank_group)
    assert isinstance(out, tuple) and set(out[1]) == {"a", "b"}
    assert torch.equal(out[0], tree[0])
    assert torch.equal(out[1]["a"]["W"], tree[1]["a"]["W"])
    assert torch.equal(out[1]["b"]["v"], tree[1]["b"]["v"])
    assert mesh.reducer(None) is None


def test_all_reduce_sum_is_in_place(one_rank_group):
    """One rank: the sum is the tensor itself, and it is the same object."""
    t = torch.randn(2, 5)
    ref = t.clone()
    out = mesh.all_reduce_sum_(t, one_rank_group)
    assert out is t and torch.equal(t, ref)


def test_all_reduce_sum_refuses_a_non_contiguous_tensor(one_rank_group):
    with pytest.raises(ValueError, match="contiguous"):
        mesh.all_reduce_sum_(torch.randn(5, 2).t(), one_rank_group)


def test_differentiable_mean_passes_the_gradient(one_rank_group):
    x = torch.randn(5, requires_grad=True)
    y = mesh.all_reduce_mean_diff(x * x, one_rank_group)
    (g,) = torch.autograd.grad(y.sum(), x)
    torch.testing.assert_close(g, 2 * x.detach())


def test_resolve_n_devices_on_the_cpu():
    assert resolve_n_devices(None, 8, "cpu") == 1
    assert resolve_n_devices(2, 8, "cpu") == 2
    with pytest.raises(ValueError, match="not divisible"):
        resolve_n_devices(3, 8, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        resolve_n_devices(0, 8, "cpu")


def test_data_parallel_graph_refuses_what_is_not_ported(one_rank_group):
    clf = MT.build_classifier(MT.build_discriminator(device="cpu"))
    for kwargs in ({"mode": "async_gradient_sharing"}, {"dcn_axis": "dcn"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DataParallelGraph(clf, one_rank_group, **kwargs)
    with pytest.raises(ValueError, match="unknown mode"):
        DataParallelGraph(clf, one_rank_group, mode="hogwild")
    dp = DataParallelGraph(clf, one_rank_group)
    with pytest.raises(ValueError, match="param_averaging"):
        dp.fit_batches(torch.zeros(2, 4, 784), torch.zeros(2, 4, 10))


def test_protocol_step_refuses_unequal_shares():
    """A rank's share must be exact: 8 rows do not split into 3 ranks."""

    class Three:
        rank, world = 0, 3

    step = FT.make_protocol_step(None, None, None, None, [], [], [], 2, 784,
                                 group=Three())
    with pytest.raises(ValueError, match="equal shares"):
        step(None, torch.zeros(16, 784), None, None, None, torch.ones(8, 1))


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        mesh.spawn(_fail_on_rank_1, 2, device="cpu", timeout=120)


def test_spawn_kills_a_hung_rank():
    """A rank that does not finish costs the timeout, not the suite: it is
    killed, and the call fails naming it.  The timeout counts from the
    moment both ranks joined, so a host slow to start the two interpreters
    does not change the outcome; rank 0 finishes at once and is not named."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[1\] did not finish"):
        mesh.spawn(_hang_on_rank_1, 2, device="cpu", timeout=10)
    assert time.monotonic() - t0 < 60
