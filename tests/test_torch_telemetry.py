"""The port's in-graph numerics telemetry (``telemetry/ingraph.py``, the
``telemetry`` block of ``_train_step`` and of the protocol step, the NaN
alarm and the metrics logger's ``on_record`` hook) held against the JAX
package on the CPU.

Both sides get the same numpy inputs and params (``interop``); the port is
handed the JAX side's latent draws.  Tolerances: ``tree_norm`` and
``graph_telemetry`` on the same trees, 1e-6 relative (f32 sums in another
order); the blocks of one training step, 5e-5 relative on every norm and
ratio (the two packages' gradients differ by f32 rounding — up to 6e-5 of
their norm in the insurance gan graph, each package within 5e-5 of the
float64 gradient: ``test_insurance_gan_gradient_gap_is_f32_rounding`` —
and RmsProp at decay 1e-8 carries that into the update); blocks after K >
1 steps, 1e-3 (rounding grows
through RmsProp's near-sign steps, as in tests/test_torch_steps.py).  The
NaN/Inf count is held exactly.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.models import mlpgan_insurance as IJ
from gan_deeplearning4j_tpu.telemetry import ingraph as GJ
from gan_deeplearning4j_tpu.train import fused_step as FJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as IT
from gan_deeplearning4j_tpu_torch.telemetry import ingraph as GT
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train import insurance_main
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer
from gan_deeplearning4j_tpu_torch.utils.metrics import MetricsLogger

T = torch.from_numpy
SAME_TREES = 1e-6
ONE_STEP = 5e-5
K_STEPS = 1e-3


def _trees(seed: int, nan: bool = False):
    """(old, new, grads, loss) numpy trees of two layers, the JAX layout."""
    rng = np.random.RandomState(seed)
    shapes = {"a": {"W": (5, 3), "b": (3,)}, "c": {"gamma": (7,), "W": (2, 2)}}

    def tree(scale):
        return {l: {n: (scale * rng.randn(*s)).astype(np.float32)
                    for n, s in lp.items()} for l, lp in shapes.items()}

    old = tree(1.0)
    new = {l: {n: v + 1e-2 * rng.randn(*v.shape).astype(np.float32)
               for n, v in lp.items()} for l, lp in old.items()}
    grads = tree(0.3)
    if nan:
        grads["a"]["W"][1, 2] = np.nan
        grads["c"]["gamma"][0] = np.inf
        grads["c"]["W"][1, 1] = -np.inf
    return old, new, grads, np.float32(rng.rand())


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: T(np.array(a)), tree)


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nonfinite"])
def test_tree_norm_and_count_match_jax(nan):
    old, _, grads, _ = _trees(0, nan)
    for tree in (old, grads, {"x": grads["a"]}, {}):
        nj = float(GJ.tree_norm(_jax(tree)))
        nt = float(GT.tree_norm(_torch(tree)))
        if math.isfinite(nj):
            np.testing.assert_allclose(nt, nj, rtol=SAME_TREES)
        else:
            assert not math.isfinite(nt)
        assert int(GT.count_nonfinite(_torch(tree))) == int(
            GJ.count_nonfinite(_jax(tree)))
    assert int(GT.count_nonfinite(_torch(grads))) == (3 if nan else 0)


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nonfinite"])
def test_graph_telemetry_matches_jax(nan):
    old, new, grads, loss = _trees(1, nan)
    bj = GJ.graph_telemetry(_jax(old), _jax(new), _jax(grads),
                            jnp.asarray(loss))
    bt = GT.graph_telemetry(_torch(old), _torch(new), _torch(grads),
                            torch.tensor(loss))
    assert set(bt) == set(bj) == {"grad_norm", "param_norm", "update_ratio",
                                  "nonfinite"}
    assert int(bt["nonfinite"]) == int(bj["nonfinite"])
    assert bt["nonfinite"].dtype == torch.int32
    for k in ("param_norm", "update_ratio"):
        np.testing.assert_allclose(float(bt[k]), float(bj[k]), rtol=SAME_TREES)
    if not nan:
        np.testing.assert_allclose(float(bt["grad_norm"]),
                                   float(bj["grad_norm"]), rtol=SAME_TREES)


def test_update_ratio_is_the_relative_move():
    old = {"l": {"W": torch.full((4,), 2.0)}}
    new = {"l": {"W": torch.full((4,), 2.1)}}
    tel = GT.graph_telemetry(old, new, {"l": {"W": torch.ones(4)}},
                             torch.tensor(1.0))
    np.testing.assert_allclose(float(tel["param_norm"]), 4.2, rtol=1e-6)
    np.testing.assert_allclose(float(tel["grad_norm"]), 2.0, rtol=1e-6)
    np.testing.assert_allclose(float(tel["update_ratio"]), 0.05, rtol=1e-5)
    assert int(tel["nonfinite"]) == 0


# -- one graph's training step -------------------------------------------------

def _graph_pair(model: str, name: str):
    if model == "dcgan":
        dj = MJ.build_discriminator()
        gj = {"dis": dj, "gan": MJ.build_gan(),
              "classifier": MJ.build_classifier(dj)}[name]
        dt = MT.build_discriminator(device="cpu")
        gt = {"dis": dt, "gan": MT.build_gan(device="cpu"),
              "classifier": MT.build_classifier(dt)}[name]
    else:
        dj = IJ.build_discriminator()
        gj = {"dis": dj, "gan": IJ.build_gan(),
              "classifier": IJ.build_classifier(dj)}[name]
        dt = IT.build_discriminator(device="cpu")
        gt = {"dis": dt, "gan": IT.build_gan(device="cpu"),
              "classifier": IT.build_classifier(dt)}[name]
    return gj, gt


def _graph_inputs(model: str, name: str, B: int = 8):
    rng = np.random.RandomState(3)
    if name == "gan":
        x = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        y = np.ones((B, 1), np.float32)
    else:
        width = 784 if model == "dcgan" else 12
        x = rng.rand(B, width).astype(np.float32)
        if name == "classifier" and model == "dcgan":
            y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, B)]
        else:
            y = (rng.rand(B, 1) > 0.5).astype(np.float32)
    return x, y


@pytest.mark.parametrize("model,name", [
    ("dcgan", "dis"), ("dcgan", "gan"), ("insurance", "gan"),
    ("insurance", "classifier")])
def test_train_step_block_matches_jax(model, name):
    """``_train_step(telemetry=True)``: the port's fourth return is the
    JAX block of the same step, from the same params, inputs and
    targets (the gan graph's frozen tail and BN statistics included)."""
    gj, gt = _graph_pair(model, name)
    gt.params = interop.params_from_numpy(jax.tree.map(np.asarray, gj.params),
                                          "cpu")
    gt.opt_state = interop.opt_state_from_numpy(
        jax.tree.map(np.asarray, gj.opt_state), "cpu")
    x, y = _graph_inputs(model, name)
    _, _, lj, bj = gj._train_step(
        gj.params, gj.opt_state, jax.random.key(0),
        {gj.input_names[0]: jnp.asarray(x)}, {gj.output_names[0]: jnp.asarray(y)},
        telemetry=True)
    out = gt._train_step(gt.params, gt.opt_state, {gt.input_names[0]: T(x)},
                         {gt.output_names[0]: T(y)}, telemetry=True)
    assert len(out) == 4
    _, _, lt, bt = out
    np.testing.assert_allclose(float(lt), float(lj), rtol=ONE_STEP)
    assert int(bt["nonfinite"]) == int(bj["nonfinite"]) == 0
    for k in ("grad_norm", "param_norm", "update_ratio"):
        np.testing.assert_allclose(float(bt[k]), float(bj[k]), rtol=ONE_STEP,
                                   err_msg=k)
    # off: the three returns as before, the same bits
    p3, o3, l3 = gt._train_step(gt.params, gt.opt_state,
                                {gt.input_names[0]: T(x)},
                                {gt.output_names[0]: T(y)})
    assert torch.equal(l3, lt)


def test_insurance_gan_gradient_gap_is_f32_rounding():
    """The insurance gan graph's gradient from the same params and inputs:
    JAX's in f32 (jitted as its programs run it, XLA's excess precision
    off), the port's in f32, and the port's in float64 (the 2-D BNs on
    their plain version, which takes float64) as the reference.  Both f32
    gradients lie at f32 rounding from it, the port's no further than the
    JAX side's: 3.2e-5 and 5.0e-5 of the float64 gradient's norm (their
    gap 6.9e-5), and no leaf of the port's further than twice the JAX
    side's worst leaf (2.5e-4, the last dense layer's bias).  JAX's f32
    agreement with the float64 gradient also shows that the reference
    computes the JAX package's function."""
    from gan_deeplearning4j_tpu_torch.train import moment_triage

    gj, gt = _graph_pair("insurance", "gan")
    x, y = _graph_inputs("insurance", "gan")

    def loss_j(p):
        values, _ = gj._forward(p, {gj.input_names[0]: jnp.asarray(x)}, True,
                                jax.random.key(0))
        return gj._loss({n: values[n] for n in gj.output_names},
                        {gj.output_names[0]: jnp.asarray(y)})

    # compiled with XLA's excess precision off: every op rounds to f32, as
    # the JAX program's own f32 arithmetic says (tests/test_torch_precision)
    g_j = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_j)).lower(
        gj.params).compile(compiler_options={
            "xla_allow_excess_precision": False})(gj.params))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, gj.params),
                                       "cpu")

    def grads_t(dtype):
        leaves = {layer: {n: t.to(dtype).requires_grad_(True)
                          for n, t in lp.items()}
                  for layer, lp in params.items()}
        values, _ = gt._forward(
            leaves, {gt.input_names[0]: T(x).to(dtype)}, True)
        loss = gt._loss({n: values[n] for n in gt.output_names},
                        {gt.output_names[0]: T(y).to(dtype)})
        keys = [(layer, n) for layer, lp in leaves.items() for n in lp]
        flat = torch.autograd.grad(loss, [leaves[k[0]][k[1]] for k in keys],
                                   allow_unused=True)
        return {k: np.zeros(leaves[k[0]][k[1]].shape) if g is None
                else g.double().numpy() for k, g in zip(keys, flat)}

    g32 = grads_t(torch.float32)
    with moment_triage._plain_2d_bn():
        g64 = grads_t(torch.float64)
    keys = sorted(k for k in g64 if np.any(g64[k]))
    jax_g = {k: np.asarray(g_j[k[0]][k[1]], np.float64) for k in keys}

    def rel(g, k=None):
        ks = keys if k is None else [k]
        ref = np.concatenate([g64[q].ravel() for q in ks])
        got = np.concatenate([g[q].ravel() for q in ks])
        return np.linalg.norm(got - ref) / np.linalg.norm(ref)

    port, jax_err = rel(g32), rel(jax_g)
    assert jax_err < 1e-4 and port <= 2 * jax_err
    worst_jax = max(rel(jax_g, k) for k in keys)
    for k in keys:
        assert rel(g32, k) <= 2 * worst_jax, k


# -- the protocol step -----------------------------------------------------------

B = 10


@pytest.fixture(scope="module")
def insurance_setup():
    """The insurance graphs in both packages from the JAX init, a table of
    two batches, the targets and the JAX latent key."""
    gj = {"dis": IJ.build_discriminator()}
    gj.update(gen=IJ.build_generator(), gan=IJ.build_gan(),
              classifier=IJ.build_classifier(gj["dis"]))
    rng = np.random.RandomState(0)
    real = rng.rand(2 * B, 12).astype(np.float32)
    labels = (rng.rand(2 * B, 1) > 0.5).astype(np.float32)
    ones = np.ones((B, 1), np.float32)
    y_real = ones + (0.05 * rng.randn(B, 1)).astype(np.float32)
    y_fake = (0.05 * rng.randn(B, 1)).astype(np.float32)
    return gj, dict(real=real, labels=labels, ones=ones, y_real=y_real,
                    y_fake=y_fake, z_key=jax.random.key(3),
                    rng_key=jax.random.key(4))


def _torch_protocol(telemetry: bool, k: int = 1):
    dis = IT.build_discriminator(device="cpu")
    graphs = (dis, IT.build_generator(device="cpu"), IT.build_gan(device="cpu"),
              IT.build_classifier(dis))
    return FT.make_protocol_step(
        *graphs, IT.DIS_TO_GAN, IT.GAN_TO_GEN, IT.DIS_TO_CLASSIFIER,
        z_size=2, num_features=12, steps_per_call=k, telemetry=telemetry)


def _carry(state_j) -> FT.ProtocolState:
    return FT.ProtocolState(
        *(interop.params_from_numpy(jax.tree.map(np.asarray,
                                                 getattr(state_j, f)), "cpu")
          for f in FT.TREES), torch.tensor(int(state_j.it)))


def _z(h, k: int):
    return [np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(h["z_key"], 2 * i + w), (B, 2), minval=-1.0,
        maxval=1.0)) for i in range(k)]) for w in (0, 1)]


@pytest.mark.parametrize("k", [1, 3], ids=["k1", "k3"])
def test_protocol_step_block_matches_jax(insurance_setup, k):
    """The fused step's flat block (the JAX keys, one total count), at K =
    1 against the JAX single step and at K = 3 against the JAX multi-step
    program on the resident table."""
    gj, h = insurance_setup
    step_j = FJ.make_protocol_step(
        gj["dis"], gj["gen"], gj["gan"], gj["classifier"], IJ.DIS_TO_GAN,
        IJ.GAN_TO_GEN, IJ.DIS_TO_CLASSIFIER, z_size=2, num_features=12,
        donate=False, telemetry=True, data_on_device=k > 1,
        steps_per_call=k)
    state_j = FJ.state_from_graphs(gj["dis"], gj["gen"], gj["gan"],
                                   gj["classifier"])
    start = _carry(state_j)
    table = slice(None) if k > 1 else slice(0, B)
    _, (lj, tj) = step_j(state_j, jnp.asarray(h["real"][table]),
                         jnp.asarray(h["labels"][table]), h["z_key"],
                         h["rng_key"], jnp.asarray(h["y_real"]),
                         jnp.asarray(h["y_fake"]), jnp.asarray(h["ones"]))
    z1, z2 = _z(h, k)
    if k == 1:
        z1, z2 = z1[0], z2[0]
    _, (lt, tt) = _torch_protocol(True, k)(
        start, T(h["real"]), T(h["labels"]), T(h["y_real"]), T(h["y_fake"]),
        T(h["ones"]), z1=T(z1), z2=T(z2))
    assert tuple(tt) == FT.TELEMETRY_KEYS and set(tt) == set(tj)
    tol = ONE_STEP if k == 1 else K_STEPS
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol)
    for key in FT.TELEMETRY_KEYS:
        assert tuple(tt[key].shape) == ((k,) if k > 1 else ())
        if key == "nonfinite":
            assert np.array_equal(np.asarray(tt[key]), np.asarray(tj[key]))
        else:
            np.testing.assert_allclose(np.asarray(tt[key]),
                                       np.asarray(tj[key]), rtol=tol,
                                       err_msg=key)


def test_telemetry_only_reads(insurance_setup):
    """With the block on, the losses and the new state are the bits of the
    step without it; off, the step returns the three losses as before."""
    gj, h = insurance_setup
    start = _carry(FJ.state_from_graphs(gj["dis"], gj["gen"], gj["gan"],
                                        gj["classifier"]))
    z1, z2 = (z[0] for z in _z(h, 1))
    args = (T(h["real"]), T(h["labels"]), T(h["y_real"]), T(h["y_fake"]),
            T(h["ones"]))
    s_off, l_off = _torch_protocol(False)(start, *args, z1=T(z1), z2=T(z2))
    s_on, (l_on, _) = _torch_protocol(True)(start, *args, z1=T(z1), z2=T(z2))
    assert isinstance(l_off, tuple) and len(l_off) == 3
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    off, on = FT._leaves(s_off), FT._leaves(s_on)
    assert off.keys() == on.keys()
    assert all(torch.equal(off[p], on[p]) for p in off)


def test_graph_body_writes_the_block_to_the_ring(insurance_setup):
    """``graph_body`` (what the CUDA graph records) on the CPU: the ring row
    is the losses, then the block in ``TELEMETRY_KEYS`` order, and
    ``unpack_rows`` gives them back by key."""
    gj, h = insurance_setup
    start = _carry(FJ.state_from_graphs(gj["dis"], gj["gen"], gj["gan"],
                                        gj["classifier"]))
    step = _torch_protocol(True)
    args = (T(h["real"]), T(h["labels"]), T(h["y_real"]), T(h["y_fake"]),
            T(h["ones"]))
    z_gen = torch.Generator().manual_seed(5)
    z_ref = torch.Generator().manual_seed(5)
    _, (losses, tel) = step(FT.clone_state(start), *args, z_gen=z_ref)
    ring = torch.zeros((4, 3 + len(FT.TELEMETRY_KEYS)))
    state = FT.clone_state(start)
    FT.graph_body(step, args, z_gen, 4, state, ring,
                  FT.step_counter(state).clone())
    row = ring[0]
    assert torch.equal(row[:3], torch.stack(losses))
    assert torch.equal(row[3:], torch.stack(
        [tel[k].float() for k in FT.TELEMETRY_KEYS]))
    got_losses, got_tel = FT.unpack_rows(ring[:1])
    assert got_losses == [row[:3].tolist()]
    assert list(got_tel) == list(FT.TELEMETRY_KEYS)
    assert int(state.it) == 1


def test_nan_batch_counts_and_trips_the_alarm(insurance_setup, tmp_path):
    """A NaN feature reaches the count in both packages (the same count),
    and the record, through the port's logger, trips the alarm at its step
    in both packages' ``NanAlarm``."""
    gj, h = insurance_setup
    real = h["real"].copy()
    real[0, 0] = np.nan
    step_j = FJ.make_protocol_step(
        gj["dis"], gj["gen"], gj["gan"], gj["classifier"], IJ.DIS_TO_GAN,
        IJ.GAN_TO_GEN, IJ.DIS_TO_CLASSIFIER, z_size=2, num_features=12,
        donate=False, telemetry=True)
    state_j = FJ.state_from_graphs(gj["dis"], gj["gen"], gj["gan"],
                                   gj["classifier"])
    start = _carry(state_j)
    _, (lj, tj) = step_j(state_j, jnp.asarray(real[:B]),
                         jnp.asarray(h["labels"][:B]), h["z_key"],
                         h["rng_key"], jnp.asarray(h["y_real"]),
                         jnp.asarray(h["y_fake"]), jnp.asarray(h["ones"]))
    z1, z2 = (z[0] for z in _z(h, 1))
    _, (lt, tt) = _torch_protocol(True)(
        start, T(real), T(h["labels"]), T(h["y_real"]), T(h["y_fake"]),
        T(h["ones"]), z1=T(z1), z2=T(z2))
    assert int(tt["nonfinite"]) == int(tj["nonfinite"]) > 0
    alarms = {"jax": GJ.NanAlarm(), "torch": GT.NanAlarm()}
    logger = MetricsLogger(str(tmp_path / "m.jsonl"),
                           on_record=lambda r: [a.observe(r)
                                                for a in alarms.values()])
    logger.log_step(7, d_loss=float(lt[0]),
                    **{k: float(v) for k, v in tt.items()})
    assert not alarms["torch"].tripped  # nothing flushed yet
    logger.flush()
    for a in alarms.values():
        assert a.tripped and a.step == 7 and a.record["nonfinite"] > 0


# -- the alarm and the logger hook --------------------------------------------------

STREAMS = {
    "finite": [{"step": i, "d_loss": 0.5, "nonfinite": 0.0} for i in range(5)],
    "count": [{"step": 1, "nonfinite": 0.0}, {"step": 2, "nonfinite": 3.0},
              {"step": 3, "nonfinite": 9.0}],
    "loss": [{"step": 4, "g_loss": 0.7}, {"step": 5, "g_loss": float("nan")},
             {"step": 6, "g_loss": float("inf")}],
    "norm": [{"step": 8, "d_grad_norm": float("inf"), "note": "fine"}],
    "ratio": [{"step": 9, "clf_update_ratio": float("nan")}],
    "unwatched": [{"step": 1, "examples_per_sec": float("inf"),
                   "note": "x"}],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_nan_alarm_trips_where_jax_does(stream):
    trips = {"jax": [], "torch": []}
    alarms = {"jax": GJ.NanAlarm(on_trip=trips["jax"].append),
              "torch": GT.NanAlarm(on_trip=trips["torch"].append)}
    for rec in STREAMS[stream]:
        for a in alarms.values():
            a.observe(dict(rec))
    j, t = alarms["jax"], alarms["torch"]
    assert (t.tripped, t.step, t.record) == (j.tripped, j.step, j.record)
    assert trips["torch"] == trips["jax"] and len(trips["torch"]) <= 1


def test_logger_on_record_fires_at_flush(tmp_path):
    seen = []
    logger = MetricsLogger(str(tmp_path / "m.jsonl"), flush_every=3,
                           on_record=seen.append)
    logger.log_step(1, d_loss=1.0)
    logger.log_step(2, d_loss=2.0)
    assert seen == []
    logger.log_chunk(3, 2, 0, {"d_loss": [3.0, 4.0], "nonfinite": [0.0, 1.0]})
    assert [r["step"] for r in seen] == [1, 2, 3, 4]
    assert seen[-1]["nonfinite"] == 1.0
    lines = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert lines == seen


# -- the trainer -------------------------------------------------------------------

def _insurance_trainer(tmp_path, **kw):
    base = dict(num_iterations=4, batch_size=10, res_path=str(tmp_path),
                print_every=0, save_every=0)
    base.update(kw)
    return GANTrainer(device="cpu", config=insurance_main.default_config(
        **base), workload=insurance_main.InsuranceWorkload())


@pytest.mark.parametrize("k", [1, 2], ids=["k1", "k2"])
def test_trainer_records_carry_the_jax_keys(tmp_path, k):
    """``telemetry=True``: every metrics record carries the JAX trainer's
    columns, the block's values as the step computed them."""
    t = _insurance_trainer(tmp_path, telemetry=True, steps_per_call=k)
    res = t.train(log=None)
    assert res["steps"] == 4 and res["steps_per_call"] == k
    recs = [json.loads(ln) for ln in open(tmp_path / "insurance_metrics.jsonl")]
    assert list(recs.pop()) == ["goodput", "run_id"]  # the run's last record
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    for r in recs:
        assert set(FT.TELEMETRY_KEYS) <= set(r)
        assert r["nonfinite"] == 0.0
        assert all(math.isfinite(r[key]) and r[key] > 0
                   for key in FT.TELEMETRY_KEYS if key != "nonfinite")
        # the JAX files' key order: a per-step record sorted, a chunk's
        # records step, wall_s, step_s, then the metrics sorted
        head = [] if k == 1 else ["step", "wall_s", "step_s"]
        assert list(r) == head + sorted(set(r) - set(head))
    plain = _insurance_trainer(tmp_path / "off", steps_per_call=k)
    plain.train(log=None)
    off = [json.loads(ln)
           for ln in open(tmp_path / "off" / "insurance_metrics.jsonl")][:-1]
    assert [{k_: r[k_] for k_ in ("d_loss", "g_loss", "classifier_loss")}
            for r in recs] == [{k_: r[k_] for k_ in (
                "d_loss", "g_loss", "classifier_loss")} for r in off]
    assert not set(FT.TELEMETRY_KEYS) & set(off[0])


@pytest.mark.parametrize("kw,match", [
    ({"nan_alarm": "abort"}, "needs telemetry"),
    ({"divergence": True}, "needs telemetry"),
    ({"telemetry": True, "fused": False}, "fused"),
    ({"telemetry": True, "dp_mode": "param_averaging"}, "fused"),
    ({"telemetry": True, "nan_alarm": "explode"}, "nan_alarm"),
    ({"telemetry": True, "nan_alarm": "snapshot", "res_path": None},
     "res_path"),
], ids=["alarm", "divergence", "unfused", "averaging", "action", "res_path"])
def test_trainer_refuses_bad_numerics_options(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        _insurance_trainer(tmp_path, **kw)


def test_poll_raises_on_abort(tmp_path):
    """A bad record through the logger trips the alarm; the next boundary
    poll raises ``NanAlarmError`` naming the step."""
    t = _insurance_trainer(tmp_path, telemetry=True, nan_alarm="abort")
    t.metrics.log_step(11, d_loss=float("nan"), nonfinite=1.0)
    t._poll_nan_alarm()  # nothing flushed: no trip yet
    t.metrics.flush()
    with pytest.raises(GT.NanAlarmError, match="step 11"):
        t._poll_nan_alarm()
