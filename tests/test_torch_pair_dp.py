"""The port's data-parallel ``GANPair`` (two gloo ranks on the CPU) held
against the JAX ``GANPair`` on ``data_mesh(2)`` (two of the conftest's
eight virtual CPU devices) and against the port's own one-rank pair, at
small width (base_filters 4 / 8, z 8, global batch 8: a rank's share of
4 is one ``MinibatchStdDev`` group).

Every random draw is the JAX side's: the graphs' params through
``interop``, and each iteration's global batch rows, latents, GP alphas,
mode-seeking z2 and conditional rows, derived from the JAX keys as the JAX
multistep derives them (the helpers of ``test_torch_gan_pair.py`` and
``test_torch_cgan.py``); each rank takes its own rows.  One module
fixture spawns the two ranks once (the rank job lives in the jax-free
``test_torch_pair_world.py``) and runs the JAX side once.

Covered, for celeba (with the EMA), celeba with the mode-seeking term,
wgan-gp (n_critic 5: the GP's alphas sliced from one global draw) and
cgan-cifar10: K = 2 iterations' d_loss and g_loss (rtol 1e-4, atol 1e-5)
and the final params and BN statistics of both graphs (rtol 1e-3, atol
1e-4) against the JAX mesh run and against the port's world-1 run; the two
ranks' final states bit for bit equal; and the mode-seeking distances
averaged over the ranks before their ratio: the G-step's loss with that
average is the one-rank loss, each rank's own ratio is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_deeplearning4j_tpu.data import datasets as DJ
from gan_deeplearning4j_tpu.models import cgan_cifar10 as GJ
from gan_deeplearning4j_tpu.models import dcgan_celeba as CJ
from gan_deeplearning4j_tpu.models import wgan_gp as WJ
from gan_deeplearning4j_tpu.parallel import data_mesh
from gan_deeplearning4j_tpu.train.gan_pair import GANPair as PairJ
from gan_deeplearning4j_tpu_torch.parallel import mesh
from test_torch_cgan import CGAN, _cond_draws
from test_torch_gan_pair import _iteration_draws
from test_torch_roadmap import CELEBA, WGAN, _np
import test_torch_pair_world as ranks

B = ranks.B
K = 2
N_ROWS = 24
WORLD = 2
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)
# (family, ms_weight, ema_decay)
CASES = {"celeba": ("celeba", 0.0, 0.9), "celeba_ms": ("celeba", 0.5, 0.0),
         "wgan-gp": ("wgan-gp", 0.0, 0.0),
         "cgan-cifar10": ("cgan-cifar10", 0.0, 0.0)}


def _jax_pair(family, ms, mesh_):
    if family == "wgan-gp":
        return PairJ(WJ.build_generator(WGAN), WJ.build_critic(WGAN),
                     mode="wgan-gp", gp_weight=WGAN.gp_weight, mesh=mesh_)
    M, cfg = (GJ, CGAN) if family == "cgan-cifar10" else (CJ, CELEBA)
    return PairJ(M.build_generator(cfg), M.build_discriminator(cfg),
                 mesh=mesh_, ms_weight=ms)


def _draws_numpy(d):
    return tuple(None if v is None else
                 [t.numpy() for t in v] if isinstance(v, list) else v.numpy()
                 for v in d)


def _case(name, key0):
    """(the rank job's case, the JAX mesh run's (state, d_losses,
    g_losses))."""
    family, ms, ema = CASES[name]
    n_critic = ranks.CONFIGS[family].n_critic if family == "wgan-gp" else 1
    real_label = 1.0 if family == "wgan-gp" else 0.9
    y = None
    if family == "wgan-gp":
        x = DJ.synthetic_mnist(N_ROWS, seed=4)[0].astype(np.float32)
    elif family == "cgan-cifar10":
        x, labels = DJ.synthetic_cifar10(N_ROWS, seed=5,
                                         difficulty="calibrated")
        y = np.eye(10, dtype=np.float32)[labels]
    else:
        x = DJ.synthetic_celeba(N_ROWS, seed=3)
    pj = _jax_pair(family, ms, data_mesh(WORLD))
    fj, sj = pj.make_multistep(
        jnp.asarray(x), None if y is None else jnp.asarray(y), batch_size=B,
        steps_per_call=K, n_critic=n_critic, real_label=real_label, z_size=8,
        seed_key=key0, ema_decay=ema)
    case = dict(family=family, ms=ms, ema=ema, batch=B, n_critic=n_critic,
                real_label=real_label, x=x, y=y, gen=_np(pj.gen.params),
                dis=_np(pj.dis.params), ms_probe=bool(ms))
    sj, (dlj, glj) = fj(sj)
    if family == "cgan-cifar10":
        draws = [_cond_draws(jax.random.fold_in(key0, it), N_ROWS, ms)
                 for it in range(K)]
    else:
        mode = "wgan-gp" if family == "wgan-gp" else "gan"
        draws = [_iteration_draws(jax.random.fold_in(key0, it), n_critic,
                                  N_ROWS, 8, mode, ms) for it in range(K)]
    case["draws"] = [_draws_numpy(d) for d in draws]
    return case, (_np(sj), np.asarray(dlj), np.asarray(glj))


@pytest.fixture(scope="module")
def runs(cpu_devices):
    cases, jax_runs = {}, {}
    for i, name in enumerate(CASES):
        cases[name], jax_runs[name] = _case(name, jax.random.key(40 + i))
    got = mesh.spawn(ranks.pair_rank_job, WORLD, (cases,), device="cpu",
                     timeout=ranks.SPAWN_TIMEOUT_S)
    one = {name: ranks.run_case(None, case) for name, case in cases.items()}
    return dict(jax=jax_runs, ranks=got, one=one)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _assert_close(ref, got, tol, what):
    ref, got = dict(_leaves(ref)), dict(_leaves(got))
    assert ref.keys() == got.keys(), (what, sorted(ref.keys() ^ got.keys()))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=f"{what}{k}", **tol)


def _check(state, d_loss, g_loss, ref_state, ref_d, ref_g, what):
    np.testing.assert_allclose(d_loss, ref_d, err_msg=f"{what} d", **LOSS_TOL)
    np.testing.assert_allclose(g_loss, ref_g, err_msg=f"{what} g", **LOSS_TOL)
    assert state["it"] == int(ref_state["it"]) == K
    for key in ("gen", "dis", "ema"):
        if key in state or key in ref_state:
            _assert_close(ref_state[key], state[key], PARAM_TOL,
                          f"{what} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_world2_pair_matches_jax_mesh(runs, name):
    sj, dlj, glj = runs["jax"][name]
    r0 = runs["ranks"][0][name]
    ref = {"gen": sj[0], "dis": sj[2], "it": sj[4]}
    if sj[5] is not None:
        ref["ema"] = sj[5]
    assert ("ema" in r0["state"]) == ("ema" in ref)
    _check(r0["state"], r0["d_loss"], r0["g_loss"], ref, dlj, glj,
           f"{name} world 2 vs JAX mesh")


@pytest.mark.parametrize("name", list(CASES))
def test_world2_pair_matches_the_ports_world1_pair(runs, name):
    one, r0 = runs["one"][name], runs["ranks"][0][name]
    _check(r0["state"], r0["d_loss"], r0["g_loss"], one["state"],
           one["d_loss"], one["g_loss"], f"{name} world 2 vs world 1")


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_stay_bitwise_equal(runs, name):
    a, b = (runs["ranks"][r][name] for r in range(WORLD))
    la, lb = dict(_leaves(a["state"])), dict(_leaves(b["state"]))
    assert la.keys() == lb.keys()
    assert all(la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k])
               for k in la), name
    assert np.array_equal(a["d_loss"], b["d_loss"])
    assert np.array_equal(a["g_loss"], b["g_loss"])


def test_mode_seeking_distances_are_averaged_before_the_ratio(runs):
    """celeba_ms's first G-step from the initial state: with the distances
    averaged over the ranks the world-2 loss is the one-rank loss (to
    f32 rounding); each rank's own ratio, averaged after, is not."""
    one = runs["one"]["celeba_ms"]["ms_probe"]
    assert one["loss"] == one["per_rank_ratio_loss"]  # one rank: the same
    for r in range(WORLD):
        got = runs["ranks"][r]["celeba_ms"]["ms_probe"]
        ours = abs(got["loss"] - one["loss"])
        per_rank = abs(got["per_rank_ratio_loss"] - one["loss"])
        assert ours <= 1e-6 * abs(one["loss"]), (r, got, one)
        assert per_rank > 100 * max(ours, 1e-7 * abs(one["loss"])), (
            r, got, one)
