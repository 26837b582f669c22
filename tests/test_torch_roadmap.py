"""The port's roadmap families (CelebA-64 DCGAN, WGAN-GP) and their
``GANPair`` engine held against the JAX package's, on the CPU, at small
width (base_filters 4, z 8, batch 8).

Every random draw is the JAX side's, carried into the port: the graphs'
Xavier init through ``interop``, and each step's batch rows, latents, GP
alphas and mode-seeking z2, derived from the JAX keys as the JAX step
derives them.  Module fixtures build and jit the JAX side once.

Covered: ``conv_transpose2d`` / ``ConvTranspose2D`` forward and backward;
``MinibatchStdDev`` (with the largest-dividing-group fallback and the raise
under a group); Adam and ``Scheduled(Adam, SigmoidSchedule)`` through
``GraphUpdater`` with L2 and clip; the RmsProp path of ``GraphUpdater``
bit for bit as the fused chain; both builders' trees; the model zips
byte-equal both ways; ``synthetic_celeba`` byte-equal; ``tile_grid`` and
the PNG; and ``roadmap_main`` on the CPU (files, result keys, checkpoint /
preemption / resume equal to a straight run).  The ``GANPair`` steps are
in ``test_torch_gan_pair.py``.
"""

import dataclasses
import json
import os
import struct
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data import datasets as DJ
from gan_deeplearning4j_tpu.eval import plots as PJ
from gan_deeplearning4j_tpu.graph import layers as LJ
from gan_deeplearning4j_tpu.graph import serialization as SJ
from gan_deeplearning4j_tpu.models import dcgan_celeba as CJ
from gan_deeplearning4j_tpu.models import wgan_gp as WJ
from gan_deeplearning4j_tpu.ops.upsample import conv_transpose2d as ct_jax
from gan_deeplearning4j_tpu.optim import adam as AdamJ
from gan_deeplearning4j_tpu.optim import schedules as SchedJ
from gan_deeplearning4j_tpu.optim.updater import GraphUpdater as UpdJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data import datasets as DT
from gan_deeplearning4j_tpu_torch.eval import plots as PT
from gan_deeplearning4j_tpu_torch.graph import layers as LT
from gan_deeplearning4j_tpu_torch.graph import serialization as ST
from gan_deeplearning4j_tpu_torch.models import dcgan_celeba as CT
from gan_deeplearning4j_tpu_torch.models import wgan_gp as WT
from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import fused_rmsprop_chains
from gan_deeplearning4j_tpu_torch.ops.upsample import conv_transpose2d as ct_torch
from gan_deeplearning4j_tpu_torch.optim import adam as AdamT
from gan_deeplearning4j_tpu_torch.optim import schedules as SchedT
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp as RmsT
from gan_deeplearning4j_tpu_torch.optim.updater import GraphUpdater as UpdT
from gan_deeplearning4j_tpu_torch.train import roadmap_main as RM

B = 8
CELEBA = dataclasses.replace(CJ.CelebAConfig(), base_filters=4, z_size=8)
CELEBA_T = dataclasses.replace(CT.CelebAConfig(), base_filters=4, z_size=8)
WGAN = dataclasses.replace(WJ.WGANGPConfig(), base_filters=4, z_size=8)
WGAN_T = dataclasses.replace(WT.WGANGPConfig(), base_filters=4, z_size=8)
# one step from the same state: losses 1e-5 relative; params and BN
# statistics 2e-6 absolute, 2% of the smallest learning rate (1e-4): an
# Adam step moves an element by about lr * sign(g), so a wrong sign or a
# wrong rate is off by ~lr.  Adam's m/v: 1e-4 relative to the leaf's
# largest value.  Exempt from the param band, within 2 lr: elements whose
# gradient is rounding noise, read from JAX's first moment (|m| below
# NOISE_FLOOR of the leaf's largest).  A bias ahead of a train-mode BN
# gets them where its ReLU keeps every row on one side: the BN cancels the
# bias exactly, both packages' f32 sums leave ~1e-10, and Adam's
# normalized step turns that noise into +-lr.  At most NOISE_SHARE of a
# leaf may use the exemption.
LOSS_TOL = 1e-5
STEP_PARAM_TOL = 2e-6
STATE_TOL = 1e-4
NOISE_FLOOR = 1e-4
NOISE_SHARE = 0.05


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tree_close(ref, got, atol, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), (path, sorted(set(ref) ^ set(got)))
        for k in ref:
            _assert_tree_close(ref[k], got[k], atol, f"{path}/{k}")
        return
    a = np.asarray(ref)
    b = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert a.shape == b.shape and a.dtype == b.dtype, (path, a.dtype, b.dtype)
    np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=path)


def _assert_params_track(ref_p, ref_opt, got, atol, lr):
    """Params within ``atol`` of JAX's, except where JAX's Adam first moment
    says the gradient is noise (see NOISE_FLOOR): those within 2 lr."""
    for layer, lp in ref_p.items():
        for n, a in lp.items():
            a, b = np.asarray(a), got[layer][n].detach().cpu().numpy()
            d = np.abs(b - a)
            st = ref_opt.get(layer, {}).get(n)
            if st is None or "m" not in st and "inner" not in st:
                np.testing.assert_array_less(d, atol, err_msg=f"{layer}.{n}")
                continue
            m = np.abs(np.asarray((st.get("inner") or st)["m"]))
            # no gradient at all (BN running stats): the BN update sets it
            noise = m < NOISE_FLOOR * m.max() if m.max() > 0 else m < 0
            assert (d[~noise] <= atol).all(), (layer, n, d[~noise].max())
            assert (d[noise] <= 2 * lr).all(), (layer, n)
            assert (noise & (d > atol)).mean() <= NOISE_SHARE, (layer, n)


def _assert_opt_close(ref, got, path=""):
    """Updater state: m and v relative to the leaf's largest value, t
    exactly (dtype included)."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _assert_opt_close(ref[k], got[k], f"{path}/{k}")
        return
    a, b = np.asarray(ref), got.detach().cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if a.ndim == 0:
        assert a == b, path
    else:
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=STATE_TOL * (np.abs(a).max() + 1e-12),
                                   err_msg=path)


# -- ops and layers -------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride,padding", [
    ((4, 4), (2, 2), (1, 1)), ((3, 3), (1, 1), (0, 0)),
    ((3, 2), (2, 1), (1, 0)), ((5, 5), (3, 2), (2, 1))])
def test_conv_transpose2d_matches_jax(kernel, stride, padding):
    """Forward and backward (x, W, b) on a non-square input; W [O, I, kh,
    kw] swapped to torch's [I, O, kh, kw], never reshaped."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    w = rng.randn(6, 3, *kernel).astype(np.float32) * 0.3
    b = rng.randn(6).astype(np.float32)
    yj, vjp = jax.vjp(lambda x, w, b: ct_jax(x, w, b, stride, padding),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gy = rng.randn(*yj.shape).astype(np.float32)
    gj = vjp(jnp.asarray(gy))
    xt, wt, bt = (_t(a).requires_grad_(True) for a in (x, w, b))
    yt = ct_torch(xt, wt, bt, stride, padding)
    assert tuple(yt.shape) == yj.shape
    layer = LT.ConvTranspose2D(kernel=kernel, stride=stride, padding=padding,
                               n_in=3, n_out=6)
    assert layer.out_shape((3, 5, 4)) == tuple(yj.shape[1:])
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-5)
    gt = torch.autograd.grad(yt, (xt, wt, bt), _t(gy))
    for a, bb in zip(gj, gt):
        np.testing.assert_allclose(bb.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=1e-5)


def test_conv_transpose_layer_init_and_apply():
    """Out shape, the W layout [O, I, kh, kw] with the JAX layer's Xavier
    fans, and the layer forward on carried params (activation included)."""
    lj = LJ.ConvTranspose2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                            n_in=16, n_out=8, activation="relu")
    lt = LT.ConvTranspose2D(kernel=(4, 4), stride=(2, 2), padding=(1, 1),
                            n_in=16, n_out=8, activation="relu")
    pt = lt.init(torch.Generator().manual_seed(0), (16, 5, 5))
    assert lt.out_shape((16, 5, 5)) == lj.out_shape((16, 5, 5)) == (8, 10, 10)
    assert tuple(pt["W"].shape) == (8, 16, 4, 4) and tuple(pt["b"].shape) == (8,)
    # Xavier N(0, 2/(fan_in+fan_out)), fans 16*16 and 8*16
    std = float(pt["W"].std())
    assert abs(std - np.sqrt(2.0 / (16 * 16 + 8 * 16))) < 0.01
    x = np.random.RandomState(1).randn(3, 16, 5, 5).astype(np.float32)
    pj = {k: jnp.asarray(v.numpy()) for k, v in pt.items()}
    yj, _ = lj.apply(pj, jnp.asarray(x), True, None)
    yt, _ = lt.apply(pt, _t(x), True, None)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 5, 3, 3), (6, 4, 2, 2), (5, 7), (8, 12)])
def test_minibatch_stddev_matches_jax(shape):
    """Contiguous groups of 4; 6 and 5 rows take the largest dividing group
    (3, 1); 4-D and FF input; forward and the input gradient."""
    lj, lt = LJ.MinibatchStdDev(), LT.MinibatchStdDev()
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    yj, vjp = jax.vjp(lambda a: lj.apply({}, a, True, None)[0], jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    yt, upd = lt.apply({}, xt, True, None)
    assert upd is None and tuple(yt.shape) == yj.shape
    assert lt.out_shape(shape[1:]) == lj.out_shape(shape[1:])
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-6)
    gy = np.random.RandomState(3).randn(*yj.shape).astype(np.float32)
    (gj,) = vjp(jnp.asarray(gy))
    (gt,) = torch.autograd.grad(yt, xt, _t(gy))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)


def test_minibatch_stddev_raises_under_a_group():
    group = types.SimpleNamespace(world=2, rank=0)
    x = torch.zeros(6, 3, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        LT.MinibatchStdDev().apply({}, x, True, None, group)
    # a group multiple is fine, as under the JAX mesh
    LT.MinibatchStdDev().apply({}, torch.zeros(8, 3, 2, 2), True, None, group)


# -- optimizers -------------------------------------------------------------------

def _updaters(pkg):
    A, S = (AdamJ, SchedJ) if pkg == "jax" else (AdamT, SchedT)
    return {"dense": A.Adam(2e-3, 0.5, 0.999),
            "conv": S.Scheduled(A.Adam(1e-3, 0.5, 0.9), S.SigmoidSchedule(
                1e-3, gamma=-1.0 / (0.06 * 10), step=0.7 * 10)),
            "bn": S.Scheduled(A.Adam(1e-3), S.StepSchedule(1e-3, 0.5, 2))}


def test_adam_and_scheduled_match_jax():
    """Five updates through GraphUpdater (L2 1e-2 on W, clip 0.05) with
    Adam, Scheduled(Adam, Sigmoid) and Scheduled(Adam, Step) layers: params
    and the updater state (m, v, t f32; Scheduled's t int32) track JAX."""
    rng = np.random.RandomState(4)
    params = {"dense": {"W": rng.randn(6, 4), "b": rng.randn(4)},
              "conv": {"W": rng.randn(3, 2, 2, 2), "b": rng.randn(3)},
              "bn": {"gamma": rng.randn(5), "beta": rng.randn(5)}}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    uj = UpdJ(_updaters("jax"), l2=1e-2, clip_threshold=0.05)
    ut = UpdT(_updaters("torch"), l2=1e-2, clip_threshold=0.05)
    pj = jax.tree.map(jnp.asarray, params)
    cj = uj.init(pj)
    pt = interop.params_from_numpy(params, "cpu")
    ct = ut.init(pt)
    _assert_opt_close(_np(cj), ct)
    assert ct["conv"]["W"]["t"].dtype == torch.int32
    assert ct["conv"]["W"]["inner"]["t"].dtype == torch.float32
    apply_j = jax.jit(uj.apply)
    for _ in range(5):
        g = jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.1).astype(
            np.float32), params)
        pj, cj = apply_j(pj, jax.tree.map(jnp.asarray, g), cj)
        pt, ct = ut.apply(pt, interop.params_from_numpy(g, "cpu"), ct)
    _assert_tree_close(_np(pj), pt, 1e-6)
    _assert_opt_close(_np(cj), ct)
    # the opt tree crosses both ways with its dtypes
    back = interop.opt_state_to_numpy(interop.opt_state_from_numpy(
        _np(cj), "cpu", like=ct))
    _assert_opt_close(_np(cj), interop.opt_state_from_numpy(back, "cpu"))
    assert back["bn"]["beta"]["t"].dtype == np.int32
    assert SchedT.Scheduled(AdamT.Adam(1e-3), SchedT.SigmoidSchedule(
        1e-3, -0.1, 7.0)).learning_rate == pytest.approx(float(
            SchedJ.SigmoidSchedule(1e-3, -0.1, 7.0)(0.0)))


def test_rmsprop_path_of_graph_updater_is_unchanged():
    """RmsProp leaves still take one fused_rmsprop_chains call, bit for bit
    as that call alone, and a mixed graph leaves them the same bits."""
    rng = np.random.RandomState(5)
    shapes = {"a": {"W": (5, 3), "b": (3,)}, "c": {"gamma": (4,), "beta": (4,)}}
    P = {l: {n: torch.from_numpy(rng.randn(*s).astype(np.float32))
             for n, s in lp.items()} for l, lp in shapes.items()}
    G = {l: {n: torch.from_numpy(rng.randn(*s).astype(np.float32))
             for n, s in lp.items()} for l, lp in shapes.items()}
    C = {l: {n: torch.from_numpy(np.abs(rng.randn(*s)).astype(np.float32))
             for n, s in lp.items()} for l, lp in shapes.items()}
    rms = UpdT({"a": RmsT(4e-3, 1e-8, 1e-8), "c": RmsT(2e-3, 1e-8, 1e-8)},
               l2=1e-4, clip_threshold=1.0)
    new_p, new_c = rms.apply(P, G, C)
    keys = [(l, n) for l in shapes for n in shapes[l]]
    ps, cs = fused_rmsprop_chains(
        [P[l][n] for l, n in keys], [G[l][n] for l, n in keys],
        [C[l][n] for l, n in keys], [rms.rates(l, n) for l, n in keys],
        clip=1.0)
    for (l, n), p, c in zip(keys, ps, cs):
        assert torch.equal(new_p[l][n], p) and torch.equal(new_c[l][n], c)
    mixed = UpdT({"a": RmsT(4e-3, 1e-8, 1e-8), "c": AdamT.Adam(1e-3)},
                 l2=1e-4, clip_threshold=1.0)
    C2 = {"a": C["a"],
          "c": {n: AdamT.Adam(1e-3).init_leaf(P["c"][n]) for n in P["c"]}}
    mp, mc = mixed.apply(P, G, C2)
    rms_a = UpdT({"a": RmsT(4e-3, 1e-8, 1e-8)}, l2=1e-4, clip_threshold=1.0)
    ap, ac = rms_a.apply({"a": P["a"]}, {"a": G["a"]}, {"a": C["a"]})
    for n in P["a"]:
        assert torch.equal(mp["a"][n], ap["a"][n])
        assert torch.equal(mc["a"][n], ac["a"][n])
    assert set(mc["c"]["gamma"]) == {"m", "v", "t"}


# -- builders ---------------------------------------------------------------------

@pytest.mark.parametrize("family", ["celeba", "wgan-gp"])
def test_builders_match_jax(family):
    """Layer names and order, types, resolved activations and updaters,
    shapes, the param and updater trees key for key, carried both ways."""
    if family == "celeba":
        pairs = [(CJ.build_generator(CELEBA), CT.build_generator(CELEBA_T, "cpu")),
                 (CJ.build_discriminator(CELEBA),
                  CT.build_discriminator(CELEBA_T, "cpu"))]
    else:
        pairs = [(WJ.build_generator(WGAN), WT.build_generator(WGAN_T, "cpu")),
                 (WJ.build_critic(WGAN), WT.build_critic(WGAN_T, "cpu"))]
    for gj, gt in pairs:
        assert list(gj.nodes) == list(gt.nodes)
        for name, nj in gj.nodes.items():
            nt = gt.nodes[name]
            assert type(nj.layer).__name__ == type(nt.layer).__name__
            assert nj.layer.activation == nt.layer.activation, name
            assert tuple(nj.out_shape) == tuple(nt.out_shape), name
            assert (ST._updater_to_dict(nt.layer.updater)
                    if nt.layer.updater is not None else None) == (
                SJ._updater_to_dict(nj.layer.updater)
                if nj.layer.updater is not None else None), name
        assert gj.clip_threshold == gt.clip_threshold
        p = interop.params_from_numpy(_np(gj.params), "cpu", like=gt.params)
        o = interop.opt_state_from_numpy(_np(gj.opt_state), "cpu",
                                         like=gt.opt_state)
        _assert_tree_close(_np(gj.params), p, 0.0)
        _assert_opt_close(_np(gj.opt_state), o)
        _assert_opt_close(_np(gj.opt_state), gt.opt_state)  # fresh zeros
        _assert_tree_close(_np(gj.params), interop.params_to_numpy(p), 0.0)


# -- files ------------------------------------------------------------------------

@pytest.mark.parametrize("family,decay", [("celeba", None), ("celeba", 1000),
                                          ("wgan-gp", None)])
def test_model_zips_byte_equal_both_ways(tmp_path, family, decay):
    """The zips of both graphs with Adam (and Scheduled(Adam, Sigmoid))
    updater state after one JAX step: the port writes the JAX bytes, and
    each package reads the other's."""
    if family == "celeba":
        cfg = dataclasses.replace(CELEBA, decay_steps=decay)
        cfg_t = dataclasses.replace(CELEBA_T, decay_steps=decay)
        gj = [CJ.build_generator(cfg), CJ.build_discriminator(cfg)]
        gt = [CT.build_generator(cfg_t, "cpu"), CT.build_discriminator(cfg_t, "cpu")]
    else:
        gj = [WJ.build_generator(WGAN), WJ.build_critic(WGAN)]
        gt = [WT.build_generator(WGAN_T, "cpu"), WT.build_critic(WGAN_T, "cpu")]
    rng = np.random.RandomState(8)
    for a, b in zip(gj, gt):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.randn(*p.shape).astype(np.float32)), a.params)
        params, opt = a.updater.apply(a.params, g, a.opt_state)
        # both graphs from the same numpy trees (one key order: jax.tree.map
        # sorts, as a jitted step's output is sorted)
        a.params = jax.tree.map(jnp.asarray, _np(params))
        a.opt_state = jax.tree.map(jnp.asarray, _np(opt))
        b.params = interop.params_from_numpy(_np(params), "cpu", like=b.params)
        b.opt_state = interop.opt_state_from_numpy(_np(opt), "cpu",
                                                   like=b.opt_state)
        for upd in (True, False):
            pj_, pt_ = tmp_path / "j.zip", tmp_path / "t.zip"
            SJ.write_model(a, str(pj_), save_updater=upd)
            ST.write_model(b, str(pt_), save_updater=upd)
            assert pj_.read_bytes() == pt_.read_bytes()
        back_t = ST.read_model(str(pj_), device="cpu")
        back_j = SJ.read_model(str(pt_))
        assert ST.graph_config_to_dict(back_t) == SJ.graph_config_to_dict(back_j)
        _assert_tree_close(_np(back_j.params), back_t.params, 0.0)
        SJ.write_model(a, str(pj_))
        back_t = ST.read_model(str(pj_), device="cpu")
        _assert_opt_close(_np(a.opt_state), back_t.opt_state)


def test_synthetic_celeba_byte_equal():
    a = DJ.synthetic_celeba(5, seed=9)
    b = DT.synthetic_celeba(5, seed=9)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    aa, ab = (DJ.synthetic_celeba(3, seed=2, return_attrs=True)[1],
              DT.synthetic_celeba(3, seed=2, return_attrs=True)[1])
    assert aa.tobytes() == ab.tobytes()


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    assert depth == 8
    ch = {0: 1, 2: 3}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    assert (raw[:, 0] == 0).all()
    img = raw[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


@pytest.mark.parametrize("shape,vrange", [((3, 6, 5), (-1.0, 1.0)),
                                          ((1, 4, 4), (0.0, 1.0))])
def test_tile_grid_and_png_match_jax(tmp_path, shape, vrange):
    """The port's tile_grid is the JAX one's; the PNG decodes (zlib, in the
    test) to the JAX tile_grid mosaic of the value-range-mapped samples,
    scaled to 8 bits."""
    rng = np.random.RandomState(10)
    s = rng.uniform(vrange[0] - 0.2, vrange[1] + 0.2,
                    (16, int(np.prod(shape)))).astype(np.float32)
    flat = rng.randn(7, 3, 4).astype(np.float32)
    assert np.array_equal(PT.tile_grid(flat, 2, 3), PJ.tile_grid(flat, 2, 3))
    path = PT.save_rgb_grid_png(str(tmp_path / "g.png"), s, shape,
                                value_range=vrange)
    img = _decode_png(open(path, "rb").read())
    c, h, w = shape
    lo, hi = vrange
    arr = np.clip((s.reshape(-1, c, h, w) - lo) / (hi - lo), 0.0, 1.0)
    mosaic = np.stack([PJ.tile_grid(arr[:, k], 4, 4) for k in range(c)], -1)
    want = np.floor(mosaic * 255.0 + 0.5).astype(np.uint8)
    assert np.array_equal(img, want[..., 0] if c == 1 else want)


# -- the program -----------------------------------------------------------------

ARGS = dict(batch_size=B, n_train=24, print_every=2, device="cpu",
            log=None)


@pytest.mark.parametrize("family", ["celeba", "wgan-gp"])
def test_roadmap_main_cpu_end_to_end(tmp_path, capsys, family):
    """The program at full width on the CPU: the JAX run's file set (less
    events.jsonl / run_manifest.json), one metrics record per iteration,
    the result line's keys, and zips that read back as the run's graphs."""
    res = tmp_path / family
    RM.main(["--family", family, "--device", "cpu", "--iterations", "4",
             "--batch-size", str(B), "--n-train", "24", "--print-every", "2",
             "--ema-decay", "0.9", "--res-path", str(res)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"family", "steps", "d_loss", "g_loss", "examples_per_sec",
            "host_seconds"} <= set(result)
    assert result["family"] == family and result["steps"] == 4
    assert result["steps_per_call"] == 2 and not result["graphed"]
    assert np.isfinite([result["d_loss"], result["g_loss"]]).all()
    assert sorted(os.listdir(res)) == sorted(
        [f"{family}_samples_2.png", f"{family}_samples_4.png",
         f"{family}_samples_ema.png", f"{family}_metrics.jsonl",
         f"{family}_gen_model.zip", f"{family}_dis_model.zip",
         f"{family}_gen_ema_model.zip"])
    recs = [json.loads(l) for l in open(res / f"{family}_metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert list(recs[0]) == ["step", "wall_s", "step_s", "d_loss", "g_loss"]
    assert recs[-1]["d_loss"] == pytest.approx(result["d_loss"])
    ema = ST.read_model(str(res / f"{family}_gen_ema_model.zip"), "cpu")
    gen = SJ.read_model(str(res / f"{family}_gen_model.zip"))
    assert set(ema.params) == set(gen.params)
    c, h, w = RM.SAMPLE_SHAPES[family]
    img = _decode_png(open(res / f"{family}_samples_4.png", "rb").read())
    assert img.shape[:2] == (8 * (h + 1) - 1, 8 * (w + 1) - 1)


def _zip_params(path):
    return {k: v.numpy() for l, lp in ST.read_model(path, "cpu").params.items()
            for k, v in ((f"{l}/{n}", t) for n, t in lp.items())}


class _TriggeredGuard(RM.PreemptionGuard):
    """A guard whose signal has already arrived (the first boundary
    preempts)."""

    @property
    def triggered(self):
        return True


def test_roadmap_main_preempt_and_resume_equal_a_straight_run(tmp_path,
                                                              monkeypatch):
    """wgan-gp with the EMA: 4 iterations straight, against a run
    preempted at its first boundary (emergency checkpoint, PREEMPTED.json,
    PreemptionError) and a run checkpointed at 2, each resumed to 4: the
    zips (params and updater state) end bit for bit equal, and the metrics
    cover steps 1-4."""
    kw = dict(ARGS, family="wgan-gp", ema_decay=0.9)
    straight = tmp_path / "straight"
    RM.train(iterations=4, res_path=str(straight), **kw)
    ckpt = tmp_path / "ckpt"
    RM.train(iterations=2, res_path=str(ckpt), checkpoint_every=2, **kw)
    out_ck = RM.train(iterations=4, res_path=str(ckpt), checkpoint_every=2,
                      resume=True, **kw)
    pre = tmp_path / "pre"
    monkeypatch.setattr(RM, "PreemptionGuard", _TriggeredGuard)
    with pytest.raises(RM.PreemptionError) as e:
        RM.train(iterations=4, res_path=str(pre), preempt_signals="SIGUSR1",
                 **kw)
    assert e.value.step == 2
    marker = json.loads(open(pre / RM.MARKER_NAME).read())
    assert marker["step"] == 2 and marker["checkpoint"].endswith("ckpt_2")
    monkeypatch.undo()
    out_pre = RM.train(iterations=4, res_path=str(pre), resume=True, **kw)
    assert not (pre / RM.MARKER_NAME).exists()
    for out in (out_ck, out_pre):
        assert out["steps"] == 4 and out["steps_per_call"] == 2
    for d in (ckpt, pre):
        for name in ("gen", "dis", "gen_ema"):
            a = (straight / f"wgan-gp_{name}_model.zip").read_bytes()
            b = (d / f"wgan-gp_{name}_model.zip").read_bytes()
            assert a == b, (d, name)
        steps = [json.loads(l)["step"] for l in open(d / "wgan-gp_metrics.jsonl")]
        assert sorted(set(steps)) == [1, 2, 3, 4]


@pytest.mark.parametrize("argv", [
    ["--family", "cgan-cifar10", "--n-devices", "2"],
    ["--family", "celeba", "--n-devices", "2"],
    ["--family", "celeba", "--data-dir", "x"],
    ["--family", "celeba", "--profile", "x"],
    ["--family", "celeba", "--metrics-port", "0"]])
def test_roadmap_main_unported_options_raise(tmp_path, argv):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        RM.main(argv + ["--device", "cpu", "--res-path", str(tmp_path)])


@pytest.mark.parametrize("flag,policy", [
    ("--bf16", {"matmul_bf16": True, "compute_bf16": False}),
    ("--mp", {"matmul_bf16": False, "compute_bf16": True})])
def test_roadmap_main_runs_under_a_precision_flag(tmp_path, flag, policy):
    """``--bf16`` / ``--mp`` (refused before they were ported): celeba at
    full width finishes two iterations on the CPU under the flag, with
    finite losses and its sample grid written through the host's f32
    copy; the policy is the run's only (the process's is as before)."""
    from gan_deeplearning4j_tpu_torch.runtime import backend

    before = backend.config()
    result = RM.main(["--family", "celeba", "--iterations", "2",
                      "--batch-size", "4", "--n-train", "8",
                      "--print-every", "2", "--device", "cpu",
                      "--res-path", str(tmp_path), flag])
    assert backend.config() == before
    assert result["steps"] == 2 and result["precision"] == policy
    assert np.isfinite(result["d_loss"]) and np.isfinite(result["g_loss"])
    assert (tmp_path / "celeba_samples_2.png").exists()


def test_advance_draws_replays_the_iterations_draws():
    """A checkpoint without ``z_gen_state`` (one the JAX package wrote)
    puts the draw generator where the iterations left it: after
    ``advance_draws(n)`` its state is that after n eager iterations."""
    pair, cfg, _ = RM._build("wgan-gp", "cpu")
    table = torch.from_numpy(RM._data("wgan-gp", 16, 1)[0])
    ran, replayed = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    step, state = pair.make_multistep(table, batch_size=B, steps_per_call=2,
                                      n_critic=cfg.n_critic, z_size=cfg.z_size,
                                      z_gen=ran)
    step(state)
    RM.advance_draws(pair, replayed, 2, 16, B, cfg.n_critic, cfg.z_size)
    assert torch.equal(ran.get_state(), replayed.get_state())


def test_steps_per_call_is_the_jax_chunk_rule():
    assert RM.steps_per_call(2000, 500, 0, 0, None) == 100
    assert RM.steps_per_call(200, 100, 0, 0, 8) == 5
    assert RM.steps_per_call(4, 2, 0, 0, None) == 2
    assert RM.steps_per_call(400, 100, 100, 100, None) == 100
    assert RM.steps_per_call(300, 100, 0, 150, None) == 50
    assert RM.DEFAULT_BATCH_SIZE == 128
    assert RM.FAMILIES == ("cgan-cifar10", "wgan-gp", "celeba")
