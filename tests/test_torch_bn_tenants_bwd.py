"""The tenant-batched BN's backward (``ops/cuda/bn_act.py``
``bn_act_tenants_bwd``, kernel ``csrc/bn_act.cu`` ``gan4j_bn_act_tenants_bwd``)
and the tenant kernels' launch plan, on the CPU: the closed form against
JAX's ``vjp`` of ``jax.vmap`` over the JAX ``fused_bn_act_train`` (the
Pallas kernel in interpret mode, as the JAX package's tests run it) and
against torch autograd through ``bn_act_tenants_plain``; its edge cases;
the wrapper's contract; ``tenant_plan``; and the fleet step with
``_BnActTenants`` routed through stand-ins of both kernels against the
fleet step through autograd of the plain ops."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.ops.pallas.bn_act import (
    fused_bn_act_train as bn_act_jax,
)
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MT
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
from gan_deeplearning4j_tpu_torch.train import fleet as FL
from gan_deeplearning4j_tpu_torch.train import fused_step as FT

# the fleet step's four train-mode BNs at batch 16, 3 tenants
FLEET_SHAPES = [(3, 32, 12), (3, 16, 2), (3, 16, 12), (3, 16, 100)]
ACTS = sorted(bn2d.ACT_CODES)
EPS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's CPU ops on one thread while this module runs (the tier-1
    lane runs six test processes at once; see tests/test_torch_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    """x, gamma, beta and the cotangents gy, gmean, gvar, f32 from a numpy
    seed; x spread so that every activation sees both signs."""
    n, b, f = shape
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, b, f) * 1.5 + 0.3).astype(np.float32)
    gamma = (rng.rand(n, f) + 0.5).astype(np.float32)
    beta = (0.5 * rng.randn(n, f)).astype(np.float32)
    gy = rng.randn(n, b, f).astype(np.float32)
    gm = rng.randn(n, f).astype(np.float32)
    gv = rng.randn(n, f).astype(np.float32)
    return x, gamma, beta, gy, gm, gv


def _closed_form(x, gamma, beta, gy, gm, gv, act):
    """bn_act_tenants_bwd_plain from the plain forward's saved mean, var."""
    t = [torch.from_numpy(a) for a in (x, gamma, beta, gy, gm, gv)]
    _, mean, var = bn2d.bn_act_tenants_plain(t[0], t[1], t[2], EPS, act)
    return bn2d.bn_act_tenants_bwd_plain(t[0], t[1], t[2], mean, var, t[3],
                                         t[4], t[5], EPS, act)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", FLEET_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_closed_form_matches_jax_vjp_of_vmapped_pallas(shape, act):
    """(dx, dgamma, dbeta) against ``jax.vjp`` of ``jax.vmap`` over the
    JAX ``fused_bn_act_train`` (Pallas, interpret mode; its ``custom_vjp``
    rematerializes through ``_reference``), with cotangents on (y, mean,
    var) and on y alone.  Tolerance 1e-4 absolute and relative, as
    tests/test_torch_fleet.py's tenant gradients: both are f32, the closed
    form sums the B rows once where autodiff differentiates the moments
    separately, and dx is a difference of terms of size B*|gz|."""
    x, gamma, beta, gy, gm, gv = _inputs(shape, 7 * shape[1] + shape[2])

    def f_jax(a, g, b):
        return jax.vmap(lambda a1, g1, b1: bn_act_jax(a1, g1, b1, EPS, act,
                                                      True))(a, g, b)

    _, vjp = jax.vjp(f_jax, *map(jnp.asarray, (x, gamma, beta)))
    zeros = np.zeros_like(gm)
    for cots in ((gy, gm, gv), (gy, zeros, zeros)):
        want = vjp(tuple(map(jnp.asarray, cots)))
        got = _closed_form(x, gamma, beta, *cots, act)
        for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} {act}")


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(3, 16, 12), (5, 32, 100)],
                         ids=lambda s: "x".join(map(str, s)))
def test_closed_form_matches_autograd_of_plain(shape, act):
    """(dx, dgamma, dbeta) against torch autograd through
    ``bn_act_tenants_plain`` (the backward it replaces), same f32 inputs;
    1e-5 absolute and 1e-4 relative: one order of summation against
    another."""
    x, gamma, beta, gy, gm, gv = _inputs(shape, shape[2])
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, gamma, beta)]
    outs = bn2d.bn_act_tenants_plain(*leaves, EPS, act)
    want = torch.autograd.grad(outs, leaves, tuple(
        map(torch.from_numpy, (gy, gm, gv))))
    got = _closed_form(x, gamma, beta, gy, gm, gv, act)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["constant_column", "b2", "f1", "n1"])
def test_closed_form_edge_cases(case):
    """A constant column (var 0: rstd = 1/sqrt(eps)), B = 2, F = 1 and one
    tenant, each against autograd of the plain forward; every value
    finite.  Tolerance 1e-4 relative to the largest gradient: at var 0 the
    gradient is scaled by 1/sqrt(eps) ~ 316."""
    shape = {"constant_column": (2, 16, 3), "b2": (3, 2, 5), "f1": (3, 8, 1),
             "n1": (1, 16, 12)}[case]
    x, gamma, beta, gy, gm, gv = _inputs(shape, 11)
    if case == "constant_column":
        x[0, :, 1] = 0.75
        x[1, :, 2] = -2.0
    for act in ("elu", "tanh"):
        leaves = [torch.tensor(a, requires_grad=True)
                  for a in (x, gamma, beta)]
        outs = bn2d.bn_act_tenants_plain(*leaves, EPS, act)
        want = torch.autograd.grad(outs, leaves, tuple(
            map(torch.from_numpy, (gy, gm, gv))))
        got = _closed_form(x, gamma, beta, gy, gm, gv, act)
        for a, b in zip(got, want):
            assert bool(torch.isfinite(a).all())
            scale = float(b.abs().max()) + 1.0
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale)


def test_wrapper_contract_on_the_cpu():
    """Shape, device and dtype refusals; a CPU tensor takes the closed
    form (the counter stays 0); need_dx=False gives no dx and the same
    dgamma, dbeta."""
    x, gamma, beta, gy, gm, gv = (torch.from_numpy(a)
                                  for a in _inputs((2, 4, 3), 3))
    _, mean, var = bn2d.bn_act_tenants_plain(x, gamma, beta, EPS, "elu")
    args = (x, gamma, beta, mean, var, gy, gm, gv)
    with pytest.raises(ValueError, match=r"\[N, B, F\]"):
        kernels.bn_act_tenants_bwd(x[0], *args[1:])
    with pytest.raises(ValueError, match=r"\[N, B, F\]"):
        kernels.bn_act_tenants_bwd(x, *args[1:5], gy[:, :2], gm, gv)
    with pytest.raises(ValueError, match="gmean"):
        kernels.bn_act_tenants_bwd(*args[:6], gm[:, :2], gv)
    with pytest.raises(ValueError, match="var"):
        kernels.bn_act_tenants_bwd(*args[:4], var[0], *args[5:])
    with pytest.raises(TypeError):
        kernels.bn_act_tenants_bwd(x.double(), *args[1:])
    with pytest.raises(TypeError):
        kernels.bn_act_tenants_bwd(*args[:5], gy.double(), gm, gv)
    kernels.reset_launch_counts()
    dx, dg, db = kernels.bn_act_tenants_bwd(*args, EPS, "elu")
    want = bn2d.bn_act_tenants_bwd_plain(*args, EPS, "elu")
    for a, b in zip((dx, dg, db), want):
        assert torch.equal(a, b)
    none, dg2, db2 = kernels.bn_act_tenants_bwd(*args, EPS, "ELU",
                                                need_dx=False)
    assert none is None and torch.equal(dg2, dg) and torch.equal(db2, db)
    assert kernels.launch_counts()["bn_act_tenants_bwd"] == 0
    with pytest.raises(ValueError, match="activation"):
        bn2d.act_grad_plain(x, "softmax")


# -- the plan ---------------------------------------------------------------

PLAN_CASES = [(n, b, f, slabs) for n in (1, 64, 1024, 4096)
              for b, f in ((32, 12), (16, 2), (16, 12), (16, 100))
              for slabs in (1, 2)] + [
    (7, 5, 2, 1), (7, 5, 2, 2), (9, 3, 3, 1), (2, 16, 600, 1),
    (1, 200, 200, 1), (500, 5, 3, 2), (33, 7, 13, 2)]


@pytest.mark.parametrize("n,b,f,slabs", PLAN_CASES)
def test_tenant_plan(n, b, f, slabs):
    """Whole tenants a stage and enough stages for every tenant; R threads
    a (tenant, column) pair (whole warps, at most TENANT_MAX_THREADS, and
    no more warps than the pairs need); a stage whose bytes end on 16
    where T can be rounded to that; shared memory the ring of padded
    buffers within MAX_DYNAMIC_SMEM; a grid of the stages or of whole SMs
    (blocks_per_sm a block each SM), never more blocks than stages."""
    p = bn2d.tenant_plan(n, b, f, sms=132, slabs=slabs)
    assert 1 <= p.per_stage <= n and p.stages == -(-n // p.per_stage)
    assert p.threads % 32 == 0 and 32 <= p.threads <= bn2d.TENANT_MAX_THREADS
    # R threads a pair: a power of two within a warp, each with at least
    # TENANT_ROWS_A_THREAD rows, and only where x is small for the card
    assert p.split in (1, 2, 4) and p.split == bn2d.tenant_split(n, b, f)
    assert p.split == 1 or f < 32  # in-order columns take one thread
    x_per_sm = 4 * n * b * f / 132
    assert p.split == 1 or b // p.split >= bn2d.TENANT_ROWS_A_THREAD
    assert p.split <= 2 or x_per_sm <= bn2d.TENANT_SPLIT_BYTES
    assert p.split == 1 or x_per_sm <= bn2d.TENANT_SPLIT_BYTES or (
        x_per_sm <= bn2d.TENANT_PAIR_SPLIT_BYTES and f <= 32)
    lanes = p.per_stage * f * p.split
    assert p.threads == min(bn2d.TENANT_MAX_THREADS, -(-lanes // 32) * 32)
    if f * p.split <= bn2d.TENANT_MAX_THREADS:
        assert lanes <= p.threads  # every pair has its threads
    if p.per_stage >= 4:
        assert p.per_stage * b * f % 4 == 0  # the slab ends on 16 bytes
    buf = bn2d.tenant_buffer_floats(p.per_stage, b, f)
    assert buf % 4 == 0 and buf >= p.per_stage * b * f + 3
    assert p.smem_bytes == 4 * p.ring * slabs * buf <= bn2d.MAX_DYNAMIC_SMEM
    assert p.ring in (1, 2)
    assert p.grid == min(p.stages, p.blocks_per_sm * 132)
    assert p.blocks_per_sm * p.threads <= bn2d.THREADS_PER_SM
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= bn2d.SMEM_PER_SM
    if p.ring == 2:
        assert p.stages > p.grid and p.blocks_per_sm >= 2


def test_tenant_plan_at_the_fleet_shapes():
    """The fleet's four BNs at 1, 1,024 and 4,096 tenants: T from two
    stages an SM (ceil(N / 264)); the rows split over 4 threads where x is
    at most 16 KB an SM, over 2 up to 64 KB, never for [16, 100] (its
    first 96 columns sum their rows in order, as the reference does), where
    at 4,096 tenants 5 of them (500 pairs in 512 threads) take a ring of
    two over a persistent grid of three blocks an SM."""
    def plan(n, b, f, slabs=1):
        p = bn2d.tenant_plan(n, b, f, sms=132, slabs=slabs)
        return p.per_stage, p.split, p.threads, p.ring, p.stages, p.grid

    assert plan(1, 32, 12) == (1, 4, 64, 1, 1, 1)
    assert plan(1, 16, 100) == (1, 1, 128, 1, 1, 1)
    assert plan(1024, 32, 12) == (4, 4, 192, 1, 256, 256)
    assert plan(1024, 16, 2) == (4, 4, 32, 1, 256, 256)
    assert plan(1024, 16, 12) == (4, 4, 192, 1, 256, 256)
    assert plan(1024, 16, 100) == (4, 1, 416, 1, 256, 256)
    assert plan(4096, 32, 12) == (16, 2, 384, 1, 256, 256)
    assert plan(4096, 16, 2) == (16, 4, 128, 1, 256, 256)
    assert plan(4096, 16, 100) == (5, 1, 512, 2, 820, 396)
    assert plan(4096, 16, 100, slabs=2) == (5, 1, 512, 1, 820, 396)
    # an odd slab (40 bytes a tenant): T even, so each stage ends on 16
    p = bn2d.tenant_plan(1000, 5, 2, sms=132)
    assert p.per_stage % 2 == 0 and p.per_stage * 40 % 16 == 0


@pytest.mark.parametrize("b,f,slabs", [(200, 6272, 1), (2, 40_000, 1),
                                       (200, 200, 2), (16, 4000, 2)])
def test_tenant_plan_refuses_a_tenant_that_does_not_fit(b, f, slabs):
    """One tenant's slabs (and the head of 3) past MAX_DYNAMIC_SMEM: no
    plan.  The forward takes [1, 200, 200] (160 KB); its backward, with x
    and gy staged, does not."""
    assert 4 * slabs * (b * f + 3) > bn2d.MAX_DYNAMIC_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        bn2d.tenant_plan(1, b, f, slabs=slabs)


def test_empty_aligned_with_keeps_the_address_modulo_16():
    """The result tensor of a tenant kernel agrees with the input it is
    stored from modulo 16 bytes, also for an input that starts off a
    16-byte boundary."""
    base = torch.zeros(64)
    for off in range(4):
        ref = base[off:off + 40].view(2, 4, 5)
        out = bn2d.empty_aligned_with(ref)
        assert out.shape == ref.shape and out.is_contiguous()
        assert (out.data_ptr() - ref.data_ptr()) % 16 == 0


# -- the plumbing: _BnActTenants on the CPU through stand-ins ---------------

N = 4
B = 8
ROWS = 24


def test_fleet_step_through_the_autograd_function_matches_plain():
    """The fleet step on the CPU with ``fused_bn_act_train_tenants`` routed
    through ``_BnActTenants`` (its forward's launch a stand-in running the
    plain forward; its backward's call of ``bn_act_tenants_bwd`` recorded,
    which on the CPU runs the closed form) against the same step through
    autograd of the plain ops: losses and every leaf of the new state
    within 1e-5 relative / 2e-5 absolute (the closed form against
    autodiff, then RmsProp; tests/test_torch_fleet.py FIRST).  The forward
    saves mean and var beside x, gamma and beta, the backward gets the
    cotangents in (y, mean, var) order, and the discriminator step's input
    BN and the GAN step's BN over the latents (inputs that need no
    gradient) ask for no dx: 4 forward and 4 backward launches, two
    without dx."""
    dis = MT.build_discriminator(device="cpu")
    graphs = (dis, MT.build_generator(device="cpu"),
              MT.build_gan(device="cpu"), MT.build_classifier(dis))
    maps = (MT.DIS_TO_GAN, MT.GAN_TO_GEN, MT.DIS_TO_CLASSIFIER)
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.rand(N, ROWS, 12).astype(np.float32))
    labels = torch.from_numpy((rng.rand(N, ROWS, 1) < 0.5).astype(
        np.float32))
    ones = np.ones((B, 1), np.float32)
    targets = [torch.from_numpy(a) for a in (
        ones + (0.05 * rng.randn(B, 1)).astype(np.float32),
        (0.05 * rng.randn(B, 1)).astype(np.float32), ones)]
    z1, z2 = (torch.from_numpy(rng.uniform(-1, 1, (N, B, 2)).astype(
        np.float32)) for _ in range(2))
    start = FL.replicate_state(FT.state_from_graphs(*graphs), N)
    step = FL.make_fleet_step(*graphs, *maps, z_size=2, num_features=12,
                              per_tenant_data=True)
    want_state, want_losses = step(FT.clone_state(start), feats, labels,
                                   *targets, z1=z1, z2=z2)

    seen = {"fwd": 0, "bwd": [], "saved": []}

    def fwd_launch(x, gamma, beta, eps, act_name):
        seen["fwd"] += 1
        with torch.no_grad():
            return bn2d.bn_act_tenants_plain(x, gamma, beta, eps, act_name)

    real_bwd = bn2d.bn_act_tenants_bwd

    def bwd_kernel(x, gamma, beta, mean, var, gy, gmean, gvar, eps,
                   act_name, need_dx):
        seen["bwd"].append((tuple(x.shape[1:]), need_dx))
        seen["saved"].append((mean.shape, var.shape, gmean.shape))
        return real_bwd(x, gamma, beta, mean, var, gy, gmean, gvar, eps,
                        act_name, need_dx=need_dx)

    def routed(x, gamma, beta, eps=1e-5, act_name="identity"):
        return bn2d._BnActTenants.apply(x, gamma, beta, float(eps),
                                        act_name.lower())

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(bn2d, "_tenants_launch", fwd_launch)
        mp.setattr(bn2d, "bn_act_tenants_bwd", bwd_kernel)
        mp.setattr(FL, "fused_bn_act_train_tenants", routed)
        got_state, got_losses = step(FT.clone_state(start), feats, labels,
                                     *targets, z1=z1, z2=z2)
    finally:
        mp.undo()
    assert seen["fwd"] == 4 and len(seen["bwd"]) == 4
    # in backward order: the discriminator's input BN over the data, then
    # the GAN graph's BN over the generator's output, its BN over the
    # latents, its hidden BN; only the inputs that carry no gradient (the
    # data, the latents) skip dx
    assert seen["bwd"] == [((2 * B, 12), False), ((B, 12), True),
                           ((B, 2), False), ((B, 100), True)]
    assert all(m[0] == m[1] == m[2] and m[0][0] == N for m in seen["saved"])
    for a, b in zip(got_losses, want_losses):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
    want, got = FT._leaves(want_state), FT._leaves(got_state)
    assert want.keys() == got.keys()
    for key, a in want.items():
        b = got[key]
        assert a.shape == b.shape, key
        if a.numel() and a.is_floating_point():
            assert float((a - b).abs().max()) <= 2e-5, key
        else:
            assert torch.equal(a, b), key
    assert math.isfinite(float(got_losses[0].sum()))
