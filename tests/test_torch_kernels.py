"""The port's kernel modules on the CPU: each plain version against the JAX
package's Pallas function run in interpret mode (as tests/test_pallas.py
and tests/test_pallas_dma.py run it), and the wrappers' routing — a CPU
tensor takes the plain version and launches nothing."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.ops.pallas.bn_act import (
    LANE,
    SUBLANE,
    _apply,
    _local_moments,
    _pad_to,
)
from gan_deeplearning4j_tpu.ops.pallas.bn_act import fused_bn_act_train as bn_act_jax
from gan_deeplearning4j_tpu.ops.pallas.bn_act import (
    fused_bn_act_train_4d as bn_act_4d_jax,
)
from gan_deeplearning4j_tpu.ops.pallas.dma_pipeline import upsample_bwd_dma
from gan_deeplearning4j_tpu.ops.pallas.fused_update import fused_rmsprop_chain as chain_jax
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
from gan_deeplearning4j_tpu_torch.ops import activations as act_lib
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act_4d as bn4d
from gan_deeplearning4j_tpu_torch.ops.cuda import fused_update as fu
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act import (
    bn_act_plain,
    bn_apply_plain,
    bn_apply_sums_plain,
    bn_moments_plain,
)
from gan_deeplearning4j_tpu_torch.ops.cuda.bn_act_4d import bn_act_4d_plain
from gan_deeplearning4j_tpu_torch.ops.cuda.fused_update import rmsprop_chain_plain
from gan_deeplearning4j_tpu_torch.ops.cuda.upsample_bwd import upsample_bwd_plain
from gan_deeplearning4j_tpu_torch.optim import updater as updater_mod


@pytest.fixture(autouse=True)
def _no_launch_leaks():
    """Nothing in this file may launch a kernel: every tensor is on the CPU."""
    kernels.reset_launch_counts()
    yield
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}


# -- bn_act ------------------------------------------------------------------

@pytest.mark.parametrize("act", ["tanh", "identity", "sigmoid"])
@pytest.mark.parametrize("B", [8, 13])
@pytest.mark.parametrize("F", [2, 1024, 300])
def test_bn_act_matches_pallas(F, B, act):
    """Values (y, mean, var) and gradients (x, gamma, beta) against the
    Pallas kernel in interpret mode; B = 13 and F = 2 / 300 exercise the
    TPU kernel's row and lane padding.  Tolerances: f32 with different
    reduction orders, 1e-5 absolute on values of O(1), 1e-4 on the
    gradients (a sum over B of products)."""
    rng = np.random.RandomState(F * 31 + B)
    x = (rng.randn(B, F) * 2 + 1).astype(np.float32)
    gamma = (rng.rand(F) + 0.5).astype(np.float32)
    beta = rng.randn(F).astype(np.float32)
    gy = rng.randn(B, F).astype(np.float32)
    gm = rng.randn(F).astype(np.float32)

    def f_jax(a, g, b):
        return bn_act_jax(a, g, b, 1e-5, act, True)

    outs_j, vjp = jax.vjp(f_jax, jnp.asarray(x), jnp.asarray(gamma),
                          jnp.asarray(beta))
    grads_j = vjp((jnp.asarray(gy), jnp.asarray(gm), jnp.zeros(F)))

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, gamma, beta)]
    outs_t = kernels.fused_bn_act_train(*leaves, 1e-5, act)
    grads_t = torch.autograd.grad(
        outs_t, leaves, (torch.from_numpy(gy), torch.from_numpy(gm),
                         torch.zeros(F)))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


def test_bn_act_wrapper_checks_its_inputs():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match=r"\[B, F\]"):
        kernels.fused_bn_act_train(torch.zeros(4, 3, 2), torch.ones(3),
                                   torch.zeros(3))
    with pytest.raises(ValueError, match="gamma"):
        kernels.fused_bn_act_train(x, torch.ones(4), torch.zeros(3))
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_bn_act_train(x.double(), torch.ones(3).double(),
                                   torch.zeros(3).double())


# -- bn_moments / bn_apply (the sync-BN pair) ---------------------------------

@pytest.mark.parametrize("B,F", [(8, 192), (5, 130), (13, 2)])
def test_bn_moments_and_apply_match_pallas(B, F):
    """One rank's halves of the pair, each against its Pallas kernel in
    interpret mode (rows and lanes padded as the TPU path pads them): the
    moments (E[x], E[x^2]), then the apply step on the moments they give.
    The 2-rank pair with its all-reduce is tests/test_torch_dp.py's.
    Tolerances: 1e-6 on the moments, 1e-5 on y (f32, other reduction
    orders, values of O(1))."""
    rng = np.random.RandomState(B * 7 + F)
    x = (rng.randn(B, F) * 1.5 - 0.5).astype(np.float32)
    gamma = (rng.rand(F) + 0.5).astype(np.float32)
    beta = rng.randn(F).astype(np.float32)
    B_pad, F_pad = -(-B // SUBLANE) * SUBLANE, -(-F // LANE) * LANE
    xp = _pad_to(jnp.asarray(x), B_pad, F_pad)
    mean_j, m2_j = _local_moments(xp, B, B_pad, F_pad, True)
    var_j = m2_j - mean_j * mean_j
    y_j = _apply(xp, mean_j, var_j, _pad_to(jnp.asarray(gamma)[None], 1, F_pad),
                 _pad_to(jnp.asarray(beta)[None], 1, F_pad), B_pad, F_pad,
                 1e-5, "tanh", True)[:B, :F]

    mean_t, m2_t = kernels.bn_moments(torch.from_numpy(x))
    for a, b in ((mean_t, mean_j), (m2_t, m2_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[0, :F],
                                   rtol=1e-6, atol=1e-6)
    var_t = m2_t - mean_t * mean_t
    y_t = kernels.bn_apply(torch.from_numpy(x), mean_t, var_t,
                           torch.from_numpy(gamma), torch.from_numpy(beta),
                           1e-5, "tanh")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)


def test_bn_pair_wrappers_check_their_inputs():
    x, v = torch.zeros(4, 3), torch.zeros(3)
    with pytest.raises(ValueError, match=r"\[B, F\]"):
        kernels.bn_moments(torch.zeros(4, 3, 2))
    with pytest.raises(TypeError, match="float32"):
        kernels.bn_moments(x.double())
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.bn_moments(torch.zeros(4, 3, device="meta"))
    with pytest.raises(ValueError, match="var"):
        kernels.bn_apply(x, v, torch.zeros(4), v, v)
    with pytest.raises(ValueError, match="does not match"):
        kernels.bn_apply(x, v, v, v.to("meta"), v)
    with pytest.raises(TypeError, match="float32"):
        kernels.bn_apply(x, v.double(), v, v, v)


def random_sums(B, F, world, seed):
    """(x [B, F], sums [2, F], gamma, beta): sums as ``world`` ranks' summed
    moments (rank r's E[x] and E[x^2] this x's scaled by f = 1 + 0.1 r and
    f^2, so var >= the mean f^2 times this x's var > 0)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(B, F) * 1.5 - 0.5).astype(np.float32))
    mean, m2 = bn_moments_plain(x)
    parts = [torch.stack([mean * (1 + 0.1 * r), m2 * (1 + 0.1 * r) ** 2])
             for r in range(world)]
    sums = torch.stack(parts).sum(0)
    gamma = torch.from_numpy((rng.rand(F) + 0.5).astype(np.float32))
    beta = torch.from_numpy(rng.randn(F).astype(np.float32))
    return x, sums, gamma, beta


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_bn_apply_sums_prologue_emulation(world):
    """csrc/bn_moments_apply.cu's from-sums prologue in float32 numpy:
    mean = s * (1/world), var = s2 * (1/world) - mean * mean, each product
    and the difference rounded on its own (no FMA).  That is the torch
    composition with the divide taken as a multiply by the float
    reciprocal, which is how torch divides a CUDA tensor by a Python scalar
    (the card's check in chip_smoke.py holds the kernel to the old epilogue
    there).  On the CPU torch divides: for powers of two the plain version
    gives the same bits; for world 3 some elements differ by one unit in
    the last place, so this case tells the two apart."""
    x, sums, gamma, beta = random_sums(5, 130, world, 10 + world)
    s = sums.numpy()
    inv = np.float32(1.0) / np.float32(world)
    mean = s[0] * inv
    var = s[1] * inv - mean * mean
    stats = sums * torch.tensor(inv)
    np.testing.assert_array_equal(mean, stats[0].numpy())
    np.testing.assert_array_equal(
        var, (stats[1] - torch.square(stats[0])).numpy())
    y_p, mean_p, var_p = bn_apply_sums_plain(x, sums, world, gamma, beta,
                                             1e-5, "tanh")
    assert torch.equal(y_p, bn_apply_plain(x, mean_p, var_p, gamma, beta,
                                           1e-5, "tanh"))
    if world & (world - 1) == 0:
        np.testing.assert_array_equal(mean, mean_p.numpy())
        np.testing.assert_array_equal(var, var_p.numpy())
    else:
        assert not (np.array_equal(mean, mean_p.numpy())
                    and np.array_equal(var, var_p.numpy()))
        np.testing.assert_array_max_ulp(mean, mean_p.numpy(), maxulp=1)


def test_bn_apply_sums_wrapper_checks_its_inputs():
    x, v, sums = torch.zeros(4, 3), torch.zeros(3), torch.zeros(2, 3)
    with pytest.raises(ValueError, match=r"\[2, 3\]"):
        kernels.bn_apply_sums(x, torch.zeros(3), 2, v, v)
    with pytest.raises(ValueError, match=r"\[2, 3\]"):
        kernels.bn_apply_sums(x, torch.zeros(2, 4), 2, v, v)
    with pytest.raises(ValueError, match=r"\[2, 3\]"):
        kernels.bn_apply_sums(x, sums.double(), 2, v, v)
    with pytest.raises(ValueError, match=r"\[2, 3\]"):
        kernels.bn_apply_sums(x, sums.to("meta"), 2, v, v)
    with pytest.raises(ValueError, match="world 0"):
        kernels.bn_apply_sums(x, sums, 0, v, v)
    with pytest.raises(ValueError, match="beta"):
        kernels.bn_apply_sums(x, sums, 2, v, torch.zeros(4))
    with pytest.raises(TypeError, match="float32"):
        kernels.bn_apply_sums(x.double(), sums, 2, v, v)


def test_bn_apply_sums_cpu_takes_the_plain_version():
    x, sums, gamma, beta = random_sums(6, 5, 2, 3)
    for a, b in zip(kernels.bn_apply_sums(x, sums, 2, gamma, beta, 1e-5, "TANH"),
                    bn_apply_sums_plain(x, sums, 2, gamma, beta, 1e-5, "tanh")):
        assert torch.equal(a, b)


# -- bn_act_4d ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 5, 7, 7), (6, 64, 8, 8),
                                   (9, 3, 16, 16)])
def test_bn_act_4d_matches_pallas(shape):
    """Values (y, mean, var) and the gradients of sum(y^2) against the
    Pallas 4-D kernel in interpret mode, at the shapes and with the
    tolerances of tests/test_pallas.py (they pad rows, channels and
    lanes): mean rtol 1e-5 atol 1e-6; var and y rtol 1e-4 atol 1e-5; the
    gradients rtol 1e-4 atol 1e-4."""
    rng = np.random.RandomState(7)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    gamma = (rng.rand(shape[1]) + 0.5).astype(np.float32)
    beta = rng.randn(shape[1]).astype(np.float32)

    def loss_j(a, g, b):
        return jnp.sum(bn_act_4d_jax(a, g, b, 1e-5, "tanh", True)[0] ** 2)

    args_j = [jnp.asarray(a) for a in (x, gamma, beta)]
    outs_j = bn_act_4d_jax(*args_j, 1e-5, "tanh", True)
    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(*args_j)

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, gamma, beta)]
    outs_t = kernels.fused_bn_act_train_4d(*leaves, 1e-5, "tanh")
    grads_t = torch.autograd.grad(torch.sum(outs_t[0] ** 2), leaves)
    for a, b, (rtol, atol) in zip(outs_t, outs_j, [(1e-4, 1e-5), (1e-5, 1e-6),
                                                   (1e-4, 1e-5)]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_bn_act_4d_wrapper_checks_its_inputs():
    x, v = torch.zeros(2, 3, 4, 4), torch.zeros(3)
    with pytest.raises(ValueError, match=r"\[B, C, H, W\]"):
        kernels.fused_bn_act_train_4d(torch.zeros(2, 3), v, v)
    with pytest.raises(ValueError, match="beta"):
        kernels.fused_bn_act_train_4d(x, v, torch.zeros(4))
    with pytest.raises(ValueError, match="does not match"):
        kernels.fused_bn_act_train_4d(x, v.to("meta"), v)
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_bn_act_train_4d(x.double(), v.double(), v.double())
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_bn_act_train_4d(x.to("meta"), v.to("meta"),
                                      v.to("meta"))


# -- the cluster kernels' launch plans (csrc/bn_act.cu, csrc/bn_act_4d.cu) ----
#
# The plans are computed in Python so that they are tested here; the kernels
# check them again.  Each kernel's partition is emulated below in numpy and
# torch: which elements each block and thread visits, and the per-block
# partial sums combined over the cluster in rank order.

# the protocol step's three, then B = 1, F = 1, ragged groups, a tall input
# and one whose rows do not fit in eight blocks' shared memory (streamed)
PLAN_2D = [(200, 2), (200, 6272), (200, 1024), (1, 1), (1, 1024), (9, 33),
           (13, 300), (3000, 100), (20000, 64)]
# chip_smoke.py's five benchmark shapes and its streamed shape, then B = 1,
# H*W % 4 != 0, C = 1, H*W = 1 and small channels
PLAN_4D = [(200, 64, 12, 12), (128, 64, 32, 32), (128, 128, 16, 16),
           (128, 256, 8, 8), (128, 512, 4, 4), (32, 10, 128, 128),
           (1, 64, 32, 32), (3, 5, 7, 7), (8, 1, 28, 28), (16, 300, 1, 1),
           (2, 7, 6, 6)]
ALIGNED, MISALIGNED = 256, 260  # data_ptr values: 16-byte aligned or not
# the insurance step's 2-D BNs on one device (dis [100, 12] ELU, gan
# [50, 2] TANH and [50, 12] ELU, classifier [50, 100] ELU) and a 2-rank
# step's per-rank shapes, 25 rows (the gan's and the classifier's; the
# discriminator's is [50, 12])
INSURANCE_2D = [(100, 12), (50, 2), (50, 12), (50, 100)]
INSURANCE_RANK = [(25, 2), (25, 12), (25, 100)]


def thread_offsets_4d(begin, end, threads, hw, row_stride):
    """The unit offsets (from the channel's first unit) that the threads of
    one csrc/bn_act_4d.cu block visit for its units [begin, end), in the
    kernel's order: thread t visits units begin + t, + T, ..., stepping
    its Cursor (column, offset) without a divide.  -> int64 [end - begin]."""
    n = max(end - begin, 0)
    out = np.full(n, -1, dtype=np.int64)
    t = np.arange(min(threads, n))
    row, col = np.divmod(begin + t, hw)
    off = row * row_stride + col
    dcol = threads % hw
    doff = (threads // hw) * row_stride + dcol
    for step in range(-(-n // threads)):
        j = t + step * threads
        live = j < n
        out[j[live]] = off[live]
        col = col + dcol
        off = off + doff
        wrap = col >= hw
        col[wrap] -= hw
        off[wrap] += row_stride - hw
    return out


def plan_blocks_4d(B, C, HW, plan):
    """[(rank, begin, end)] of one channel's cluster; every channel's is
    the same, offset by its own first unit."""
    units = B * HW // plan.vec
    P = plan.units_per_block
    return [(r, r * P, min(units, (r + 1) * P)) for r in range(plan.cluster)]


@pytest.mark.parametrize("ptr", [ALIGNED, MISALIGNED])
@pytest.mark.parametrize("shape", PLAN_4D)
def test_bn_act_4d_plan(shape, ptr):
    """The 4-D plan's limits, and that its blocks' and threads' ranges cover
    every element of a channel exactly once."""
    B, C, H, W = shape
    HW = H * W
    plan = bn4d.launch_plan(B, C, HW, ptr)
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.vec == (4 if HW % 4 == 0 and ptr % 16 == 0 else 1)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= bn4d.MAX_THREADS
    assert plan.grid == C * plan.cluster
    units = B * HW // plan.vec
    assert units * plan.vec == B * HW
    assert plan.smem_bytes <= bn2d.MAX_DYNAMIC_SMEM < bn2d.SMEM_PER_BLOCK
    share = plan.units_per_block * plan.vec * 4
    if plan.resident:
        assert plan.smem_bytes == share
    else:
        assert plan.smem_bytes == 0 and share > bn2d.MAX_DYNAMIC_SMEM
        assert plan.cluster == bn2d.MAX_CLUSTER
    if C * min(bn2d.MAX_CLUSTER, units) >= bn2d.SMS:
        assert plan.grid >= bn2d.SMS
    hw_v, stride = HW // plan.vec, C * HW // plan.vec
    seen = np.concatenate([
        thread_offsets_4d(b, e, plan.threads, hw_v, stride)
        for _, b, e in plan_blocks_4d(B, C, HW, plan)])
    want = (np.arange(B)[:, None] * stride + np.arange(hw_v)[None]).ravel()
    assert seen.size == want.size
    np.testing.assert_array_equal(np.sort(seen), want)


@pytest.mark.parametrize("shape", PLAN_2D + INSURANCE_2D + INSURANCE_RANK)
def test_bn_act_plan(shape):
    """The 2-D plan's limits, and that its blocks' rows and lanes' columns
    cover every element exactly once."""
    B, F = shape
    plan = bn2d.launch_plan(B, F)
    groups = -(-F // bn2d.GROUP)
    assert plan.cluster in (1, 2, 4, 8)
    assert 1 <= plan.row_threads <= bn2d.MAX_ROW_THREADS
    assert plan.grid == groups * plan.cluster
    assert plan.smem_bytes <= bn2d.MAX_DYNAMIC_SMEM < bn2d.SMEM_PER_BLOCK
    share = plan.rows_per_block * bn2d.GROUP * 4
    if plan.resident:
        assert plan.smem_bytes == share
    else:
        assert plan.smem_bytes == 0 and share > bn2d.MAX_DYNAMIC_SMEM
        assert plan.cluster == bn2d.MAX_CLUSTER
    # a row is the smallest share: at B < 8 rows there are at most B blocks
    if groups * min(bn2d.MAX_CLUSTER, B) >= bn2d.SMS:
        assert plan.grid >= bn2d.SMS
    count = np.zeros((B, groups * bn2d.GROUP), dtype=np.int64)
    R = plan.rows_per_block
    for r in range(plan.cluster):
        r0, r1 = r * R, min(B, (r + 1) * R)
        for ty in range(plan.row_threads):
            count[r0 + ty:r1:plan.row_threads] += 1
    assert (count[:, :F] == 1).all()


def test_plans_at_the_main_shapes():
    """The splits the card runs on the protocol step and on chip_smoke.py's
    benchmark shapes: one block per SM or more, three blocks' shares per
    SM at most, and the streamed shape streamed."""
    assert [tuple(bn2d.launch_plan(200, f))[:3] for f in (2, 6272, 1024)] == [
        (8, 25, 13), (1, 200, 16), (8, 25, 13)]
    got = [bn4d.launch_plan(b, c, h * w, ALIGNED)
           for b, c, h, w in PLAN_4D[:6]]
    assert [(p.cluster, p.threads, p.vec, p.resident) for p in got] == [
        (4, 256, 4, True), (8, 256, 4, True), (2, 256, 4, True),
        (1, 256, 4, True), (1, 128, 4, True), (8, 256, 4, False)]
    assert all(p.smem_bytes <= bn2d.TARGET_SMEM for p in got)


# the sync-BN pair (csrc/bn_moments_apply.cu) at a 2-rank step's per-rank
# shapes and ragged ones: F = 2 (the scalar path), 130 (a ragged group),
# 6272; B = 1, 5, 100
PLAN_PAIR = [(B, F) for F in (2, 130, 6272) for B in (1, 5, 100)]
PAIR_CASES = PLAN_PAIR + [(20000, 64)] + INSURANCE_2D + INSURANCE_RANK


def moments_thread_rows(B, ty, rt):
    """The rows one moments thread reads, in the kernel's order: rounds of
    MOMENTS_UNROLL rows ty, ty + rt, ..., each row < B."""
    out, b0, u_max = [], ty, bn2d.MOMENTS_UNROLL
    while b0 < B:
        out += [b0 + u * rt for u in range(u_max) if b0 + u * rt < B]
        b0 += u_max * rt
    return out


def apply_thread_rows(r0, r1, ty, rt):
    """The rows one apply thread writes: r0 + ty, + rt, ..., APPLY_ROWS of
    them, each < r1."""
    return [r0 + ty + u * rt for u in range(bn2d.APPLY_ROWS)
            if r0 + ty + u * rt < r1]


@pytest.mark.parametrize("shape", PAIR_CASES,
                         ids=[f"{b}x{f}" for b, f in PAIR_CASES])
def test_bn_moments_plan(shape):
    """The moments plan: one block per column group, whole warps of
    row-threads (at most 32), and the row-threads' rounds reading each row
    exactly once, in one round of loads a thread where 32 row-threads allow
    it (B <= 256) and in several for a taller input."""
    B, F = shape
    plan = bn2d.moments_plan(B, F)
    rt = plan.row_threads
    assert plan.grid == -(-F // bn2d.PAIR_GROUP)
    assert rt % bn2d.WARP_ROWS == 0 and 0 < rt <= bn2d.PAIR_MAX_ROW_THREADS
    count = np.zeros(B, dtype=np.int64)
    for ty in range(rt):
        mine = moments_thread_rows(B, ty, rt)
        if B <= bn2d.PAIR_MAX_ROW_THREADS * bn2d.MOMENTS_UNROLL:
            assert len(mine) <= bn2d.MOMENTS_UNROLL
        count[mine] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", PAIR_CASES,
                         ids=[f"{b}x{f}" for b, f in PAIR_CASES])
def test_bn_apply_plan(shape):
    """The apply plan: column groups cover F, row chunks of APPLY_ROWS rows
    a row-thread cover B (the C entry refuses a longer chunk), whole warps
    of row-threads, one block per SM or more where a warp per block allows
    it, and the threads' rows cover every row of a chunk exactly once."""
    B, F = shape
    plan = bn2d.apply_plan(B, F)
    chunks, groups = plan.grid
    rt, R = plan.row_threads, plan.rows_per_block
    assert groups == -(-F // bn2d.PAIR_GROUP)
    assert rt in (4, 8, 16, 32) and R == rt * bn2d.APPLY_ROWS
    assert (chunks - 1) * R < B <= chunks * R
    if groups * -(-B // (bn2d.WARP_ROWS * bn2d.APPLY_ROWS)) >= bn2d.SMS:
        assert chunks * groups >= bn2d.SMS
    count = np.zeros(B, dtype=np.int64)
    for c in range(chunks):
        for ty in range(rt):
            for b in apply_thread_rows(c * R, min(B, (c + 1) * R), ty, rt):
                count[b] += 1
    assert (count == 1).all()


def test_pair_plans_at_the_main_shapes():
    """The splits the card runs at a 2-rank step's per-rank shapes."""
    assert [tuple(bn2d.moments_plan(100, f)) for f in (2, 6272, 1024)] == [
        (16, 1), (16, 196), (16, 32)]
    assert [tuple(bn2d.apply_plan(100, f)) for f in (2, 6272, 1024)] == [
        (4, 8, (13, 1)), (32, 64, (2, 196)), (8, 16, (7, 32))]
    assert tuple(bn2d.moments_plan(20000, 64)) == (32, 2)


def test_plans_at_the_insurance_shapes():
    """The splits the card runs on the insurance step: on one device a
    cluster of 8 blocks per 32-column group even for 100 floats ([50, 2]),
    the last block holding the remainder of the rows (one row at B = 50;
    at 25 rows the eighth block holds none and adds zeros); at 2 ranks the
    pair's one block per group and the smallest apply blocks."""
    assert [tuple(bn2d.launch_plan(*s)) for s in INSURANCE_2D + INSURANCE_RANK] == [
        (8, 13, 7, 8, 1664, True), (8, 7, 4, 8, 896, True),
        (8, 7, 4, 8, 896, True), (8, 7, 4, 32, 896, True),
        (8, 4, 2, 8, 512, True), (8, 4, 2, 8, 512, True),
        (8, 4, 2, 32, 512, True)]
    rank_shapes = [(50, 12)] + INSURANCE_RANK
    assert [tuple(bn2d.moments_plan(*s)) for s in rank_shapes] == [
        (8, 1), (4, 1), (4, 1), (4, 4)]
    assert [tuple(bn2d.apply_plan(*s)) for s in rank_shapes] == [
        (4, 8, (7, 1)), (4, 8, (4, 1)), (4, 8, (4, 1)), (4, 8, (4, 4))]
    # the [25, 2] BN takes the pair's scalar path (F % 4 != 0)
    assert not bn2d.float4_ok(2, torch.zeros(25, 2))
    assert bn2d.float4_ok(12, torch.zeros(25, 12), torch.zeros(2, 12))


def test_pair_float4_flag():
    """The float4 path needs F % 4 == 0 and every tensor 16-byte aligned;
    an offset view of a buffer (the chip check's scalar path) fails it."""
    x = torch.zeros(4, 8)
    buf = torch.zeros(33)
    assert bn2d.float4_ok(8, x, torch.zeros(2, 8))
    assert not bn2d.float4_ok(8, buf[1:].view(4, 8))
    assert not bn2d.float4_ok(6, torch.zeros(4, 6))


def emulate_bn_moments(x):
    """csrc/bn_moments_apply.cu's moments in the kernel's order on the CPU
    (f32 throughout): each row-thread's sum over its rows in walk order, a
    warp's 4 row-threads folded as its shuffles fold them ((0 + 2) + (1 +
    3)), the warps' sums added in warp order, times 1/B.  (The kernel's
    x*x term is an FMA, here a rounded product.)"""
    B, F = x.shape
    rt = bn2d.moments_plan(B, F).row_threads
    xn = x.numpy()

    def thread_sums(ty):
        s, s2 = np.zeros(F, np.float32), np.zeros(F, np.float32)
        for b in moments_thread_rows(B, ty, rt):
            s, s2 = s + xn[b], s2 + xn[b] * xn[b]
        return s, s2

    threads = [thread_sums(ty) for ty in range(rt)]
    total = [np.zeros(F, np.float32), np.zeros(F, np.float32)]
    for w in range(0, rt, bn2d.WARP_ROWS):  # warp order
        t0, t1, t2, t3 = threads[w:w + bn2d.WARP_ROWS]
        for j in range(2):
            total[j] = total[j] + ((t0[j] + t2[j]) + (t1[j] + t3[j]))
    inv_n = np.float32(1.0) / np.float32(B)
    return [torch.from_numpy(t * inv_n) for t in total]


@pytest.mark.parametrize("shape", [(100, 2), (100, 1024), (5, 130), (1, 6),
                                   (300, 8), (50, 12), (25, 2), (25, 12),
                                   (25, 100)])
def test_bn_moments_partition_emulation(shape):
    """The moments kernel's summation order, emulated, gives
    bn_moments_plain's values (f32, another summation order: 1e-6 on values
    of O(1)); (300, 8) takes two rounds of loads a thread."""
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy((rng.randn(*shape) * 1.5 - 0.5).astype(np.float32))
    for a, b in zip(emulate_bn_moments(x), bn_moments_plain(x)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def emulate_bn_act_4d(x, gamma, beta, eps, act, ptr):
    """csrc/bn_act_4d.cu's arithmetic order on the CPU: each block's partial
    (sum x, sum x^2) over the units its threads visit, the cluster's K
    partials added in rank order, then each visited unit normalized and
    written back where it was read."""
    B, C, H, W = x.shape
    plan = bn4d.launch_plan(B, C, H * W, ptr)
    V = plan.vec
    hw_v, stride = H * W // V, C * H * W // V
    units = x.reshape(-1, V)  # [B*C*H*W/V, V]: a unit per row
    y = torch.empty_like(units)
    mean, var = torch.empty(C), torch.empty(C)
    inv_n = 1.0 / (B * H * W)
    for c in range(C):
        parts, offs = [], []
        for _, b, e in plan_blocks_4d(B, C, H * W, plan):
            o = torch.from_numpy(
                thread_offsets_4d(b, e, plan.threads, hw_v, stride)
                + c * hw_v)
            v = units[o]
            parts.append((v.sum(), (v * v).sum()))
            offs.append(o)
        s = s2 = torch.tensor(0.0)
        for p, p2 in parts:  # rank order
            s, s2 = s + p, s2 + p2
        mean[c] = s * inv_n
        var[c] = s2 * inv_n - mean[c] * mean[c]
        for o in offs:
            y[o] = (units[o] - mean[c]) * torch.rsqrt(var[c] + eps) \
                * gamma[c] + beta[c]
    return act_lib.get(act)(y.reshape(x.shape)), mean, var


def emulate_bn_act(x, gamma, beta, eps, act):
    """csrc/bn_act.cu's arithmetic order on the CPU: each block's column
    sums over its rows, the K blocks' sums added in rank order."""
    B, F = x.shape
    plan = bn2d.launch_plan(B, F)
    R = plan.rows_per_block
    s = torch.zeros(F)
    s2 = torch.zeros(F)
    for r in range(plan.cluster):  # rank order
        rows = x[r * R:(r + 1) * R]
        s, s2 = s + rows.sum(0), s2 + (rows * rows).sum(0)
    mean = s / B
    var = s2 / B - mean * mean
    y = (x - mean) * torch.rsqrt(var + eps) * gamma + beta
    return act_lib.get(act)(y), mean, var


@pytest.mark.parametrize("ptr", [ALIGNED, MISALIGNED])
@pytest.mark.parametrize("shape", [(3, 5, 7, 7), (2, 7, 6, 6), (1, 3, 8, 8),
                                   (16, 300, 1, 1)])
def test_bn_act_4d_partition_emulation(shape, ptr):
    """The 4-D plan's partition, summed block by block and combined in rank
    order, gives bn_act_4d_plain's values (f32, another summation order:
    1e-5 on values of O(1))."""
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy((rng.randn(*shape) * 1.5 + 0.5).astype(np.float32))
    gamma = torch.from_numpy((rng.rand(shape[1]) + 0.5).astype(np.float32))
    beta = torch.from_numpy(rng.randn(shape[1]).astype(np.float32))
    got = emulate_bn_act_4d(x, gamma, beta, 1e-5, "tanh", ptr)
    for a, b in zip(got, bn_act_4d_plain(x, gamma, beta, 1e-5, "tanh")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,act", [
    ((100, 12), "elu"), ((50, 2), "tanh"), ((50, 12), "elu"),
    ((50, 100), "elu"), ((25, 2), "tanh"), ((25, 100), "elu")])
def test_bn_act_partition_emulation_insurance(shape, act):
    """The insurance shapes' row splits (a remainder block, and at 25 rows
    an empty eighth block), summed block by block and combined in rank
    order, give bn_act_plain's values with the step's activations
    (tolerance as below)."""
    rng = np.random.RandomState(shape[0] * 3 + shape[1])
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    gamma = torch.from_numpy((rng.rand(shape[1]) + 0.5).astype(np.float32))
    beta = torch.from_numpy(rng.randn(shape[1]).astype(np.float32))
    got = emulate_bn_act(x, gamma, beta, 1e-5, act)
    for a, b in zip(got, bn_act_plain(x, gamma, beta, 1e-5, act)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(200, 2), (13, 300), (9, 33), (25, 64)])
def test_bn_act_partition_emulation(shape):
    """The 2-D plan's row split, summed block by block and combined in rank
    order, gives bn_act_plain's values (tolerance as above)."""
    rng = np.random.RandomState(shape[0] + shape[1])
    x = torch.from_numpy((rng.randn(*shape) * 1.5 + 0.5).astype(np.float32))
    gamma = torch.from_numpy((rng.rand(shape[1]) + 0.5).astype(np.float32))
    beta = torch.from_numpy(rng.randn(shape[1]).astype(np.float32))
    got = emulate_bn_act(x, gamma, beta, 1e-5, "tanh")
    for a, b in zip(got, bn_act_plain(x, gamma, beta, 1e-5, "tanh")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


# -- fused_update ------------------------------------------------------------

@pytest.mark.parametrize("l2,clip", [(0.0, None), (1e-4, None), (0.0, 1.0),
                                     (1e-4, 1.0)])
@pytest.mark.parametrize("shape", [(1152, 1024), (64, 1, 5, 5), (7,)])
def test_fused_update_matches_pallas(shape, l2, clip):
    """The RmsProp chain against the Pallas kernel in interpret mode, with
    gradients large enough to clip.  Tolerance 1e-6 relative: the same
    elementwise formula, rounding only in rsqrt."""
    rng = np.random.RandomState(len(shape))
    p = rng.randn(*shape).astype(np.float32) * 0.1
    g = rng.randn(*shape).astype(np.float32) * 2.0
    c = np.abs(rng.randn(*shape)).astype(np.float32) * 0.5
    kw = dict(lr=0.002, rho=1e-8, eps=1e-8, l2=l2, clip=clip)
    pj, cj = chain_jax(jnp.asarray(p), jnp.asarray(g), jnp.asarray(c),
                       interpret=True, **kw)
    pt, ct = kernels.fused_rmsprop_chain(torch.from_numpy(p),
                                         torch.from_numpy(g),
                                         torch.from_numpy(c), **kw)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-12)


def test_fused_update_frozen_layer_keeps_params():
    """lr 0 (a frozen layer) leaves the param bit-equal and moves the cache."""
    p = torch.randn(5, 3)
    g = torch.randn(5, 3)
    p2, c2 = kernels.fused_rmsprop_chain(p, g, torch.zeros(5, 3), lr=0.0,
                                         rho=1e-8, eps=1e-8, l2=1e-4, clip=1.0)
    assert torch.equal(p2, p)
    assert bool((c2 > 0).all())


def test_fused_update_wrapper_checks_its_inputs():
    p = torch.zeros(4)
    kw = dict(lr=0.1, rho=1e-8, eps=1e-8)
    with pytest.raises(ValueError, match="does not match"):
        kernels.fused_rmsprop_chain(p, torch.zeros(5), torch.zeros(4), **kw)
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_rmsprop_chain(p.double(), p.double(), p.double(), **kw)


# -- fused_update's multi-tensor launch plan (csrc/fused_update.cu) ----------
#
# The leaf table is computed in Python and tested here; the kernel's block
# walk over it (each block's binary search for its leaf, its chunk, its
# float4 part and its scalar rest) is emulated below.

@pytest.fixture(scope="module")
def dcgan_leaves():
    """{graph: (shapes, rates, clip)} of the three graphs the protocol step
    updates, in the order GraphUpdater.apply passes their leaves."""
    cfg = MT.CVConfig()
    dis = MT.build_discriminator(cfg, "cpu")
    out = {}
    for name, g in (("dis", dis), ("gan", MT.build_gan(cfg, "cpu")),
                    ("classifier", MT.build_classifier(dis, cfg))):
        keys = [(layer, n) for layer, lp in g.params.items() for n in lp]
        out[name] = ([tuple(g.params[layer][n].shape) for layer, n in keys],
                     [g.updater.rates(layer, n) for layer, n in keys],
                     g.updater.clip_threshold)
    return out


@pytest.fixture(scope="module")
def insurance_leaves():
    """The same for the insurance step's three graph updates."""
    dis = MI.build_discriminator(device="cpu")
    out = {}
    for name, g in (("dis", dis), ("gan", MI.build_gan(device="cpu")),
                    ("classifier", MI.build_classifier(dis))):
        keys = [(layer, n) for layer, lp in g.params.items() for n in lp]
        out[name] = ([tuple(g.params[layer][n].shape) for layer, n in keys],
                     [g.updater.rates(layer, n) for layer, n in keys],
                     g.updater.clip_threshold)
    return out


RATES = [fu.Rates(0.002, 1e-8, 1e-8, 1e-4), fu.Rates(0.004, 1e-8, 1e-8),
         fu.Rates(0.0, 1e-8, 1e-8, 1e-4)]
ODD_SIZES = [1, 2, 3, 25, 1600, 0, 4097, 8192, 7]
LONG_SIZES = [(i * 37) % 300 + 1 for i in range(100)] + [5000]


def kernel_leaf(first_blocks, b):
    """csrc/fused_update.cu's binary search: the last leaf whose first
    block is <= b."""
    lo, hi = 0, len(first_blocks) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first_blocks[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


def block_walk(launch, vec):
    """[(leaf in the launch, begin, vec_end, end)] for every block of the
    launch, as the kernel computes them: [begin, vec_end) in float4s,
    [vec_end, end) scalar."""
    out = []
    for b in range(launch.grid):
        i = kernel_leaf(launch.first_blocks, b)
        begin = (b - launch.first_blocks[i]) * fu.CHUNK
        end = min(begin + fu.CHUNK, launch.sizes[i])
        vec_end = begin + ((end - begin) & ~3) if vec[launch.start + i] else begin
        out.append((i, begin, vec_end, end))
    return out


def check_plan(sizes, plan):
    """Every element of every leaf visited exactly once, leaves in order
    over the launches, outputs 16-byte aligned and disjoint, at most
    MAX_LEAVES leaves a launch."""
    assert len(plan.launches) == max(1, -(-len(sizes) // fu.MAX_LEAVES))
    assert len(plan.vec) == len(sizes)
    start = 0
    for launch in plan.launches:
        k = len(launch.sizes)
        assert launch.start == start and 1 <= k <= fu.MAX_LEAVES
        assert launch.sizes == tuple(sizes[start:start + k])
        start += k
        assert launch.first_blocks[0] == 0 and len(launch.first_blocks) == k + 1
        ends = [0]
        for n, off in zip(launch.sizes, launch.offsets):
            assert off % fu.ALIGN == 0 and off >= ends[-1]
            ends.append(off + n)
        assert launch.total >= ends[-1] and launch.total % fu.ALIGN == 0
        count = [np.zeros(n, dtype=np.int64) for n in launch.sizes]
        for i, begin, vec_end, end in block_walk(launch, plan.vec):
            assert begin < end and (vec_end - begin) % 4 == 0
            assert end - vec_end < 4 or vec_end == begin
            count[i][begin:end] += 1
        assert all((c == 1).all() for c in count)
    assert start == len(sizes)


@pytest.mark.parametrize("graph,leaves", [("dis", 12), ("gan", 28),
                                          ("classifier", 16)])
def test_fused_update_plan_dcgan(dcgan_leaves, graph, leaves):
    """The protocol step's three graph updates: one launch each, over all
    of the graph's leaves, with the leaves' own rates and the graph's
    clip; 16-byte-aligned inputs take float4s everywhere."""
    shapes, rates, clip = dcgan_leaves[graph]
    sizes = [int(np.prod(s)) for s in shapes]
    plan = fu.launch_plan(sizes, [256] * len(sizes), rates, clip)
    assert len(sizes) == leaves and len(plan.launches) == 1
    assert plan.launches[0].rates == tuple(rates)
    assert plan.launches[0].clip == clip == 1.0
    assert all(plan.vec)
    check_plan(sizes, plan)


@pytest.mark.parametrize("graph,leaves,elements", [
    ("dis", 8, 1449), ("gan", 20, 23169), ("classifier", 12, 1849)])
def test_fused_update_plan_insurance(insurance_leaves, graph, leaves,
                                     elements):
    """The insurance step's three updates over tables of tiny leaves (BNs
    of 2 and 12 features, a 100x1 and a 12x100 dense): one launch each,
    the leaves' own rates (the gan's frozen tail at lr 0), every element
    once."""
    shapes, rates, clip = insurance_leaves[graph]
    sizes = [int(np.prod(s)) for s in shapes]
    assert len(sizes) == leaves and sum(sizes) == elements
    for ptr in (256, 260):
        plan = fu.launch_plan(sizes, [ptr] * len(sizes), rates, clip)
        assert len(plan.launches) == 1 and clip == 1.0
        assert plan.launches[0].rates == tuple(rates)
        assert plan.vec == (ptr == 256,) * len(sizes)
        check_plan(sizes, plan)


@pytest.mark.parametrize("graph", ["dis", "gan", "classifier"])
def test_fused_update_block_walk_emulation_insurance(insurance_leaves, graph):
    """The kernel's block walk over each insurance leaf table, float4 and
    scalar leaves mixed, gives the plain chain's bits leaf by leaf."""
    shapes, rates, clip = insurance_leaves[graph]
    rng = np.random.RandomState(4)
    ps, gs, cs = ([torch.from_numpy((f(rng, s) * k).astype(np.float32))
                   for s in shapes]
                  for f, k in ((lambda r, s: r.randn(*s), 0.05),
                               (lambda r, s: r.randn(*s), 0.02),
                               (lambda r, s: np.abs(r.randn(*s)), 1e-3)))
    got = emulate_fused_update(ps, gs, cs, rates, clip, lambda i: i % 2 == 0)
    for j, (p, g, c, r) in enumerate(zip(ps, gs, cs, rates)):
        want = rmsprop_chain_plain(p, g, c, lr=r.lr, rho=r.rho, eps=r.eps,
                                   l2=r.l2, clip=clip)
        assert torch.equal(got[0][j], want[0]) and torch.equal(got[1][j], want[1])


@pytest.mark.parametrize("sizes", [ODD_SIZES, LONG_SIZES, [5]],
                         ids=["odd", "long", "one"])
@pytest.mark.parametrize("ptr", [256, 260, 258])
def test_fused_update_plan(sizes, ptr):
    """Odd sizes (1, 2, 3, 25, 1,600, an empty leaf, chunk edges), a list
    longer than the leaf cap and a single leaf, with aligned and unaligned
    pointers."""
    rates = [RATES[i % 3] for i in range(len(sizes))]
    plan = fu.launch_plan(sizes, [ptr] * len(sizes), rates, 1.0)
    assert plan.vec == (ptr % 16 == 0,) * len(sizes)
    check_plan(sizes, plan)


def test_fused_update_plan_vector_flag():
    """vec follows the or-ed input pointers' 16-byte alignment, leaf by
    leaf; the cached part of the plan does not depend on the pointers."""
    sizes, rates = [8, 8, 8, 8, 8], [RATES[0]] * 5
    ptrs = [0x1000, 0x1004, 0x1000 | 0x2008, 0x7f0, 0x1000 | 0x1001]
    plan = fu.launch_plan(sizes, ptrs, rates, None)
    assert plan.vec == (True, False, False, True, False)
    assert plan.launches is fu.launch_plan(sizes, [0] * 5, rates, None).launches


def test_fused_update_table_matches_the_plan():
    """The ctypes table a launch copies: csrc/fused_update.cu's Table
    (3,152 bytes with 48 leaves, inside the 4 KB parameter limit), with
    the plan's sizes, offsets, blocks, rates (1 - rho from the host) and
    clip, and no pointer filled in."""
    assert ctypes.sizeof(fu._Table) == 3152 <= 4096
    sizes, rates = ODD_SIZES, [RATES[i % 3] for i in range(len(ODD_SIZES))]
    (launch,) = fu.launch_plan(sizes, [0] * len(sizes), rates, 0.5).launches
    t, k = launch.table, len(sizes)
    assert list(t.n[:k]) == sizes and list(t.offset[:k]) == list(launch.offsets)
    assert list(t.first_block[:k + 1]) == list(launch.first_blocks)
    f32 = np.float32
    for i, r in enumerate(rates):
        assert (t.lr[i], t.rho[i], t.eps[i], t.l2[i]) == tuple(
            float(f32(v)) for v in (r.lr, r.rho, r.eps, r.l2))
        assert t.one_minus_rho[i] == float(f32(1.0 - r.rho))
    assert (t.clip, t.has_clip, t.n_leaves) == (0.5, 1, k)
    assert not any(t.p) and not any(t.vec) and t.p_out is None
    (unclipped,) = fu.launch_plan(sizes, [0] * k, rates, None).launches
    assert unclipped.table.has_clip == 0


def leaf_inputs(sizes, seed):
    rng = np.random.RandomState(seed)
    shapes = [(n,) if n % 5 else (5, n // 5) for n in sizes]
    return ([torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1)
             for s in shapes],
            [torch.from_numpy(rng.randn(*s).astype(np.float32) * 2.0)
             for s in shapes],
            [torch.from_numpy(np.abs(rng.randn(*s)).astype(np.float32) * 0.5)
             for s in shapes])


def emulate_fused_update(ps, gs, cs, rates, clip, vec_of):
    """csrc/fused_update.cu on the CPU: the plan's launches, each block's
    float4 part and scalar rest through the plain chain, written at the
    leaf's offset of two flat buffers (NaN elsewhere), then the wrapper's
    views of them."""
    sizes = [p.numel() for p in ps]
    plan = fu.launch_plan(sizes, [0 if vec_of(i) else 4 for i in range(len(ps))],
                          rates, clip)
    p_new, c_new = [], []
    for launch in plan.launches:
        p_out = torch.full((launch.total,), float("nan"))
        c_out = torch.full((launch.total,), float("nan"))
        for i, begin, vec_end, end in block_walk(launch, plan.vec):
            j, off, r = launch.start + i, launch.offsets[i], launch.rates[i]
            for a, z in ((begin, vec_end), (vec_end, end)):
                p2, c2 = rmsprop_chain_plain(
                    ps[j].reshape(-1)[a:z], gs[j].reshape(-1)[a:z],
                    cs[j].reshape(-1)[a:z], lr=r.lr, rho=r.rho, eps=r.eps,
                    l2=r.l2, clip=clip)
                p_out[off + a:off + z] = p2
                c_out[off + a:off + z] = c2
        for j, off in zip(range(launch.start, launch.start + len(launch.sizes)),
                          launch.offsets):
            p_new.append(p_out.as_strided(ps[j].shape, ps[j].stride(), off))
            c_new.append(c_out.as_strided(ps[j].shape, ps[j].stride(), off))
    return p_new, c_new


@pytest.mark.parametrize("sizes", [ODD_SIZES, LONG_SIZES], ids=["odd", "long"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_fused_update_block_walk_emulation(sizes, clip):
    """The block walk over the plan, with every other leaf unaligned
    (scalar path), gives the plain chain's bits on every leaf."""
    ps, gs, cs = leaf_inputs(sizes, len(sizes))
    rates = [RATES[i % 3] for i in range(len(sizes))]
    got = emulate_fused_update(ps, gs, cs, rates, clip, lambda i: i % 2 == 0)
    for j, (p, g, c, r) in enumerate(zip(ps, gs, cs, rates)):
        want = rmsprop_chain_plain(p, g, c, lr=r.lr, rho=r.rho, eps=r.eps,
                                   l2=r.l2, clip=clip)
        assert torch.equal(got[0][j], want[0]) and torch.equal(got[1][j], want[1])


def test_fused_update_block_walk_emulation_dcgan(dcgan_leaves):
    """The same over the discriminator update's 12 real leaves (1.39M
    elements, 345 blocks), all aligned."""
    shapes, rates, clip = dcgan_leaves["dis"]
    rng = np.random.RandomState(3)
    ps, gs, cs = ([torch.from_numpy((f(rng, s) * k).astype(np.float32))
                   for s in shapes]
                  for f, k in ((lambda r, s: r.randn(*s), 0.05),
                               (lambda r, s: r.randn(*s), 0.02),
                               (lambda r, s: np.abs(r.randn(*s)), 1e-3)))
    got = emulate_fused_update(ps, gs, cs, rates, clip, lambda i: True)
    for j, (p, g, c, r) in enumerate(zip(ps, gs, cs, rates)):
        want = rmsprop_chain_plain(p, g, c, lr=r.lr, rho=r.rho, eps=r.eps,
                                   l2=r.l2, clip=clip)
        assert torch.equal(got[0][j], want[0]) and torch.equal(got[1][j], want[1])


def test_fused_update_multi_leaf_matches_plain_and_pallas():
    """The multi-leaf wrapper on CPU tensors: bit-equal to the plain chain
    leaf by leaf, and within the single-leaf test's 1e-6 of the Pallas
    kernel in interpret mode, each leaf with its own rates (a frozen lr-0
    leaf among them, its params bit-equal)."""
    sizes = [1600, 7, 3, 130, 165]
    ps, gs, cs = leaf_inputs(sizes, 11)
    rates = [RATES[i % 3] for i in range(len(sizes))]
    new_p, new_c = kernels.fused_rmsprop_chains(ps, gs, cs, rates, clip=1.0)
    assert [t.shape for t in new_p] == [t.shape for t in new_c] == [
        p.shape for p in ps]
    for p, g, c, r, p2, c2 in zip(ps, gs, cs, rates, new_p, new_c):
        kw = dict(lr=r.lr, rho=r.rho, eps=r.eps, l2=r.l2, clip=1.0)
        want = rmsprop_chain_plain(p, g, c, **kw)
        assert torch.equal(p2, want[0]) and torch.equal(c2, want[1])
        pj, cj = chain_jax(jnp.asarray(p.numpy()), jnp.asarray(g.numpy()),
                           jnp.asarray(c.numpy()), interpret=True, **kw)
        np.testing.assert_allclose(p2.numpy(), np.asarray(pj), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(c2.numpy(), np.asarray(cj), rtol=1e-6,
                                   atol=1e-12)
    assert torch.equal(new_p[2], ps[2])  # RATES[2] is frozen (lr 0)
    assert kernels.fused_rmsprop_chains([], [], [], [], clip=1.0) == ([], [])


def test_fused_update_multi_leaf_wrapper_checks_its_inputs():
    p, r = torch.zeros(4), fu.Rates(0.1, 1e-8, 1e-8)
    ok = ([p, torch.zeros(2, 3)], [p, torch.zeros(2, 3)],
          [p, torch.zeros(2, 3)], [r, r])
    with pytest.raises(ValueError, match="does not match"):
        kernels.fused_rmsprop_chains(ok[0], [p, torch.zeros(3, 2)], *ok[2:])
    with pytest.raises(ValueError, match="does not match"):
        kernels.fused_rmsprop_chains(ok[0], ok[1], [p, torch.zeros(6)], ok[3])
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_rmsprop_chains(ok[0], [p, torch.zeros(2, 3).double()],
                                     *ok[2:])
    with pytest.raises(ValueError, match="does not match leaf 0"):
        kernels.fused_rmsprop_chains([p, torch.zeros(2, 3, device="meta")],
                                     *ok[1:])
    with pytest.raises(ValueError, match="does not match leaf 0"):
        kernels.fused_rmsprop_chains(*ok[:2], [p, torch.zeros(2, 3, device="meta")],
                                     ok[3])
    with pytest.raises(ValueError, match="2 params, 2 gradients, 2 caches, 1"):
        kernels.fused_rmsprop_chains(*ok[:3], [r])
    meta = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_rmsprop_chains(meta, meta, meta, [r])


def test_graph_updater_makes_one_call_per_update(monkeypatch):
    """GraphUpdater.apply passes every leaf with a gradient to one
    fused_rmsprop_chains call, with its layer's rates (l2 on W only, lr 0
    for a frozen layer) and the graph's clip; params without a gradient
    pass through as the same tensors, and both trees keep their
    structure."""
    calls = []

    def spy(ps, gs, cs, rates, *, clip):
        calls.append((len(ps), list(rates), clip))
        return fu.fused_rmsprop_chains(ps, gs, cs, rates, clip=clip)

    monkeypatch.setattr(updater_mod, "fused_rmsprop_chains", spy)
    up = updater_mod.GraphUpdater(
        {"dense": updater_mod.RmsProp(0.002, 1e-8, 1e-8)}, l2=1e-4,
        clip_threshold=1.0)
    params = {"dense": {"W": torch.randn(3, 2), "b": torch.randn(2)},
              "frozen": {"W": torch.randn(2, 2)}, "pool": {}}
    cache = up.init(params)
    grads = {"dense": {"W": torch.randn(3, 2)}, "frozen": {"W": torch.randn(2, 2)}}
    new_p, new_c = up.apply(params, grads, cache)
    assert calls == [(2, [fu.Rates(0.002, 1e-8, 1e-8, 1e-4),
                          fu.Rates(0.0, 1e-8, 1e-8, 1e-4)], 1.0)]
    assert {k: set(v) for k, v in new_p.items()} == {
        k: set(v) for k, v in params.items()} == {k: set(v) for k, v in new_c.items()}
    assert new_p["dense"]["b"] is params["dense"]["b"]
    assert new_c["dense"]["b"] is cache["dense"]["b"]
    assert torch.equal(new_p["frozen"]["W"], params["frozen"]["W"])
    assert not torch.equal(new_p["dense"]["W"], params["dense"]["W"])


# -- upsample_bwd ------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (2, 3, 8, 12),     # small
    (4, 128, 14, 14),  # the generator's first upsample cotangent
    (4, 64, 28, 28),   # the generator's second upsample cotangent
])
def test_upsample_bwd_matches_pallas(shape):
    """The (2, 2) block sum against the DMA-pipeline kernel in interpret
    mode.  Tolerance 1e-6: four f32 adds per output."""
    g = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    dj = upsample_bwd_dma(jnp.asarray(g), 2, 2, interpret=True)
    dt = kernels.upsample_bwd(torch.from_numpy(g), 2, 2)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)


def test_upsample_bwd_plain_is_the_block_sum():
    g = torch.randn(3, 2, 6, 9)
    ref = g.view(3, 2, 2, 3, 3, 3).sum((3, 5))
    torch.testing.assert_close(upsample_bwd_plain(g, 3, 3), ref)
    with pytest.raises(ValueError, match="cotangent"):
        kernels.upsample_bwd(torch.zeros(1, 1, 5, 4), 2, 2)


# -- routing -----------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    """Each wrapper on CPU tensors returns exactly its plain version's
    result (and, by the autouse fixture, launches nothing)."""
    x, gm, bt = torch.randn(6, 5), torch.rand(5) + 0.5, torch.randn(5)
    for a, b in zip(kernels.fused_bn_act_train(x, gm, bt, 1e-5, "tanh"),
                    bn_act_plain(x, gm, bt, 1e-5, "tanh")):
        assert torch.equal(a, b)
    p, g, c = torch.randn(9), torch.randn(9), torch.rand(9)
    kw = dict(lr=0.004, rho=1e-8, eps=1e-8, l2=1e-4, clip=1.0)
    for a, b in zip(kernels.fused_rmsprop_chain(p, g, c, **kw),
                    rmsprop_chain_plain(p, g, c, **kw)):
        assert torch.equal(a, b)
    up = torch.randn(2, 2, 4, 4)
    assert torch.equal(kernels.upsample_bwd(up, 2, 2),
                       upsample_bwd_plain(up, 2, 2))
    for a, b in zip(kernels.bn_moments(x), bn_moments_plain(x)):
        assert torch.equal(a, b)
    mean, var = torch.randn(5), torch.rand(5)
    assert torch.equal(kernels.bn_apply(x, mean, var, gm, bt, 1e-5, "tanh"),
                       bn_apply_plain(x, mean, var, gm, bt, 1e-5, "tanh"))
    x4 = torch.randn(3, 5, 2, 2)
    for a, b in zip(kernels.fused_bn_act_train_4d(x4, gm, bt, 1e-5, "tanh"),
                    bn_act_4d_plain(x4, gm, bt, 1e-5, "tanh")):
        assert torch.equal(a, b)
