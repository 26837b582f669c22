"""Train-mode BatchNorm + activation over [B, F]: single device, and the
data-parallel (sync-BN) pair.

Replaces ``fused_bn_act_train`` of ``gan_deeplearning4j_tpu/ops/pallas/
bn_act.py``: ``_fused_kernel`` (the ``axis_name=None`` path, CUDA source
``csrc/bn_act.cu``) and ``_moments_kernel`` + ``_apply_kernel`` (the SPMD
path, ``csrc/bn_moments_apply.cu``).

    mean = E[x], var = E[x^2] - mean^2        (biased, per feature)
    y    = act((x - mean) * rsqrt(var + eps) * gamma + beta)

Returns (y, mean, var).  With a group of more than one rank the moments
are the global batch's: the moments kernel gives this rank's E[x], E[x^2]
as one [2, F] buffer, one in-place all-reduce sums it over the ranks, and
the apply kernel takes the sums, finishes the moments (divide by the
world, var = m2 - mean^2) and normalizes — the TPU path's moments kernel,
``pmean``, apply kernel, with no launch between them but the collective.

Bound on the card: device memory.  Single device: x read once and y
written once (8 bytes per element); on the protocol step that is the
generator's [200, 6272] BN (10.0 MB, 3.0 us at 3.35 TB/s), the
classifier's [200, 1024] and the generator's [200, 2] input BN.  The
kernel is one launch that reads x once: each 32-column feature group is
split over the rows of a thread-block cluster, kept in shared memory,
reduced across the cluster through distributed shared memory, and written
from there (``launch_plan`` sets the split; ``csrc/bn_act.cu``).  The
pair: moments read x once (4 bytes per element), apply reads x and writes
y (8 bytes per element), at the per-rank shapes [B/n, F]; a thread of
either owns 4 neighbouring columns (float4) of a 32-column group, the
moments give a group one block (``moments_plan``), and the apply grid is
row chunks x column groups (``apply_plan``; ``csrc/bn_moments_apply.cu``).

The tenant-batched form (``fused_bn_act_train_tenants``, the fleet's: x
[N, B, F], each tenant's moments over its own B rows; what ``jax.vmap`` of
``fused_bn_act_train`` computes, the Pallas batching rule making the tenant
axis a grid axis of ``_fused_kernel``) is a second kernel of
``csrc/bn_act.cu``, and its backward a third.  Both are bound by bytes
(the forward reads x and writes y, the backward reads x and gy and writes
dx) and move a few MB a launch at the fleet's widths (B 16-32 rows, F
2-100 columns a tenant), so they are built to keep copies in flight and
lanes busy: a persistent grid walks stages of T whole tenants, each
stage's contiguous slab brought into shared memory by one bulk copy (TMA)
on an mbarrier with the next stage's copy in flight, each (tenant, column)
pair owned by R neighbouring threads of a warp (R > 1 splits the rows
where the launch moves little and its time is each thread's chain of
work), T chosen so that the pairs fill whole warps, and the result
leaving by one bulk store (``tenant_plan``).  Each column's moments are
summed in the order of the plain reference on the CPU, every step rounded
as its torch op rounds, so that they are its bits.  The cluster plan above
does not carry over: at the fleet's shapes there are no rows to split
across blocks.

The [B, F] kernels and the pair have no backward kernel, as the TPU paths
have none: their backward recomputes through the plain composition under
autograd (with the differentiable all-reduce on the pair's path), as the
JAX ``custom_vjp`` does with its ``pmean``.  The tenant form's backward is
the kernel ``bn_act_tenants_bwd`` (closed form, ``bn_act_tenants_bwd_plain``
beside it): under ``vmap`` on the TPU XLA fuses that recompute into a few
fusions, on the card it was some forty launches a BN.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gan_deeplearning4j_tpu_torch.ops import activations as act_lib
from gan_deeplearning4j_tpu_torch.ops.cuda import build
from gan_deeplearning4j_tpu_torch.parallel import mesh

# the kernels' compile-time activation set (csrc/bn_common.cuh enum Act)
ACT_CODES = {"identity": 0, "tanh": 1, "sigmoid": 2, "relu": 3, "elu": 4,
             "leakyrelu": 5}

_ARGTYPES = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int] + [
    ctypes.c_int] * 5 + [ctypes.c_void_p]
_MOMENTS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_APPLY_ARGTYPES = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_APPLY_SUMS_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_TENANTS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_TENANTS_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
    ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# what csrc/bn_cluster.cuh lets a plan ask for: clusters of at most 8
# blocks (the portable size), and the H100's 232,448 bytes of shared memory
# a block can use less 8 KB kept for the kernels' static arrays
# (kMaxCluster, kMaxDynamicSmem)
MAX_CLUSTER = 8
SMEM_PER_BLOCK = 232_448
MAX_DYNAMIC_SMEM = SMEM_PER_BLOCK - 8_192
# a block's share that lets three blocks (and their loads in flight) share
# an SM's 228 KB
TARGET_SMEM = 72 * 1024
SMS = 132  # the H100 SXM's; the wrappers pass their card's own count
GROUP = 32  # columns of a feature group: 128 bytes of a row, one warp
MAX_ROW_THREADS = 16  # csrc/bn_act.cu kMaxRowThreads
# the sync-BN pair (csrc/bn_moments_apply.cu): 8 lanes of 4 neighbouring
# columns make a 32-column group (kGroupCols), a warp holds 4 row-threads
# (kWarpRows), a block at most 32 (kMaxRowThreads); a moments thread keeps
# 8 loads in flight (kMomentsUnroll), an apply thread 2 (kApplyRows)
PAIR_GROUP = 32
WARP_ROWS = 4
PAIR_MAX_ROW_THREADS = 32
MOMENTS_UNROLL = 8
APPLY_ROWS = 2


class Plan(NamedTuple):
    """How ``csrc/bn_act.cu`` splits a [B, F] input (see launch_plan)."""

    cluster: int  # K blocks per feature group
    rows_per_block: int  # block rank r owns rows [r*R, (r+1)*R) of B
    row_threads: int  # a block is 32 column lanes x this many row-threads
    grid: int  # groups * K blocks
    smem_bytes: int  # dynamic shared memory: the [R, 32] tile, 0 if streamed
    resident: bool  # False: the streamed branch reads x twice


def cluster_size(groups: int, units: int, bytes_for, sms: int) -> int:
    """K for ``groups`` independent reductions of ``units`` indivisible
    pieces each: the smallest power of two that gives the grid one block
    per SM, then larger while a block's share (``bytes_for(K)``) is more
    than TARGET_SMEM; at most MAX_CLUSTER and at most ``units``."""
    k = 1
    while k < MAX_CLUSTER and groups * k < sms and 2 * k <= units:
        k *= 2
    while (bytes_for(k) > TARGET_SMEM and k < MAX_CLUSTER
           and 2 * k <= units):
        k *= 2
    return k


def launch_plan(B: int, F: int, sms: int = SMS) -> Plan:
    """The single-device kernel's split of x [B, F]: a cluster of K blocks
    per 32-column group, each block a contiguous run of ceil(B/K) rows kept
    in shared memory (or streamed when that does not fit)."""
    groups = -(-F // GROUP)
    k = cluster_size(groups, B, lambda k: -(-B // k) * GROUP * 4, sms)
    rows = -(-B // k)
    smem = rows * GROUP * 4
    resident = smem <= MAX_DYNAMIC_SMEM
    return Plan(cluster=k, rows_per_block=rows,
                row_threads=min(MAX_ROW_THREADS, -(-rows // 2)),
                grid=groups * k, smem_bytes=smem if resident else 0,
                resident=resident)


class TenantPlan(NamedTuple):
    """How ``csrc/bn_act.cu``'s tenant kernels split x [N, B, F]."""

    per_stage: int  # T whole tenants a stage: one [T, B, F] slab an input
    split: int  # R neighbouring threads a (tenant, column) pair, B/R rows each
    threads: int  # T*F pairs x R, in whole warps
    ring: int  # stages in flight a block (1 or 2)
    stages: int  # ceil(N / T)
    grid: int  # persistent blocks: the stages, at most blocks_per_sm an SM
    blocks_per_sm: int  # by threads and shared memory
    smem_bytes: int  # ring x slabs x the slab buffer (T*B*F + a head of 3)


# csrc/bn_act.cu kTenantMaxThreads, kTenantMaxRing and kTenantMaxSplit; an
# H100 SM holds 2,048 threads and 228 KB of shared memory (1 KB of it kept
# by the system a block)
TENANT_MAX_THREADS = 512
TENANT_MAX_RING = 2
TENANT_MAX_SPLIT = 4
THREADS_PER_SM = 2048
SMEM_PER_SM = 233_472
# rows a thread of a pair walks (B / R), and stages a plan aims at for each
# SM: more, smaller stages balance the SMs and let one block's copies run
# under another's work
TENANT_ROWS_A_THREAD = 4
TENANT_STAGES_PER_SM = 2
# x bytes an SM up to which a launch splits its rows fully, and in two
# (tenant_split): on the H100 the full split won at 12 KB an SM, lost at
# 24 KB; a split in two won at 24-48 KB for [16-32, 12]
TENANT_SPLIT_BYTES = 16 * 1024
TENANT_PAIR_SPLIT_BYTES = 64 * 1024


def tenant_buffer_floats(per_stage: int, B: int, F: int) -> int:
    """Floats of one slab's shared buffer: T*B*F and a head of up to 3
    that keeps the array's alignment, rounded to 16 bytes (bn_act.cu
    tenant_dims)."""
    return -(-(per_stage * B * F + 3) // 4) * 4


def tenant_split(N: int, B: int, F: int, sms: int = SMS) -> int:
    """R, the threads that share a pair: a power of two that leaves each at
    least TENANT_ROWS_A_THREAD of the B rows, at most TENANT_MAX_SPLIT
    where the launch moves little (x up to TENANT_SPLIT_BYTES an SM: its
    time is each thread's chain of dependent work, B rows walked twice),
    at most 2 up to TENANT_PAIR_SPLIT_BYTES, else 1 (the SMs' threads are
    busy anyway, and fewer threads a byte keep more bytes in flight).  1
    for rows of 32 columns or more: their first 32 * (F // 32) columns sum
    their rows in order, as the reference does (csrc/bn_act.cu
    OrderedSum), which one thread must do.  The bands are the H100's,
    measured at the fleet's shapes (PERF.md, chip_fleet_ab.py)."""
    x_per_sm = 4 * N * B * F / sms
    if F >= GROUP:
        return 1
    if x_per_sm <= TENANT_SPLIT_BYTES:
        most = TENANT_MAX_SPLIT
    elif x_per_sm <= TENANT_PAIR_SPLIT_BYTES:
        most = 2
    else:
        return 1
    r = 1
    while 2 * r <= min(most, B // TENANT_ROWS_A_THREAD):
        r *= 2
    return r


def tenant_plan(N: int, B: int, F: int, sms: int = SMS,
                slabs: int = 1) -> TenantPlan:
    """The tenant kernels' split of x [N, B, F] with ``slabs`` inputs staged
    (1: the forward's x; 2: the backward's x and gy).

    Each (tenant, column) pair is R = tenant_split(N, B, F) neighbouring
    threads of one warp.  T tenants a stage: enough to fill a warp and about
    TENANT_STAGES_PER_SM stages an SM (ceil(N / (2 sms))), at most one
    pair a group of R threads (TENANT_MAX_THREADS / (F R)) and what shared
    memory holds (two buffers a slab where they fit); then rounded down to
    whole warps (a multiple of 32 / gcd(F R, 32)) and to a slab that ends
    on 16 bytes (4 / gcd(B F, 4)), where T is that large.  A ring of two
    stages where a block walks more than one and two still leave an SM two
    blocks; the grid is the stages or blocks_per_sm x sms, whichever is
    fewer.  Raises ValueError when one tenant's slabs do not fit in
    MAX_DYNAMIC_SMEM (the fleet's largest, [16, 100], takes 6.4 KB)."""
    elems = B * F
    split = tenant_split(N, B, F, sms)
    lanes = F * split  # threads a tenant

    def smem(per: int, ring: int) -> int:
        return 4 * ring * slabs * tenant_buffer_floats(per, B, F)

    def fit(ring: int) -> int:
        floats = MAX_DYNAMIC_SMEM // (4 * ring * slabs) // 4 * 4
        return (floats - 3) // elems

    if fit(1) < 1:
        raise ValueError(f"bn_act over tenants: one tenant's [{B}, {F}] "
                         f"({slabs} slab{'s' * (slabs > 1)}) does not fit "
                         "one block's shared memory")
    room = fit(TENANT_MAX_RING) if fit(TENANT_MAX_RING) >= 1 else fit(1)
    want = max(-(-GROUP // lanes), -(-N // (TENANT_STAGES_PER_SM * sms)))
    per = max(1, min(max(1, TENANT_MAX_THREADS // lanes), room, want, N))
    for q in (GROUP // math.gcd(lanes, GROUP), 4 // math.gcd(elems, 4)):
        if per >= q:
            per -= per % q
    threads = min(TENANT_MAX_THREADS, -(-per * lanes // 32) * 32)
    stages = -(-N // per)

    def grid(ring: int) -> Tuple[int, int]:
        per_sm = max(1, min(THREADS_PER_SM // threads,
                            SMEM_PER_SM // (smem(per, ring) + 1024), 32))
        return per_sm, min(stages, per_sm * sms)

    ring = TENANT_MAX_RING
    if (smem(per, ring) > MAX_DYNAMIC_SMEM or stages <= grid(1)[1]
            or grid(ring)[0] < 2):
        ring = 1
    per_sm, g = grid(ring)
    return TenantPlan(per_stage=per, split=split, threads=threads, ring=ring,
                      stages=stages, grid=g, blocks_per_sm=per_sm,
                      smem_bytes=smem(per, ring))


class MomentsPlan(NamedTuple):
    """How ``csrc/bn_moments_apply.cu``'s moments kernel splits [B, F]."""

    row_threads: int  # a block is 8 lanes x this many row-threads
    grid: int  # one block per 32-column group


def moments_plan(B: int, F: int) -> MomentsPlan:
    """The moments kernel's split of x [B, F]: one block per 32-column
    group, with the fewest row-threads (whole warps of 4, at most 32) that
    give each thread one round of at most MOMENTS_UNROLL loads; a taller
    input (B > 32 x 8) takes more rounds."""
    warps = max(1, -(-B // (MOMENTS_UNROLL * WARP_ROWS)))
    return MomentsPlan(row_threads=min(PAIR_MAX_ROW_THREADS, WARP_ROWS * warps),
                       grid=-(-F // PAIR_GROUP))


class ApplyPlan(NamedTuple):
    """How ``csrc/bn_moments_apply.cu``'s apply kernel splits [B, F]."""

    row_threads: int  # a block is 8 lanes x this many row-threads
    rows_per_block: int  # the block's chunk of rows; thread t takes t, t+RT..
    grid: Tuple[int, int]  # (row chunks, column groups)


def apply_plan(B: int, F: int, sms: int = SMS) -> ApplyPlan:
    """The apply kernel's split of x [B, F]: one block per (chunk of
    row_threads * APPLY_ROWS rows, 32-column group), so each thread has
    APPLY_ROWS rows in flight; row_threads the largest power of two from
    PAIR_MAX_ROW_THREADS down to WARP_ROWS that still gives the grid one
    block per SM."""
    groups = -(-F // PAIR_GROUP)
    rt = PAIR_MAX_ROW_THREADS
    while rt > WARP_ROWS and groups * -(-B // (rt * APPLY_ROWS)) < sms:
        rt //= 2
    rows = rt * APPLY_ROWS
    return ApplyPlan(row_threads=rt, rows_per_block=rows,
                     grid=(-(-B // rows), groups))


def float4_ok(cols: int, *tensors: torch.Tensor) -> bool:
    """The pair kernels' float4 path: every row of every tensor starts on a
    16-byte boundary."""
    return cols % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- plain versions ------------------------------------------------------------

def bn_moments_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) per feature (bn_act.py ``_moments_kernel``)."""
    return torch.mean(x, dim=0), torch.mean(torch.square(x), dim=0)


def bn_apply_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                   gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                   act_name: str) -> torch.Tensor:
    """Normalize by given moments, scale, shift, activate (bn_act.py
    ``_apply_kernel``)."""
    y = (x - mean[None]) * torch.rsqrt(var[None] + eps)
    y = y * gamma[None] + beta[None]
    return act_lib.get(act_name)(y)


def bn_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float, act_name: str,
                 group: Optional[mesh.DataGroup] = None) -> Triple:
    """The reference composition (bn_act.py ``_reference``) in torch ops;
    with a group, the moments' mean over its ranks sits between the two
    halves, differentiably (``_reference``'s ``pmean``)."""
    mean, m2 = bn_moments_plain(x)
    if group is not None:
        stats = mesh.all_reduce_mean_diff(torch.stack([mean, m2]), group)
        mean, m2 = stats[0], stats[1]
    var = m2 - torch.square(mean)
    return bn_apply_plain(x, mean, var, gamma, beta, eps, act_name), mean, var


def bn_act_tenants_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float, act_name: str
                         ) -> Triple:
    """``bn_act_plain`` for each tenant of x [N, B, F] with its own gamma,
    beta [N, F] -> (y [N, B, F], mean [N, F], var [N, F]): the moments over
    dim 1 (``jax.vmap`` of bn_act.py ``_reference``)."""
    mean = torch.mean(x, dim=1)
    var = torch.mean(torch.square(x), dim=1) - torch.square(mean)
    y = (x - mean[:, None]) * torch.rsqrt(var[:, None] + eps)
    y = y * gamma[:, None] + beta[:, None]
    # a tenant's bits must not depend on how many share the launch
    return act_lib.tail_stable(act_name)(y), mean, var


def act_grad_plain(z: torch.Tensor, act_name: str) -> torch.Tensor:
    """d act(z) / dz as JAX differentiates ``ops/activations.py``
    (csrc/bn_common.cuh activate_grad): tanh 1 - tanh^2, the logistic
    s(1 - s), relu 0 at 0, elu exp(z) for z <= 0, leaky relu 1 at 0."""
    if act_name == "tanh":
        return 1 - torch.square(torch.tanh(z))
    if act_name == "sigmoid":
        s = act_lib.tail_stable("sigmoid")(z)
        return s * (1 - s)
    if act_name == "relu":
        return (z > 0).to(z.dtype)
    if act_name == "elu":
        return torch.where(z > 0, torch.ones_like(z), torch.exp(z))
    if act_name == "leakyrelu":
        return torch.where(z >= 0, torch.ones_like(z),
                           torch.full_like(z, 0.01))
    if act_name == "identity":
        return torch.ones_like(z)
    raise ValueError(f"no derivative for activation {act_name!r}")


def bn_act_tenants_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, mean: torch.Tensor,
                             var: torch.Tensor, gy: torch.Tensor,
                             gmean: torch.Tensor, gvar: torch.Tensor,
                             eps: float, act_name: str) -> Triple:
    """The closed-form vector-Jacobian product of ``bn_act_tenants_plain``
    from its saved mean and var: -> (dx [N, B, F], dgamma, dbeta [N, F])
    for the cotangents gy of y and gmean, gvar of mean and var.

        dbeta = sum_b gz,  dgamma = sum_b gz * xh,  where
        xh = (x - mean) * rstd,  gz = gy * act'(gamma * xh + beta)
        dx = gamma * rstd / B * (B * gz - dbeta - xh * dgamma)
             + gmean / B + gvar * 2 (x - mean) / B

    (var = E[x^2] - mean^2 has the biased variance's derivative,
    2 (x - mean) / B.)  dx is evaluated in the order autograd of the plain
    forward takes it, through the gradients of rstd, mean and E[x^2]:
    gv = gvar - rstd^3 / 2 * sum_b gz gamma (x - mean), gm = gmean -
    sum_b gz gamma rstd - 2 mean gv, dx = gz gamma rstd + gm / B + 2 gv x /
    B.  The kernel (csrc/bn_act.cu BwdPair) does the same, so that its
    rounding follows the recompute it replaced: the B gz - dbeta - xh
    dgamma form cancels in another place, and on the card it moved the
    fleet step's first RmsProp update past its band against the CPU."""
    n = x.shape[1]
    r = torch.rsqrt(var + eps)
    c = x - mean[:, None]
    xh = c * r[:, None]
    gz = gy * act_grad_plain(xh * gamma[:, None] + beta[:, None], act_name)
    dbeta = gz.sum(dim=1)
    dgamma = (gz * xh).sum(dim=1)
    gxh = gz * gamma[:, None]
    gv = gvar + -0.5 * (gxh * c).sum(dim=1) * (r * r * r)
    gm = gmean - (gxh * r[:, None]).sum(dim=1) - 2 * mean * gv
    dx = gxh * r[:, None] + (gm / n)[:, None] + (2 * gv / n)[:, None] * x
    return dx, dgamma, dbeta


def bn_apply_sums_plain(x: torch.Tensor, sums: torch.Tensor, world: int,
                        gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                        act_name: str) -> Triple:
    """The apply step from the ranks' summed moments: ``sums`` [2, F] is the
    all-reduce sum of every rank's (E[x], E[x^2]).  Their mean over the
    ranks, var = m2 - mean^2 (the pmean and epilogue of the TPU path), then
    ``bn_apply_plain`` -> (y, mean, var)."""
    stats = sums / world
    mean = stats[0].clone()
    var = stats[1] - torch.square(stats[0])
    return bn_apply_plain(x, mean, var, gamma, beta, eps, act_name), mean, var


# -- kernels -------------------------------------------------------------------

def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x, gamma, beta, eps, act_name):
    B, F = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(F, dtype=x.dtype, device=x.device)
    var = torch.empty(F, dtype=x.dtype, device=x.device)
    plan = launch_plan(B, F, sm_count(x.device))
    fn = build.function("bn_act", "gan4j_bn_act", _ARGTYPES)
    code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
              mean.data_ptr(), var.data_ptr(), B, F, eps,
              ACT_CODES[act_name], plan.cluster, plan.rows_per_block,
              plan.row_threads, plan.smem_bytes, int(plan.resident),
              _stream(x))
    build.check(code, "fused_bn_act_train")
    fused_bn_act_train.launches += 1
    return y, mean, var


def empty_aligned_with(ref: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ref's shape whose address agrees with ref's
    modulo 16 bytes: the tenant kernels store the result from the buffer
    of that input by 16-byte-aligned bulk copies."""
    if ref.data_ptr() % 16 == 0:
        return torch.empty_like(ref)
    buf = torch.empty(ref.numel() + 3, dtype=ref.dtype, device=ref.device)
    shift = (ref.data_ptr() - buf.data_ptr()) % 16 // ref.element_size()
    return buf[shift:shift + ref.numel()].view(ref.shape)


def _tenants_launch(x, gamma, beta, eps, act_name):
    N, B, F = x.shape
    y = empty_aligned_with(x)
    mean = torch.empty((N, F), dtype=x.dtype, device=x.device)
    var = torch.empty((N, F), dtype=x.dtype, device=x.device)
    plan = tenant_plan(N, B, F, sm_count(x.device))
    fn = build.function("bn_act", "gan4j_bn_act_tenants", _TENANTS_ARGTYPES)
    code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
              mean.data_ptr(), var.data_ptr(), N, B, F, eps,
              ACT_CODES[act_name], plan.per_stage, plan.split, plan.threads,
              plan.ring, plan.grid, plan.smem_bytes, _stream(x))
    build.check(code, "fused_bn_act_train_tenants")
    fused_bn_act_train_tenants.launches += 1
    return y, mean, var


def _tenants_bwd_launch(x, gamma, beta, mean, var, gy, gmean, gvar, eps,
                        act_name, need_dx):
    N, B, F = x.shape
    dx = empty_aligned_with(gy) if need_dx else None
    dgamma = torch.empty((N, F), dtype=x.dtype, device=x.device)
    dbeta = torch.empty((N, F), dtype=x.dtype, device=x.device)
    plan = tenant_plan(N, B, F, sm_count(x.device), slabs=2)
    fn = build.function("bn_act", "gan4j_bn_act_tenants_bwd",
                        _TENANTS_BWD_ARGTYPES)
    code = fn(x.data_ptr(), gy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
              mean.data_ptr(), var.data_ptr(), gmean.data_ptr(),
              gvar.data_ptr(), None if dx is None else dx.data_ptr(),
              dgamma.data_ptr(), dbeta.data_ptr(), N, B, F, eps,
              ACT_CODES[act_name], plan.per_stage, plan.split, plan.threads,
              plan.ring, plan.grid, plan.smem_bytes, _stream(x))
    build.check(code, "bn_act_tenants_bwd")
    bn_act_tenants_bwd.launches += 1
    return dx, dgamma, dbeta


def _moments_launch(x: torch.Tensor) -> torch.Tensor:
    """-> [2, F]: row 0 E[x], row 1 E[x^2]."""
    B, F = x.shape
    stats = torch.empty((2, F), dtype=x.dtype, device=x.device)
    plan = moments_plan(B, F)
    fn = build.function("bn_moments_apply", "gan4j_bn_moments",
                        _MOMENTS_ARGTYPES)
    code = fn(x.data_ptr(), stats.data_ptr(), B, F, plan.row_threads,
              int(float4_ok(F, x, stats)), _stream(x))
    build.check(code, "bn_moments")
    bn_moments.launches += 1
    return stats


def _apply_launch(x, mean, var, gamma, beta, eps, act_name) -> torch.Tensor:
    B, F = x.shape
    y = torch.empty_like(x)
    plan = apply_plan(B, F, sm_count(x.device))
    fn = build.function("bn_moments_apply", "gan4j_bn_apply", _APPLY_ARGTYPES)
    code = fn(x.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
              beta.data_ptr(), y.data_ptr(), B, F, eps, ACT_CODES[act_name],
              plan.row_threads, plan.rows_per_block,
              int(float4_ok(F, x, mean, var, gamma, beta, y)), _stream(x))
    build.check(code, "bn_apply")
    bn_apply.launches += 1
    return y


def _apply_sums_launch(x, sums, world, gamma, beta, eps, act_name) -> Triple:
    B, F = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(F, dtype=x.dtype, device=x.device)
    var = torch.empty(F, dtype=x.dtype, device=x.device)
    plan = apply_plan(B, F, sm_count(x.device))
    fn = build.function("bn_moments_apply", "gan4j_bn_apply_sums",
                        _APPLY_SUMS_ARGTYPES)
    code = fn(x.data_ptr(), sums.data_ptr(), gamma.data_ptr(),
              beta.data_ptr(), y.data_ptr(), mean.data_ptr(), var.data_ptr(),
              B, F, world, eps, ACT_CODES[act_name], plan.row_threads,
              plan.rows_per_block,
              int(float4_ok(F, x, sums, gamma, beta, y, mean, var)),
              _stream(x))
    build.check(code, "bn_apply")
    bn_apply.launches += 1
    return y, mean, var


def recompute_grads(ctx, cotangents, plain, *args):
    """A BN kernel's backward: autograd through its plain version
    ``plain(x, gamma, beta, *args)`` from the saved (x, gamma, beta)."""
    x, gamma, beta = ctx.saved_tensors
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta)]
        return torch.autograd.grad(plain(*leaves, *args), leaves, cotangents)


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act_name):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.act_name = eps, act_name
        return _launch(x, gamma, beta, eps, act_name)

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        grads = recompute_grads(ctx, (gy, gmean, gvar), bn_act_plain, ctx.eps,
                                ctx.act_name)
        return (*grads, None, None)


class _BnActTenants(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act_name):
        y, mean, var = _tenants_launch(x, gamma, beta, eps, act_name)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.act_name = eps, act_name
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = bn_act_tenants_bwd(
            x, gamma, beta, mean, var, gy, gmean, gvar, ctx.eps,
            ctx.act_name, need_dx=ctx.needs_input_grad[0])
        return dx, dgamma, dbeta, None, None


class _BnSync(torch.autograd.Function):
    """The pair on the card: moments kernel, one in-place all-reduce sum,
    apply kernel (which finishes the moments): three device launches."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act_name, group):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.act_name, ctx.group = eps, act_name, group
        sums = mesh.all_reduce_sum_(_moments_launch(x), group)
        return _apply_sums_launch(x, sums, group.world, gamma, beta, eps,
                                  act_name)

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        grads = recompute_grads(ctx, (gy, gmean, gvar), bn_act_plain, ctx.eps,
                                ctx.act_name, ctx.group)
        return (*grads, None, None, None)


# -- wrappers ------------------------------------------------------------------

def check_inputs(what: str, x: torch.Tensor, layout: str,
                 **vectors: torch.Tensor) -> None:
    """x: f32 with the dims of ``layout`` ("B, F" or "B, C, H, W") on the
    CPU or a card; each vector f32 [x.shape[1]] on x's device."""
    if x.dim() != len(layout.split(",")):
        raise ValueError(f"{what} takes [{layout}], got {tuple(x.shape)}")
    n = x.shape[1]
    for name, t in vectors.items():
        if t.shape != (n,) or t.device != x.device:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} on {t.device} "
                             f"does not match x {tuple(x.shape)} on {x.device}")
    if any(t.dtype != torch.float32 for t in (x, *vectors.values())):
        raise TypeError(f"{what} takes float32 only, got "
                        + "/".join(str(t.dtype) for t in (x, *vectors.values())))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def kernel_act(what: str, act_name: str) -> str:
    name = act_name.lower()
    if name not in ACT_CODES:
        raise ValueError(f"{what}: activation {act_name!r} is not "
                         f"elementwise-fusable; known: {sorted(ACT_CODES)}")
    return name


def bn_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) per feature of a 2-D f32 x.  A CPU x takes the plain
    version; a CUDA x launches the moments kernel."""
    check_inputs("bn_moments", x, "B, F")
    if x.device.type == "cpu":
        return bn_moments_plain(x)
    stats = _moments_launch(x.contiguous())
    return stats[0], stats[1]


def bn_apply(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
             gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
             act_name: str = "identity") -> torch.Tensor:
    """act((x - mean) * rsqrt(var + eps) * gamma + beta) for a 2-D f32 x
    and per-feature vectors.  A CPU x takes the plain version; a CUDA x
    launches the apply kernel."""
    check_inputs("bn_apply", x, "B, F", mean=mean, var=var, gamma=gamma,
                 beta=beta)
    if x.device.type == "cpu":
        return bn_apply_plain(x, mean, var, gamma, beta, eps, act_name.lower())
    return _apply_launch(x.contiguous(), mean.contiguous(), var.contiguous(),
                         gamma.contiguous(), beta.contiguous(), float(eps),
                         kernel_act("bn_apply", act_name))


def bn_apply_sums(x: torch.Tensor, sums: torch.Tensor, world: int,
                  gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
                  act_name: str = "identity") -> Triple:
    """-> (y, mean, var) from ``sums`` [2, F], the sum over ``world`` ranks
    of each rank's (E[x], E[x^2]) (as the all-reduce leaves it): mean = the
    first row / world, var = the second / world - mean^2, then the apply
    step.  A CPU x takes the plain version; a CUDA x launches the apply
    kernel (counted as ``bn_apply``), which finishes the moments itself."""
    check_inputs("bn_apply_sums", x, "B, F", gamma=gamma, beta=beta)
    if (sums.shape != (2, x.shape[1]) or sums.device != x.device
            or sums.dtype != torch.float32):
        raise ValueError(f"bn_apply_sums: sums {tuple(sums.shape)} "
                         f"{sums.dtype} on {sums.device} is not f32 "
                         f"[2, {x.shape[1]}] on {x.device}")
    if int(world) < 1:
        raise ValueError(f"bn_apply_sums: world {world} < 1")
    if x.device.type == "cpu":
        return bn_apply_sums_plain(x, sums, int(world), gamma, beta, eps,
                                   act_name.lower())
    return _apply_sums_launch(x.contiguous(), sums.contiguous(), int(world),
                              gamma.contiguous(), beta.contiguous(),
                              float(eps), kernel_act("bn_apply_sums", act_name))


def fused_bn_act_train(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-5,
                       act_name: str = "identity",
                       group: Optional[mesh.DataGroup] = None) -> Triple:
    """-> (act(bn(x)), batch_mean, batch_var) for a 2-D f32 x.  With a
    ``group`` of more than one rank, x is this rank's rows and the moments
    are the global batch's (sync-BN).  A CPU x takes the plain version; a
    CUDA x launches the single-device kernel, or the moments and apply
    kernels with one all-reduce between them."""
    check_inputs("fused_bn_act_train", x, "B, F", gamma=gamma, beta=beta)
    sync = group if group is not None and group.world > 1 else None
    if x.device.type == "cpu":
        return bn_act_plain(x, gamma, beta, eps, act_name.lower(), sync)
    name = kernel_act("fused_bn_act_train", act_name)
    args = (x.contiguous(), gamma.contiguous(), beta.contiguous(), float(eps),
            name)
    if sync is not None:
        return _BnSync.apply(*args, sync)
    return _BnAct.apply(*args)


def fused_bn_act_train_tenants(x: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, eps: float = 1e-5,
                               act_name: str = "identity") -> Triple:
    """-> (act(bn(x)) [N, B, F], mean [N, F], var [N, F]) for an f32 x
    [N, B, F] of N tenants, each normalized by its own B rows with its own
    gamma, beta [N, F].  A CPU x takes the plain version; a CUDA x launches
    the tenant kernel (one launch for every tenant)."""
    if x.dim() != 3:
        raise ValueError(f"fused_bn_act_train_tenants takes [N, B, F], got "
                         f"{tuple(x.shape)}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.shape != (x.shape[0], x.shape[2]) or t.device != x.device
                or t.dtype != torch.float32):
            raise ValueError(f"fused_bn_act_train_tenants: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} is "
                             f"not f32 [{x.shape[0]}, {x.shape[2]}] on "
                             f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_bn_act_train_tenants takes float32 only, got "
                        f"{x.dtype}")
    if x.device.type == "cpu":
        return bn_act_tenants_plain(x, gamma, beta, eps, act_name.lower())
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_act_train_tenants: unsupported device "
                         f"{x.device}")
    name = kernel_act("fused_bn_act_train_tenants", act_name)
    return _BnActTenants.apply(x.contiguous(), gamma.contiguous(),
                               beta.contiguous(), float(eps), name)


def bn_act_tenants_bwd(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, mean: torch.Tensor,
                       var: torch.Tensor, gy: torch.Tensor,
                       gmean: torch.Tensor, gvar: torch.Tensor,
                       eps: float = 1e-5, act_name: str = "identity",
                       need_dx: bool = True):
    """The backward of ``fused_bn_act_train_tenants`` from its saved mean
    and var: -> (dx [N, B, F] or None when not ``need_dx``, dgamma, dbeta
    [N, F]) for the cotangents gy [N, B, F] and gmean, gvar [N, F].  A CPU
    x takes the closed form (``bn_act_tenants_bwd_plain``); a CUDA x
    launches the backward kernel."""
    if x.dim() != 3 or gy.shape != x.shape:
        raise ValueError(f"bn_act_tenants_bwd takes x and gy [N, B, F], got "
                         f"{tuple(x.shape)} and {tuple(gy.shape)}")
    vectors = {"gamma": gamma, "beta": beta, "mean": mean, "var": var,
               "gmean": gmean, "gvar": gvar}
    for name, t in vectors.items():
        if t.shape != (x.shape[0], x.shape[2]) or t.device != x.device:
            raise ValueError(f"bn_act_tenants_bwd: {name} {tuple(t.shape)} on "
                             f"{t.device} is not [{x.shape[0]}, {x.shape[2]}] "
                             f"on {x.device}")
    if gy.device != x.device:
        raise ValueError(f"bn_act_tenants_bwd: gy on {gy.device}, x on "
                         f"{x.device}")
    if any(t.dtype != torch.float32 for t in (x, gy, *vectors.values())):
        raise TypeError("bn_act_tenants_bwd takes float32 only")
    if x.device.type == "cpu":
        dx, dgamma, dbeta = bn_act_tenants_bwd_plain(
            x, gamma, beta, mean, var, gy, gmean, gvar, eps,
            act_name.lower())
        return (dx if need_dx else None), dgamma, dbeta
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_tenants_bwd: unsupported device {x.device}")
    name = kernel_act("bn_act_tenants_bwd", act_name)
    return _tenants_bwd_launch(
        *(t.contiguous() for t in (x, gamma, beta, mean, var, gy, gmean,
                                   gvar)), float(eps), name, bool(need_dx))


fused_bn_act_train.launches = 0
fused_bn_act_train_tenants.launches = 0
bn_act_tenants_bwd.launches = 0
bn_moments.launches = 0
bn_apply.launches = 0
