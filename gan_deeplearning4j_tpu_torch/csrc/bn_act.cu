// Train-mode BatchNorm + activation over a row-major [B, F] f32 matrix,
// single device (replaces the Pallas kernel _fused_kernel in
// gan_deeplearning4j_tpu/ops/pallas/bn_act.py, fused_bn_act_train with
// axis_name=None).
//
//   mean = sum(x)/B, var = sum(x*x)/B - mean^2   (biased, per feature)
//   y    = act((x - mean) * rsqrt(var + eps) * gamma + beta)
//
// Bound: device memory.  x is read and y written once (8 bytes per element
// for about ten flops); mean and var are F floats each.  The TPU kernel
// reduces whole [B, 128] tiles in VMEM; here a feature group of 32
// neighbouring columns (128 bytes of a row, one coalesced warp load) plays
// the part of bn_act_4d.cu's channel.  One launch, no atomics:
//   - group g belongs to cluster g of K blocks (K <= 8, chosen so that the
//     grid fills the card); block rank r owns a contiguous run of the B
//     rows;
//   - a block is 32 column lanes by RT row-threads; each thread loads its
//     rows of its column, keeps them in the block's [rows, 32] shared tile
//     and sums x and x*x;
//   - the RT partials of each column meet in shared memory, then the K
//     blocks' column sums meet through distributed shared memory in rank
//     order (bn_cluster.cuh), so every block holds the same moments;
//   - it normalizes from the tile and writes y once.
// Rows too many for K blocks' shared memory take the streamed branch
// (resident = 0): the second walk reads x from device memory again.
// The launch plan (K, rows per block, RT, shared memory, branch) comes from
// ops/cuda/bn_act.py launch_plan and is checked here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_cluster.cuh"
#include "bn_common.cuh"

namespace {

using gan4j::activate;
namespace cg = gan4j::cg;

constexpr int kMaxRowThreads = 16;
constexpr int kUnroll = 8;  // loads a thread keeps in flight

template <int ACT>
__global__ void __launch_bounds__(32 * kMaxRowThreads)
bn_act_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ var_out,
              int rows, int cols, int k, int per_block, int resident,
              float inv_n, float eps) {
  extern __shared__ float tile[];  // [per_block][32] when resident
  __shared__ float ps[kMaxRowThreads][32], ps2[kMaxRowThreads][32];
  __shared__ float part[2][32];  // this block's column sums of x, x*x
  __shared__ float coef[2][32];  // each column's mean, rsqrt(var + eps)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x, ty = threadIdx.y, rt = blockDim.y;
  const int col = (blockIdx.x / k) * 32 + lane;
  const bool live = col < cols;
  const int r0 = rank * per_block;
  const int r1 = r0 + per_block < rows ? r0 + per_block : rows;
  const float* xp = x + col;
  float* yp = y + col;
  // read now, so their latency is not paid after the reduction
  const float gm = live ? gamma[col] : 0.0f, bt = live ? beta[col] : 0.0f;

  // one walk over this block's rows of the group: sums, and the tile
  float s = 0.0f, s2 = 0.0f;
  for (int b0 = r0 + ty; b0 < r1; b0 += kUnroll * rt) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + u * rt;
      v[u] = live && b < r1 ? xp[(int64_t)b * cols] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + u * rt;
      if (b < r1) {
        if (resident) tile[(b - r0) * 32 + lane] = v[u];
        s += v[u];
        s2 = fmaf(v[u], v[u], s2);
      }
    }
  }
  ps[ty][lane] = s;
  ps2[ty][lane] = s2;
  __syncthreads();
  if (ty == 0) {
    s = 0.0f;
    s2 = 0.0f;
    for (int t = 0; t < rt; ++t) {
      s += ps[t][lane];
      s2 += ps2[t][lane];
    }
    part[0][lane] = s;
    part[1][lane] = s2;
  }
  // every block's column sums are written and visible to the cluster
  cluster.sync();
  if (ty == 0) {
    const float mean = gan4j::cluster_sum(cluster, &part[0][0], lane, k) * inv_n;
    const float var =
        gan4j::cluster_sum(cluster, &part[0][0], 32 + lane, k) * inv_n -
        mean * mean;
    coef[0][lane] = mean;
    coef[1][lane] = rsqrtf(var + eps);
    if (rank == 0 && live) {
      mean_out[col] = mean;
      var_out[col] = var;
    }
  }
  __syncthreads();
  if (live) {
    const float mean = coef[0][lane], scale = coef[1][lane];
    for (int b = r0 + ty; b < r1; b += rt) {
      const int64_t off = (int64_t)b * cols;
      const float v = resident ? tile[(b - r0) * 32 + lane] : xp[off];
      yp[off] = activate<ACT>((v - mean) * scale * gm + bt);
    }
  }
  // no block leaves while another may still read its column sums
  cluster.sync();
}

struct Launch {
  const float *x, *gamma, *beta;
  float *y, *mean, *var;
  int rows, cols, k, per_block, row_threads, smem, resident;
  float eps;
  cudaStream_t stream;
  cudaError_t err;

  template <int ACT>
  void run() {
    static const cudaError_t attr =
        gan4j::allow_max_dynamic_smem(bn_act_kernel<ACT>);
    if (attr != cudaSuccess) {
      err = attr;
      return;
    }
    const int groups = (cols + 31) / 32;
    err = gan4j::launch_cluster(
        bn_act_kernel<ACT>, dim3(groups * k), dim3(32, row_threads), k,
        (size_t)smem, stream, x, gamma, beta, y, mean, var, rows, cols, k,
        per_block, resident, 1.0f / (float)rows, eps);
  }
};

}  // namespace

// The plan (k, per_block rows, row_threads, smem, resident) is
// ops/cuda/bn_act.py launch_plan's.  act: the codes of bn_common.cuh.
// Returns cudaErrorInvalidValue for another code or a plan this kernel
// cannot run, else the launch's error (cudaErrorInvalidConfiguration when
// no cluster of k blocks fits).
extern "C" int gan4j_bn_act(const void* x, const void* gamma,
                            const void* beta, void* y, void* mean, void* var,
                            int rows, int cols, float eps, int act, int k,
                            int per_block, int row_threads, int smem,
                            int resident, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const int64_t groups = (cols + 31) / 32;
  const bool ok =
      gan4j::valid_cluster(k) && row_threads >= 1 &&
      row_threads <= kMaxRowThreads && per_block >= 1 &&
      (int64_t)per_block * k >= rows && groups * k <= 0x7fffffffLL &&
      (resident ? (int64_t)smem == (int64_t)per_block * 32 * 4 &&
                      smem <= gan4j::kMaxDynamicSmem
                : smem == 0);
  if (!ok) return (int)cudaErrorInvalidValue;
  Launch l{(const float*)x, (const float*)gamma, (const float*)beta,
           (float*)y,       (float*)mean,        (float*)var,
           rows,            cols,                k,
           per_block,       row_threads,         smem,
           resident,        eps,                 (cudaStream_t)stream,
           cudaSuccess};
  if (!gan4j::dispatch_act(act, l)) return (int)cudaErrorInvalidValue;
  return (int)l.err;
}

// ---------------------------------------------------------------------------
// The tenant-batched form: x [N, B, F] row-major, gamma/beta [N, F]; each
// tenant's statistics over its own B rows -> y [N, B, F], mean/var [N, F].
// gan4j_bn_act_tenants replaces what jax.vmap makes of _fused_kernel
// (gan_deeplearning4j_tpu/ops/pallas/bn_act.py) on the JAX fleet's path:
// the Pallas batching rule turns the tenant axis into a grid axis.
// gan4j_bn_act_tenants_bwd replaces no Pallas kernel: it stands for the
// JAX _bwd of fused_bn_act_train (bn_act.py) under vmap, whose
// rematerialization through _reference XLA fuses into a few fusions; on
// the card that recompute was some forty torch ops a BN.
//
// Bound: device memory.  The forward reads x and writes y once (8 bytes an
// element), the backward reads x and gy and writes dx once (12 bytes);
// the [N, F] vectors are a sixteenth of that at the fleet's widths.  The
// fleet's BNs are small per tenant ([16..32, 2..100] at batch 16), so a
// launch at a few thousand tenants moves a few MB, and below that its
// time is latency: the copy in, each thread's chain of dependent work,
// the copy out.  The design:
//   - A persistent grid (ops/cuda/bn_act.py tenant_plan: the stages, or a
//     few blocks an SM) walks stages of T whole tenants; a stage's
//     [T, B, F] slab is contiguous in x.
//   - One thread issues each slab as one cp.async.bulk into a shared
//     buffer, completed on the buffer's mbarrier; a ring of two buffers
//     keeps the next stage's copy in flight under this stage's work.
//   - Each (tenant, column) pair belongs to R neighbouring lanes of a
//     warp, lane k walking rows k, k + R, ...; their sums meet by
//     shuffles.  R splits the B rows where the launch moves little (the
//     chain is B / R rows, not B) and is 1 where the SMs are full anyway.
//     T is chosen so that the pairs fill whole warps, and its stage bytes
//     start and end on 16 bytes; where they cannot (an odd B*F, a base
//     address off 16 bytes), the buffer keeps the array's alignment and
//     the threads copy the ragged head and tail (under 16 bytes each).
//   - A column's sums are taken in the order the plain reference takes
//     them on the CPU and every step is rounded as its torch op rounds
//     (OrderedSum, __f*_rn: no contraction into fma), so the moments are
//     the reference's bits: the card's fleet step stays within its band
//     of the CPU's (chip_smoke.py FLEET_TOL).
//   - A thread's column and tenant come from its start and a fixed stride
//     (no division an element).
//   - The result (y, or dx over gy's buffer) is written in place in the
//     buffer and leaves as one bulk store, which must have read the buffer
//     before the ring refills it.
// The two kernels share this pipeline (tenant_stages); they differ in the
// per-pair work (FwdPair, BwdPair), instantiated for each split R, the
// activation a runtime code (bn_common.cuh activate_code).  The plan is
// checked here.

namespace {

constexpr int kTenantMaxThreads = 512;
constexpr int kTenantMaxRing = 2;
constexpr int kTenantMaxSplit = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(reinterpret_cast<unsigned long long>(dst)),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The ring's geometry and the run's sizes, the same for every stage.
struct Dims {
  int tenants, rows, cols;  // N, B, F
  int per_stage;            // T tenants a stage
  int stages;               // ceil(N / T)
  int ring;                 // buffers in flight a block, 1 or 2
  int vec_cols;             // 32 * (F / 32): the columns summed in order
  int buf;                  // floats of one slab's buffer
  int64_t total;            // N * B * F
  float eps;
};

// One slab's part of a stage: elements [s0, s1) of a flat array kept at
// buf[head + (e - s0)], so that buffer and array agree modulo 16 bytes;
// local indices [lo, hi) are the 16-byte-aligned run the bulk copies move,
// [0, lo) and [hi, s1 - s0) the ragged ends (under 16 bytes each).
struct Span {
  int head, lo, hi;
};

__device__ __forceinline__ Span span_of(const float* p, int64_t s0,
                                        int64_t s1) {
  const int n = (int)(s1 - s0);
  const int head = (int)((reinterpret_cast<uintptr_t>(p + s0) & 15) >> 2);
  const int tail = (int)((reinterpret_cast<uintptr_t>(p + s1) & 15) >> 2);
  const int lo = ((4 - head) & 3) < n ? (4 - head) & 3 : n;
  const int hi = n - tail;
  return {head, lo, hi > lo ? hi : lo};
}

constexpr int kRowUnroll = 4;  // rows a thread has in flight

// Visits this thread's rows of a pair's column, b = k, k + R, ... < B in
// order (R = RS threads a pair), at offset base + b*F in each of NS
// buffers: fn(v, off, u) with v[s] = bufs[s][off] and u = the row's place
// in its round, so that b = k + R u (mod 4R).  Each round reads kRowUnroll
// rows of every buffer before fn sees the first, so the loads overlap (fn
// may write the element it was given).
template <int NS, int RS, class Fn>
__device__ __forceinline__ void walk_column(float* const (&bufs)[NS],
                                            int base, int k, int rows,
                                            int cols, Fn&& fn) {
  for (int i0 = k; i0 < rows; i0 += RS * kRowUnroll) {
    float v[kRowUnroll][NS];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
#pragma unroll
      for (int s = 0; s < NS; ++s)
        v[u][s] = i0 + u * RS < rows ? bufs[s][base + (i0 + u * RS) * cols]
                                     : 0.0f;
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
      if (i0 + u * RS < rows) fn(v[u], base + (i0 + u * RS) * cols, u);
  }
}

// A column's sum over its B rows in the order of the plain reference on
// the CPU (torch's sum over the middle axis, B up to 32): a column of the
// first 32 * (F / 32), the vectorized ones, sums its rows in order; the
// others keep four running sums, of rows b = 0, 1, 2, 3 mod 4, added in
// that order at the end.  So the card's moments are the reference's bits
// whatever the split.  With RS lanes a pair (RS dividing 4, and no
// vectorized column), lane k keeps the sums of rows k, k + RS, ... mod 4
// (slot j: rows k + RS j mod 4); total() gathers the four in order, the
// result every lane's.
template <int RS>
struct OrderedSum {
  static constexpr int kSlots = 4 / RS;
  float acc[kSlots];
  bool in_order;
  __device__ __forceinline__ explicit OrderedSum(bool vectorized)
      : in_order(vectorized) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) acc[j] = 0.0f;
  }
  // u: the row's place in its round (walk_column), a constant once unrolled
  __device__ __forceinline__ void add(int u, float v) {
    if (in_order)
      acc[0] = __fadd_rn(acc[0], v);
    else
      acc[u % kSlots] = __fadd_rn(acc[u % kSlots], v);
  }
  __device__ __forceinline__ float total() const {
    const int group = (int)(threadIdx.x & 31) & ~(RS - 1);
    float t = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float a = RS == 1 ? acc[c]
                              : __shfl_sync(0xffffffffu, acc[c / RS],
                                            group + c % RS);
      t = c == 0 ? a : __fadd_rn(t, a);
    }
    return t;
  }
};

// Stage c's slabs into ring slot ``slot`` (one thread): the aligned run of
// each by one bulk copy, all completed on ``bar``.
template <int SLABS>
__device__ void issue_stage(const Dims& d, const float* const* src,
                            float* slot, uint64_t* bar, int c) {
  const int64_t s0 = (int64_t)c * d.per_stage * d.rows * d.cols;
  const int64_t span = (int64_t)d.per_stage * d.rows * d.cols;
  const int64_t s1 = s0 + span < d.total ? s0 + span : d.total;
  Span sp[SLABS];
  uint32_t bytes = 0;
#pragma unroll
  for (int s = 0; s < SLABS; ++s) {
    sp[s] = span_of(src[s], s0, s1);
    bytes += 4u * (uint32_t)(sp[s].hi - sp[s].lo);
  }
  mbar_expect(bar, bytes);
#pragma unroll
  for (int s = 0; s < SLABS; ++s)
    if (sp[s].hi > sp[s].lo)
      bulk_load(slot + s * d.buf + sp[s].head + sp[s].lo,
                src[s] + s0 + sp[s].lo, 4u * (uint32_t)(sp[s].hi - sp[s].lo),
                bar);
}

// The pipeline both kernels run.  Pair supplies kSlabs (inputs staged),
// kOut (the slab whose buffer takes the result; its array ``out`` agrees
// with that input modulo 16 bytes; nullptr: no result array), in[], out,
// Vec load(q) (the pair's [N, F] vectors, read before the wait) and
// run(d, bufs, live, base, vectorized, k, q, vec) over the stage's buffers
// (all lanes call it; ``live`` is false past the stage's last pair).
template <class Pair>
__global__ void __launch_bounds__(kTenantMaxThreads)
tenant_stages(Pair op, Dims d) {
  constexpr int S = Pair::kSlabs;
  extern __shared__ __align__(128) float tenant_smem[];
  __shared__ uint64_t bars[kTenantMaxRing];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int r = 0; r < d.ring; ++r) mbar_init(&bars[r]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int r = 0; r < d.ring; ++r) {
      const int c = blockIdx.x + r * gridDim.x;
      if (c < d.stages)
        issue_stage<S>(d, op.in, tenant_smem + (size_t)r * S * d.buf,
                       &bars[r], c);
    }
  }
  __syncthreads();
  // R = Pair::kSplit neighbouring lanes share a pair, lane k of them taking
  // rows k, k + R, ...; this thread's first pair of a stage and the step to
  // its next (pp pairs a pass), the same every stage
  constexpr int R = Pair::kSplit;
  const int k = tid & (R - 1), pp = blockDim.x / R;
  const int p_first = tid / R;
  const int t_first = p_first / d.cols, c_first = p_first - t_first * d.cols;
  const int dt = pp / d.cols, dc = pp - dt * d.cols;
  const int tile = d.rows * d.cols;

  for (int j = 0;; ++j) {
    const int c = blockIdx.x + j * gridDim.x;
    if (c >= d.stages) break;
    const int r = d.ring == 1 ? 0 : (j & 1);
    const uint32_t parity = (uint32_t)(d.ring == 1 ? j : j >> 1) & 1u;
    float* slot = tenant_smem + (size_t)r * S * d.buf;
    const int t0 = c * d.per_stage;
    const int nt = d.tenants - t0 < d.per_stage ? d.tenants - t0 : d.per_stage;
    const int64_t s0 = (int64_t)t0 * tile;
    const int64_t s1 = s0 + (int64_t)nt * tile;
    const int n_el = (int)(s1 - s0);
    Span sp[S];
    bool ragged = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sp[s] = span_of(op.in[s], s0, s1);
      ragged |= sp[s].lo > 0 || sp[s].hi < n_el;
    }
    bool waited = false;
    if (ragged) {
      // the ends no bulk copy moves, by the threads, once the slot holds
      // this stage (its last store has read it)
      mbar_wait(&bars[r], parity);
      waited = true;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float* b = slot + s * d.buf + sp[s].head;
        const float* g = op.in[s] + s0;
        if (tid < sp[s].lo) b[tid] = g[tid];
        if (tid < n_el - sp[s].hi) b[sp[s].hi + tid] = g[sp[s].hi + tid];
      }
      __syncthreads();
    }
    float* bufs[S];  // each slab's element 0 of the stage
#pragma unroll
    for (int s = 0; s < S; ++s) bufs[s] = slot + s * d.buf + sp[s].head;
    const int pairs = nt * d.cols;
    int t = t_first, col = c_first;
    // every lane runs every pass: the pair sums shuffle across the warp
    for (int p0 = 0; p0 < pairs; p0 += pp) {
      const bool live = p0 + p_first < pairs;
      const int64_t q = (int64_t)t0 * d.cols + p0 + p_first;
      const typename Pair::Vec v = live ? op.load(q) : typename Pair::Vec{};
      if (!waited) {
        mbar_wait(&bars[r], parity);
        waited = true;
      }
      op.run(d, bufs, live, t * tile + col, col < d.vec_cols, k, q, v);
      t += dt;
      col += dc;
      if (col >= d.cols) {
        col -= d.cols;
        ++t;
      }
    }
    // the buffer's generic writes, seen by the bulk store's async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      if (op.out != nullptr) {
        const Span& o = sp[Pair::kOut];
        const float* b = slot + Pair::kOut * d.buf + o.head;
        float* g = op.out + s0;
        for (int l = 0; l < o.lo; ++l) g[l] = b[l];
        for (int l = o.hi; l < n_el; ++l) g[l] = b[l];
        if (o.hi > o.lo)
          bulk_store(g + o.lo, b + o.lo, 4u * (uint32_t)(o.hi - o.lo));
      }
      const int cn = c + d.ring * gridDim.x;
      if (cn < d.stages) {
        // the store has read the buffer the next copy overwrites
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        issue_stage<S>(d, op.in, slot, &bars[r], cn);
      }
    }
  }
  // the stores have read shared memory before the block leaves
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The forward's pair: the column's E[x], E[x^2] -> mean, var (biased, as
// _reference), then y = act((x - mean) * rsqrt(var + eps) * gamma + beta)
// over x in the buffer.
template <int RS>
struct FwdPair {
  static constexpr int kSlabs = 1, kOut = 0, kSplit = RS;
  int act;             // bn_common.cuh Act
  const float* in[1];  // x
  float* out;          // y
  const float *gamma, *beta;
  float *mean, *var;
  struct Vec {
    float g, b;
  };
  __device__ __forceinline__ Vec load(int64_t q) const {
    return {gamma[q], beta[q]};
  }
  __device__ __forceinline__ void run(const Dims& d, float* const (&bufs)[1],
                                      bool live, int base, bool vectorized,
                                      int k, int64_t q, Vec v) const {
    // each step rounded as the plain reference's torch ops round it
    OrderedSum<RS> s(vectorized), s2(vectorized);
    if (live)
      walk_column<1, RS>(bufs, base, k, d.rows, d.cols,
                         [&](const float(&e)[1], int, int u) {
                           s.add(u, e[0]);
                           s2.add(u, __fmul_rn(e[0], e[0]));
                         });
    const float n = (float)d.rows;
    const float m = __fdiv_rn(s.total(), n);
    const float m2 = __fdiv_rn(s2.total(), n);
    if (!live) return;
    const float var_ = __fsub_rn(m2, __fmul_rn(m, m));
    if (k == 0) {
      mean[q] = m;
      var[q] = var_;
    }
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var_, d.eps)));
    walk_column<1, RS>(bufs, base, k, d.rows, d.cols,
                       [&](const float(&e)[1], int l, int) {
                         bufs[0][l] = gan4j::activate_code(act, __fadd_rn(
                             __fmul_rn(__fmul_rn(__fsub_rn(e[0], m), rs), v.g),
                             v.b));
                       });
  }
};

// The backward's pair, from the forward's mean and var: the vector-Jacobian
// product of the forward in the order autograd of the plain forward takes
// it (bn_act_tenants_bwd_plain), so that its rounding follows the
// recompute it replaced (the fleet step's card-against-CPU band holds it):
//   r = rsqrt(var + eps), c = x - mean, xh = c r, gz = gy act'(gamma xh +
//   beta), dbeta = sum_b gz, dgamma = sum_b gz xh, gxh = gz gamma,
//   gv = gvar - 0.5 r^3 sum_b gxh c, gm = gmean - sum_b gxh r - 2 mean gv,
//   dx = gxh r + gm / B + (2 gv / B) x,
// which is gamma r / B (B gz - dbeta - xh dgamma) + gmean / B
// + gvar 2 (x - mean) / B; dx written over gy in its buffer (skipped when
// out is nullptr).
template <int RS>
struct BwdPair {
  static constexpr int kSlabs = 2, kOut = 1, kSplit = RS;
  int act;             // bn_common.cuh Act
  const float* in[2];  // x, gy
  float* out;          // dx, or nullptr
  const float *gamma, *beta, *mean, *var, *gmean, *gvar;
  float *dgamma, *dbeta;
  struct Vec {
    float g, b, m, v, gm, gv;
  };
  __device__ __forceinline__ Vec load(int64_t q) const {
    return {gamma[q], beta[q], mean[q], var[q], gmean[q], gvar[q]};
  }
  __device__ __forceinline__ void run(const Dims& d, float* const (&bufs)[2],
                                      bool live, int base, bool vectorized,
                                      int k, int64_t q, Vec v) const {
    // bufs: x, gy (then dx); each step rounded as autograd's ops round it
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(v.v, d.eps)));
    OrderedSum<RS> db(vectorized), dg(vectorized), sgc(vectorized),
        sgr(vectorized);
    if (live)
      walk_column<2, RS>(bufs, base, k, d.rows, d.cols,
                         [&](const float(&e)[2], int, int u) {
                           const float c = __fsub_rn(e[0], v.m);
                           const float xh = __fmul_rn(c, r);
                           const float gz = __fmul_rn(
                               e[1], gan4j::activate_grad_code(act, 
                                         __fadd_rn(__fmul_rn(xh, v.g), v.b)));
                           const float gxh = __fmul_rn(gz, v.g);
                           db.add(u, gz);
                           dg.add(u, __fmul_rn(gz, xh));
                           sgc.add(u, __fmul_rn(gxh, r));
                           sgr.add(u, __fmul_rn(gxh, c));
                         });
    const float tdb = db.total(), tdg = dg.total();
    const float tgc = sgc.total(), tgr = sgr.total();
    if (!live) return;
    if (k == 0) {
      dgamma[q] = tdg;
      dbeta[q] = tdb;
    }
    if (out == nullptr) return;
    const float n = (float)d.rows;
    const float gv = __fadd_rn(
        v.gv, __fmul_rn(__fmul_rn(-0.5f, tgr), __fmul_rn(__fmul_rn(r, r), r)));
    const float gm =
        __fsub_rn(__fsub_rn(v.gm, tgc), __fmul_rn(__fmul_rn(2.0f, v.m), gv));
    const float am = __fdiv_rn(gm, n), ax = __fdiv_rn(__fmul_rn(2.0f, gv), n);
    walk_column<2, RS>(bufs, base, k, d.rows, d.cols,
                       [&](const float(&e)[2], int l, int) {
                         const float xh = __fmul_rn(__fsub_rn(e[0], v.m), r);
                         const float gz = __fmul_rn(
                             e[1], gan4j::activate_grad_code(act, 
                                       __fadd_rn(__fmul_rn(xh, v.g), v.b)));
                         bufs[1][l] = __fadd_rn(
                             __fadd_rn(__fmul_rn(__fmul_rn(gz, v.g), r), am),
                             __fmul_rn(ax, e[0]));
                       });
  }
};

struct TenantPlan {
  int per_stage, split, threads, ring, grid, smem;
};

// The plan (ops/cuda/bn_act.py tenant_plan) for ``slabs`` staged inputs:
// false for one this pipeline cannot run, else ``d`` filled.
bool tenant_dims(int tenants, int rows, int cols, float eps,
                 const TenantPlan& p, int slabs, Dims* d) {
  if (p.per_stage < 1 ||
      (p.split != 1 && p.split != 2 && p.split != kTenantMaxSplit) ||
      (p.split > 1 && cols >= 32) ||
      p.threads < 32 ||
      p.threads > kTenantMaxThreads || p.threads % 32 != 0 || p.ring < 1 ||
      p.ring > kTenantMaxRing || p.grid < 1)
    return false;
  const int64_t span = (int64_t)p.per_stage * rows * cols;
  const int64_t buf = (span + 3 + 3) / 4 * 4;  // + a head of up to 3
  const int64_t stages = ((int64_t)tenants + p.per_stage - 1) / p.per_stage;
  if ((int64_t)p.smem != (int64_t)p.ring * slabs * buf * 4 ||
      p.smem > gan4j::kMaxDynamicSmem || p.grid > stages)
    return false;
  *d = Dims{tenants,       rows, cols, p.per_stage, (int)stages, p.ring,
            cols / 32 * 32, (int)buf, (int64_t)tenants * rows * cols, eps};
  return true;
}

bool same_alignment(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

template <class Pair>
cudaError_t launch_stages(const Pair& op, const Dims& d, const TenantPlan& p,
                          cudaStream_t stream) {
  static const cudaError_t attr =
      gan4j::allow_max_dynamic_smem(tenant_stages<Pair>);
  if (attr != cudaSuccess) return attr;
  tenant_stages<Pair><<<p.grid, p.threads, (size_t)p.smem, stream>>>(op, d);
  return cudaGetLastError();
}

struct FwdLaunch {
  const float *x, *gamma, *beta;
  float *y, *mean, *var;
  int act;
  Dims d;
  TenantPlan p;
  cudaStream_t stream;

  template <int RS>
  cudaError_t go() const {
    FwdPair<RS> op;
    op.act = act;
    op.in[0] = x;
    op.out = y;
    op.gamma = gamma;
    op.beta = beta;
    op.mean = mean;
    op.var = var;
    return launch_stages(op, d, p, stream);
  }
};

struct BwdLaunch {
  const float *x, *gy, *gamma, *beta, *mean, *var, *gmean, *gvar;
  float *dx, *dgamma, *dbeta;
  int act;
  Dims d;
  TenantPlan p;
  cudaStream_t stream;

  template <int RS>
  cudaError_t go() const {
    BwdPair<RS> op;
    op.act = act;
    op.in[0] = x;
    op.in[1] = gy;
    op.out = dx;
    op.gamma = gamma;
    op.beta = beta;
    op.mean = mean;
    op.var = var;
    op.gmean = gmean;
    op.gvar = gvar;
    op.dgamma = dgamma;
    op.dbeta = dbeta;
    return launch_stages(op, d, p, stream);
  }
};

// The launcher's kernel for the plan's split (tenant_dims checked it).
template <class Launch>
cudaError_t launch_split(const Launch& l) {
  if (l.p.split == 1) return l.template go<1>();
  if (l.p.split == 2) return l.template go<2>();
  return l.template go<kTenantMaxSplit>();
}

}  // namespace

// x, y [tenants, rows, cols] (y agreeing with x modulo 16 bytes); gamma,
// beta, mean, var [tenants, cols].  The plan (per_stage tenants a stage,
// split threads a pair, threads, ring, grid, smem bytes) is
// ops/cuda/bn_act.py tenant_plan's
// with one slab.  Returns cudaErrorInvalidValue for an unknown activation
// code or a plan this kernel cannot run, else the launch's error.
extern "C" int gan4j_bn_act_tenants(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* var, int tenants, int rows,
                                    int cols, float eps, int act,
                                    int per_stage, int split, int threads,
                                    int ring, int grid, int smem,
                                    void* stream) {
  if (tenants <= 0 || rows <= 0 || cols <= 0) return 0;
  const TenantPlan p{per_stage, split, threads, ring, grid, smem};
  Dims d;
  if (!gan4j::valid_act(act) ||
      !tenant_dims(tenants, rows, cols, eps, p, 1, &d) ||
      !same_alignment(x, y))
    return (int)cudaErrorInvalidValue;
  const FwdLaunch l{(const float*)x, (const float*)gamma, (const float*)beta,
                    (float*)y,       (float*)mean,        (float*)var,
                    act,             d,                   p,
                    (cudaStream_t)stream};
  return (int)launch_split(l);
}

// x, gy, dx [tenants, rows, cols] (dx agreeing with gy modulo 16 bytes, or
// null: no dx); gamma, beta, mean, var (the forward's), gmean, gvar (the
// cotangents of mean and var), dgamma, dbeta [tenants, cols].  The plan is
// tenant_plan's with two slabs.  Returns as gan4j_bn_act_tenants.
extern "C" int gan4j_bn_act_tenants_bwd(
    const void* x, const void* gy, const void* gamma, const void* beta,
    const void* mean, const void* var, const void* gmean, const void* gvar,
    void* dx, void* dgamma, void* dbeta, int tenants, int rows, int cols,
    float eps, int act, int per_stage, int split, int threads, int ring,
    int grid, int smem, void* stream) {
  if (tenants <= 0 || rows <= 0 || cols <= 0) return 0;
  const TenantPlan p{per_stage, split, threads, ring, grid, smem};
  Dims d;
  if (!gan4j::valid_act(act) ||
      !tenant_dims(tenants, rows, cols, eps, p, 2, &d) ||
      (dx != nullptr && !same_alignment(gy, dx)))
    return (int)cudaErrorInvalidValue;
  const BwdLaunch l{(const float*)x,     (const float*)gy,
                    (const float*)gamma, (const float*)beta,
                    (const float*)mean,  (const float*)var,
                    (const float*)gmean, (const float*)gvar,
                    (float*)dx,          (float*)dgamma,
                    (float*)dbeta,       act,
                    d,                   p,
                    (cudaStream_t)stream};
  return (int)launch_split(l);
}
