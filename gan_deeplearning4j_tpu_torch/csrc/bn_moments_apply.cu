// The data-parallel (sync-BN) pair of train-mode BatchNorm + activation
// over a rank's row-major [Bl, F] f32 block.  Replaces the Pallas kernels
// _moments_kernel and _apply_kernel in gan_deeplearning4j_tpu/ops/pallas/
// bn_act.py (fused_bn_act_train with an axis_name).  The caller runs
//
//   gan4j_bn_moments:    stats = [sum(x)/Bl; sum(x*x)/Bl]   (per feature)
//   an in-place all-reduce sum of stats over the ranks
//   gan4j_bn_apply_sums: mean = stats[0]/world, m2 = stats[1]/world,
//                        var = m2 - mean^2,
//                        y = act((x - mean) * rsqrt(var + eps) * gamma + beta)
//
// so one collective sits between the two kernels, as the pmean does in the
// TPU version, and nothing else: the apply kernel finishes the moments
// itself.  gan4j_bn_apply is the same apply kernel given mean and var.  The
// one-pass E[x], E[x^2] form (not Welford) is the reference's: var is taken
// after the reduction over ranks.
//
// Bound: device memory.  Moments read x once (4 bytes per element), apply
// reads x and writes y once (8 bytes per element); at a 2-rank DCGAN step's
// per-rank shapes ([100, 2], [100, 6272], [100, 1024]) that is 2.9 MB and
// 5.9 MB, under 2 us at 3.35 TB/s, so each launch's fixed cost (its first
// loads' latency, the block reduction, the store) sets the pace.  The
// design keeps that cost to one round of loads, spread over many SMs:
//   - A column group is 32 columns, 128 bytes of a row.  A thread owns 4
//     neighbouring columns and moves them as one float4: 8 lanes cover a
//     group's row, and a warp reads 4 rows of it, 4 full 128-byte lines.
//     (A scratch timing on the card found 32-column groups faster than
//     128-column ones at these shapes: a small share per SM on many SMs
//     beats a wide row on few.)  When F % 4 != 0 or a pointer is not
//     16-byte aligned (the [Bl, 2] BN, an offset view) the same threads
//     load and store their 4 columns one float at a time: the same
//     arithmetic in the same order, so both paths give the same bits.
//   - Moments: one block of 8 lanes x RT row-threads per group (ops/cuda/
//     bn_act.py moments_plan: the fewest whole warps that give a thread
//     at most kMomentsUnroll rows), each thread issuing its loads before
//     it adds; an input taller than one round (B > 256) takes more rounds
//     of the same loop.  The 4 row-threads of a warp fold by shuffles, the
//     warps' partials in shared memory, both in a fixed order: no atomics,
//     and two launches give the same bits.  No tile is kept (moments need
//     no second walk), so no dynamic shared memory.  (A first design split
//     a group's rows over a thread-block cluster, summed through
//     distributed shared memory: a scratch timing on the card found every
//     cluster of 2-8 blocks slower than one block at these shapes.)
//   - Apply: the grid is row chunks x column groups (ops/cuda/bn_act.py
//     apply_plan: kApplyRows rows a thread, enough blocks for the card).
//     A thread issues the loads of its rows of the chunk, then computes its
//     4 columns' coefficients once (mean, rsqrt(var + eps), gamma, beta)
//     while they are in flight; there is no per-element index arithmetic,
//     gather or rsqrt.  The first row chunk writes mean and var.
// The from-sums prologue gives the bits of the epilogue it replaces,
// torch's `flat /= world` then `stats[1] - torch.square(stats[0])` on the
// card: torch divides a CUDA tensor by a Python scalar as a multiply by the
// scalar's reciprocal in float (1.0f / (float)world, computed once), and
// __fmul_rn / __fsub_rn keep nvcc from contracting the product and the
// difference into an FMA.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_common.cuh"

namespace {

using gan4j::activate;

constexpr int kLanes = 8;                // threads across a column group
constexpr int kGroupCols = 4 * kLanes;   // ops/cuda/bn_act.py PAIR_GROUP
constexpr int kWarpRows = 32 / kLanes;   // row-threads in a warp
constexpr int kMaxRowThreads = 32;       // PAIR_MAX_ROW_THREADS (both kernels)
constexpr int kMomentsUnroll = 8;        // MOMENTS_UNROLL: loads in flight
constexpr int kApplyRows = 2;            // APPLY_ROWS: an apply thread's rows

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Columns c0 .. c0+3 of the row at p (c0 < cols); a column past the end
// reads as 0 on the scalar path.  VEC: one 16-byte load.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int c0,
                                        int cols) {
  if (VEC) return *reinterpret_cast<const float4*>(p + c0);
  float4 v;
  v.x = p[c0];
  v.y = c0 + 1 < cols ? p[c0 + 1] : 0.0f;
  v.z = c0 + 2 < cols ? p[c0 + 2] : 0.0f;
  v.w = c0 + 3 < cols ? p[c0 + 3] : 0.0f;
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, int c0, int cols,
                                       float4 v) {
  if (VEC) {
    *reinterpret_cast<float4*>(p + c0) = v;
    return;
  }
  p[c0] = v.x;
  if (c0 + 1 < cols) p[c0 + 1] = v.y;
  if (c0 + 2 < cols) p[c0 + 2] = v.z;
  if (c0 + 3 < cols) p[c0 + 3] = v.w;
}

__device__ __forceinline__ void accumulate(float4& s, float4& s2, float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
  s2.x = fmaf(v.x, v.x, s2.x);
  s2.y = fmaf(v.y, v.y, s2.y);
  s2.z = fmaf(v.z, v.z, s2.z);
  s2.w = fmaf(v.w, v.w, s2.w);
}

// The sum over a warp's 4 row-threads (lanes l, l + 8, l + 16, l + 24), in
// a fixed order; lanes 0-7 (row-thread 0 of the warp) hold it.
__device__ __forceinline__ float fold_warp_rows(float v) {
  v += __shfl_down_sync(0xffffffffu, v, 2 * kLanes);
  return v + __shfl_down_sync(0xffffffffu, v, kLanes);
}

__device__ __forceinline__ float4 fold_warp_rows(float4 v) {
  return make_float4(fold_warp_rows(v.x), fold_warp_rows(v.y),
                     fold_warp_rows(v.z), fold_warp_rows(v.w));
}

// Block: kLanes x RT threads (RT a multiple of kWarpRows, so every warp is
// whole for the shuffles), one block per column group.
template <bool VEC>
__global__ void __launch_bounds__(kLanes * kMaxRowThreads)
bn_moments_kernel(const float* __restrict__ x, float* __restrict__ stats,
                  int rows, int cols, float inv_n) {
  constexpr int kMaxWarps = kMaxRowThreads / kWarpRows;
  __shared__ float4 ws[kMaxWarps][kLanes], ws2[kMaxWarps][kLanes];

  const int lane = threadIdx.x, ty = threadIdx.y, rt = blockDim.y;
  const int tid = ty * kLanes + lane, nt = kLanes * rt;
  const int first_col = blockIdx.x * kGroupCols;
  const int c0 = first_col + 4 * lane;

  // this thread's rows ty, ty + rt, ..., kMomentsUnroll loads issued
  // before any add
  float4 s = zero4(), s2 = zero4();
  if (c0 < cols) {
    for (int b0 = ty; b0 < rows; b0 += kMomentsUnroll * rt) {
      float4 v[kMomentsUnroll];
#pragma unroll
      for (int u = 0; u < kMomentsUnroll; ++u) {
        const int b = b0 + u * rt;
        v[u] = b < rows ? load4<VEC>(x + (int64_t)b * cols, c0, cols) : zero4();
      }
#pragma unroll
      for (int u = 0; u < kMomentsUnroll; ++u)
        if (b0 + u * rt < rows) accumulate(s, s2, v[u]);
    }
  }
  s = fold_warp_rows(s);
  s2 = fold_warp_rows(s2);
  if (ty % kWarpRows == 0) {
    ws[ty / kWarpRows][lane] = s;
    ws2[ty / kWarpRows][lane] = s2;
  }
  __syncthreads();
  // each of the group's 2 x 32 sums over the warps, in their order (as
  // floats, ws[w] holds column c of warp w at w * 32 + c)
  const float* wf = &ws[0][0].x;
  const float* wf2 = &ws2[0][0].x;
  for (int i = tid; i < 2 * kGroupCols; i += nt) {
    const float* src = (i < kGroupCols ? wf : wf2) + i % kGroupCols;
    float a = 0.0f;
    for (int w = 0; w < rt / kWarpRows; ++w) a += src[w * kGroupCols];
    const int c = first_col + i % kGroupCols;
    if (c < cols) stats[(int64_t)(i / kGroupCols) * cols + c] = a * inv_n;
  }
}

__device__ __forceinline__ float finish_one(float s, float s2, float inv_world,
                                            float& var) {
  const float mean = __fmul_rn(s, inv_world);
  var = __fsub_rn(__fmul_rn(s2, inv_world), __fmul_rn(mean, mean));
  return mean;
}

template <int ACT>
__device__ __forceinline__ float normalize(float v, float mean, float scale,
                                           float gm, float bt) {
  return activate<ACT>((v - mean) * scale * gm + bt);
}

// SUMS: a and b are the rows of the all-reduced [2, cols] stats (the ranks'
// sums of E[x] and E[x^2]), and the first row chunk writes mean_out and
// var_out.  Otherwise a and b are mean and var.
template <int ACT, bool VEC, bool SUMS>
__global__ void __launch_bounds__(kLanes * kMaxRowThreads)
bn_apply_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ var_out,
                int rows, int cols, int per_block, float inv_world,
                float eps) {
  const int lane = threadIdx.x, ty = threadIdx.y, rt = blockDim.y;
  const int c0 = blockIdx.y * kGroupCols + 4 * lane;
  if (c0 >= cols) return;  // no barrier below
  const int r0 = blockIdx.x * per_block;
  const int r1 = r0 + per_block < rows ? r0 + per_block : rows;

  // this thread's rows, in flight while it computes its coefficients
  float4 v[kApplyRows];
#pragma unroll
  for (int u = 0; u < kApplyRows; ++u) {
    const int row = r0 + ty + u * rt;
    v[u] = row < r1 ? load4<VEC>(x + (int64_t)row * cols, c0, cols) : zero4();
  }
  float4 mean = load4<VEC>(a, c0, cols), var = load4<VEC>(b, c0, cols);
  if (SUMS) {
    mean.x = finish_one(mean.x, var.x, inv_world, var.x);
    mean.y = finish_one(mean.y, var.y, inv_world, var.y);
    mean.z = finish_one(mean.z, var.z, inv_world, var.z);
    mean.w = finish_one(mean.w, var.w, inv_world, var.w);
    if (blockIdx.x == 0 && ty == 0) {
      store4<VEC>(mean_out, c0, cols, mean);
      store4<VEC>(var_out, c0, cols, var);
    }
  }
  const float4 gm = load4<VEC>(gamma, c0, cols), bt = load4<VEC>(beta, c0, cols);
  const float4 scale = make_float4(rsqrtf(var.x + eps), rsqrtf(var.y + eps),
                                   rsqrtf(var.z + eps), rsqrtf(var.w + eps));
#pragma unroll
  for (int u = 0; u < kApplyRows; ++u) {
    const int row = r0 + ty + u * rt;
    if (row < r1) {
      const float4 o = make_float4(
          normalize<ACT>(v[u].x, mean.x, scale.x, gm.x, bt.x),
          normalize<ACT>(v[u].y, mean.y, scale.y, gm.y, bt.y),
          normalize<ACT>(v[u].z, mean.z, scale.z, gm.z, bt.z),
          normalize<ACT>(v[u].w, mean.w, scale.w, gm.w, bt.w));
      store4<VEC>(y + (int64_t)row * cols, c0, cols, o);
    }
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct ApplyLaunch {
  const float *x, *a, *b, *gamma, *beta;
  float *y, *mean_out, *var_out;
  int rows, cols, row_threads, per_block;
  bool vec, sums;
  float inv_world, eps;
  cudaStream_t stream;

  template <int ACT>
  void run() {
    if (sums)
      vec ? go<ACT, true, true>() : go<ACT, false, true>();
    else
      vec ? go<ACT, true, false>() : go<ACT, false, false>();
  }

  template <int ACT, bool VEC, bool SUMS>
  void go() {
    const dim3 grid((unsigned)((rows + per_block - 1) / per_block),
                    (unsigned)((cols + kGroupCols - 1) / kGroupCols));
    bn_apply_kernel<ACT, VEC, SUMS>
        <<<grid, dim3(kLanes, row_threads), 0, stream>>>(
            x, a, b, gamma, beta, y, mean_out, var_out, rows, cols, per_block,
            inv_world, eps);
  }
};

// The checks of an apply plan (ops/cuda/bn_act.py apply_plan) and of the
// float4 flag that the kernel relies on.
bool valid_apply(const ApplyLaunch& l) {
  const int64_t chunks = ((int64_t)l.rows + l.per_block - 1) / l.per_block;
  const bool vec_ok =
      !l.vec || (l.cols % 4 == 0 && aligned(l.x) && aligned(l.a) &&
                 aligned(l.b) && aligned(l.gamma) && aligned(l.beta) &&
                 aligned(l.y) &&
                 (!l.sums || (aligned(l.mean_out) && aligned(l.var_out))));
  return l.row_threads >= 1 && l.row_threads <= kMaxRowThreads &&
         l.per_block >= 1 && l.per_block <= kApplyRows * l.row_threads &&
         chunks <= 0x7fffffffLL &&
         (l.cols + kGroupCols - 1) / kGroupCols <= 65535 && vec_ok;
}

int launch_apply(ApplyLaunch& l, int act) {
  if (l.rows <= 0 || l.cols <= 0) return 0;
  if (!valid_apply(l)) return (int)cudaErrorInvalidValue;
  if (!gan4j::dispatch_act(act, l)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// stats: a [2, cols] buffer, row 0 E[x], row 1 E[x^2] (the all-reduce then
// takes one contiguous tensor).  row_threads: ops/cuda/bn_act.py
// moments_plan's; vec: x and stats 16-byte aligned and cols % 4 == 0.
// Returns cudaErrorInvalidValue for a plan this kernel cannot run, else the
// launch's error.
extern "C" int gan4j_bn_moments(const void* x, void* stats, int rows, int cols,
                                int row_threads, int vec, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const bool ok = row_threads >= kWarpRows && row_threads <= kMaxRowThreads &&
                  row_threads % kWarpRows == 0 &&
                  (!vec || (cols % 4 == 0 && aligned(x) && aligned(stats)));
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((cols + kGroupCols - 1) / kGroupCols));
  const dim3 block(kLanes, row_threads);
  const float inv_n = 1.0f / (float)rows;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    bn_moments_kernel<true><<<grid, block, 0, s>>>(
        (const float*)x, (float*)stats, rows, cols, inv_n);
  else
    bn_moments_kernel<false><<<grid, block, 0, s>>>(
        (const float*)x, (float*)stats, rows, cols, inv_n);
  return (int)cudaGetLastError();
}

// y = act((x - mean) * rsqrt(var + eps) * gamma + beta).  The plan
// (row_threads, per_block <= kApplyRows * row_threads rows) is ops/cuda/
// bn_act.py apply_plan's; vec: every pointer 16-byte aligned and
// cols % 4 == 0.  act: the codes of bn_common.cuh.  Returns
// cudaErrorInvalidValue for another code or a plan this kernel cannot run,
// else cudaGetLastError().
extern "C" int gan4j_bn_apply(const void* x, const void* mean, const void* var,
                              const void* gamma, const void* beta, void* y,
                              int rows, int cols, float eps, int act,
                              int row_threads, int per_block, int vec,
                              void* stream) {
  ApplyLaunch l{(const float*)x,    (const float*)mean, (const float*)var,
                (const float*)gamma, (const float*)beta, (float*)y,
                nullptr,            nullptr,             rows,
                cols,               row_threads,         per_block,
                vec != 0,           false,               1.0f,
                eps,                (cudaStream_t)stream};
  return launch_apply(l, act);
}

// The same from sums: the [2, cols] stats summed over ``world`` ranks (as
// the all-reduce leaves them).  Writes y and this step's mean and var.
extern "C" int gan4j_bn_apply_sums(const void* x, const void* sums,
                                   const void* gamma, const void* beta, void* y,
                                   void* mean, void* var, int rows, int cols,
                                   int world, float eps, int act,
                                   int row_threads, int per_block, int vec,
                                   void* stream) {
  if (world < 1) return (int)cudaErrorInvalidValue;
  const float* s = (const float*)sums;
  // torch's divide of a CUDA tensor by a Python scalar: a * (1 / b), the
  // reciprocal taken in float
  const float inv_world = 1.0f / (float)world;
  ApplyLaunch l{(const float*)x,     s,                  s + cols,
                (const float*)gamma, (const float*)beta, (float*)y,
                (float*)mean,        (float*)var,        rows,
                cols,                row_threads,        per_block,
                vec != 0,            true,               inv_world,
                eps,                 (cudaStream_t)stream};
  return launch_apply(l, act);
}
