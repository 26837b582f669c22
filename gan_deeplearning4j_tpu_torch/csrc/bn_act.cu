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
