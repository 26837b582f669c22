// The data-parallel (sync-BN) pair of train-mode BatchNorm + activation
// over a rank's row-major [Bl, F] f32 block.  Replaces the Pallas kernels
// _moments_kernel and _apply_kernel in gan_deeplearning4j_tpu/ops/pallas/
// bn_act.py (fused_bn_act_train with an axis_name).  The caller runs
//
//   gan4j_bn_moments: mean = sum(x)/Bl, m2 = sum(x*x)/Bl   (per feature)
//   all-reduce mean of [mean; m2] over the ranks, var = m2 - mean^2
//   gan4j_bn_apply:   y = act((x - mean) * rsqrt(var + eps) * gamma + beta)
//
// so the global moments sit between the two kernels, as the pmean does in
// the TPU version.  The one-pass E[x], E[x^2] form (not Welford) is the
// reference's: var is taken after the reduction over ranks.
//
// Bound: device memory.  Moments read x once (4 bytes per element), apply
// reads x and writes y once (8 bytes per element).
//
// Moments: a block of 32 x 8 threads owns 32 neighbouring feature columns;
// the 8 threads of a column take every 8th row, so a warp reads 32
// neighbouring floats of one row at each step and a [100, 6272] block runs
// 50k threads (one thread per column would leave 6k threads on 132 SMs).
// The 8 partial sums of a column meet in shared memory.
// Apply: one thread per element (grid-stride), the four per-feature
// vectors read through the cache.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_common.cuh"

namespace {

using gan4j::activate;

constexpr int kCols = 32;        // feature columns per block (one warp wide)
constexpr int kRowThreads = 8;   // threads per column

__global__ void bn_moments_kernel(const float* __restrict__ x,
                                  float* __restrict__ mean_out,
                                  float* __restrict__ m2_out, int rows,
                                  int cols) {
  __shared__ float sh_s[kRowThreads][kCols];
  __shared__ float sh_s2[kRowThreads][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int f = blockIdx.x * kCols + tx;
  float s = 0.0f, s2 = 0.0f;
  if (f < cols) {
    for (int b = ty; b < rows; b += kRowThreads) {
      const float v = x[(int64_t)b * cols + f];
      s += v;
      s2 += v * v;
    }
  }
  sh_s[ty][tx] = s;
  sh_s2[ty][tx] = s2;
  __syncthreads();
#pragma unroll
  for (int half = kRowThreads / 2; half > 0; half >>= 1) {
    if (ty < half) {
      sh_s[ty][tx] += sh_s[ty + half][tx];
      sh_s2[ty][tx] += sh_s2[ty + half][tx];
    }
    __syncthreads();
  }
  if (ty == 0 && f < cols) {
    const float inv_n = 1.0f / (float)rows;
    mean_out[f] = sh_s[0][tx] * inv_n;
    m2_out[f] = sh_s2[0][tx] * inv_n;
  }
}

template <int ACT>
__global__ void bn_apply_kernel(const float* __restrict__ x,
                                const float* __restrict__ mean,
                                const float* __restrict__ var,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                float* __restrict__ y, int64_t n, int cols,
                                float eps) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int f = (int)(i % cols);
    const float v = (x[i] - mean[f]) * rsqrtf(var[f] + eps);
    y[i] = activate<ACT>(v * gamma[f] + beta[f]);
  }
}

struct ApplyLaunch {
  const float *x, *mean, *var, *gamma, *beta;
  float* y;
  int64_t n;
  int cols;
  float eps;
  cudaStream_t stream;

  template <int ACT>
  void run() {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 65535) blocks = 65535;
    bn_apply_kernel<ACT><<<(unsigned)blocks, threads, 0, stream>>>(
        x, mean, var, gamma, beta, y, n, cols, eps);
  }
};

}  // namespace

// mean and m2 may be two rows of one [2, cols] buffer (the all-reduce
// then takes one contiguous tensor).  Returns cudaGetLastError().
extern "C" int gan4j_bn_moments(const void* x, void* mean, void* m2, int rows,
                                int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const dim3 block(kCols, kRowThreads);
  const dim3 grid((cols + kCols - 1) / kCols);
  bn_moments_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)mean, (float*)m2, rows, cols);
  return (int)cudaGetLastError();
}

// act: the codes of bn_common.cuh.  Returns cudaErrorInvalidValue for
// another code, else cudaGetLastError().
extern "C" int gan4j_bn_apply(const void* x, const void* mean,
                              const void* var, const void* gamma,
                              const void* beta, void* y, int rows, int cols,
                              float eps, int act, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  ApplyLaunch l{(const float*)x,     (const float*)mean, (const float*)var,
                (const float*)gamma, (const float*)beta, (float*)y,
                (int64_t)rows * cols, cols,              eps,
                (cudaStream_t)stream};
  if (!gan4j::dispatch_act(act, l)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
