// Train-mode BatchNorm + activation over a row-major [B, F] f32 matrix,
// single device (replaces the Pallas kernel _fused_kernel in
// gan_deeplearning4j_tpu/ops/pallas/bn_act.py, fused_bn_act_train with
// axis_name=None).
//
//   mean = sum(x)/B, var = sum(x*x)/B - mean^2   (biased, per feature)
//   y    = act((x - mean) * rsqrt(var + eps) * gamma + beta)
//
// Bound: device memory.  x is read and y written once (8 bytes per element
// for about ten flops); mean and var are F floats each.  One thread owns
// one feature column, so the 32 threads of a warp read 32 neighbouring
// floats of a row at each step.  The column is walked twice: once for the
// two sums (in f32 registers), once to write y; the second walk finds x in
// cache for the main path's sizes.  Small blocks spread the columns of a
// [200, 6272] input over more of the card's SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_common.cuh"

namespace {

using gan4j::activate;

template <int ACT>
__global__ void bn_act_kernel(const float* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              float* __restrict__ y,
                              float* __restrict__ mean_out,
                              float* __restrict__ var_out, int rows,
                              int cols, float eps) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= cols) return;
  const float* col = x + f;
  float s = 0.0f, s2 = 0.0f;
#pragma unroll 8
  for (int b = 0; b < rows; ++b) {
    const float v = col[(int64_t)b * cols];
    s += v;
    s2 += v * v;
  }
  const float inv_n = 1.0f / (float)rows;
  const float mean = s * inv_n;
  const float var = s2 * inv_n - mean * mean;
  const float scale = rsqrtf(var + eps);
  const float gm = gamma[f];
  const float bt = beta[f];
  float* out = y + f;
#pragma unroll 8
  for (int b = 0; b < rows; ++b) {
    const int64_t k = (int64_t)b * cols;
    out[k] = activate<ACT>((col[k] - mean) * scale * gm + bt);
  }
  mean_out[f] = mean;
  var_out[f] = var;
}

struct Launch {
  const float *x, *gamma, *beta;
  float *y, *mean, *var;
  int rows, cols;
  float eps;
  cudaStream_t stream;

  template <int ACT>
  void run() {
    const int threads = 32;
    const int blocks = (cols + threads - 1) / threads;
    bn_act_kernel<ACT><<<blocks, threads, 0, stream>>>(x, gamma, beta, y, mean,
                                                       var, rows, cols, eps);
  }
};

}  // namespace

// act: 0 identity, 1 tanh, 2 sigmoid, 3 relu, 4 elu, 5 leakyrelu.
// Returns cudaErrorInvalidValue for another code, else cudaGetLastError().
extern "C" int gan4j_bn_act(const void* x, const void* gamma,
                            const void* beta, void* y, void* mean, void* var,
                            int rows, int cols, float eps, int act,
                            void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  Launch l{(const float*)x, (const float*)gamma, (const float*)beta,
           (float*)y,       (float*)mean,        (float*)var,
           rows,            cols,                eps,
           (cudaStream_t)stream};
  if (!gan4j::dispatch_act(act, l)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
