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

namespace {

enum Act { IDENTITY = 0, TANH = 1, SIGMOID = 2, RELU = 3, ELU = 4,
           LEAKYRELU = 5 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == TANH) return tanhf(v);
  if (ACT == SIGMOID) return 1.0f / (1.0f + expf(-v));
  if (ACT == RELU) return v > 0.0f ? v : 0.0f;
  if (ACT == ELU) return v > 0.0f ? v : expm1f(v);
  if (ACT == LEAKYRELU) return v >= 0.0f ? v : 0.01f * v;
  return v;
}

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

template <int ACT>
void launch(const float* x, const float* gamma, const float* beta, float* y,
            float* mean, float* var, int rows, int cols, float eps,
            cudaStream_t stream) {
  const int threads = 32;
  const int blocks = (cols + threads - 1) / threads;
  bn_act_kernel<ACT><<<blocks, threads, 0, stream>>>(x, gamma, beta, y, mean,
                                                     var, rows, cols, eps);
}

}  // namespace

// act: 0 identity, 1 tanh, 2 sigmoid, 3 relu, 4 elu, 5 leakyrelu.
// Returns cudaErrorInvalidValue for another code, else cudaGetLastError().
extern "C" int gan4j_bn_act(const void* x, const void* gamma,
                            const void* beta, void* y, void* mean, void* var,
                            int rows, int cols, float eps, int act,
                            void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const float* xf = (const float*)x;
  const float* gf = (const float*)gamma;
  const float* bf = (const float*)beta;
  float* yf = (float*)y;
  float* mf = (float*)mean;
  float* vf = (float*)var;
  cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case IDENTITY: launch<IDENTITY>(xf, gf, bf, yf, mf, vf, rows, cols, eps, s); break;
    case TANH: launch<TANH>(xf, gf, bf, yf, mf, vf, rows, cols, eps, s); break;
    case SIGMOID: launch<SIGMOID>(xf, gf, bf, yf, mf, vf, rows, cols, eps, s); break;
    case RELU: launch<RELU>(xf, gf, bf, yf, mf, vf, rows, cols, eps, s); break;
    case ELU: launch<ELU>(xf, gf, bf, yf, mf, vf, rows, cols, eps, s); break;
    case LEAKYRELU: launch<LEAKYRELU>(xf, gf, bf, yf, mf, vf, rows, cols, eps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
