// Train-mode per-channel BatchNorm + activation over a contiguous
// [B, C, H, W] f32 tensor, single device (replaces the Pallas kernel
// _fused_kernel_4d in gan_deeplearning4j_tpu/ops/pallas/bn_act.py,
// fused_bn_act_train_4d).
//
//   mean[c] = E[x[:, c]], var[c] = E[x[:, c]^2] - mean[c]^2   (biased)
//   y       = act((x - mean) * rsqrt(var + eps) * gamma + beta)
//
// Bound: device memory, x read and y written once (8 bytes per element).
// One block per channel walks the channel's B*H*W elements (B rows of H*W
// contiguous floats, C*H*W apart) twice: once for the two sums, reduced
// across the block by warp shuffles and shared memory, once to write y.
// The second walk mostly hits L2 (a whole input of the benchmark shapes is
// 4-34 MB against the H100's 50 MB).  The TPU kernel's 8-channel VMEM
// block and its VMEM-size gate are layout, not math: this kernel takes
// every shape.  At C = 64 only 64 of the 132 SMs have a block; splitting a
// channel over several blocks is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_common.cuh"

namespace {

using gan4j::activate;

constexpr int kThreads = 512;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
bn_act_4d_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ var_out,
                 int batch, int channels, int hw, float eps) {
  __shared__ float red_s[kThreads / 32];
  __shared__ float red_s2[kThreads / 32];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n = (int64_t)batch * hw;
  const int64_t row_stride = (int64_t)channels * hw;
  const float* xc = x + (int64_t)c * hw;
  float* yc = y + (int64_t)c * hw;

  float s = 0.0f, s2 = 0.0f;
  for (int64_t j = tid; j < n; j += kThreads) {
    const int64_t b = j / hw;
    const float v = xc[b * row_stride + (j - b * hw)];
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red_s[warp] = s;
    red_s2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? red_s[lane] : 0.0f;
    s2 = lane < kThreads / 32 ? red_s2[lane] : 0.0f;
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red_s[0] = s;
      red_s2[0] = s2;
    }
  }
  __syncthreads();
  const float inv_n = 1.0f / (float)n;
  const float mean = red_s[0] * inv_n;
  const float var = red_s2[0] * inv_n - mean * mean;
  const float scale = rsqrtf(var + eps);
  const float gm = gamma[c];
  const float bt = beta[c];
  for (int64_t j = tid; j < n; j += kThreads) {
    const int64_t b = j / hw;
    const int64_t k = b * row_stride + (j - b * hw);
    yc[k] = activate<ACT>((xc[k] - mean) * scale * gm + bt);
  }
  if (tid == 0) {
    mean_out[c] = mean;
    var_out[c] = var;
  }
}

struct Launch {
  const float *x, *gamma, *beta;
  float *y, *mean, *var;
  int batch, channels, hw;
  float eps;
  cudaStream_t stream;

  template <int ACT>
  void run() {
    bn_act_4d_kernel<ACT><<<channels, kThreads, 0, stream>>>(
        x, gamma, beta, y, mean, var, batch, channels, hw, eps);
  }
};

}  // namespace

// act: the codes of bn_common.cuh.  Returns cudaErrorInvalidValue for
// another code, else cudaGetLastError().
extern "C" int gan4j_bn_act_4d(const void* x, const void* gamma,
                               const void* beta, void* y, void* mean,
                               void* var, int batch, int channels, int hw,
                               float eps, int act, void* stream) {
  if (batch <= 0 || channels <= 0 || hw <= 0) return 0;
  Launch l{(const float*)x, (const float*)gamma, (const float*)beta,
           (float*)y,       (float*)mean,        (float*)var,
           batch,           channels,            hw,
           eps,             (cudaStream_t)stream};
  if (!gan4j::dispatch_act(act, l)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
