// Backward of the nearest-neighbour upsample: dx[B,C,H,W] is the (sh x sw)
// block sum of g[B,C,H*sh,W*sw], f32 (replaces the Pallas kernel _bwd_kernel
// in gan_deeplearning4j_tpu/ops/pallas/dma_pipeline.py, upsample_bwd_dma).
//
// Bound: device memory.  g is read once and dx written once; the adds are
// one per element of g.  One thread per element of dx sums its block in
// row-major order, so the warp's reads of each block row fall on
// neighbouring addresses and every byte of g is fetched once.  The TPU
// kernel's double-buffered DMA and its 0/1-matrix dot for the lane
// gather have no counterpart here: the card's many warps in flight hide
// the load latency, and a strided read costs nothing extra.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void upsample_bwd_kernel(const float* __restrict__ g,
                                    float* __restrict__ dx, int64_t n_out,
                                    int H, int W, int sh, int sw) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  const int64_t row = (int64_t)W * sw;  // one row of g
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += stride) {
    const int w = (int)(i % W);
    const int64_t t = i / W;
    const int h = (int)(t % H);
    const int64_t bc = t / H;
    const float* src = g + (bc * H + h) * sh * row + (int64_t)w * sw;
    float acc = 0.0f;
    for (int a = 0; a < sh; ++a)
      for (int b = 0; b < sw; ++b) acc += src[a * row + b];
    dx[i] = acc;
  }
}

}  // namespace

extern "C" int gan4j_upsample_bwd(const void* g, void* dx, long long bc,
                                  int H, int W, int sh, int sw,
                                  void* stream) {
  const long long n_out = bc * H * W;
  if (n_out <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_out + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  upsample_bwd_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)g, (float*)dx, (int64_t)n_out, H, W, sh, sw);
  return (int)cudaGetLastError();
}
