// DL4J's L2 -> elementwise clip -> RmsProp chain over one f32 leaf, in one
// pass (replaces the Pallas kernel _chain_kernel in
// gan_deeplearning4j_tpu/ops/pallas/fused_update.py).
//
//   g  = clip(g + l2*p, +-clip)
//   c' = rho*c + (1-rho)*g*g
//   p' = p - lr*g*rsqrt(c' + eps)
//
// Bound: device memory.  Each element reads p, g, c and writes p', c'
// (20 bytes) for about ten flops, far below the card's ratio of flops to
// bytes.  The design moves each byte once: a grid-stride loop with
// neighbouring threads on neighbouring addresses, nothing kept between
// elements, out of place so the caller keeps the old leaf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rmsprop_chain_kernel(
    const float* __restrict__ p, const float* __restrict__ g,
    const float* __restrict__ c, float* __restrict__ p_out,
    float* __restrict__ c_out, int64_t n, float lr, float rho,
    float one_minus_rho, float eps, float l2, float clip, int has_clip) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pi = p[i];
    float gi = g[i];
    if (l2 != 0.0f) gi = gi + l2 * pi;
    // a comparison clip keeps NaN as NaN, like jnp.clip and torch.clamp
    if (has_clip) gi = gi < -clip ? -clip : (gi > clip ? clip : gi);
    const float ci = rho * c[i] + one_minus_rho * gi * gi;
    p_out[i] = pi - lr * gi * rsqrtf(ci + eps);
    c_out[i] = ci;
  }
}

}  // namespace

extern "C" int gan4j_fused_rmsprop(const void* p, const void* g,
                                   const void* c, void* p_out, void* c_out,
                                   long long n, float lr, float rho,
                                   float one_minus_rho, float eps, float l2,
                                   float clip, int has_clip, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  rmsprop_chain_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)p, (const float*)g, (const float*)c, (float*)p_out,
      (float*)c_out, (int64_t)n, lr, rho, one_minus_rho, eps, l2, clip,
      has_clip);
  return (int)cudaGetLastError();
}
