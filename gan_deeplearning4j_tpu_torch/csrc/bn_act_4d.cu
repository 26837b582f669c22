// Train-mode per-channel BatchNorm + activation over a contiguous
// [B, C, H, W] f32 tensor, single device (replaces the Pallas kernel
// _fused_kernel_4d in gan_deeplearning4j_tpu/ops/pallas/bn_act.py,
// fused_bn_act_train_4d).
//
//   mean[c] = E[x[:, c]], var[c] = E[x[:, c]^2] - mean[c]^2   (biased)
//   y       = act((x - mean) * rsqrt(var + eps) * gamma + beta)
//
// Bound: device memory, x read and y written once (8 bytes per element).
// The TPU kernel keeps a channel block in VMEM and reads x once; this one
// does the same on Hopper with a thread-block cluster per channel.  One
// launch, no atomics:
//   - channel c belongs to cluster c of K blocks (K <= 8); block rank r owns
//     a contiguous run of the channel's B*H*W elements in (b, hw) order, in
//     units of VEC floats (float4 when H*W % 4 == 0 and x, y are 16-byte
//     aligned);
//   - each thread walks its units with a cursor that steps (row, column)
//     without a divide, loads them (16 bytes a thread), keeps them in the
//     block's dynamic shared memory and sums x and x*x;
//   - the block reduces its two sums; after a cluster barrier each block
//     reads the K partials through distributed shared memory in rank order
//     (bn_cluster.cuh), so all blocks hold the same mean and var;
//   - it normalizes from shared memory and writes y once.
// A channel too large for K blocks' shared memory takes the streamed branch
// of the same kernel (resident = 0): the sums on a first walk, the cluster
// reduction, then a second walk over x in device memory.
// The launch plan (K, units per block, threads, VEC, shared memory, branch)
// comes from ops/cuda/bn_act_4d.py launch_plan and is checked here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_cluster.cuh"
#include "bn_common.cuh"

namespace {

using gan4j::activate;
namespace cg = gan4j::cg;

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;  // loads a thread keeps in flight

template <int VEC>
struct Unit;
template <>
struct Unit<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static void sums(T v, float& s, float& s2) {
    s += v;
    s2 = fmaf(v, v, s2);
  }
  template <int ACT>
  __device__ static T norm(T v, float mean, float scale, float gm, float bt) {
    return activate<ACT>((v - mean) * scale * gm + bt);
  }
};
template <>
struct Unit<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void sums(T v, float& s, float& s2) {
    s += (v.x + v.y) + (v.z + v.w);
    s2 = fmaf(v.x, v.x, s2);
    s2 = fmaf(v.y, v.y, s2);
    s2 = fmaf(v.z, v.z, s2);
    s2 = fmaf(v.w, v.w, s2);
  }
  template <int ACT>
  __device__ static T norm(T v, float mean, float scale, float gm, float bt) {
    return make_float4(Unit<1>::norm<ACT>(v.x, mean, scale, gm, bt),
                       Unit<1>::norm<ACT>(v.y, mean, scale, gm, bt),
                       Unit<1>::norm<ACT>(v.z, mean, scale, gm, bt),
                       Unit<1>::norm<ACT>(v.w, mean, scale, gm, bt));
  }
};

// Position of a unit of the channel: its column in the row and its offset
// from the channel's first unit (rows are row_stride units apart).  One
// 64-bit divide when a thread starts; advance() steps by the block's
// thread count without one.
struct Cursor {
  int64_t off;
  int col;

  __device__ Cursor(int64_t i, int hw, int64_t row_stride) {
    const int64_t row = i / hw;
    col = (int)(i - row * hw);
    off = row * row_stride + col;
  }
  // dcol = T % hw, doff = (T / hw) * row_stride + dcol,
  // wrap = row_stride - hw
  __device__ void advance(int hw, int dcol, int64_t doff, int64_t wrap) {
    col += dcol;
    off += doff;
    if (col >= hw) {
      col -= hw;
      off += wrap;
    }
  }
};

template <int ACT, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 3)
bn_act_4d_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ var_out,
                 int k, int hw, int64_t row_stride, int64_t units,
                 int64_t per_block, int resident, float inv_n, float eps) {
  using U = Unit<VEC>;
  using T = typename U::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  __shared__ float warp_s[kMaxThreads / 32], warp_s2[kMaxThreads / 32];
  __shared__ float part[2];  // this block's sum of x and of x*x
  __shared__ float coef[2];  // the channel's mean and rsqrt(var + eps)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / k;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t begin = (int64_t)rank * per_block;
  const int64_t end = begin + per_block < units ? begin + per_block : units;
  const int64_t mine = end > begin ? end - begin : 0;
  const T* xc = reinterpret_cast<const T*>(x) + (int64_t)c * hw;
  T* yc = reinterpret_cast<T*>(y) + (int64_t)c * hw;
  const int dcol = nt % hw;
  const int64_t doff = (int64_t)(nt / hw) * row_stride + dcol;
  const int64_t wrap = row_stride - hw;
  // read now, so their latency is not paid after the reduction
  const float gm = gamma[c], bt = beta[c];

  // one walk over x: sums, and the units kept in shared memory
  const Cursor start(begin + tid, hw, row_stride);
  float s = 0.0f, s2 = 0.0f;
  {
    Cursor cur = start;
    for (int64_t j0 = tid; j0 < mine; j0 += (int64_t)kUnroll * nt) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = j0 + (int64_t)u * nt < mine ? xc[cur.off] : U::zero();
        cur.advance(hw, dcol, doff, wrap);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + (int64_t)u * nt;
        if (j < mine) {
          if (resident) stage[j] = v[u];
          U::sums(v[u], s, s2);
        }
      }
    }
  }
  s = gan4j::warp_sum(s);
  s2 = gan4j::warp_sum(s2);
  if (lane == 0) {
    warp_s[warp] = s;
    warp_s2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = nt >> 5;
    s = lane < nw ? warp_s[lane] : 0.0f;
    s2 = lane < nw ? warp_s2[lane] : 0.0f;
    s = gan4j::warp_sum(s);
    s2 = gan4j::warp_sum(s2);
    if (lane == 0) {
      part[0] = s;
      part[1] = s2;
    }
  }
  // every block's partials are written and visible to the cluster
  cluster.sync();
  if (tid == 0) {
    const float mean = gan4j::cluster_sum(cluster, part, 0, k) * inv_n;
    const float var =
        gan4j::cluster_sum(cluster, part, 1, k) * inv_n - mean * mean;
    coef[0] = mean;
    coef[1] = rsqrtf(var + eps);
    if (rank == 0) {
      mean_out[c] = mean;
      var_out[c] = var;
    }
  }
  __syncthreads();
  const float mean = coef[0], scale = coef[1];
  {
    Cursor cur = start;
    for (int64_t j = tid; j < mine; j += nt) {
      const T v = resident ? stage[j] : xc[cur.off];
      yc[cur.off] = U::template norm<ACT>(v, mean, scale, gm, bt);
      cur.advance(hw, dcol, doff, wrap);
    }
  }
  // no block leaves while another may still read its partials
  cluster.sync();
}

struct Launch {
  const float *x, *gamma, *beta;
  float *y, *mean, *var;
  int batch, channels, hw, k, threads, vec;
  int64_t per_block;
  int smem, resident;
  float eps;
  cudaStream_t stream;
  cudaError_t err;

  template <int ACT, int VEC>
  void launch() {
    static const cudaError_t attr =
        gan4j::allow_max_dynamic_smem(bn_act_4d_kernel<ACT, VEC>);
    if (attr != cudaSuccess) {
      err = attr;
      return;
    }
    const int hw_v = hw / VEC;
    const int64_t units = (int64_t)batch * hw_v;
    err = gan4j::launch_cluster(
        bn_act_4d_kernel<ACT, VEC>, dim3(channels * k), dim3(threads), k,
        (size_t)smem, stream, x, gamma, beta, y, mean, var, k, hw_v,
        (int64_t)channels * hw_v, units, per_block, resident,
        1.0f / ((float)batch * (float)hw), eps);
  }

  template <int ACT>
  void run() {
    if (vec == 4)
      launch<ACT, 4>();
    else
      launch<ACT, 1>();
  }
};

}  // namespace

// The plan (k, per_block, threads, vec, smem, resident) is
// ops/cuda/bn_act_4d.py launch_plan's.  Returns cudaErrorInvalidValue for
// an activation code or a plan this kernel cannot run, else the launch's
// error (cudaErrorInvalidConfiguration when no cluster of k blocks fits).
extern "C" int gan4j_bn_act_4d(const void* x, const void* gamma,
                               const void* beta, void* y, void* mean,
                               void* var, int batch, int channels, int hw,
                               float eps, int act, int k, long long per_block,
                               int threads, int vec, int smem, int resident,
                               void* stream) {
  if (batch <= 0 || channels <= 0 || hw <= 0) return 0;
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)y) & 15) == 0 && hw % 4 == 0;
  const int64_t units = (int64_t)batch * (hw / (vec > 0 ? vec : 1));
  const bool ok =
      gan4j::valid_cluster(k) && threads >= 32 &&
      threads <= kMaxThreads && threads % 32 == 0 &&
      (vec == 1 || (vec == 4 && aligned)) && per_block >= 1 &&
      per_block * k >= units && (int64_t)channels * k <= 0x7fffffffLL &&
      (resident ? smem == per_block * vec * 4 &&
                      smem <= gan4j::kMaxDynamicSmem
                : smem == 0);
  if (!ok) return (int)cudaErrorInvalidValue;
  Launch l{(const float*)x, (const float*)gamma, (const float*)beta,
           (float*)y,       (float*)mean,        (float*)var,
           batch,           channels,            hw,
           k,               threads,             vec,
           (int64_t)per_block, smem,             resident,
           eps,             (cudaStream_t)stream, cudaSuccess};
  if (!gan4j::dispatch_act(act, l)) return (int)cudaErrorInvalidValue;
  return (int)l.err;
}
