// What the single-pass BN kernels (bn_act.cu, bn_act_4d.cu) share: the
// cluster reduction over distributed shared memory, the plan limits they
// check, and the checked cluster launch.
//
// A channel (4-D) or a 32-column feature group (2-D) is split over the K
// blocks of one thread-block cluster (K <= 8, the portable size).  Each
// block reduces its part to partial sums in its own shared memory; after a
// cluster barrier every block reads the K partials through
// cluster.map_shared_rank, always in rank order, so every block of the
// cluster computes bit-identical moments and two launches give the same
// bits.  No atomics.  A block must not exit while another block may still
// read its shared memory, so each kernel ends with a second cluster
// barrier.
//
// The plans are computed in Python (ops/cuda/bn_act.py, ops/cuda/
// bn_act_4d.py) and checked here: a plan this card cannot run returns an
// error code, it is never launched silently into nothing.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace gan4j {

namespace cg = cooperative_groups;

// the portable cluster size; ops/cuda/bn_act.py MAX_CLUSTER
constexpr int kMaxCluster = 8;
// dynamic shared memory a plan may ask for: the H100's 232,448 bytes a
// block can use, less 8 KB kept for the kernels' static shared memory;
// ops/cuda/bn_act.py MAX_DYNAMIC_SMEM
constexpr int kMaxDynamicSmem = 232448 - 8192;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the cluster's ranks, in rank order, of element ``i`` of the
// array ``local`` that every block holds at the same shared address.
__device__ __forceinline__ float cluster_sum(const cg::cluster_group& cluster,
                                             float* local, int i, int k) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = r < k ? cluster.map_shared_rank(local, r)[i] : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < k) s += v[r];
  return s;
}

inline bool valid_cluster(int k) {
  return k == 1 || k == 2 || k == 4 || k == 8;
}

// Lets ``kernel`` take up to kMaxDynamicSmem of dynamic shared memory.  The
// caller keeps the result in a function-local static, so it runs once per
// kernel instantiation.
template <typename Kernel>
cudaError_t allow_max_dynamic_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxDynamicSmem);
}

// cudaSuccess if one cluster of ``cfg`` fits on the card at all, else
// cudaErrorInvalidConfiguration or the query's own error.  The answer for a
// (kernel, cluster size, block, shared memory) is asked of
// cudaOccupancyMaxActiveClusters once and kept: it does not change, and a
// launch recorded into a CUDA graph (stream capture) then makes no query.
template <typename Kernel>
cudaError_t cluster_fits(Kernel kernel, const cudaLaunchConfig_t& cfg, int k) {
  using Key = std::tuple<const void*, int, unsigned, unsigned, unsigned, size_t>;
  static std::mutex mu;
  static std::map<Key, cudaError_t> known;
  const Key key{reinterpret_cast<const void*>(kernel), k, cfg.blockDim.x,
                cfg.blockDim.y, cfg.blockDim.z, cfg.dynamicSmemBytes};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
  known.emplace(key, e);
  return e;
}

// Launches ``kernel`` as clusters of ``k`` blocks along x with
// cudaLaunchKernelEx and a cluster-dimension attribute.  For k > 1 it first
// checks (cluster_fits) that one such cluster fits on the card at all, and
// returns cudaErrorInvalidConfiguration if none does.  k = 1 launches
// without the attribute: the block is then its own implicit cluster, and
// the launch costs less.  Returns the launch's own error.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block,
                           int k, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;
  if (k > 1) {
    const cudaError_t e = cluster_fits(kernel, cfg, k);
    if (e != cudaSuccess) return e;
  }
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace gan4j
