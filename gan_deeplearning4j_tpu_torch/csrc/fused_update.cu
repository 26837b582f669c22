// DL4J's L2 -> elementwise clip -> RmsProp chain over every leaf of one
// graph update, in one launch (replaces the Pallas kernel _chain_kernel in
// gan_deeplearning4j_tpu/ops/pallas/fused_update.py, which the TPU package
// runs once per leaf).
//
//   g  = clip(g + l2*p, +-clip)
//   c' = rho*c + (1-rho)*g*g
//   p' = p - lr*g*rsqrt(c' + eps)
//
// Bound: device memory.  Each element reads p, g, c and writes p', c'
// (20 bytes) for about ten flops, far below the card's ratio of flops to
// bytes.  A graph's leaves are mostly tiny (biases, BN vectors) beside a few
// large weights, so a launch per leaf is mostly fixed cost: here one launch
// takes a table of all the leaves (a multi-tensor kernel).
//   - The table (Table below) is the kernel's only parameter, passed by
//     value as a __grid_constant__ struct: no copy to the device, no
//     synchronisation.  It stays under the classic 4 KB parameter limit
//     (kMaxLeaves leaves; ops/cuda/fused_update.py splits longer lists).
//   - Leaf i owns blocks [first_block[i], first_block[i+1]), one chunk of
//     kChunk elements each; a block finds its leaf by a binary search over
//     first_block (uniform across the block, read from the constant bank).
//   - A leaf whose five pointers are 16-byte aligned (vec[i]) moves float4s,
//     each thread keeping all its loads of the chunk in flight before it
//     computes; the rest of the leaf's last chunk (n % 4 elements) and every
//     element of an unaligned leaf (the data-parallel path's gradients are
//     split views of one buffer, at any element offset) take the scalar
//     path.  Both paths run the same per-element code, so they give the
//     same bits.
//   - Outputs go to two flat buffers (p_out, c_out) at each leaf's offset, a
//     multiple of 4 elements; out of place, so the caller keeps the old
//     leaves.
// The table is built in Python (launch_plan) and checked again here before
// the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ops/cuda/fused_update.py MAX_LEAVES, CHUNK, THREADS
constexpr int kMaxLeaves = 48;
constexpr int kChunk = 4096;
constexpr int kThreads = 256;
constexpr int kVecPerThread = kChunk / (4 * kThreads);
constexpr int kScalarPerThread = kChunk / kThreads;

// The leaf table; ops/cuda/fused_update.py _Table mirrors this layout field
// for field (gan4j_fused_rmsprop_table_bytes lets it check the size).
struct Table {
  const float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  const float* c[kMaxLeaves];
  float* p_out;
  float* c_out;
  long long n[kMaxLeaves];       // elements of the leaf
  long long offset[kMaxLeaves];  // of the leaf in p_out and c_out
  int first_block[kMaxLeaves + 1];  // [n_leaves] = the grid
  float lr[kMaxLeaves];
  float rho[kMaxLeaves];
  float one_minus_rho[kMaxLeaves];
  float eps[kMaxLeaves];
  float l2[kMaxLeaves];
  float clip;
  int has_clip;
  int n_leaves;
  unsigned char vec[kMaxLeaves];  // 1: all five pointers 16-byte aligned
};
static_assert(sizeof(Table) <= 4096, "the leaf table must fit the 4 KB limit");

struct Rates {
  float lr, rho, one_minus_rho, eps, l2, clip;
  int has_clip;

  // the chain of one element, in the order of the single-leaf kernel it
  // replaces and of the plain version
  __device__ __forceinline__ void chain(float pi, float gi, float c,
                                        float& p_new, float& c_new) const {
    if (l2 != 0.0f) gi = gi + l2 * pi;
    // a comparison clip keeps NaN as NaN, like jnp.clip and torch.clamp
    if (has_clip) gi = gi < -clip ? -clip : (gi > clip ? clip : gi);
    const float ci = rho * c + one_minus_rho * gi * gi;
    p_new = pi - lr * gi * rsqrtf(ci + eps);
    c_new = ci;
  }
};

__global__ void __launch_bounds__(kThreads)
    rmsprop_multi_kernel(const __grid_constant__ Table t) {
  // the leaf of this block: the last one whose first block is <= blockIdx.x
  // (a leaf of no elements has no block and is passed over)
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int leaf = lo;
  const Rates r{t.lr[leaf], t.rho[leaf], t.one_minus_rho[leaf], t.eps[leaf],
                t.l2[leaf], t.clip, t.has_clip};
  const float* __restrict__ p = t.p[leaf];
  const float* __restrict__ g = t.g[leaf];
  const float* __restrict__ c = t.c[leaf];
  float* __restrict__ p_out = t.p_out + t.offset[leaf];
  float* __restrict__ c_out = t.c_out + t.offset[leaf];
  const long long begin = (long long)(b - t.first_block[leaf]) * kChunk;
  const long long n = t.n[leaf];
  const long long end = begin + kChunk < n ? begin + kChunk : n;

  long long scalar_begin = begin;
  if (t.vec[leaf]) {
    // begin is a multiple of kChunk, so every float4 below is aligned
    const long long vec_end = begin + ((end - begin) & ~3LL);
    float4 pv[kVecPerThread], gv[kVecPerThread], cv[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const long long i = begin + 4LL * (threadIdx.x + k * kThreads);
      if (i < vec_end) {
        pv[k] = *reinterpret_cast<const float4*>(p + i);
        gv[k] = *reinterpret_cast<const float4*>(g + i);
        cv[k] = *reinterpret_cast<const float4*>(c + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const long long i = begin + 4LL * (threadIdx.x + k * kThreads);
      if (i < vec_end) {
        float4 po, co;
        r.chain(pv[k].x, gv[k].x, cv[k].x, po.x, co.x);
        r.chain(pv[k].y, gv[k].y, cv[k].y, po.y, co.y);
        r.chain(pv[k].z, gv[k].z, cv[k].z, po.z, co.z);
        r.chain(pv[k].w, gv[k].w, cv[k].w, po.w, co.w);
        *reinterpret_cast<float4*>(p_out + i) = po;
        *reinterpret_cast<float4*>(c_out + i) = co;
      }
    }
    scalar_begin = vec_end;
  }
#pragma unroll 4
  for (int k = 0; k < kScalarPerThread; ++k) {
    const long long i = scalar_begin + threadIdx.x + (long long)k * kThreads;
    if (i >= end) break;
    r.chain(p[i], g[i], c[i], p_out[i], c_out[i]);
  }
}

bool aligned(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The checks of a table that the kernel relies on: a leaf count in range,
// first blocks that start at 0 and never fall, each leaf's blocks exactly
// covering its elements, offsets on 4-element boundaries, and vec set only
// where all five pointers are aligned.
bool valid(const Table& t) {
  if (t.n_leaves < 1 || t.n_leaves > kMaxLeaves || t.first_block[0] != 0)
    return false;
  if (!aligned(t.p_out) || !aligned(t.c_out)) return false;
  for (int i = 0; i < t.n_leaves; ++i) {
    const long long blocks = (t.n[i] + kChunk - 1) / kChunk;
    if (t.n[i] < 0 || t.offset[i] % 4 != 0 ||
        t.first_block[i + 1] - t.first_block[i] != blocks)
      return false;
    if (t.vec[i] && !(aligned(t.p[i]) && aligned(t.g[i]) && aligned(t.c[i]) &&
                      aligned(t.p_out + t.offset[i]) &&
                      aligned(t.c_out + t.offset[i])))
      return false;
  }
  return true;
}

}  // namespace

extern "C" int gan4j_fused_rmsprop_table_bytes() { return (int)sizeof(Table); }

// Launches the chain over the table's leaves on ``stream``.  Returns
// cudaErrorInvalidValue for a table the kernel cannot run, else the
// launch's own error.
extern "C" int gan4j_fused_rmsprop_multi(const void* table, void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  if (!valid(t)) return (int)cudaErrorInvalidValue;
  const int grid = t.first_block[t.n_leaves];
  if (grid == 0) return 0;
  rmsprop_multi_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
