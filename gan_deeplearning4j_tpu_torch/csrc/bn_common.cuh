// The activation set shared by the BN kernels (bn_act.cu,
// bn_moments_apply.cu, bn_act_4d.cu), so their codes cannot drift.  The
// Python side names the same codes in ops/cuda/bn_act.py ACT_CODES.
#pragma once

#include <cuda_runtime.h>

namespace gan4j {

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

// d activate<ACT>(v) / dv, as JAX differentiates the activations of
// ops/activations.py: tanh 1 - tanh^2, the logistic s(1 - s), relu 0 at
// 0, elu exp(v) for v <= 0, leaky relu 1 at 0.
template <int ACT>
__device__ __forceinline__ float activate_grad(float v) {
  if (ACT == TANH) {
    const float t = tanhf(v);
    return 1.0f - t * t;
  }
  if (ACT == SIGMOID) {
    const float s = 1.0f / (1.0f + expf(-v));
    return s * (1.0f - s);
  }
  if (ACT == RELU) return v > 0.0f ? 1.0f : 0.0f;
  if (ACT == ELU) return v > 0.0f ? 1.0f : expf(v);
  if (ACT == LEAKYRELU) return v >= 0.0f ? 1.0f : 0.01f;
  return 1.0f;
}

// The two above for a code known only at run time and the same across a
// launch (a uniform branch an element): one kernel serves every
// activation, where instantiating each would multiply compile time.
__device__ __forceinline__ float activate_code(int act, float v) {
  switch (act) {
    case TANH: return activate<TANH>(v);
    case SIGMOID: return activate<SIGMOID>(v);
    case RELU: return activate<RELU>(v);
    case ELU: return activate<ELU>(v);
    case LEAKYRELU: return activate<LEAKYRELU>(v);
    default: return v;
  }
}

__device__ __forceinline__ float activate_grad_code(int act, float v) {
  switch (act) {
    case TANH: return activate_grad<TANH>(v);
    case SIGMOID: return activate_grad<SIGMOID>(v);
    case RELU: return activate_grad<RELU>(v);
    case ELU: return activate_grad<ELU>(v);
    case LEAKYRELU: return activate_grad<LEAKYRELU>(v);
    default: return 1.0f;
  }
}

inline bool valid_act(int act) { return act >= IDENTITY && act <= LEAKYRELU; }

// Calls launcher.template run<ACT>() for the runtime code ``act``; returns
// false for an unknown code (the caller reports cudaErrorInvalidValue).
template <typename Launcher>
bool dispatch_act(int act, Launcher& launcher) {
  switch (act) {
    case IDENTITY: launcher.template run<IDENTITY>(); return true;
    case TANH: launcher.template run<TANH>(); return true;
    case SIGMOID: launcher.template run<SIGMOID>(); return true;
    case RELU: launcher.template run<RELU>(); return true;
    case ELU: launcher.template run<ELU>(); return true;
    case LEAKYRELU: launcher.template run<LEAKYRELU>(); return true;
    default: return false;
  }
}

}  // namespace gan4j
