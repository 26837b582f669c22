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
