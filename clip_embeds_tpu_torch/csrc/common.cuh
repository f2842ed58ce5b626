// Helpers shared by the port's hand-written Hopper kernels.
//
// Built with nvcc for sm_90a into one shared library with a plain C
// interface (ops/_build.py loads it with ctypes). No PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cet {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 f2bf(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

enum Act { ACT_QUICK = 0, ACT_ERF = 1, ACT_TANH = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_QUICK) return v / (1.0f + expf(-1.702f * v));
  if (act == ACT_TANH) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// Mean and 1/std of one row of d values, read by the 32 lanes of a warp:
// fp32, two passes (mean, then centred variance) as the Pallas `_ln`.
__device__ __forceinline__ void row_ln_stats(const bf16* xr, int d, int lane,
                                             float eps, float& mu,
                                             float& rstd) {
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += bf2f(xr[c]);
  mu = warp_sum(s) / d;
  float v = 0.f;
  for (int c = lane; c < d; c += 32) {
    float t = bf2f(xr[c]) - mu;
    v += t * t;
  }
  rstd = rsqrtf(warp_sum(v) / d + eps);
}

}  // namespace cet
