// Helpers shared by the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

typedef __nv_bfloat16 bf16;

// Eight bf16 values (one 16-byte load) to fp32.
__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// exp(s - m) for a score that may be masked (-inf); masked -> 0.
__device__ __forceinline__ float masked_exp(float s, float m) {
  return s == -INFINITY ? 0.f : __expf(s - m);
}

// Online-softmax rescale factor exp(m_old - m_new); 0 while no score
// has been seen (m_old == -inf), so an empty accumulator stays empty.
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == -INFINITY ? 0.f : __expf(m_old - m_new);
}

}  // namespace repro
