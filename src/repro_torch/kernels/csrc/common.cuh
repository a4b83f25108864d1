// Shared helpers of the port's attention kernels: element conversion and
// the host-side dispatch macros.  Plain C interface only (no PyTorch
// headers), so each file builds in seconds.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace rt {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Masked scores are -inf and the running max starts at this finite
// floor, so exp(s - m) is exactly 0 for a masked key and a row that has
// seen no valid key keeps l == 0 (written out as zeros, as the Pallas
// kernels do for fully-masked rows).
constexpr float kMinFloor = -1e30f;

// q * scale rounded to T, as the Pallas entries compute it in q's dtype
// (``q * jnp.asarray(scale, q.dtype)``); the wrapper passes the scale
// already rounded to T.
template <typename T>
__device__ __forceinline__ float scaled_q(T q, float scale) {
  return to_f(from_f<T>(to_f(q) * scale));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace rt
