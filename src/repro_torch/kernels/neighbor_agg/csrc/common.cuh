// Shared helpers of the neighbor-aggregation kernels (forward, backward,
// row): f32 <-> storage-type conversions and a warp sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nagg {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// error code returned by the C entry points for arguments they refuse
constexpr int kBadArgs = 1000;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;  // every lane holds the sum
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

}  // namespace nagg
