// Shared helpers for the port's hand-written sm_90a kernels.
//
// Every kernel is templated on its element type (float or __nv_bfloat16)
// and computes in f32.  The C entry points take a dtype code, launch on the
// stream they are given, allocate nothing, and return cudaGetLastError()
// so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro

// Runs BODY with `T` bound to the element type named by a dtype code.
#define REPRO_DISPATCH(dtype, ...)                      \
  do {                                                  \
    if ((dtype) == repro::kF32) {                       \
      using T = float;                                  \
      __VA_ARGS__                                       \
    } else if ((dtype) == repro::kBF16) {               \
      using T = __nv_bfloat16;                          \
      __VA_ARGS__                                       \
    } else {                                            \
      return cudaErrorInvalidValue;                     \
    }                                                   \
  } while (0)
