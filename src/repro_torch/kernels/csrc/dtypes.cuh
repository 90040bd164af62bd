// Element types the kernels take, and the conversions every kernel body
// does: loads widen to f32, results narrow back with round-to-nearest-even.
// dtype codes (kernels/_build.py DTYPE_CODES): 0 float32, 1 bfloat16,
// 2 float16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace sgdrc {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<T>{}) for the element type of `dtype`; f returns cudaError_t.
template <typename F>
cudaError_t with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return f(Tag<float>{});
    case 1:
      return f(Tag<__nv_bfloat16>{});
    case 2:
      return f(Tag<__half>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// As with_dtype, for the CUDA-core bodies whose bf16 case runs on the
// tensor cores instead: f32 and f16 only, bf16 is refused.
template <typename F>
cudaError_t with_f32_or_f16(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return f(Tag<float>{});
    case 2:
      return f(Tag<__half>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sgdrc
