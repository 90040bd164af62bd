// Element types the kernels take, and the conversions every kernel body
// does: loads widen to f32, results narrow back with round-to-nearest-even
// (one element at a time, or 4 to 16 bytes at once: load_f32,
// store_from_f32).
// dtype codes (kernels/_build.py DTYPE_CODES): 0 float32, 1 bfloat16,
// 2 float16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Two 16-bit values in one 32-bit word, widened to f32.
__device__ __forceinline__ float2 widen2(uint32_t w, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
__device__ __forceinline__ float2 widen2(uint32_t w, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ uint32_t narrow2(float a, float b, __half) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t narrow2(float a, float b,
                                            __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// N elements of T at p (aligned to their size, 4 to 16 bytes; f32 also any
// multiple of 4 elements) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* x) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const float4 u = reinterpret_cast<const float4*>(p)[i];
        x[4 * i] = u.x;
        x[4 * i + 1] = u.y;
        x[4 * i + 2] = u.z;
        x[4 * i + 3] = u.w;
      }
    } else {
      static_assert(N == 2, "f32 loads of 2 or 4k elements");
      const float2 u = *reinterpret_cast<const float2*>(p);
      x[0] = u.x;
      x[1] = u.y;
    }
  } else {
    constexpr int W = N / 2;  // 32-bit words
    uint32_t w[W];
    if constexpr (W == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (W == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else {
      static_assert(W == 1, "16-bit loads of 2, 4 or 8 elements");
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float2 f = widen2(w[i], T{});
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// N f32 values stored at p as N elements of T (rounded to nearest even).
template <typename T, int N>
__device__ __forceinline__ void store_from_f32(T* p, const float* x) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        reinterpret_cast<float4*>(p)[i] =
            make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    } else {
      static_assert(N == 2, "f32 stores of 2 or 4k elements");
      *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    }
  } else {
    constexpr int W = N / 2;
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = narrow2(x[2 * i], x[2 * i + 1], T{});
    if constexpr (W == 4) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (W == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      static_assert(W == 1, "16-bit stores of 2, 4 or 8 elements");
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

}  // namespace sgdrc
