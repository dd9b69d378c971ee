// Shared helpers for the port's Hopper kernels: dtype conversion (int8
// K/V pages included), warp reductions, vector row loads and the dtype
// switch of the C entry points.
//
// Every entry point is `extern "C"`, takes raw device pointers and the
// CUDA stream from the caller, launches, and returns cudaGetLastError()
// as an int (0 = cudaSuccess). Kernels allocate nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

// dtype codes shared with backends/cuda/build.py
enum MojoDType : int { kMojoF32 = 0, kMojoF16 = 1, kMojoBF16 = 2 };

__device__ __forceinline__ float mojo_to_float(float x) { return x; }
__device__ __forceinline__ float mojo_to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float mojo_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float mojo_to_float(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T mojo_from_float(float x);
template <>
__device__ __forceinline__ float mojo_from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half mojo_from_float<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 mojo_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float mojo_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float mojo_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Load N consecutive elements of T as floats. `p` must be aligned to
// N * sizeof(T) bytes when that is 4, 8 or a multiple of 16.
template <typename T, int N>
__device__ __forceinline__ void mojo_load_row(const T* __restrict__ p, float (&f)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < PER; ++k) f[i * PER + k] = mojo_to_float(t[k]);
    }
  } else if constexpr (BYTES == 8) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = mojo_to_float(t[k]);
  } else if constexpr (BYTES == 4) {
    unsigned int u = *reinterpret_cast<const unsigned int*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = mojo_to_float(t[k]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = mojo_to_float(p[k]);
  }
}

// Store N floats as N consecutive elements of T, rounded once; the same
// alignment rule as mojo_load_row.
template <typename T, int N>
__device__ __forceinline__ void mojo_store_row(T* __restrict__ p, const float (&f)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      uint4 u;
      T* t = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int k = 0; k < PER; ++k) t[k] = mojo_from_float<T>(f[i * PER + k]);
      reinterpret_cast<uint4*>(p)[i] = u;
    }
  } else if constexpr (BYTES == 8) {
    uint2 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < N; ++k) t[k] = mojo_from_float<T>(f[k]);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (BYTES == 4) {
    unsigned int u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < N; ++k) t[k] = mojo_from_float<T>(f[k]);
    *reinterpret_cast<unsigned int*>(p) = u;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = mojo_from_float<T>(f[k]);
  }
}

// Run BODY with T bound to the element type of `code`; unknown codes
// return cudaErrorInvalidValue from the enclosing entry point.
#define MOJO_DISPATCH_DTYPE(code, T, ...)              \
  switch (code) {                                      \
    case kMojoF32: {                                   \
      using T = float;                                 \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    case kMojoF16: {                                   \
      using T = __half;                                \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    case kMojoBF16: {                                  \
      using T = __nv_bfloat16;                         \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    default:                                           \
      return static_cast<int>(cudaErrorInvalidValue);  \
  }
