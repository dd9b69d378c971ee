// Shared helpers for the port's Hopper kernels: dtype conversion (int8
// K/V pages included), warp reductions, vector row loads, the fixed-order
// column sum of per-block partial rows (K, Q), the cp.async and bf16/fp16
// mma.sync.m16n8k16 fragments of the GEMM kernels (H, N), and the dtype
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
#include <type_traits>

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

// in an unnamed namespace: each source that launches it keeps its own copy
namespace {

constexpr int kMojoSumCols = 32;
constexpr int kMojoSumSlices = 32;

// out[c] = sum over r of part[r, c] for (rows, cols) fp32 partial rows, r in
// order: a (32 columns x 32 slices) block; slice s adds the rows r = s,
// s + 32, ..., then slice 0 adds the 32 slice sums in slice order. No
// atomics: the same rows give the same bits. Launch with a grid of
// ceil(cols / kMojoSumCols) blocks of kMojoSumCols * kMojoSumSlices threads.
template <int kCols = kMojoSumCols, int kSlices = kMojoSumSlices>
__global__ void __launch_bounds__(kCols * kSlices)
mojo_column_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, int cols) {
  __shared__ float slice_sum[kSlices][kCols + 1];
  const int col = threadIdx.x % kCols, slice = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + col;
  float s = 0.f;
  if (c < cols) {
    for (int r = slice; r < rows; r += kSlices) s += part[static_cast<int64_t>(r) * cols + c];
  }
  slice_sum[slice][col] = s;
  __syncthreads();
  if (slice == 0 && c < cols) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kSlices; ++i) total += slice_sum[i][col];
    out[c] = total;
  }
}

}  // namespace

// 16-byte asynchronous copy global -> shared; with pred false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

// The first `bytes` (0-16) of a 16-byte chunk; the rest of the 16 shared
// bytes are zero-filled. `gmem` must be 16-byte aligned even when fewer
// bytes are read.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

__device__ __forceinline__ unsigned lds32(const uint16_t* p) { return *reinterpret_cast<const unsigned*>(p); }

// two 16-bit values of one column at rows k and k + 1 of a (K, N) tile, k low
__device__ __forceinline__ unsigned pack2(const uint16_t* p, int ld) {
  return static_cast<unsigned>(p[0]) | (static_cast<unsigned>(p[ld]) << 16);
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
