// Kernel A: row RMSNorm, y = (x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces the JAX package's backends/pallas/kernels/norms.py:45 (rmsnorm,
// body _rmsnorm_kernel :37).
//
// Bound on the H100: bytes. Each row is read twice (the second read hits
// L1) and written once; the arithmetic is a few FLOPs per element.
// Design: statistics and scaling in fp32, one rounding to x's dtype at the
// store. Short rows (D <= 256: the Qwen3 per-head q/k norms at D = 128 on
// T*32 and T*8 rows) get one warp per row, so no block barrier is needed;
// long rows (the layer norms at D = 2560) get one 256-thread block per row
// with a shared-memory reduction. Both use 16-byte vector loads when D
// and the pointers allow it.
#include "common.cuh"

namespace {

constexpr int kWarpRowThreads = 128;  // 4 rows per block
constexpr int kBlockRowThreads = 256;

template <typename T, bool VEC>
__device__ __forceinline__ float row_sum_sq(const T* __restrict__ xr, int D, int start, int step) {
  float ss = 0.f;
  if constexpr (VEC) {
    constexpr int N = 16 / static_cast<int>(sizeof(T));
    for (int c = start * N; c < D; c += step * N) {
      float f[N];
      mojo_load_row<T, N>(xr + c, f);
#pragma unroll
      for (int k = 0; k < N; ++k) ss += f[k] * f[k];
    }
  } else {
    for (int c = start; c < D; c += step) {
      float f = mojo_to_float(xr[c]);
      ss += f * f;
    }
  }
  return ss;
}

template <typename T, bool VEC>
__device__ __forceinline__ void row_scale(const T* __restrict__ xr, const float* __restrict__ w,
                                          T* __restrict__ yr, int D, float inv, int start, int step) {
  if constexpr (VEC) {
    constexpr int N = 16 / static_cast<int>(sizeof(T));
    for (int c = start * N; c < D; c += step * N) {
      float f[N];
      mojo_load_row<T, N>(xr + c, f);
      uint4 u;
      T* t = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int k = 0; k < N; ++k) t[k] = mojo_from_float<T>((f[k] * inv) * w[c + k]);
      *reinterpret_cast<uint4*>(yr + c) = u;
    }
  } else {
    for (int c = start; c < D; c += step) {
      yr[c] = mojo_from_float<T>((mojo_to_float(xr[c]) * inv) * w[c]);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpRowThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                    int rows, int D, float eps) {
  const int row = blockIdx.x * (kWarpRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + static_cast<int64_t>(row) * D;
  const float ss = mojo_warp_sum(row_sum_sq<T, VEC>(xr, D, lane, 32));
  const float inv = 1.f / sqrtf(ss / D + eps);
  row_scale<T, VEC>(xr, w, y + static_cast<int64_t>(row) * D, D, inv, lane, 32);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBlockRowThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                     int D, float eps) {
  __shared__ float partial[kBlockRowThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + static_cast<int64_t>(row) * D;
  float ss = mojo_warp_sum(row_sum_sq<T, VEC>(xr, D, threadIdx.x, kBlockRowThreads));
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockRowThreads / 32; ++i) ss += partial[i];
  const float inv = 1.f / sqrtf(ss / D + eps);
  row_scale<T, VEC>(xr, w, y + static_cast<int64_t>(row) * D, D, inv, threadIdx.x, kBlockRowThreads);
}

template <typename T, bool VEC>
void launch_rmsnorm(const T* x, const float* w, T* y, int rows, int D, float eps, cudaStream_t stream) {
  if (D <= 256) {
    const int per_block = kWarpRowThreads / 32;
    rmsnorm_warp_kernel<T, VEC><<<(rows + per_block - 1) / per_block, kWarpRowThreads, 0, stream>>>(
        x, w, y, rows, D, eps);
  } else {
    rmsnorm_block_kernel<T, VEC><<<rows, kBlockRowThreads, 0, stream>>>(x, w, y, D, eps);
  }
}

}  // namespace

// x, y: (rows, D) contiguous in `dtype`; w: (D,) fp32. `vec` = 1 when D is
// a multiple of 16 bytes' worth of elements and x, y are 16-byte aligned.
extern "C" int mojo_rmsnorm(const void* x, const void* w, void* y, int rows, int D, float eps,
                            int vec, int dtype, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    if (vec) {
      launch_rmsnorm<T, true>(xt, wf, yt, rows, D, eps, s);
    } else {
      launch_rmsnorm<T, false>(xt, wf, yt, rows, D, eps, s);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
