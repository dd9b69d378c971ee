// Kernel L: SiLU forward and backward, two entry points.
//
// Replaces the JAX package's backends/pallas/kernels/silu_vjp.py
// (_fwd_kernel :30, call :52; _bwd_kernel :35, call :71):
//   forward   y  = x * sigmoid(x)
//   backward  dx = dy * s * (1 + x * (1 - s)),  s = sigmoid(x) recomputed
//             from the saved x (the activation is not saved)
//
// Bound on the H100: bytes (elementwise: the forward reads x and writes y,
// the backward reads x and dy and writes dx; ~10 FLOPs and one exp per
// element). Design: the tensor as one flat run of n elements; a grid-stride
// loop over 16-byte vectors when the pointers are 16-byte aligned, then the
// scalar tail. Math in fp32, one rounding at the store; expf, not the fast
// __expf, so fp32 agrees with PyTorch's silu to an ulp or two.
#include "common.cuh"

namespace {

constexpr int kSiluThreads = 256;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float silu_fwd(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float silu_bwd(float v, float g) {
  const float s = sigmoid(v);
  return g * s * (1.f + v * (1.f - s));
}

// N elements per vector: 16 bytes, or 1 (the scalar path: n_vec = 0)
template <typename T, int N>
__global__ void __launch_bounds__(kSiluThreads)
silu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n_vec, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float f[N];
    mojo_load_row<T, N>(x + i * N, f);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = silu_fwd(f[k]);
    mojo_store_row<T, N>(y + i * N, f);
  }
  for (int64_t i = n_vec * N + tid; i < n; i += stride) y[i] = mojo_from_float<T>(silu_fwd(mojo_to_float(x[i])));
}

template <typename T, int N>
__global__ void __launch_bounds__(kSiluThreads)
silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int64_t n_vec, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float f[N], g[N];
    mojo_load_row<T, N>(x + i * N, f);
    mojo_load_row<T, N>(dy + i * N, g);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = silu_bwd(f[k], g[k]);
    mojo_store_row<T, N>(dx + i * N, f);
  }
  for (int64_t i = n_vec * N + tid; i < n; i += stride) {
    dx[i] = mojo_from_float<T>(silu_bwd(mojo_to_float(x[i]), mojo_to_float(dy[i])));
  }
}

int grid_for(int64_t work) {
  const int64_t want = (work + kSiluThreads - 1) / kSiluThreads;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);  // grid-stride past 16 per SM
}

}  // namespace

// x, y: n contiguous elements of `dtype`; `vec` = 1 when x and y are
// 16-byte aligned.
extern "C" int mojo_silu_fwd(const void* x, void* y, long long n, int vec, int dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    constexpr int N = 16 / static_cast<int>(sizeof(T));
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    if (vec) {
      silu_fwd_kernel<T, N><<<grid_for(n / N), kSiluThreads, 0, s>>>(xt, yt, n / N, n);
    } else {
      silu_fwd_kernel<T, 1><<<grid_for(n), kSiluThreads, 0, s>>>(xt, yt, 0, n);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: n contiguous elements of `dtype`; `vec` = 1 when all three are
// 16-byte aligned.
extern "C" int mojo_silu_bwd(const void* x, const void* dy, void* dx, long long n, int vec, int dtype,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    constexpr int N = 16 / static_cast<int>(sizeof(T));
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    if (vec) {
      silu_bwd_kernel<T, N><<<grid_for(n / N), kSiluThreads, 0, s>>>(xt, dyt, dxt, n / N, n);
    } else {
      silu_bwd_kernel<T, 1><<<grid_for(n), kSiluThreads, 0, s>>>(xt, dyt, dxt, 0, n);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
