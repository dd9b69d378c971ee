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
// element). Design: the tensor as one flat run of n elements. When the
// pointers are 16-byte aligned, one grid covers the n / V 16-byte vectors
// once (V elements each), with no grid-stride loop: block b's thread t owns
// vectors b * THREADS * U + u * THREADS + t for u < U (neighbouring threads
// on neighbouring vectors), issues all of its U loads (2U in the backward:
// x and dy) before any math, and stores U vectors. Nothing is read twice, so
// the loads and stores carry the streaming hint (__ldcs, __stcs). The last
// block also takes the n % V scalar tail. An unaligned tensor keeps a
// grid-stride scalar loop. Math in fp32, one rounding at the store; expf,
// not the fast __expf, so fp32 agrees with PyTorch's silu to an ulp or two.
// U (2 or 4) and THREADS (128, 256 or 512) come from the wrapper
// (silu_vjp.UNROLL, silu_vjp.THREADS), chosen by benchmark/split_sweep.py's
// int4 mode.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float silu_fwd(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float silu_bwd(float v, float g) {
  const float s = sigmoid(v);
  return g * s * (1.f + v * (1.f - s));
}

// one 16-byte vector of T as floats, and back, rounded once
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[16 / sizeof(T)]) {
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < static_cast<int>(16 / sizeof(T)); ++k) f[k] = mojo_to_float(t[k]);
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&f)[16 / sizeof(T)]) {
  uint4 u;
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int k = 0; k < static_cast<int>(16 / sizeof(T)); ++k) t[k] = mojo_from_float<T>(f[k]);
  return u;
}

// the vector route: n_vec 16-byte vectors, then the n - n_vec * V tail in the last block
template <typename T, int U, int THREADS>
__global__ void __launch_bounds__(THREADS)
silu_fwd_vec_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n_vec, int64_t n) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (THREADS * U) + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 in[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < n_vec) in[u] = __ldcs(xv + i);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < n_vec) {
      float f[V];
      unpack16<T>(in[u], f);
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = silu_fwd(f[k]);
      __stcs(yv + i, pack16<T>(f));
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int64_t i = n_vec * V + threadIdx.x;  // the tail is shorter than V <= THREADS
    if (i < n) y[i] = mojo_from_float<T>(silu_fwd(mojo_to_float(x[i])));
  }
}

template <typename T, int U, int THREADS>
__global__ void __launch_bounds__(THREADS)
silu_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int64_t n_vec,
                    int64_t n) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (THREADS * U) + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(dy);
  uint4* dv = reinterpret_cast<uint4*>(dx);
  uint4 in[U], grad[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < n_vec) {
      in[u] = __ldcs(xv + i);
      grad[u] = __ldcs(gv + i);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < n_vec) {
      float f[V], g[V];
      unpack16<T>(in[u], f);
      unpack16<T>(grad[u], g);
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = silu_bwd(f[k], g[k]);
      __stcs(dv + i, pack16<T>(f));
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int64_t i = n_vec * V + threadIdx.x;
    if (i < n) dx[i] = mojo_from_float<T>(silu_bwd(mojo_to_float(x[i]), mojo_to_float(dy[i])));
  }
}

// the unaligned route: a grid-stride scalar loop
constexpr int kScalarThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kScalarThreads) silu_fwd_scalar_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                                         int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n; i += stride) {
    y[i] = mojo_from_float<T>(silu_fwd(mojo_to_float(x[i])));
  }
}

template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
silu_bwd_scalar_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n; i += stride) {
    dx[i] = mojo_from_float<T>(silu_bwd(mojo_to_float(x[i]), mojo_to_float(dy[i])));
  }
}

int scalar_grid(int64_t n) {
  const int64_t want = (n + kScalarThreads - 1) / kScalarThreads;
  return static_cast<int>(want < 132 * 16 ? want : 132 * 16);  // grid-stride past 16 blocks an SM
}

// blocks of the vector route: every vector once, at least one block for the tail
int vec_grid(int64_t n_vec, int per_block) {
  const int64_t want = (n_vec + per_block - 1) / per_block;
  return static_cast<int>(want > 0 ? want : 1);
}

// Run BODY with U and THREADS bound to the compile-time values of `unroll` and `threads`; other values return
// cudaErrorInvalidValue.
#define MOJO_SILU_CONFIG(unroll, threads, ...)                             \
  do {                                                                     \
    if ((unroll) == 2 && (threads) == 128) {                               \
      constexpr int U = 2, THREADS = 128;                                  \
      __VA_ARGS__;                                                         \
    } else if ((unroll) == 2 && (threads) == 256) {                        \
      constexpr int U = 2, THREADS = 256;                                  \
      __VA_ARGS__;                                                         \
    } else if ((unroll) == 2 && (threads) == 512) {                        \
      constexpr int U = 2, THREADS = 512;                                  \
      __VA_ARGS__;                                                         \
    } else if ((unroll) == 4 && (threads) == 128) {                        \
      constexpr int U = 4, THREADS = 128;                                  \
      __VA_ARGS__;                                                         \
    } else if ((unroll) == 4 && (threads) == 256) {                        \
      constexpr int U = 4, THREADS = 256;                                  \
      __VA_ARGS__;                                                         \
    } else if ((unroll) == 4 && (threads) == 512) {                        \
      constexpr int U = 4, THREADS = 512;                                  \
      __VA_ARGS__;                                                         \
    } else {                                                               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
  } while (0)

}  // namespace

// x, y: n contiguous elements of `dtype`; `vec` = 1 when x and y are
// 16-byte aligned; `unroll` (2, 4) vectors a thread, `threads` (128, 256,
// 512) a block on the vector route.
extern "C" int mojo_silu_fwd(const void* x, void* y, long long n, int vec, int unroll, int threads, int dtype,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    if (vec) {
      MOJO_SILU_CONFIG(unroll, threads, {
        silu_fwd_vec_kernel<T, U, THREADS><<<vec_grid(n / V, U * THREADS), THREADS, 0, s>>>(xt, yt, n / V, n);
      });
    } else {
      silu_fwd_scalar_kernel<T><<<scalar_grid(n), kScalarThreads, 0, s>>>(xt, yt, n);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: n contiguous elements of `dtype`; `vec` = 1 when all three are
// 16-byte aligned; `unroll` and `threads` as mojo_silu_fwd's.
extern "C" int mojo_silu_bwd(const void* x, const void* dy, void* dx, long long n, int vec, int unroll, int threads,
                             int dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    if (vec) {
      MOJO_SILU_CONFIG(unroll, threads, {
        silu_bwd_vec_kernel<T, U, THREADS><<<vec_grid(n / V, U * THREADS), THREADS, 0, s>>>(xt, dyt, dxt, n / V,
                                                                                          n);
      });
    } else {
      silu_bwd_scalar_kernel<T><<<scalar_grid(n), kScalarThreads, 0, s>>>(xt, dyt, dxt, n);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
