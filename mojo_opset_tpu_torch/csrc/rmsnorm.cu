// Kernel A: row RMSNorm, y = (x * rsqrt(mean(x^2) + eps)) * w; and kernel P:
// residual add + RMSNorm, s = x + r, y = (s * rsqrt(mean(s^2) + eps)) * w,
// whose new residual is s (pre) or y (post).
//
// A replaces the JAX package's backends/pallas/kernels/norms.py:45 (rmsnorm,
// body _rmsnorm_kernel :37); P its norms.py:82 (residual_add_rmsnorm, body
// _add_rmsnorm_kernel :68, call :96).
//
// Bound on the H100: bytes. Each row is read twice (the second read hits
// L1) and written once (P: two rows read, two written); the arithmetic is a
// few FLOPs per element.
// Design: statistics and scaling in fp32, one rounding to each output's
// dtype at the store; P keeps the sum in fp32 (it is never rounded before
// the norm) and reads an fp32 residual beside a bf16/fp16 x as it is. Short
// rows (D <= 256: the Qwen3 per-head q/k norms at D = 128 on T*32 and T*8
// rows) get one warp per row, so no block barrier is needed; long rows (the
// layer norms at D = 2560) get one 256-thread block per row with a
// shared-memory reduction. Both use vectors of 16 bytes of x's dtype when D
// and the pointers allow it. A and P share these two kernels: MODE says
// whether a residual is added and which row is the new residual.
#include "common.cuh"

namespace {

constexpr int kWarpRowThreads = 128;  // 4 rows per block
constexpr int kBlockRowThreads = 256;

// A: no residual; P: s = x + r, new residual s (pre) or y (post)
enum NormMode : int { kPlain = 0, kAddPre = 1, kAddPost = 2 };

// the new residual's type: the residual's in pre (the sum's promoted
// dtype), x's in post
template <typename T, typename R, int MODE>
using ResOut = std::conditional_t<MODE == kAddPre, R, T>;

// N consecutive elements of the row being normalized, as floats: x, or x + r
template <typename T, typename R, int MODE, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ x, const R* __restrict__ r, int64_t i,
                                         float (&f)[N]) {
  mojo_load_row<T, N>(x + i, f);
  if constexpr (MODE != kPlain) {
    float g[N];
    mojo_load_row<R, N>(r + i, g);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] += g[k];
  }
}

// N = 1 walks single elements; N > 1 vectors of N (16 bytes of T)
template <typename T, typename R, int MODE, int N>
__device__ __forceinline__ float row_sum_sq(const T* __restrict__ x, const R* __restrict__ r, int64_t off, int D,
                                            int start, int step) {
  float ss = 0.f;
  for (int c = start * N; c < D; c += step * N) {
    float f[N];
    load_row<T, R, MODE, N>(x, r, off + c, f);
#pragma unroll
    for (int k = 0; k < N; ++k) ss += f[k] * f[k];
  }
  return ss;
}

template <typename T, typename R, int MODE, int N>
__device__ __forceinline__ void row_scale(const T* __restrict__ x, const R* __restrict__ r,
                                          const float* __restrict__ w, T* __restrict__ y,
                                          ResOut<T, R, MODE>* __restrict__ res, int64_t off, int D, float inv,
                                          int start, int step) {
  for (int c = start * N; c < D; c += step * N) {
    float f[N], out[N];
    load_row<T, R, MODE, N>(x, r, off + c, f);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = (f[k] * inv) * w[c + k];
    mojo_store_row<T, N>(y + off + c, out);
    if constexpr (MODE == kAddPre) mojo_store_row<ResOut<T, R, MODE>, N>(res + off + c, f);
    if constexpr (MODE == kAddPost) mojo_store_row<ResOut<T, R, MODE>, N>(res + off + c, out);
  }
}

template <typename T, typename R, int MODE, int N>
__global__ void __launch_bounds__(kWarpRowThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const R* __restrict__ r, const float* __restrict__ w,
                    T* __restrict__ y, ResOut<T, R, MODE>* __restrict__ res, int rows, int D, float eps) {
  const int row = blockIdx.x * (kWarpRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const int64_t off = static_cast<int64_t>(row) * D;
  const float ss = mojo_warp_sum(row_sum_sq<T, R, MODE, N>(x, r, off, D, lane, 32));
  const float inv = 1.f / sqrtf(ss / D + eps);
  row_scale<T, R, MODE, N>(x, r, w, y, res, off, D, inv, lane, 32);
}

template <typename T, typename R, int MODE, int N>
__global__ void __launch_bounds__(kBlockRowThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const R* __restrict__ r, const float* __restrict__ w,
                     T* __restrict__ y, ResOut<T, R, MODE>* __restrict__ res, int D, float eps) {
  __shared__ float partial[kBlockRowThreads / 32];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * D;
  float ss = mojo_warp_sum(row_sum_sq<T, R, MODE, N>(x, r, off, D, threadIdx.x, kBlockRowThreads));
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockRowThreads / 32; ++i) ss += partial[i];
  const float inv = 1.f / sqrtf(ss / D + eps);
  row_scale<T, R, MODE, N>(x, r, w, y, res, off, D, inv, threadIdx.x, kBlockRowThreads);
}

template <typename T, typename R, int MODE, int N>
void launch_rows(const T* x, const R* r, const float* w, T* y, ResOut<T, R, MODE>* res, int rows, int D, float eps,
                 cudaStream_t stream) {
  if (D <= 256) {
    const int per_block = kWarpRowThreads / 32;
    rmsnorm_warp_kernel<T, R, MODE, N><<<(rows + per_block - 1) / per_block, kWarpRowThreads, 0, stream>>>(
        x, r, w, y, res, rows, D, eps);
  } else {
    rmsnorm_block_kernel<T, R, MODE, N><<<rows, kBlockRowThreads, 0, stream>>>(x, r, w, y, res, D, eps);
  }
}

template <typename T, typename R, int MODE>
void launch_rows_vec(const void* x, const void* r, const float* w, void* y, void* res, int rows, int D, float eps,
                     int vec, cudaStream_t stream) {
  using Q = ResOut<T, R, MODE>;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const T* xt = static_cast<const T*>(x);
  const R* rt = static_cast<const R*>(r);
  if (vec) {
    launch_rows<T, R, MODE, kVec>(xt, rt, w, static_cast<T*>(y), static_cast<Q*>(res), rows, D, eps, stream);
  } else {
    launch_rows<T, R, MODE, 1>(xt, rt, w, static_cast<T*>(y), static_cast<Q*>(res), rows, D, eps, stream);
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
    launch_rows_vec<T, T, kPlain>(x, nullptr, wf, y, nullptr, rows, D, eps, vec, s);
  });
  return static_cast<int>(cudaGetLastError());
}

// x, y: (rows, D) contiguous in `dtype`; r: (rows, D) contiguous in `dtype`,
// or fp32 when `res_f32`; w: (D,) fp32; res: the new residual (rows, D), in
// r's dtype when `post` = 0 and in `dtype` when `post` = 1. `vec` = 1 when D
// is a multiple of 16 bytes' worth of x's elements and every pointer is
// 16-byte aligned.
extern "C" int mojo_residual_add_rmsnorm(const void* x, const void* r, const void* w, void* y, void* res, int rows,
                                         int D, float eps, int post, int res_f32, int vec, int dtype, void* stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    if (res_f32) {
      if (post) {
        launch_rows_vec<T, float, kAddPost>(x, r, wf, y, res, rows, D, eps, vec, s);
      } else {
        launch_rows_vec<T, float, kAddPre>(x, r, wf, y, res, rows, D, eps, vec, s);
      }
    } else if (post) {
      launch_rows_vec<T, T, kAddPost>(x, r, wf, y, res, rows, D, eps, vec, s);
    } else {
      launch_rows_vec<T, T, kAddPre>(x, r, wf, y, res, rows, D, eps, vec, s);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
