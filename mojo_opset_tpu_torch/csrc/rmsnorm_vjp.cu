// Kernel K: the RMSNorm backward, dx and an fp32 dw in one pass over x and dy.
//
// Replaces the JAX package's backends/pallas/kernels/rmsnorm_vjp.py:56
// (_rmsnorm_bwd_pallas, body _bwd_kernel :38, call :59). In fp32, with
// nothing saved from the forward but x and w:
//   rstd = rsqrt(mean(x^2) + eps)   (recomputed)
//   g    = dy * w
//   dx   = rstd * g - rstd^3 * x * mean(g * x)
//   dw   = sum over rows of dy * x * rstd
//
// Bound on the H100: bytes (read x and dy, write dx; a few FLOPs per
// element). The TPU kernel carries dw across a sequential grid; here blocks
// run in no order, so each block walks its rows (grid-stride), keeps its
// own fp32 dw sums, and writes them as one row of a (blocks, D) partial
// buffer; a second small kernel (common.cuh's column sum) adds those rows in
// block order. No
// atomics: the same inputs and grid give the same bits.
//
// Short rows (D <= 256: the per-head q/k norms at D = 128 over 131072 and
// 32768 rows) take a warp per row, 8 rows of a block at a time, the row in
// registers (lane l owns columns l*G + k*32*G); a lane's dw sums stay in
// registers and the block adds its 8 warps' sums in warp order. Long rows
// (the layer norms at D = 2560) take a block per row; a thread owns the
// same columns in every row, so its dw sums live in shared memory that no
// other thread touches, and the row is read twice (the second read hits
// L1/L2). Loads are vectors of G elements where D and the pointers allow.
#include "common.cuh"

namespace {

constexpr int kShortThreads = 256;
constexpr int kShortWarps = kShortThreads / 32;
constexpr int kShortMaxD = 256;
constexpr int kLongThreads = 512;
constexpr int kLongWarps = kLongThreads / 32;

template <typename T, int G>
__global__ void __launch_bounds__(kShortThreads)
rmsnorm_bwd_short_kernel(const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ dy,
                         T* __restrict__ dx, float* __restrict__ dw_part, int rows, int D, float eps) {
  constexpr int K = kShortMaxD / (32 * G);  // column groups a lane owns at most
  __shared__ float warp_dw[kShortWarps][kShortMaxD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[K * G];
#pragma unroll
  for (int i = 0; i < K * G; ++i) acc[i] = 0.f;
  for (int row = blockIdx.x * kShortWarps + warp; row < rows; row += gridDim.x * kShortWarps) {
    const int64_t off = static_cast<int64_t>(row) * D;
    float xs[K * G], dys[K * G], gs[K * G];
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (lane + k * 32) * G;
      if (c < D) {
        float xf[G], df[G];
        mojo_load_row<T, G>(x + off + c, xf);
        mojo_load_row<T, G>(dy + off + c, df);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float g = df[j] * w[c + j];
          xs[k * G + j] = xf[j];
          dys[k * G + j] = df[j];
          gs[k * G + j] = g;
          ss += xf[j] * xf[j];
          sg += g * xf[j];
        }
      }
    }
    ss = mojo_warp_sum(ss);
    sg = mojo_warp_sum(sg);
    const float rstd = 1.f / sqrtf(ss / D + eps);
    const float coef = rstd * rstd * rstd * (sg / D);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (lane + k * 32) * G;
      if (c < D) {
        float out[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int i = k * G + j;
          out[j] = rstd * gs[i] - coef * xs[i];
          acc[i] += dys[i] * (xs[i] * rstd);
        }
        mojo_store_row<T, G>(dx + off + c, out);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (lane + k * 32) * G;
    if (c < D) {
#pragma unroll
      for (int j = 0; j < G; ++j) warp_dw[warp][c + j] = acc[k * G + j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kShortThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kShortWarps; ++i) s += warp_dw[i][c];
    dw_part[static_cast<int64_t>(blockIdx.x) * D + c] = s;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kLongThreads)
rmsnorm_bwd_long_kernel(const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ dy,
                        T* __restrict__ dx, float* __restrict__ dw_part, int rows, int D, float eps) {
  extern __shared__ float mojo_rms_bwd_smem[];  // D fp32 dw sums; thread t owns its own columns
  __shared__ float red[2][kLongWarps];
  const int start = threadIdx.x * G, step = kLongThreads * G;
  for (int c = start; c < D; c += step) {
#pragma unroll
    for (int j = 0; j < G; ++j) mojo_rms_bwd_smem[c + j] = 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t off = static_cast<int64_t>(row) * D;
    float ss = 0.f, sg = 0.f;
    for (int c = start; c < D; c += step) {
      float xf[G], df[G];
      mojo_load_row<T, G>(x + off + c, xf);
      mojo_load_row<T, G>(dy + off + c, df);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        ss += xf[j] * xf[j];
        sg += df[j] * w[c + j] * xf[j];
      }
    }
    ss = mojo_warp_sum(ss);
    sg = mojo_warp_sum(sg);
    if (threadIdx.x % 32 == 0) {
      red[0][threadIdx.x / 32] = ss;
      red[1][threadIdx.x / 32] = sg;
    }
    __syncthreads();
    ss = 0.f;
    sg = 0.f;
#pragma unroll
    for (int i = 0; i < kLongWarps; ++i) {
      ss += red[0][i];
      sg += red[1][i];
    }
    __syncthreads();  // red is written again for the next row
    const float rstd = 1.f / sqrtf(ss / D + eps);
    const float coef = rstd * rstd * rstd * (sg / D);
    for (int c = start; c < D; c += step) {
      float xf[G], df[G], out[G];
      mojo_load_row<T, G>(x + off + c, xf);
      mojo_load_row<T, G>(dy + off + c, df);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        out[j] = rstd * (df[j] * w[c + j]) - coef * xf[j];
        mojo_rms_bwd_smem[c + j] += df[j] * (xf[j] * rstd);
      }
      mojo_store_row<T, G>(dx + off + c, out);
    }
  }
  for (int c = start; c < D; c += step) {
#pragma unroll
    for (int j = 0; j < G; ++j) dw_part[static_cast<int64_t>(blockIdx.x) * D + c + j] = mojo_rms_bwd_smem[c + j];
  }
}

template <typename T, int G>
cudaError_t launch_rmsnorm_bwd(const T* x, const float* w, const T* dy, T* dx, float* part, float* dw, int rows,
                               int D, float eps, int blocks, cudaStream_t stream) {
  if (D <= kShortMaxD) {
    rmsnorm_bwd_short_kernel<T, G><<<blocks, kShortThreads, 0, stream>>>(x, w, dy, dx, part, rows, D, eps);
  } else {
    const size_t smem = static_cast<size_t>(D) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t attr = cudaFuncSetAttribute(rmsnorm_bwd_long_kernel<T, G>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(smem));
      if (attr != cudaSuccess) return attr;
    }
    rmsnorm_bwd_long_kernel<T, G><<<blocks, kLongThreads, smem, stream>>>(x, w, dy, dx, part, rows, D, eps);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mojo_column_sum_kernel<><<<(D + kMojoSumCols - 1) / kMojoSumCols, kMojoSumCols * kMojoSumSlices, 0, stream>>>(
      part, dw, blocks, D);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, D) contiguous in `dtype`; w: (D,) fp32; part: (blocks,
// D) fp32 scratch; dw: (D,) fp32. `blocks` >= 1 is the grid of the row
// pass (any value is right; the wrapper fixes it from rows and D, so a
// call's bits repeat). `vec` = 1 when D is a multiple of 4 (short rows) or
// of 16 bytes' worth of elements (long rows) and x, dy, dx are aligned to
// that vector.
extern "C" int mojo_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* part, void* dw,
                                int rows, int D, float eps, int blocks, int vec, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  float* dwf = static_cast<float*>(dw);
  cudaError_t err = cudaSuccess;
  MOJO_DISPATCH_DTYPE(dtype, T, {
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    constexpr int kLongG = 16 / static_cast<int>(sizeof(T));
    if (!vec) {
      err = launch_rmsnorm_bwd<T, 1>(xt, wf, dyt, dxt, pf, dwf, rows, D, eps, blocks, s);
    } else if (D <= kShortMaxD) {
      err = launch_rmsnorm_bwd<T, 4>(xt, wf, dyt, dxt, pf, dwf, rows, D, eps, blocks, s);
    } else {
      err = launch_rmsnorm_bwd<T, kLongG>(xt, wf, dyt, dxt, pf, dwf, rows, D, eps, blocks, s);
    }
  });
  return static_cast<int>(err);
}
