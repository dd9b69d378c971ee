// Kernel A: row RMSNorm, y = (x * rsqrt(mean(x^2) + eps)) * w; and kernel P:
// residual add + RMSNorm, s = x + r, y = (s * rsqrt(mean(s^2) + eps)) * w,
// whose new residual is s (pre) or y (post).
//
// A replaces the JAX package's backends/pallas/kernels/norms.py:45 (rmsnorm,
// body _rmsnorm_kernel :37); P its norms.py:82 (residual_add_rmsnorm, body
// _add_rmsnorm_kernel :68, call :96).
//
// Bound on the H100: bytes. Each row is read once and written once (P: two
// rows read, two written); the arithmetic is a few FLOPs per element.
// Design: statistics and scaling in fp32, one rounding to each output's
// dtype at the store.
// A at the widths the models use (norms.row_layout: 16-byte vectors a row
// of 16 to 896, D = 128 to 7168 in bf16; the layouts and the grid in
// row_regs.cuh, shared with E) reads each row once into
// registers: a row is split evenly over TPR threads (8, 16 or 32 lanes of
// a warp, or 2 or 4 whole warps) of VPT 16-byte vectors each, the lanes on
// consecutive vectors, so no lane idles (D = 128 bf16: 8 lanes of 2
// vectors, 4 rows a warp; D = 2560: a warp of 10 vectors each; D = 7168: 4
// warps of 7). The sum of squares reduces over the row's lanes by
// shuffles (and, for rows of several warps, the warps' sums in order
// through shared memory); the scaling reads the fp32 weight as 16-byte
// vectors. 128-thread blocks take 128 / TPR rows at a time; the grid is no
// larger than the blocks the card holds at once, and is cut so that every
// block takes the same number of row groups (no partial last wave).
// Other widths and unaligned pointers, and P, take the generic row kernels:
// short rows (D <= 256) one warp a row, long rows one 256-thread block a row
// with a shared-memory reduction, reading the row twice (the second read
// hits L1), in vectors of 16 bytes when D and the pointers allow it. P keeps
// the sum in fp32 (it is never rounded before the norm) and reads an fp32
// residual beside a bf16/fp16 x as it is; MODE says whether a residual is
// added and which row is the new residual.
#include "common.cuh"
#include "row_regs.cuh"

namespace {

constexpr int kWarpRowThreads = 128;  // 4 rows per block
constexpr int kBlockRowThreads = 256;
constexpr int kRegRowThreads = 128;   // A's register kernel: 128 / TPR rows at a time

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

// A with the row in registers: TPR threads a row, VPT 16-byte vectors each, thread `sub` of a row holding vectors
// sub, sub + TPR, ...; D = TPR * VPT * (16 / sizeof(T)) exactly. Block b takes row groups b, b + gridDim.x, ...
template <typename T, int TPR, int VPT>
__global__ void __launch_bounds__(kRegRowThreads)
rmsnorm_regs_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, int rows, float eps) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int D = TPR * VPT * VEC;
  constexpr int RPB = kRegRowThreads / TPR;  // rows a block takes at a time
  constexpr int WARPS = TPR / 32;            // whole warps a row (0: lanes of one warp)
  static_assert(kRegRowThreads % TPR == 0 && (TPR <= 32 ? 32 % TPR == 0 : TPR % 32 == 0), "row split");
  __shared__ float warp_ss[kRegRowThreads / 32];
  const int sub = threadIdx.x % TPR, row_in_block = threadIdx.x / TPR;
  const int groups = (rows + RPB - 1) / RPB;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int row = grp * RPB + row_in_block;
    const bool ok = row < rows;  // every lane joins the shuffles; a row past the end loads and stores nothing
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * D);
    uint4 v[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) v[i] = ok ? xr[i * TPR + sub] : make_uint4(0, 0, 0, 0);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const T* t = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = mojo_to_float(t[k]);
        ss += f * f;
      }
    }
#pragma unroll
    for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if constexpr (WARPS > 1) {
      const int warp = threadIdx.x / 32;
      if (threadIdx.x % 32 == 0) warp_ss[warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) ss += warp_ss[row_in_block * WARPS + i];
      __syncthreads();  // read before the next group writes
    }
    const float inv = 1.f / sqrtf(ss / D + eps);
    if (!ok) continue;
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<int64_t>(row) * D);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = (i * TPR + sub) * VEC;
      const T* t = reinterpret_cast<const T*>(&v[i]);
      float wv[VEC], out[VEC];
#pragma unroll
      for (int k = 0; k < VEC / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(w + c)[k];
        wv[4 * k] = q.x;
        wv[4 * k + 1] = q.y;
        wv[4 * k + 2] = q.z;
        wv[4 * k + 3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[k] = (mojo_to_float(t[k]) * inv) * wv[k];
      mojo_store_row<T, VEC>(reinterpret_cast<T*>(yr + i * TPR + sub), out);
    }
  }
}

// The register kernel's grid: at most the blocks the card holds at once, cut so that each takes the same number
// of row groups
template <typename T, int TPR, int VPT>
int launch_regs(const T* x, const float* w, T* y, int rows, float eps, cudaStream_t stream) {
  static const int resident = mojo_resident_blocks(rmsnorm_regs_kernel<T, TPR, VPT>, kRegRowThreads);
  constexpr int RPB = kRegRowThreads / TPR;
  const int groups = (rows + RPB - 1) / RPB;
  rmsnorm_regs_kernel<T, TPR, VPT><<<mojo_even_rounds_grid(groups, resident), kRegRowThreads, 0, stream>>>(
      x, w, y, rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_regs(const void* x, const float* w, void* y, int rows, float eps, int tpr, int vpt,
                  cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define MOJO_ROW_CASE(TPR, VPT) \
  if (tpr == TPR && vpt == VPT) return launch_regs<T, TPR, VPT>(xt, w, yt, rows, eps, stream);
  MOJO_ROW_LAYOUTS(MOJO_ROW_CASE)
#undef MOJO_ROW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
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
// tpr > 0 (with vec, and w 16-byte aligned) takes the register kernel with
// tpr threads of vpt 16-byte vectors a row (norms.row_layout), D = tpr *
// vpt * 16 / sizeof(dtype); tpr = 0 the generic row kernels.
extern "C" int mojo_rmsnorm(const void* x, const void* w, void* y, int rows, int D, float eps,
                            int vec, int tpr, int vpt, int dtype, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    if (tpr > 0) {
      if (vec && D == tpr * vpt * static_cast<int>(16 / sizeof(T)) && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
        rc = dispatch_regs<T>(x, wf, y, rows, eps, tpr, vpt, s);
      }
    } else {
      launch_rows_vec<T, T, kPlain>(x, nullptr, wf, y, nullptr, rows, D, eps, vec, s);
      rc = static_cast<int>(cudaGetLastError());
    }
  });
  return rc;
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
