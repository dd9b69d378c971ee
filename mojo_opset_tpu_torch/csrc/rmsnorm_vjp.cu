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
// run in no order, so each block keeps its own fp32 dw sums and writes them
// as one row of a (blocks, D) partial buffer; a second small kernel
// (common.cuh's column sum) adds those rows in block order. No atomics: the
// same inputs and grid give the same bits.
//
// At the widths the models use (rmsnorm_vjp.layout: kernel A's row layouts,
// row_regs.cuh, with 16-byte-aligned x, dy, dx and w) the register kernel
// reads each row once: a row is split evenly over TPR threads of VPT
// 16-byte vectors each, none idle (D = 128 bf16: 8 lanes of 2 vectors, 4
// rows a warp; D = 2560: a warp of 10). A row team loads all its x and dy
// vectors (streaming loads) before any math, reduces the sum of squares and
// sum(g * x) over its lanes by xor shuffles (a row of several warps adds the
// warps' sums in order through shared memory), writes dx from the registers
// (16-byte streaming stores) and adds dy * x * rstd into its dw registers,
// which it keeps across every row it takes. The fp32 weight is read as
// 16-byte vectors at each use. The grid is at most the blocks the card
// holds at once (reg_min_blocks, which the launch bounds guarantee and
// rmsnorm_vjp.blocks_per_sm mirrors), cut so every block takes the same
// number of row groups; at the end a block adds its teams' dw sums in team
// order through shared memory (all teams at once where their sums fit in 16
// KB, as at D = 128; else one team at a time) and writes its partial row.
//
// Other widths and unaligned views take the generic kernels. Short rows
// (D <= 256) take a warp per row, 8 rows of a block at a time, the row in
// registers (lane l owns columns l*G + k*32*G); a lane's dw sums stay in
// registers and the block adds its 8 warps' sums in warp order. Long rows
// take a block per row; a thread owns the same columns in every row, so its
// dw sums live in shared memory that no other thread touches, and the row
// is read twice (the second read hits L1/L2). Loads are vectors of G
// elements where D and the pointers allow.
#include "common.cuh"
#include "row_regs.cuh"

namespace {

constexpr int kShortThreads = 256;
constexpr int kShortWarps = kShortThreads / 32;
constexpr int kShortMaxD = 256;
constexpr int kLongThreads = 512;
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kRegThreads = 128;  // the register kernel: 128 / TPR rows at a time

// blocks an SM the register kernel is built to hold, and its grid takes, from a thread's VPT * VEC values (x and dy
// packed, fp32 dw sums): rmsnorm_vjp.blocks_per_sm mirrors it. At D 128 (16 values) 4 blocks an SM are as fast as 5
// or 6 at 131072 rows and the fastest at 32768 (split_sweep rmsnorm_bwd), with fewer dw partial rows
constexpr int reg_min_blocks(int values) { return values <= 40 ? 4 : 2; }

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

// VEC / 4 16-byte vectors of fp32 at p (16-byte aligned) into f, through the read-only cache. The load is
// volatile so that the register kernel's two reads of the weight stay two: merged, the weight would stay live
// across the row's reductions (80 more registers a thread at D = 2560)
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&f)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k) {
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(f[4 * k]), "=f"(f[4 * k + 1]), "=f"(f[4 * k + 2]), "=f"(f[4 * k + 3])
                 : "l"(p + 4 * k));
  }
}

// VEC fp32 values to p (16-byte aligned) as 16-byte vectors
template <int VEC>
__device__ __forceinline__ void store_f32(float* __restrict__ p, const float (&f)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k) {
    reinterpret_cast<float4*>(p)[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
  }
}

// K with the row in registers: TPR threads a row, VPT 16-byte vectors each, thread `sub` of a row holding vectors
// sub, sub + TPR, ...; D = TPR * VPT * (16 / sizeof(T)) exactly. Block b takes row groups b, b + gridDim.x, ...;
// team t of a block (its threads t * TPR .. t * TPR + TPR - 1) takes row t of each group and keeps the dw sums of
// its thread's columns in registers across them. The block's partial row is its teams' sums added in team order.
template <typename T, int TPR, int VPT>
__global__ void __launch_bounds__(kRegThreads, reg_min_blocks(VPT * 16 / static_cast<int>(sizeof(T))))
rmsnorm_bwd_regs_kernel(const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ dy,
                        T* __restrict__ dx, float* __restrict__ dw_part, int rows, float eps) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int D = TPR * VPT * VEC;
  constexpr int RPB = kRegThreads / TPR;  // rows (teams) a block takes at a time
  constexpr int WARPS = TPR / 32;         // whole warps a row (0: lanes of one warp)
  static_assert(kRegThreads % TPR == 0 && (TPR <= 32 ? 32 % TPR == 0 : TPR % 32 == 0), "row split");
  // the teams' dw sums meet in shared memory: all at once where RPB rows of D fit in 16 KB, else one team at a time
  constexpr bool kAllTeams = RPB > 1 && RPB * D <= 4096;
  __shared__ float2 warp_sums[kRegThreads / 32];  // (sum of squares, sum of g * x) of each warp
  __shared__ float team_dw[RPB > 1 ? (kAllTeams ? RPB : 1) * D : 1];
  const int sub = threadIdx.x % TPR, team = threadIdx.x / TPR;
  float acc[VPT][VEC];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[i][k] = 0.f;
  }
  const int groups = (rows + RPB - 1) / RPB;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int row = grp * RPB + team;
    const bool ok = row < rows;  // every lane joins the reductions; a row past the end loads and stores nothing
    const int64_t off = static_cast<int64_t>(row) * D;
    const uint4* xr = reinterpret_cast<const uint4*>(x + off);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + off);
    uint4 xv[VPT], dv[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) xv[i] = ok ? __ldcs(xr + i * TPR + sub) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < VPT; ++i) dv[i] = ok ? __ldcs(dr + i * TPR + sub) : make_uint4(0, 0, 0, 0);
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const T* xt = reinterpret_cast<const T*>(&xv[i]);
      const T* dt = reinterpret_cast<const T*>(&dv[i]);
      float wv[VEC];
      load_f32<VEC>(w + (i * TPR + sub) * VEC, wv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xf = mojo_to_float(xt[k]);
        ss += xf * xf;
        sg += mojo_to_float(dt[k]) * wv[k] * xf;
      }
    }
#pragma unroll
    for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
    }
    if constexpr (WARPS > 1) {
      if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = make_float2(ss, sg);
      __syncthreads();
      ss = 0.f;
      sg = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) {
        const float2 s = warp_sums[team * WARPS + i];
        ss += s.x;
        sg += s.y;
      }
      __syncthreads();  // read before the next group writes
    }
    const float rstd = 1.f / sqrtf(ss / D + eps);
    const float coef = rstd * rstd * rstd * (sg / D);
    if (!ok) continue;
    // the row stays packed until dx: unknown to the compiler from here, so the sums' unpacked copies do not live on
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      asm volatile("" : "+r"(xv[i].x), "+r"(xv[i].y), "+r"(xv[i].z), "+r"(xv[i].w));
      asm volatile("" : "+r"(dv[i].x), "+r"(dv[i].y), "+r"(dv[i].z), "+r"(dv[i].w));
    }
    uint4* dxr = reinterpret_cast<uint4*>(dx + off);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const T* xt = reinterpret_cast<const T*>(&xv[i]);
      const T* dt = reinterpret_cast<const T*>(&dv[i]);
      float wv[VEC];
      load_f32<VEC>(w + (i * TPR + sub) * VEC, wv);
      uint4 u;
      T* ot = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xf = mojo_to_float(xt[k]), df = mojo_to_float(dt[k]);
        ot[k] = mojo_from_float<T>(rstd * (df * wv[k]) - coef * xf);
        acc[i][k] += df * (xf * rstd);
      }
      __stcs(dxr + i * TPR + sub, u);
    }
  }
  // the block's partial row: team 0's sums, plus team 1's, ... in team order
  float* part = dw_part + static_cast<int64_t>(blockIdx.x) * D;
  if constexpr (kAllTeams) {  // every team stores its sums, then each thread adds its columns' RPB sums in order
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = (i * TPR + sub) * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) team_dw[team * D + c + k] = acc[i][k];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kRegThreads) {
      float s = team_dw[c];
#pragma unroll
      for (int t = 1; t < RPB; ++t) s += team_dw[t * D + c];
      part[c] = s;
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < RPB; ++t) {  // one team at a time; the last one stores the row
      if (team == t) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const int c = (i * TPR + sub) * VEC;
          if (t == RPB - 1) {
            float s[VEC];
#pragma unroll
            for (int k = 0; k < VEC; ++k) s[k] = t == 0 ? acc[i][k] : team_dw[c + k] + acc[i][k];
            store_f32<VEC>(part + c, s);
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) team_dw[c + k] = t == 0 ? acc[i][k] : team_dw[c + k] + acc[i][k];
          }
        }
      }
      if (t < RPB - 1) __syncthreads();
    }
  }
}

cudaError_t column_sum(const float* part, float* dw, int blocks, int D, cudaStream_t stream) {
  mojo_column_sum_kernel<><<<(D + kMojoSumCols - 1) / kMojoSumCols, kMojoSumCols * kMojoSumSlices, 0, stream>>>(
      part, dw, blocks, D);
  return cudaGetLastError();
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
  return column_sum(part, dw, blocks, D, stream);
}

// the register route with layout (tpr, vpt), or cudaErrorInvalidValue for a pair that is not instantiated
template <typename T>
cudaError_t launch_regs(const void* x, const float* w, const void* dy, void* dx, float* part, float* dw, int rows,
                        float eps, int blocks, int tpr, int vpt, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
#define MOJO_ROW_CASE(TPR, VPT)                                                                                     \
  if (tpr == TPR && vpt == VPT) {                                                                                   \
    rmsnorm_bwd_regs_kernel<T, TPR, VPT><<<blocks, kRegThreads, 0, stream>>>(xt, w, dyt, dxt, part, rows, eps);      \
    const cudaError_t err = cudaGetLastError();                                                                     \
    return err != cudaSuccess ? err : column_sum(part, dw, blocks, TPR * VPT * VEC, stream);                        \
  }
  MOJO_ROW_LAYOUTS(MOJO_ROW_CASE)
#undef MOJO_ROW_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
int regs_resources(int tpr, int vpt, int* out) {
#define MOJO_ROW_CASE(TPR, VPT) \
  if (tpr == TPR && vpt == VPT) return mojo_kernel_resources(rmsnorm_bwd_regs_kernel<T, TPR, VPT>, kRegThreads, 0, out);
  MOJO_ROW_LAYOUTS(MOJO_ROW_CASE)
#undef MOJO_ROW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, dy, dx: (rows, D) contiguous in `dtype`; w: (D,) fp32; part: (blocks,
// D) fp32 scratch; dw: (D,) fp32. `blocks` >= 1 is the grid of the row
// pass (any value is right; the wrapper fixes it from rows and D, so a
// call's bits repeat). tpr > 0 takes the register kernel with tpr threads
// of vpt 16-byte vectors a row (rmsnorm_vjp.layout: D = tpr * vpt * 16 /
// sizeof(dtype), x, dy, dx and w 16-byte aligned). tpr = 0 the generic
// kernels: `vec` = 1 when D is a multiple of 4 (short rows) or of 16 bytes'
// worth of elements (long rows) and x, dy, dx are aligned to that vector.
extern "C" int mojo_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* part, void* dw,
                                int rows, int D, float eps, int blocks, int vec, int tpr, int vpt, int dtype,
                                void* stream) {
  if (rows <= 0 || D <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  float* dwf = static_cast<float*>(dw);
  cudaError_t err = cudaErrorInvalidValue;
  MOJO_DISPATCH_DTYPE(dtype, T, {
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if (tpr > 0) {
      if (D == tpr * vpt * kVec && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
        err = launch_regs<T>(x, wf, dy, dx, pf, dwf, rows, eps, blocks, tpr, vpt, s);
      }
    } else if (!vec) {
      err = launch_rmsnorm_bwd<T, 1>(xt, wf, dyt, dxt, pf, dwf, rows, D, eps, blocks, s);
    } else if (D <= kShortMaxD) {
      err = launch_rmsnorm_bwd<T, 4>(xt, wf, dyt, dxt, pf, dwf, rows, D, eps, blocks, s);
    } else {
      err = launch_rmsnorm_bwd<T, kVec>(xt, wf, dyt, dxt, pf, dwf, rows, D, eps, blocks, s);
    }
  });
  return static_cast<int>(err);
}

// Registers a thread, blocks an SM, spill bytes and static shared bytes (common.cuh mojo_kernel_resources) of the
// row kernel mojo_rmsnorm_bwd takes for the same D, vec, tpr, vpt and dtype, into out[0..3]
extern "C" int mojo_rmsnorm_bwd_resources(int D, int vec, int tpr, int vpt, int dtype, int* out) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if (tpr > 0) {
      rc = regs_resources<T>(tpr, vpt, out);
    } else if (D <= kShortMaxD) {
      rc = vec ? mojo_kernel_resources(rmsnorm_bwd_short_kernel<T, 4>, kShortThreads, 0, out)
               : mojo_kernel_resources(rmsnorm_bwd_short_kernel<T, 1>, kShortThreads, 0, out);
    } else {
      const size_t smem = static_cast<size_t>(D) * sizeof(float);
      rc = vec ? mojo_kernel_resources(rmsnorm_bwd_long_kernel<T, kVec>, kLongThreads, smem, out)
               : mojo_kernel_resources(rmsnorm_bwd_long_kernel<T, 1>, kLongThreads, smem, out);
    }
  });
  return rc;
}
