// Shared pieces of the scalar-FMA flash-attention kernels J (flash_swa.cu)
// and O (flash_diffusion.cu): the thread tiling, row staging into shared
// memory, the shared-memory sizing, each thread's score and output products
// and the online-softmax step. A kernel keeps only how it finds its rows and
// keys and its keep-predicate, so a tensor-core version of these products
// replaces them for both kernels at once.
//
// Tiling. A forward / dq block is 128 threads over 64 query rows: thread
// (rg, cg) = (tid / 8, tid % 8) owns rows rg * 4 .. rg * 4 + 3, score columns
// cg + 8 c of a 32-key tile and output columns cg + 8 c of D. A dk/dv block
// owns KR keys (dkv_rows) the same way, TR = KR / 16 per thread, against
// 32-query tiles. Staged rows are fp32 with a padded stride of D + 1; P and dS
// tiles have a padded stride of 33.
#pragma once

#include "common.cuh"

namespace mojo_flash {

constexpr int kThreads = 128;
constexpr int kRows = 64;   // query rows of a forward / dq block
constexpr int kTR = 4;      // rows per thread there
constexpr int kCG = 8;      // threads sharing a row group (adjacent lanes)
constexpr int kBK = 32;     // keys per tile (forward / dq); query rows per tile (dk/dv)
constexpr int kTC = kBK / kCG;  // score columns per thread
constexpr int kSS = kBK + 1;    // padded row stride of P / dS
constexpr float kEmptyLse = 1e30f;

static_assert(kRows == kTR * kThreads / kCG, "thread tiling must cover the rows");

// keys of a dk/dv block: two (KR x D/8) accumulators a thread stay in registers
template <int D>
__host__ __device__ constexpr int dkv_rows() { return D >= 256 ? 32 : 64; }

template <int D>
constexpr int rows_smem_floats(int big_rows, int big_tiles, int small_rows, int small_tiles) {
  return big_tiles * big_rows * (D + 1) + small_tiles * small_rows * (D + 1) + kRows * kSS;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// Stage rows [r0, r0 + n) into s (n x (D + 1) floats, times mul); row r of x
// starts `stride` elements after row r - 1. Zero past `limit` rows.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* s, const T* __restrict__ x, int r0, int n, int limit,
                                           int64_t stride, float mul) {
  constexpr int QS = D + 1;
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < n * (D / VE); i += kThreads) {
    const int r = i % n;
    const int d0 = (i / n) * VE;
    float f[VE];
    if (r0 + r < limit) {
      mojo_load_row<T, VE>(x + static_cast<int64_t>(r0 + r) * stride + d0, f);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VE; ++e) s[r * QS + d0 + e] = f[e] * mul;
  }
}

// s[i][c] += A[rg * TR + i] . B[cg + kCG * c] over D (staged rows)
template <int D, int TR>
__device__ __forceinline__ void tile_scores(float (&s)[TR][kTC], const float* a, const float* b, int rg, int cg) {
  constexpr int QS = D + 1;
  for (int d = 0; d < D; ++d) {
    float av[TR], bv[kTC];
#pragma unroll
    for (int i = 0; i < TR; ++i) av[i] = a[(rg * TR + i) * QS + d];
#pragma unroll
    for (int c = 0; c < kTC; ++c) bv[c] = b[(cg + kCG * c) * QS + d];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[i][c] += av[i] * bv[c];
  }
}

// The backward's two products in one sweep over D: s += A0 B0^T, dp += A1 B1^T
template <int D, int TR>
__device__ __forceinline__ void tile_scores2(float (&s)[TR][kTC], float (&dp)[TR][kTC], const float* a0,
                                             const float* b0, const float* a1, const float* b1, int rg, int cg) {
  constexpr int QS = D + 1;
  for (int d = 0; d < D; ++d) {
    float a0v[TR], a1v[TR], b0v[kTC], b1v[kTC];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      a0v[i] = a0[(rg * TR + i) * QS + d];
      a1v[i] = a1[(rg * TR + i) * QS + d];
    }
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      b0v[c] = b0[(cg + kCG * c) * QS + d];
      b1v[c] = b1[(cg + kCG * c) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        s[i][c] += a0v[i] * b0v[c];
        dp[i][c] += a1v[i] * b1v[c];
      }
  }
}

// acc[i][c] += sum over j < kBK of P[rg * TR + i][j] * X[j][cg + kCG * c]
// (P with row stride kSS, X staged rows)
template <int D, int TR>
__device__ __forceinline__ void tile_accumulate(float (&acc)[TR][D / kCG], const float* p, const float* x, int rg,
                                                int cg) {
  constexpr int QS = D + 1;
  for (int j = 0; j < kBK; ++j) {
    float pv[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) pv[i] = p[(rg * TR + i) * kSS + j];
#pragma unroll
    for (int c = 0; c < D / kCG; ++c) {
      const float xv = x[j * QS + cg + kCG * c];
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[i][c] += pv[i] * xv;
    }
  }
}

// This thread's cells of s into p (row stride kSS)
template <int TR>
__device__ __forceinline__ void store_cells(float* p, const float (&s)[TR][kTC], int rg, int cg) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < kTC; ++c) p[(rg * TR + i) * kSS + cg + kCG * c] = s[i][c];
}

// One online-softmax step of this thread's kTR rows over a key tile whose
// masked scores are -inf: new running max m and sum l, acc rescaled, and the
// tile's probabilities written to p_s for the PV product.
template <int D>
__device__ __forceinline__ void online_softmax(const float (&s)[kTR][kTC], float (&m)[kTR], float (&l)[kTR],
                                               float (&acc)[kTR][D / kCG], float* p_s, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kTC; ++c) mx = fmaxf(mx, s[i][c]);
#pragma unroll
    for (int off = 1; off < kCG; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      const float p = m_new == -INFINITY ? 0.f : expf(s[i][c] - m_new);
      p_s[(rg * kTR + i) * kSS + cg + kCG * c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 1; off < kCG; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < D / kCG; ++c) acc[i][c] *= alpha;
  }
}

}  // namespace mojo_flash

// Run BODY with T bound to the dtype and D to the head dim (64, 128, 256);
// others fail.
#define MOJO_FLASH_DISPATCH(dtype, hd, ...)                            \
  MOJO_DISPATCH_DTYPE(dtype, T, {                                      \
    if (hd == 64) {                                                    \
      constexpr int D = 64;                                            \
      __VA_ARGS__;                                                     \
    } else if (hd == 128) {                                            \
      constexpr int D = 128;                                           \
      __VA_ARGS__;                                                     \
    } else if (hd == 256) {                                            \
      constexpr int D = 256;                                           \
      __VA_ARGS__;                                                     \
    } else {                                                           \
      return static_cast<int>(cudaErrorInvalidValue);                  \
    }                                                                  \
  })
