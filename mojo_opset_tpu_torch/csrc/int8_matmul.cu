// Kernel F: int8 x int8 -> int32 GEMM with the per-token x per-channel
// dequant epilogue.
//
// Replaces the JAX package's backends/pallas/kernels/int8_matmul.py:54
// (int8_scaled_matmul, body _int8_mm_kernel :30, call :87).
//
// out[m, n] = float(sum_k x[m, k] * w[n, k]) * xs[m] * ws[n], rounded once
// to the output dtype. The int32 sum is exact (|sum| <= K * 128^2); the
// epilogue multiplies in that order, in fp32, as the golden does.
//
// Bound on the H100: at prefill (M = 1650 tokens, ~2e8 int8 ops per token
// and layer at Qwen3-4B) the tensor cores; at decode (M = batch) the bytes
// of the int8 weights, streamed once per step. Design: tensor-core
// mma.sync.m16n8k32 s8 tiles, fed from shared memory that cp.async fills
// 16 bytes at a time in a ring of STAGES k-tiles, so the next tiles load
// while the current one multiplies. The model's (N, K) weight is
// K-contiguous, exactly the "col" B operand of the instruction, so
// fragments are 32-bit shared loads; shared rows are padded by 16 bytes so
// the 32 lanes of a fragment load hit 32 banks. A (K, N) weight is staged
// as it lies and its fragments gather 4 bytes each. Two tile shapes: 128 x
// 128 (8 warps of 64 x 32) for M > 16, and 16 x 32 with 128-deep k-tiles
// (4 warps of 16 x 8) for decode, where more blocks share out the weight
// stream. Ragged M, N and K are zero-filled on load and masked on store;
// K % 16 == 0 (and N % 16 == 0 for a (K, N) weight) keeps every 16-byte
// copy inside one row. No split-K: at decode N / 32 blocks (32 for N =
// 1024) leave SMs idle, which later work fixes.
#include "common.cuh"

namespace {

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int STAGES_>
struct GemmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;             // mma tiles per warp
  static constexpr int LDA = BK + 16;                         // padded row bytes of A and of an (N, K) B
  static constexpr int LDB_KN = BN + 16;                      // padded row bytes of a (K, N) B
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int B_BYTES = (BN * LDA > BK * LDB_KN) ? BN * LDA : BK * LDB_KN;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 32 == 0, "mma tile shapes");
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0, "16-byte aligned stages");
};

using LargeTile = GemmTile<128, 128, 64, 2, 4, 4>;
using DecodeTile = GemmTile<16, 32, 128, 1, 4, 4>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lds32(const unsigned char* p) { return *reinterpret_cast<const int*>(p); }

// 4 bytes of column n from rows k .. k+3 of a (K, N) tile, k in the low byte
__device__ __forceinline__ int gather4(const unsigned char* p, int ld) {
  return static_cast<int>(static_cast<unsigned>(p[0]) | (static_cast<unsigned>(p[ld]) << 8) |
                          (static_cast<unsigned>(p[2 * ld]) << 16) | (static_cast<unsigned>(p[3 * ld]) << 24));
}

template <typename TO, typename C, bool TRANS>
__global__ void __launch_bounds__(C::THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ xs,
                 const float* __restrict__ ws, TO* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char mojo_gemm_smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int k_tiles = (K + C::BK - 1) / C::BK;

  auto load_tile = [&](int stage, int kt) {
    unsigned char* as = mojo_gemm_smem + stage * C::STAGE_BYTES;
    unsigned char* bs = as + C::A_BYTES;
    const int k0 = kt * C::BK;
    constexpr int KCH = C::BK / 16;  // 16-byte chunks per k-row
    for (int c = tid; c < C::BM * KCH; c += C::THREADS) {
      const int r = c / KCH, k = k0 + (c % KCH) * 16;
      const bool ok = m0 + r < M && k < K;
      cp_async16(as + r * C::LDA + (c % KCH) * 16, ok ? x + static_cast<int64_t>(m0 + r) * K + k : x, ok);
    }
    if constexpr (TRANS) {
      for (int c = tid; c < C::BN * KCH; c += C::THREADS) {
        const int r = c / KCH, k = k0 + (c % KCH) * 16;
        const bool ok = n0 + r < N && k < K;
        cp_async16(bs + r * C::LDA + (c % KCH) * 16, ok ? w + static_cast<int64_t>(n0 + r) * K + k : w, ok);
      }
    } else {
      constexpr int NCH = C::BN / 16;
      for (int c = tid; c < C::BK * NCH; c += C::THREADS) {
        const int r = c / NCH, n = n0 + (c % NCH) * 16;
        const bool ok = k0 + r < K && n < N;
        cp_async16(bs + r * C::LDB_KN + (c % NCH) * 16, ok ? w + static_cast<int64_t>(k0 + r) * N + n : w, ok);
      }
    }
  };

  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // tile kt has landed
    __syncthreads();                 // ... for every thread, and tile kt-1 is consumed
    const int next = kt + C::STAGES - 1;
    if (next < k_tiles) load_tile(next % C::STAGES, next);
    cp_async_commit();

    const unsigned char* as = mojo_gemm_smem + (kt % C::STAGES) * C::STAGE_BYTES;
    const unsigned char* bs = as + C::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 32) {
      int a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const unsigned char* p = as + (wm * C::WM + i * 16 + g) * C::LDA + kk + tig * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * C::LDA);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * C::LDA + 16);
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int n = wn * C::WN + j * 8 + g;
        if constexpr (TRANS) {
          const unsigned char* p = bs + n * C::LDA + kk + tig * 4;
          b[j][0] = lds32(p);
          b[j][1] = lds32(p + 16);
        } else {
          const unsigned char* p = bs + (kk + tig * 4) * C::LDB_KN + n;
          b[j][0] = gather4(p, C::LDB_KN);
          b[j][1] = gather4(p + 16 * C::LDB_KN, C::LDB_KN);
        }
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * C::WM + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * C::WN + j * 8 + tig * 2 + e;
          if (n < N) {
            const float val = static_cast<float>(acc[i][j][2 * h + e]) * sx * ws[n];
            out[static_cast<int64_t>(m) * N + n] = mojo_from_float<TO>(val);
          }
        }
      }
    }
  }
}

template <typename TO, typename C, bool TRANS>
int launch_gemm(const int8_t* x, const int8_t* w, const float* xs, const float* ws, TO* out, int M, int N, int K,
                cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_gemm_kernel<TO, C, TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  int8_gemm_kernel<TO, C, TRANS><<<grid, C::THREADS, C::SMEM, stream>>>(x, w, xs, ws, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO, bool TRANS>
int dispatch_tile(const int8_t* x, const int8_t* w, const float* xs, const float* ws, TO* out, int M, int N,
                  int K, cudaStream_t stream) {
  if (M <= DecodeTile::BM) return launch_gemm<TO, DecodeTile, TRANS>(x, w, xs, ws, out, M, N, K, stream);
  return launch_gemm<TO, LargeTile, TRANS>(x, w, xs, ws, out, M, N, K, stream);
}

}  // namespace

// x: (M, K) int8; w: (N, K) int8 when trans_weight, else (K, N); xs: (M,)
// fp32; ws: (N,) fp32; out: (M, N) in `dtype`. All contiguous and 16-byte
// aligned; K % 16 == 0, and N % 16 == 0 when !trans_weight.
extern "C" int mojo_int8_matmul(const void* x, const void* w, const void* xs, const void* ws, void* out, int M,
                                int N, int K, int trans_weight, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K % 16 != 0 || (!trans_weight && N % 16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* xsf = static_cast<const float*>(xs);
  const float* wsf = static_cast<const float*>(ws);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, TO, {
    TO* o = static_cast<TO*>(out);
    rc = trans_weight ? dispatch_tile<TO, true>(xq, wq, xsf, wsf, o, M, N, K, s)
                      : dispatch_tile<TO, false>(xq, wq, xsf, wsf, o, M, N, K, s);
  });
  return rc;
}
