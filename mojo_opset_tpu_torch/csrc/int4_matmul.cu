// Kernel G: packed-int4 x int8 -> int32 GEMM with the per-token x
// per-channel dequant epilogue.
//
// Replaces the JAX package's backends/pallas/kernels/int4_matmul.py:85
// (int4_scaled_matmul; kernel body _int4_mm_kernel :54-71, unpack
// _unpack_block :40-51, pallas_call :114).
//
// out[m, n] = float(sum_k x[m, k] * W[n, k]) * xs[m] * ws[n], rounded once
// to the output dtype; W is unpacked from w_packed (N/2, K) int8, whose
// packed row j*64 + r holds channel j*128 + r in its low nibble
// (lo = ((p & 15) ^ 8) - 8) and channel j*128 + 64 + r in its high nibble
// (hi = p >> 4, arithmetic). The int32 sum is exact; the epilogue
// multiplies in that order, in fp32, as the golden does.
//
// Bound on the H100: at decode (M = batch, 1 for the speculative draft at
// bs 1) the bytes of the packed weights, 0.5 byte per weight, streamed
// once per step; at the draft's prefill (M = 512) the tensor cores.
// Design: the int8 kernel's mma.sync.m16n8k32 s8 tiles and cp.async ring
// (csrc/int8_matmul.cu), with B staged as packed bytes, 16 bytes at a time.
// One 32-bit shared load of four packed bytes at consecutive k gives two
// B-fragment words, one for the low-nibble channel and one for the
// high-nibble channel, unpacked in registers with per-byte ops (mask,
// xor, __vsub4): no unpacked weight ever exists in memory. A block owns n
// packed rows of one 128-channel group and writes two runs of n channels.
// Two tiles: 128 x 64 packed rows (the whole group, 8 warps of 64 x 16)
// for M > 16, and, for decode, 16 x 8 packed rows with a 512-byte k-tile
// whose four 128-byte slices go to four warps, summed through shared
// memory at the end: 8 packed rows per block give N / 16 blocks (64 at
// N = 1024, 608 at N = 9728), where the int8 kernel's 16 x 32 tile gave
// 32. Ragged M and K are zero-filled on load and masked on store;
// N % 128 == 0 and K % 16 == 0 keep every 16-byte copy inside one row.
#include "common.cuh"

namespace {

template <int BM_, int BNP_, int BK_, int WARPS_M_, int WARPS_N_, int WARPS_K_, int STAGES_>
struct Int4Tile {
  static constexpr int BM = BM_, BNP = BNP_, BK = BK_;  // BNP: packed rows = BNP low + BNP high channels
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, WARPS_K = WARPS_K_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = WARPS_M * WARPS_N * WARPS_K * 32;
  static constexpr int WM = BM / WARPS_M, WNP = BNP / WARPS_N, WK = BK / WARPS_K;
  static constexpr int MT = WM / 16, NT = WNP / 8;  // mma tiles per warp (each n tile twice: lo, hi)
  static constexpr int LD = BK + 16;                // padded row bytes of A and of packed B
  static constexpr int A_BYTES = BM * LD;
  static constexpr int B_BYTES = BNP * LD;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int ACC = MT * NT * 2 * 4;       // int32 accumulators per thread
  static constexpr int RED_BYTES = WARPS_K > 1 ? (WARPS_K - 1) * WARPS_M * WARPS_N * 32 * ACC * 4 : 0;
  static constexpr int SMEM = STAGES * STAGE_BYTES > RED_BYTES ? STAGES * STAGE_BYTES : RED_BYTES;
  static_assert(WM % 16 == 0 && WNP % 8 == 0 && WK % 32 == 0, "mma tile shapes");
  static_assert(64 % BNP == 0, "a block stays inside one 128-channel group");
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0, "16-byte aligned stages");
};

using LargeTile = Int4Tile<128, 64, 64, 2, 4, 1, 4>;
using DecodeTile = Int4Tile<16, 8, 512, 1, 1, 4, 4>;

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

// four packed bytes -> four signed int8 of their low (resp. high) nibbles,
// byte order kept: a nibble v in 0..15 becomes (v ^ 8) - 8 in -8..7
__device__ __forceinline__ int unpack_lo(int p) {
  const unsigned v = static_cast<unsigned>(p) & 0x0F0F0F0Fu;
  return static_cast<int>(__vsub4(v ^ 0x08080808u, 0x08080808u));
}

__device__ __forceinline__ int unpack_hi(int p) {
  const unsigned v = (static_cast<unsigned>(p) >> 4) & 0x0F0F0F0Fu;
  return static_cast<int>(__vsub4(v ^ 0x08080808u, 0x08080808u));
}

template <typename TO, typename C>
__global__ void __launch_bounds__(C::THREADS)
int4_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp, const float* __restrict__ xs,
                 const float* __restrict__ ws, TO* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char mojo_int4_smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wk = warp / (C::WARPS_M * C::WARPS_N);
  const int wm = (warp / C::WARPS_N) % C::WARPS_M, wn = warp % C::WARPS_N;
  const int m0 = blockIdx.y * C::BM;
  const int p0 = blockIdx.x * C::BNP;  // first packed row of the block
  const int k_tiles = (K + C::BK - 1) / C::BK;

  auto load_tile = [&](int stage, int kt) {
    unsigned char* as = mojo_int4_smem + stage * C::STAGE_BYTES;
    unsigned char* bs = as + C::A_BYTES;
    const int k0 = kt * C::BK;
    constexpr int KCH = C::BK / 16;  // 16-byte chunks per k-row
    for (int c = tid; c < C::BM * KCH; c += C::THREADS) {
      const int r = c / KCH, k = k0 + (c % KCH) * 16;
      const bool ok = m0 + r < M && k < K;
      cp_async16(as + r * C::LD + (c % KCH) * 16, ok ? x + static_cast<int64_t>(m0 + r) * K + k : x, ok);
    }
    for (int c = tid; c < C::BNP * KCH; c += C::THREADS) {
      const int r = c / KCH, k = k0 + (c % KCH) * 16;
      const bool ok = k < K;  // N % 128 == 0: every packed row of the block exists
      cp_async16(bs + r * C::LD + (c % KCH) * 16, ok ? wp + static_cast<int64_t>(p0 + r) * K + k : wp, ok);
    }
  };

  int acc[C::MT][C::NT][2][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][h][e] = 0;

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

    const unsigned char* as = mojo_int4_smem + (kt % C::STAGES) * C::STAGE_BYTES;
    const unsigned char* bs = as + C::A_BYTES;
#pragma unroll
    for (int kq = 0; kq < C::WK; kq += 32) {
      const int kk = wk * C::WK + kq;  // this warp's k slice of the tile
      int a[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const unsigned char* p = as + (wm * C::WM + i * 16 + g) * C::LD + kk + tig * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * C::LD);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * C::LD + 16);
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const unsigned char* p = bs + (wn * C::WNP + j * 8 + g) * C::LD + kk + tig * 4;
        const int w0 = lds32(p), w1 = lds32(p + 16);
        const int b_lo[2] = {unpack_lo(w0), unpack_lo(w1)};
        const int b_hi[2] = {unpack_hi(w0), unpack_hi(w1)};
#pragma unroll
        for (int i = 0; i < C::MT; ++i) {
          mma_s8(acc[i][j][0], a[i], b_lo);
          mma_s8(acc[i][j][1], a[i], b_hi);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (C::WARPS_K > 1) {
    // warps of k slice > 0 park their sums in shared memory; slice 0 adds them
    __syncthreads();  // every warp is done reading the last stage
    int* red = reinterpret_cast<int*>(mojo_int4_smem);
    constexpr int MN_WARPS = C::WARPS_M * C::WARPS_N;
    const int slot = (warp % MN_WARPS) * 32 + lane;
    if (wk > 0) {
      int* dst = red + ((wk - 1) * MN_WARPS * 32 + slot) * C::ACC;
      const int* src = &acc[0][0][0][0];
#pragma unroll
      for (int e = 0; e < C::ACC; ++e) dst[e] = src[e];
    }
    __syncthreads();
    if (wk > 0) return;
    int* mine = &acc[0][0][0][0];
#pragma unroll
    for (int s = 0; s < C::WARPS_K - 1; ++s) {
      const int* src = red + (s * MN_WARPS * 32 + slot) * C::ACC;
#pragma unroll
      for (int e = 0; e < C::ACC; ++e) mine[e] += src[e];
    }
  }

  // packed row p0 + q of group j = (p0 + q) / 64 holds channels j*128 + r and j*128 + 64 + r, r = (p0 + q) % 64
  const int group_base = (p0 / 64) * 128, r0 = p0 % 64;
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int hm = 0; hm < 2; ++hm) {
      const int m = m0 + wm * C::WM + i * 16 + g + 8 * hm;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = group_base + h * 64 + r0 + wn * C::WNP + j * 8 + tig * 2 + e;
            const float val = static_cast<float>(acc[i][j][h][2 * hm + e]) * sx * ws[n];
            out[static_cast<int64_t>(m) * N + n] = mojo_from_float<TO>(val);
          }
        }
      }
    }
  }
}

template <typename TO, typename C>
int launch_int4(const int8_t* x, const int8_t* wp, const float* xs, const float* ws, TO* out, int M, int N, int K,
                cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int4_gemm_kernel<TO, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(N / 2 / C::BNP, (M + C::BM - 1) / C::BM);
  int4_gemm_kernel<TO, C><<<grid, C::THREADS, C::SMEM, stream>>>(x, wp, xs, ws, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) int8; w_packed: (N / 2, K) int8 in the pack_int4_rows layout;
// xs: (M,) fp32; ws: (N,) fp32; out: (M, N) in `dtype`. All contiguous and
// 16-byte aligned; N % 128 == 0, K % 16 == 0.
extern "C" int mojo_int4_matmul(const void* x, const void* w_packed, const void* xs, const void* ws, void* out,
                                int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (N % 128 != 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w_packed);
  const float* xsf = static_cast<const float*>(xs);
  const float* wsf = static_cast<const float*>(ws);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, TO, {
    TO* o = static_cast<TO*>(out);
    rc = M <= DecodeTile::BM ? launch_int4<TO, DecodeTile>(xq, wq, xsf, wsf, o, M, N, K, s)
                             : launch_int4<TO, LargeTile>(xq, wq, xsf, wsf, o, M, N, K, s);
  });
  return rc;
}
